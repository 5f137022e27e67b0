"""Simulation subsystem: the multi-round driver (host mode), its schema-3
ledger, and the registry of the scenario cells the port runs."""

from repro_torch.sim.driver import (  # noqa: F401
    SimLedger,
    run_scenario,
    run_simulation,
    validate_ledger,
)
from repro_torch.sim.scenarios import (  # noqa: F401
    SCENARIOS,
    Scenario,
    get_scenario,
    list_scenarios,
)
