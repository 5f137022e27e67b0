"""Simulation subsystem: the multi-round driver (host, prefetch and scan
modes), the device-resident client pool and the client-state layer, the
schema-3 ledger, and the registry of the scenario cells."""

from repro_torch.sim.driver import (  # noqa: F401
    SimLedger,
    run_scenario,
    run_simulation,
    validate_ledger,
)
from repro_torch.sim.pool import ClientPool, RoundPlan, plan_cohort  # noqa: F401
from repro_torch.sim.scenarios import (  # noqa: F401
    SCENARIOS,
    Scenario,
    get_scenario,
    list_scenarios,
)
