"""Simulation subsystem: the multi-round driver (host, prefetch and scan
modes), the device-resident client pool and the client-state layer, the
schema-3 ledger, and the registry of the scenario cells."""

from repro_torch.sim.driver import (  # noqa: F401
    SIM_SCHEMA,
    SimLedger,
    build_client_mesh,
    run_scenario,
    run_simulation,
    validate_ledger,
)
from repro_torch.sim.pool import (  # noqa: F401
    ClientPool,
    ClientState,
    RoundPlan,
    SystemConfig,
    init_client_state,
    plan_cohort,
    step_client_state,
)
from repro_torch.sim.scenarios import (  # noqa: F401
    SCENARIOS,
    Scenario,
    get_scenario,
    list_scenarios,
    register,
)
