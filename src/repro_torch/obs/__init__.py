"""Round-trace observability layer of the port (``repro_torch.obs``), the
port of ``repro.obs``.

Telemetry for the whole round path, strictly additive: phase spans
(monotonic wall times + ``torch.profiler`` annotations), the online Eq. 2
gap estimator (``‖ŝ − s‖²`` between the sampled and the full-participation
aggregate), a schema-versioned JSONL event stream, and a stdlib-threaded
live metrics endpoint (JSON snapshot + Prometheus text).  With telemetry
off nothing here runs and every other path is unchanged.

Entry points: hand an :class:`ObsConfig` to
``repro_torch.sim.driver.run_simulation(obs=...)`` (or ``launch/train.py
--metrics-port/--diag-every/--obs-jsonl/--trace-dir``); hold a
:class:`Telemetry` yourself when the endpoint should outlive the run.
"""

from repro_torch.obs.events import OBS_SCHEMA, EventLog
from repro_torch.obs.gap import GapStats, flat_gap_stats, gap_ratio, tree_gap_stats
from repro_torch.obs.http import MetricsServer, render_prometheus
from repro_torch.obs.log import get_logger
from repro_torch.obs.telemetry import ObsConfig, Telemetry
from repro_torch.obs.trace import PHASES, TraceWindow, span

__all__ = [
    "OBS_SCHEMA", "EventLog",
    "GapStats", "flat_gap_stats", "gap_ratio", "tree_gap_stats",
    "MetricsServer", "render_prometheus",
    "get_logger",
    "ObsConfig", "Telemetry",
    "PHASES", "TraceWindow", "span",
]
