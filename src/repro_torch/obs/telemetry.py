"""Telemetry aggregator: one object owning the obs sinks for a run — the
port of ``repro/obs/telemetry.py``.

:class:`ObsConfig` is the declarative knob set (what to record, where to
serve it); :class:`Telemetry` is the live object the sim driver threads
through the round loop.  The driver calls ``record_span`` (from phase
spans), ``record_round`` (once per completed round), ``record_gap`` (on
diagnostic rounds) and ``finish``; Telemetry fans each call out to the
JSONL event stream, the HTTP endpoint snapshot, and the running
phase-seconds table.

Ownership: ``run_simulation(obs=ObsConfig(...))`` builds and closes the
Telemetry itself, while ``run_simulation(obs=Telemetry(...))`` leaves
lifecycle with the caller — that is how ``chip_smoke.py`` and the tests
scrape the endpoint *after* the run returns, then ``close()`` it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

from repro_torch.obs.events import EventLog
from repro_torch.obs.gap import gap_ratio
from repro_torch.obs.http import MetricsServer
from repro_torch.obs.log import get_logger
from repro_torch.obs.trace import PHASES, TraceWindow


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """What the obs layer records for one run; all knobs default off.

    ``diag_every=N`` runs the Eq. 2 gap estimator every N rounds (0
    disables); ``metrics_port`` starts the live endpoint (0 = ephemeral
    port); ``jsonl`` appends the event stream to that path; ``trace_dir``
    profiles the first ``trace_rounds`` rounds with ``torch.profiler``;
    ``phases=True`` switches the host-mode driver to the phased executor so
    per-phase wall times are real device-bounded measurements (the port's
    phases run the fused step's ops in its order, so masks and parameters
    stay bitwise; the per-phase syncs change only the timing).

    The default-constructed config is inert: ``enabled`` is False and the
    driver takes the exact pre-obs code path.
    """

    diag_every: int = 0
    metrics_port: Optional[int] = None
    jsonl: Optional[str] = None
    trace_dir: Optional[str] = None
    trace_rounds: int = 3
    phases: bool = False

    def __post_init__(self):
        if self.diag_every < 0:
            raise ValueError(f"diag_every must be >= 0, got {self.diag_every}")
        if self.trace_rounds < 1:
            raise ValueError(
                f"trace_rounds must be >= 1, got {self.trace_rounds}")
        if self.metrics_port is not None and not 0 <= self.metrics_port < 65536:
            raise ValueError(f"bad metrics_port {self.metrics_port}")

    @property
    def enabled(self) -> bool:
        """True when any sink or diagnostic is switched on."""
        return (self.diag_every > 0 or self.metrics_port is not None
                or self.jsonl is not None or self.trace_dir is not None
                or self.phases)


class Telemetry:
    """Live telemetry for one run: spans, rounds, gaps → events + endpoint.

    Construct from an :class:`ObsConfig`; sinks whose knobs are unset are
    simply absent (``record_*`` still works and keeps the in-memory
    snapshot, so tests can introspect without any I/O).  ``snapshot()``
    returns the dict the endpoint serves; ``close()`` tears every sink
    down idempotently.
    """

    def __init__(self, cfg: ObsConfig):
        self.cfg = cfg
        self._log = get_logger("obs")
        self._events: Optional[EventLog] = (
            EventLog(cfg.jsonl) if cfg.jsonl else None)
        self._server: Optional[MetricsServer] = None
        if cfg.metrics_port is not None:
            self._server = MetricsServer(port=cfg.metrics_port).start()
            self._log.info("metrics endpoint at %s/metrics", self._server.url)
        self.trace_window = TraceWindow(cfg.trace_dir, cfg.trace_rounds)
        self._t0 = time.perf_counter()
        self._snap: dict = {"rounds_total": 0, "phase_seconds": {}}
        self._phase_seconds: dict = {}
        self.last_gap: Optional[dict] = None

    # -- identity ---------------------------------------------------------
    @property
    def url(self) -> Optional[str]:
        """Endpoint base URL, or None when no server was requested."""
        return self._server.url if self._server is not None else None

    def want_gap(self, k: int) -> bool:
        """True when round ``k`` lies on the ``diag_every`` grid."""
        return self.cfg.diag_every > 0 and k % self.cfg.diag_every == 0

    # -- recording --------------------------------------------------------
    def run_start(self, **info) -> None:
        """Record the run info block (scenario/mode/sampler/...)."""
        self._snap["run"] = dict(info)
        if self._events is not None:
            self._events.emit("run_start", **info)
        self._push()

    def record_span(self, name: str, seconds: float) -> None:
        """Sink target for :func:`repro_torch.obs.trace.span`."""
        self._phase_seconds[name] = seconds

    def round_start(self, k: int) -> None:
        """Hook the trace window (and reset this round's phase table)."""
        self.trace_window.round_start(k)
        self._phase_seconds = {}

    def record_round(self, k: int, **payload) -> None:
        """One completed round: loss / sent / wall_ms / cumulative counters.

        Folds the round's phase seconds (from :meth:`record_span`) into the
        event and the endpoint snapshot, closes the trace window for this
        round, and bumps ``rounds_total`` / ``rounds_per_sec``.
        """
        self.trace_window.round_end(k)
        if self._phase_seconds:
            payload["phase_seconds"] = dict(self._phase_seconds)
        if self._events is not None:
            self._events.emit("round", round=k, **payload)
        self._snap["round"] = k
        self._snap["rounds_total"] += 1
        elapsed = time.perf_counter() - self._t0
        if elapsed > 0:
            self._snap["rounds_per_sec"] = self._snap["rounds_total"] / elapsed
        for key in ("loss", "sent_clients", "uplink_bits_total",
                    "downlink_bits_total", "deadline_misses_total",
                    "dropouts_total"):
            if payload.get(key) is not None:
                self._snap[key] = payload[key]
        if self._phase_seconds:
            self._snap["phase_seconds"] = dict(self._phase_seconds)
        self._push()

    def record_gap(self, k: int, gap_sq: float, full_sq: float) -> dict:
        """One diagnostic round's Eq. 2 stats; returns the recorded dict."""
        rec = {
            "round": k,
            "gap_sq": float(gap_sq),
            "full_sq": float(full_sq),
            "gap_ratio": gap_ratio(gap_sq, full_sq),
        }
        self.last_gap = rec
        if self._events is not None:
            self._events.emit("gap", **rec)
        self._snap["gap"] = rec
        self._push()
        return rec

    def finish(self, **summary) -> None:
        """Record the run summary (rounds, wall seconds, rounds/s)."""
        self._snap["wall_s"] = time.perf_counter() - self._t0
        if self._events is not None:
            self._events.emit("run_end", **summary)
        self._push()

    # -- plumbing ---------------------------------------------------------
    def snapshot(self) -> dict:
        """The current endpoint snapshot (also kept with no server)."""
        return dict(self._snap)

    def _push(self) -> None:
        if self._server is not None:
            self._server.update(self.snapshot())

    def close(self) -> None:
        """Tear down server, event log and trace window (idempotent)."""
        self.trace_window.close()
        if self._events is not None:
            self._events.close()
            self._events = None
        if self._server is not None:
            self._server.stop()
            self._server = None


def as_telemetry(obs) -> "tuple[Optional[Telemetry], bool]":
    """Normalize a driver ``obs=`` argument to ``(telemetry, owned)``.

    ``None`` / inert :class:`ObsConfig` → ``(None, False)`` (telemetry off,
    pre-obs code path); an enabled :class:`ObsConfig` → a fresh Telemetry
    the driver must close (``owned=True``); a :class:`Telemetry` instance →
    passed through with ``owned=False`` (caller keeps lifecycle: it scrapes
    the endpoint after the run, then closes it).
    """
    if obs is None:
        return None, False
    if isinstance(obs, Telemetry):
        return obs, False
    if isinstance(obs, ObsConfig):
        if not obs.enabled:
            return None, False
        return Telemetry(obs), True
    raise TypeError(f"obs must be ObsConfig or Telemetry, got {type(obs)!r}")


__all__ = ["ObsConfig", "Telemetry", "PHASES", "as_telemetry"]
