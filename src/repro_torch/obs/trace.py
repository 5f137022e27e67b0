"""Phase spans: monotonic wall-time measurement + profiler annotation — the
port of ``repro/obs/trace.py``.

:func:`span` is the one timing primitive of the obs layer: a context
manager that (a) opens ``torch.profiler.record_function("repro.obs/<name>")``
so the phase shows as a named slice in a profiler trace (on the CPU and on
a card alike), and (b) records the phase's wall time on the monotonic clock
(``time.perf_counter``).  Work on a card is asynchronous, so a bare exit
timestamp would measure the enqueue only: the span takes a ``block(x)``
target, and ``torch.cuda.synchronize`` runs on the devices of ``x``'s CUDA
tensors before the clock stops, so the seconds bound the phase's device
work (the reference's ``jax.block_until_ready``).

:class:`TraceWindow` is the ``--trace-dir`` support: a
``torch.profiler.profile`` (CPU activities and, with a card, CUDA ones)
over the first N rounds of a run, exported as a Chrome trace into the
directory (the reference's ``jax.profiler`` window).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# the five phases of one communication round — the names span()/Telemetry
# publish.  (Execution order is local_update -> compress -> sample ->
# aggregate -> server_opt: the plan needs the norms of what clients send.)
PHASES = ("sample", "local_update", "compress", "aggregate", "server_opt")


def _cuda_devices(x, found: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, found)
    return found


def block_until_ready(x) -> None:
    """Wait for the devices of every CUDA tensor in ``x`` (tensors, or
    dicts, tuples and lists of them)."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


class Span:
    """One timed phase: ``name``, a block target, and the measured seconds."""

    __slots__ = ("name", "seconds", "_block")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._block = None

    def block(self, tensors) -> None:
        """Tensors whose devices are synced before the span closes, so the
        recorded wall time covers the phase's device work."""
        self._block = tensors


@contextlib.contextmanager
def span(name: str, sink=None):
    """Time one phase on the monotonic clock, annotated for the profiler.

    Yields a :class:`Span`; ``sp.block(tensors)`` with the phase's output
    makes the clock stop after their device work.  ``sink`` (a
    :class:`~repro_torch.obs.telemetry.Telemetry`, or anything with
    ``record_span(name, seconds)``) receives the measurement; with
    ``sink=None`` the span still annotates the profiler trace.
    """
    sp = Span(name)
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"repro.obs/{name}"):
        try:
            yield sp
        finally:
            if sp._block is not None:
                block_until_ready(sp._block)
            sp.seconds = time.perf_counter() - t0
            if sink is not None:
                sink.record_span(name, sp.seconds)


class TraceWindow:
    """``--trace-dir`` support: profile the first ``rounds`` rounds to disk.

    ``round_start(k)`` starts a ``torch.profiler.profile`` at round 0;
    ``round_end(k)`` stops it once ``rounds`` rounds have completed and
    writes ``repro-obs-rounds-0-<n>.pt.trace.json`` (a Chrome trace:
    Perfetto or ``chrome://tracing``) into ``trace_dir``; :meth:`close`
    stops an open window, so a short run still writes its trace.  Each obs
    phase shows as a ``repro.obs/<phase>`` slice (:func:`span`).
    """

    def __init__(self, trace_dir: str | None, rounds: int = 3):
        if rounds < 1:
            raise ValueError(f"trace window must cover >= 1 round, got {rounds}")
        self.trace_dir = trace_dir
        self.rounds = rounds
        self.active = False
        self.path = None
        self._prof = None
        self._done = 0

    def round_start(self, k: int) -> None:
        """Start the profiler when round ``k`` is the window's first."""
        if self.trace_dir is not None and k == 0 and not self.active:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self.active = True
            self._done = 0

    def round_end(self, k: int) -> None:
        """Stop and export once the window's last round has completed."""
        if self.active:
            self._done = k + 1
            if self._done >= self.rounds:
                self._stop()

    def _stop(self) -> None:
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(self.trace_dir,
                                 f"repro-obs-rounds-0-{self._done}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self.active = False

    def close(self) -> None:
        """Stop an open window (runs shorter than the window)."""
        if self.active:
            self._stop()
