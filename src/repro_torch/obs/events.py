"""Schema-versioned JSONL event stream: one JSON object per line, per event.
A copy of ``repro/obs/events.py``: the same ``OBS_SCHEMA`` and event kinds,
so the two packages' streams read the same.

The durable half of the obs layer (the HTTP endpoint is the live half):
every round, gap diagnostic, and run boundary is appended to a JSONL file
as a flat JSON object carrying ``schema`` (:data:`OBS_SCHEMA`), ``kind``,
``ts`` (epoch seconds, for humans correlating with external logs) and the
event payload.  JSONL rather than one growing JSON document so a crashed or
killed run still leaves every completed round parseable, and ``tail -f`` /
``jq`` work while the run is live.

Event kinds emitted by :class:`~repro_torch.obs.telemetry.Telemetry`:

* ``run_start`` — the run info block (scenario, mode, sampler, config);
* ``round``     — per-round record: loss / sent / cumulative duplex bits /
  system counters / ``wall_ms`` / the round's phase seconds;
* ``gap``       — a diagnostic round's Eq. 2 stats (``gap_sq`` /
  ``full_sq`` / ``gap_ratio``);
* ``run_end``   — the run summary (rounds, wall seconds, rounds/s).

The field tables are the reference's (its ``docs/observability.md``).
"""

from __future__ import annotations

import json
import os
import time

# version of the JSONL event schema; bump when an emitted field changes
# meaning or an event kind's required fields change.
OBS_SCHEMA = 1


class EventLog:
    """Append-only JSONL writer for obs events (one flat object per line).

    Lines are flushed per event so a live ``tail -f`` sees every completed
    round immediately and a killed process loses at most the line being
    written.  Not thread-safe by design — the driver emits from the round
    loop only.
    """

    def __init__(self, path: str):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, "w")

    def emit(self, kind: str, **payload) -> dict:
        """Append one event; returns the emitted object (tests introspect it)."""
        evt = {"schema": OBS_SCHEMA, "kind": kind, "ts": time.time(), **payload}
        self._f.write(json.dumps(evt, sort_keys=True) + "\n")
        self._f.flush()
        return evt

    def close(self) -> None:
        """Flush and close the underlying file (idempotent)."""
        if self._f is not None:
            self._f.close()
            self._f = None


def read_events(path: str) -> list:
    """Parse a JSONL event file back into a list of dicts (test helper)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
