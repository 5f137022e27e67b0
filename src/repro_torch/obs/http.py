"""Live metrics endpoint: stdlib-threaded HTTP server with a JSON snapshot
and a Prometheus text exposition — no third-party dependency.  A copy of
``repro/obs/http.py``: the same ``repro_*`` metric names, so one scraper
reads both packages.

``GET /metrics`` returns Prometheus text-format gauges/counters
(``repro_*`` namespace — gap ratio, per-phase seconds, rounds/s, cumulative
duplex bits, system counters; the key table is the reference's);
``GET /`` or ``GET /snapshot`` returns the raw JSON snapshot.  The server
runs on a daemon thread (``ThreadingHTTPServer``), binds ``127.0.0.1`` by
default, and ``port=0`` picks an ephemeral port (read it back from
``MetricsServer.port``, as the tests do).

The snapshot is replaced atomically under a lock by
:meth:`MetricsServer.update`; request handlers only ever read the current
reference, so a scrape never observes a half-written round.
"""

from __future__ import annotations

import http.server
import json
import threading


def _prom_escape(v: str) -> str:
    """Escape a Prometheus label value (backslash, quote, newline)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_prometheus(snap: dict) -> str:
    """Prometheus text exposition of a telemetry snapshot dict.

    Emits only the keys present in the snapshot, so a scrape before the
    first diagnostic round simply lacks the ``repro_gap_*`` family rather
    than exporting a fake zero.
    """
    lines = []

    def put(name, value, labels=None, typ="gauge"):
        lines.append(f"# TYPE {name} {typ}")
        lab = ""
        if labels:
            inner = ",".join(
                f'{k}="{_prom_escape(v)}"' for k, v in sorted(labels.items())
            )
            lab = "{" + inner + "}"
        lines.append(f"{name}{lab} {value}")

    info = snap.get("run", {})
    if info:
        put("repro_run_info", 1, labels={k: str(v) for k, v in info.items()})
    if "round" in snap:
        put("repro_round", snap["round"])
    if "rounds_total" in snap:
        put("repro_rounds_total", snap["rounds_total"], typ="counter")
    for key in ("rounds_per_sec", "loss", "sent_clients", "wall_s"):
        if snap.get(key) is not None:
            put(f"repro_{key}", snap[key])
    for key in ("uplink_bits_total", "downlink_bits_total",
                "deadline_misses_total", "dropouts_total"):
        if snap.get(key) is not None:
            put(f"repro_{key}", snap[key], typ="counter")
    for phase, secs in sorted(snap.get("phase_seconds", {}).items()):
        lines.append('# TYPE repro_phase_seconds gauge')
        lines.append(f'repro_phase_seconds{{phase="{_prom_escape(phase)}"}} {secs}')
    gap = snap.get("gap")
    if gap:
        put("repro_gap_round", gap["round"])
        put("repro_gap_sq", gap["gap_sq"])
        put("repro_full_sq", gap["full_sq"])
        put("repro_gap_ratio", gap["gap_ratio"])
    return "\n".join(lines) + "\n"


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (stdlib handler API)
        snap = self.server.snapshot()
        if self.path.rstrip("/") in ("", "/snapshot".rstrip("/")):
            body = json.dumps(snap, sort_keys=True).encode()
            ctype = "application/json"
        elif self.path == "/metrics":
            body = render_prometheus(snap).encode()
            ctype = "text/plain; version=0.0.4"
        else:
            self.send_error(404, "want / (JSON snapshot) or /metrics (Prometheus)")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr):
        super().__init__(addr, _Handler)
        self._lock = threading.Lock()
        self._snapshot: dict = {}

    def snapshot(self) -> dict:
        with self._lock:
            return self._snapshot

    def set_snapshot(self, snap: dict) -> None:
        with self._lock:
            self._snapshot = snap


class MetricsServer:
    """The obs layer's live endpoint: start, :meth:`update`, :meth:`stop`.

    ``port=0`` binds an ephemeral port; the bound port is available as
    ``.port`` after :meth:`start` and the whole endpoint URL as ``.url``.
    Serving happens on a daemon thread, so a crashed run never hangs on the
    endpoint and process exit always wins.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._server = _Server((host, port))
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        """Base URL of the endpoint (``http://host:port``)."""
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        """Begin serving on a daemon thread; returns self for chaining."""
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="repro-obs-http", daemon=True
        )
        self._thread.start()
        return self

    def update(self, snapshot: dict) -> None:
        """Atomically replace the snapshot served at ``/`` and ``/metrics``."""
        self._server.set_snapshot(snapshot)

    def stop(self) -> None:
        """Shut the server down and join its thread (idempotent)."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._server.server_close()
            self._thread = None
