"""HTTP observability sidecar for the gRPC serving process (the port of
``lumen_tpu/serving/observability.py``).

A stdlib ``http.server`` thread exposing:

- ``GET  /metrics``        — Prometheus text exposition (cumulative
  ``le``-labeled ``_bucket`` histograms + ``_sum``/``_count``),
- ``GET  /metrics.json``   — JSON snapshot (per-task p50/p90/p99, errors,
  counters, gauge providers such as ``vlm-continuous:{name}``, and the
  CUDA allocator's per-device memory),
- ``GET  /stats?window=N`` — rolling-window capacity view: last-N-seconds
  task latencies/rates, device duty cycles, and the SLO summary (see
  ``utils/telemetry.py``),
- ``GET  /slo``            — SLO objectives + multi-window burn state,
- ``GET  /autopilot``      — the capacity controller's state (not ported:
  answers "not loaded"),
- ``GET  /peers``          — federation peers (not ported: answers "not
  loaded"),
- ``GET  /events?n=K``     — the incident flight recorder's event ring,
- ``GET  /incidents``      — captured incident bundles,
- ``GET  /traces``         — retained request traces (see
  ``utils/trace.py``),
- ``GET  /traces/perfetto``— the same traces as Chrome trace-event JSON,
- ``POST /profiler/start`` — begin a ``torch.profiler`` session (CPU and,
  on the card, CUDA activity; query parameter ``dir=...``, default
  ``lumen-tpu-torch-trace`` under the temporary directory),
- ``POST /profiler/stop``  — end it and write a Chrome trace
  (``trace.json``, loadable in Perfetto next to ``/traces/perfetto``) into
  that directory; the response carries the directory.

Enabled with ``--metrics-port N`` (``serve(metrics_port=N)``; 0 binds an
OS-assigned port, ``handle.metrics_server.port``).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils import telemetry
from ..utils.metrics import metrics
from ..utils.trace import get_recorder

logger = logging.getLogger(__name__)

DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(), "lumen-tpu-torch-trace")

#: the Chrome trace file a profiler session writes into its directory.
TRACE_FILE = "trace.json"

#: sibling package module the /autopilot and /peers routes read, looked up
#: by name so a process that never loaded it answers honestly.
_RUNTIME = f"{__package__.rpartition('.')[0]}.runtime"


class _ProfilerState:
    """One ``torch.profiler`` session at a time (the JAX sidecar's
    ``jax.profiler.start_trace`` / ``stop_trace``). The session lives on a
    thread of its own: the profiler must start and stop on one thread, and
    the HTTP server answers each request on a new one. Device activity is
    traced whatever thread launched it."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.active_dir: str | None = None
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self._outcome: dict = {}

    def start(self, trace_dir: str) -> tuple[bool, str]:
        import torch

        with self.lock:
            if self.active_dir:
                return False, f"trace already running into {self.active_dir}"
            os.makedirs(trace_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            started, stop, outcome = threading.Event(), threading.Event(), {}

            def session() -> None:
                try:
                    prof = torch.profiler.profile(activities=activities)
                    prof.start()
                except BaseException as e:  # noqa: BLE001 - reported by start()
                    outcome["error"] = e
                    started.set()
                    return
                started.set()
                stop.wait()
                try:
                    prof.stop()
                    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
                except BaseException as e:  # noqa: BLE001 - reported by stop()
                    outcome["error"] = e

            thread = threading.Thread(target=session, name="torch-profiler", daemon=True)
            thread.start()
            started.wait()
            if "error" in outcome:
                thread.join()
                raise outcome["error"]
            self.active_dir, self._stop, self._thread, self._outcome = trace_dir, stop, thread, outcome
            return True, trace_dir

    def stop(self) -> tuple[bool, str]:
        with self.lock:
            if not self.active_dir:
                return False, "no trace running"
            self._stop.set()
            self._thread.join()
            trace_dir, self.active_dir = self.active_dir, None
            if "error" in self._outcome:
                raise self._outcome["error"]
            return True, trace_dir


class MetricsServer:
    """Threaded HTTP sidecar; ``start()`` returns the bound port."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        # Loopback default on purpose: /profiler/* is unauthenticated
        # control; exposing it beyond the host must be an explicit choice.
        self.host = host
        self.port = port
        self.profiler = _ProfilerState()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> int:
        profiler = self.profiler

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A002 - silence stdlib access log
                logger.debug("metrics: " + fmt, *args)

            def _send(self, code: int, body: str, content_type: str = "application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 - stdlib API
                parsed = urlparse(self.path)
                path = parsed.path
                if path == "/metrics":
                    self._send(200, "\n".join(metrics.prometheus_lines()) + "\n", "text/plain; version=0.0.4")
                elif path == "/metrics.json":
                    snap = metrics.snapshot()
                    snap["device_memory"] = metrics.device_memory()
                    self._send(200, json.dumps(snap))
                elif path == "/stats":
                    q = parse_qs(parsed.query)
                    try:
                        window = float(q.get("window", ["60"])[0])
                    except ValueError:
                        window = 60.0
                    self._send(200, json.dumps(telemetry.capacity_stats(window)))
                elif path == "/slo":
                    self._send(200, json.dumps(telemetry.slo_report()))
                elif path == "/autopilot":
                    # Read the controller only when its module is loaded;
                    # otherwise answer "off" honestly.
                    mod = sys.modules.get(f"{_RUNTIME}.autopilot")
                    if mod is None:
                        body = {
                            "enabled": False, "running": False,
                            "loops": {}, "decisions": [],
                            "detail": "autopilot module not loaded in this process",
                        }
                    else:
                        try:
                            body = mod.export_status()
                        except Exception as e:  # noqa: BLE001 - report, don't 500
                            body = {"enabled": False, "running": False,
                                    "loops": {}, "decisions": [],
                                    "error": str(e)}
                    self._send(200, json.dumps(body))
                elif path == "/peers":
                    # Same rule as /autopilot for the federation module.
                    mod = sys.modules.get(f"{_RUNTIME}.federation")
                    if mod is None:
                        body = {
                            "enabled": False, "peers": {},
                            "detail": "federation module not loaded in this process",
                        }
                    else:
                        try:
                            body = mod.export_status()
                        except Exception as e:  # noqa: BLE001 - report, don't 500
                            body = {"enabled": False, "peers": {}, "error": str(e)}
                    self._send(200, json.dumps(body))
                elif path == "/events":
                    q = parse_qs(parsed.query)
                    try:
                        n = int(q.get("n", ["0"])[0])
                    except ValueError:
                        n = 0
                    # n caps the tail; zero/negative means "everything"
                    # (a negative slice bound would silently invert the
                    # semantics to drop-oldest-K).
                    self._send(
                        200,
                        json.dumps(telemetry.export_events(n if n > 0 else None)),
                    )
                elif path == "/incidents":
                    self._send(200, json.dumps(telemetry.export_incidents()))
                elif path == "/traces":
                    self._send(200, json.dumps(get_recorder().export()))
                elif path == "/traces/perfetto":
                    self._send(200, json.dumps(get_recorder().perfetto()))
                elif path == "/health":
                    self._send(200, json.dumps({"status": "ok"}))
                else:
                    self._send(404, json.dumps({"error": "not found"}))

            def do_POST(self):  # noqa: N802 - stdlib API
                parsed = urlparse(self.path)
                if parsed.path == "/profiler/start":
                    q = parse_qs(parsed.query)
                    trace_dir = q.get("dir", [DEFAULT_TRACE_DIR])[0]
                    try:
                        ok, detail = profiler.start(trace_dir)
                    except Exception as e:  # noqa: BLE001 - report to client
                        self._send(500, json.dumps({"error": str(e)}))
                        return
                    self._send(200 if ok else 409, json.dumps({"tracing": ok, "dir": detail}))
                elif parsed.path == "/profiler/stop":
                    try:
                        ok, detail = profiler.stop()
                    except Exception as e:  # noqa: BLE001
                        self._send(500, json.dumps({"error": str(e)}))
                        return
                    self._send(200 if ok else 409, json.dumps({"stopped": ok, "dir": detail}))
                else:
                    self._send(404, json.dumps({"error": "not found"}))

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http", daemon=True
        )
        self._thread.start()
        logger.info("metrics endpoint on http://%s:%d/metrics", self.host, self.port)
        return self.port

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
