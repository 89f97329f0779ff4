"""Managed gRPC server subprocess (reference ``services/server_manager.py``).

The port's copy of the JAX package's ``app/server_manager.py``. Spawns
``python -m lumen_tpu_torch.serving.server --config <path>`` (the process
boundary of SURVEY.md §3.5; :meth:`ServerManager.command` builds the argv),
captures merged stdout/stderr into the app log broadcast, waits for the
readiness line, health-checks over gRPC, and supports stop (SIGTERM ->
kill) and restart.

Where the child runs comes from the config: every service states
``backend_settings.device`` (``config_gen`` writes the preset's). When
all say ``cpu`` the child gets ``--device cpu`` -- the caller asking for
the CPU; otherwise it serves on the card (the server's default, which
fails without one). A config whose services disagree is refused: one
server process serves on one device.
"""

from __future__ import annotations

import asyncio
import logging
import re
import signal
import sys
import time
from enum import Enum

logger = logging.getLogger(__name__)

# Emitted by lumen_tpu_torch.serving.server.serve() once the port is bound
# ("serving 4 service(s) on 0.0.0.0:50051 (cuda:0): [...]").
READY_RE = re.compile(r"serving \d+ service\(s\) on (\S+):(\d+)")
# Emitted by the observability sidecar when --metrics-port is passed.
METRICS_RE = re.compile(r"metrics endpoint on http://(\S+):(\d+)/metrics")


class ServerStatus(str, Enum):
    STOPPED = "stopped"
    STARTING = "starting"
    RUNNING = "running"
    FAILED = "failed"


def config_device_args(config_path: str) -> list[str]:
    """The server CLI's device arguments for a config: ``--device cpu``
    when every enabled service says ``device: cpu``, none when they say
    the card (or nothing: the card is the default); raises ``ValueError``
    when they disagree."""
    from lumen_tpu_torch.core.config import load_config

    cfg = load_config(config_path)
    devices = {
        name: (svc.backend_settings.device or "cuda").split(":")[0]
        for name, svc in cfg.enabled_services().items()
    }
    if len(set(devices.values())) > 1:
        raise ValueError(f"services disagree on their device: {devices}; one server serves on one device")
    return ["--device", "cpu"] if set(devices.values()) == {"cpu"} else []


class ServerManager:
    #: the program the child runs; the config and arguments follow
    server_argv: tuple[str, ...] = (sys.executable, "-m", "lumen_tpu_torch.serving.server")
    #: generous StreamReader limit — one over-long child log line must
    #: not kill the capture task before the readiness line is seen
    STREAM_LIMIT = 1 << 20

    def __init__(self, state, ready_timeout: float = 600.0) -> None:
        self.state = state
        self.ready_timeout = ready_timeout
        self.proc: asyncio.subprocess.Process | None = None
        self.status = ServerStatus.STOPPED
        self.port: int | None = None
        self.metrics_port: int | None = None
        self.config_path: str | None = None
        self.extra_args: list[str] = []
        self.started_at: float | None = None
        self.exit_code: int | None = None  # last child exit (crash triage)
        self._ready = asyncio.Event()
        self._capture_task: asyncio.Task | None = None
        # Serializes start/stop/restart: two concurrent starts must not both
        # pass the running-check and leak an unmanaged child.
        self._lifecycle = asyncio.Lock()

    # -- lifecycle --------------------------------------------------------

    async def start(self, config_path: str, extra_args: list[str] | None = None) -> dict:
        async with self._lifecycle:
            return await self._start_locked(config_path, extra_args)

    async def _start_locked(self, config_path: str, extra_args: list[str] | None) -> dict:
        if self.proc and self.proc.returncode is None:
            raise RuntimeError("server already running; stop it first")
        try:
            cmd = self.command(config_path, extra_args)
        except Exception as e:  # noqa: BLE001 - an unreadable or mixed-device config is refused
            raise RuntimeError(f"cannot start {config_path}: {e}") from e
        self._ready.clear()
        self.status = ServerStatus.STARTING
        self.config_path = config_path
        self.extra_args = list(extra_args or [])
        self.port = None
        self.metrics_port = None
        self.exit_code = None
        self.state.broadcast_log(f"starting server: {' '.join(cmd)}", source="server")
        self.proc = await asyncio.create_subprocess_exec(
            *cmd,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
            limit=self.STREAM_LIMIT,
        )
        self.started_at = time.time()
        self._capture_task = asyncio.ensure_future(self._capture_logs())
        try:
            await asyncio.wait_for(self._ready.wait(), timeout=self.ready_timeout)
        except asyncio.TimeoutError:
            self.status = ServerStatus.FAILED
            await self._stop_locked(force=True)
            raise RuntimeError(f"server not ready within {self.ready_timeout}s") from None
        if self.status != ServerStatus.RUNNING:  # process died before ready
            raise RuntimeError("server exited during startup; see logs")
        return self.info()

    def command(self, config_path: str, extra_args: list[str] | None = None) -> list[str]:
        """The child's argv: :attr:`server_argv` on the config, its device
        arguments (:func:`config_device_args`), then ``extra_args``."""
        return [*self.server_argv, "--config", config_path, *config_device_args(config_path), *(extra_args or [])]

    async def _capture_logs(self) -> None:
        """Readiness scan + log bridge (reference ``server_manager.py:317-382``)."""
        assert self.proc and self.proc.stdout
        async for raw in self.proc.stdout:
            line = raw.decode(errors="replace").rstrip()
            self.state.broadcast_log(line, source="server")
            m = READY_RE.search(line)
            if m:
                self.port = int(m.group(2))
                self.status = ServerStatus.RUNNING
                self._ready.set()
            m = METRICS_RE.search(line)
            if m:
                self.metrics_port = int(m.group(2))
        # EOF: process exited.
        rc = await self.proc.wait()
        self.exit_code = rc
        if self.status in (ServerStatus.STARTING, ServerStatus.RUNNING):
            self.status = ServerStatus.FAILED if rc else ServerStatus.STOPPED
        self.state.broadcast_log(f"server exited with code {rc}", source="server")
        self._ready.set()  # unblock any waiter

    async def stop(self, force: bool = False, grace: float = 10.0) -> None:
        async with self._lifecycle:
            await self._stop_locked(force=force, grace=grace)

    async def _stop_locked(self, force: bool = False, grace: float = 10.0) -> None:
        if not self.proc:
            self.status = ServerStatus.STOPPED
            return
        if self.proc.returncode is None:
            self.proc.send_signal(signal.SIGKILL if force else signal.SIGTERM)
            try:
                await asyncio.wait_for(self.proc.wait(), timeout=grace)
            except asyncio.TimeoutError:
                self.proc.kill()
                await self.proc.wait()
        if self._capture_task:
            await self._capture_task
            self._capture_task = None
        self.proc = None
        self.port = None
        self.metrics_port = None
        self.status = ServerStatus.STOPPED

    async def restart(self) -> dict:
        async with self._lifecycle:
            if not self.config_path:
                raise RuntimeError("no previous start to restart")
            path, args = self.config_path, list(self.extra_args)
            await self._stop_locked()
            return await self._start_locked(path, args)

    # -- introspection ----------------------------------------------------

    async def health_check(self, timeout: float = 5.0) -> bool:
        """gRPC ``Health`` probe against the child (requires RUNNING)."""
        if self.status != ServerStatus.RUNNING or not self.port:
            return False

        def _probe() -> bool:
            import grpc
            from google.protobuf import empty_pb2

            from lumen_tpu_torch.serving.proto import ml_service_pb2_grpc

            with grpc.insecure_channel(f"127.0.0.1:{self.port}") as chan:
                stub = ml_service_pb2_grpc.InferenceStub(chan)
                # Health returns Empty and signals unhealthiness via RPC
                # status (proto contract: ml_service.proto:31).
                stub.Health(empty_pb2.Empty(), timeout=timeout)
                return True

        try:
            return await asyncio.to_thread(_probe)
        except Exception:  # noqa: BLE001 - any RPC failure is "unhealthy"
            return False

    async def fetch_metrics(self, timeout: float = 5.0) -> dict | None:
        """Snapshot of the child's per-task latency metrics (requires the
        server to have been started with --metrics-port)."""
        if self.status != ServerStatus.RUNNING or not self.metrics_port:
            return None

        def _fetch() -> dict:
            import json
            import urllib.request

            url = f"http://127.0.0.1:{self.metrics_port}/metrics.json"
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return json.loads(r.read().decode())

        try:
            return await asyncio.to_thread(_fetch)
        except Exception:  # noqa: BLE001 - metrics are best-effort
            return None

    def info(self) -> dict:
        return {
            "status": self.status.value,
            "pid": self.proc.pid if self.proc and self.proc.returncode is None else None,
            "port": self.port,
            "metrics_port": self.metrics_port,
            "config_path": self.config_path,
            "exit_code": self.exit_code,
            "uptime_s": round(time.time() - self.started_at, 1) if self.started_at and self.status == ServerStatus.RUNNING else None,
        }
