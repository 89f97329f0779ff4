"""Hub / single-service gRPC server of the port (console script
``lumen-tpu-torch``).

The port of ``lumen_tpu/serving/server.py``. Startup: load and validate
the config -> make the model artifacts ready (the copied downloader: a
model directory already under ``<cache_dir>/models/<name>`` with a valid
``model_info.json`` needs no network) -> build each enabled service from
its ``registry_class`` (a ``lumen_tpu.`` path resolves to the same path
in this package, see ``loader.py``) on one torch device -> bind gRPC
(OS-assigned port fallback) -> serve until SIGINT/SIGTERM, then drain.

The device is ``cuda:0`` unless the caller asks for another
(``--device cpu``); without a card ``serve`` raises instead of falling
back. A service that fails to load boots as a ``DegradedService`` and a
background ``RecoveryManager`` retries it, as in the JAX server; a
service the port does not have yet degrades the same way, with a "not
ported yet" error. Every live service gets its circuit breaker
(``LUMEN_BREAKER_FAILURES``, default 6; ``LUMEN_BREAKER_RELOAD=1`` hands
an opening breaker to recovery for a reload), the process's result cache
and quarantine registry are built at boot, and ``--metrics-port`` starts
the HTTP sidecar (``observability.py``) on loopback. Not ported yet: the
federation front tier and peer wiring, the autopilot and mDNS
advertising.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
from concurrent import futures

import grpc

from ..core.config import LumenConfig, load_config
from ..core.downloader import Downloader
from ..core.exceptions import DownloadError
from ..runtime.policy import resolve_device
from ..utils.env import env_float, env_int
from ..utils.logger import setup_logging
from .base_service import BaseService
from .breaker import CircuitBreaker, breaker_failures
from .loader import resolve
from .resilience import DegradedService, RecoveryManager, expected_tasks_for
from .router import HubRouter

logger = logging.getLogger(__name__)

GRPC_OPTIONS = [
    ("grpc.max_send_message_length", 64 * 1024 * 1024),
    ("grpc.max_receive_message_length", 64 * 1024 * 1024),
]

DRAIN_ENV = "LUMEN_DRAIN_S"


def grpc_workers() -> int:
    """``LUMEN_GRPC_WORKERS``: gRPC handler threads (default 10, the
    reference's ThreadPoolExecutor size). Each open Infer stream holds one."""
    return env_int("LUMEN_GRPC_WORKERS", 10, minimum=1)


def drain_budget_s() -> float:
    """``LUMEN_DRAIN_S``: seconds a SIGTERM/SIGINT shutdown spends
    draining (default 10) — new RPCs answer UNAVAILABLE with a retry-after
    hint while queued and in-flight work completes; stragglers past the
    budget are aborted, then the process exits. ``0`` stops at once."""
    return env_float(DRAIN_ENV, 10.0, minimum=0.0)


def build_one_service(config: LumenConfig, name: str, device) -> BaseService:
    """Load exactly one service via its ``import_info.registry_class``
    factory (``from_config(service_config, cache_dir, device=...)``).
    Shared by first boot and background recovery (including the
    ``model_load`` fault point)."""
    from ..testing.faults import faults

    svc_cfg = config.services[name]
    faults.check("model_load", name)
    cls = resolve(svc_cfg.import_info.registry_class)
    logger.info("loading service %r via %s on %s", name, svc_cfg.import_info.registry_class, device)
    return cls.from_config(svc_cfg, config.metadata.cache_path, device=device)


def build_services(
    config: LumenConfig, device, failed: dict[str, str] | None = None
) -> dict[str, BaseService]:
    """Instantiate every enabled service; services named in ``failed`` (or
    whose construction raises) become :class:`DegradedService` placeholders
    instead of killing their healthy siblings."""
    services: dict[str, BaseService] = {}
    for name, svc_cfg in config.enabled_services().items():
        error = (failed or {}).get(name)
        if error is None:
            try:
                services[name] = build_one_service(config, name, device)
                continue
            except Exception as e:  # noqa: BLE001 - degrade, don't kill siblings
                logger.exception("service %r failed to load; booting degraded", name)
                error = f"{type(e).__name__}: {e}"
        services[name] = DegradedService(
            name, error, tasks=expected_tasks_for(name, svc_cfg)
        )
    return services


def ensure_models(config: LumenConfig, strict: bool | None = None) -> dict[str, str]:
    """Fetch every enabled model; returns ``{service: error}`` for the
    services whose artifacts could not be made ready. With ``strict``
    (``LUMEN_STRICT_BOOT=1``) any failure aborts."""
    if strict is None:
        strict = os.environ.get("LUMEN_STRICT_BOOT") == "1"
    report = Downloader(config).download_all()
    failures: dict[str, str] = {}
    for r in report.failures():
        logger.error("model fetch failed: %s/%s (%s): %s", r.service, r.alias, r.model, r.error)
        msg = f"{r.alias} ({r.model}): {r.error}"
        failures[r.service] = f"{failures[r.service]}; {msg}" if r.service in failures else msg
    if failures and strict:
        raise SystemExit(1)
    return failures


def rebuild_service(config: LumenConfig, name: str, device, skip_download: bool = False) -> BaseService:
    """Recovery path for one degraded service: re-fetch its artifacts and
    reconstruct it. Raises on any failure (the RecoveryManager backs off
    and retries)."""
    if not skip_download:
        report = Downloader(config).download_service(name)
        if not report.ok:
            errs = "; ".join(f"{r.alias}: {r.error}" for r in report.failures())
            raise DownloadError(f"model fetch failed for {name!r}: {errs}")
    return build_one_service(config, name, device)


def attach_breaker(recovery: RecoveryManager, name: str, svc: BaseService) -> BaseService:
    """Give one live service its circuit breaker (JAX ``attach_breaker``):
    none for a degraded placeholder, which already fast-fails, or when
    ``LUMEN_BREAKER_FAILURES=0``. With ``LUMEN_BREAKER_RELOAD=1`` an opening
    breaker hands the service to the RecoveryManager for a full reload;
    without it the breaker sheds and half-open-probes, and a reload stays
    an operator's decision."""
    if isinstance(svc, DegradedService) or breaker_failures() == 0:
        return svc
    reload_on_open = os.environ.get("LUMEN_BREAKER_RELOAD") == "1"

    def on_open() -> None:
        if reload_on_open:
            logger.warning("breaker for %r opened: handing to recovery for a reload", name)
            recovery.register(name)

    svc.breaker = CircuitBreaker(name, on_open=on_open)
    return svc


class ServerHandle:
    """A running gRPC server and its lifecycle (returned by ``serve``; the
    CLI blocks on ``wait``)."""

    def __init__(
        self, server: grpc.Server, port: int, router: HubRouter, recovery: RecoveryManager | None,
        metrics_server=None,
    ):
        self.server = server
        self.port = port
        self.router = router
        self.metrics_server = metrics_server
        # Live view: recovery hot-swaps promoted services into this dict
        # (it is the router's), so teardown closes what is actually running.
        self.services = router.services
        self.recovery = recovery

    def drain_and_stop(self, drain_s: float | None = None) -> None:
        """Graceful shutdown: refuse new RPCs (the router answers in-band
        UNAVAILABLE with a ``lumen-retry-after-ms`` hint while the gRPC
        server keeps accepting), let in-flight streams complete for up to
        ``drain_s`` (``LUMEN_DRAIN_S``), then tear down."""
        import time

        from ..utils import telemetry

        if drain_s is None:
            drain_s = drain_budget_s()
        if drain_s <= 0:
            self.stop()
            return
        started = time.monotonic()
        deadline = started + drain_s
        self.router.begin_drain(retry_after_s=max(drain_s, 1.0))
        telemetry.record_event(
            "server_drain", "server",
            f"drain started: refusing new RPCs, draining in-flight work (budget {drain_s:.0f}s)",
        )
        while self.router.active_streams() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        stragglers = self.router.active_streams()
        self.stop(grace=max(deadline - time.monotonic(), 0.5))
        telemetry.record_event(
            "server_drain", "server",
            f"drain complete in {time.monotonic() - started:.2f}s "
            f"({stragglers} straggler stream(s) past the budget); exiting",
        )

    def stop(self, grace: float = 5.0) -> None:
        if self.recovery:
            # First: a recovery attempt finishing mid-shutdown would swap a
            # fresh service in after the close pass below already ran.
            self.recovery.stop()
        if self.metrics_server:
            self.metrics_server.stop()
        # Let in-flight RPCs drain first, then close the services so their
        # engine threads retire cleanly. grpc sets the stop event only
        # after aborting stragglers at t=grace, hence the margin.
        self.server.stop(grace).wait(grace + 5.0)
        for name, svc in list(self.services.items()):
            close = getattr(svc, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    logger.exception("closing service %r failed", name)

    def wait(self) -> None:
        self.server.wait_for_termination()


def serve(
    config: LumenConfig,
    port_override: int | None = None,
    skip_download: bool = False,
    metrics_port: int | None = None,
    device=None,
) -> ServerHandle:
    """Boot the server; ``device`` (default ``cuda:0``, raising without a
    card) reaches every service's ``from_config``. ``port_override=0``
    binds an OS-assigned port (``handle.port``); ``metrics_port`` starts
    the HTTP sidecar on loopback (0: an OS-assigned port,
    ``handle.metrics_server.port``)."""
    from ..runtime.quarantine import get_quarantine
    from ..runtime.result_cache import get_result_cache

    device = resolve_device(device)
    # The process-wide result cache (LUMEN_CACHE_BYTES, LUMEN_CACHE_DIR) and
    # quarantine registry, built from the environment before any request.
    get_result_cache()
    get_quarantine()
    failed: dict[str, str] = {}
    if not skip_download:
        failed = ensure_models(config)
    services = build_services(config, device, failed=failed)
    if not services:
        logger.error("no enabled services selected by deployment config")
        raise SystemExit(1)
    router = HubRouter(services)

    def rebuild(n: str) -> BaseService:
        # A recovered or reloaded service gets a fresh breaker: the swap
        # replaces the instance whose breaker tripped.
        svc = rebuild_service(config, n, device, skip_download=skip_download)
        return attach_breaker(recovery, n, svc)

    # Built on every boot: a breaker can hand a service over for reload at
    # any point in the process's life.
    recovery = RecoveryManager(router, rebuild=rebuild)
    for name, svc in services.items():
        attach_breaker(recovery, name, svc)
    degraded = sorted(n for n, s in services.items() if isinstance(s, DegradedService))
    if degraded:
        logger.warning(
            "booting with %d degraded service(s): %s — healthy siblings keep "
            "serving; background recovery is retrying the failed loads",
            len(degraded), degraded,
        )
        for name in degraded:
            recovery.register(name)
    recovery.start()

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=grpc_workers(), thread_name_prefix="grpc"),
        options=GRPC_OPTIONS,
    )
    router.attach_to_server(server)
    host = config.server.host
    port = config.server.port if port_override is None else port_override
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        # Requested port unavailable: fall back to an OS-assigned one
        # (reference behavior, src/lumen/server.py:242-263).
        bound = server.add_insecure_port(f"{host}:0")
        if bound == 0:
            logger.error("could not bind any port on %s", host)
            raise SystemExit(1)
        logger.warning("port %d unavailable; bound %d instead", port, bound)
    server.start()
    # The sidecar starts (and logs its endpoint) before the readiness line:
    # a supervisor reads that line as "fully up". Loopback only: the
    # profiler control must not be reachable from the network.
    metrics_server = None
    if metrics_port is not None:
        from .observability import MetricsServer

        metrics_server = MetricsServer(port=metrics_port, host="127.0.0.1")
        metrics_server.start()
    logger.info("serving %d service(s) on %s:%d (%s): %s", len(services), host, bound, device, sorted(services))
    for name, svc in services.items():
        logger.info("  %s [%s] tasks: %s", name, svc.status(), svc.registry.task_names())
    return ServerHandle(server, bound, router, recovery, metrics_server)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="lumen-tpu-torch",
        description="lumen-tpu inference server on PyTorch/CUDA",
        epilog="Models are fetched by the configured downloader; with --skip-download "
        "(or without network) a model is served from <cache_dir>/models/<name>.",
    )
    parser.add_argument("--config", required=True, help="path to lumen config YAML")
    parser.add_argument("--port", type=int, default=None, help="override configured port")
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument(
        "--skip-download", action="store_true", help="assume model artifacts are already cached"
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to serve on (default cuda:0; 'cpu' for a run without a card)",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve /metrics, /metrics.json, /traces and the profiler on this loopback port",
    )
    args = parser.parse_args(argv)

    setup_logging(args.log_level)
    config = load_config(args.config)
    handle = serve(
        config, port_override=args.port, skip_download=args.skip_download,
        metrics_port=args.metrics_port, device=args.device,
    )

    stop_event = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001
        logger.info("signal %d received; shutting down", signum)
        stop_event.set()

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    while not stop_event.wait(timeout=1.0):
        pass
    handle.drain_and_stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
