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
the HTTP sidecar (``observability.py``) on loopback.

Fleets, as in the JAX server: with ``LUMEN_FED_PEERS`` set and no enabled
service, the server boots as a federation FRONT TIER
(``FederationRouter``): it owns no model, touches no device and resolves
none, and consistent-hash-routes every request over its peers. With
services and peers it is a peer-aware backend: the result cache consults
the ring owner's cache on a miss (when ``LUMEN_FED_SELF`` names this host
in the peer list), and every continuous VLM engine can migrate a
prefilled row's KV pages to a decode-lane peer and accept rows migrated
to it (``LUMEN_FED_ROLE``). ``LUMEN_AUTOPILOT=1`` starts the capacity
controller, ``server.mdns`` in the config advertises the server on the
LAN, and a drain holds the server open until a watching front has read
the draining flag (``LUMEN_DRAIN_ANNOUNCE_S``). Without
``LUMEN_FED_PEERS`` none of this starts: no thread, no gauge.
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
from .mdns import MdnsAdvertiser
from .resilience import DegradedService, RecoveryManager, expected_tasks_for
from .router import FederationRouter, HubRouter

logger = logging.getLogger(__name__)

GRPC_OPTIONS = [
    ("grpc.max_send_message_length", 64 * 1024 * 1024),
    ("grpc.max_receive_message_length", 64 * 1024 * 1024),
]

DRAIN_ENV = "LUMEN_DRAIN_S"
DRAIN_ANNOUNCE_ENV = "LUMEN_DRAIN_ANNOUNCE_S"

#: a capacity probe older than this means nobody is watching anymore (a
#: front polls every LUMEN_FED_POLL_S, default 2s) -- don't hold shutdown
#: for a departed observer.
_DRAIN_WATCHER_STALE_S = 15.0


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


def drain_announce_s() -> float:
    """``LUMEN_DRAIN_ANNOUNCE_S``: max extra seconds an idle drain holds
    the server open so capacity gossip can announce the draining flag to a
    watching front (default 5; ``0`` disables the hold). Only applies when
    a Health probe carried this host's capacity report recently -- a
    standalone or ungossiped server shuts down exactly as before. The hold
    ends early the moment a probe is served with the flag set, plus a
    short margin for the front's hot-key handoff fetches to arrive; always
    capped by the remaining ``LUMEN_DRAIN_S`` budget."""
    return env_float(DRAIN_ANNOUNCE_ENV, 5.0, minimum=0.0)


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
        metrics_server=None, mdns: MdnsAdvertiser | None = None, autopilot=None, federation=None,
    ):
        self.server = server
        self.port = port
        self.router = router
        self.metrics_server = metrics_server
        self.mdns = mdns
        self.autopilot = autopilot
        self.federation = federation
        # Live view: recovery hot-swaps promoted services into this dict
        # (it is the router's), so teardown closes what is actually running.
        self.services = router.services
        self.recovery = recovery

    def drain_and_stop(self, drain_s: float | None = None) -> None:
        """Graceful shutdown: refuse new RPCs (the router answers in-band
        UNAVAILABLE with a ``lumen-retry-after-ms`` hint while the gRPC
        server keeps accepting), hold until a watching front has read the
        draining flag (``LUMEN_DRAIN_ANNOUNCE_S``), let in-flight streams
        complete for up to ``drain_s`` (``LUMEN_DRAIN_S``), then tear
        down."""
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
        # Announce hold: a PLANNED shutdown must be gossiped, not
        # discovered. If a front was recently reading our capacity report
        # off Health probes, an idle drain would otherwise tear the
        # listener down before the next poll, and the front would eject us
        # through failover (a fed_peer_down incident) instead of
        # re-weighting to zero and prefetching hot keys. Hold (bounded)
        # until a probe is served WITH the draining flag, then a short
        # margin so the front's handoff fetches land while we still answer.
        announce_s = drain_announce_s()
        probe_age = self.router.capacity_probe_age()
        if announce_s > 0 and probe_age is not None and probe_age <= _DRAIN_WATCHER_STALE_S:
            announce_deadline = min(deadline, started + announce_s)
            while not self.router.drain_announced() and time.monotonic() < announce_deadline:
                time.sleep(0.05)
            if self.router.drain_announced():
                logger.info(
                    "drain: draining flag gossiped to a watching front (%.2fs after SIGTERM)",
                    time.monotonic() - started,
                )
                time.sleep(min(1.0, max(deadline - time.monotonic(), 0.0)))
            else:
                logger.info("drain: no probe observed the draining flag within %.1fs; proceeding", announce_s)
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
        if self.autopilot is not None:
            # First of all: the controller must not actuate (park, force a
            # rung, retune a window) against services mid-teardown, and the
            # process-wide slot must not keep advertising a dead controller.
            from ..runtime.autopilot import get_autopilot, install_autopilot

            self.autopilot.stop()
            if get_autopilot() is self.autopilot:
                install_autopilot(None)
            self.autopilot = None
        if self.federation is not None:
            # Fleet teardown next: the poller must stop probing (and the
            # process-wide slot stop advertising on /peers) before the
            # services it might mark healthy are closed underneath it.
            from ..runtime.federation import get_federation, install_federation
            from ..runtime.result_cache import detach_peer_lookup

            detach_peer_lookup(self.federation.peer_cache_lookup)
            self.federation.close()
            if get_federation() is self.federation:
                install_federation(None)
            self.federation = None
        if self.recovery:
            # Next: a recovery attempt finishing mid-shutdown would swap a
            # fresh service in after the close pass below already ran.
            self.recovery.stop()
        if self.mdns:
            self.mdns.stop()
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
    card) reaches every service's ``from_config``. A front tier (peers and
    no enabled service) owns no model and resolves no device.
    ``port_override=0`` binds an OS-assigned port (``handle.port``);
    ``metrics_port`` starts the HTTP sidecar on loopback (0: an
    OS-assigned port, ``handle.metrics_server.port``)."""
    from ..runtime.compile_cache import enable_persistent_cache
    from ..runtime.federation import maybe_federation

    enable_persistent_cache()  # warm restarts load built kernel libraries
    # Fleet federation (LUMEN_FED_PEERS / LUMEN_FED_DISCOVER): resolved
    # once at boot, logged once. Unset -> None having done nothing: no
    # thread, no gauge.
    federation = maybe_federation()
    recovery: RecoveryManager | None = None
    if not config.enabled_services():
        if federation is None:
            logger.error("no enabled services selected by deployment config")
            raise SystemExit(1)
        # Front-tier mode: this server owns no models; every Infer stream
        # consistent-hash-routes over the peer set (a front tier speaks the
        # same protocol, so tiers compose).
        services: dict[str, BaseService] = {}
        router: HubRouter = FederationRouter(federation)
        where = "front tier, no device"
        logger.info(
            "front-tier mode: no local services; routing %d peer(s) with hop budget %d",
            len(federation.peers), federation.hops,
        )
    else:
        from ..runtime.quarantine import get_quarantine
        from ..runtime.result_cache import get_result_cache

        device = resolve_device(device)
        where = str(device)
        # The process-wide result cache (LUMEN_CACHE_BYTES, LUMEN_CACHE_DIR)
        # and quarantine registry, built from the environment before any
        # request.
        get_result_cache()
        get_quarantine()
        failed: dict[str, str] = {}
        if not skip_download:
            failed = ensure_models(config)
        services = build_services(config, device, failed=failed)
        router = HubRouter(services)

        def rebuild(n: str) -> BaseService:
            # A recovered or reloaded service gets a fresh breaker: the swap
            # replaces the instance whose breaker tripped.
            svc = rebuild_service(config, n, device, skip_download=skip_download)
            return attach_breaker(recovery, n, svc)

        # Built on every boot: a breaker can hand a service over for reload
        # at any point in the process's life.
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
        if federation is not None:
            attach_federation(router, services, federation)
    if federation is not None:
        federation.start()  # the one background health-poll thread

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
    # LUMEN_AUTOPILOT=1 starts the capacity controller (scale, brownout and
    # window loops over the telemetry spine); unset starts nothing.
    from ..runtime.autopilot import maybe_start_autopilot

    autopilot = maybe_start_autopilot()
    logger.info("serving %d service(s) on %s:%d (%s): %s", len(services), host, bound, where, sorted(services))
    for name, svc in services.items():
        logger.info("  %s [%s] tasks: %s", name, svc.status(), svc.registry.task_names())
    mdns = None
    mdns_cfg = config.server.mdns
    if mdns_cfg and mdns_cfg.enabled:
        mdns = MdnsAdvertiser(
            mdns_cfg.service_name or "lumen-tpu",
            bound,
            properties={"tasks": ",".join(t for s in services.values() for t in s.registry.task_names())},
        )
        mdns.start()
    return ServerHandle(
        server, bound, router, recovery, metrics_server, mdns=mdns, autopilot=autopilot, federation=federation,
    )


def attach_federation(router: HubRouter, services: dict[str, BaseService], federation) -> None:
    """Peer-aware backend wiring (the JAX ``serve``'s): fleet state rides
    this hub's Health (``lumen-fed-status``); when this server knows which
    ring member it is, local result-cache misses consult the ring owner's
    cache first; and every continuous VLM engine gets both halves of the
    KV migration wire: it can answer ``fed_kv_put`` (decode sink) and
    dispatch migrations (prefill side). Which lane a host plays is the
    front tier's routing call, from each host's ``LUMEN_FED_ROLE``."""
    from ..runtime.federation import fed_role
    from ..runtime.result_cache import get_result_cache
    from ..utils import disagg

    router.federation = federation
    if federation.self_listed:
        get_result_cache().peer_lookup = federation.peer_cache_lookup
        logger.info("federation: peer-cache lookups enabled (self=%s)", federation.self_name)
    else:
        # Unset or mislisted: either way the `owner == self` guard cannot
        # work, so no hook (the manager already warned on a mislisted self).
        logger.info(
            "federation: LUMEN_FED_SELF %s — peer-cache lookups disabled on this backend "
            "(health gossip + Health surfacing only)",
            "unset" if not federation.self_name else "not in peer list",
        )
    vlm = next((s for s in services.values() if hasattr(s, "handle_kv_put")), None)
    engines = list(getattr(getattr(vlm, "manager", None), "_engines", None) or []) if vlm is not None else []
    if engines:
        disagg.enable()
        router.kv_migration = vlm
        for eng in engines:
            eng.migrator = federation.kv_migrate
        logger.info("federation: KV migration wire enabled on %d engine(s) (role=%s)", len(engines), fed_role())


def main(argv: list[str] | None = None, on_serving=None) -> int:
    """The server CLI: serve the config until SIGINT or SIGTERM, then drain
    and stop. ``on_serving(handle)``, when given, runs once the server
    answers (a caller that embeds the CLI reads its handle there)."""
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
    if on_serving is not None:
        on_serving(handle)

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
