"""Hub router: one gRPC endpoint multiplexing several model services.

Same role as the reference ``src/lumen/router.py:10-87``: a routing table
from task key -> child service is built from each child's registry; ``Infer``
peeks at the first message of the stream to pick the child and then forwards
the whole stream zero-copy; capabilities aggregate.

Resilience semantics on top of the reference:

- services can be hot-swapped (:meth:`replace_service`) — the background
  recovery loop promotes a ``DegradedService`` placeholder to the real
  service without restarting the server; the route table rebuilds
  atomically under a lock;
- ``Health`` reports per-service status in trailing metadata
  (``lumen-service-status``: JSON ``{name: state}``). A *degraded* service
  (known-broken, recovering) does NOT fail hub health — healthy siblings
  keep serving; an *unhealthy* one (unexpected) still aborts UNAVAILABLE,
  as does a hub with no working service at all;
- an unknown task while some service is degraded answers UNAVAILABLE with
  the degraded-service hint, not INVALID_ARGUMENT — the task may well
  belong to the broken service, and "client bug" is the wrong message;
- containment state is first-class: per-service circuit-breaker states
  ride ``Health`` trailing metadata (``lumen-breaker-status``) and each
  ``StreamCapabilities`` record (``extra["breaker"]``), and the current
  poison-quarantine size rides ``lumen-quarantine-size`` — a client can
  tell "backend fast-failing" from "overloaded" without a failed Infer;
- multi-tenant QoS state rides ``lumen-qos-status`` (per-admission-queue
  occupancy + brownout level, per-tenant quota admit/shed totals) so an
  operator sees "tenant X is being browned out" from a Health probe, and
  each ``StreamCapabilities`` record carries ``extra["qos"]``;
- SLO burn state rides ``lumen-slo-status`` (per-task breach/ok + 5m/1h
  error-budget burn rates from ``utils/telemetry.py``) — a Health probe
  is also the lazy SLO evaluation tick, so breach counters and incident
  bundles fire within one probe of the window turning bad.

The port's copy of ``lumen_tpu/serving/router.py``: ``HubRouter`` and the
module helpers it uses. Not ported yet, each with its own slice: the
federation front tier (``FederationRouter``) and the reserved
``fed_cache_lookup`` / ``fed_kv_put`` tasks it and disaggregated decode
answer (peer result-cache reads, KV page migration), the result cache
whose namespaces a hot-swap invalidates, and the quarantine and autopilot
states on ``Health``. A reserved task name therefore routes like any
other here: no service registers it, so it answers INVALID_ARGUMENT.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from typing import Iterable, Iterator

import grpc
from google.protobuf import empty_pb2

from .base_service import BaseService
from .proto import ml_service_pb2 as pb
from .proto.ml_service_pb2_grpc import InferenceServicer

logger = logging.getLogger(__name__)

#: env knob selecting this host's lane in a disaggregated fleet.
ROLE_ENV = "LUMEN_FED_ROLE"

#: gRPC metadata key a host's lane rides on Health TRAILING metadata —
#: peers learn each other's roles passively from the probe they already
#: run, no new RPC. Absent = unconfigured = serves both lanes.
FED_ROLE_META = "lumen-fed-role"

FED_ROLES = ("prefill", "decode", "both")

#: env knob opting a fleet into capacity gossip: when "1", each host's
#: Health trailing metadata carries a compact capacity report (duty
#: fraction, worst SLO burn, drain flag) and the federation front scales
#: ring weights from it. Unset keeps the Health payload — and the ring —
#: byte-identical to pre-capacity builds.
FED_CAPACITY_ENV = "LUMEN_FED_CAPACITY"

#: gRPC metadata key the capacity report rides on Health TRAILING
#: metadata — same passive channel as :data:`FED_ROLE_META`: peers learn
#: each other's headroom from the probe they already run, no new RPC.
FED_CAPACITY_META = "lumen-fed-capacity"

_ROLE_WARNED = False


def capacity_gossip_enabled() -> bool:
    """Whether this process participates in capacity gossip (report on
    the server side, weighted ring + drain handoff on the front). Read
    fresh on each call — it gates per-probe work, not a latched
    structure."""
    return os.environ.get(FED_CAPACITY_ENV, "") == "1"


def advertised_fed_role() -> str | None:
    """This host's ``LUMEN_FED_ROLE`` lane, or None when unset. None
    advertises nothing — an unconfigured host's Health payload (and
    every request path) stays byte-identical to pre-role builds. A
    malformed value warns once and behaves as unset: serve both lanes,
    degrade rather than crash."""
    raw = (os.environ.get(ROLE_ENV) or "").strip().lower()
    if not raw:
        return None
    if raw not in FED_ROLES:
        global _ROLE_WARNED
        if not _ROLE_WARNED:
            _ROLE_WARNED = True
            logger.warning(
                "%s=%r is not one of %s; serving both lanes",
                ROLE_ENV, raw, FED_ROLES,
            )
        return None
    return raw


class HubRouter(InferenceServicer):
    def __init__(self, services: dict[str, BaseService]):
        self.services = dict(services)
        self._lock = threading.Lock()
        self._route_table: dict[str, BaseService] = {}
        # Graceful-drain gate: once set, new Infer streams answer
        # UNAVAILABLE with a retry-after hint while queued/in-flight work
        # completes (see ServerHandle.drain_and_stop). _active_streams
        # counts forwarded Infer streams so the drain knows when the last
        # one finished — gRPC itself does not expose this.
        self._draining = False
        self._drain_retry_ms = "1000"
        self._active_streams = 0
        # Capacity-gossip observation timestamps (monotonic; 0.0 = never):
        # when a Health probe last carried our capacity report, and when
        # one carried it with the draining flag SET. The drain sequencer
        # reads these to hold teardown until a watching front has actually
        # seen the flag — without a watcher, shutdown is unchanged.
        self._capacity_probe_t = 0.0
        self._drain_announced_t = 0.0
        self._rebuild_routes()

    def begin_drain(self, retry_after_s: float = 1.0) -> None:
        """Stop admitting new RPCs: every subsequent Infer stream answers
        UNAVAILABLE carrying ``lumen-retry-after-ms`` (sized to the drain
        budget — by then this process is gone and the client's next
        attempt lands on a live sibling). In-flight streams are untouched;
        the gRPC server's grace period drains them."""
        from ..utils.qos import retry_after_ms

        self._drain_retry_ms = retry_after_ms(max(retry_after_s, 0.001))
        self._draining = True
        logger.info(
            "drain: refusing new RPCs (retry-after %sms)", self._drain_retry_ms
        )

    @property
    def draining(self) -> bool:
        return self._draining

    def capacity_probe_age(self) -> float | None:
        """Seconds since a Health probe last carried this host's capacity
        report (None = never, i.e. gossip off or nobody watching)."""
        if self._capacity_probe_t <= 0.0:
            return None
        return max(0.0, time.monotonic() - self._capacity_probe_t)

    def drain_announced(self) -> bool:
        """Whether a capacity report with the draining flag SET has been
        served since :meth:`begin_drain` — i.e. a watching front has had
        the chance to re-weight us to zero and start the hot-key handoff
        instead of discovering the shutdown through failover."""
        return self._drain_announced_t > 0.0

    def active_streams(self) -> int:
        """Forwarded Infer streams currently executing — the drain's
        "is the house empty yet" probe."""
        with self._lock:
            return self._active_streams

    def _rebuild_routes(self) -> None:
        table: dict[str, BaseService] = {}
        owner: dict[str, str] = {}
        for name, svc in self.services.items():
            for task in svc.registry.task_names():
                if task in table:
                    raise ValueError(
                        f"task {task!r} registered by multiple services "
                        f"(first: {owner[task]!r}, second: {name!r})"
                    )
                table[task] = svc
                owner[task] = name
        self._route_table = table
        logger.info(
            "hub routing table: %s",
            {t: s.registry.service_name for t, s in table.items()},
        )

    def replace_service(self, name: str, svc: BaseService) -> None:
        """Atomically swap a child service (degraded -> recovered) and
        rebuild the route table. The old service's in-flight streams keep
        their reference; new streams route to the replacement. A duplicate
        task in the replacement rolls the swap back."""
        with self._lock:
            old = self.services.get(name)
            self.services[name] = svc
            try:
                self._rebuild_routes()
            except ValueError:
                if old is None:
                    self.services.pop(name, None)
                else:
                    self.services[name] = old
                self._rebuild_routes()
                raise
        close = getattr(old, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 - best-effort teardown of the placeholder
                logger.exception("closing replaced service %r failed", name)

    def _drain_response(self, first: pb.InferRequest) -> pb.InferResponse:
        """The drain-gate refusal: in-band UNAVAILABLE with a parseable
        retry hint. ONE definition — the hub and the federation front
        tier must never drift on the drain contract."""
        from ..utils.qos import RETRY_AFTER_META

        return pb.InferResponse(
            correlation_id=first.correlation_id,
            is_final=True,
            meta={RETRY_AFTER_META: self._drain_retry_ms},
            error=pb.Error(
                code=pb.ERROR_CODE_UNAVAILABLE,
                message="server is draining for shutdown",
                detail=(
                    "graceful drain in progress; retry with backoff "
                    "(lumen-retry-after-ms) against another replica"
                ),
            ),
        )

    def _route(self, task: str) -> BaseService | None:
        with self._lock:
            return self._route_table.get(task)

    def _statuses(self) -> dict[str, str]:
        with self._lock:
            return {name: svc.status() for name, svc in sorted(self.services.items())}

    def attach_to_server(self, server: grpc.Server) -> None:
        from .proto.ml_service_pb2_grpc import add_InferenceServicer_to_server

        add_InferenceServicer_to_server(self, server)

    # -- rpcs -------------------------------------------------------------

    def Infer(self, request_iterator: Iterable[pb.InferRequest], context) -> Iterator[pb.InferResponse]:
        try:
            first = next(iter(request_iterator))
        except StopIteration:
            return
        if self._draining:
            yield self._drain_response(first)
            return
        target = self._route(first.task)
        if target is None:
            degraded = {n: s for n, s in self._statuses().items() if s in ("degraded", "failed")}
            if degraded:
                # The task may belong to a service that failed to load and
                # could not even declare its tasks — answer "broken
                # backend", not "client bug".
                yield pb.InferResponse(
                    correlation_id=first.correlation_id,
                    is_final=True,
                    error=pb.Error(
                        code=pb.ERROR_CODE_UNAVAILABLE,
                        message=(
                            f"no healthy service handles task {first.task!r}; "
                            f"degraded services: {sorted(degraded)}"
                        ),
                        detail="recovery is retrying in the background; retry later",
                    ),
                )
                return
            yield pb.InferResponse(
                correlation_id=first.correlation_id,
                is_final=True,
                error=pb.Error(
                    code=pb.ERROR_CODE_INVALID_ARGUMENT,
                    message=f"no service handles task {first.task!r}",
                    detail=f"known tasks: {sorted(self._route_table)}",
                ),
            )
            return
        # Re-prepend the consumed first message; forward the stream as-is.
        # The active-stream count brackets the forward so a drain can tell
        # "in-flight work still running" from "house empty".
        with self._lock:
            self._active_streams += 1
        try:
            yield from target.Infer(itertools.chain([first], request_iterator), context)
        finally:
            with self._lock:
                self._active_streams -= 1

    def GetCapabilities(self, request, context) -> pb.Capability:
        # Aggregate: merge every child capability into one record (the
        # detailed per-service view is StreamCapabilities).
        with self._lock:
            services = list(self.services.values())
        caps = [svc.capability() for svc in services]
        agg = pb.Capability(
            service_name="hub",
            runtime=_aggregate_runtime(caps),
            protocol_version="1.0.0",
        )
        for cap in caps:
            agg.model_ids.extend(cap.model_ids)
            agg.tasks.extend(cap.tasks)
            for p in cap.precisions:
                if p not in agg.precisions:
                    agg.precisions.append(p)
            agg.max_concurrency = max(agg.max_concurrency, cap.max_concurrency)
        return agg

    def StreamCapabilities(self, request, context) -> Iterator[pb.Capability]:
        with self._lock:
            services = list(self.services.values())
        for svc in services:
            cap = svc.capability()
            breaker = getattr(svc, "breaker", None)
            if breaker is not None:
                # Live containment state rides the capability record so a
                # client refreshing capabilities sees "backend fast-failing"
                # without a failed Infer round-trip.
                cap.extra["breaker"] = breaker.state()
            yield cap

    def _breaker_states(self) -> dict[str, str]:
        with self._lock:
            services = list(self.services.items())
        return {
            name: breaker.state()
            for name, svc in services
            if (breaker := getattr(svc, "breaker", None)) is not None
        }

    def _replica_states(self) -> dict[str, dict]:
        """Per-service replica-fleet states ({service: {dispatcher:
        {replica: state}}}); services without a fleet report nothing.
        jax-free: the states come from the service objects, the router
        never touches the runtime package."""
        with self._lock:
            services = list(self.services.items())
        out: dict[str, dict] = {}
        for name, svc in services:
            try:
                states = svc.replica_states()
            except Exception:  # noqa: BLE001 - health must never fail on telemetry
                continue
            if states:
                out[name] = states
        return out

    @staticmethod
    def _qos_status() -> dict:
        """Live multi-tenant QoS state (jax-free — the implementation
        lives in ``utils.qos`` precisely so this router can read it on
        jax-free deployments). ``{}`` omits the key entirely."""
        from ..utils import qos

        try:
            return qos.status()
        except Exception:  # noqa: BLE001 - health must never fail on telemetry
            return {}

    @staticmethod
    def _slo_state() -> dict:
        """Evaluated SLO burn state per task (jax-free — the engine lives
        in ``utils.telemetry``). ``{}`` (no objectives configured, or no
        traffic) omits the key entirely. Evaluating here is what makes a
        Health probe flip ``lumen-slo-status`` within one window: the
        engine is lazy, and Health is the operator's poll."""
        from ..utils import telemetry

        try:
            return telemetry.slo_status()
        except Exception:  # noqa: BLE001 - health must never fail on telemetry
            return {}

    def _capacity_status(self) -> dict:
        """Compact capacity report for the ``lumen-fed-capacity``
        trailing-metadata key: duty fraction (busiest device meter over
        the last 30s), worst per-task 5m SLO burn, and the drain flag —
        the three signals the front's weighted ring is built from. While
        draining, the hottest result-cache keys ride along so successors
        can prefetch them before failover would discover the drain.
        ``{}`` (knob off, or nothing to report) omits the key entirely —
        the unconfigured Health payload stays byte-identical."""
        if not capacity_gossip_enabled():
            return {}
        from ..utils import telemetry

        cap: dict = {"draining": 1 if self._draining else 0}
        try:
            duty = telemetry.device_duty(30.0)
            if duty is not None:
                cap["duty"] = round(duty, 4)
            slo = telemetry.slo_status()
            if slo:
                burns = [
                    s.get("burn_5m")
                    for s in slo.values()
                    if isinstance(s, dict) and s.get("burn_5m") is not None
                ]
                if burns:
                    cap["burn_5m"] = round(max(burns), 3)
        except Exception:  # noqa: BLE001 - health must never fail on telemetry
            pass
        return cap

    def Health(self, request, context):
        statuses = self._statuses()
        if context is not None:
            try:
                trailing = [("lumen-service-status", json.dumps(statuses))]
                breakers = self._breaker_states()
                if breakers:
                    trailing.append(("lumen-breaker-status", json.dumps(breakers)))
                replicas = self._replica_states()
                if replicas:
                    # Per-replica fleet health next to the breaker/
                    # quarantine keys: a DOWN replica is a reported
                    # condition (siblings keep the hub SERVING), exactly
                    # like a degraded sibling service.
                    trailing.append(("lumen-replica-status", json.dumps(replicas)))
                slo_state = self._slo_state()
                if slo_state:
                    # SLO burn next to the containment keys: a breaching
                    # task is a reported condition (clients may back off
                    # bulk traffic), not an outage — the hub still serves.
                    trailing.append(("lumen-slo-status", json.dumps(slo_state)))
                qos_state = self._qos_status()
                if qos_state:
                    # Multi-tenant QoS next to the containment keys:
                    # per-admission-queue occupancy/brownout and the
                    # quota gate's per-tenant admit/shed totals — a
                    # browned-out bulk lane is a reported condition, not
                    # an outage.
                    trailing.append(("lumen-qos-status", json.dumps(qos_state)))
                role = advertised_fed_role()
                if role:
                    # Disaggregation lane: peers learn it from the Health
                    # probe they already run. Unset advertises nothing —
                    # the unconfigured payload stays byte-identical.
                    trailing.append((FED_ROLE_META, role))
                cap = self._capacity_status()
                if cap:
                    # Capacity gossip: duty/burn/drain ride the probe the
                    # federation poll thread already runs — the front
                    # scales ring weights from this, no new RPC.
                    trailing.append((FED_CAPACITY_META, json.dumps(cap)))
                context.set_trailing_metadata(tuple(trailing))
                if cap:
                    # Stamp AFTER the metadata is attached: these feed the
                    # drain sequencer's "has a watcher seen the flag yet"
                    # hold, so they must mean served, not merely built.
                    self._capacity_probe_t = time.monotonic()
                    if cap.get("draining"):
                        self._drain_announced_t = time.monotonic()
            except Exception:  # noqa: BLE001 - test stubs may lack metadata support
                pass
        unhealthy = [n for n, s in statuses.items() if s == "unhealthy"]
        broken = [n for n, s in statuses.items() if s != "healthy"]
        if unhealthy:
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"service(s) unhealthy: {sorted(unhealthy)}",
            )
        if statuses and len(broken) == len(statuses):
            # Nothing left serving: a hub of only degraded placeholders is
            # not healthy, however gracefully it boots.
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"all services degraded: {sorted(broken)}",
            )
        return empty_pb2.Empty()


def _aggregate_runtime(caps) -> str:
    """Runtime of the aggregate capability record: the live services'
    common runtime (``torch-cuda`` or ``torch-cpu``; a degraded
    placeholder's ``none`` does not count), ``torch`` when they differ or
    there are none."""
    runtimes = {cap.runtime for cap in caps} - {"none"}
    return runtimes.pop() if len(runtimes) == 1 else "torch"
