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

The port's copy of ``lumen_tpu/serving/router.py``: ``HubRouter`` with
the JAX router's hot-swap invalidation of the result cache, its
containment keys on ``Health`` and the reserved federation tasks
(``fed_cache_lookup``, ``fed_kv_put``), and ``FederationRouter``, the front
tier. Runtime modules (result cache, quarantine, autopilot) are read
through ``sys.modules`` under this package's name, so a front tier that
loaded none of them answers without importing them.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import Iterable, Iterator

import grpc
from google.protobuf import empty_pb2

from ..utils import trace as request_trace
from ..utils.metrics import metrics
from .base_service import BaseService, _Assembly
from .proto import ml_service_pb2 as pb
from .proto.ml_service_pb2_grpc import InferenceServicer

logger = logging.getLogger(__name__)

#: Reserved task name of the federation cache-lookup RPC. Answered HERE —
#: before routing, before the drain gate, before any admission accounting —
#: because a cache read is a cheap read-only probe that must keep working
#: on a draining peer and costs O(1) on the owner. Payload = the exact
#: result-cache key (UTF-8); response meta ``fed_cache`` = ``hit``/``miss``
#: with the pickle blob as the result on a hit. The client half lives in
#: :mod:`~lumen_tpu_torch.runtime.federation`.
FED_CACHE_TASK = "fed_cache_lookup"

#: cap one cache-lookup answer under the gRPC message limit (with
#: protobuf headroom); larger entries answer miss and the requester
#: computes — correctness first, the dedupe win is for typical results.
_FED_CACHE_MAX_BLOB = 48 * 1024 * 1024

#: hard cap on how long the OWNER parks a handler thread riding its own
#: in-flight computation for a cache lookup (the requester asks via
#: ``wait_ms``; the effective wait is further clamped to the lookup
#: RPC's own remaining deadline — a waiter whose caller is gone must not
#: keep a thread). Re-exported by :mod:`~lumen_tpu_torch.runtime.federation`.
FED_CACHE_MAX_WAIT_S = 30.0


#: Reserved task name of the KV page-migration RPC (disaggregated
#: prefill/decode): a prefill-lane host ships a freshly prefilled row's
#: KV pages + exact decode state to its decode-lane owner, which decodes
#: with ZERO re-prefill and streams the tokens back on the same RPC.
#: Answered like :data:`FED_CACHE_TASK` (before the route table — the
#: task is reserved, never registered) but BEHIND the drain gate:
#: accepting a row to decode is real admission. Server half:
#: :meth:`HubRouter._answer_kv_put` (sink = the VLM service's
#: ``handle_kv_put``); client half:
#: ``lumen_tpu_torch.runtime.federation.FederationManager.kv_migrate``.
FED_KV_PUT_TASK = "fed_kv_put"

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

#: Search tasks the federation FRONT fans out SHARD-WISE instead of
#: routing to a single content-address owner: ANN shard placement keys
#: the hash ring per ``ann/{tenant}/{shard}`` (data placement — a query
#: must visit EVERY shard owner, an upsert batch is partitioned by the
#: same placement function), so the ordinary payload-digest routing
#: would send a query to one random peer holding one fraction of the
#: index. String literals on purpose: the canonical definitions live in
#: :mod:`.services.search_service`, whose import drags numpy and the
#: batcher machinery this router deliberately stays free of — and the
#: task names are wire protocol either way.
FED_SEARCH_QUERY_TASK = "search_query"
FED_SEARCH_UPSERT_TASK = "search_upsert"
FED_SEARCH_TASKS = (FED_SEARCH_QUERY_TASK, FED_SEARCH_UPSERT_TASK)

#: chunk size for front-built shard sub-requests (same 1 MiB the client
#: uses — comfortably under any gRPC frame limit).
_FED_SEARCH_CHUNK = 1 << 20


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


def _fed_wait_slots() -> threading.Semaphore:
    """Process-wide cap on CONCURRENTLY-PARKED cache-lookup waits — the
    per-RPC deadline clamp bounds each wait, this bounds the aggregate:
    with the default 10-thread gRPC pool, a handful of slow flights each
    attracting one waiting lookup per non-owner peer could otherwise park
    every handler thread and starve this host's own Health probes into a
    fleet-wide ejection. Over the cap, lookups degrade to an immediate
    peek (miss if not cached) — the requester computes, which is always
    correct. Sized to half the handler pool, floor 1."""
    global _FED_WAIT_SLOTS
    if _FED_WAIT_SLOTS is None:
        from ..utils.env import env_int

        workers = env_int("LUMEN_GRPC_WORKERS", 10, minimum=1)
        _FED_WAIT_SLOTS = threading.Semaphore(max(1, workers // 2))
    return _FED_WAIT_SLOTS


_FED_WAIT_SLOTS: threading.Semaphore | None = None


#: this package's name: runtime modules are looked up under it
_PACKAGE = __package__.rpartition(".")[0]


def _runtime_module(name: str):
    """``runtime.<name>`` of this package when some code of the process
    already imported it, else None (the router never imports the runtime
    package itself)."""
    return sys.modules.get(f"{_PACKAGE}.runtime.{name}")


class HubRouter(InferenceServicer):
    #: Fleet view (:class:`~lumen_tpu_torch.runtime.federation.FederationManager`)
    #: attached by the server on peer-aware boots; None (the default and
    #: the only state when ``LUMEN_FED_PEERS`` is unset) keeps every
    #: request path byte-identical to single-host.
    federation = None

    #: KV-migration sink (the VLM service's ``handle_kv_put``), attached
    #: by the server on decode-capable boots; None answers the reserved
    #: ``fed_kv_put`` task with a typed in-band refusal, and the prefill
    #: host decodes the row locally — a refusal never loses work.
    kv_migration = None

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
        # Hot-swap cache invalidation: result-cache namespaces lead with the
        # service family name, so dropping the prefix guarantees that the
        # swapped-in model never serves a predecessor's results, even when
        # id and revision match (the same model reloaded by recovery). The
        # family is the registry name the managers key their namespaces
        # with; the router key is a config alias that may differ. Any swap
        # also drops the whole (rebuildable) ingest cache.
        from ..runtime.result_cache import invalidate_namespace

        prefixes = {getattr(svc.registry, "service_name", name), name, "ingest"}

        def sweep() -> int:
            return sum(invalidate_namespace(f"{p}/") for p in prefixes)

        dropped = sweep()
        close = getattr(old, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 - best-effort teardown of the placeholder
                logger.exception("closing replaced service %r failed", name)
        # Sweep AGAIN once the old service is closed: a request that entered
        # it after the first sweep holds a post-invalidation fence the store
        # cannot reject, but it finished before close() returned.
        dropped += sweep()
        if dropped:
            logger.info("hot-swap of %r invalidated %d cached result(s)", name, dropped)

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

    def _answer_cache_lookup(
        self, first: pb.InferRequest, context=None
    ) -> pb.InferResponse:
        """Server half of the federation cache-lookup protocol: probe the
        local result cache (and, with a ``wait_ms`` meta, ride a live
        single-flight) for the requested key. Reads the cache module via
        ``sys.modules`` — a process that never loaded the runtime package
        (echo deployments, the front tier itself) answers miss
        without importing anything.

        A ``meta["op"] == "put"`` request is the drain-handoff WRITE half
        (the front pushing a draining peer's hot entry onto a ring
        successor): the payload is the pickle blob, ``meta["key"]`` the
        cache key. Gated on the same capacity-gossip knob that produces
        the pushes — a host outside the gossip ignores stray writes."""
        mod = _runtime_module("result_cache")
        if first.meta.get("op") == "put":
            stored = False
            if mod is not None and capacity_gossip_enabled():
                try:
                    stored = bool(
                        mod.peer_import(
                            first.meta.get("key", ""), bytes(first.payload)
                        )
                    )
                except Exception:  # noqa: BLE001 - a bad blob must never 500 the peer
                    logger.exception("federation cache import failed")
            return pb.InferResponse(
                correlation_id=first.correlation_id,
                is_final=True,
                meta={"fed_cache": "stored" if stored else "ignored"},
            )
        blob = None
        if mod is not None:
            try:
                wait_ms = int(first.meta.get("wait_ms", "0") or "0")
            except ValueError:
                wait_ms = 0
            wait_s = min(max(wait_ms, 0) / 1000.0, FED_CACHE_MAX_WAIT_S)
            # Never wait past the lookup RPC's own deadline: once the
            # requester's call has expired, riding the flight further
            # only parks this handler thread for nobody (handler-pool
            # exhaustion on the owner is how a HEALTHY host gets its
            # Health probes starved and ejected).
            rem_fn = getattr(context, "time_remaining", None)
            if callable(rem_fn):
                try:
                    rem = rem_fn()
                except Exception:  # noqa: BLE001 - stub contexts
                    rem = None
                if rem is not None:
                    wait_s = max(0.0, min(wait_s, rem - 0.1))
            key = bytes(first.payload).decode("utf-8", "replace")
            slots = _fed_wait_slots()
            parked = wait_s > 0 and slots.acquire(blocking=False)
            if wait_s > 0 and not parked:
                wait_s = 0.0  # wait budget spent: peek-only, never park
            try:
                blob = mod.peer_export(key, wait_s=wait_s)
            except Exception:  # noqa: BLE001 - a lookup must never 500 the peer
                logger.exception("federation cache export failed")
                blob = None
            finally:
                if parked:
                    slots.release()
        if blob is None or len(blob) > _FED_CACHE_MAX_BLOB:
            return pb.InferResponse(
                correlation_id=first.correlation_id,
                is_final=True,
                meta={"fed_cache": "miss"},
            )
        return pb.InferResponse(
            correlation_id=first.correlation_id,
            is_final=True,
            result=blob,
            result_mime="application/x-python-pickle",
            meta={"fed_cache": "hit"},
            total=1,
        )

    def _answer_kv_put(
        self, first: pb.InferRequest, request_iterator, context
    ) -> Iterator[pb.InferResponse]:
        """Server half of the KV page-migration protocol: delegate to the
        attached sink. Unlike the cache lookup this IS admission of real
        decode work, so the drain gate applies; every refusal is a typed
        in-band UNAVAILABLE — the prefill host treats ANY failure as
        "resume locally", so nothing here can lose a row."""
        if self._draining:
            yield self._drain_response(first)
            return
        sink = self.kv_migration
        if sink is None:
            yield pb.InferResponse(
                correlation_id=first.correlation_id,
                is_final=True,
                meta={"fed_kv": "refused"},
                error=pb.Error(
                    code=pb.ERROR_CODE_UNAVAILABLE,
                    message="this host accepts no KV migrations",
                    detail=(
                        "no continuous-batching VLM engine is attached "
                        "(front tier, modelless host, or non-continuous "
                        "scheduler); the prefill host decodes locally"
                    ),
                ),
            )
            return
        try:
            yield from sink.handle_kv_put(first, request_iterator, context)
        except Exception as e:  # noqa: BLE001 - a broken sink must answer in-band
            logger.exception("fed_kv_put sink failed")
            yield pb.InferResponse(
                correlation_id=first.correlation_id,
                is_final=True,
                meta={"fed_kv": "refused"},
                error=pb.Error(
                    code=pb.ERROR_CODE_INTERNAL,
                    message=f"fed_kv_put sink failed: {type(e).__name__}: {e}",
                ),
            )

    def Infer(self, request_iterator: Iterable[pb.InferRequest], context) -> Iterator[pb.InferResponse]:
        try:
            first = next(iter(request_iterator))
        except StopIteration:
            return
        if first.task == FED_CACHE_TASK:
            # Peer-cache protocol: answered before the drain gate and the
            # route table on purpose (read-only, O(1), and a draining or
            # modelless peer must still serve its cache).
            yield self._answer_cache_lookup(first, context)
            return
        if first.task == FED_KV_PUT_TASK:
            # KV-migration protocol: reserved like the cache lookup, but
            # the drain gate (inside) applies — this admits decode work.
            yield from self._answer_kv_put(first, request_iterator, context)
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

    @staticmethod
    def _quarantine_size() -> int | None:
        """Entries currently quarantined, read only when the quarantine
        module is already loaded in this process (a service that never
        gates on it reports nothing), as the JAX router does."""
        mod = _runtime_module("quarantine")
        if mod is None:
            return None
        try:
            return len(mod.get_quarantine())
        except Exception:  # noqa: BLE001 - health must never fail on telemetry
            return None

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

    @staticmethod
    def _autopilot_state() -> dict:
        """Compact autopilot state WITHOUT importing the runtime package
        (same rule as the quarantine probe): only report when the
        controller module is already loaded in-process. ``{}`` omits the
        key."""
        mod = _runtime_module("autopilot")
        if mod is None:
            return {}
        try:
            return mod.health_status()
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
        if self._draining:
            # Hot-key manifest for the drain handoff: the front fetches
            # these via the ordinary peer-cache path and pushes them onto
            # ring successors. sys.modules read — a front never imports
            # the runtime package for this.
            mod = _runtime_module("result_cache")
            if mod is not None:
                try:
                    cap["hot"] = mod.hot_keys(8)
                except Exception:  # noqa: BLE001 - telemetry only
                    pass
        return cap

    def _fed_status(self) -> dict:
        """Per-peer federation state for the ``lumen-fed-status``
        trailing-metadata key. ``{}`` (no fleet attached) omits the key —
        single-host Health payloads stay byte-identical."""
        fed = self.federation
        if fed is None:
            return {}
        try:
            return fed.health_status()
        except Exception:  # noqa: BLE001 - health must never fail on telemetry
            return {}

    def Health(self, request, context):
        statuses = self._statuses()
        if context is not None:
            try:
                trailing = [("lumen-service-status", json.dumps(statuses))]
                breakers = self._breaker_states()
                if breakers:
                    trailing.append(("lumen-breaker-status", json.dumps(breakers)))
                quarantined = self._quarantine_size()
                if quarantined is not None:
                    trailing.append(("lumen-quarantine-size", str(quarantined)))
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
                fed_state = self._fed_status()
                if fed_state:
                    # Fleet view next to the containment keys: an ejected
                    # peer is a reported condition (its ring segment
                    # spilled to successors), not an outage of THIS host.
                    trailing.append(("lumen-fed-status", json.dumps(fed_state)))
                role = advertised_fed_role()
                if role:
                    # Disaggregation lane: peers learn it from the Health
                    # probe they already run. Unset advertises nothing —
                    # the unconfigured payload stays byte-identical.
                    trailing.append((FED_ROLE_META, role))
                ap_state = self._autopilot_state()
                if ap_state:
                    # Whether the capacity controller is live, which loops
                    # it holds, and its last actuation — so "who parked
                    # that replica / forced that rung" is answerable from
                    # a Health probe.
                    trailing.append(("lumen-autopilot-status", json.dumps(ap_state)))
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


class FederationRouter(HubRouter):
    """Front tier: a lumen-tpu server that owns NO models and routes every
    Infer stream over N peer servers speaking the unchanged gRPC protocol
    (so a front tier can itself be fronted — tiers compose).

    Routing is consistent-hash by the request payload's sha256 — the same
    content address the result cache keys on — so identical payloads
    always land on the same peer and its cache concentrates the hits.
    Empty-payload tasks (vlm generate: the prompt rides in request meta)
    fold the first message's meta into the key instead, so a meta-borne
    workload still spreads across the ring.
    Per-request resilience: the hop budget (``LUMEN_FED_HOPS``) walks the
    ring owner's live successors on a transport failure (peer dead —
    feeds the ejection streak) or an in-band UNAVAILABLE shed (peer alive
    but refusing — neutral, the request just spills); when every hop is
    exhausted the LAST peer's answer is relayed verbatim so the
    ``lumen-retry-after-ms`` hint survives the front-tier hop (and is
    echoed as trailing metadata for clients that only read that).

    The request stream is buffered before the first forward: failover
    must be able to replay it, and replay is only safe while no response
    byte has been seen (the same contract the client's own stream-setup
    retry keeps). After the first forwarded response reaches the client,
    failures propagate — blind re-dispatch could double-run a task.
    """

    def __init__(self, federation):
        super().__init__({})
        self.federation = federation

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _forward_metadata(context) -> tuple | None:
        """Propagate every ``lumen-*`` request-metadata pair (tenant id,
        trace id) to the chosen peer — QoS identity and trace stitching
        must survive the hop."""
        md = getattr(context, "invocation_metadata", None)
        if not callable(md):
            return None
        out: list[tuple[str, str]] = []
        try:
            for item in md() or ():
                key = getattr(item, "key", None)
                value = getattr(item, "value", None)
                if key is None and isinstance(item, (tuple, list)) and len(item) == 2:
                    key, value = item
                if key and str(key).startswith("lumen-"):
                    out.append((str(key), str(value)))
        except Exception:  # noqa: BLE001 - metadata must never break routing
            return None
        return tuple(out) or None

    def _forward_timeout(self, context) -> float:
        """Deadline for one peer forward: the caller's own remaining
        budget when it set one, else the fleet default. Clamp: a
        no-deadline client surfaces as a HUGE ``time_remaining()`` on
        some gRPC stacks, and that number fed raw into the forward's
        deadline overflows C time — the call dies instantly instead of
        never (same trap the result cache's flight wait hit)."""
        timeout = None
        tr_fn = getattr(context, "time_remaining", None)
        if callable(tr_fn):
            try:
                timeout = tr_fn()
            except Exception:  # noqa: BLE001 - stub contexts
                timeout = None
        if timeout is None or timeout <= 0:
            timeout = self.federation.forward_timeout_s
        return min(timeout, 86400.0)

    @staticmethod
    def _reroutable_shed(resp: pb.InferResponse) -> bool:
        """An in-band UNAVAILABLE as the FIRST response: the peer refused
        before dispatch (drain, breaker, quota, queue shed) and said so
        parseably — re-sending elsewhere is explicitly safe."""
        return bool(
            resp.HasField("error")
            and resp.error.code == pb.ERROR_CODE_UNAVAILABLE
        )

    def _relay_exhausted(
        self, context, cid: str, last_shed: pb.InferResponse | None, tried: int
    ) -> pb.InferResponse:
        """Every hop failed: relay the last in-band answer verbatim (its
        response meta — retry hint included — is the peer's own words),
        echoing the hint into trailing metadata so it survives for
        clients that only read the RPC trailer."""
        from ..utils.qos import RETRY_AFTER_META, retry_after_ms

        metrics.count("fed_exhausted")
        if last_shed is not None:
            hint = last_shed.meta.get(RETRY_AFTER_META, "")
        else:
            hint = ""
        if not hint:
            hint = retry_after_ms(1.0)
        if context is not None:
            try:
                context.set_trailing_metadata(((RETRY_AFTER_META, hint),))
            except Exception:  # noqa: BLE001 - stubs may lack metadata support
                pass
        if last_shed is not None:
            return last_shed
        return pb.InferResponse(
            correlation_id=cid,
            is_final=True,
            meta={RETRY_AFTER_META: hint},
            error=pb.Error(
                code=pb.ERROR_CODE_UNAVAILABLE,
                message=f"all {tried} federation peer(s) unavailable",
                detail=(
                    "front tier exhausted its hop budget; retry with "
                    "backoff (lumen-retry-after-ms)"
                ),
            ),
        )

    # -- rpcs --------------------------------------------------------------

    def Infer(self, request_iterator: Iterable[pb.InferRequest], context) -> Iterator[pb.InferResponse]:
        try:
            first = next(iter(request_iterator))
        except StopIteration:
            return
        if first.task == FED_CACHE_TASK:
            # A cache lookup must NEVER be consistent-hash-forwarded: the
            # ring is keyed on the original payload's digest, not on the
            # key STRING this request carries, so a forward would land on
            # a random peer and park its handler for nothing. A front
            # tier owns no cache — answer miss honestly, right here.
            yield self._answer_cache_lookup(first, context)
            return
        if first.task == FED_KV_PUT_TASK:
            # A migration targets a SPECIFIC decode host, not a content
            # address — consistent-hashing the page payload to a random
            # peer would be wrong. A front tier never has a sink attached,
            # so this answers the typed in-band refusal.
            yield from self._answer_kv_put(first, request_iterator, context)
            return
        if self._draining:
            yield self._drain_response(first)
            return
        forward = (
            self._search_fanout
            if first.task in FED_SEARCH_TASKS
            else self._route_and_forward
        )
        tr = None
        if request_trace.enabled():
            tr = request_trace.begin_request(
                f"fed:{first.task}",
                trace_id=BaseService._trace_id_from(context),
            )
        if tr is None:
            yield from forward(first, request_iterator, context, None)
            return
        token = request_trace.activate(tr)
        try:
            for resp in forward(first, request_iterator, context, tr):
                if resp.HasField("error"):
                    tr.set_error(resp.error.message or "error")
                yield resp
        except BaseException as e:
            tr.set_error(f"{type(e).__name__}: {e}")
            raise
        finally:
            request_trace.deactivate(token)
            request_trace.finish_request(tr)

    def _route_and_forward(
        self, first: pb.InferRequest, request_iterator, context, tr
    ) -> Iterator[pb.InferResponse]:
        fed = self.federation
        # Buffer the whole request stream: the ring key needs the full
        # payload (chunked uploads), and failover needs an exact replay.
        msgs: list[pb.InferRequest] = [first]
        asm = _Assembly()
        asm.add(first)
        for req in request_iterator:
            msgs.append(req)
            if not asm.complete and req.correlation_id == first.correlation_id:
                asm.add(req)
        rspan = tr.begin("fed.route") if tr is not None else None
        body = asm.payload()
        h = hashlib.sha256(body)
        if not body:
            # Meta-borne tasks (vlm generate: the prompt rides in request
            # meta over an empty payload) would otherwise all collapse to
            # sha256(b"") — one ring owner for the whole workload and, in
            # a role-tagged fleet, one decode owner for every migrated
            # row. Fold the first message's meta in so content spreads;
            # payload-bearing tasks keep their exact digests.
            for k in sorted(first.meta):
                h.update(k.encode())
                h.update(b"\x00")
                h.update(first.meta[k].encode())
                h.update(b"\x00")
        digest = h.hexdigest()
        plan = fed.plan(digest)
        # Disaggregation rewrite: for generation tasks in a role-tagged
        # fleet, prefill-capable peers lead the plan and the first
        # decode-capable peer in ring order OWNS the decode — the chosen
        # prefill host migrates the row's KV there. Identity (plan, None)
        # whenever roles are unconfigured or the task has no phase split.
        decode_owner = None
        if plan:
            plan, decode_owner = fed.disagg_plan(first.task, plan)
        if rspan is not None:
            rattrs = {
                "owner": plan[0].name if plan else "none",
                "candidates": str(len(plan)),
            }
            if decode_owner:
                rattrs["decode_owner"] = decode_owner
            rspan.end(**rattrs)
        if not plan:
            yield self._relay_exhausted(context, first.correlation_id, None, 0)
            return
        timeout = self._forward_timeout(context)
        md = self._forward_metadata(context)
        kwargs = {"timeout": timeout} if md is None else {
            "timeout": timeout, "metadata": md,
        }
        with self._lock:
            self._active_streams += 1
        try:
            last_shed = None
            for attempt, peer in enumerate(plan):
                fed.record_dispatch(peer, failover=attempt > 0)
                fspan = (
                    tr.begin("fed.forward", {"peer": peer.name, "hop": str(attempt)})
                    if tr is not None
                    else None
                )
                fkw = kwargs
                if decode_owner is not None and peer.name != decode_owner:
                    # Pin the row's decode to the ring-chosen owner; the
                    # prefill host migrates the KV there after prefill.
                    # Omitted when the forward target IS the owner (or on
                    # the owner itself after failover) — decode locally.
                    from ..utils.disagg import DECODE_OWNER_META

                    fkw = dict(kwargs)
                    fkw["metadata"] = (md or ()) + (
                        (DECODE_OWNER_META, decode_owner),
                    )
                got_any = False
                shed = None
                try:
                    for resp in peer.stub.Infer(iter(msgs), **fkw):
                        if not got_any and self._reroutable_shed(resp):
                            shed = resp
                            break
                        got_any = True
                        yield resp
                except grpc.RpcError as e:
                    code = e.code() if callable(getattr(e, "code", None)) else None
                    # Only transport-unreachable feeds the ejection
                    # streak; DEADLINE_EXCEEDED/CANCELLED describe the
                    # CLIENT's budget or patience, and failing over on
                    # them would burn hops a dead client can't use.
                    unreachable = fed.record_unreachable(peer, e, "forward")
                    if fspan is not None:
                        fspan.end(error=str(code or type(e).__name__))
                    if got_any or not unreachable:
                        # Bytes already forwarded (replay unsafe), or the
                        # client itself gave up — propagate the break.
                        raise
                    continue
                if fspan is not None:
                    fspan.end(shed="1" if shed is not None else "0")
                if shed is not None:
                    fed.record_shed(peer)
                    last_shed = shed
                    continue
                fed.record_success(peer)
                return
            yield self._relay_exhausted(
                context, first.correlation_id, last_shed, len(plan)
            )
        finally:
            with self._lock:
                self._active_streams -= 1

    # -- sharded search fan-out --------------------------------------------

    def _search_fanout(
        self, first: pb.InferRequest, request_iterator, context, tr
    ) -> Iterator[pb.InferResponse]:
        """Front half of the sharded search path: buffer the request,
        resolve the tenant, and fan out to the ring owners of every
        ``ann/{tenant}/{shard}`` key — per-shard forwards run their own
        failover walk and the results merge HERE, so one dead shard
        owner degrades to its ring successor, never to a silently
        partial answer. Responses are collected (not streamed), which
        keeps replay safe for every shard hop: no byte reaches the
        client until all shards have answered."""
        fed = self.federation
        msgs: list[pb.InferRequest] = [first]
        asm = _Assembly()
        asm.add(first)
        for req in request_iterator:
            msgs.append(req)
            if not asm.complete and req.correlation_id == first.correlation_id:
                asm.add(req)
        # The front uses only runtime.ann's placement and merge helpers:
        # host code, no tensor is placed.
        from ..runtime.ann import ann_shards
        from ..utils.qos import DEFAULT_TENANT, TENANT_META_KEY

        tenant = (
            first.meta.get("tenant")
            or BaseService._invocation_meta(context, TENANT_META_KEY)
            or DEFAULT_TENANT
        )
        n_shards = ann_shards()
        timeout = self._forward_timeout(context)
        md = self._forward_metadata(context)
        kwargs = {"timeout": timeout} if md is None else {
            "timeout": timeout, "metadata": md,
        }
        with self._lock:
            self._active_streams += 1
        try:
            if first.task == FED_SEARCH_UPSERT_TASK:
                yield from self._search_upsert_fanout(
                    first, asm, context, tr, tenant, n_shards, kwargs
                )
            else:
                yield from self._search_query_fanout(
                    first, msgs, context, tr, tenant, n_shards, kwargs
                )
        finally:
            with self._lock:
                self._active_streams -= 1

    def _search_query_fanout(
        self, first, msgs, context, tr, tenant, n_shards, kwargs
    ) -> Iterator[pb.InferResponse]:
        fed = self.federation
        cid = first.correlation_id
        metrics.count("fed_search_queries")

        def one_shard(shard: int):
            # Same payload (the query tensor forwards verbatim — a
            # fleet-internal hop never re-encodes), shard-pinned meta:
            # the owner answers ONLY from ann/{tenant}/{shard}.
            head = pb.InferRequest()
            head.CopyFrom(first)
            head.meta["shard"] = str(shard)
            head.meta["tenant"] = tenant
            key = hashlib.sha256(f"ann/{tenant}/{shard}".encode()).hexdigest()
            plan = fed.plan(key)
            span = (
                tr.begin("fed.search", {"shard": str(shard), "tenant": tenant})
                if tr is not None
                else None
            )
            got, peer, last_shed, tried = self._forward_collect(
                [head, *msgs[1:]], plan, kwargs
            )
            if span is not None:
                span.end(
                    owner=peer.name if peer is not None else "none",
                    hops=str(tried),
                    ok="1" if got is not None else "0",
                )
            return got, last_shed, tried

        parts: list[tuple[list, list]] = []
        last_shed = None
        total_tried = 0
        for got, shed, tried in self._fanout_run(one_shard, list(range(n_shards))):
            total_tried += tried
            if shed is not None:
                last_shed = shed
            if got is None:
                # One unreachable shard fails the WHOLE query: a quietly
                # partial top-k is a wrong answer, not a degraded one.
                yield self._relay_exhausted(context, cid, last_shed, total_tried)
                return
            final = got[-1]
            if final.HasField("error"):
                # The shard's own in-band error (bad k, bad vector...)
                # relays verbatim — its message is the ground truth.
                yield final
                return
            body = b"".join(bytes(r.result) for r in got)
            try:
                doc = json.loads(body.decode("utf-8"))
                parts.append((doc["ids"], doc["scores"]))
            except (ValueError, KeyError, UnicodeDecodeError) as e:
                yield pb.InferResponse(
                    correlation_id=cid,
                    is_final=True,
                    error=pb.Error(
                        code=pb.ERROR_CODE_INTERNAL,
                        message=f"shard returned a malformed search body: {e}",
                    ),
                )
                return
        from ..runtime.ann import merge_topk

        try:
            k = max(1, int(first.meta.get("k", "10") or "10"))
        except ValueError:
            k = 10  # the shards validated k; unreachable in practice
        ids, scores = merge_topk(parts, k)
        out = {
            "ids": ids,
            "scores": scores,
            "k": k,
            "shards": n_shards,
            "tenant": tenant,
        }
        yield pb.InferResponse(
            correlation_id=cid,
            is_final=True,
            result=json.dumps(out).encode(),
            result_mime="application/json",
            total=1,
        )

    def _search_upsert_fanout(
        self, first, asm, context, tr, tenant, n_shards, kwargs
    ) -> Iterator[pb.InferResponse]:
        import numpy as np

        from ..runtime.ann import shard_of
        from ..utils.tensorwire import BUNDLE_MIME, pack_bundle, unpack_bundle

        fed = self.federation
        cid = first.correlation_id
        payload = asm.payload()
        try:
            if asm.payload_mime == BUNDLE_MIME:
                tensors = unpack_bundle(payload)
                if len(tensors) != 2:
                    raise ValueError(
                        f"upsert bundle must hold [vectors, ids_json], "
                        f"got {len(tensors)} tensors"
                    )
                vecs = np.asarray(tensors[0], np.float32)
                ids = json.loads(
                    bytes(np.asarray(tensors[1], np.uint8)).decode("utf-8")
                )
            else:
                doc = json.loads(payload.decode("utf-8"))
                ids = doc["ids"]
                vecs = np.asarray(doc["vectors"], np.float32)
            if (
                not isinstance(ids, list)
                or not all(isinstance(i, str) for i in ids)
                or vecs.ndim != 2
                or len(ids) != vecs.shape[0]
                or not ids
            ):
                raise ValueError(
                    f"{len(ids) if isinstance(ids, list) else '?'} string ids "
                    f"over vectors {vecs.shape}"
                )
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            # The front must parse to PARTITION, so malformed batches
            # answer here — same contract the shard host would apply.
            yield pb.InferResponse(
                correlation_id=cid,
                is_final=True,
                error=pb.Error(
                    code=pb.ERROR_CODE_INVALID_ARGUMENT,
                    message=f"upsert batch did not parse: {type(e).__name__}: {e}",
                    detail=(
                        "expected tensor/bundle [vectors, ids_json] or "
                        "JSON {'ids': [...], 'vectors': [[...]]}"
                    ),
                ),
            )
            return
        metrics.count("fed_search_upserts")
        groups: dict[int, list[int]] = {}
        for row, vid in enumerate(ids):
            groups.setdefault(shard_of(vid, n_shards), []).append(row)

        def one_shard(item):
            shard, rows = item
            sub_ids = [ids[r] for r in rows]
            body = pack_bundle([
                np.ascontiguousarray(vecs[rows]),
                np.frombuffer(json.dumps(sub_ids).encode("utf-8"), np.uint8),
            ])
            meta = dict(first.meta)
            meta["shard"] = str(shard)
            meta["tenant"] = tenant
            shard_msgs = list(
                self._search_msgs(first.task, cid, bytes(body), BUNDLE_MIME, meta)
            )
            key = hashlib.sha256(f"ann/{tenant}/{shard}".encode()).hexdigest()
            plan = fed.plan(key)
            span = (
                tr.begin(
                    "fed.search",
                    {"shard": str(shard), "tenant": tenant, "rows": str(len(rows))},
                )
                if tr is not None
                else None
            )
            got, peer, last_shed, tried = self._forward_collect(
                shard_msgs, plan, kwargs
            )
            if span is not None:
                span.end(
                    owner=peer.name if peer is not None else "none",
                    hops=str(tried),
                    ok="1" if got is not None else "0",
                )
            return got, last_shed, tried

        added = updated = 0
        last_shed = None
        total_tried = 0
        items = sorted(groups.items())
        for got, shed, tried in self._fanout_run(one_shard, items):
            total_tried += tried
            if shed is not None:
                last_shed = shed
            if got is None:
                # Partial-write honesty: some slices may have landed, but
                # upserts are idempotent by id — the client retries the
                # whole batch and converges.
                yield self._relay_exhausted(context, cid, last_shed, total_tried)
                return
            final = got[-1]
            if final.HasField("error"):
                yield final
                return
            body = b"".join(bytes(r.result) for r in got)
            try:
                doc = json.loads(body.decode("utf-8"))
                added += int(doc.get("added", 0))
                updated += int(doc.get("updated", 0))
            except (ValueError, TypeError) as e:
                yield pb.InferResponse(
                    correlation_id=cid,
                    is_final=True,
                    error=pb.Error(
                        code=pb.ERROR_CODE_INTERNAL,
                        message=f"shard returned a malformed upsert body: {e}",
                    ),
                )
                return
        out = {
            "added": added,
            "updated": updated,
            "shards": len(items),
            "tenant": tenant,
        }
        yield pb.InferResponse(
            correlation_id=cid,
            is_final=True,
            result=json.dumps(out).encode(),
            result_mime="application/json",
            total=1,
        )

    def _forward_collect(self, msgs, plan, kwargs):
        """One shard's forward: walk the ring owner's live successors
        exactly like :meth:`_route_and_forward`, but COLLECT the response
        messages instead of streaming them. Returns ``(responses | None,
        serving_peer | None, last_shed, hops_tried)`` — ``None`` responses
        mean the plan is exhausted (empty plan included)."""
        fed = self.federation
        last_shed = None
        for attempt, peer in enumerate(plan):
            fed.record_dispatch(peer, failover=attempt > 0)
            got: list[pb.InferResponse] = []
            shed = None
            try:
                for resp in peer.stub.Infer(iter(msgs), **kwargs):
                    if not got and self._reroutable_shed(resp):
                        shed = resp
                        break
                    got.append(resp)
            except grpc.RpcError as e:
                if not fed.record_unreachable(peer, e, "search"):
                    # DEADLINE_EXCEEDED/CANCELLED describe the CLIENT's
                    # budget or patience — burning more hops serves a
                    # caller that is already gone. Replay stays safe
                    # (nothing was forwarded), but pointless.
                    raise
                continue
            if shed is not None:
                fed.record_shed(peer)
                last_shed = shed
                continue
            if not got:
                # A peer that half-answered an empty stream is broken in
                # a way record_unreachable never saw; try the successor.
                continue
            fed.record_success(peer)
            return got, peer, last_shed, attempt + 1
        return None, None, last_shed, len(plan)

    def _fanout_run(self, fn, items: list) -> list:
        """Run ``fn(item)`` for every item CONCURRENTLY (the per-shard
        forwards are network-bound; serial fan-out would multiply query
        latency by the shard count) and return results in item order.
        A worker exception propagates — same surface as a failed single
        forward."""
        if len(items) <= 1:
            return [fn(i) for i in items]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(len(items), 8), thread_name_prefix="fed-search"
        ) as pool:
            return list(pool.map(fn, items))

    @staticmethod
    def _search_msgs(
        task: str, cid: str, payload: bytes, mime: str, meta: dict[str, str]
    ) -> Iterator[pb.InferRequest]:
        """Chunked request messages for a front-built shard sub-request
        (the same framing the client's ``_requests`` helper emits)."""
        if len(payload) <= _FED_SEARCH_CHUNK:
            yield pb.InferRequest(
                correlation_id=cid, task=task, payload=payload,
                payload_mime=mime, meta=meta,
            )
            return
        total = (len(payload) + _FED_SEARCH_CHUNK - 1) // _FED_SEARCH_CHUNK
        for i in range(total):
            part = payload[i * _FED_SEARCH_CHUNK : (i + 1) * _FED_SEARCH_CHUNK]
            yield pb.InferRequest(
                correlation_id=cid, task=task, payload=part,
                payload_mime=mime, meta=meta if i == 0 else {},
                seq=i, total=total, offset=i * _FED_SEARCH_CHUNK,
            )

    def GetCapabilities(self, request, context) -> pb.Capability:
        """Aggregate the LIVE peers' capabilities into one record (the
        same merge the hub applies to its child services, one level up)."""
        fed = self.federation
        agg = pb.Capability(
            service_name="fed-front",
            runtime="torch",
            protocol_version="1.0.0",
        )
        for peer in fed.peers.values():
            if peer.state != "serving":
                continue
            try:
                cap = peer.stub.GetCapabilities(request, timeout=5.0)
            except Exception as e:  # noqa: BLE001 - a dead peer is not a caps error
                fed.record_unreachable(peer, e, "caps")
                continue
            for mid in cap.model_ids:
                if mid not in agg.model_ids:
                    agg.model_ids.append(mid)
            known = {t.name for t in agg.tasks}
            for task in cap.tasks:
                if task.name not in known:
                    agg.tasks.append(task)
            for p in cap.precisions:
                if p not in agg.precisions:
                    agg.precisions.append(p)
            agg.max_concurrency += cap.max_concurrency
        return agg

    def StreamCapabilities(self, request, context) -> Iterator[pb.Capability]:
        fed = self.federation
        for peer in fed.peers.values():
            if peer.state != "serving":
                continue
            try:
                for cap in peer.stub.StreamCapabilities(request, timeout=5.0):
                    # Stamp provenance so a topology client sees WHICH
                    # host each capability record came from.
                    cap.extra["fed_peer"] = peer.name
                    yield cap
            except Exception as e:  # noqa: BLE001 - skip dead peers
                fed.record_unreachable(peer, e, "caps")
                continue

    def Health(self, request, context):
        status = self._fed_status()
        if context is not None and status:
            try:
                context.set_trailing_metadata(
                    (("lumen-fed-status", json.dumps(status)),)
                )
            except Exception:  # noqa: BLE001 - test stubs may lack metadata support
                pass
        peers = status.get("peers", {})
        live = [n for n, s in peers.items() if s == "serving"]
        if peers and not live:
            # A front tier with every peer ejected serves nothing: fail
            # health exactly like a hub of only degraded placeholders.
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"all federation peers ejected: {sorted(peers)}",
            )
        return empty_pb2.Empty()


def _aggregate_runtime(caps) -> str:
    """Runtime of the aggregate capability record: the live services'
    common runtime (``torch-cuda`` or ``torch-cpu``; a degraded
    placeholder's ``none`` does not count), ``torch`` when they differ or
    there are none."""
    runtimes = {cap.runtime for cap in caps} - {"none"}
    return runtimes.pop() if len(runtimes) == 1 else "torch"
