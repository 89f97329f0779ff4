"""Process-wide content-addressed inference result cache + single-flight.

BENCH_r05 measured the device lane ~100x ahead of the serving path (CLIP
9,083 images/s/chip device-only vs 37.9 images/s end-to-end ingest and 77
RPS gRPC c10): the binding resource is the *host* — decode (~100
images/s/core) and per-request serialization. The cheapest throughput
multiplier left is therefore not computing at all: photo-indexing traffic
is full of byte-identical work (re-index passes over an unchanged library,
burst duplicates, client retries after an admission shed), and every one
of those requests used to pay decode + batcher + device again.

This module is the answer, in two parts:

- **content-addressed result cache** — results keyed by
  ``(namespace, canonicalized request options, sha256(payload bytes))``
  where the namespace is ``{service}/{task}/{model-id}@{revision}``. The
  hash runs on the RAW bytes, so a hit is decided *before* the decode
  pool and the micro-batcher ever see the request: it skips the host
  decode bottleneck entirely and never counts against admission queues or
  deadline gates. Two tiers: a byte-budgeted in-RAM LRU
  (``LUMEN_CACHE_BYTES``, default 256 MiB, 0 disables) and an optional
  pickle-on-disk tier (``LUMEN_CACHE_DIR``) that survives restarts.

- **single-flight coalescing** — concurrent *identical* requests share one
  in-flight future: the first caller computes, the rest wait on its
  result, so a retry storm or duplicate burst costs ONE batcher
  submission instead of N. Caller-specific overload failures
  (:class:`~lumen_tpu.utils.deadline.DeadlineExpired` /
  :class:`~lumen_tpu.utils.deadline.QueueFull` on the owner) are NOT fanned
  out as final answers — a waiter whose owner was shed retries the compute
  itself (one of the waiters becomes the new owner), because the owner's
  deadline says nothing about the waiter's.

Invalidation is namespace-prefix-based: the router's hot-swap path
(:meth:`~lumen_tpu.serving.router.HubRouter.replace_service`, which the
background :class:`~lumen_tpu.serving.resilience.RecoveryManager` drives)
invalidates ``{service}/`` so a newly swapped-in model never serves a
predecessor's results even when id+revision match.

Deliberately jax-free (like :mod:`~lumen_tpu.runtime.decode_pool`): pure
host plumbing, importable from the serving layer without a backend.

Caching is only ever keyed on deterministic work: the VLM manager bypasses
the cache when ``do_sample`` / ``temperature > 0`` — sampled generations
must stay sampled.

Multi-tenant isolation (:mod:`~lumen_tpu.utils.qos`): keys for a
non-default tenant carry a ``/tenant=<id>`` namespace qualifier, so one
tenant's entries (and its poison-quarantine fingerprints — a tenant must
not be able to poison-flag content another tenant serves) never answer
for another's; per-tenant byte accounting rides each entry, and when the
RAM tier is over budget it evicts **fair-share-first**: the victim is
always the least-recently-used entry of the tenant holding the MOST
bytes, so a flooding tenant's churn evicts its own backlog while smaller
tenants' hot sets stay resident. ``cross_tenant_evictions`` counts the
violations (an under-fair-share tenant losing an entry to another
tenant's store) — zero by construction, watched by ``bench.py qos``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import threading
import weakref
from collections import OrderedDict
from concurrent.futures import Future, TimeoutError as FuturesTimeout
from typing import Any, Callable, Mapping
from urllib.parse import quote, unquote

import numpy as np

from ..utils.deadline import DeadlineExpired, PoisonInput, QueueFull, remaining
from ..utils.env import env_int
from ..utils.metrics import metrics
from ..utils.qos import DEFAULT_TENANT, _MAX_TENANT_STATS, current_tenant
from ..utils.request_notes import mark as _mark
from .trace import current_trace

logger = logging.getLogger(__name__)

CACHE_BYTES_ENV = "LUMEN_CACHE_BYTES"
CACHE_DIR_ENV = "LUMEN_CACHE_DIR"

DEFAULT_CACHE_BYTES = 256 * 1024 * 1024


def cache_bytes() -> int:
    """RAM-tier byte budget: ``LUMEN_CACHE_BYTES`` (0 disables the RAM
    tier; unset -> 256 MiB default, malformed -> default with the shared
    parser's one-shot warning)."""
    return env_int(CACHE_BYTES_ENV, DEFAULT_CACHE_BYTES, minimum=0)


def cache_dir() -> str | None:
    """Disk-tier root: ``LUMEN_CACHE_DIR`` (unset/empty = no disk tier)."""
    return os.environ.get(CACHE_DIR_ENV) or None


def canonical_options(options: Mapping[str, Any] | None) -> str:
    """Canonical JSON for the request-options half of the key: sorted keys,
    no whitespace, non-JSON values via repr — the SAME logical options must
    hash identically regardless of dict insertion order."""
    return json.dumps(
        dict(options or {}), sort_keys=True, separators=(",", ":"), default=repr
    )


def make_namespace(
    family: str, task: str, model_id: str, revision: str, *qualifiers: str
) -> str:
    """The ONE namespace format: ``{family}/{task}/{model-id}@{revision}``
    plus any compute-path qualifiers (dtype policy, quant route, ...) that
    change the numerics of a result — entries computed under different
    precision must not answer for each other, especially across restarts
    via the disk tier. The family prefix is load-bearing: the router's
    hot-swap invalidation drops ``{family}/``, so every manager must build
    namespaces through here."""
    ns = f"{family}/{task}/{model_id}@{revision}"
    quals = [q for q in qualifiers if q]
    if quals:
        ns += "/" + ",".join(quals)
    return ns


#: namespace qualifier marking a non-default tenant's entries
_TENANT_MARK = "/tenant="


def make_key(namespace: str, options: Mapping[str, Any] | None, payload: bytes) -> str:
    """``{namespace}:{sha256 digest}`` — the namespace stays in the clear so
    prefix invalidation (model hot-swap) can drop a whole model's entries
    without remembering its keys.

    Tenant-scoped: a request running under a non-default tenant (the
    ``lumen-tenant`` contextvar, see :mod:`~lumen_tpu.utils.qos`) gets a
    trailing ``/tenant=<id>`` qualifier, so tenants never share entries —
    or poison-quarantine fingerprints, which are this same key. The
    family prefix stays leading, so hot-swap invalidation
    (``invalidate("clip/")``) still sweeps every tenant's entries.
    Default-tenant keys are byte-identical to the pre-QoS format."""
    tenant = current_tenant()
    if tenant != DEFAULT_TENANT:
        namespace = f"{namespace}{_TENANT_MARK}{quote(tenant, safe='')}"
    h = hashlib.sha256()
    h.update(namespace.encode("utf-8"))
    h.update(b"\x00")
    h.update(canonical_options(options).encode("utf-8"))
    h.update(b"\x00")
    h.update(payload)
    return f"{namespace}:{h.hexdigest()}"


def key_tenant(key: str) -> str:
    """The tenant a cache key belongs to (``default`` for unscoped keys)
    — the entry's accounting identity is intrinsic to its key, so
    promotions and replacements always charge the same tenant no matter
    which request context performs them."""
    ns, _, _ = key.rpartition(":")
    i = ns.rfind(_TENANT_MARK)
    if i < 0:
        return DEFAULT_TENANT
    return unquote(ns[i + len(_TENANT_MARK):])


class _Entry:
    __slots__ = ("value", "nbytes", "tenant")

    def __init__(self, value: Any, nbytes: int, tenant: str = DEFAULT_TENANT):
        self.value = value
        self.nbytes = nbytes
        self.tenant = tenant


class ResultCache:
    """Byte-budgeted LRU + optional disk tier + single-flight coalescing.

    ``get_or_compute`` is the whole API surface the serving path uses; the
    lower-level ``get``/``put``/``invalidate`` exist for the ingest
    pipeline (bulk peek/store without single-flight) and the hot-swap hook.

    **Fleet federation hook** (:mod:`~lumen_tpu.runtime.federation`):
    ``peer_lookup`` — when set (peer-aware backends with
    ``LUMEN_FED_SELF``), a local miss consults the consistent-hash ring
    owner's cache over the wire BEFORE computing — owner-anchored
    dedupe: duplicates that reach the ring owner first (all
    front-tier-routed traffic) cost device work once fleet-wide; a
    result computed at a non-owner stays local (lookup-only protocol,
    no write-back). The hook is ``(key, payload) -> (found, value)``
    and must never raise into the serving path (failures are treated as
    a miss). ``None`` (the default, and the only state when federation
    is unconfigured) keeps the miss path byte-identical to single-host.
    """

    #: optional cross-host lookup consulted on the owner path of a miss
    #: (set by the federation boot wiring; None = single-host behavior).
    peer_lookup: Callable[[str, bytes], tuple[bool, Any]] | None = None

    def __init__(
        self,
        max_bytes: int | None = None,
        disk_dir: str | None = None,
        name: str = "result_cache",
    ):
        self.max_bytes = cache_bytes() if max_bytes is None else max(0, max_bytes)
        self.disk_dir = disk_dir if disk_dir is not None else cache_dir()
        if self.max_bytes == 0:
            # LUMEN_CACHE_BYTES=0 is the ONE kill switch, as documented:
            # it disables both tiers. A lingering LUMEN_CACHE_DIR must not
            # silently keep a disk-backed cache (and single-flight) alive
            # on a deployment that turned caching off.
            self.disk_dir = None
        self.name = name
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._bytes = 0
        self._inflight: dict[str, Future] = {}
        # Invalidation fence: a monotonic sequence bumped by invalidate(),
        # with the last-invalidation seq per prefix. A computation that
        # STARTED before an invalidation of its namespace must not store
        # its (predecessor-model) result after it — get_or_compute captures
        # the fence pre-compute and put() rejects anything stale. Bounded:
        # one entry per distinct prefix (service families).
        self._inval_seq = 0
        self._inval_marks: dict[str, int] = {}
        self._waiting = 0  # callers currently blocked on another's flight
        # Per-tenant RAM-tier byte accounting (entry tenant is intrinsic
        # to its key): drives fair-share-first eviction and the
        # ``bytes:{tenant}`` gauges. Only tenants with live entries keep
        # a row — a drained tenant's row is deleted, so churn through
        # many tenant ids cannot grow this without bound.
        self._tenant_bytes: dict[str, int] = {}
        # Per-tenant LRU key order mirroring ``_entries`` (same recency
        # updates, same lock): victim selection in fair-share eviction is
        # a first-key lookup instead of a scan over every other tenant's
        # entries — churn under one tenant must not hold the cache lock
        # for O(total entries) per eviction.
        self._tenant_lru: dict[str, OrderedDict[str, None]] = {}
        # Local mirrors of the global event counters, for gauges/bench.
        self.stats = {
            "hits": 0,
            "disk_hits": 0,
            "misses": 0,
            "coalesced": 0,
            "evictions": 0,
            "cross_tenant_evictions": 0,
            "stores": 0,
        }
        self._pickle_warned = False
        if self.disk_dir:
            try:
                os.makedirs(self.disk_dir, exist_ok=True)
            except OSError as e:
                logger.warning("cache disk tier disabled (%s): %s", self.disk_dir, e)
                self.disk_dir = None
        # Occupancy gauges next to the batcher/decode-pool providers; the
        # weakref keeps the global registry from pinning a dropped cache.
        ref = weakref.ref(self)

        def _gauges() -> dict:
            c = ref()
            return {} if c is None else c.gauges()

        self._gauge_fn = _gauges
        metrics.register_gauges(name, _gauges)

    # -- properties --------------------------------------------------------

    @property
    def enabled(self) -> bool:
        """False when both tiers are off — callers then run compute()
        directly (not even single-flight: an explicitly disabled cache
        must leave the serving path byte-for-byte as before)."""
        return self.max_bytes > 0 or self.disk_dir is not None

    def gauges(self) -> dict:
        with self._lock:
            out = {
                **self.stats,
                "bytes": self._bytes,
                "budget_bytes": self.max_bytes,
                "entries": len(self._entries),
                "inflight": len(self._inflight),
                "waiting": self._waiting,
            }
            # Per-tenant residency only when a non-default tenant holds
            # entries — single-tenant deployments keep the exact pre-QoS
            # gauge payload.
            if len(self._tenant_bytes) > 1 or (
                self._tenant_bytes and DEFAULT_TENANT not in self._tenant_bytes
            ):
                for tenant, n in sorted(self._tenant_bytes.items()):
                    out[f"bytes:{tenant}"] = n
        return out

    def hit_rate(self) -> float:
        with self._lock:
            hits = self.stats["hits"] + self.stats["disk_hits"]
            total = hits + self.stats["misses"]
        return hits / total if total else 0.0

    # -- core lookup -------------------------------------------------------

    def _count(self, stat: str, metric: str) -> None:
        self.stats[stat] += 1  # caller holds no lock; int += is fine for telemetry
        metrics.count(metric)

    def get(self, key: str, clone: Callable[[Any], Any] | None = None) -> tuple[bool, Any]:
        """RAM-then-disk probe. Returns ``(found, value)``; a disk hit is
        promoted into the RAM tier. Marks the request-note scope on hit,
        and records a ``cache.lookup`` span on the active request trace."""
        tr = current_trace()
        if tr is None:
            return self._get(key, clone)
        h = tr.begin("cache.lookup")
        found = False
        try:
            found, value = self._get(key, clone)
            return found, value
        finally:
            h.end(hit="1" if found else "0")

    def _get(self, key: str, clone: Callable[[Any], Any] | None = None) -> tuple[bool, Any]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._lru_touch_locked(entry.tenant, key)
                value = entry.value
            else:
                value = None
        if entry is not None:
            self._count("hits", "cache_hits")
            _mark("hit")
            return True, clone(value) if clone else value
        if self.disk_dir is not None:
            # Fence the promotion: a disk read racing an invalidation's
            # rmtree must neither serve nor re-promote the swept entry.
            fence = self.current_fence()
            found, value, nbytes = self._disk_read(key)
            if found and not self._stale(key, fence):
                self._store_ram(key, value, nbytes, fence=fence)
                self._count("disk_hits", "cache_disk_hits")
                _mark("hit")
                return True, clone(value) if clone else value
        return False, None

    def current_fence(self) -> int:
        """Snapshot of the invalidation sequence; pass to :meth:`put` to
        guarantee a result computed before a later invalidation of its
        namespace is never stored after it."""
        with self._lock:
            return self._inval_seq

    def _stale_locked(self, key: str, fence: int) -> bool:
        """Caller holds ``self._lock``."""
        return any(
            seq > fence and key.startswith(prefix)
            for prefix, seq in self._inval_marks.items()
        )

    def _stale(self, key: str, fence: int) -> bool:
        with self._lock:
            return self._stale_locked(key, fence)

    def put(
        self,
        key: str,
        value: Any,
        clone: Callable[[Any], Any] | None = None,
        fence: int | None = None,
    ) -> None:
        """Store a computed value in both tiers. ``clone`` (when given) is
        applied to the stored copy so the caller keeps exclusive ownership
        of the object it just computed — later mutation must not corrupt
        what other requests will be served. ``fence`` (from
        :meth:`current_fence`, taken before the compute) drops the store
        when the namespace was invalidated mid-compute — e.g. a model
        hot-swap racing an in-flight request on the old instance."""
        if fence is not None and self._stale(key, fence):
            return  # fast reject; the tiers re-check authoritatively
        blob = None
        if self.disk_dir is not None:
            blob = self._encode(value)
            if blob is None:
                return  # unpicklable: warned once, not cached
            nbytes = len(blob)
        else:
            # RAM-only: a structural size estimate avoids paying a full
            # pickle per store just to weigh the entry (the ingest settle
            # loop stores every record — this is a hot path).
            est = self._approx_nbytes(value)
            if est is None:
                return
            nbytes = est
        if clone is not None and blob is not None:
            # The pickle round-trip IS a deep copy — don't traverse the
            # value a second time (clone on hits still applies, giving
            # VLM-style custom clones their marker semantics there).
            stored = pickle.loads(blob)
        else:
            stored = clone(value) if clone else value
        self._store_ram(key, stored, nbytes, fence=fence)
        self._count("stores", "cache_stores")
        if blob is not None:
            self._disk_write(key, blob, fence=fence)

    def hot_keys(self, n: int = 8) -> list[str]:
        """The ``n`` most-recently-used RAM-tier keys, hottest first — the
        drain-handoff manifest a draining host gossips so the front can
        prefetch exactly these onto ring successors. ``_entries`` is kept
        in LRU order (MRU at the end), so the reversal is the recency
        ranking; no touch, no promotion — reading the manifest must not
        reorder the cache it describes."""
        with self._lock:
            keys = list(self._entries)
        return keys[::-1][:n]

    def _approx_nbytes(self, value: Any, _depth: int = 0) -> int | None:
        """Structural RAM weight for common result shapes (arrays, bytes,
        records, dataclasses); odd types fall back to one pickle."""
        if _depth > 8:
            blob = self._encode(value)
            return None if blob is None else len(blob)
        if isinstance(value, np.ndarray):
            return value.nbytes + 128
        if isinstance(value, (bytes, bytearray, str)):
            return len(value) + 64
        if value is None or isinstance(value, (bool, int, float, complex)):
            return 32
        if isinstance(value, (list, tuple, set, frozenset)):
            total = 64
            for v in value:
                n = self._approx_nbytes(v, _depth + 1)
                if n is None:
                    return None
                total += n
            return total
        if isinstance(value, dict):
            total = 64
            for k, v in value.items():
                nk = self._approx_nbytes(k, _depth + 1)
                nv = self._approx_nbytes(v, _depth + 1)
                if nk is None or nv is None:
                    return None
                total += nk + nv
            return total
        inner = getattr(value, "__dict__", None)
        if inner is not None:  # dataclass-style records (FaceDetection, ...)
            return self._approx_nbytes(inner, _depth + 1)
        blob = self._encode(value)
        return None if blob is None else len(blob)

    def get_or_compute(
        self,
        namespace: str,
        options: Mapping[str, Any] | None,
        payload: bytes,
        compute: Callable[[], Any],
        clone: Callable[[Any], Any] | None = None,
        key: str | None = None,
    ) -> Any:
        """The serving-path entry point: content-addressed lookup with
        single-flight coalescing around ``compute``.

        - **hit** (RAM or disk): the stored value (cloned when ``clone``)
          returns immediately — no decode, no batcher, no admission or
          deadline accounting.
        - **miss, first caller**: computes, stores, resolves the shared
          flight. Failures propagate to the caller and fan out to waiters
          (never cached — a poison verdict in particular can never be
          served as a "result").
        - **miss, concurrent duplicate**: waits on the owner's flight —
          one batcher submission serves the whole burst. If the owner
          failed with a *caller-specific* overload error (deadline/shed)
          or a containment verdict (poison isolation/quarantine), the
          waiter retries the compute itself instead of inheriting an
          error shaped by someone else's flight; a poison retry then hits
          the quarantine gate up front and earns its OWN properly-worded
          rejection, not a secondhand cache error.

        ``key`` skips the internal :func:`make_key` when the caller
        already hashed the payload (e.g. for the quarantine gate) — the
        sha256 over megabytes of image bytes should run once, not twice.
        """
        if not self.enabled:
            return compute()
        if key is None:
            key = make_key(namespace, options, payload)
        while True:
            found, value = self.get(key, clone=clone)
            if found:
                return value
            with self._lock:
                flight = self._inflight.get(key)
                if flight is None:
                    flight = Future()
                    self._inflight[key] = flight
                    owner = True
                else:
                    owner = False
            if owner:
                break
            with self._lock:
                self._waiting += 1
            tr = current_trace()
            wspan = tr.begin("cache.wait") if tr is not None else None
            try:
                # Bounded by the WAITER's own ambient request deadline
                # (None = wait for the owner, whose resolution is
                # guaranteed): the deadline contract must survive
                # coalescing — a 50ms-budget duplicate must not ride out
                # the owner's multi-second queue wait on a gRPC thread.
                # Clamped: a no-deadline request can surface as a HUGE
                # time_remaining() on some gRPC stacks, and that number
                # fed raw into Future.result overflows C time
                # (_PyTime_t) — observed live as INTERNAL errors on a
                # coalesced burst.
                rem = remaining()
                value = flight.result(
                    timeout=None if rem is None else min(rem, 86400.0)
                )
            except FuturesTimeout:
                metrics.count("deadline_drops")
                metrics.count("deadline_drops:result_cache")
                raise DeadlineExpired(
                    "request deadline expired waiting on a coalesced "
                    "identical request"
                ) from None
            except (DeadlineExpired, QueueFull, PoisonInput) as e:
                if isinstance(e, PoisonInput):
                    from .quarantine import get_quarantine

                    if not get_quarantine().enabled:
                        # With quarantine disabled there is no up-front
                        # gate to make the re-owned recompute cheap: each
                        # waiter would serially re-run the poison batch
                        # (plus a full bisection pass) at device cost. The
                        # verdict is payload-determined — identical bytes,
                        # identical poison — so share it instead.
                        raise
                # The OWNER was shed, ran out of ITS deadline budget, or
                # had its item isolated/quarantined as poison — none of
                # those verdicts are ours to replay as a cache answer.
                # Retire the failed flight (the owner's own cleanup may
                # not have run yet) and loop: re-probe, then race to
                # become the new owner. For poison that recompute is
                # cheap: the fingerprint is quarantined by now, so the
                # re-owning waiter is rejected before admission with the
                # real quarantine message.
                with self._lock:
                    if self._inflight.get(key) is flight:
                        self._inflight.pop(key)
                continue
            else:
                # Counted/marked only when the shared flight actually
                # SERVED this request — a waiter that re-owns after an
                # owner overload computes for itself and must not inflate
                # the absorption telemetry (or its response meta).
                self._count("coalesced", "cache_coalesced")
                _mark("coalesced")
                return clone(value) if clone else value
            finally:
                if wspan is not None:
                    wspan.end()
                with self._lock:
                    self._waiting -= 1
        # -- owner path
        self._count("misses", "cache_misses")
        fence = self.current_fence()
        try:
            value = None
            served_by_peer = False
            hook = self.peer_lookup
            if hook is not None:
                # Cross-host dedupe: ask the ring owner's cache before
                # burning device time. A hook failure of ANY kind is a
                # miss — federation must never break local serving.
                try:
                    served_by_peer, value = hook(key, payload)
                except Exception:  # noqa: BLE001 - peer lookup is best-effort
                    logger.exception("peer cache lookup failed; computing locally")
                    served_by_peer = False
            if served_by_peer:
                # Surfaces as ``cache_peer_hit`` response meta — the
                # client-observed proof that a duplicate cost no device
                # work anywhere in the fleet.
                _mark("peer_hit")
            else:
                value = compute()
        except BaseException as e:
            flight.set_exception(e)
            raise
        else:
            # Storing is best-effort and must never leave the flight
            # unresolved: a clone/pickle failure inside put() would
            # otherwise wedge every coalesced waiter on a Future nobody
            # will ever complete. The flight is resolved with a PRIVATE
            # copy when clone is set — the owner's caller owns `value` and
            # may mutate it the instant we return, racing waiters that
            # are still deep-copying the shared object.
            shared = value
            try:
                self.put(key, value, clone=clone, fence=fence)
                if clone is not None:
                    shared = clone(value)
            except Exception:  # noqa: BLE001 - caching must never break serving
                logger.exception("cache store failed; serving uncached")
            flight.set_result(shared)
            return value
        finally:
            # Object-guarded: a waiter that recovered from this flight's
            # overload failure may already own a NEW flight under the same
            # key — popping blindly would orphan its waiters into a
            # duplicate computation.
            with self._lock:
                if self._inflight.get(key) is flight:
                    self._inflight.pop(key)

    def peek_or_wait(self, key: str, wait_s: float = 0.0) -> tuple[bool, Any]:
        """Tier probe for the federation cache-lookup RPC: RAM-then-disk
        ``get``, and — when ``wait_s`` > 0 and an identical computation is
        in flight HERE — ride that flight instead of answering miss. This
        is what extends single-flight coalescing across the fleet: N hosts
        asking the owner for a key the owner is currently computing get
        ONE device submission total. Owner-overload failures on the flight
        (shed/deadline/poison) answer miss — those verdicts are the
        owner's, never the remote requester's."""
        found, value = self.get(key)
        if found or wait_s <= 0:
            return found, value
        with self._lock:
            flight = self._inflight.get(key)
        if flight is None:
            return False, None
        with self._lock:
            self._waiting += 1
        try:
            value = flight.result(timeout=min(wait_s, 86400.0))
        except BaseException:  # noqa: BLE001 - any flight failure is a miss here
            return False, None
        finally:
            with self._lock:
                self._waiting -= 1
        self._count("coalesced", "cache_coalesced")
        return True, value

    # -- invalidation ------------------------------------------------------

    def invalidate(self, prefix: str) -> int:
        """Drop every entry whose namespace starts with ``prefix`` (both
        tiers) and return how many RAM entries went. ``prefix`` is matched
        against the clear-text namespace half of the key, so
        ``invalidate("clip/")`` after a hot-swap clears every task and
        revision the swapped service ever served."""
        with self._lock:
            self._inval_seq += 1
            self._inval_marks[prefix] = self._inval_seq
            doomed = [k for k in self._entries if k.startswith(prefix)]
            for k in doomed:
                e = self._entries.pop(k)
                self._bytes -= e.nbytes
                self._account_locked(e.tenant, -e.nbytes)
                self._lru_forget_locked(e.tenant, k)
            # Retire matching in-flight computations too: a caller
            # arriving AFTER the invalidation must not coalesce onto a
            # pre-swap flight and be served the predecessor model's
            # output. Existing waiters keep their reference (they joined
            # pre-swap; the owner still resolves them), and the owner's
            # cleanup is object-guarded, so dropping the dict entry here
            # is safe.
            for k in [k for k in self._inflight if k.startswith(prefix)]:
                self._inflight.pop(k)
        if doomed:
            metrics.count("cache_invalidations", len(doomed))
        if self.disk_dir is not None:
            self._disk_invalidate(prefix)
        return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._tenant_bytes.clear()
            self._tenant_lru.clear()
            self._bytes = 0

    def close(self) -> None:
        metrics.unregister_gauges(self.name, self._gauge_fn)

    # -- RAM tier ----------------------------------------------------------

    def _accounting_tenant_locked(self, tenant: str) -> str:
        """Accounting identity for a stored entry, bounded at the same
        64-id cap as the quota/WFQ stat tables: overflow tenant ids
        collapse onto the shared ``_other`` identity. Without the cap a
        client spraying fabricated ``lumen-tenant`` ids would (a) shrink
        ``fair = max_bytes / #tenants`` until the legitimate largest
        tenant becomes the perpetual eviction victim while the
        ``cross_tenant_evictions`` watchdog stays silent, and (b) grow the
        ``bytes:{tenant}`` gauge payload without bound. Entries keep the
        identity they were stored under (it rides the ``_Entry``), so
        accounting stays consistent even as the mapping saturates."""
        if tenant in self._tenant_bytes or len(self._tenant_bytes) < _MAX_TENANT_STATS:
            return tenant
        return "_other"

    def _account_locked(self, tenant: str, delta: int) -> None:
        n = self._tenant_bytes.get(tenant, 0) + delta
        if n > 0:
            self._tenant_bytes[tenant] = n
        else:
            self._tenant_bytes.pop(tenant, None)

    def _lru_track_locked(self, tenant: str, key: str) -> None:
        self._tenant_lru.setdefault(tenant, OrderedDict())[key] = None

    def _lru_touch_locked(self, tenant: str, key: str) -> None:
        order = self._tenant_lru.get(tenant)
        if order is not None and key in order:
            order.move_to_end(key)

    def _lru_forget_locked(self, tenant: str, key: str) -> None:
        order = self._tenant_lru.get(tenant)
        if order is not None:
            order.pop(key, None)
            if not order:
                del self._tenant_lru[tenant]

    def _pop_victim_locked(self) -> _Entry:
        """Fair-share-first eviction: the victim is the least-recently-
        used entry of the tenant holding the MOST bytes. With one tenant
        (the common single-tenant deployment) this IS plain LRU. The
        largest tenant necessarily holds at least the mean share, so an
        under-fair-share tenant is never the victim — one tenant's churn
        cannot evict another's hot set. O(#tenants) via the per-tenant
        LRU mirror, never O(#entries)."""
        victim = None
        if len(self._tenant_bytes) > 1:
            fattest = max(self._tenant_bytes, key=self._tenant_bytes.get)
            order = self._tenant_lru.get(fattest)
            if order:  # accounting drift guard; always populated
                k = next(iter(order))
                victim = self._entries.pop(k)
                self._lru_forget_locked(fattest, k)
        if victim is None:
            k, victim = self._entries.popitem(last=False)
            self._lru_forget_locked(victim.tenant, k)
        self._bytes -= victim.nbytes
        self._account_locked(victim.tenant, -victim.nbytes)
        return victim

    def _store_ram(
        self, key: str, value: Any, nbytes: int, fence: int | None = None
    ) -> None:
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            return  # RAM tier off, or a single value that outweighs it
        tenant = key_tenant(key)
        evicted = 0
        cross = 0
        with self._lock:
            # Authoritative fence check, under the same lock invalidate()
            # sweeps with: either this insert lands before the sweep (and
            # is swept) or after the bump (and is rejected) — no window.
            if fence is not None and self._stale_locked(key, fence):
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
                self._account_locked(old.tenant, -old.nbytes)
                self._lru_forget_locked(old.tenant, key)
            tenant = self._accounting_tenant_locked(tenant)
            self._entries[key] = _Entry(value, nbytes, tenant)
            self._bytes += nbytes
            self._account_locked(tenant, nbytes)
            self._lru_track_locked(tenant, key)
            while self._bytes > self.max_bytes and self._entries:
                fair = self.max_bytes / max(1, len(self._tenant_bytes))
                victim = self._pop_victim_locked()
                evicted += 1
                if victim.tenant != tenant and (
                    self._tenant_bytes.get(victim.tenant, 0) + victim.nbytes < fair
                ):
                    # An under-fair-share tenant lost an entry to another
                    # tenant's store — the isolation violation the
                    # fair-share policy exists to prevent. Zero by
                    # construction; counted so the bench can prove it.
                    cross += 1
        if evicted:
            self.stats["evictions"] += evicted
            metrics.count("cache_evictions", evicted)
        if cross:
            self.stats["cross_tenant_evictions"] += cross
            metrics.count("cache_cross_tenant_evictions", cross)

    # -- disk tier ---------------------------------------------------------

    def _encode(self, value: Any) -> bytes | None:
        """Pickle once: the blob length is the (honest) RAM-tier weight and
        the blob itself is the disk-tier payload."""
        try:
            return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as e:  # noqa: BLE001 - caching must never break serving
            if not self._pickle_warned:
                self._pickle_warned = True
                logger.warning("unpicklable cache value (%s); not caching", e)
            return None

    def _disk_path(self, key: str) -> str:
        namespace, _, digest = key.rpartition(":")
        return os.path.join(self.disk_dir, quote(namespace, safe=""), digest + ".pkl")

    def _disk_read(self, key: str) -> tuple[bool, Any, int]:
        path = self._disk_path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
            return True, pickle.loads(blob), len(blob)
        except FileNotFoundError:
            return False, None, 0
        except Exception as e:  # noqa: BLE001 - a corrupt file is a miss, not a crash
            logger.warning("cache disk read failed for %s: %s", path, e)
            try:
                os.unlink(path)
            except OSError:
                pass
            return False, None, 0

    def _disk_write(self, key: str, blob: bytes, fence: int | None = None) -> None:
        path = self._disk_path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)  # atomic: readers never see a torn file
            # Post-replace fence: if an invalidation's rmtree swept this
            # namespace between our pre-checks and the replace, the file
            # just landed AFTER the sweep — undo it (the bump
            # happens-before the sweep, so a stale fence is visible here).
            if fence is not None and self._stale(key, fence):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        except OSError as e:
            logger.warning("cache disk write failed for %s: %s", path, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _disk_invalidate(self, prefix: str) -> None:
        import shutil

        try:
            subdirs = os.listdir(self.disk_dir)
        except OSError:
            return
        for sub in subdirs:
            if unquote(sub).startswith(prefix):
                shutil.rmtree(os.path.join(self.disk_dir, sub), ignore_errors=True)


# -- process-wide instance ---------------------------------------------------

_shared: ResultCache | None = None
_shared_lock = threading.Lock()


def get_result_cache() -> ResultCache:
    """The process-wide cache (lazily built from the env)."""
    global _shared
    if _shared is None:
        with _shared_lock:
            if _shared is None:
                _shared = ResultCache(name="result_cache")
    return _shared


def reset_result_cache() -> None:
    """Drop the shared cache (tests / clean shutdown); the next
    :func:`get_result_cache` rebuilds from the current env."""
    global _shared
    with _shared_lock:
        cache, _shared = _shared, None
    if cache is not None:
        cache.close()


def peer_export(key: str, wait_s: float = 0.0) -> bytes | None:
    """Wire-format (pickle) export of one entry for the federation
    cache-lookup RPC — ``None`` is a miss. Reads the shared cache WITHOUT
    instantiating one (a process that never cached owns nothing to
    export), honors the bounded flight wait (:meth:`ResultCache.peek_or_wait`),
    and answers miss for unpicklable values. Host-only and cheap: this is
    answered by the hub router before any admission accounting."""
    with _shared_lock:
        cache = _shared
    if cache is None or not cache.enabled:
        return None
    found, value = cache.peek_or_wait(key, wait_s=wait_s)
    if not found:
        return None
    blob = cache._encode(value)
    if blob is not None:
        metrics.count("fed_cache_serves")
    return blob


def hot_keys(n: int = 8) -> list[str]:
    """Module-level hot-key manifest for the capacity gossip: the shared
    cache's MRU keys WITHOUT instantiating a cache that was never used
    (same posture as :func:`peer_export` — a process that never cached
    has nothing hot)."""
    with _shared_lock:
        cache = _shared
    if cache is None or not cache.enabled:
        return []
    return cache.hot_keys(n)


#: the JAX package's top-level name: a peer blob naming one of its classes
#: is refused, never imported (split so no string names one of its modules)
_JAX_PACKAGE = "lumen" + "_tpu"


class _PeerUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] == _JAX_PACKAGE:
            raise pickle.UnpicklingError(
                f"a peer blob names {module}.{name}, a class of the JAX package; "
                "the port never imports it"
            )
        return super().find_class(module, name)


def peer_loads(blob: bytes) -> Any:
    """Unpickle a blob a federation peer sent (a cache-lookup answer or a
    drain-handoff push). A fleet may mix this package's hosts with the
    JAX package's, whose results pickle as that package's classes: such a
    blob raises :class:`pickle.UnpicklingError`, which both callers treat
    as a miss."""
    import io

    return _PeerUnpickler(io.BytesIO(blob)).load()


def peer_import(key: str, blob: bytes) -> bool:
    """Store a pickle blob pushed by the federation drain handoff (the
    write half of the peer-cache protocol; :func:`peer_export` is the
    read half). Unlike the export this DOES build the shared cache on
    first use — the push targets a ring successor that is about to
    inherit the drained host's arcs, and an empty cache is exactly the
    state the handoff exists to fix. Returns True when stored."""
    if not key or not blob:
        return False
    cache = get_result_cache()
    if not cache.enabled:
        return False
    try:
        value = peer_loads(blob)
    except Exception as e:  # noqa: BLE001 - a bad peer blob is a no-op, not a crash
        logger.warning("federation cache import failed for %r: %s", key, e)
        return False
    cache.put(key, value)
    metrics.count("fed_cache_imports")
    return True


def detach_peer_lookup(hook) -> None:
    """Remove a federation peer-lookup hook IF it is still the installed
    one (server teardown; a later boot may have installed its own).
    Bound methods are compared by (__self__, __func__): CPython
    materializes a FRESH bound-method object per attribute access, so a
    plain ``is`` on ``manager.peer_cache_lookup`` never matches the one
    installed at boot — and a stale hook left behind would keep routing
    every cache miss at a torn-down fleet."""
    with _shared_lock:
        cache = _shared
    if cache is None:
        return
    cur = cache.peer_lookup
    if cur is None:
        return
    same = cur is hook or (
        getattr(cur, "__func__", None) is getattr(hook, "__func__", object())
        and getattr(cur, "__self__", None) is getattr(hook, "__self__", object())
    )
    if same:
        cache.peer_lookup = None


def invalidate_namespace(prefix: str) -> int:
    """Prefix-invalidate WITHOUT instantiating a cache that was never
    used: the hot-swap hook calls this unconditionally, and a process that
    never cached anything should not allocate one just to clear it."""
    with _shared_lock:
        cache = _shared
    return cache.invalidate(prefix) if cache is not None else 0
