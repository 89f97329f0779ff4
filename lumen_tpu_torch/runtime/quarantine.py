"""TTL'd quarantine registry for poison-input fingerprints.

Batch bisection (:mod:`lumen_tpu.runtime.batcher`) isolates the input that
made a batch fail; this module remembers it. The first failure costs a
bisection pass (bounded sub-batch re-dispatches); every repeat of the same
payload is rejected *up front* — before admission control, the decode
pool, and the device — so a client (or a library re-index) hammering one
broken photo costs the hub a dict lookup, not a device batch.

Keying reuses the result cache's content addressing
(:func:`~lumen_tpu.runtime.result_cache.make_key`:
``{namespace}:{sha256(namespace, canonical options, payload)}``): the same
bytes under the same model/options that failed before are exactly the
bytes that will fail again, while the namespace half keeps one model's
poison from tainting another's. Entries expire after
``LUMEN_QUARANTINE_TTL_S`` (a hot-swapped or upgraded model deserves a
fresh verdict) and the registry is LRU-capped at ``LUMEN_QUARANTINE_MAX``
so an adversarial stream of unique poison cannot grow it without bound.

Rejections raise :class:`~lumen_tpu.utils.deadline.PoisonInput` and mark
the request-note scope (``quarantined``) so the gRPC layer surfaces the
verdict in trailing metadata.

Deliberately jax-free (like :mod:`~lumen_tpu.runtime.result_cache`): pure
host bookkeeping, usable from the serving layer without a backend.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import OrderedDict

from ..utils.deadline import PoisonInput
from ..utils.env import env_float, env_int
from ..utils.metrics import metrics
from ..utils.request_notes import mark as _mark

logger = logging.getLogger(__name__)

QUARANTINE_TTL_ENV = "LUMEN_QUARANTINE_TTL_S"
QUARANTINE_MAX_ENV = "LUMEN_QUARANTINE_MAX"

DEFAULT_TTL_S = 300.0
DEFAULT_MAX_ENTRIES = 4096


def quarantine_ttl_s() -> float:
    """``LUMEN_QUARANTINE_TTL_S``: seconds an isolated fingerprint stays
    rejected (0 disables quarantine entirely; unset/malformed -> 300)."""
    return env_float(QUARANTINE_TTL_ENV, DEFAULT_TTL_S, minimum=0.0)


def quarantine_max_entries() -> int:
    """``LUMEN_QUARANTINE_MAX``: LRU cap on tracked fingerprints
    (unset/malformed -> 4096; floor 1)."""
    return env_int(QUARANTINE_MAX_ENV, DEFAULT_MAX_ENTRIES, minimum=1)


class _Entry:
    __slots__ = ("expires_at", "reason", "rejections")

    def __init__(self, expires_at: float, reason: str):
        self.expires_at = expires_at
        self.reason = reason
        self.rejections = 0


class QuarantineRegistry:
    """Thread-safe fingerprint -> (expiry, reason) map with LRU eviction.

    ``add`` is called by whatever *proved* an input poison (batch
    bisection, per-item ingest salvage); ``check`` is the hot-path guard
    the managers and the batcher call before spending any work on a
    payload."""

    def __init__(
        self,
        ttl_s: float | None = None,
        max_entries: int | None = None,
        name: str = "quarantine",
    ):
        self.ttl_s = quarantine_ttl_s() if ttl_s is None else max(0.0, ttl_s)
        self.max_entries = (
            quarantine_max_entries() if max_entries is None else max(1, max_entries)
        )
        self.name = name
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self.stats = {"quarantined": 0, "rejections": 0, "expired": 0, "evicted": 0}
        ref = weakref.ref(self)

        def _gauges() -> dict:
            q = ref()
            if q is None:
                return {}
            with q._lock:
                return {**q.stats, "entries": len(q._entries)}

        self._gauge_fn = _gauges
        metrics.register_gauges(name, _gauges)

    @property
    def enabled(self) -> bool:
        return self.ttl_s > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- registration ------------------------------------------------------

    def add(self, key: str, reason: str) -> bool:
        """Quarantine ``key`` for ``ttl_s`` seconds. Returns False when
        quarantine is disabled. Re-adding refreshes the TTL (the input
        just proved itself poison again)."""
        if not self.enabled or not key:
            return False
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                entry = _Entry(0.0, reason)
                self.stats["quarantined"] += 1
            entry.expires_at = time.monotonic() + self.ttl_s
            entry.reason = reason
            self._entries[key] = entry
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.stats["evicted"] += 1
        metrics.count("quarantine_adds")
        from ..utils import telemetry

        telemetry.record_event(
            "quarantine_add", self.name, reason,
            fingerprint=key.split(":")[-1][:16],
        )
        logger.warning("quarantined input %s: %s", key.split(":")[-1][:16], reason)
        return True

    # -- lookup ------------------------------------------------------------

    def reason(self, key: str | None) -> str | None:
        """Why ``key`` is quarantined, or None. Expired entries are purged
        lazily here (no sweeper thread); a live hit refreshes LRU order
        but NOT the TTL — rejections must not keep an entry alive forever."""
        if not self.enabled or not key:
            return None
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            if now >= entry.expires_at:
                self._entries.pop(key, None)
                self.stats["expired"] += 1
                return None
            self._entries.move_to_end(key)
            entry.rejections += 1
            self.stats["rejections"] += 1
        metrics.count("quarantine_rejections")
        return entry.reason

    def check(self, key: str | None) -> None:
        """Raise :class:`PoisonInput` when ``key`` is quarantined — the
        up-front rejection every layer calls before spending work. Marks
        the request-note scope so the response carries ``quarantined``,
        and records a ``quarantine`` span on the active request trace
        (only when one is live — the bare lookup stays a dict probe)."""
        from .trace import current_trace

        tr = current_trace()
        span = tr.begin("quarantine") if tr is not None else None
        reason = self.reason(key)
        if span is not None:
            span.end(rejected="1" if reason is not None else "0")
        if reason is not None:
            _mark("quarantined")
            raise PoisonInput(
                f"input quarantined after being isolated as a poison batch "
                f"member (TTL {self.ttl_s:.0f}s): {reason}"
            )

    # -- lifecycle ---------------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def close(self) -> None:
        metrics.unregister_gauges(self.name, self._gauge_fn)


def guarded_key(namespace: str, options, payload: bytes) -> str | None:
    """The managers' pre-compute gate: one content address serving BOTH
    the quarantine rejection (raises :class:`PoisonInput` on a hit) and
    the result-cache lookup — or ``None`` when the cache and quarantine
    are both disabled, in which case NO hash is computed at all (the
    ``LUMEN_CACHE_BYTES=0`` kill-switch path must not pay a sha256 over
    megabytes of image bytes to feed two disabled gates)."""
    from .result_cache import get_result_cache, make_key

    quarantine = get_quarantine()
    if not quarantine.enabled and not get_result_cache().enabled:
        return None
    key = make_key(namespace, options, payload)
    quarantine.check(key)
    return key


# -- process-wide instance ---------------------------------------------------

_shared: QuarantineRegistry | None = None
_shared_lock = threading.Lock()


def get_quarantine() -> QuarantineRegistry:
    """The process-wide registry (lazily built from the env)."""
    global _shared
    if _shared is None:
        with _shared_lock:
            if _shared is None:
                _shared = QuarantineRegistry(name="quarantine")
    return _shared


def reset_quarantine() -> None:
    """Drop the shared registry (tests); the next :func:`get_quarantine`
    rebuilds from the current env."""
    global _shared
    with _shared_lock:
        registry, _shared = _shared, None
    if registry is not None:
        registry.close()
