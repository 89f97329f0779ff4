"""Capacity telemetry: rolling windows, duty cycles, SLO burn, flight recorder.

Cumulative histograms and per-request traces (``utils/metrics``,
``utils/trace``) cannot answer the questions capacity control hinges
on: *what fraction of each replica's wall-clock is the device actually
busy right now*, *how much HBM headroom is left*, *is the host lane or
the device the wall this minute* — and after an hour of traffic the
since-boot ``p99_ms`` in ``/metrics.json`` is immovable, so "right now"
is exactly what the old surface cannot say. This module is the
always-on measurement layer that makes those questions answerable from a
single HTTP probe:

- **rolling windows** — every rate/quantile/utilization here lives in a
  ring of time buckets (``LUMEN_TELEMETRY_BUCKET_S`` wide,
  ``LUMEN_TELEMETRY_RETAIN_S`` of history), so ``GET /stats?window=N``
  reports "the last N seconds", not "since boot".
  :class:`RollingCounter` (windowed event totals/rates),
  :class:`RollingHistogram` (windowed latency quantiles) and
  :class:`DutyMeter` (busy-time accounting) share the bucket mechanics.
- **duty cycles** — components report *busy intervals*
  (:func:`busy`): the micro-batcher reports each batch's
  dispatch→settle interval per replica (``device:{batcher}``, the same
  envelope its ``batch.device`` trace spans cover, so span-derived and
  windowed duty agree), the decode pool reports per-task run time
  (``decode:{pool}``, capacity = worker count). A duty fraction is
  ``busy_s / (window * capacity)``.
- **SLO burn-rate engine** — :class:`SLOEngine` reads per-task latency
  objectives from ``LUMEN_SLO_<TASK>_P95_MS`` knobs and an availability
  objective from ``LUMEN_SLO_AVAILABILITY``, tracks good/slow/error
  counts in rolling windows, and reports multi-window (5m/1h)
  error-budget burn rates. Burn > 1 on the short window flips the task
  to ``breach`` (counted on ``slo_breaches`` / ``slo_breaches:{task}``,
  recorded as an ``slo_breach`` flight-recorder event, surfaced in the
  router's ``lumen-slo-status`` Health trailing metadata); burn falling
  back under 1 recovers it.
- **incident flight recorder** — :func:`record_event` appends bounded
  structured operational events (sheds, breaker transitions, replica
  down/revive, quarantine adds, watchdog fires, brownout rung changes,
  recovery swaps) carrying timestamp/tenant/trace-id. Trigger kinds
  (breaker open, replica down, SLO breach) automatically capture an
  **incident bundle**: the recent event window, retained request traces
  (ids + bodies), a device-memory snapshot, and the gauge/counter
  surface — the post-mortem context that is gone by the time a human
  looks, served from the sidecar as ``GET /incidents``.

**Overhead contract** (same discipline as the trace layer): the
per-request cost with all telemetry knobs unset is one cached env check
plus one rolling-histogram observe — tier-1 asserts <2µs/request.
Everything else is per-*batch* or per-*event*, and all retention is
bounded (rings, name caps, event/incident caps). ``LUMEN_TELEMETRY=0``
turns the rolling feed into a pure no-op.

Deliberately jax-free (stdlib + ``utils.metrics``/``utils.trace``): the
serving base class, the router and the client import this without a
backend. :mod:`lumen_tpu.runtime.telemetry` is the runtime-side façade,
like ``runtime/qos.py`` and ``runtime/trace.py``.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Callable

from .env import env_float, env_int
from .metrics import MetricsRegistry, metrics

logger = logging.getLogger(__name__)

TELEMETRY_ENV = "LUMEN_TELEMETRY"
BUCKET_ENV = "LUMEN_TELEMETRY_BUCKET_S"
RETAIN_ENV = "LUMEN_TELEMETRY_RETAIN_S"
EVENTS_RING_ENV = "LUMEN_EVENTS_RING"
INCIDENTS_MAX_ENV = "LUMEN_INCIDENTS_MAX"
INCIDENT_COOLDOWN_ENV = "LUMEN_INCIDENT_COOLDOWN_S"
SLO_AVAILABILITY_ENV = "LUMEN_SLO_AVAILABILITY"

#: per-task latency objective knob shape: ``LUMEN_SLO_<TASK>_P95_MS``
#: (task name uppercased, e.g. ``LUMEN_SLO_CLIP_IMAGE_EMBED_P95_MS``).
SLO_PREFIX = "LUMEN_SLO_"
SLO_SUFFIX = "_P95_MS"

#: gRPC Health trailing-metadata key carrying the SLO engine's state
#: (emitted by the router next to the breaker/replica/qos keys).
SLO_META_KEY = "lumen-slo-status"

#: SLO burn windows: (short, long) seconds — the 5m window decides
#: breach/recovery, the 1h window says how fast the monthly budget burns.
SLO_WINDOWS_S = (300.0, 3600.0)

#: event kinds that automatically capture an incident bundle.
INCIDENT_KINDS = ("breaker_open", "replica_down", "slo_breach", "fed_peer_down")

# Latched enabled flag: unlike utils/trace.py's per-call env re-read,
# the always-on layer latches the knob at first use — ``os.environ.get``
# alone costs over a microsecond on a loaded 1-core host, which would
# blow most of the <2µs per-request budget on a parse of the SAME
# answer. ``reset_hub()`` (tests / intentional reconfiguration) drops
# the latch.
_enabled_flag: bool | None = None


def telemetry_enabled() -> bool:
    """``LUMEN_TELEMETRY`` (default ON): the rolling-window feed. ``0``
    turns :func:`observe`/:func:`count`/:func:`busy` into no-ops (the
    flight recorder stays live — events are rare and bounded). Latched
    at first use; :func:`reset_hub` re-reads the env."""
    global _enabled_flag
    flag = _enabled_flag
    if flag is None:
        flag = _enabled_flag = os.environ.get(TELEMETRY_ENV) != "0"
    return flag


def telemetry_bucket_s() -> float:
    """``LUMEN_TELEMETRY_BUCKET_S``: ring time-bucket width (default 5s).
    Window edges are resolved to whole buckets, so reported windows are
    accurate to ±one bucket."""
    return env_float(BUCKET_ENV, 5.0, minimum=0.05)


def telemetry_retain_s() -> float:
    """``LUMEN_TELEMETRY_RETAIN_S``: how much history the rings keep
    (default 600s — enough for ``window=60``/``window=300`` queries; the
    SLO engine keeps its own coarser 1h rings either way)."""
    return env_float(RETAIN_ENV, 600.0, minimum=10.0)


def events_ring() -> int:
    """``LUMEN_EVENTS_RING``: flight-recorder capacity (default 512
    events; 0 disables event recording AND incident capture)."""
    return env_int(EVENTS_RING_ENV, 512, minimum=0)


def incidents_max() -> int:
    """``LUMEN_INCIDENTS_MAX``: retained incident bundles (default 8,
    oldest evicted first)."""
    return env_int(INCIDENTS_MAX_ENV, 8, minimum=1)


def incident_cooldown_s() -> float:
    """``LUMEN_INCIDENT_COOLDOWN_S``: per-kind debounce between bundle
    captures (default 30s) — a flapping breaker must not churn every
    retained bundle out of the store."""
    return env_float(INCIDENT_COOLDOWN_ENV, 30.0, minimum=0.0)


# -- rolling-window primitives ------------------------------------------------


class RollingCounter:
    """Windowed event totals: a ring of per-time-bucket sums.

    ``add(n)`` lands ``n`` in the current bucket; ``total(window_s)``
    sums the buckets covering the last ``window_s`` seconds. Stale slots
    (epochs older than the ring) are lazily zeroed on write and skipped
    on read — no sweeper thread."""

    __slots__ = ("bucket_s", "slots", "_vals", "_epochs", "_lock")

    def __init__(self, bucket_s: float, slots: int):
        self.bucket_s = bucket_s
        self.slots = max(2, slots)
        self._vals = [0.0] * self.slots
        self._epochs = [-1] * self.slots
        self._lock = threading.Lock()

    def add(self, n: float, now: float) -> None:
        epoch = int(now / self.bucket_s)
        i = epoch % self.slots
        with self._lock:
            if self._epochs[i] != epoch:
                self._epochs[i] = epoch
                self._vals[i] = 0.0
            self._vals[i] += n

    def total(self, window_s: float, now: float) -> float:
        epoch = int(now / self.bucket_s)
        # Whole buckets only: the current (partial) bucket counts, plus
        # enough full buckets to cover the window.
        n_back = int(window_s / self.bucket_s)
        oldest = epoch - n_back
        out = 0.0
        with self._lock:
            for i in range(self.slots):
                if oldest <= self._epochs[i] <= epoch:
                    out += self._vals[i]
        return out

    def series(self, window_s: float, now: float) -> list[float]:
        """Per-bucket totals over the last ``window_s`` seconds, oldest
        first, COMPLETED buckets only — the current partial bucket would
        bias a trend fit low. Buckets nothing landed in read 0.0."""
        epoch = int(now / self.bucket_s)
        n_back = min(self.slots - 1, max(2, int(window_s / self.bucket_s)))
        with self._lock:
            have = dict(zip(self._epochs, self._vals))
        return [have.get(e, 0.0) for e in range(epoch - n_back, epoch)]


class RollingHistogram:
    """Windowed latency quantiles: a ring of per-bucket count arrays
    sharing the metrics registry's log-spaced bounds, so a windowed p95
    and the cumulative ``/metrics`` p95 quantize identically."""

    __slots__ = (
        "bucket_s", "slots", "bounds", "_nb",
        "_counts", "_sums", "_totals", "_epochs", "_lock",
    )

    def __init__(self, bucket_s: float, slots: int, bounds: list[float] | None = None):
        from .metrics import _default_bounds

        self.bucket_s = bucket_s
        self.slots = max(2, slots)
        self.bounds = bounds if bounds is not None else _default_bounds()
        self._nb = len(self.bounds) + 1
        # Slot count arrays are allocated lazily (None until first write)
        # so hundreds of mostly-idle names don't pin len(bounds)-sized
        # lists per time bucket.
        self._counts: list[list[int] | None] = [None] * self.slots
        self._sums = [0.0] * self.slots
        self._totals = [0] * self.slots
        self._epochs = [-1] * self.slots
        self._lock = threading.Lock()

    def observe(self, ms: float, now: float) -> None:
        # THE per-request method (via the metrics tee): local-aliased and
        # branch-light on purpose — its cost is most of the always-on
        # <2µs budget the tier-1 guard enforces.
        epoch = int(now / self.bucket_s)
        i = epoch % self.slots
        idx = bisect_left(self.bounds, ms)
        with self._lock:
            epochs = self._epochs
            if epochs[i] != epoch:
                epochs[i] = epoch
                self._counts[i] = None
                self._sums[i] = 0.0
                self._totals[i] = 0
            counts = self._counts[i]
            if counts is None:
                counts = self._counts[i] = [0] * self._nb
            counts[idx] += 1
            self._totals[i] += 1
            self._sums[i] += ms

    def window(self, window_s: float, now: float) -> dict:
        """``{count, sum_ms, mean_ms, p50_ms, p95_ms, p99_ms}`` over the
        last ``window_s`` seconds (quantiles are bucket upper bounds,
        like the cumulative histograms')."""
        epoch = int(now / self.bucket_s)
        oldest = epoch - int(window_s / self.bucket_s)
        merged = [0] * (len(self.bounds) + 1)
        total = 0
        sum_ms = 0.0
        with self._lock:
            for i in range(self.slots):
                if oldest <= self._epochs[i] <= epoch and self._counts[i] is not None:
                    counts = self._counts[i]
                    for j, c in enumerate(counts):
                        merged[j] += c
                    total += self._totals[i]
                    sum_ms += self._sums[i]
        if total == 0:
            return {"count": 0, "sum_ms": 0.0, "mean_ms": 0.0,
                    "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}

        def pct(q: float) -> float:
            rank = q * total
            seen = 0
            for j, c in enumerate(merged):
                seen += c
                if seen >= rank:
                    return self.bounds[j] if j < len(self.bounds) else self.bounds[-1]
            return self.bounds[-1]

        return {
            "count": total,
            "sum_ms": round(sum_ms, 3),
            "mean_ms": round(sum_ms / total, 3),
            "p50_ms": round(pct(0.50), 3),
            "p95_ms": round(pct(0.95), 3),
            "p99_ms": round(pct(0.99), 3),
        }

class DutyMeter:
    """Busy-time accounting for one resource.

    ``add(t0, t1)`` credits the busy interval to the time buckets it
    overlaps. Two modes:

    - **union** (``union=True``, capacity 1) — for a serialized resource
      observed through possibly-overlapping reports (the batcher's
      dispatch→settle envelopes overlap under pipelining): intervals are
      clamped against the furthest end seen, so duty can never exceed
      wall time. Correct because settle order == dispatch order.
    - **sum** (default) — for a pool of ``capacity`` workers reporting
      per-task run time: busy seconds add up and the fraction divides by
      ``window * capacity``.
    """

    __slots__ = ("counter", "capacity", "union", "_last_end", "_lock")

    def __init__(self, bucket_s: float, slots: int, capacity: float = 1.0, union: bool = False):
        self.counter = RollingCounter(bucket_s, slots)
        self.capacity = max(1e-9, capacity)
        self.union = union
        self._last_end = -float("inf")
        self._lock = threading.Lock()

    def add(self, t0: float, t1: float) -> None:
        if self.union:
            with self._lock:
                t0 = max(t0, self._last_end)
                if t1 <= t0:
                    return
                self._last_end = t1
        elif t1 <= t0:
            return
        # Split the interval across the buckets it overlaps (usually 1-2).
        bucket = self.counter.bucket_s
        cur = t0
        while cur < t1:
            edge = (int(cur / bucket) + 1) * bucket
            end = min(edge, t1)
            self.counter.add(end - cur, cur)
            cur = end

    def window(self, window_s: float, now: float) -> dict:
        busy = self.counter.total(window_s, now)
        frac = busy / (window_s * self.capacity) if window_s > 0 else 0.0
        return {
            "busy_s": round(busy, 3),
            "fraction": round(min(1.0, frac), 4),
            "capacity": self.capacity,
        }


# -- SLO engine ---------------------------------------------------------------


def _slo_env_task(key: str) -> str | None:
    """``LUMEN_SLO_CLIP_IMAGE_EMBED_P95_MS`` -> ``clip_image_embed``;
    None for non-objective keys (e.g. ``LUMEN_SLO_AVAILABILITY``)."""
    if not key.startswith(SLO_PREFIX) or not key.endswith(SLO_SUFFIX):
        return None
    middle = key[len(SLO_PREFIX):-len(SLO_SUFFIX)]
    return middle.lower() if middle else None


def slo_objectives() -> dict[str, float]:
    """Per-task p95 objectives from the environment: ``{task: ms}``."""
    out: dict[str, float] = {}
    for key, raw in os.environ.items():
        task = _slo_env_task(key)
        if task is None:
            continue
        try:
            ms = float(raw)
        except ValueError:
            logger.warning("ignoring malformed SLO knob %s=%r", key, raw)
            continue
        if ms > 0:
            out[task] = ms
    return out


def slo_availability() -> float | None:
    """``LUMEN_SLO_AVAILABILITY``: availability objective in (0, 1)
    (e.g. ``0.999``); unset/malformed = no availability SLO."""
    raw = os.environ.get(SLO_AVAILABILITY_ENV)
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r", SLO_AVAILABILITY_ENV, raw)
        return None
    return v if 0.0 < v < 1.0 else None


class SLOEngine:
    """Multi-window error-budget burn rates for configured objectives.

    A latency objective ``p95 <= X ms`` allows 5% of requests over X; a
    burn rate is ``observed_slow_fraction / 0.05``. An availability
    objective ``A`` allows ``1 - A`` errors; burn is
    ``error_fraction / (1 - A)``. Burn 1.0 = spending budget exactly at
    the sustainable rate; >1 on the short (5m) window flips the task to
    **breach** (counted + flight-recorded once per transition), and
    dropping back to <=1 recovers it. Evaluation is lazy — every surface
    (Health, ``/slo``, ``/stats``, the ``slo`` gauge provider) evaluates
    on read, so there is no poller thread and fake-clock tests drive
    transitions deterministically.

    The engine keeps its OWN coarse rings (60s buckets x the long
    window) so the 1h burn never depends on ``LUMEN_TELEMETRY_RETAIN_S``.
    Slow/fast is classified EXACTLY at feed time against the objective
    (the precise latency is in hand there) — deriving it from log-spaced
    histogram buckets would leave a ~47%-wide blind band around every
    bucket boundary, and objectives below the first bound could never
    breach at all.
    """

    BUCKET_S = 60.0

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.objectives = slo_objectives()
        self.availability = slo_availability()
        slots = int(SLO_WINDOWS_S[1] / self.BUCKET_S) + 2
        self._n: dict[str, RollingCounter] = {}
        self._slow: dict[str, RollingCounter] = {}
        self._errors: dict[str, RollingCounter] = {}
        self._states: dict[str, str] = {}
        self._slots = slots

    @property
    def enabled(self) -> bool:
        return bool(self.objectives) or self.availability is not None

    #: observe() names that are internal instrumentation, not served
    #: tasks — the availability SLO must not grow bogus "task" rows for
    #: them (per-stage trace histograms, kernel build durations).
    _INTERNAL_PREFIXES = ("stage:", "kernel_build")

    def _tracked(self, task: str) -> bool:
        return task in self.objectives or (
            self.availability is not None
            and not task.startswith(self._INTERNAL_PREFIXES)
        )

    def _counter(self, table: dict[str, RollingCounter], task: str) -> RollingCounter:
        ctr = table.get(task)
        if ctr is None:
            with self._lock:
                ctr = table.setdefault(
                    task, RollingCounter(self.BUCKET_S, self._slots)
                )
        return ctr

    def feed(self, task: str, ms: float) -> None:
        if not self._tracked(task):
            return
        now = self._clock()
        self._counter(self._n, task).add(1, now)
        threshold = self.objectives.get(task)
        if threshold is not None and ms > threshold:
            self._counter(self._slow, task).add(1, now)

    def feed_error(self, task: str) -> None:
        if not self._tracked(task):
            return
        self._counter(self._errors, task).add(1, self._clock())

    # -- evaluation --------------------------------------------------------

    def _burns(self, task: str, now: float) -> dict[str, Any]:
        out: dict[str, Any] = {}
        n = self._n.get(task)
        slow_ctr = self._slow.get(task)
        errors = self._errors.get(task)
        threshold = self.objectives.get(task)
        for label, win in zip(("5m", "1h"), SLO_WINDOWS_S):
            total = n.total(win, now) if n is not None else 0
            slow = slow_ctr.total(win, now) if slow_ctr is not None else 0
            err = errors.total(win, now) if errors is not None else 0.0
            burn = 0.0
            if threshold is not None and total > 0:
                burn = (slow / total) / 0.05
            if self.availability is not None and (total + err) > 0:
                avail_burn = (err / (total + err)) / (1.0 - self.availability)
                burn = max(burn, avail_burn)
                out[f"availability_burn_{label}"] = round(avail_burn, 3)
            out[f"burn_{label}"] = round(burn, 3)
            if label == "5m":
                out["window_requests"] = int(total + err)
        if threshold is not None:
            out["objective_p95_ms"] = threshold
        if self.availability is not None:
            out["objective_availability"] = self.availability
        return out

    def status(self) -> dict[str, dict]:
        """Evaluate every tracked task: ``{task: {state, burn_5m,
        burn_1h, ...}}``. Breach transitions are counted and
        flight-recorded HERE (once per ok->breach edge)."""
        if not self.enabled:
            return {}
        now = self._clock()
        with self._lock:
            tasks = sorted(set(self._n) | set(self._errors) | set(self.objectives))
        out: dict[str, dict] = {}
        breached: list[tuple[str, dict]] = []
        recovered: list[str] = []
        for task in tasks:
            rec = self._burns(task, now)
            burn = rec.get("burn_5m", 0.0)
            observed = rec.get("window_requests", 0) > 0
            state = "breach" if (burn > 1.0 and observed) else "ok"
            with self._lock:
                prev = self._states.get(task, "ok")
                self._states[task] = state
            if state == "breach" and prev != "breach":
                breached.append((task, rec))
            elif state == "ok" and prev == "breach":
                recovered.append(task)
            rec["state"] = state
            out[task] = rec
        # Counters/events OUTSIDE the engine lock (metrics.count tees back
        # into the telemetry hub; holding our lock across it invites
        # ordering surprises even though today's paths don't cycle).
        for task, rec in breached:
            metrics.count("slo_breaches")
            metrics.count(f"slo_breaches:{task}")
            record_event(
                "slo_breach", task,
                f"burn_5m={rec.get('burn_5m')} over objective "
                f"(p95<={rec.get('objective_p95_ms', '-')}ms, "
                f"availability>={rec.get('objective_availability', '-')})",
            )
        for task in recovered:
            record_event("slo_recover", task, "burn back under 1.0")
        return out


# -- flight recorder ----------------------------------------------------------


class EventLog:
    """Bounded ring of structured operational events.

    Every record carries a wall-clock timestamp, the ambient tenant (from
    the QoS contextvar) and the active trace id when one exists — an
    event during a traced request greps straight to its trace. High-rate
    kinds (sheds) pass ``min_interval_s`` so a flood cannot churn the
    breaker transitions out of the ring."""

    def __init__(self, capacity: int | None = None):
        self.capacity = events_ring() if capacity is None else max(0, capacity)
        self._ring: deque[dict] = deque(maxlen=max(1, self.capacity))
        self._lock = threading.Lock()
        self._seq = 0
        self._last: dict[tuple[str, str], float] = {}

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def record(
        self,
        kind: str,
        component: str,
        message: str,
        min_interval_s: float = 0.0,
        **fields: Any,
    ) -> dict | None:
        if not self.enabled:
            return None
        now_mono = time.monotonic()
        if min_interval_s > 0:
            key = (kind, component)
            with self._lock:
                last = self._last.get(key)
                if last is not None and now_mono - last < min_interval_s:
                    return None
                self._last[key] = now_mono
        event: dict[str, Any] = {
            "unix_ms": round(time.time() * 1e3, 1),
            "kind": kind,
            "component": component,
            "message": message,
        }
        qos = sys.modules.get(f"{__package__}.qos")
        if qos is not None:
            try:
                tenant = qos.current_tenant()
                if tenant and tenant != qos.DEFAULT_TENANT:
                    event["tenant"] = tenant
            except Exception:  # noqa: BLE001 - telemetry must never break the caller
                pass
        trace_mod = sys.modules.get(f"{__package__}.trace")
        if trace_mod is not None:
            tr = trace_mod.current_trace()
            if tr is not None:
                event["trace_id"] = tr.trace_id
        if fields:
            event.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._ring.append(event)
        return event

    def export(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._ring)
        # Positive n = newest-n tail; anything else = everything (a
        # negative slice bound would invert the meaning to drop-oldest).
        return out[-n:] if n is not None and n > 0 else out


class IncidentRecorder:
    """Bounded store of incident bundles — the flight recorder's crash
    dump. A bundle freezes the operational context around a trigger
    event (breaker open, replica down, SLO breach): the recent event
    window, the retained request traces (always-retained error traces
    included, so >=1 correlated trace id exists whenever tracing is on),
    a device-memory snapshot and the live gauge/counter surface."""

    #: traces embedded per bundle (ids of ALL retained traces ride along).
    MAX_TRACES = 8
    #: events embedded per bundle.
    MAX_EVENTS = 64

    def __init__(self, capacity: int | None = None, cooldown_s: float | None = None):
        self.capacity = incidents_max() if capacity is None else max(1, capacity)
        self.cooldown_s = incident_cooldown_s() if cooldown_s is None else max(0.0, cooldown_s)
        self._bundles: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._last_by_kind: dict[str, float] = {}
        self._capturing = threading.local()

    def capture(self, trigger: dict, events: list[dict], slo: dict) -> dict | None:
        kind = trigger.get("kind", "unknown")
        # Re-entrancy guard: the gauge snapshot below evaluates the SLO
        # gauge provider, whose breach transition would record an
        # slo_breach event and try to capture ANOTHER bundle from inside
        # this one — one bundle per trigger, the nested transition still
        # lands in the event ring and gets its own bundle next probe.
        if getattr(self._capturing, "active", False):
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_by_kind.get(kind)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_by_kind[kind] = now
            self._seq += 1
            seq = self._seq
        self._capturing.active = True
        from .trace import get_recorder

        try:
            traces = get_recorder().traces()
            snap = metrics.snapshot()
            bundle = {
                "id": seq,
                "unix_ms": round(time.time() * 1e3, 1),
                "kind": kind,
                "trigger": trigger,
                "events": events[-self.MAX_EVENTS:],
                "trace_ids": [t["trace_id"] for t in traces],
                "traces": traces[-self.MAX_TRACES:],
                "device_memory": MetricsRegistry.device_memory(),
                "gauges": snap.get("gauges", {}),
                "counters": snap.get("counters", {}),
                "slo": slo,
            }
        finally:
            self._capturing.active = False
        with self._lock:
            self._bundles.append(bundle)
        metrics.count("incidents_captured")
        logger.error(
            "incident bundle #%d captured (trigger: %s %s — %s)",
            seq, kind, trigger.get("component"), trigger.get("message"),
        )
        return bundle

    def export(self) -> list[dict]:
        with self._lock:
            return list(self._bundles)


# -- the hub ------------------------------------------------------------------


class TelemetryHub:
    """Process-wide container tying the rolling rings, the SLO engine
    and the flight recorder together. One instance per process (see
    :func:`get_hub`); tests build their own with a fake clock and
    install it via :func:`install_hub`."""

    #: cap on distinct rolling names per kind — a name-spraying caller
    #: lands on ``_other`` instead of growing the rings without bound.
    MAX_NAMES = 512

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.bucket_s = telemetry_bucket_s()
        self.slots = max(2, int(telemetry_retain_s() / self.bucket_s) + 2)
        self.enabled = telemetry_enabled()
        self._lock = threading.Lock()
        self._counters: dict[str, RollingCounter] = {}
        self._hists: dict[str, RollingHistogram] = {}
        self._duties: dict[str, DutyMeter] = {}
        self.slo = SLOEngine(clock=clock)
        self._slo_enabled = self.slo.enabled
        self.events = EventLog()
        self.incidents = IncidentRecorder()
        if self.slo.enabled:
            # Burn-rate gauges next to the component gauges: evaluating
            # at scrape time keeps breach counters live without a poller.
            def _slo_gauges() -> dict:
                out: dict[str, float] = {}
                for task, rec in self.slo.status().items():
                    out[f"burn5m:{task}"] = rec.get("burn_5m", 0.0)
                    out[f"burn1h:{task}"] = rec.get("burn_1h", 0.0)
                    out[f"breach:{task}"] = 1 if rec.get("state") == "breach" else 0
                return out

            self._slo_gauge_fn = _slo_gauges
            metrics.register_gauges("slo", _slo_gauges)

    # -- named-structure access (capped) ----------------------------------

    def _get(self, table: dict, name: str, factory: Callable[[], Any]):
        obj = table.get(name)
        if obj is None:
            with self._lock:
                obj = table.get(name)
                if obj is None:
                    if len(table) >= self.MAX_NAMES:
                        name = "_other"
                        obj = table.get(name)
                        if obj is not None:
                            return obj
                    obj = table[name] = factory()
        return obj

    # -- the feed ----------------------------------------------------------

    def observe(self, name: str, ms: float) -> None:
        hist = self._hists.get(name)
        if hist is None:
            hist = self._get(
                self._hists, name,
                lambda: RollingHistogram(self.bucket_s, self.slots),
            )
        hist.observe(ms, self.clock())
        # _slo_enabled is latched at hub build (objectives are env
        # config, not runtime state): the unconfigured default skips the
        # engine entirely on the per-request path.
        if self._slo_enabled:
            self.slo.feed(name, ms)

    def count(self, name: str, n: float = 1) -> None:
        ctr = self._counters.get(name)
        if ctr is None:
            ctr = self._get(
                self._counters, name,
                lambda: RollingCounter(self.bucket_s, self.slots),
            )
        ctr.add(n, self.clock())

    def count_error(self, task: str) -> None:
        self.count(f"errors:{task}")
        if self._slo_enabled:
            self.slo.feed_error(task)

    def set_capacity(self, name: str, capacity: float, union: bool = False) -> None:
        """(Re)declare a duty-metered resource's capacity — the batcher
        declares ``device:{name}`` (capacity 1, union mode) at start, the
        decode pool declares ``decode:{name}`` with its worker count."""
        with self._lock:
            meter = self._duties.get(name)
            if meter is None:
                if len(self._duties) >= self.MAX_NAMES:
                    return
                self._duties[name] = DutyMeter(
                    self.bucket_s, self.slots, capacity=capacity, union=union
                )
            else:
                meter.capacity = max(1e-9, capacity)
                meter.union = union

    def busy(self, name: str, t0: float, t1: float) -> None:
        meter = self._duties.get(name)
        if meter is None:
            meter = self._get(
                self._duties, name,
                lambda: DutyMeter(self.bucket_s, self.slots),
            )
        meter.add(t0, t1)

    # -- point sensors (the autopilot's read surface) ----------------------

    def duty_fraction(self, name: str, window_s: float) -> float | None:
        """One duty meter's busy fraction over the last ``window_s``
        seconds, or ``None`` when the meter does not exist yet — the
        controller treats "no sensor" as "no actuation", never as 0."""
        meter = self._duties.get(name)
        if meter is None:
            return None
        return meter.window(window_s, self.clock())["fraction"]

    def window_total(self, name: str, window_s: float) -> float:
        """One rolling counter's total over the last ``window_s`` seconds
        (0.0 when the counter does not exist)."""
        ctr = self._counters.get(name)
        return 0.0 if ctr is None else ctr.total(window_s, self.clock())

    def forecast_rate(
        self, name: str, window_s: float, horizon_s: float
    ) -> float | None:
        """Short-horizon arrival-rate forecast for one rolling counter:
        a least-squares line through the per-bucket rates of the last
        ``window_s`` seconds, extrapolated ``horizon_s`` past the newest
        complete bucket and floored at 0. ``None`` when the counter does
        not exist (no sensor = no forecast — the autopilot falls back to
        its reactive thresholds) or the window holds fewer than two
        complete buckets."""
        ctr = self._counters.get(name)
        if ctr is None:
            return None
        series = ctr.series(window_s, self.clock())
        if len(series) < 2:
            return None
        b = ctr.bucket_s
        xs = [i * b for i in range(len(series))]
        ys = [v / b for v in series]
        n = len(xs)
        mean_x = sum(xs) / n
        mean_y = sum(ys) / n
        var = sum((x - mean_x) ** 2 for x in xs)
        if var <= 0:
            return None
        slope = sum(
            (x - mean_x) * (y - mean_y) for x, y in zip(xs, ys)
        ) / var
        return max(0.0, mean_y + slope * (xs[-1] + horizon_s - mean_x))

    def device_duty(self, window_s: float) -> float | None:
        """Worst ``device:*`` duty fraction over the window — the
        host-level headroom signal the federation capacity gossip
        advertises. ``None`` when no device meter exists yet."""
        with self._lock:
            meters = [
                m for n, m in self._duties.items() if n.startswith("device:")
            ]
        if not meters:
            return None
        now = self.clock()
        return max(m.window(window_s, now)["fraction"] for m in meters)

    # -- export ------------------------------------------------------------

    def window_stats(self, window_s: float) -> dict:
        now = self.clock()
        with self._lock:
            hists = dict(self._hists)
            counters = dict(self._counters)
            duties = dict(self._duties)
        tasks = {}
        for name, h in sorted(hists.items()):
            snap = h.window(window_s, now)
            if snap["count"]:
                snap["rps"] = round(snap["count"] / window_s, 3)
                tasks[name] = snap
        counts = {}
        for name, c in sorted(counters.items()):
            total = c.total(window_s, now)
            if total:
                counts[name] = round(total, 3)
        duty = {
            name: d.window(window_s, now)
            for name, d in sorted(duties.items())
        }
        return {
            "window_s": window_s,
            "bucket_s": self.bucket_s,
            "enabled": self.enabled,
            "tasks": tasks,
            "counters": counts,
            "duty": duty,
        }


_hub: TelemetryHub | None = None
_hub_lock = threading.Lock()


def get_hub() -> TelemetryHub:
    """The process-wide hub (lazily built from the env)."""
    global _hub
    if _hub is None:
        with _hub_lock:
            if _hub is None:
                _hub = TelemetryHub()
    return _hub


def install_hub(hub: TelemetryHub | None) -> None:
    """Swap the process hub (tests: inject a fake-clock instance; None
    drops it so the next :func:`get_hub` rebuilds from the env)."""
    global _hub
    with _hub_lock:
        old, _hub = _hub, hub
    if old is not None and getattr(old, "_slo_gauge_fn", None) is not None:
        metrics.unregister_gauges("slo", old._slo_gauge_fn)


def reset_hub() -> None:
    """Drop the shared hub (tests); also re-reads the enabled flag."""
    global _enabled_flag
    _enabled_flag = None
    install_hub(None)


# -- module-level feed (the whole hot-path API) -------------------------------


def enabled() -> bool:
    return telemetry_enabled()


def observe(name: str, ms: float) -> None:
    """Windowed latency observation — THE per-request call (teed from
    ``metrics.observe``). No-op when ``LUMEN_TELEMETRY=0``. Reads the
    latched module globals directly: this is the one call on the
    serving hot path, and every indirection here is paid per request."""
    flag = _enabled_flag
    if flag is None:
        flag = telemetry_enabled()
    if not flag:
        return
    hub = _hub
    if hub is None:
        hub = get_hub()
    # Known-name fast path: skip one call frame (hub.observe) — the
    # slow path below only runs once per new name.
    hist = hub._hists.get(name)
    if hist is None:
        hub.observe(name, ms)
        return
    hist.observe(ms, hub.clock())
    if hub._slo_enabled:
        hub.slo.feed(name, ms)


def count(name: str, n: float = 1) -> None:
    """Windowed event counter (teed from ``metrics.count`` plus direct
    per-batch feeds like ``batch_items:{batcher}``)."""
    if not telemetry_enabled():
        return
    get_hub().count(name, n)


def count_error(task: str) -> None:
    if not telemetry_enabled():
        return
    get_hub().count_error(task)


def busy(name: str, t0: float, t1: float) -> None:
    """Credit a busy interval (``time.monotonic`` bounds) to a duty
    meter — per-batch/per-task, never per-request."""
    if not telemetry_enabled():
        return
    get_hub().busy(name, t0, t1)


def set_capacity(name: str, capacity: float, union: bool = False) -> None:
    if not telemetry_enabled():
        return
    get_hub().set_capacity(name, capacity, union=union)


def duty_fraction(name: str, window_s: float) -> float | None:
    """Windowed busy fraction of one duty meter (``None`` = no meter yet,
    or telemetry disabled — the autopilot's no-sensor/no-actuation rule
    covers both)."""
    if not telemetry_enabled():
        return None
    hub = _hub
    if hub is None:
        return None  # nothing has fed yet; don't build a hub to say so
    return hub.duty_fraction(name, window_s)


def window_total(name: str, window_s: float) -> float:
    """Windowed total of one rolling counter (0.0 when absent/disabled)."""
    if not telemetry_enabled():
        return 0.0
    hub = _hub
    if hub is None:
        return 0.0
    return hub.window_total(name, window_s)


def forecast_rate(name: str, window_s: float, horizon_s: float) -> float | None:
    """Trend-extrapolated arrival rate for one rolling counter
    (``None`` = counter absent, too little history, or telemetry
    disabled — the no-sensor/no-forecast rule)."""
    if not telemetry_enabled():
        return None
    hub = _hub
    if hub is None:
        return None
    return hub.forecast_rate(name, window_s, horizon_s)


def device_duty(window_s: float) -> float | None:
    """Worst device duty fraction across the host's ``device:*`` meters
    (``None`` = no meter yet or telemetry disabled)."""
    if not telemetry_enabled():
        return None
    hub = _hub
    if hub is None:
        return None
    return hub.device_duty(window_s)


def record_event(
    kind: str, component: str, message: str,
    min_interval_s: float = 0.0, **fields: Any,
) -> dict | None:
    """Append a flight-recorder event; trigger kinds
    (:data:`INCIDENT_KINDS`) also capture an incident bundle (debounced
    by ``LUMEN_INCIDENT_COOLDOWN_S``)."""
    hub = get_hub()
    event = hub.events.record(
        kind, component, message, min_interval_s=min_interval_s, **fields
    )
    if event is not None and kind in INCIDENT_KINDS:
        try:
            hub.incidents.capture(
                event, hub.events.export(), slo_status()
            )
        except Exception:  # noqa: BLE001 - capture must never break the trigger path
            logger.exception("incident capture failed for %s", kind)
    return event


def slo_status() -> dict:
    """The SLO engine's evaluated state (``{}`` when no objective is
    configured) — the body of the ``lumen-slo-status`` Health key."""
    hub = _hub
    if hub is None:
        # Don't build a hub just to say "nothing configured".
        if not slo_objectives() and slo_availability() is None:
            return {}
        hub = get_hub()
    return hub.slo.status()


def export_events(n: int | None = None) -> dict:
    hub = get_hub()
    return {
        "capacity": hub.events.capacity,
        "events": hub.events.export(n),
    }


def export_incidents() -> dict:
    hub = get_hub()
    return {
        "capacity": hub.incidents.capacity,
        "cooldown_s": hub.incidents.cooldown_s,
        "incidents": hub.incidents.export(),
    }


# -- the /stats payload -------------------------------------------------------


def _device_memory_view() -> dict:
    """Per-device HBM occupancy + derived headroom from the shared
    ``metrics.device_memory()`` probe (empty on backends without
    stats)."""
    out: dict[str, dict] = {}
    for dev, stats in MetricsRegistry.device_memory().items():
        view = dict(stats)
        in_use = stats.get("bytes_in_use")
        limit = stats.get("bytes_limit")
        if in_use is not None and limit:
            view["headroom_bytes"] = limit - in_use
            view["occupancy_pct"] = round(100.0 * in_use / limit, 2)
        out[dev] = view
    return out


def capacity_stats(window_s: float = 60.0) -> dict:
    """The ``GET /stats?window=N`` body: windowed task latencies and
    event rates, duty cycles, per-batcher batch/padding/transfer
    accounting, kernel build activity, HBM occupancy/headroom and the SLO
    summary — one probe answering "where is capacity going right now"."""
    window_s = max(1.0, min(float(window_s), 24 * 3600.0))
    hub = get_hub()
    out = hub.window_stats(window_s)
    counters = out["counters"]

    # Per-batcher batch accounting from the windowed counter families.
    batch: dict[str, dict] = {}
    for name, val in counters.items():
        if name.startswith("batch_items:"):
            batch.setdefault(name.split(":", 1)[1], {})["items"] = int(val)
        elif name.startswith("batch_padded:"):
            batch.setdefault(name.split(":", 1)[1], {})["padded"] = int(val)
        elif name.startswith("batch_bucket:"):
            _, batcher, size = name.split(":", 2)
            b = batch.setdefault(batcher, {})
            b.setdefault("buckets", {})[size] = int(val)
    for b in batch.values():
        items = b.get("items", 0)
        padded = b.get("padded", 0)
        slots = items + padded
        b["padding_waste_pct"] = round(100.0 * padded / slots, 2) if slots else 0.0
        if "buckets" in b:
            b["distinct_buckets"] = len(b["buckets"])
    out["batch"] = batch

    transfer: dict[str, dict] = {}
    for name, val in counters.items():
        for direction in ("h2d", "d2h"):
            prefix = f"transfer_{direction}:"
            if name.startswith(prefix):
                t = transfer.setdefault(name[len(prefix):], {})
                t[f"{direction}_bytes"] = int(val)
    out["transfer"] = transfer

    # The port's compile step: nvcc / g++ builds of the kernel libraries
    # that actually ran (runtime/compile_cache.note_build).
    compile_hist = out["tasks"].pop("kernel_build_ms", None)
    out["compile"] = {
        "compiles": int(counters.get("kernel_builds", 0)),
        "ms": compile_hist or None,
    }
    out["device_memory"] = _device_memory_view()
    out["slo"] = slo_status()
    return out


def slo_report() -> dict:
    """The ``GET /slo`` body: objectives + evaluated burn state."""
    hub = get_hub()
    return {
        "objectives": {
            "p95_ms": hub.slo.objectives,
            "availability": hub.slo.availability,
        },
        "windows_s": list(SLO_WINDOWS_S),
        "tasks": hub.slo.status(),
    }
