"""Micro-batching queue: the port's twin of ``lumen_tpu/runtime/batcher.py``.

The reference serves exactly one payload per ONNX session call
(`SURVEY.md` §2.8 "Batching"); on a GPU that strands the tensor cores.
This batcher sits between gRPC worker threads and a batched model
function on a torch device:

- callers ``submit()`` single items and block on a future,
- a collector thread drains the queue until ``max_batch`` items or the
  collection window closes. The window is ADAPTIVE by default
  (``LUMEN_BATCH_ADAPTIVE``): an EWMA of the submit arrival rate predicts
  how long the rest of the batch takes to arrive — the wait stretches
  (bounded by ``LUMEN_BATCH_WINDOW_MS``, default the fixed
  ``max_latency_ms``) when traffic can fill ``max_batch`` and collapses to
  ~0 for a lone request. Batch fill is exported as the
  ``batch-occupancy:<name>`` gauge provider (mean fill % against
  ``max_batch`` + per-bucket batch counts),
- items are stacked into reusable per-bucket staging arenas (no per-batch
  allocation on the hot path; pinned host memory when the batcher feeds a
  CUDA device, so the host->device copy is asynchronous), padded to a
  static *bucket* size (the same shapes every time, as the JAX package's
  one program per bucket), and DISPATCHED as one device call — CUDA
  launches are asynchronous, so the collector records an event after the
  batch's work, hands the un-fetched result to a bounded in-flight deque
  and immediately goes back to collecting,
- a fetch/settle worker drains the deque in dispatch order: ONE
  device->host copy per batch into pinned memory, on a side stream that
  waits on that event (:func:`device_get`), then the rows are scattered
  back to the callers. A plain ``.cpu()`` here would run on the default
  stream, behind the NEXT batch's compute, and undo the overlap.

Over a ``data`` axis above 1 (:func:`mesh_sharded`) a batch's rows split
into one part a data place: each part is copied to and run on its place's
device, comes back as :class:`Parts`, and the fetch copies each part on
that place's side stream, after that place's event, before joining the
rows in batch order.

The two lanes overlap: batch *k+1* is being collected, stacked, and
dispatched while batch *k* computes on device and its transfer completes.
``LUMEN_BATCH_INFLIGHT`` (default 2) bounds how many dispatched-but-
unfetched batches may pile up — enough to hide the transfer latency,
small enough that a slow consumer exerts backpressure on collection
instead of queueing unbounded device results in device memory.

Shape buckets default to powers of two up to ``max_batch``; a warmup call
per bucket at startup pays every bucket's first-call cost (allocator
growth, library heuristics) before traffic arrives.

Fault containment (three mechanisms, all per-batcher):

- **batch bisection** — a failing batch of N no longer fails all N
  callers: the two halves are re-dispatched (synchronously, bounded by
  ``LUMEN_BISECT_DEPTH`` levels) until the offending item(s) are
  isolated. Innocent co-batched requests get their real results; only the
  poison items fail (:class:`~lumen_tpu_torch.utils.deadline.PoisonInput`), and
  their fingerprints land in the quarantine registry so repeats are
  rejected before admission. When NO item in the failing batch succeeds,
  the failure is the device's, not an input's — everyone gets the original
  error and nothing is quarantined.
- **quarantine rejection** — ``submit(fingerprint=...)`` consults
  :mod:`~lumen_tpu_torch.runtime.quarantine` before the admission queue: a
  known-poison payload costs a dict lookup, never a batch slot.
- **watchdog** — with ``LUMEN_BATCH_WATCHDOG_S`` set (>0; 0 = off, the
  CPU/test default), a monitor thread fails any single device dispatch or
  fetch that exceeds the budget: pending futures get
  :class:`~lumen_tpu_torch.utils.deadline.WatchdogTimeout`, queued and in-flight
  work is drained loudly, and the batcher refuses new submits instead of
  wedging — mirroring the dead-fetch-worker containment.

Multi-tenant QoS: the admission queue is tenant-aware by default
(``LUMEN_QOS``, :mod:`~lumen_tpu_torch.runtime.qos`) — per-(tenant, lane)
sub-queues popped by virtual-time weighted-fair queuing, interactive
outranking bulk, with the bulk lane browning out first under sustained
pressure. ``QueueFull`` sheds carry the queue depth and a drain-time
estimate from the measured service rate, so clients (and the serving
layer's ``lumen-retry-after-ms`` hint) back off proportionally.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError as futures_InvalidState, TimeoutError as FuturesTimeout
from contextlib import contextmanager
from typing import Any, Callable

import numpy as np
import torch

from ..utils.deadline import (
    DeadlineExpired,
    PoisonInput,
    QueueFull,
    WatchdogTimeout,
    get_deadline,
    remaining,
)
from ..utils.env import env_float, env_int
from ..utils.metrics import metrics
from . import telemetry
from .qos import WFQAdmissionQueue, wfq_enabled
from .quarantine import QuarantineRegistry, get_quarantine
from .trace import current_trace

logger = logging.getLogger(__name__)


def _end_trace_spans(fut: Future) -> None:
    """Done-callback backstop for the request-trace span handles riding a
    caller future: whatever settles the future (fetch worker, bisection,
    watchdog, close-time drain, a caller's cancel) also closes its open
    spans — ``SpanHandle.end`` is idempotent, so the explicit ends on the
    happy path stay authoritative and this only catches the error lanes."""
    if getattr(fut, "_lumen_settled", None) is None:
        fut._lumen_settled = time.perf_counter()  # cancel path: no _settle ran
    if fut.cancelled():
        err: str | None = "cancelled"
    else:
        e = fut.exception()
        err = type(e).__name__ if e is not None else None
    for attr in ("_lumen_collect", "_lumen_device"):
        h = getattr(fut, attr, None)
        if h is not None:
            h.end(error=err)


def default_buckets(max_batch: int) -> list[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def mesh_buckets(max_batch: int, dp: int) -> list[int]:
    """Batch-size buckets for a data-parallel mesh: every bucket must be a
    multiple of the ``data`` axis size so the leading dim shards evenly."""
    if dp <= 1:
        return default_buckets(max_batch)
    max_batch = max(max_batch, dp)
    if max_batch % dp:
        max_batch = ((max_batch // dp) + 1) * dp
    return [dp * b for b in default_buckets(max_batch // dp)]


class Parts:
    """A batch's un-fetched results over a ``data`` axis: one tree a data
    place, in place order (place ``i`` holds the rows after place
    ``i - 1``'s). :func:`record_ready` records one event a place,
    :func:`device_get` fetches each part on its place's side stream and
    joins the rows in batch order, :func:`synchronize` waits for every
    place."""

    __slots__ = ("trees",)

    def __init__(self, trees: list):
        self.trees = list(trees)


def on_device(device: torch.device):
    """``device`` as the current CUDA device while inside (nothing on the
    CPU): a launch that reads the current device or stream finds the
    place's own."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def mesh_sharded(fn, mesh):
    """Wrap a ``fn(batched_tree, n)`` for the mesh's ``data`` places (JAX
    ``mesh_sharded``, one micro-batch spread over the data axis): ``fn``
    is one callable a place, in place order, or one callable for every
    place (one that follows its input's device). The stacked tree is split
    into equal contiguous parts (:func:`~.mesh.data_sharding`; a batch
    that does not split evenly raises ``ValueError``), part ``i`` is copied
    to place ``i``'s device with ``non_blocking`` from the pinned staging
    buffer, and place ``i``'s callable is launched on it with the count of
    real rows the part holds. On a serving group's mesh each place's
    callable runs a program of the group at that place, whose rows land
    on rank 0's device of the place. Returns the un-fetched result of a
    one-place mesh, else :class:`Parts` -- exactly what the pipelined
    collector wants."""
    from .mesh import data_sharding

    sharding = data_sharding(mesh)
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * len(sharding.devices)
    if len(fns) != len(sharding.devices):
        raise ValueError(f"{len(fns)} callables for the {len(sharding.devices)} data places of {mesh}")
    if len(fns) == 1:
        device, place_fn = sharding.devices[0], fns[0]

        def wrapped(tree, n):
            return place_fn(tree_map(lambda x: to_device(x, device), tree), n)

        return wrapped

    def wrapped_parts(tree, n):
        parts = sharding.split(tree)
        per = len(tree_flatten(parts[0])[0][0])
        out = []
        for i, (device, part) in enumerate(zip(sharding.devices, parts)):
            with on_device(device):
                out.append(fns[i](tree_map(lambda x: to_device(x, device), part), max(0, min(per, n - i * per))))
        return Parts(out)

    return wrapped_parts


def to_device(x: Any, device: torch.device) -> torch.Tensor:
    """One staged leaf onto ``device``: asynchronously from pinned memory
    (the batcher's staging buffers are pinned when it feeds a card; any
    other host array is pinned first)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if device.type != "cuda":
        return t.to(device)
    if not t.is_cuda and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def warmup_batcher(batcher: "MicroBatcher", make_dummy: Callable[[int], Any]) -> None:
    """Run every bucket once through the batcher's OWN callable — the same
    code path real traffic takes (a hand-rolled warmup twin could silently
    drift from the serving fn). Batcher fns launch asynchronously (the
    fetch worker owns the transfer), so synchronize here, every data
    place's device: warmup must not return with work queued."""
    for b in batcher.buckets:
        synchronize(batcher.fn(make_dummy(b), b))


def batch_adaptive() -> bool:
    """``LUMEN_BATCH_ADAPTIVE`` (default on): the collector's wait window
    tracks the measured arrival rate instead of sitting at the fixed
    ``max_latency_ms`` — stretched (bounded by ``LUMEN_BATCH_WINDOW_MS``)
    when traffic can fill ``max_batch``, collapsed to ~0 when idle.
    ``0`` restores the fixed window everywhere."""
    return os.environ.get("LUMEN_BATCH_ADAPTIVE", "1") != "0"


def batch_window_ms() -> float | None:
    """``LUMEN_BATCH_WINDOW_MS``: upper bound on the adaptive collection
    window. Unset/malformed = each batcher's own ``max_latency_ms`` (the
    adaptive controller then never waits LONGER than the fixed window did,
    only shorter); explicit values let an operator stretch the window past
    the fixed default when occupancy matters more than tail latency."""
    return env_float("LUMEN_BATCH_WINDOW_MS", None, minimum=0.0)


class AdaptiveWindow:
    """EWMA arrival-rate controller for the collector's batch window.

    ``observe()`` is called at every ``submit()`` (cheap: one EWMA update
    under the submit lock the caller already holds is avoided — this has
    its own tiny lock so hot submitters don't serialize on the collector).
    ``window_s(have)`` answers: with ``have`` items already collected, how
    long is it worth waiting for the rest of the batch?

    - **No history yet** → the fixed window (cold start must not dispatch
      singletons before the rate is known).
    - **Idle** (inter-arrival EWMA beyond ``IDLE_FACTOR`` caps) → ~0: a
      lone request pays dispatch latency, not a window it cannot fill.
      The factor matters: closed-loop callers (a worker pool that submits
      the next item when the previous settles) measure an arrival
      interval ≈ the service interval, slightly ABOVE a tight cap — that
      is a convoy to coalesce, not idleness.
    - **Traffic** → the predicted time for the REST of the batch to
      arrive, clamped to the cap: a saturating producer fills ``max_batch``
      and the window never stretches past ``cap_s``.

    ``clock`` is injectable for deterministic tests."""

    #: "idle" = the next arrival is expected beyond this many cap-widths
    #: away; between 1 and this, waiting one cap still buys co-batching.
    IDLE_FACTOR = 8.0
    #: multiplier on the predicted fill time: the EWMA is a point estimate
    #: and closed-loop arrival jitter is on the order of the interval
    #: itself — without headroom the window closes exactly when the last
    #: item was DUE, losing it to the next batch half the time. Bounded by
    #: the cap either way, so tail latency is unchanged.
    HEADROOM = 2.0

    __slots__ = ("max_batch", "cap_s", "fixed_s", "alpha", "clock", "_interval", "_last", "_lock")

    def __init__(
        self,
        max_batch: int,
        cap_s: float,
        fixed_s: float,
        alpha: float = 0.2,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_batch = max_batch
        self.cap_s = cap_s
        self.fixed_s = fixed_s
        self.alpha = alpha
        self.clock = clock
        self._interval: float | None = None  # EWMA inter-arrival seconds
        self._last: float | None = None
        self._lock = threading.Lock()

    def observe(self) -> None:
        now = self.clock()
        with self._lock:
            if self._last is not None:
                # Clamp a long idle gap to 2x the idle threshold before
                # folding it in: the gap still reads as idle (above the
                # window_s threshold), but resumed traffic needs ~3
                # observations to decay back under it instead of ~20 —
                # one 10s pause must not make the next burst dispatch as
                # singletons while a poisoned EWMA recovers.
                dt = min(now - self._last, self.cap_s * self.IDLE_FACTOR * 2)
                self._interval = (
                    dt
                    if self._interval is None
                    else (1.0 - self.alpha) * self._interval + self.alpha * dt
                )
            self._last = now

    def window_s(self, have: int) -> float:
        with self._lock:
            interval = self._interval
        if interval is None:
            return min(self.fixed_s, self.cap_s) if self.cap_s > 0 else self.fixed_s
        if self.cap_s <= 0:
            return 0.0
        if interval > self.cap_s * self.IDLE_FACTOR:
            return 0.0  # idle: the next arrival is nowhere near
        need = max(0, self.max_batch - have)
        return min(self.cap_s, need * interval * self.HEADROOM)


class _Occupancy:
    """Batch-fill telemetry: mean fill % against ``max_batch`` plus a
    per-bucket batch count, exported as the ``batch-occupancy:<name>``
    gauge provider. A fixed-window batcher under bursty traffic shows its
    padding waste here; the adaptive window's whole point is making this
    gauge read high under load."""

    __slots__ = ("max_batch", "batches", "items", "by_bucket", "_lock")

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.batches = 0
        self.items = 0
        self.by_bucket: dict[int, int] = {}
        self._lock = threading.Lock()

    def record(self, n: int, size: int) -> None:
        with self._lock:
            self.batches += 1
            self.items += n
            self.by_bucket[size] = self.by_bucket.get(size, 0) + 1

    def gauges(self) -> dict:
        with self._lock:
            if not self.batches:
                return {"batches": 0, "items": 0, "mean_fill_pct": 0.0}
            out = {
                "batches": self.batches,
                "items": self.items,
                "mean_fill_pct": round(
                    100.0 * self.items / (self.batches * self.max_batch), 1
                ),
                "mean_items": round(self.items / self.batches, 2),
            }
            for size, count in sorted(self.by_bucket.items()):
                out[f"bucket_{size}"] = count
            return out


class _DrainRate:
    """EWMA of settled items/second — the service-rate signal behind the
    ``QueueFull`` drain-time estimate. A shed used to say only "queue
    full"; with this, the error (and the ``lumen-retry-after-ms`` hint the
    serving layer derives from it) says *when the backlog will clear*, so
    clients back off proportionally instead of guessing."""

    __slots__ = ("alpha", "_rate", "_last", "_lock")

    #: inter-settle gaps above this are idle time, not service time — an
    #: unclamped 5-minute lull before a burst would read as a ~0 rate and
    #: tell the burst's shed clients to come back in minutes for a queue
    #: that drains in under a second (same idiom as AdaptiveWindow's
    #: idle-gap clamp). Clamping only ever UNDER-estimates drain time,
    #: and an early retry is a cheap O(1) shed.
    MAX_GAP_S = 5.0
    #: hint ceiling: past this the estimate is stale-rate noise, and a
    #: retry-after floor of minutes hurts more than an extra shed.
    MAX_ESTIMATE_S = 30.0

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._rate: float | None = None  # items/second
        self._last: float | None = None
        self._lock = threading.Lock()

    def record(self, n: int) -> None:
        now = time.monotonic()
        with self._lock:
            if self._last is not None:
                dt = min(now - self._last, self.MAX_GAP_S)
                if dt > 1e-6:
                    inst = n / dt
                    self._rate = (
                        inst
                        if self._rate is None
                        else (1.0 - self.alpha) * self._rate + self.alpha * inst
                    )
            self._last = now

    def estimate_s(self, queued: int) -> float | None:
        """Seconds to drain ``queued`` items at the measured service rate
        (capped at :data:`MAX_ESTIMATE_S`); ``None`` before any rate is
        known (cold batcher)."""
        with self._lock:
            rate = self._rate
        if rate is None or rate <= 0:
            return None
        return min(queued / rate, self.MAX_ESTIMATE_S)


def batch_wait_timeout() -> float:
    """Default seconds a caller waits on a batched-call future — must
    tolerate a cold first call of a bucket (see
    :meth:`MicroBatcher.__call__`). ``LUMEN_BATCH_TIMEOUT_S`` overrides."""
    return env_float("LUMEN_BATCH_TIMEOUT_S", 300.0)


def batch_queue_depth() -> int:
    """Default queue-depth limit for admission control:
    ``LUMEN_BATCH_QUEUE_DEPTH`` (0 / unset = unbounded, the
    pre-resilience behavior; a malformed value degrades to unbounded WITH
    a one-shot warning — a typo'd depth limit must not silently remove
    admission control)."""
    return env_int("LUMEN_BATCH_QUEUE_DEPTH", 0, minimum=0)


def batch_inflight() -> int:
    """Default bound on dispatched-but-unfetched batches:
    ``LUMEN_BATCH_INFLIGHT`` (default 2 — one computing, one settling;
    1 = no dispatch pipelining, malformed = default)."""
    return env_int("LUMEN_BATCH_INFLIGHT", 2, minimum=1)


def bisect_depth_default(max_batch: int) -> int:
    """Default batch-bisection depth: ``LUMEN_BISECT_DEPTH`` when set
    (0 disables bisection — a failing batch fans out to every caller, the
    pre-containment behavior); otherwise ``ceil(log2(max_batch))``, enough
    to isolate a single poison item out of a full batch."""
    raw = env_int("LUMEN_BISECT_DEPTH", None, minimum=0)
    if raw is not None:
        return raw
    return max(1, math.ceil(math.log2(max(2, max_batch))))


def batch_watchdog_s() -> float:
    """``LUMEN_BATCH_WATCHDOG_S``: seconds one device dispatch or fetch
    may run before the watchdog fails the batch and disables the batcher
    (0 / unset / malformed = off — the CPU/test default; on the card, size
    it above the worst warmed-bucket batch latency, and warm up first: a
    bucket's first call is slower than its steady state)."""
    return env_float("LUMEN_BATCH_WATCHDOG_S", 0.0, minimum=0.0)


def _settle(fut: Future, result: Any = None, exception: BaseException | None = None) -> bool:
    """Resolve a caller future, tolerating the cancel race: a
    deadline-bounded caller may cancel() between the collector's state
    check and its set — set_result/set_exception on a cancelled Future
    raises InvalidStateError, which must not kill the collector thread.
    Returns True when the future was actually settled."""
    # Settle instant for the traced caller's ``batch.wake`` span — stamped
    # BEFORE set_result because the waiter wakes before done-callbacks run.
    if getattr(fut, "_lumen_trace", None) is not None:
        fut._lumen_settled = time.perf_counter()
    if fut.cancelled():
        return False
    try:
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
        return True
    except futures_InvalidState:
        return False


def bucket_for(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def wait_for_batch(fut: Future, name: str, stats: dict, timeout: float | None = None) -> Any:
    """Wait on a batcher future — the blocking half of
    ``MicroBatcher.__call__``, shared with the replica fleet's routed
    dispatch (``ReplicaSet.__call__`` submits through whichever replica
    the policy picked and waits here with that replica's name/stats).

    The default wait must tolerate a cold first call of a new bucket —
    the client's own RPC deadline, not this timeout, bounds user-visible
    latency. ``LUMEN_BATCH_TIMEOUT_S``
    overrides; unset → 300s. An ambient request deadline, when sooner,
    bounds the wait instead (no point blocking a gRPC thread past its
    caller's hangup)."""
    if timeout is None:
        timeout = batch_wait_timeout()
    rem = remaining()
    deadline_bounded = rem is not None and rem < timeout
    if deadline_bounded:
        timeout = max(rem, 0.0)
    try:
        result = fut.result(timeout=timeout)
        # Close the span handles HERE, not only in the done-callback:
        # set_result wakes this waiter BEFORE callbacks run, so the
        # request could otherwise finish its trace while the fetch
        # worker is still descheduled — dropping the device span from
        # exactly the slow trace being captured. end() is idempotent;
        # whichever side runs first wins.
        if getattr(fut, "_lumen_trace", None) is not None:
            _end_trace_spans(fut)
            # Attribution completeness: on a loaded host the gap
            # between the fetch worker settling the future and THIS
            # thread being rescheduled is real milliseconds — charge
            # it to ``batch.wake`` instead of leaving it dark.
            settled = getattr(fut, "_lumen_settled", None)
            if settled is not None:
                fut._lumen_trace.add_span("batch.wake", settled, time.perf_counter())
        return result
    except FuturesTimeout:
        if not deadline_bounded:
            raise
        # The caller's deadline — not the batch-wait budget — expired.
        # Cancel so the collector skips the dead entry (when it hasn't
        # started) and surface the wire-mappable deadline error, not a
        # generic timeout that reads as a handler crash.
        if fut.cancel():
            stats["expired"] += 1
            metrics.count("deadline_drops")
            metrics.count(f"deadline_drops:{name}")
        raise DeadlineExpired(
            f"{name}: request deadline expired while waiting for a batch slot"
        ) from None
    except BaseException:
        # Settled-with-exception path (poison, watchdog, shed at
        # dispatch...): same span-close determinism as the success
        # path — the error verdict must reach the trace before the
        # request finishes it.
        if fut.done() and getattr(fut, "_lumen_trace", None) is not None:
            _end_trace_spans(fut)
        raise


class _Inflight:
    """One dispatched-but-unfetched batch riding the in-flight deque.
    ``entries`` keeps the (item, future, fingerprint) triples so a
    fetch-time failure can still bisect (re-dispatching needs the host
    items, which are tiny next to the device result they produced).
    ``arena`` lists the staging buffers the batch was stacked into (when
    the collector's reusable arenas were used) so the fetch path can
    detect — and copy out of — a result that aliases them. ``ready`` is
    the CUDA event recorded right after the batch's work was launched
    (None for host results): the fetch's side stream waits on it."""

    __slots__ = ("futures", "result", "n", "size", "entries", "arena", "t_dispatch", "ready")

    def __init__(
        self,
        futures: list[Future],
        result: Any,
        n: int,
        size: int,
        entries: list[tuple] | None = None,
        arena: list | None = None,
        t_dispatch: float = 0.0,
        ready: "torch.cuda.Event | list | None" = None,
    ):
        self.futures = futures
        self.result = result  # un-fetched device result tree
        self.n = n
        self.size = size
        self.entries = entries or []
        self.arena = arena
        # Dispatch instant (monotonic): the fetch worker credits the
        # dispatch->settle envelope to the ``device:{name}`` duty meter —
        # the same envelope the ``batch.device`` trace span covers.
        self.t_dispatch = t_dispatch
        self.ready = ready


#: live batchers by name (weakrefs — the registry must not pin a dropped
#: batcher): the autopilot's window loop and any future controller read
#: the process's batcher population from here, the same idiom as
#: ``utils/qos.py``'s WFQ-queue registry.
_batcher_registry: dict[str, "weakref.ref[MicroBatcher]"] = {}
_batcher_reg_lock = threading.Lock()


def live_batchers() -> list["MicroBatcher"]:
    """Every started, not-yet-closed MicroBatcher in the process (dead
    refs are pruned on the way out)."""
    with _batcher_reg_lock:
        items = list(_batcher_registry.items())
    out: list[MicroBatcher] = []
    for name, ref in items:
        b = ref()
        if b is None:
            with _batcher_reg_lock:
                if _batcher_registry.get(name) is ref:
                    del _batcher_registry[name]
        elif not b._closed.is_set():
            out.append(b)
    return out


class MicroBatcher:
    """Batch single-item pytrees through a batched function.

    ``fn(batched_tree, n_valid) -> batched_result_tree`` where every leaf of
    ``batched_tree`` has a leading bucket-size dim; the result's leaves must
    share that leading dim (rows past ``n_valid`` are padding and dropped).

    ``fn`` should DISPATCH and return without fetching (return the device
    tensors as-is — no ``.cpu()``): the fetch/settle worker performs the
    one device->host transfer per batch, so up to ``inflight`` batches
    compute while the collector stacks the next one. A blocking ``fn``
    still works (numpy trees pass through the fetch untouched); it just
    forfeits the overlap.

    ``pin_memory``: stage batches in pinned host memory (set it when the
    batcher feeds a CUDA device through :func:`mesh_sharded`).
    """

    def __init__(
        self,
        fn: Callable[[Any, int], Any],
        max_batch: int = 8,
        max_latency_ms: float = 5.0,
        buckets: list[int] | None = None,
        name: str = "batcher",
        max_queue: int | None = None,
        inflight: int | None = None,
        bisect_depth: int | None = None,
        watchdog_s: float | None = None,
        quarantine: QuarantineRegistry | None = None,
        adaptive: bool | None = None,
        window_ms: float | None = None,
        clock: Callable[[], float] = time.monotonic,
        replica: str | None = None,
        pin_memory: bool = False,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.fn = fn
        self.pin_memory = pin_memory
        # Side streams of the fetch worker's device->host copies, its own
        # (one batcher's fetch never queues behind another's compute), one
        # a data place and device, made on first use.
        self._d2h_streams = SideStreams()
        # Replica tag when this batcher is one slice of a ReplicaSet
        # (runtime/fleet.py): rides the ``batch.device`` trace span so a
        # slow trace names the chip slice that served it.
        self.replica = replica
        self.max_batch = max_batch
        self.max_latency_s = max_latency_ms / 1e3
        self.buckets = sorted(buckets) if buckets else default_buckets(max_batch)
        if self.buckets[-1] < max_batch:
            self.buckets.append(max_batch)
        self.name = name
        # Admission control: bound the number of waiting items so overload
        # becomes explicit shed errors (callers can back off) instead of an
        # unbounded queue whose latency grows without limit. 0 = unbounded.
        self.max_queue = batch_queue_depth() if max_queue is None else max(0, max_queue)
        self.inflight = batch_inflight() if inflight is None else max(1, inflight)
        # Containment: bisection depth (0 = off), watchdog budget (0 = off)
        # and the quarantine registry isolated offenders land in (None =
        # the process-wide one, resolved lazily so tests can reset it).
        self.bisect_depth = (
            bisect_depth_default(max_batch) if bisect_depth is None else max(0, bisect_depth)
        )
        self.watchdog_s = batch_watchdog_s() if watchdog_s is None else max(0.0, watchdog_s)
        self._quarantine = quarantine
        # Adaptive collection window: the EWMA controller replaces the
        # fixed wait when enabled (LUMEN_BATCH_ADAPTIVE, default on); the
        # cap is LUMEN_BATCH_WINDOW_MS or this batcher's own fixed window.
        self.adaptive = batch_adaptive() if adaptive is None else adaptive
        cap_ms = batch_window_ms() if window_ms is None else max(0.0, window_ms)
        self.window_cap_s = (cap_ms / 1e3) if cap_ms is not None else self.max_latency_s
        # The configured cap, remembered: the autopilot's window loop
        # retunes window_cap_s around this anchor and returns to it when
        # padding waste clears (never drifting from an already-drifted
        # value).
        self.base_window_cap_s = self.window_cap_s
        self._clock = clock
        self._window = AdaptiveWindow(
            max_batch, self.window_cap_s, self.max_latency_s, clock=clock
        )
        self._occupancy = _Occupancy(max_batch)
        # Reusable per-bucket staging arenas: (size, treedef, leaf sig) ->
        # ring of buffer lists. Ring length inflight+2 guarantees a slot is
        # only rewritten after its batch's device work has been fetched
        # (the collector blocks once `inflight` batches are un-fetched), so
        # a backend that zero-copy-aliases host numpy stays correct.
        self._arenas: dict[tuple, list[list[Any]]] = {}
        self._arena_seq: dict[tuple, int] = {}
        # Admission queue: tenant-aware weighted-fair by default
        # (LUMEN_QOS, runtime/qos.py) — per-(tenant, lane) sub-queues
        # popped by virtual-time WFQ, with the bulk lane browning out
        # first under pressure. With only default-tenant interactive
        # traffic the schedule IS the old FIFO; LUMEN_QOS=0 restores the
        # plain stdlib queue outright.
        self._queue: Any
        if wfq_enabled():
            self._queue = WFQAdmissionQueue(name=name, max_queue=self.max_queue)
        else:
            self._queue = queue.Queue()
        # Service-rate EWMA feeding the QueueFull drain-time estimate.
        self._drain = _DrainRate()
        self._thread: threading.Thread | None = None
        self._fetch_thread: threading.Thread | None = None
        self._watchdog_thread: threading.Thread | None = None
        self._closed = threading.Event()
        # Guards the closed-check + enqueue pair in submit() against a
        # concurrent close() draining the queue in between.
        self._submit_lock = threading.Lock()
        # Dispatched-but-unfetched batches, FIFO (dispatch order == settle
        # order); the condition variable carries both the bound (collector
        # waits when full) and the fetch hand-off (worker waits when empty).
        self._inflight: deque[_Inflight] = deque()
        self._inflight_cv = threading.Condition()
        self._fetch_stop = False
        # Watchdog state: lane (thread id) -> (start, futures) for every
        # risky device call currently running, and the wedge verdict once
        # the watchdog has fired (submit refuses new work from then on).
        self._watch_lock = threading.Lock()
        self._watching: dict[int, tuple[float, list[Future]]] = {}
        self._wedged: WatchdogTimeout | None = None
        # Telemetry for capability metadata / benchmarks.
        self.stats = {
            "batches": 0,
            "items": 0,
            "padded": 0,
            "shed": 0,
            "expired": 0,
            "bisects": 0,
            "poisoned": 0,
            "quarantine_rejected": 0,
            "watchdog": 0,
        }

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "MicroBatcher":
        self._thread = threading.Thread(target=self._run, name=self.name, daemon=True)
        self._fetch_thread = threading.Thread(
            target=self._fetch_loop, name=f"{self.name}-fetch", daemon=True
        )
        # Fetch worker FIRST: the collector's dead-fetch-worker guard reads
        # a not-yet-started thread as dead, and with pre-queued items and a
        # collapsed adaptive window the collector can reach its first
        # dispatch within microseconds of starting.
        self._fetch_thread.start()
        self._thread.start()
        if self.watchdog_s > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, name=f"{self.name}-watchdog", daemon=True
            )
            self._watchdog_thread.start()
        # Live state on /metrics: queue depth + batch/padding telemetry
        # (latency histograms can't show a backed-up or waste-heavy queue).
        # The provider closes over a weakref so the global registry never
        # pins a dropped batcher (and its captured params) in memory.
        ref = weakref.ref(self)

        def _gauges() -> dict:
            b = ref()
            if b is None:
                return {}
            return {
                **b.stats,
                "queue_depth": b._queue.qsize(),
                "inflight": len(b._inflight),
                "inflight_limit": b.inflight,
            }

        self._gauge_fn = _gauges
        metrics.register_gauges(f"batcher:{self.name}", _gauges)
        # Controller registry (last-writer-wins per name, like the gauge
        # providers): a revive's fresh same-name batcher supersedes the
        # wedge it replaces.
        with _batcher_reg_lock:
            _batcher_registry[self.name] = ref
        # Duty meter for this batcher's device stream: capacity 1 in
        # union mode (dispatch->settle envelopes overlap under
        # pipelining; settle order == dispatch order, so union-clamping
        # yields true busy wall-time and the fraction can never top 1).
        telemetry.set_capacity(f"device:{self.name}", 1.0, union=True)

        def _occupancy_gauges() -> dict:
            b = ref()
            return {} if b is None else b._occupancy.gauges()

        self._occupancy_gauge_fn = _occupancy_gauges
        metrics.register_gauges(f"batch-occupancy:{self.name}", _occupancy_gauges)
        if isinstance(self._queue, WFQAdmissionQueue):
            # Per-tenant admission telemetry (queued/admitted/shed by
            # tenant, lane totals, brownout level) next to the batcher's
            # own gauges. The queue is reached through the batcher weakref
            # like the sibling providers — capturing it directly would let
            # the registry pin a dropped batcher's queue (and its queued
            # entry tuples) forever.

            def _qos_gauges() -> dict:
                b = ref()
                return {} if b is None else b._queue.gauges()

            self._qos_gauge_fn = _qos_gauges
            metrics.register_gauges(f"qos:{self.name}", _qos_gauges)
        return self

    def close(self) -> None:
        with self._submit_lock:
            if self._closed.is_set():
                return
            self._closed.set()
            # The sentinel lands after any already-submitted item, so the
            # collector's drain pass sees them all.
            self._queue.put(None)
        if self._thread:
            # A wedged batcher's collector may be parked inside the stuck
            # device call forever — the watchdog already settled its
            # futures, so close() must not ride out the full join budget.
            self._thread.join(timeout=1.0 if self._wedged is not None else 10)
        # Stop the fetch worker only AFTER the collector exits: every batch
        # it dispatched must still settle (in-flight results drain; the
        # worker's loop runs until the deque is empty AND stop is set).
        with self._inflight_cv:
            self._fetch_stop = True
            self._inflight_cv.notify_all()
        if self._fetch_thread:
            self._fetch_thread.join(timeout=1.0 if self._wedged is not None else 60)
            # A fetch worker killed by an escaping BaseException leaves its
            # in-flight batches unsettled, and after close() nothing else
            # will ever settle them — drain here so close() upholds the
            # "every dispatched batch settles" contract even when the
            # settling lane itself died. Guarded on death: a merely-slow
            # worker (join timed out) keeps ownership of its entries.
            if not self._fetch_thread.is_alive():
                with self._inflight_cv:
                    stranded = list(self._inflight)
                    self._inflight.clear()
                if stranded:
                    err = RuntimeError(
                        f"{self.name}: fetch worker died; batcher closed "
                        "with unsettled in-flight batches"
                    )
                    logger.error("%s", err)
                    for entry in stranded:
                        for f in entry.futures:
                            _settle(f, exception=err)
        # Ownership-guarded: a newer same-name batcher keeps its gauges.
        # A never-started instance has no _gauge_fn — it must not pass
        # None (= unconditional) and evict a live same-name batcher's.
        if fn := getattr(self, "_gauge_fn", None):
            metrics.unregister_gauges(f"batcher:{self.name}", fn)
        if fn := getattr(self, "_occupancy_gauge_fn", None):
            metrics.unregister_gauges(f"batch-occupancy:{self.name}", fn)
        if fn := getattr(self, "_qos_gauge_fn", None):
            metrics.unregister_gauges(f"qos:{self.name}", fn)
        # Same ownership guard for the controller registry: only drop the
        # entry if it still points at THIS instance.
        with _batcher_reg_lock:
            ref = _batcher_registry.get(self.name)
            if ref is not None and ref() is self:
                del _batcher_registry[self.name]

    # -- client side ------------------------------------------------------

    @property
    def quarantine(self) -> QuarantineRegistry:
        """The registry isolated offenders land in (the process-wide one
        unless the constructor pinned an explicit instance)."""
        return self._quarantine if self._quarantine is not None else get_quarantine()

    def submit(
        self, item: Any, deadline: float | None = None, fingerprint: str | None = None
    ) -> Future:
        """Enqueue one item. ``deadline`` is an absolute ``time.monotonic()``
        instant; unset, it is inherited from the ambient request context
        (:func:`lumen_tpu_torch.utils.deadline.get_deadline`, installed by the
        gRPC layer from ``context.time_remaining()``). Expired entries are
        dropped before the device call instead of burning a batch slot.

        ``fingerprint`` is the payload's content address (the result-cache
        key) — it is both the quarantine gate (a known-poison payload is
        rejected HERE, before the admission queue and the device) and the
        identity that gets quarantined if bisection later isolates this
        item as the one that fails its batch.

        Raises :class:`QueueFull` when ``max_queue`` items are already
        waiting (load shed — the caller should surface a retryable
        RESOURCE_EXHAUSTED-style error), :class:`DeadlineExpired` when
        the deadline has already passed at submit time,
        :class:`PoisonInput` when the fingerprint is quarantined, and
        :class:`WatchdogTimeout` when the watchdog has disabled the
        batcher."""
        if deadline is None:
            deadline = get_deadline()
        if deadline is not None and time.monotonic() >= deadline:
            self.stats["expired"] += 1
            metrics.count("deadline_drops")
            metrics.count(f"deadline_drops:{self.name}")
            raise DeadlineExpired(f"{self.name}: request deadline already expired at submit")
        if fingerprint is not None:
            try:
                self.quarantine.check(fingerprint)
            except PoisonInput:
                self.stats["quarantine_rejected"] += 1
                raise
        if self.adaptive:
            self._window.observe()
        fut: Future = Future()
        # Request tracing: the collect span begins HERE (caller thread,
        # where the contextvar is visible) and ends when the collector
        # picks the batch for dispatch — queue wait + collect window, one
        # number. The handle rides the future because contextvars do not
        # cross into the collector/fetch threads.
        tr = current_trace()
        if tr is not None:
            fut._lumen_trace = tr
            fut._lumen_collect = tr.begin("batch.collect", {"batcher": self.name})
            fut.add_done_callback(_end_trace_spans)
        with self._submit_lock:
            # Wedge check INSIDE the lock: _fire_watchdog sets _wedged and
            # drains the queue under the same lock, so an entry can never
            # slip in between the drain and this check and hang unsettled
            # (same race the lock already closes for close()'s drain).
            if self._wedged is not None:
                raise WatchdogTimeout(str(self._wedged))
            if self._closed.is_set():
                raise RuntimeError(f"{self.name} is closed")
            if self.max_queue and self._queue.qsize() >= self.max_queue:
                self.stats["shed"] += 1
                metrics.count("sheds")
                metrics.count(f"sheds:{self.name}")
                # Flight-recorder breadcrumb, rate-limited per batcher: a
                # shed storm is one line a second in the ring, not a
                # flood that churns breaker transitions out of it.
                telemetry.record_event(
                    "shed", self.name,
                    f"admission queue full ({self.max_queue} waiting)",
                    min_interval_s=1.0,
                )
                raise self._queue_full_error(self.max_queue)
            try:
                self._queue.put((item, fut, deadline, fingerprint))
            except QueueFull as e:
                # WFQ brownout: the bulk lane sheds below the full depth
                # so interactive traffic keeps the remaining headroom.
                # Same accounting and drain-context contract as the
                # full-queue shed above.
                self.stats["shed"] += 1
                metrics.count("sheds")
                metrics.count(f"sheds:{self.name}")
                telemetry.record_event(
                    "shed", self.name, str(e), min_interval_s=1.0,
                )
                self._attach_drain_hint(e, self._queue.qsize())
                raise
        return fut

    def _queue_full_error(self, depth: int) -> QueueFull:
        """Build the full-queue shed error WITH backoff context: queue
        depth plus the drain-time estimate from the measured service rate
        (when one exists), so the client — and the serving layer's
        ``lumen-retry-after-ms`` hint — can back off proportionally
        instead of re-knocking on a queue that needs seconds to clear."""
        est = self._drain.estimate_s(depth)
        detail = f"{depth} waiting"
        if est is not None:
            detail += f", est drain {est:.2f}s"
        e = QueueFull(
            f"{self.name}: admission queue full ({detail}); request shed"
        )
        e.queue_depth = depth
        if est is not None:
            e.retry_after_s = est
        return e

    def _attach_drain_hint(self, e: QueueFull, depth: int) -> None:
        e.queue_depth = getattr(e, "queue_depth", depth)
        if getattr(e, "retry_after_s", None) is None:
            est = self._drain.estimate_s(depth)
            if est is not None:
                e.retry_after_s = est

    def __call__(
        self, item: Any, timeout: float | None = None, fingerprint: str | None = None
    ) -> Any:
        """Submit and wait (see :func:`wait_for_batch` for the wait
        semantics — shared with the replica fleet's routed dispatch)."""
        fut = self.submit(item, fingerprint=fingerprint)
        return wait_for_batch(fut, self.name, self.stats, timeout)

    def load(self) -> int:
        """Queued + dispatched-but-unsettled items — the signal the
        fleet's least-loaded dispatch policy ranks replicas by."""
        with self._inflight_cv:
            inflight = sum(e.n for e in self._inflight)
        return self._queue.qsize() + inflight

    def drain_estimate_s(self) -> float | None:
        """Seconds the CURRENT backlog needs to clear at the measured
        service rate (None before any batch settled) — the queue-drain
        sensor the autopilot's scale loop reads, the same estimate the
        ``QueueFull`` retry hint is built from."""
        return self._drain.estimate_s(self.load())

    def set_window_cap_s(self, cap_s: float) -> float:
        """Retarget the adaptive window's cap (the autopilot's batch-window
        actuator). Floored at 0; returns the applied value. Takes effect on
        the collector's next ``window_s`` read — no lock needed, a float
        store is atomic and the controller tick is the only writer."""
        cap = max(0.0, float(cap_s))
        self.window_cap_s = cap
        self._window.cap_s = cap
        return cap

    # -- collector thread -------------------------------------------------

    def _run(self) -> None:
        while not self._closed.is_set() and self._wedged is None:
            first = self._queue.get()
            if first is None:
                break
            batch = [first]
            # Window from the FIRST item's pickup. Fixed mode keeps the
            # historical ``max_latency_ms`` wait; adaptive mode asks the
            # EWMA controller and re-asks after each arrival (more items in
            # hand = less of the batch left to wait for), always bounded by
            # ``window_cap_s`` from the first item.
            t_first = time.monotonic()
            if self.adaptive:
                deadline = t_first + min(self._window.window_s(1), self.window_cap_s)
            else:
                deadline = t_first + self.max_latency_s
            while len(batch) < self.max_batch:
                # Drain-first: items ALREADY queued join the batch
                # regardless of the window — a collapsed (~0) adaptive
                # window must mean "don't wait for traffic that isn't
                # coming", never "strand waiting items for a later batch".
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                if nxt is None:
                    self._closed.set()
                    break
                batch.append(nxt)
                if self.adaptive:
                    deadline = min(
                        t_first + self.window_cap_s,
                        time.monotonic() + self._window.window_s(len(batch)),
                    )
            self._dispatch(batch)
        # Drain anything left after close.
        while True:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                break
            if entry is not None:
                _settle(entry[1], exception=RuntimeError(f"{self.name} closed"))

    def _dispatch(self, batch: list[tuple[Any, Future, float | None, str | None]]) -> None:
        # Reserve an in-flight slot FIRST: this wait is where the collector
        # blocks under backpressure (possibly for a full device-batch
        # latency), so it must come before the deadline gate — an entry
        # whose deadline expires while we wait here still gets dropped
        # below instead of burning the batch it no longer wants. Exactness:
        # at most `inflight` un-fetched device results exist at any instant
        # (the device-memory bound an operator sizes against), and inflight=1 really
        # does serialize dispatch. Only this thread appends, so reserving
        # by waiting for space cannot race another producer.
        dead = False
        with self._inflight_cv:
            while len(self._inflight) >= self.inflight:
                # A dead fetch worker can never drain the deque: fail
                # loudly instead of wedging the collector (and every
                # caller) in a silent 300s-timeout limbo.
                if self._fetch_thread is not None and not self._fetch_thread.is_alive():
                    dead = True
                    break
                if self._wedged is not None:
                    break  # the watchdog drained the deque; abort below
                self._inflight_cv.wait(timeout=1.0)
        if self._wedged is not None:
            for _, fut, _, _ in batch:
                _settle(fut, exception=WatchdogTimeout(str(self._wedged)))
            return
        if dead:
            self._abort_dead_fetch([fut for _, fut, _, _ in batch])
            return
        # Deadline gate: entries whose caller deadline passed while they
        # queued are failed here — BEFORE stacking and the device call — so
        # an overloaded server does not spend device time computing answers
        # nobody is waiting for (their gRPC stream is already torn down).
        # The gate runs per dispatch even with earlier batches still in
        # flight: a deadline that expires while batch k computes still
        # drops the k+1 entry it covers.
        live: list[tuple[Any, Future, str | None]] = []
        now = time.monotonic()
        for item, fut, deadline, fingerprint in batch:
            if fut.cancelled():
                # The waiting caller already gave up (and accounted the
                # drop); counting here too would double-book the event.
                continue
            if deadline is not None and now >= deadline:
                if _settle(
                    fut,
                    exception=DeadlineExpired(
                        f"{self.name}: deadline expired while queued"
                    ),
                ):
                    self.stats["expired"] += 1
                    metrics.count("deadline_drops")
                    metrics.count(f"deadline_drops:{self.name}")
            else:
                live.append((item, fut, fingerprint))
        if not live:
            return
        items = [b[0] for b in live]
        futures = [b[1] for b in live]
        n = len(items)
        size = bucket_for(n, self.buckets)
        self._occupancy.record(n, size)
        # Trace hand-off at the thread hop: collect ends on THIS (collector)
        # thread; the device span opens here and is closed by whatever
        # settles the future (fetch worker on the happy path — see
        # ``_end_trace_spans``), so it covers dispatch + device compute +
        # the one device->host transfer, bisection passes included.
        for _, fut, _ in live:
            h = getattr(fut, "_lumen_collect", None)
            if h is not None:
                h.end()
                attrs = {"batcher": self.name, "n": n, "size": size}
                if self.replica is not None:
                    attrs["replica"] = self.replica
                fut._lumen_device = fut._lumen_trace.begin("batch.device", attrs)
        arena = None
        t_dispatch = time.monotonic()
        try:
            stacked, arena = self._stack(items, size)
            if telemetry.enabled():
                # Host->device payload for this batch (the staged numpy
                # tree the backend will transfer). Per-batch, not
                # per-request; a windowed byte rate on /stats.
                telemetry.count(
                    f"transfer_h2d:{self.name}", _tree_nbytes(stacked)
                )
            result = self._execute(live, n, size, stacked=stacked)
            ready = record_ready(result)
        except Exception as e:  # noqa: BLE001 - contain, or fan out to callers
            self._contain_failure(live, e)
            return
        with self._inflight_cv:
            if self._fetch_thread is not None and not self._fetch_thread.is_alive():
                dead = True  # nobody left to settle this result
            else:
                self._inflight.append(
                    _Inflight(
                        futures, result, n, size, entries=live, arena=arena,
                        t_dispatch=t_dispatch, ready=ready,
                    )
                )
                self._inflight_cv.notify_all()
        if dead:
            self._abort_dead_fetch(futures)

    def _execute(
        self,
        entries: list[tuple[Any, Future, str | None]],
        n: int,
        size: int,
        stacked: Any | None = None,
    ):
        """Fault checks + stack + dispatch for one (sub-)batch, watched by
        the watchdog. Shared by the normal dispatch path (which pre-stacks
        into a reusable arena and passes ``stacked``) and bisection probes
        (which re-stack their sub-batch here), so an armed fault point (or
        a real per-item failure, e.g. a shape mismatch surfacing in
        ``stack_and_pad``) fires identically for every sub-batch that
        still contains the offending item."""
        from ..testing.faults import faults

        with self._watched([e[1] for e in entries]):
            # No-op unless a test/harness armed the point; lets the suite
            # exercise the containment paths below deterministically.
            # With inflight > 1 an injected failure lands on exactly this
            # batch's callers — earlier in-flight batches settle normally.
            faults.check("batch_execute", self.name)
            for _, _, fingerprint in entries:
                if fingerprint:
                    faults.check("batch_poison", f"{self.name}:{fingerprint}")
            if faults.fires("batch_hang", self.name):
                self._hang()
            if stacked is None:
                stacked = stack_and_pad([e[0] for e in entries], size)
            return self.fn(stacked, n)  # async dispatch; fetch worker settles

    #: bound on distinct (bucket, leaf-signature) arena keys; past it new
    #: shapes fall back to allocating stacks (a shape-churning caller must
    #: not grow pinned staging memory without limit).
    _MAX_ARENA_KEYS = 8

    def _stack(self, items: list[Any], size: int):
        """Stack ``items`` into a reusable per-bucket staging arena
        (collector thread only — bisection probes and salvage paths use the
        allocating :func:`stack_and_pad`). Returns ``(stacked_tree,
        arena_buffers | None)``; the buffers ride the in-flight entry so
        the fetch path can copy out of a result that aliases them.

        A ring of ``inflight + 2`` buffer sets per signature makes reuse
        safe even when the backend zero-copy-aliases host numpy: a slot is
        rewritten only after its batch left the in-flight deque (the
        collector blocks at ``inflight`` un-fetched batches), i.e. after
        its device work was fetched. Any shape/structure surprise falls
        back to ``stack_and_pad`` so error semantics (and bisection) are
        exactly the pre-arena ones. With ``pin_memory`` the buffers are
        pinned torch tensors (written through numpy views), so the
        host->device copy of the batch is asynchronous."""
        try:
            flat = [tree_flatten(it) for it in items]
            leaves0 = [np.asarray(l) for l in flat[0][0]]
            treedef0 = flat[0][1]
            key = (size, treedef0, tuple((a.shape, a.dtype.str) for a in leaves0))
            ring = self._arenas.get(key)
            if ring is None:
                if len(self._arenas) >= self._MAX_ARENA_KEYS:
                    return stack_and_pad(items, size, pin=self.pin_memory), None
                ring = [
                    [_staging((size, *a.shape), a.dtype, self.pin_memory) for a in leaves0]
                    for _ in range(self.inflight + 2)
                ]
                self._arenas[key] = ring
                self._arena_seq[key] = 0
            seq = self._arena_seq[key]
            self._arena_seq[key] = seq + 1
            bufs = ring[seq % len(ring)]
            views = [_host_view(b) for b in bufs]
            n = len(items)
            for i, (leaves, treedef) in enumerate(flat):
                if treedef != treedef0:
                    raise ValueError("mixed pytree structures in batch")
                for j, leaf in enumerate(leaves):
                    arr = np.asarray(leaf)
                    # Exact-match gate, like np.stack's: a broadcastable
                    # (or castable) mismatch must fall through to the
                    # allocating path and RAISE there — never silently
                    # broadcast/truncate into a wrong device result.
                    if arr.shape != leaves0[j].shape or arr.dtype != leaves0[j].dtype:
                        raise ValueError(
                            f"item {i} leaf {j} shape/dtype "
                            f"{arr.shape}/{arr.dtype} != arena "
                            f"{leaves0[j].shape}/{leaves0[j].dtype}"
                        )
                    views[j][i] = arr
            if n < size:
                for view in views:
                    view[n:size] = view[n - 1]  # repeat-last padding
            return tree_unflatten(treedef0, bufs), views
        except Exception:  # noqa: BLE001 - degrade to the allocating path
            return stack_and_pad(items, size, pin=self.pin_memory), None

    def _hang(self) -> None:
        """Simulate a wedged device call (``batch_hang`` fault point):
        park where the real stall would sit until the watchdog fires or
        the batcher closes, then surface the corresponding error."""
        logger.warning("%s: batch_hang fault armed; parking dispatch", self.name)
        while not self._closed.is_set() and self._wedged is None:
            time.sleep(0.005)
        raise self._wedged or RuntimeError(f"{self.name}: closed while hung")

    def _contain_failure(
        self, entries: list[tuple[Any, Future, str | None]], error: Exception
    ) -> None:
        """A dispatched (sub-)batch raised: bisect when possible, otherwise
        fan the failure out to every caller (single item, or bisection
        disabled)."""
        n = len(entries)
        if n > 1 and self.bisect_depth > 0 and not isinstance(error, WatchdogTimeout):
            logger.warning(
                "%s: batch of %d failed (%s: %s); bisecting to isolate",
                self.name, n, type(error).__name__, error,
            )
            self._bisect(entries, error)
            return
        logger.exception("%s: batched dispatch failed (n=%d)", self.name, n)
        for _, fut, _ in entries:
            _settle(fut, exception=error)

    def _bisect(self, entries: list[tuple[Any, Future, str | None]], error: Exception) -> None:
        """Isolate the item(s) that make a batch fail.

        Runs SYNCHRONOUSLY on the calling thread (collector or fetch
        worker — whichever observed the failure): each probe dispatches a
        half and blocks on its fetch, so the pass costs at most
        ``2 * bisect_depth`` sub-batch device calls. Sub-batch sizes round
        up to existing buckets, so a warmed batcher sees no new shape. Containment verdicts:

        - a group that succeeds settles its futures with real rows
          (innocent co-batched callers lose latency, not their answers);
        - a single item that fails while ANY sibling succeeded is poison:
          :class:`PoisonInput` + quarantine registration;
        - a failing group at the depth bound fails together with its
          probe's error (isolation gave up — no quarantine on guesses);
        - if NOTHING succeeded, the device (not an input) is broken: every
          caller gets the original error and nothing is quarantined.
        """
        self.stats["bisects"] += 1
        metrics.count("batch_bisects")
        metrics.count(f"batch_bisects:{self.name}")
        isolated: list[tuple[tuple[Any, Future, str | None], Exception]] = []
        exhausted: list[tuple[list[tuple[Any, Future, str | None]], Exception]] = []
        succeeded = 0
        work: deque[tuple[list[tuple[Any, Future, str | None]], Exception, int]] = deque(
            [(entries, error, self.bisect_depth)]
        )
        while work:
            if self._wedged is not None:
                # A probe tripped the watchdog mid-pass: EVERYTHING still
                # unresolved — queued work, isolated candidates awaiting
                # their verdict, and depth-exhausted groups awaiting their
                # group error — fails with the wedge verdict, loudly.
                # Nothing else will ever settle these futures (they are in
                # neither the queue nor the in-flight deque).
                for group, _, _ in work:
                    for _, fut, _ in group:
                        _settle(fut, exception=WatchdogTimeout(str(self._wedged)))
                for entry, _ in isolated:
                    _settle(entry[1], exception=WatchdogTimeout(str(self._wedged)))
                for group, _ in exhausted:
                    for _, fut, _ in group:
                        _settle(fut, exception=WatchdogTimeout(str(self._wedged)))
                return
            group, err, depth = work.popleft()
            group = [e for e in group if not e[1].cancelled()]
            if not group:
                continue
            if len(group) == 1:
                isolated.append((group[0], err))
                continue
            if depth <= 0:
                exhausted.append((group, err))
                continue
            mid = (len(group) + 1) // 2
            for half in (group[:mid], group[mid:]):
                try:
                    rows = self._probe(half)
                except Exception as e:  # noqa: BLE001 - recurse into the half
                    work.append((half, e, depth - 1))
                else:
                    # Sibling evidence = the probe ran CLEAN on device,
                    # independent of whether its callers still wanted the
                    # rows (_settle on a cancelled/expired future returns
                    # False, but the device just proved these items
                    # healthy — the poison verdict below relies on it).
                    succeeded += len(half)
                    for (item, fut, _), row in zip(half, rows):
                        _settle(fut, result=row)
                    self.stats["batches"] += 1
                    self.stats["items"] += len(half)
        for group, err in exhausted:
            logger.error(
                "%s: bisection depth exhausted with %d items still "
                "co-failing; failing the group",
                self.name, len(group),
            )
            for _, fut, _ in group:
                _settle(fut, exception=err)
        if not succeeded:
            # NOTHING in the batch ran clean — that is a broken device
            # call, not poison inputs. A poison verdict requires sibling
            # evidence ("fails while others succeed"); without it, every
            # isolated item gets the original batch error and nothing is
            # quarantined. This holds at ANY depth: a depth-bounded pass
            # whose groups all co-failed proves just as little about the
            # one item it happened to isolate.
            if isolated:
                logger.error(
                    "%s: bisection found no healthy item in a batch of %d; "
                    "treating as a batch-level failure (%s)",
                    self.name, len(entries), error,
                )
                for entry, _ in isolated:
                    _settle(entry[1], exception=error)
            return
        for (item, fut, fingerprint), err in isolated:
            poison = PoisonInput(
                f"{self.name}: input isolated by batch bisection as the "
                f"item that fails its batch ({type(err).__name__}: {err})"
            )
            self.stats["poisoned"] += 1
            metrics.count("poison_isolated")
            metrics.count(f"poison_isolated:{self.name}")
            if fingerprint:
                self.quarantine.add(
                    fingerprint, f"{self.name}: {type(err).__name__}: {err}"
                )
            _settle(fut, exception=poison)

    def _probe(self, entries: list[tuple[Any, Future, str | None]]) -> list[Any]:
        """One synchronous bisection probe: dispatch the group and block on
        its fetch. Returns per-item rows; raises what the group raises.
        Probe device time feeds the same duty meter as normal batches —
        a bisection storm IS device load an operator should see."""
        n = len(entries)
        t0 = time.monotonic()
        try:
            result = self._execute(entries, n, bucket_for(n, self.buckets))
            ready = record_ready(result)
            with self._watched([e[1] for e in entries]):
                return unstack(result, n, ready, self._d2h_streams)
        finally:
            telemetry.busy(f"device:{self.name}", t0, time.monotonic())

    # -- watchdog ----------------------------------------------------------

    @contextmanager
    def _watched(self, futures: list[Future]):
        """Register the enclosed device call with the watchdog: if it runs
        past ``watchdog_s``, the monitor thread fails ``futures`` and
        disables the batcher. Free when the watchdog is off."""
        if self.watchdog_s <= 0:
            yield
            return
        lane = threading.get_ident()
        with self._watch_lock:
            self._watching[lane] = (time.monotonic(), futures)
        try:
            yield
        finally:
            with self._watch_lock:
                self._watching.pop(lane, None)

    def _watchdog_loop(self) -> None:
        interval = min(1.0, max(0.01, self.watchdog_s / 8))
        while not self._closed.is_set() and self._wedged is None:
            time.sleep(interval)
            now = time.monotonic()
            with self._watch_lock:
                overdue = [
                    futs
                    for _, (t0, futs) in self._watching.items()
                    if now - t0 > self.watchdog_s
                ]
            if overdue:
                self._fire_watchdog([f for futs in overdue for f in futs])
                return

    def _fire_watchdog(self, futures: list[Future]) -> None:
        """A device call blew its budget: presume the device stream is
        wedged. Fail the stuck batch's callers, drain everything queued or
        in flight (nothing downstream of a wedged lane will ever settle),
        and refuse new work — an operator (or the circuit breaker's
        recovery handoff) must reload the service."""
        err = WatchdogTimeout(
            f"{self.name}: batch execution exceeded the watchdog budget "
            f"({self.watchdog_s:.1f}s); batcher disabled pending reload"
        )
        queued_entries = []
        with self._submit_lock:
            # Set the wedge flag and drain the queue under the submit lock
            # (the same pairing close() uses): submit() re-checks _wedged
            # inside the lock, so no entry can land after this drain and
            # hang with nobody left to settle it.
            self._wedged = err
            while True:
                try:
                    queued = self._queue.get_nowait()
                except queue.Empty:
                    break
                if queued is not None:
                    queued_entries.append(queued)
        self.stats["watchdog"] += 1
        metrics.count("watchdog_timeouts")
        metrics.count(f"watchdog_timeouts:{self.name}")
        telemetry.record_event(
            "watchdog", self.name,
            f"batch exceeded the {self.watchdog_s:.1f}s watchdog budget; "
            "batcher disabled pending reload",
        )
        logger.error("%s", err)
        for f in futures:
            _settle(f, exception=err)
        with self._inflight_cv:
            stranded = list(self._inflight)
            self._inflight.clear()
            self._inflight_cv.notify_all()
        for entry in stranded:
            for f in entry.futures:
                _settle(f, exception=err)
        # The collector is either the stuck thread or about to observe
        # _wedged: queued entries would sit forever — fail them now.
        for queued in queued_entries:
            _settle(queued[1], exception=err)

    def _abort_dead_fetch(self, futures: list[Future]) -> None:
        """The fetch worker died (a BaseException escaped its loop):
        settle its stranded in-flight batches AND the current batch with a
        loud error — callers must not ride out the full batch-wait timeout
        for results that can never arrive."""
        err = RuntimeError(
            f"{self.name}: fetch worker died; batcher cannot settle results"
        )
        logger.error("%s", err)
        with self._inflight_cv:
            stranded = list(self._inflight)
            self._inflight.clear()
            self._inflight_cv.notify_all()
        for entry in stranded:
            for f in entry.futures:
                _settle(f, exception=err)
        for f in futures:
            _settle(f, exception=err)

    # -- fetch/settle worker ----------------------------------------------

    def _fetch_loop(self) -> None:
        """Drain the in-flight deque in dispatch order: one blocking
        device->host transfer per batch, then settle that batch's futures
        (submission order within the batch). Runs until close() has both
        stopped the collector and set the stop flag — every dispatched
        batch settles before close() returns."""
        while True:
            with self._inflight_cv:
                while not self._inflight:
                    # Exit only once close() asked AND the collector can no
                    # longer dispatch (its thread is dead) — a collector
                    # stuck past close()'s join timeout in a long compile
                    # must still get its final batch settled, not orphaned.
                    if self._fetch_stop:
                        # A wedged collector may be parked in a stuck
                        # device call forever; its futures are settled, so
                        # there is nothing left to wait for.
                        if self._wedged is not None or not (
                            self._thread and self._thread.is_alive()
                        ):
                            return
                        self._inflight_cv.wait(timeout=0.05)
                    else:
                        self._inflight_cv.wait()
                # Peek — the entry leaves the deque only after its fetch
                # completes, so the in-flight bound counts batches whose
                # device work (or transfer) is genuinely outstanding.
                entry = self._inflight[0]
            try:
                with self._watched(entry.futures):
                    rows = _unstack_guarded(
                        entry.result, entry.n, entry.arena, entry.ready, self._d2h_streams
                    )
            except Exception as e:  # noqa: BLE001 - contain, or fan out to THIS batch only
                # A device error often surfaces at the FETCH, not the
                # dispatch (CUDA launches are async): bisection runs here
                # too, re-dispatching halves of the original items.
                if entry.entries:
                    self._contain_failure(entry.entries, e)
                else:
                    logger.exception(
                        "%s: batched fetch failed (n=%d)", self.name, entry.n
                    )
                    for f in entry.futures:
                        _settle(f, exception=e)
            else:
                self.stats["batches"] += 1
                self.stats["items"] += entry.n
                self.stats["padded"] += entry.size - entry.n
                self._drain.record(entry.n)
                if telemetry.enabled():
                    # Capacity telemetry, all per-batch: the device duty
                    # envelope (dispatch->settle, union-merged so the
                    # pipelined overlap isn't double-counted), windowed
                    # batch fill vs padding, the bucket the batch
                    # compiled into, and the device->host result bytes.
                    now = time.monotonic()
                    if entry.t_dispatch:
                        telemetry.busy(
                            f"device:{self.name}", entry.t_dispatch, now
                        )
                    telemetry.count(f"batch_items:{self.name}", entry.n)
                    telemetry.count(
                        f"batch_padded:{self.name}", entry.size - entry.n
                    )
                    telemetry.count(
                        f"batch_bucket:{self.name}:{entry.size}"
                    )
                    if rows:
                        telemetry.count(
                            f"transfer_d2h:{self.name}",
                            _tree_nbytes(rows[0]) * entry.n,
                        )
                for f, row in zip(entry.futures, rows):
                    _settle(f, result=row)
            with self._inflight_cv:
                # Identity-guarded: _fire_watchdog may have cleared the
                # deque while this entry was being unstacked (it was only
                # PEEKED, not popped) — a blind popleft would then raise
                # on the empty deque, or eat a successor batch's entry.
                if self._inflight and self._inflight[0] is entry:
                    self._inflight.popleft()
                self._inflight_cv.notify_all()


# -- pytrees: dicts, lists, tuples and array leaves ----------------------------

#: treedef of a leaf (anything that is not a dict, list, tuple or None)
_LEAF = "*"


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """Leaves of a pytree in order (dict keys sorted, as ``jax.tree_util``)
    and a hashable structure :func:`tree_unflatten` rebuilds it from."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(x) for x in node))
        if node is None:
            return ("none",)
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(d):
        if d == _LEAF:
            return next(it)
        if d[0] == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if d[0] == "none":
            return None
        children = [build(c) for c in d[1]]
        return children if d[0] == "list" else tuple(children)

    return build(treedef)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def _tree_nbytes(tree: Any) -> int:
    """Total bytes across a pytree's array leaves (host-side accounting
    for the transfer-byte telemetry; leaves without ``nbytes`` count 0).
    One flatten per BATCH — never on the per-request path."""
    leaves, _ = tree_flatten(tree)
    return sum(int(getattr(leaf, "nbytes", 0) or 0) for leaf in leaves)


# -- staging and fetching ---------------------------------------------------


def _staging(shape: tuple, dtype: np.dtype, pin: bool) -> Any:
    """A host staging buffer: numpy, or a pinned torch tensor (whose
    host->device copies run asynchronously)."""
    if not pin:
        return np.empty(shape, dtype)
    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=True)


def _host_view(buf: Any) -> np.ndarray:
    """The numpy view rows are written through (a torch staging tensor
    shares its memory with it)."""
    return buf.numpy() if isinstance(buf, torch.Tensor) else buf


def stack_and_pad(items: list[Any], size: int, pin: bool = False) -> Any:
    """Stack a list of same-structure pytrees into one tree with leading dim
    ``size``; rows past ``len(items)`` repeat the last item (repeating keeps
    padding numerically harmless for ops like softmax over the batch).
    ``pin``: stage into pinned torch tensors (a batcher feeding a card).

    Items may be views over recycled buffers — notably the process decode
    pool's shared-memory arena slots (``DecodePool.run_decode``): stacking
    copies each row out, so the view is not needed AFTER the stack. But a
    submitter must still hold its lease until ``submit()``'s future
    settles, not just until dispatch: batch **bisection** re-stacks halves
    from the ORIGINAL item references at dispatch or fetch time, and a
    slot recycled early would feed the re-run garbage. The managers'
    ``try: batcher(view) finally: release()`` shape satisfies this by
    construction."""
    n = len(items)
    pad = size - n

    def stack(*leaves):
        arrs = [np.asarray(x) for x in leaves]
        if pad:
            arrs = arrs + [arrs[-1]] * pad
        out = np.stack(arrs)
        if not pin:
            return out
        buf = _staging(out.shape, out.dtype, True)
        buf.numpy()[...] = out
        return buf

    return tree_map(stack, *items)


def record_ready(tree: Any) -> "torch.cuda.Event | list | None":
    """An event on the current stream of the result's CUDA device,
    recorded right after the batch's work was launched (None for a host
    result): the fetch's side stream waits on exactly that work, never on
    work launched after it. :class:`Parts` get one a place, in place
    order."""
    if isinstance(tree, Parts):
        return [record_ready(t) for t in tree.trees]
    leaves, _ = tree_flatten(tree)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return torch.cuda.current_stream(leaf.device).record_event()
    return None


def synchronize(tree: Any) -> None:
    """Wait for the device work behind a result tree (``block_until_ready``),
    on every device it spans (every data place of :class:`Parts`)."""
    leaves, _ = tree_flatten(tree.trees if isinstance(tree, Parts) else tree)
    for dev in {leaf.device for leaf in leaves if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.synchronize(dev)


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16
        t = t.float()
    return t.numpy()


#: ``stream_for(device, place)``: the side stream of a data place's copies
#: on a device
StreamFor = Callable[[torch.device, int], "torch.cuda.Stream"]


class SideStreams:
    """Side streams for device->host copies, one a data place and device
    (a :data:`StreamFor`), made on first use: keyed by the place's index
    as well as its device, so two places on one card never share one."""

    def __init__(self) -> None:
        self._streams: dict[tuple[int, torch.device], torch.cuda.Stream] = {}

    def __call__(self, device: torch.device, place: int = 0) -> "torch.cuda.Stream":
        key = (place, device)
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams.setdefault(key, torch.cuda.Stream(device=device))
        return stream

    def __len__(self) -> int:
        return len(self._streams)


class _Fetch:
    """One launched device->host copy of a tree's CUDA leaves (see
    :func:`_fetch_cuda`); :meth:`wait` returns their host arrays."""

    __slots__ = ("tensors", "host", "done")

    def __init__(self, tensors: list[torch.Tensor], host: torch.Tensor, done: "torch.cuda.Event"):
        self.tensors, self.host, self.done = tensors, host, done

    def wait(self) -> list[np.ndarray]:
        self.done.synchronize()
        tensors, host = self.tensors, self.host
        if len(tensors) == 1:
            return [np.array(_host_numpy(host).reshape(tensors[0].shape))]
        out, off = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            out.append(np.array(_host_numpy(host[off:off + n].clone().view(t.dtype).reshape(t.shape))))
            off += n
        return out


def _fetch_cuda(
    tensors: list[torch.Tensor],
    ready: "torch.cuda.Event | None",
    stream_for: StreamFor | None,
    place: int = 0,
) -> _Fetch:
    """Launch ONE device->host copy for all of a tree's CUDA leaves: on
    the side stream of ``place`` on their device, which first waits on
    ``ready``, the leaves (as bytes, concatenated when there are several)
    go to one pinned host buffer; the host then waits on that stream's
    event alone (:meth:`_Fetch.wait`). ``record_stream`` tells the caching
    allocator the leaves are read on the side stream, so their memory is
    not handed to a later batch before the copy has read it."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"batch result spans devices {sorted({str(t.device) for t in tensors})}")
    stream = stream_for(device, place) if stream_for is not None else torch.cuda.Stream(device=device)
    if ready is None:
        ready = torch.cuda.current_stream(device).record_event()
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        flat = [t.detach().contiguous().reshape(-1) for t in tensors]
        if len(flat) == 1:
            src = flat[0]
        else:
            src = torch.cat([f.view(torch.uint8) for f in flat])
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src, non_blocking=True)
        done = stream.record_event()
    for t in tensors:
        t.record_stream(stream)
    return _Fetch(tensors, host, done)


def _device_get_start(tree: Any, ready, stream_for: StreamFor | None, place: int):
    """Launch the fetch of one tree's CUDA leaves; ``finish()`` of the
    returned callable gives the host tree."""
    leaves, treedef = tree_flatten(tree)
    cuda = [i for i, leaf in enumerate(leaves) if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
    fetch = _fetch_cuda([leaves[i] for i in cuda], ready, stream_for, place) if cuda else None

    def finish() -> Any:
        fetched = dict(zip(cuda, fetch.wait())) if fetch is not None else {}
        host = [
            fetched[i] if i in fetched
            else _host_numpy(leaf) if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf)
            for i, leaf in enumerate(leaves)
        ]
        return tree_unflatten(treedef, host)

    return finish


def device_get(
    tree: Any,
    ready: "torch.cuda.Event | list | None" = None,
    stream_for: StreamFor | None = None,
) -> Any:
    """A result tree on the host, as numpy (``jax.device_get``): CUDA
    leaves through :func:`_fetch_cuda` (``ready``: the event recorded
    after the batch's work; ``stream_for``: the side stream of a data place
    on a device), CPU tensors as numpy, anything else through
    ``np.asarray``. :class:`Parts` (``ready`` one event a place): every
    place's copy is launched on its own side stream before any is waited
    on, and the rows are joined in place order."""
    if not isinstance(tree, Parts):
        return _device_get_start(tree, ready, stream_for, 0)()
    readies = ready if ready is not None else [None] * len(tree.trees)
    finish = [_device_get_start(t, r, stream_for, i) for i, (t, r) in enumerate(zip(tree.trees, readies))]
    return tree_map(lambda *rows: np.concatenate(rows), *(f() for f in finish))


def _unstack_guarded(
    tree: Any,
    n: int,
    arena: list | None,
    ready: "torch.cuda.Event | list | None" = None,
    stream_for: StreamFor | None = None,
) -> list[Any]:
    """``unstack`` with an arena-alias guard: a passthrough/zero-copy
    backend can hand back host arrays that ALIAS the reusable staging
    buffers the batch was stacked into — rows sliced from those would be
    silently rewritten when the arena slot cycles. Any fetched leaf that
    may share memory with an arena buffer is copied out first (real device
    results are fresh host arrays, so the check is a no-op bounds test on
    the hot path)."""
    tree = device_get(tree, ready, stream_for)
    if arena:
        leaves, treedef = tree_flatten(tree)
        leaves = [
            np.array(leaf, copy=True)
            if isinstance(leaf, np.ndarray)
            and any(np.may_share_memory(leaf, buf) for buf in arena)
            else leaf
            for leaf in leaves
        ]
        tree = tree_unflatten(treedef, leaves)
    leaves, treedef = tree_flatten(tree)
    return [tree_unflatten(treedef, [leaf[i] for leaf in leaves]) for i in range(n)]


def unstack(
    tree: Any,
    n: int,
    ready: "torch.cuda.Event | list | None" = None,
    stream_for: StreamFor | None = None,
) -> list[Any]:
    """Split a batched result tree back into ``n`` single-item trees (host
    numpy). :func:`device_get` on the WHOLE tree makes one device->host
    copy per batch (a per-leaf ``.cpu()`` loop would round-trip the device
    once per leaf, on the default stream — the fetch worker calls this on
    every settled batch, so the difference is on the serving hot path);
    numpy and array-like leaves pass through as plain arrays."""
    return _unstack_guarded(tree, n, None, ready, stream_for)
