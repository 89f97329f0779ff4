"""Shared host-decode pool: the serving path's first lane.

The port's copy of ``lumen_tpu/runtime/decode_pool.py``. On the serving
path the first serialized host step is image decode: a gRPC handler
thread that decodes its own payload inline makes decode concurrency
whatever the RPC thread pool happens to be — unbounded CPU
oversubscription under load, single-threaded decode under light
concurrency, and always on the thread that should be going straight back
to the batcher.

This module owns ONE process-wide sized pool that decode/preprocess work
routes through (in the port: the CLIP manager's ``clip_resize`` decode;
in the JAX package also its other managers and the photo-ingest
producer). It runs in one of two modes:

- **Thread mode** (``LUMEN_DECODE_WORKERS``; default ``cpu_count - 1``,
  floor 1): a sized :class:`ThreadPoolExecutor`. PIL and cv2 release the
  GIL for parts of a decode, but the surrounding Python (header probes,
  color conversion, numpy glue) does not — measured decode scaling
  plateaus well under the core count. This stays the default on small
  hosts and the tier-1 suite default.
- **Process mode** (``LUMEN_DECODE_PROCS``; unset = auto: ``cpu_count-1``
  workers when the host has >2 cores, else thread mode; ``0`` forces
  thread mode): decode **specs** (named, picklable-by-reference recipes
  from :mod:`lumen_tpu_torch.utils.host_decode`) run in spawned worker
  processes — no GIL anywhere near the decode — and the decoded pixels
  come back through parent-owned shared-memory arena slots
  (:mod:`lumen_tpu_torch.utils.shm_arena`), so the only pickle on the hop is
  a tuple of metadata. Arbitrary callables (``run``/``map``) still use
  the thread lane; a crashed worker fails its items as retryable sheds
  (:class:`QueueFull` — never a poison verdict) and the process pool is
  rebuilt on the next submission.

Queue-wait telemetry is exported as metrics gauges (``decode_pool``
provider: ``queue_depth``, ``wait_ms_p50``, arena accounting, spill and
crash counters), so an operator can see when the decode lane — not the
device — binds, and whether zero-copy transport is actually engaged.

Deliberately torch-free: the pool is pure host plumbing and must stay
importable from the serving layer without pulling in a backend.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterable

from ..utils import host_decode
from ..utils.deadline import DeadlineExpired, QueueFull, get_deadline
from ..utils.env import env_int
from ..utils.metrics import metrics
from ..utils.shm_arena import ShmArena
from . import telemetry
from .trace import current_trace

DECODE_WORKERS_ENV = "LUMEN_DECODE_WORKERS"
DECODE_PROCS_ENV = "LUMEN_DECODE_PROCS"


def decode_workers() -> int:
    """Thread-lane size: ``LUMEN_DECODE_WORKERS`` when set to a positive
    int, else ``cpu_count - 1`` with a floor of 1 — decode is CPU-bound,
    so the default claims every core but one, reserved for the thread
    that must keep draining the gRPC/batcher side (a decode lane that
    saturates ALL cores starves the very consumer it feeds)."""
    n = env_int(DECODE_WORKERS_ENV, 0)
    if n > 0:
        return n
    return max(1, (os.cpu_count() or 2) - 1)


def decode_procs() -> int:
    """Process-lane size: ``LUMEN_DECODE_PROCS`` (0 = thread mode). Unset
    means auto: ``cpu_count - 1`` worker processes when the host has more
    than 2 cores — where the GIL is the measured decode ceiling — and
    thread mode otherwise (on 1-2 cores the spawn/IPC overhead buys no
    parallelism back)."""
    n = env_int(DECODE_PROCS_ENV, None, minimum=0)
    if n is not None:
        return n
    cpus = os.cpu_count() or 1
    return max(1, cpus - 1) if cpus > 2 else 0


class DecodedTensor:
    """One decoded result: ``array`` (possibly a view over a shared-memory
    arena slot), optional ``extras`` provenance from the spec, and a
    ``release()`` the caller MUST invoke once the pixels have been
    consumed (stacked by the batcher / copied device-side) — it recycles
    the arena slot. No-op in thread mode and for spilled results."""

    __slots__ = ("array", "extras", "_release")

    def __init__(self, array, extras=None, release: Callable[[], None] | None = None):
        self.array = array
        self.extras = extras
        self._release = release

    def release(self) -> None:
        if self._release is not None:
            self._release()
            self._release = None


def _call_spec(spec: str, payload: bytes, params: dict | None):
    return host_decode.resolve_decode_spec(spec)(payload, dict(params or {}))


class DecodePool:
    """Sized decode pool with queue-wait telemetry and nested-call safety.

    ``run``/``map`` called FROM a pool worker thread execute inline — a
    pooled task that fans out again (e.g. an ingest ``decode`` that
    itself calls a manager helper) must not deadlock a fully-occupied
    pool waiting on itself.
    """

    def __init__(
        self,
        workers: int | None = None,
        name: str = "decode-pool",
        procs: int | None = None,
    ):
        self.workers = workers if workers and workers > 0 else decode_workers()
        self.procs = procs if procs is not None and procs >= 0 else decode_procs()
        self.name = name
        self._pool = ThreadPoolExecutor(self.workers, thread_name_prefix=name)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pending = 0  # submitted, not yet started (queue depth)
        self._tasks = 0
        self._wait_ms: deque[float] = deque(maxlen=512)
        # Process lane (built lazily on first spec decode: spawning
        # workers costs ~0.5s each and a thread-mode-only deployment must
        # never pay it). The arena is parent-owned; workers only attach.
        self._proc_lock = threading.Lock()
        self._workers_cond = threading.Condition(self._proc_lock)
        self._proc_threads: ThreadPoolExecutor | None = None
        self._workers_idle: list[_PipeWorker] = []
        self._workers_all: set[_PipeWorker] = set()
        self._workers_alive = 0
        self._closed = False
        self._arena: ShmArena | None = None
        self._spills = 0
        self._crashes = 0
        #: spec decodes by spec name (both lanes): the ``decodes_<spec>``
        #: gauges, which show which decode recipes a path runs
        self._spec_decodes: dict[str, int] = {}
        self._crash_streak = 0
        # Gauges close over a weakref: the global metrics registry must not
        # be what keeps a dropped pool's threads reachable.
        ref = weakref.ref(self)

        def _gauges() -> dict:
            pool = ref()
            return {} if pool is None else pool.gauges()

        self._gauge_fn = _gauges
        metrics.register_gauges(name, _gauges)
        # Worker duty meter: per-task run time sums against the pool's
        # total decode concurrency (threads + worker processes), so
        # /stats reports the lane's busy fraction — the "is the host
        # decode lane the wall right now" signal — identically in both
        # modes.
        self._duty_name = f"decode:{name}"
        telemetry.set_capacity(self._duty_name, float(self.workers + self.procs))

    @property
    def process_mode(self) -> bool:
        return self.procs > 0

    # -- task plumbing -----------------------------------------------------

    def _task(
        self,
        fn: Callable,
        args: tuple,
        kwargs: dict,
        t_submit: float,
        deadline: float | None,
        qspan=None,
        box: dict | None = None,
    ) -> Any:
        self._local.in_pool = True
        wait_ms = (time.perf_counter() - t_submit) * 1e3
        with self._lock:
            self._pending -= 1
            self._tasks += 1
            self._wait_ms.append(wait_ms)
        # Trace hand-off at the thread hop: the queue span (begun on the
        # submitting thread) ends here on the pool worker, and the run
        # span covers the decode itself.
        if qspan is not None:
            qspan.end()
        # Same contract as the batcher's pre-dispatch gate, one stage
        # earlier: a request whose deadline expired while it sat in the
        # decode queue must not burn a pool worker decoding an image
        # nobody is waiting for (under overload that's ALL the workers).
        if deadline is not None and time.monotonic() >= deadline:
            metrics.count("deadline_drops")
            metrics.count(f"deadline_drops:{self.name}")
            raise DeadlineExpired(
                f"{self.name}: request deadline expired while queued for decode"
            )
        # Worker busy accounting (per task, not per request-stage): the
        # run time sums into the ``decode:{pool}`` duty meter whatever
        # the tracing state is — duty cycles are always-on telemetry.
        t_run = time.monotonic()
        if qspan is None:
            try:
                return fn(*args, **kwargs)
            finally:
                telemetry.busy(self._duty_name, t_run, time.monotonic())
        rspan = qspan.trace.begin("decode", {"pool": self.name})
        try:
            result = fn(*args, **kwargs)
        except BaseException as e:
            rspan.end(error=type(e).__name__)
            telemetry.busy(self._duty_name, t_run, time.monotonic())
            raise
        rspan.end()
        telemetry.busy(self._duty_name, t_run, time.monotonic())
        if box is not None:
            # Completion instant for the caller's ``decode.wake`` span —
            # written before _task returns, so run() can never read a
            # half-stamped box.
            box["settled"] = time.perf_counter()
        return result

    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        # The ambient deadline is a contextvar of the CALLING thread;
        # capture it here, not in the worker. Same for the request trace:
        # the queue span must begin where the contextvar is visible.
        deadline = get_deadline()
        tr = current_trace()
        qspan = box = None
        if tr is not None:
            qspan = tr.begin("decode.queue", {"pool": self.name})
            box = {}
        with self._lock:
            self._pending += 1
        fut = self._pool.submit(
            self._task, fn, args, kwargs, time.perf_counter(), deadline, qspan, box
        )
        if tr is not None:
            fut._lumen_trace = tr
            fut._lumen_box = box
        return fut

    def run(self, fn: Callable, *args, **kwargs) -> Any:
        """Run ``fn`` in the pool and wait for its result (exceptions
        propagate unchanged). Inline when already on a pool thread."""
        if getattr(self._local, "in_pool", False):
            return fn(*args, **kwargs)
        fut = self.submit(fn, *args, **kwargs)
        result = fut.result()
        # Attribution completeness: on a loaded host the worker finishing
        # and THIS thread resuming are milliseconds apart — charge that
        # scheduler gap to ``decode.wake`` instead of leaving it dark.
        box = getattr(fut, "_lumen_box", None)
        if box is not None and "settled" in box:
            fut._lumen_trace.add_span(
                "decode.wake", box["settled"], time.perf_counter()
            )
        return result

    def map(self, fn: Callable, items: Iterable) -> list:
        """Parallel map preserving input order (inline on a pool thread)."""
        if getattr(self._local, "in_pool", False):
            return [fn(item) for item in items]
        futs = [self.submit(fn, item) for item in items]
        return [f.result() for f in futs]

    # -- spec decode (thread OR process lane) ------------------------------

    def run_decode(
        self, spec: str, payload: bytes, params: dict | None = None
    ) -> DecodedTensor:
        """Run a **named decode spec** (:mod:`lumen_tpu_torch.utils.host_decode`)
        and wait for its result. In process mode the decode runs in a
        worker process and the returned array is a zero-copy view over a
        shared-memory arena slot — the caller must ``release()`` the
        result once the pixels are consumed. Thread mode runs the exact
        same spec function on the thread lane (``release()`` is a no-op),
        so the two modes are bitwise-identical by construction."""
        self._count_spec(spec, 1)
        if not self.process_mode:
            out = self.run(_call_spec, spec, payload, params)
            if isinstance(out, tuple):
                return DecodedTensor(out[0], out[1])
            return DecodedTensor(out)
        return self._proc_decode(spec, payload, params)

    def map_decode(
        self, spec: str, payloads: Iterable[bytes], params: dict | None = None
    ) -> list[DecodedTensor]:
        """Parallel :meth:`run_decode` preserving input order. On any
        per-item failure, already-materialized results are released and
        the error propagates — the caller never has to track half a
        batch's leases."""
        payloads = list(payloads)
        self._count_spec(spec, len(payloads))
        if not self.process_mode:
            outs = self.map(lambda p: _call_spec(spec, p, params), payloads)
            return [
                DecodedTensor(o[0], o[1]) if isinstance(o, tuple) else DecodedTensor(o)
                for o in outs
            ]
        submitted = [self._proc_submit(spec, p, params) for p in payloads]
        results: list[DecodedTensor] = []
        try:
            for entry in submitted:
                results.append(self._proc_settle(*entry))
        except BaseException:
            for r in results:
                r.release()
            raise
        return results

    def _count_spec(self, spec: str, n: int) -> None:
        with self._lock:
            self._spec_decodes[spec] = self._spec_decodes.get(spec, 0) + n

    def _proc_lane(self) -> ThreadPoolExecutor:
        """The process lane's parent-side plumbing, built lazily: a small
        executor of pure-I/O threads (each one blocks on one worker
        process's pipe for the duration of a decode) plus the shared
        arena. Worker PROCESSES themselves are spawned on demand up to
        ``procs`` and recycled across requests."""
        with self._proc_lock:
            if self._proc_threads is None:
                self._proc_threads = ThreadPoolExecutor(
                    self.procs, thread_name_prefix=f"{self.name}-procio"
                )
                self._arena = ShmArena(name=self.name.replace("-", ""))
            return self._proc_threads

    def _checkout_worker(self) -> "_PipeWorker":
        spawn = False
        with self._workers_cond:
            while True:
                # A mid-wait downgrade (crash streak) or pool close must
                # fail waiters rather than park them forever: both paths
                # notify_all, and the re-check here turns the wake into a
                # retryable shed (the retry lands on the thread lane).
                if self._closed or self.procs <= 0:
                    raise _WorkerDied("decode process lane closed")
                if self._workers_idle:
                    return self._workers_idle.pop()
                if self._workers_alive < self.procs:
                    self._workers_alive += 1
                    spawn = True
                    break
                self._workers_cond.wait()
        try:
            w = _PipeWorker()
        except BaseException as e:
            with self._workers_cond:
                self._workers_alive -= 1
                self._workers_cond.notify()
            raise _WorkerDied(f"decode worker spawn failed: {e}") from e
        assert spawn
        with self._workers_cond:
            self._workers_all.add(w)
        return w

    def _checkin_worker(self, w: "_PipeWorker", died: bool) -> None:
        with self._workers_cond:
            if died:
                self._workers_alive -= 1
                self._workers_all.discard(w)
            else:
                self._workers_idle.append(w)
            self._workers_cond.notify()
        if died:
            w.close()

    def _proc_request(self, spec, payload, params, slot, deadline):
        """One decode round-trip to a worker process (runs on a procio
        thread). Worker checkout blocks when all ``procs`` workers are
        busy — that wait IS the process lane's queue, and the worker's
        own pickup stamp measures it."""
        w = self._checkout_worker()
        died = False
        try:
            return w.request((
                spec, payload, params,
                slot.name if slot is not None else None,
                slot.capacity if slot is not None else 0,
                deadline,
            ))
        except _WorkerDied:
            died = True
            raise
        finally:
            self._checkin_worker(w, died)

    def _proc_submit(self, spec: str, payload: bytes, params: dict | None):
        """Submit one spec decode to the process lane. Returns everything
        :meth:`_proc_settle` needs to finish the hop on the caller side."""
        deadline = get_deadline()
        tr = current_trace()
        lane = self._proc_lane()
        slot = self._arena.acquire(
            host_decode.spec_est_nbytes(spec, payload, params or {})
        )
        with self._lock:
            self._pending += 1
        t_submit = time.perf_counter()
        try:
            fut = lane.submit(
                self._proc_request, spec, bytes(payload), params, slot, deadline
            )
        except BaseException:
            with self._lock:
                self._pending -= 1
            if slot is not None:
                slot.release()
            raise
        return (fut, slot, t_submit, tr)

    def _proc_settle(self, fut, slot, t_submit, tr) -> DecodedTensor:
        try:
            res = fut.result()
        except _WorkerDied as e:
            self._proc_account(t_submit, None)
            if slot is not None:
                slot.release()
            raise self._proc_crashed(e) from e
        # Worker pickup stamp per response shape (queue-wait gauge twin
        # of the thread lane's submit->start measurement).
        t0 = {"deadline": 1, "shm": 4, "raw": 3}.get(res[0])
        self._proc_account(t_submit, res[t0] if t0 is not None else None)
        if res[0] == "error":
            # The spec itself raised IN the worker (undecodable payload,
            # unknown spec): re-raise with thread-lane shapes — a
            # ValueError is the decode contract's own verdict, anything
            # else a plain crash. Not a worker-health event.
            if slot is not None:
                slot.release()
            _, kind, msg = res
            if kind == "ValueError":
                raise ValueError(msg)
            raise RuntimeError(f"decode worker: {kind}: {msg}")
        with self._lock:
            self._crash_streak = 0
        if res[0] == "deadline":
            if slot is not None:
                slot.release()
            metrics.count("deadline_drops")
            metrics.count(f"deadline_drops:{self.name}")
            raise DeadlineExpired(
                f"{self.name}: request deadline expired while queued for decode"
            )
        if res[0] == "shm":
            _, shape, dtype, extras, t0_pc, t1_pc, t0_m, t1_m = res
            self._proc_telemetry(tr, t_submit, t0_pc, t1_pc, t0_m, t1_m)
            return DecodedTensor(slot.view(shape, dtype), extras, slot.release)
        # "raw": output did not fit the slot (or the arena declined one) —
        # the array crossed pickled. Correct, observable, not zero-copy.
        _, arr, extras, t0_pc, t1_pc, t0_m, t1_m = res
        if slot is not None:
            slot.release()
        with self._lock:
            self._spills += 1
        metrics.count("decode_shm_spills")
        self._proc_telemetry(tr, t_submit, t0_pc, t1_pc, t0_m, t1_m)
        return DecodedTensor(arr, extras)

    def _proc_account(self, t_submit: float, t_pickup: float | None) -> None:
        """Queue-depth/wait bookkeeping for one settled process task —
        wait is measured submit -> worker pickup, directly comparable
        across processes (CLOCK_MONOTONIC is machine-wide on Linux)."""
        wait_ms = 0.0 if t_pickup is None else max(0.0, (t_pickup - t_submit) * 1e3)
        with self._lock:
            self._pending -= 1
            self._tasks += 1
            self._wait_ms.append(wait_ms)

    def _proc_telemetry(self, tr, t_submit, t0_pc, t1_pc, t0_m, t1_m) -> None:
        """Duty-meter credit + trace spans for a process-lane decode,
        stitched from the worker's clock stamps so ``decode.queue`` /
        ``decode`` / ``decode.wake`` report identically to thread mode
        (the PR 6 cross-thread contract, extended across the process
        hop)."""
        telemetry.busy(self._duty_name, t0_m, t1_m)
        if tr is None:
            return
        meta = {"pool": self.name, "proc": "1"}
        tr.add_span("decode.queue", t_submit, t0_pc, meta)
        tr.add_span("decode", t0_pc, t1_pc, meta)
        tr.add_span("decode.wake", t1_pc, time.perf_counter(), meta)

    def _proc_crashed(self, cause: BaseException) -> QueueFull:
        """A worker process died mid-decode. The payload gets NO verdict —
        a crashed codec says nothing about the bytes (contrast
        PoisonInput, which requires sibling evidence) — so the item fails
        as a retryable shed; the dead worker was already discarded and
        the next request simply spawns a fresh one (siblings keep
        serving throughout). A streak of crashes with no successful
        decode in between means the environment, not a payload, is
        broken: downgrade to thread mode instead of thrashing respawn
        loops."""
        with self._lock:
            self._crashes += 1
            self._crash_streak += 1
            streak = self._crash_streak
        metrics.count("decode_proc_crashes")
        if streak >= 3 and self.procs > 0:
            import logging

            logging.getLogger(__name__).warning(
                "%s: %d consecutive decode-worker crashes; downgrading to "
                "thread mode", self.name, streak,
            )
            self.procs = 0
            # The duty meter's capacity was registered as workers + procs;
            # the lane just shrank to threads only — re-declare it or
            # /stats understates decode busy by the dead procs forever.
            telemetry.set_capacity(self._duty_name, float(self.workers))
            with self._workers_cond:
                self._workers_cond.notify_all()
        return QueueFull(
            f"{self.name}: decode worker process died mid-decode ({cause}); "
            "a fresh worker will serve the retry"
        )

    def _proc_decode(self, spec: str, payload: bytes, params: dict | None) -> DecodedTensor:
        entry = self._proc_submit(spec, payload, params)
        out = self._proc_settle(*entry)
        return out

    # -- telemetry ---------------------------------------------------------

    def wait_ms_p50(self) -> float:
        with self._lock:
            sample = sorted(self._wait_ms)
        return sample[len(sample) // 2] if sample else 0.0

    def gauges(self) -> dict:
        with self._lock:
            pending, tasks = self._pending, self._tasks
            spills, crashes = self._spills, self._crashes
            spec_decodes = dict(self._spec_decodes)
        # Numeric-only: the metrics registry drops non-numeric gauge
        # values at snapshot (Prometheus exposition contract), so the
        # mode flag is an int and the arena block is flattened with an
        # ``arena_`` prefix — the accounting invariant (acquired ==
        # recycled, live == 0 at drain) must be visible on /metrics.
        out = {
            "workers": self.workers,
            "queue_depth": pending,
            "tasks": tasks,
            "wait_ms_p50": round(self.wait_ms_p50(), 3),
            "process_mode": int(self.process_mode),
            "procs": self.procs,
        }
        out.update({f"decodes_{spec}": n for spec, n in sorted(spec_decodes.items())})
        if spills:
            out["shm_spills"] = spills
        if crashes:
            out["proc_crashes"] = crashes
        arena = self._arena
        if arena is not None:
            out.update({f"arena_{k}": v for k, v in arena.stats().items()})
        return out

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        with self._workers_cond:
            self._closed = True
            workers = list(self._workers_all)
            self._workers_all.clear()
            self._workers_idle.clear()
            self._workers_cond.notify_all()
        for w in workers:
            w.close()
        if self._proc_threads is not None:
            self._proc_threads.shutdown(wait=False)
        if self._arena is not None:
            self._arena.close()
        metrics.unregister_gauges(self.name, self._gauge_fn)


#: what a decode worker process runs: this package's torch-free module
WORKER_COMMAND = "from lumen_tpu_torch.utils.host_decode import worker_main; worker_main()"


class _WorkerDied(Exception):
    """A decode worker process exited (or its pipe broke) mid-request."""


class _PipeWorker:
    """Parent-side handle for one decode worker subprocess. The child
    runs :func:`lumen_tpu_torch.utils.host_decode.worker_main` — it imports
    exactly that torch-free module (numpy + cv2/PIL), never the parent's
    ``__main__``, never torch. One request is in flight at a time; the
    pool checks workers out per request and recycles them, so a worker's
    module imports are paid once per process lifetime."""

    def __init__(self):
        import subprocess
        import sys

        env = dict(os.environ)
        # lumen_tpu_torch's import root (works from a checkout or site-packages).
        root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(host_decode.__file__)))
        )
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", WORKER_COMMAND],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=env,
        )

    def request(self, task: tuple):
        import pickle
        import struct

        try:
            blob = pickle.dumps(task, protocol=pickle.HIGHEST_PROTOCOL)
            self.proc.stdin.write(struct.pack("<Q", len(blob)))
            self.proc.stdin.write(blob)
            self.proc.stdin.flush()
            hdr = self.proc.stdout.read(8)
            if len(hdr) < 8:
                raise _WorkerDied(f"worker exited (rc={self.proc.poll()})")
            (n,) = struct.unpack("<Q", hdr)
            data = self.proc.stdout.read(n)
            if len(data) < n:
                raise _WorkerDied("worker pipe truncated mid-response")
            return pickle.loads(data)
        except (BrokenPipeError, OSError) as e:
            raise _WorkerDied(str(e)) from e

    def close(self) -> None:
        try:
            self.proc.stdin.close()  # EOF = clean shutdown request
        except Exception:  # noqa: BLE001
            pass
        try:
            self.proc.wait(timeout=0.5)
        except Exception:  # noqa: BLE001
            try:
                self.proc.kill()
                self.proc.wait(timeout=0.5)
            except Exception:  # noqa: BLE001
                pass


_shared: DecodePool | None = None
_shared_lock = threading.Lock()


def get_decode_pool() -> DecodePool:
    """The process-wide pool (lazily built from the env)."""
    global _shared
    if _shared is None:
        with _shared_lock:
            if _shared is None:
                _shared = DecodePool(name="decode_pool")
    return _shared


def shutdown_decode_pool() -> None:
    """Drop the shared pool (tests / clean process exit); the next
    :func:`get_decode_pool` builds a fresh one from the current env."""
    global _shared
    with _shared_lock:
        pool, _shared = _shared, None
    if pool is not None:
        pool.close()
