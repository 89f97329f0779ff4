"""The port's ``MicroBatcher`` held to the JAX package's batcher cases.

The admission, deadline, pipelined-executor, fault, adaptive-window,
occupancy and staging-arena cases of ``tests/test_batcher_admission.py``,
``tests/test_batch_window.py`` and ``tests/test_batcher_overlap.py`` are
package-neutral (host numpy items, fake device functions), so each runs
against both packages' batchers (``pkg``), with the same assertions.
The port's own cases run torch-tensor batches through stack, fetch and
unstack on the CPU: results come back as host numpy rows (bfloat16 as
float32), the pytree helpers flatten in ``jax.tree_util``'s order, and
``mesh_sharded`` places a staged batch on the replica's device.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import lumen_tpu.runtime.batcher as jax_batcher
import lumen_tpu.testing as jax_testing
import lumen_tpu.utils.deadline as jax_deadline
import lumen_tpu.utils.metrics as jax_metrics
import lumen_tpu_torch.runtime.batcher as port_batcher
import lumen_tpu_torch.testing as port_testing
import lumen_tpu_torch.utils.deadline as port_deadline
import lumen_tpu_torch.utils.metrics as port_metrics
from lumen_tpu_torch.runtime.mesh import DeviceMesh
from tests.batcher_fakes import SlowFetch

PACKAGES = {
    "jax": (jax_batcher, jax_testing, jax_deadline, jax_metrics),
    "port": (port_batcher, port_testing, port_deadline, port_metrics),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    batcher, testing, deadline, metrics = PACKAGES[request.param]
    testing.faults.reset()
    yield SimpleNamespace(
        B=batcher, MicroBatcher=batcher.MicroBatcher, faults=testing.faults,
        FaultInjected=testing.FaultInjected, deadline=deadline, metrics=metrics.metrics,
    )
    testing.faults.reset()


def identity(tree, n):
    return tree


class KillFetch:
    """BaseException out of ``__array__`` kills the fetch thread."""

    def __init__(self, arr):
        self.arr = np.asarray(arr)

    def __array__(self, dtype=None, copy=None):
        raise SystemExit("fetch thread killed")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# -- admission and deadlines ---------------------------------------------------


def test_depth_limit_sheds_and_drains(pkg):
    b = pkg.MicroBatcher(identity, max_batch=4, max_latency_ms=1, max_queue=2)  # not started: queue holds
    before = pkg.metrics.counter_value("sheds")
    f1, f2 = b.submit(np.zeros(1)), b.submit(np.zeros(1))
    with pytest.raises(pkg.deadline.QueueFull, match="request shed"):
        b.submit(np.zeros(1))
    assert b.stats["shed"] == 1 and pkg.metrics.counter_value("sheds") == before + 1
    b.start()
    f1.result(timeout=5), f2.result(timeout=5)
    assert np.asarray(b(np.zeros(1), timeout=5)).shape == (1,)  # admission opens again
    b.close()


def test_env_defaults(pkg, monkeypatch):
    monkeypatch.setenv("LUMEN_BATCH_QUEUE_DEPTH", "7")
    monkeypatch.setenv("LUMEN_BATCH_INFLIGHT", "5")
    b = pkg.MicroBatcher(identity)
    assert (b.max_queue, b.inflight) == (7, 5)
    monkeypatch.setenv("LUMEN_BATCH_QUEUE_DEPTH", "nope")
    monkeypatch.setenv("LUMEN_BATCH_INFLIGHT", "0")
    assert pkg.B.batch_queue_depth() == 0 and pkg.B.batch_inflight() == 1
    monkeypatch.setenv("LUMEN_BATCH_WINDOW_MS", "40")
    assert pkg.MicroBatcher(identity, max_batch=4, max_latency_ms=5).window_cap_s == pytest.approx(0.040)
    monkeypatch.setenv("LUMEN_BATCH_ADAPTIVE", "0")
    assert pkg.B.batch_adaptive() is False


def test_expired_at_submit_and_ambient_deadline(pkg):
    b = pkg.MicroBatcher(identity, max_batch=2)
    with pytest.raises(pkg.deadline.DeadlineExpired):
        b.submit(np.zeros(1), deadline=time.monotonic() - 0.1)
    token = pkg.deadline.set_deadline(time.monotonic() - 0.1)
    try:
        with pytest.raises(pkg.deadline.DeadlineExpired):
            b.submit(np.zeros(1))  # no explicit deadline: reads the contextvar
    finally:
        pkg.deadline.reset(token)
    b.close()


def test_expired_while_queued_dropped_before_device_call(pkg):
    calls = []

    def fn(tree, n):
        calls.append(n)
        return tree

    b = pkg.MicroBatcher(fn, max_batch=4, max_latency_ms=1, name="dl-t")
    doomed = b.submit(np.zeros(1), deadline=time.monotonic() + 0.01)
    live = b.submit(np.zeros(1))
    time.sleep(0.05)
    b.start()
    assert np.asarray(live.result(timeout=5)).shape == (1,)
    with pytest.raises(pkg.deadline.DeadlineExpired):
        doomed.result(timeout=5)
    assert calls == [1] and b.stats["expired"] == 1
    b.close()


def test_deadline_expiry_during_backpressure_wait(pkg):
    calls = []

    def fn(tree, n):
        calls.append(n)
        return SlowFetch(tree, 0.25)

    b = pkg.MicroBatcher(fn, max_batch=1, max_latency_ms=1, inflight=1, name="bp-dl").start()
    a = b.submit(np.zeros(1))
    time.sleep(0.03)  # A dispatched; its slow fetch holds the only slot
    doomed = b.submit(np.zeros(1), deadline=time.monotonic() + 0.05)
    assert np.asarray(a.result(timeout=5)).shape == (1,)
    with pytest.raises(pkg.deadline.DeadlineExpired):
        doomed.result(timeout=5)
    assert calls == [1]
    b.close()


# -- the pipelined executor ---------------------------------------------------------


def test_settles_in_submission_order_across_inflight_batches(pkg):
    b = pkg.MicroBatcher(lambda t, n: SlowFetch(t, 0.02), max_batch=1, max_latency_ms=0.5, inflight=3).start()
    futs, settled = [], []
    for i in range(9):
        fut = b.submit(np.array([i], np.int64))
        fut.add_done_callback(lambda _, i=i: settled.append(i))
        futs.append(fut)
    high_water = 0
    deadline = time.monotonic() + 10
    while any(not f.done() for f in futs) and time.monotonic() < deadline:
        high_water = max(high_water, len(b._inflight))
        time.sleep(0.001)
    assert [int(np.asarray(f.result(timeout=10))[0]) for f in futs] == list(range(9))
    assert settled == list(range(9)) and high_water >= 3
    assert b.stats["batches"] == 9 and b.stats["items"] == 9
    b.close()


DISPATCH_S = FETCH_S = 0.03
N_BATCHES = 10


def sleepy_device_fn(tree, n):
    time.sleep(DISPATCH_S)
    return SlowFetch(tree, FETCH_S)


class TimedFetch(SlowFetch):
    """``SlowFetch`` that records when its fetch ran, under its batch's
    index."""

    def __init__(self, arr, delay: float, spans: dict, index: int):
        super().__init__(arr, delay)
        self.spans, self.index = spans, index

    def __array__(self, dtype=None, copy=None):
        t0 = time.perf_counter()
        out = super().__array__(dtype, copy)
        self.spans[self.index] = (t0, time.perf_counter())
        return out


def test_pipelined_batcher_overlaps_dispatch_and_fetch(pkg):
    """With ``inflight=2`` a batch's fetch runs while later batches
    dispatch. Held on the recorded start and end of every dispatch and
    every fetch, not on the wall clock, which a loaded host stretches with
    idle time (0.822 s against a 0.75 s bound once under xdist load):
    the fetches overlap later dispatches for at least a quarter of the
    serial time -- the saving the old bound, wall < 0.75 x serial, asked
    for -- and at least half of them overlap one."""
    dispatch, fetch = {}, {}

    def fn(tree, n):
        i = int(np.asarray(tree).reshape(-1)[0])
        t0 = time.perf_counter()
        time.sleep(DISPATCH_S)
        dispatch[i] = (t0, time.perf_counter())
        return TimedFetch(tree, FETCH_S, fetch, i)

    b = pkg.MicroBatcher(fn, max_batch=1, max_latency_ms=0.5, inflight=2, name="overlap").start()
    try:
        futs = [b.submit(np.array([float(i)])) for i in range(N_BATCHES)]
        vals = [float(np.asarray(f.result(timeout=30))[0]) for f in futs]
    finally:
        b.close()
    assert vals == [float(i) for i in range(N_BATCHES)]
    assert sorted(dispatch) == sorted(fetch) == list(range(N_BATCHES))

    def shared(a, c) -> float:
        return max(0.0, min(a[1], c[1]) - max(a[0], c[0]))

    later = {i: sum(shared(fetch[i], dispatch[j]) for j in range(i + 1, N_BATCHES)) for i in range(N_BATCHES)}
    overlap = sum(later.values())
    assert overlap >= 0.25 * N_BATCHES * (DISPATCH_S + FETCH_S), f"no dispatch/fetch overlap: {overlap:.3f} s"
    assert sum(v > 0 for v in later.values()) >= N_BATCHES // 2, later


def test_inflight_one_serializes_dispatch(pkg):
    b = pkg.MicroBatcher(sleepy_device_fn, max_batch=1, max_latency_ms=0.5, inflight=1, name="overlap-1").start()
    try:
        futs = [b.submit(np.array([float(i)])) for i in range(N_BATCHES)]
        t0 = time.perf_counter()
        for f in futs:
            f.result(timeout=30)
        wall = time.perf_counter() - t0
    finally:
        b.close()
    assert wall > 0.85 * N_BATCHES * (DISPATCH_S + FETCH_S)


def test_fault_fans_to_its_batch_only_with_inflight(pkg):
    b = pkg.MicroBatcher(lambda t, n: SlowFetch(t, 0.1), max_batch=1, max_latency_ms=1, inflight=3,
                         name="multi").start()
    f1 = b.submit(np.array([1.0]))
    time.sleep(0.04)
    pkg.faults.configure("batch_execute", times=1, match="multi")
    f2 = b.submit(np.array([2.0]))
    f3 = b.submit(np.array([3.0]))
    assert float(np.asarray(f1.result(timeout=5))[0]) == 1.0
    with pytest.raises(pkg.FaultInjected):
        f2.result(timeout=5)
    assert float(np.asarray(f3.result(timeout=5))[0]) == 3.0
    b.close()


def test_dead_fetch_worker_fails_loud(pkg):
    b = pkg.MicroBatcher(lambda t, n: KillFetch(t), max_batch=1, max_latency_ms=1, inflight=2,
                         name="dead-fetch").start()
    f1 = b.submit(np.zeros(1))
    time.sleep(0.05)
    f2 = b.submit(np.zeros(1))
    for f in (f2, f1):
        with pytest.raises(RuntimeError, match="fetch worker died"):
            f.result(timeout=5)
    b.close()


def test_close_settles_every_inflight_batch(pkg):
    b = pkg.MicroBatcher(lambda t, n: SlowFetch(t, 0.04), max_batch=1, max_latency_ms=1, inflight=4).start()
    futs = [b.submit(np.array([float(i)])) for i in range(6)]
    deadline = time.monotonic() + 5
    while (b.stats["batches"] + len(b._inflight)) < 2 and time.monotonic() < deadline:
        time.sleep(0.002)
    b.close()
    results = closed = 0
    for i, f in enumerate(futs):
        assert f.done()
        try:
            assert float(np.asarray(f.result(timeout=0))[0]) == float(i)
            results += 1
        except RuntimeError as e:
            assert "closed" in str(e)
            closed += 1
    assert results >= 2 and results + closed == 6


# -- the adaptive window, occupancy and staging arenas --------------------------------


def test_adaptive_window_controller(pkg):
    clock = FakeClock()
    w = pkg.B.AdaptiveWindow(max_batch=8, cap_s=0.050, fixed_s=0.005, clock=clock)
    assert w.window_s(1) == 0.005  # cold start: the fixed window
    for _ in range(16):
        w.observe()
        clock.advance(0.001)
    headroom = pkg.B.AdaptiveWindow.HEADROOM
    assert w.window_s(1) == pytest.approx(7 * 0.001 * headroom, rel=0.05)
    assert w.window_s(7) == pytest.approx(1 * 0.001 * headroom, rel=0.05)
    idle = pkg.B.AdaptiveWindow(max_batch=8, cap_s=0.005, fixed_s=0.005, clock=clock)
    for _ in range(4):
        idle.observe()
        clock.advance(1.0)
    assert idle.window_s(1) == 0.0


def test_saturating_producer_fills_batches(pkg):
    b = pkg.MicroBatcher(identity, max_batch=8, max_latency_ms=5, name="occ-t")
    futs = [b.submit(np.full((2,), i, np.float32)) for i in range(64)]
    b.start()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=10), np.full((2,), i))
    gauges = pkg.metrics.snapshot()["gauges"]["batch-occupancy:occ-t"]
    assert gauges["batches"] >= 8 and gauges["mean_fill_pct"] >= 80.0
    b.close()
    assert "batch-occupancy:occ-t" not in pkg.metrics.snapshot().get("gauges", {})


def test_rows_survive_arena_reuse_and_shape_changes(pkg):
    b = pkg.MicroBatcher(identity, max_batch=4, max_latency_ms=1, name="arena-t").start()
    futs = [b.submit({"a": np.full((3,), i, np.float32), "b": np.int32(i)}) for i in range(40)]
    for i, f in enumerate(futs):
        row = f.result(timeout=10)
        np.testing.assert_array_equal(row["a"], np.full((3,), i, np.float32))
        assert int(row["b"]) == i
    for size in range(2, 12):  # past the arena-key cap: the allocating fallback
        np.testing.assert_array_equal(b(np.full((size,), size, np.float32), timeout=10),
                                      np.full((size,), size, np.float32))
    b.close()


def test_ragged_shapes_still_raise_per_batch(pkg):
    b = pkg.MicroBatcher(identity, max_batch=2, max_latency_ms=50, name="arena-r", bisect_depth=0)
    f1, f2 = b.submit(np.zeros(2, np.float32)), b.submit(np.zeros(3, np.float32))
    b.start()
    errs = 0
    for f in (f1, f2):
        try:
            f.result(timeout=10)
        except Exception:  # noqa: BLE001 - both packages raise their stacking error
            errs += 1
    assert errs == 2
    b.close()


def test_adaptive_concurrent_callers_batch_together(pkg):
    calls = []

    def fn(tree, n):
        calls.append(n)
        return tree

    b = pkg.MicroBatcher(fn, max_batch=8, max_latency_ms=10, name="adapt-cc").start()
    results = [None] * 32
    barrier = threading.Barrier(8)

    def worker(wid):
        barrier.wait()
        for i in range(4):
            idx = wid * 4 + i
            results[idx] = b(np.full((2,), idx, np.float32), timeout=10)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for idx, row in enumerate(results):
        np.testing.assert_array_equal(row, np.full((2,), idx, np.float32))
    assert sum(calls) == 32 and len(calls) <= 24
    b.close()


# -- the port's own: torch tensors through stack, fetch and unstack --------------------


def test_tree_helpers_flatten_like_jax():
    tree = {"b": [np.zeros(2), (np.ones(1), None)], "a": np.arange(3), "c": {"z": 1.0, "y": np.int32(2)}}
    leaves, treedef = port_batcher.tree_flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(want) and all(x is y for x, y in zip(leaves, want))
    rebuilt = port_batcher.tree_unflatten(treedef, leaves)
    assert jax.tree_util.tree_structure(rebuilt) == jax.tree_util.tree_structure(tree)
    hash(treedef)  # arena keys hash it


def test_torch_results_come_back_as_numpy_rows():
    """A batch function returning torch CPU tensors (float32, bfloat16,
    int64) through the whole batcher: every caller gets host numpy rows
    of ITS item; bfloat16 comes back as float32 (numpy has none)."""

    def fn(tree, n):
        x = torch.from_numpy(np.asarray(tree["x"]))
        return {"f": x * 2, "h": x.to(torch.bfloat16), "i": x.long() + 1}

    b = port_batcher.MicroBatcher(fn, max_batch=4, max_latency_ms=5, name="torch-rows").start()
    try:
        futs = [b.submit({"x": np.full((3,), i, np.float32)}) for i in range(10)]
        for i, f in enumerate(futs):
            row = f.result(timeout=10)
            assert isinstance(row["f"], np.ndarray) and row["f"].dtype == np.float32
            np.testing.assert_array_equal(row["f"], np.full((3,), 2 * i, np.float32))
            assert row["h"].dtype == np.float32
            np.testing.assert_array_equal(row["h"], np.full((3,), i, np.float32))
            np.testing.assert_array_equal(row["i"], np.full((3,), i + 1, np.int64))
    finally:
        b.close()


def test_identity_torch_result_never_aliases_the_arena():
    """A CPU batch function that hands back its (staged) input as a tensor
    aliases the staging arena: the alias guard copies the rows out, so
    recycled arena slots never rewrite an answer already returned."""
    mesh = DeviceMesh([torch.device("cpu")], {"data": 1})
    b = port_batcher.MicroBatcher(port_batcher.mesh_sharded(lambda t, n: t, mesh), max_batch=2,
                                  max_latency_ms=1, name="torch-alias").start()
    try:
        rows = [b.submit(np.full((4,), i, np.float32)) for i in range(24)]
        rows = [f.result(timeout=10) for f in rows]
    finally:
        b.close()
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(row, np.full((4,), i, np.float32))


def test_stack_fetch_unstack_of_torch_trees():
    items = [{"px": np.full((2, 2), i, np.uint8), "ids": np.arange(3, dtype=np.int32) + i} for i in range(3)]
    stacked = port_batcher.stack_and_pad(items, 4)
    assert stacked["px"].shape == (4, 2, 2) and (stacked["px"][3] == 2).all()  # repeat-last padding
    mesh = DeviceMesh([torch.device("cpu")], {"data": 1})
    seen = {}

    def fn(tree, n):
        seen.update({k: (type(v), v.device) for k, v in tree.items()})
        return {"sum": tree["px"].float().sum(dim=(1, 2)), "ids": tree["ids"] * 2}

    out = port_batcher.mesh_sharded(fn, mesh)(stacked, 3)
    assert seen == {"px": (torch.Tensor, torch.device("cpu")), "ids": (torch.Tensor, torch.device("cpu"))}
    rows = port_batcher.unstack(out, 3)
    for i, row in enumerate(rows):
        assert row["sum"] == pytest.approx(4.0 * i)
        np.testing.assert_array_equal(row["ids"], (np.arange(3) + i) * 2)
    assert port_batcher.record_ready(out) is None  # host results need no event
    port_batcher.synchronize(out)  # and nothing to wait for
