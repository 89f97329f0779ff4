"""The port's replica fleet held against the JAX package's.

- ``plan_replicas`` over an explicit CPU device list plans the replica
  counts and slice sizes the JAX planner plans over the suite's 8 forced
  host devices (``LUMEN_REPLICAS_CLIP`` unset, 4, 3, ``max``, 8 on 4
  devices), each replica's mesh the JAX mesh's ``data`` shape over as
  many devices; a tensor-parallel axis without its group raises;
- ``build_fleet`` hands back the plain batcher for one replica and a
  ``ReplicaSet`` otherwise;
- a replica wedged past its watchdog goes down, its siblings serve, and
  the background revive brings it back (both packages);
- ``topology_extra`` has the JAX keys, with and without a fleet;
- ``EngineFleet`` (the OCR family's one-unit fleet, and one with a build
  hook): gauges, park to the floor of one, unpark and close (both
  packages).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import lumen_tpu.runtime.batcher as jax_batcher
import lumen_tpu.runtime.fleet as jax_fleet
import lumen_tpu.testing as jax_testing
import lumen_tpu.utils.deadline as jax_deadline
import lumen_tpu.utils.metrics as jax_metrics
import lumen_tpu_torch.runtime.batcher as port_batcher
import lumen_tpu_torch.runtime.fleet as port_fleet
import lumen_tpu_torch.testing as port_testing
import lumen_tpu_torch.utils.deadline as port_deadline
import lumen_tpu_torch.utils.metrics as port_metrics
from lumen_tpu_torch.runtime.mesh import DeviceMesh, build_mesh

CPU = torch.device("cpu")

PACKAGES = {
    "jax": (jax_batcher, jax_fleet, jax_testing, jax_deadline),
    "port": (port_batcher, port_fleet, port_testing, port_deadline),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    batcher, fleet, testing, deadline = PACKAGES[request.param]
    testing.faults.reset()
    yield SimpleNamespace(MicroBatcher=batcher.MicroBatcher, fleet=fleet, faults=testing.faults,
                          WatchdogTimeout=deadline.WatchdogTimeout)
    testing.faults.reset()


def make_build(pkg, name: str, watchdog_s: float = 0.0, builds: dict | None = None):
    """Batcher factory of a meshless fleet: doubles every row."""

    def build(rid, mesh):  # noqa: ARG001 - the fleet is mesh-agnostic below the planner
        if builds is not None:
            builds[rid] = builds.get(rid, 0) + 1
        return pkg.MicroBatcher(
            lambda tree, n: tree * 2, max_batch=4, max_latency_ms=1.0,
            name=pkg.fleet.batcher_name(name, rid), watchdog_s=watchdog_s,
            replica=None if rid is None else f"r{rid}",
        ).start()

    return build


@pytest.mark.parametrize("requested, n_devices", [(None, 8), ("4", 8), ("3", 8), ("max", 8), ("8", 4)])
def test_plan_matches_jax(monkeypatch, requested, n_devices):
    monkeypatch.delenv("LUMEN_REPLICAS", raising=False)
    if requested is None:
        monkeypatch.delenv("LUMEN_REPLICAS_CLIP", raising=False)
    else:
        monkeypatch.setenv("LUMEN_REPLICAS_CLIP", requested)
    want = jax_fleet.plan_replicas("clip", devices=jax.local_devices()[:n_devices])
    got = port_fleet.plan_replicas("clip", devices=[CPU] * n_devices)
    for field in ("family", "replicas", "policy", "device_count", "devices_per_replica", "requested"):
        assert getattr(got, field) == getattr(want, field), field
    # Each replica's mesh is a data axis over its slice, the JAX mesh's
    # shape ({"data": 8}, {"data": 2} x 4, ...) over as many devices.
    assert len(got.meshes) == got.replicas == len(want.meshes)
    for g, w in zip(got.meshes, want.meshes):
        assert g.shape == dict(w.shape) and g.devices == [CPU] * w.devices.size
        assert g.data_devices == [CPU] * w.shape["data"]


def test_parallel_axes_raise(monkeypatch):
    # An expert or model axis runs on an expert x model serving group;
    # without one it raises (never a replicated fallback), and so does one
    # larger than the host; seq and stage serve one copy a data place, as
    # JAX serves identical copies. A data axis beside such a group, and
    # replicas of one, need the group too.
    for axes in ({"model": 2}, {"expert": 2}, {"expert": 2, "model": 2}):
        with pytest.raises(RuntimeError, match="none is running"):
            build_mesh(axes, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        build_mesh({"model": 4}, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="needs 4 devices"):
        build_mesh({"expert": 2, "model": 2}, devices=[CPU] * 2)
    seq = build_mesh({"seq": 2}, devices=[CPU] * 2)
    assert seq.shape == {"seq": 2} and seq.data_devices == [CPU] and seq.idle_devices == [1]
    for axes in ({"data": 2, "model": 2}, {"data": -1, "expert": 2}):
        with pytest.raises(RuntimeError, match="none is running"):
            build_mesh(axes, devices=[CPU] * 4)
    with pytest.raises(RuntimeError, match="none is running"):
        port_fleet.plan_replicas("clip", {"model": 2}, devices=[CPU] * 4)
    monkeypatch.setenv("LUMEN_REPLICAS", "2")
    for axes in ({"model": 2}, {"expert": 2}):
        with pytest.raises(RuntimeError, match="none is running"):
            port_fleet.plan_replicas("clip", axes, devices=[CPU] * 4)
    assert build_mesh(devices=[CPU]).shape == {"data": 1}


def test_build_fleet_single_and_replica_set(monkeypatch):
    monkeypatch.delenv("LUMEN_REPLICAS", raising=False)
    pkg = SimpleNamespace(MicroBatcher=port_batcher.MicroBatcher, fleet=port_fleet)
    monkeypatch.delenv("LUMEN_REPLICAS_CLIP", raising=False)
    single = port_fleet.build_fleet(port_fleet.plan_replicas("clip", devices=[CPU]), "plain",
                                    make_build(pkg, "plain"))
    try:
        assert isinstance(single, port_batcher.MicroBatcher) and single.name == "plain"
        assert list(port_fleet.each_batcher(single)) == [single]
    finally:
        single.close()
    monkeypatch.setenv("LUMEN_REPLICAS_CLIP", "2")
    rs = port_fleet.build_fleet(port_fleet.plan_replicas("clip", devices=[CPU] * 2), "pair",
                                make_build(pkg, "pair"))
    try:
        assert isinstance(rs, port_fleet.ReplicaSet)
        assert [b.name for b in port_fleet.each_batcher(rs)] == ["pair-r0", "pair-r1"]
        for _ in range(6):
            assert float(rs(np.ones(1), timeout=10)[0]) == 2.0
        assert all(r.dispatches >= 1 for r in rs.replicas)  # round robin reached both
    finally:
        rs.close()


def test_wedged_replica_is_revived_after_its_watchdog(pkg):
    """r1's first batch hangs past its 0.15 s watchdog: r1 goes down,
    r0 keeps serving, and the background revive rebuilds r1 alone, which
    then serves again."""
    pkg.faults.configure("batch_hang", times=1, match="wedge-r1")
    builds: dict = {}
    rs = pkg.fleet.ReplicaSet("wedge", make_build(pkg, "wedge", watchdog_s=0.15, builds=builds), [None] * 2,
                              failures=3, revive_s=0.05)
    try:
        deadline = time.monotonic() + 20
        wedged = 0
        while builds.get(1, 0) < 2 and time.monotonic() < deadline:
            try:
                assert float(rs(np.ones(1), timeout=5)[0]) == 2.0
            except pkg.WatchdogTimeout:
                wedged += 1
        assert wedged >= 1 and builds == {0: 1, 1: 2}
        deadline = time.monotonic() + 10
        while rs.states()["r1"] != pkg.fleet.SERVING and time.monotonic() < deadline:
            time.sleep(0.02)
        assert rs.states() == {"r0": pkg.fleet.SERVING, "r1": pkg.fleet.SERVING}
        before = rs.replicas[1].dispatches
        for _ in range(6):
            assert float(rs(np.ones(1), timeout=5)[0]) == 2.0
        assert rs.replicas[1].dispatches > before
    finally:
        rs.close()


def test_topology_extra_keys_match(monkeypatch):
    monkeypatch.delenv("LUMEN_REPLICAS", raising=False)
    monkeypatch.delenv("LUMEN_REPLICAS_CLIP", raising=False)
    jplan = jax_fleet.plan_replicas("clip", devices=jax.local_devices()[:1])
    assert sorted(port_fleet.topology_extra(DeviceMesh([CPU], {"data": 1}))) == sorted(
        jax_fleet.topology_extra(jplan.meshes[0]))
    assert sorted(port_fleet.topology_extra(None)) == sorted(jax_fleet.topology_extra(None))
    pkgs = [SimpleNamespace(MicroBatcher=b.MicroBatcher, fleet=f) for b, f, *_ in PACKAGES.values()]
    sets = [p.fleet.ReplicaSet("topo", make_build(p, "topo"), [None] * 2, revive_s=0) for p in pkgs]
    try:
        jextra = jax_fleet.topology_extra(jplan.meshes[0], sets[0])
        textra = port_fleet.topology_extra(DeviceMesh([CPU], {"data": 1}), sets[1])
        assert sorted(textra) == sorted(jextra)
        for key in ("replicas", "replica_policy", "replica_states", "mesh_axes", "devices_per_replica"):
            assert textra[key] == jextra[key], key
        assert textra["device_count"] == "1"  # the CPU mesh's own devices
        assert port_fleet.replica_states_of(sets[1]) == jax_fleet.replica_states_of(sets[0])
    finally:
        for rs in sets:
            rs.close()


class _Engine:
    """A dispatch unit of an ``EngineFleet``: a name, a load, a close."""

    def __init__(self, name: str, load: int = 0):
        self.name, self._load, self.closed = name, load, False

    def load(self) -> int:
        return self._load

    def close(self) -> None:
        self.closed = True


@pytest.mark.parametrize("grows", [False, True], ids=["one-unit", "rebuildable"])
def test_engine_fleet_gauges_park_unpark_close(pkg, grows):
    """The fleet the OCR family registers (one unit, no build hook: never
    parked, never grown) and a rebuildable one: gauges, park to the floor
    of one, unpark through the hook, close, as in the JAX package."""
    metrics = (jax_metrics if pkg.fleet is jax_fleet else port_metrics).metrics
    name = f"engines-{'grow' if grows else 'one'}"
    units = [_Engine("e0", 3)] + ([_Engine("e1", 1)] if grows else [])
    fleet = pkg.fleet.EngineFleet(name, units, build=(lambda rid: _Engine(f"e{rid}-new")) if grows else None)
    try:
        gauges = metrics.snapshot()["gauges"][f"replica:{name}"]
        assert gauges["replicas"] == len(units) and gauges["parked"] == 0 and gauges["r0_load"] == 3
        assert fleet in pkg.fleet.live_fleets()
        if not grows:
            assert fleet.park() is None and fleet.unpark() is None  # the floor of one; no hook
            assert fleet.states() == {"r0": pkg.fleet.SERVING} and fleet.serving_engines() == units
            return
        assert fleet.park() == 1 and units[1].closed
        assert fleet.park() is None  # the floor of one
        assert fleet.states() == {"r0": pkg.fleet.SERVING, "r1": pkg.fleet.PARKED}
        assert metrics.snapshot()["gauges"][f"replica:{name}"]["parked"] == 1
        assert fleet.serving_engines() == [units[0]]
        assert fleet.unpark() == 1 and fleet.serving_engines()[1].name == "e1-new"
        assert fleet.active_count() == 2 and fleet.parked_count() == 0
    finally:
        fleet.close()
    assert all(u.closed for u in units[:1])
    assert f"replica:{name}" not in metrics.snapshot().get("gauges", {})
    assert fleet.park() is None and fleet.unpark() is None  # closed
