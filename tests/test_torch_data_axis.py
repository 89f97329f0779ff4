"""The port's ``data`` axis held against the JAX package's on the CPU.

- ``resolve_axes`` and ``build_mesh`` over the table of
  ``tests/test_runtime.py``: the port's mesh has the JAX mesh's shape over
  as many devices (a degraded axis on the prefix), and a data axis beside
  a ``model`` or ``expert`` axis raises, naming ROADMAP item 2d-ii;
- ``mesh_buckets`` equal, and ``mesh_sharded`` through both packages'
  ``MicroBatcher`` over ``{"data": 4}``: rows of a tree of several leaves
  come back in batch order, each part reaches its own place's callable
  although every place names the same device (state is kept by place
  index), and a batch that does not split evenly is refused with the
  JAX ``ValueError``;
- ``data_sharding`` splits like the JAX sharding, and
  ``parallel.sharding.replicate`` makes one copy a place;
- the H100 presets: detection by card count, larger presets first, and
  the mesh and global batches a generated config states.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import lumen_tpu.runtime.batcher as jbatcher
import lumen_tpu_torch.runtime.batcher as tbatcher
from lumen_tpu.runtime.mesh import build_mesh as jax_build_mesh, data_sharding as jax_data_sharding
from lumen_tpu.runtime.mesh import resolve_axes as jax_resolve_axes
from lumen_tpu_torch.app.config_gen import generate_config
from lumen_tpu_torch.app.presets import DETECTION_ORDER, PRESETS, detect_preset, supported_presets
from lumen_tpu_torch.parallel.sharding import replicate
from lumen_tpu_torch.runtime.mesh import build_mesh, data_sharding, local_batch_multiple, resolve_axes

CPU = torch.device("cpu")
H100_NAME = "NVIDIA H100 80GB HBM3"

#: (axes, devices): tests/test_runtime.py's table, and the fleet's shapes
MESH_TABLE = [
    ({"data": -1}, 8), ({"data": -1}, 1), ({"data": 8}, 4), ({"data": 3}, 8), ({"data": 4}, 8), ({"data": 2}, 8),
    ({"data": 6, "model": 2}, 8), ({"data": -1, "model": 2}, 8), ({"data": 4, "model": 2}, 8),
    ({"data": -1, "model": 3}, 8),
]


@pytest.mark.parametrize("axes, n", MESH_TABLE)
def test_mesh_resolves_as_jax(axes, n, monkeypatch):
    try:
        want = jax_resolve_axes(axes, n)
    except ValueError:
        with pytest.raises(ValueError):
            resolve_axes(axes, n)
        with pytest.raises(ValueError):
            build_mesh(axes, devices=[CPU] * n)
        return
    assert resolve_axes(axes, n) == want
    jmesh = jax_build_mesh(axes, devices=jax.devices()[:n])
    if any(s > 1 for a, s in want.items() if a != "data"):
        # A model axis serves on a running group, whose data places the
        # data axis resolves against (n devices: n / model places).
        with pytest.raises(RuntimeError, match="none is running"):
            build_mesh(axes, devices=[CPU] * n)
        from lumen_tpu_torch.runtime import tp_group
        from tests.torch_spmd_ranks import StandInGroup

        monkeypatch.setattr(tp_group, "_current", StandInGroup(n // want["model"], model=want["model"]))
    mesh = build_mesh(axes, devices=[CPU] * n)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.devices == [CPU] * jmesh.devices.size
    assert mesh.data_devices == [CPU] * jmesh.shape["data"]
    assert local_batch_multiple(mesh) == jmesh.shape["data"]


@pytest.mark.parametrize("max_batch, dp", [(8, 1), (8, 2), (8, 4), (6, 4), (3, 8), (64, 8), (256, 7)])
def test_mesh_buckets_equal(max_batch, dp):
    assert tbatcher.mesh_buckets(max_batch, dp) == jbatcher.mesh_buckets(max_batch, dp)


def _rows(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal(3).astype(np.float32), "k": np.array([i, -i], np.int32)} for i in range(n)]


def _submit_all(batcher, items) -> list:
    futs = [batcher.submit(item) for item in items]
    return [f.result(timeout=30) for f in futs]


@pytest.mark.parametrize("n_items", [8, 5])
def test_mesh_sharded_regathers_in_batch_order(monkeypatch, n_items):
    """Both packages' batchers over ``{"data": 4}`` (the JAX one on four
    of the suite's CPU devices, the port's on the CPU named four times):
    equal rows in submission order. Each port place's callable adds its
    own index, so a part that reached another place's callable, or ran
    twice, would show."""
    monkeypatch.setenv("LUMEN_BATCH_ADAPTIVE", "0")
    items = _rows(0, n_items)
    jmesh = jax_build_mesh({"data": 4}, devices=jax.devices()[:4])
    jb = jbatcher.MicroBatcher(
        jbatcher.mesh_sharded(lambda t, n: {"y": t["x"] * 2.0, "k": t["k"] + 1}, jmesh),
        max_batch=8, buckets=jbatcher.mesh_buckets(8, 4), max_latency_ms=200, name="jax-dp").start()
    mesh = build_mesh({"data": 4}, devices=[CPU] * 4)
    calls = []

    def place_fn(i):
        def fn(t, n):
            calls.append((i, tuple(t["x"].shape), n))
            return {"y": t["x"] * 2.0, "k": t["k"] + 1, "place": torch.full((len(t["x"]),), i)}

        return fn

    tb = tbatcher.MicroBatcher(tbatcher.mesh_sharded([place_fn(i) for i in range(4)], mesh), max_batch=8,
                               buckets=tbatcher.mesh_buckets(8, 4), max_latency_ms=200, name="port-dp").start()
    try:
        want = _submit_all(jb, items)
        got = _submit_all(tb, items)
    finally:
        jb.close()
        tb.close()
    per = 2  # the bucket of 8 (or 5 padded to 8) over 4 places
    assert sorted(calls) == [(i, (per, 3), max(0, min(per, n_items - i * per))) for i in range(4)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["y"], np.asarray(w["y"]))
        np.testing.assert_array_equal(g["k"], np.asarray(w["k"]))
        assert int(g["place"]) == i // per


def test_mesh_sharded_refuses_an_uneven_batch():
    tree = {"x": np.zeros((6, 3), np.float32)}
    jmesh = jax_build_mesh({"data": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        jbatcher.mesh_sharded(lambda t, n: t, jmesh)(tree, 6)
    with pytest.raises(ValueError, match="divisible by 4"):
        tbatcher.mesh_sharded(lambda t, n: t, build_mesh({"data": 4}, devices=[CPU] * 4))(tree, 6)
    with pytest.raises(ValueError, match="3 callables"):
        tbatcher.mesh_sharded([lambda t, n: t] * 3, build_mesh({"data": 4}, devices=[CPU] * 4))


def test_data_sharding_splits_as_jax():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    jmesh = jax_build_mesh({"data": 4}, devices=jax.devices()[:4])
    shards = sorted(jax.device_put(x, jax_data_sharding(jmesh)).addressable_shards, key=lambda s: s.index[0].start)
    parts = data_sharding(build_mesh({"data": 4}, devices=[CPU] * 4)).split({"x": x})
    assert len(parts) == len(shards) == 4
    for part, shard in zip(parts, shards):
        np.testing.assert_array_equal(part["x"], np.asarray(shard.data))


def test_replicate_makes_one_copy_a_place():
    mesh = build_mesh({"data": 3}, devices=[CPU] * 3)
    module = torch.nn.Linear(4, 2)
    copies = replicate(module, mesh)
    assert copies[0] is module and len({id(c) for c in copies}) == 3
    assert all(torch.equal(c.weight, module.weight) for c in copies)
    assert replicate(lambda d: ("made on", d), mesh) == [("made on", CPU)] * 3


@pytest.mark.parametrize("n, want", [(1, "cuda_h100_1"), (2, "cuda_h100_1"), (4, "cuda_h100_4"), (7, "cuda_h100_4"),
                                     (8, "cuda_h100_8"), (9, "cuda_h100_8")])
def test_presets_pick_the_largest_the_cards_cover(n, want):
    assert detect_preset("cuda", n, H100_NAME).name == want
    supported = [p.name for p in supported_presets("cuda", n, H100_NAME)]
    assert supported[0] == want and supported[-1] == "cpu"
    chips = [PRESETS[p].chips for p in supported[:-1]]
    assert chips == sorted(chips, reverse=True) and max(chips) == max(c for c in (1, 4, 8) if c <= n)
    preset = PRESETS[want]
    cfg = generate_config(want, tier="full")
    for name, svc in cfg.services.items():
        bs = svc.backend_settings
        assert bs.mesh.axes == {"data": -1} and bs.device == "cuda", name
        expected = {"clip": 64 * preset.chips, "face": 16 * preset.chips, "ocr": 8, "vlm": 8}[name]
        assert bs.batch_size == expected, (name, bs.batch_size)


def test_a_data_only_mesh_starts_no_serving_group():
    """``serve()``'s group is for ``expert``/``model`` axes: the 4-card
    preset's config (every service on ``{"data": -1}``) starts none and
    hands each service's mesh to its manager as written."""
    from lumen_tpu_torch.serving.server import start_tensor_parallel

    cfg = generate_config("cuda_h100_4", tier="full")
    assert start_tensor_parallel(cfg, CPU, tp_devices=[CPU] * 4) is None
    assert {name: svc.backend_settings.mesh.axes for name, svc in cfg.enabled_services().items()} == {
        name: {"data": -1} for name in cfg.enabled_services()}


def test_detection_order_is_larger_first():
    cards = [PRESETS[name].chips for name in DETECTION_ORDER if PRESETS[name].platform == "cuda"]
    assert cards == sorted(cards, reverse=True) and sorted(set(cards), reverse=True) == [8, 4, 1]
    assert DETECTION_ORDER[-1] == "cpu"
