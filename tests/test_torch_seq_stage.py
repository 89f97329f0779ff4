"""Serving meshes with a ``seq`` or ``stage`` axis, the port against the
JAX package on the CPU (the suite's eight forced CPU devices on the JAX
side, the CPU named once a device on the port's).

The JAX package sizes ``seq`` and ``stage`` like any non-``data`` axis,
replicates every weight over them (its placement rules name only
``model`` and ``expert``), splits a batch over ``data`` alone and runs no
ring attention, Ulysses or pipeline in serving: its copies give the
mesh-less answers. The port serves such a mesh with one copy a data place
(``runtime.mesh``), and is held to the JAX package's:

- (a) resolution: shape, devices used, the ``data`` degrade warning and
  the raise on a misfit, for a table of requests;
- (b) replica plans with ``LUMEN_REPLICAS_CLIP`` (``FleetPlan``'s
  replicas, devices a replica, each replica mesh's shape);
- (c) CLIP at ``{data: 2, seq: 2}`` and ``{seq: 2, stage: 2, data: -1}``:
  embeddings within ``EMBED_TOL`` and labels equal, each serving place
  running its part of a full batch, one copy a data place;
- (d) face at ``{data: 2, stage: 2}`` (held as
  ``tests/test_torch_data_serving.py`` holds it);
- (e) the VLM at ``{data: 2, seq: 2}``, ``{stage: 2, data: -1}`` and
  ``{seq: 2}``: the JAX manager's greedy tokens;
- (f) in gloo ranks (``tests/torch_spmd_ranks.py``'s ``seq_*`` cases): the
  VLM at ``{model: 2, seq: 2}`` and ``{data: 2, seq: 2, model: 2}`` and
  CLIP at the latter, on a group whose places are blocks of two ``seq``
  positions; ``serve()`` of ``{data: 2, seq: 2, model: 2}`` on eight
  devices starts two ranks whose places sit on devices ``[0, 1]`` and
  ``[4, 5]``;
- (g) CLIP at ``{seq: 2}`` and ``{stage: -1}``, meshes with no ``data``
  axis: the JAX manager fails as it builds its batcher (``P("data")``, a
  fault of the reference), the port serves the mesh-less embeddings.
"""

from __future__ import annotations

import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from lumen_tpu.models.clip import CLIPManager as JClip
from lumen_tpu.models.face import FaceManager as JFace
from lumen_tpu.models.vlm import VLMManager as JVlm
from lumen_tpu.models.vlm.chat import ChatMessage as JChatMessage
from lumen_tpu.runtime import fleet as jfleet, mesh as jmesh
from lumen_tpu_torch.models import face as tface
from lumen_tpu_torch.models.clip import CLIPManager as TClip
from lumen_tpu_torch.models.vlm import VLMManager as TVlm
from lumen_tpu_torch.models.vlm.chat import ChatMessage
from lumen_tpu_torch.runtime import fleet as tfleet, mesh as tmesh, tp_group
from lumen_tpu_torch.serving.server import start_tensor_parallel
from lumen_tpu_torch.core.config import validate_config_dict
from test_torch_face import assert_same_faces, port_configs
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture
from tests.clip_fixtures import make_clip_model_dir, png_bytes
from tests.test_face import make_face_model_dir
from tests.test_vlm import make_vlm_model_dir
from tests.torch_spmd_ranks import run_ranks

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs the simulated 8-device mesh")

CPU = torch.device("cpu")
HOST = [CPU] * 8
#: embeddings and label scores: the same float32 towers in two libraries
EMBED_TOL = 1e-5
#: CLIP embeddings across a model axis (``tests/test_torch_dp_tp.py``)
TP_TOL = 2e-5
BATCH = 8
PROMPT = "describe the image"
MAX_NEW = 12
TEXT = "a photo of a cat"
#: (a)'s table of requests, on eight devices
REQUESTS = [{"data": 2, "seq": 2}, {"seq": 2, "stage": 2, "data": -1}, {"data": 4, "seq": 4}, {"seq": 3},
            {"seq": 2}, {"stage": -1}]
#: the JAX warnings each request of the table draws: a prefix served, a
#: data axis degraded
WARNED = {"data=2,seq=2": 1, "data=4,seq=4": 1, "seq=2": 1}


def _id(axes: dict) -> str:
    return ",".join(f"{a}={s}" for a, s in axes.items())


@pytest.fixture(autouse=True)
def fixed_window(monkeypatch):
    """A fixed 200 ms collection window: the concurrent requests of a case
    fill one batch, so every place runs a part."""
    monkeypatch.setenv("LUMEN_BATCH_ADAPTIVE", "0")
    monkeypatch.delenv("LUMEN_REPLICAS", raising=False)
    monkeypatch.delenv("LUMEN_REPLICAS_CLIP", raising=False)


# -- (a) resolution and (b) replica plans -------------------------------------------


def _warnings(caplog, name: str) -> list[str]:
    return [r.getMessage() for r in caplog.records if r.name == name and r.levelno >= logging.WARNING]


@pytest.mark.parametrize("axes", REQUESTS, ids=_id)
def test_a_request_resolves_as_the_jax_mesh(axes, monkeypatch, caplog):
    monkeypatch.setattr(jmesh, "_degrade_warned", set())
    monkeypatch.setattr(tmesh, "_degrade_warned", set())
    results = []
    for build, devices in ((jmesh.build_mesh, jax.devices()[:8]), (tmesh.build_mesh, HOST)):
        try:
            results.append(build(dict(axes), devices=devices))
        except ValueError as e:
            results.append(e)
    want, got = results
    if isinstance(want, ValueError):
        assert isinstance(got, ValueError) and str(got) == str(want)
        return
    assert got.shape == dict(want.shape)
    assert len(got.devices) == want.devices.size
    warned = _warnings(caplog, "lumen_tpu.runtime.mesh")
    assert _warnings(caplog, "lumen_tpu_torch.runtime.mesh") == warned and len(warned) == WARNED.get(_id(axes), 0)
    # one copy a data place, at the first position of its block
    data = got.shape.get("data", 1)
    block = len(got.devices) // data
    assert got.span == block and len(got.data_devices) == data
    assert got.idle_devices == [i for i in range(len(got.devices)) if i % block]


def test_the_table_covers_a_degrade_and_a_misfit(caplog):
    """The table's third and fourth rows: ``{data: 4, seq: 4}`` degrades
    ``data`` to 2 with the JAX warning, ``{seq: 3}`` raises."""
    tmesh._degrade_warned.discard(f"{sorted({'data': 4, 'seq': 4}.items())}@8")
    with caplog.at_level(logging.WARNING, logger=tmesh.logger.name):
        assert tmesh.build_mesh({"data": 4, "seq": 4}, devices=HOST).shape == {"data": 2, "seq": 4}
    assert "degrading data axis 4 -> 2" in caplog.text
    with pytest.raises(ValueError, match="do not divide device count 8"):
        tmesh.build_mesh({"seq": 3}, devices=HOST)


@pytest.mark.parametrize("requested", ["2", "max"])
@pytest.mark.parametrize("axes", [{"seq": 2}, {"data": 2, "seq": 2}], ids=_id)
def test_replica_plans_equal_the_jax_plans(axes, requested, monkeypatch):
    monkeypatch.setenv("LUMEN_REPLICAS_CLIP", requested)
    want = jfleet.plan_replicas("clip", dict(axes), devices=jax.devices()[:8])
    got = tfleet.plan_replicas("clip", dict(axes), devices=HOST)
    for field in ("replicas", "devices_per_replica", "device_count", "requested"):
        assert getattr(got, field) == getattr(want, field), field
    assert [m.shape for m in got.meshes] == [dict(m.shape) for m in want.meshes]
    if requested == "2":
        assert got.meshes[0].shape == {"seq": 2, "data": 2} and got.devices_per_replica == 4


# -- (c), (d), (e), (g): one process, a copy a data place ---------------------------


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_seq_stage")
    face_dir, det_cfg, rec_cfg = make_face_model_dir(root / "face")
    vlm_dir = make_vlm_model_dir(root / "vlm")
    os.remove(os.path.join(vlm_dir, "tokenizer_config.json"))  # the plain transcript on both packages
    return {"clip": make_clip_model_dir(root / "clip"), "face": (face_dir, det_cfg, rec_cfg), "vlm": vlm_dir,
            "root": root}


def _concurrently(fn, items) -> list:
    with ThreadPoolExecutor(len(items)) as ex:
        return list(ex.map(fn, items))


def _count_parts(models) -> list:
    """Rows each place's vision tower runs, by a forward hook."""
    rows = [[] for _ in models]
    for i, m in enumerate(models):
        m.vision.register_forward_hook(lambda mod, args, out, i=i: rows[i].append(args[0].shape[0]))
    return rows


@pytest.mark.parametrize("axes", [{"data": 2, "seq": 2}, {"seq": 2, "stage": 2, "data": -1}], ids=_id)
def test_clip_embeddings_and_labels_equal_the_jax_manager(dirs, axes):
    kw = dict(dataset="Tiny", dtype="float32", batch_size=BATCH, max_batch_latency_ms=200, mesh_axes=axes)
    jm = JClip(dirs["clip"], **kw)
    tm = TClip(dirs["clip"], device="cpu", devices=HOST, **kw)
    jm.initialize()
    tm.initialize()
    try:
        assert tm.mesh.shape == dict(jm.mesh.shape)
        assert len(tm.mesh.devices) == jm.mesh.devices.size
        dp = tm.mesh.shape["data"]
        # one copy a data place; the block's other seq and stage positions hold none
        assert dp == 2 and len({id(m) for m in tm.place_models}) == dp and tm.model is tm.place_models[0]
        assert len(tm.mesh.idle_devices) == len(tm.mesh.devices) - dp
        assert tm._image_batcher.buckets == jm._image_batcher.buckets
        rows = _count_parts(tm.place_models)
        images = [png_bytes(seed=i, size=48) for i in range(BATCH)]
        got = _concurrently(tm.encode_image, images)
        want = _concurrently(jm.encode_image, images)
        assert rows == [[BATCH // dp]] * dp  # one full batch, a part a place
        np.testing.assert_allclose(np.stack(got), np.stack(want), atol=EMBED_TOL, rtol=0)
        texts = [f"a photo of thing {i}" for i in range(BATCH)]
        np.testing.assert_allclose(np.stack(_concurrently(tm.encode_text, texts)),
                                   np.stack(_concurrently(jm.encode_text, texts)), atol=EMBED_TOL, rtol=0)
        for t, j in zip(_concurrently(lambda b: tm.classify_image(b, top_k=3), images[:4]),
                        _concurrently(lambda b: jm.classify_image(b, top_k=3), images[:4])):
            assert [l for l, _ in t.labels] == [l for l, _ in j.labels]
            np.testing.assert_allclose([s for _, s in t.labels], [s for _, s in j.labels], atol=EMBED_TOL, rtol=0)
    finally:
        tm.close()
        jm.close()


def test_face_at_data_2_stage_2_equals_the_jax_manager(dirs):
    face_dir, det_cfg, rec_cfg = dirs["face"]
    tdet, trec = port_configs(det_cfg, rec_cfg)
    axes = {"data": 2, "stage": 2}
    jm = JFace(face_dir, dtype="float32", batch_size=4, max_batch_latency_ms=200, detector_cfg=det_cfg,
               embedder_cfg=rec_cfg, mesh_axes=axes)
    tm = tface.FaceManager(face_dir, dtype="float32", batch_size=4, max_batch_latency_ms=200, detector_cfg=tdet,
                           embedder_cfg=trec, mesh_axes=axes, device="cpu", devices=HOST)
    jm.initialize()
    tm.initialize()
    try:
        assert tm.mesh.shape == dict(jm.mesh.shape) == axes
        assert len({id(v) for v in tm.det_places}) == 2 and len({id(v) for v in tm.rec_places}) == 2
        assert tm._det_batcher.buckets == jm._det_batcher.buckets
        images = [png_bytes(seed=i, size=(96, 64, 128, 100)[i]) for i in range(4)]

        def detect(mgr):
            return lambda b: mgr.detect_and_extract(b, max_faces=3, conf_threshold=0.0)

        got, want = _concurrently(detect(tm), images), _concurrently(detect(jm), images)
        assert sum(len(f) for f in got) > 0
        for t, j in zip(got, want):
            assert_same_faces(t, j, embeddings=True)
    finally:
        tm.close()
        jm.close()


@pytest.mark.parametrize("axes", [{"data": 2, "seq": 2}, {"stage": 2, "data": -1}, {"seq": 2}], ids=_id)
def test_vlm_gives_the_jax_tokens(dirs, axes):
    kw = dict(dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32), gen_slots=2, gen_block=4)
    jm = JVlm(dirs["vlm"], mesh_axes=axes, **kw)
    jm.initialize()
    tm = TVlm.from_model_dir(dirs["vlm"], device="cpu", mesh_axes=axes, devices=HOST, **kw)
    try:
        assert tm.mesh.shape == dict(jm.mesh.shape)
        # one engine, on place 0, over the one copy of the model
        assert len(tm._engines) == 1 and tm.engine.gen.model is tm.model
        image = png_bytes(seed=3, size=40)
        for content, img in ((PROMPT, image), ("hello there", None)):
            j = jm.generate([JChatMessage(role="user", content=content)], image_bytes=img, max_new_tokens=10)
            t = tm.generate([ChatMessage(role="user", content=content)], image_bytes=img, max_new_tokens=10)
            assert t.tokens == list(j.tokens) and t.text == j.text and t.tokens
    finally:
        tm.close()
        jm.close()


@pytest.mark.parametrize("axes", [{"seq": 2}, {"stage": -1}], ids=_id)
def test_clip_without_a_data_axis_fails_in_jax_and_serves_in_the_port(dirs, axes):
    """A reference fault (ROADMAP C): the JAX ``CLIPManager`` builds such a
    mesh, then its image batcher's ``data_sharding`` makes ``P("data")``,
    which names an axis the mesh lacks, so ``initialize`` raises. The port
    serves the mesh as one data place: the JAX manager's mesh-less
    embeddings."""
    kw = dict(dataset="Tiny", dtype="float32", batch_size=BATCH, max_batch_latency_ms=20)
    jbroken, jplain = JClip(dirs["clip"], mesh_axes=axes, **kw), JClip(dirs["clip"], **kw)
    tm = TClip(dirs["clip"], device="cpu", devices=HOST, mesh_axes=axes, **kw)
    try:
        with pytest.raises(ValueError, match=r"Resource axis: data of PartitionSpec\('data',\) is not found in mesh"):
            jbroken.initialize()
        jplain.initialize()
        tm.initialize()
        image = png_bytes(seed=1, size=48)
        assert tm.mesh.shape == dict(jbroken.mesh.shape) and "data" not in tm.mesh.shape
        assert len(tm.place_models) == 1 and len(tm.mesh.idle_devices) == len(tm.mesh.devices) - 1
        np.testing.assert_allclose(tm.encode_image(image), jplain.encode_image(image), atol=EMBED_TOL, rtol=0)
        np.testing.assert_allclose(tm.encode_text(TEXT), jplain.encode_text(TEXT), atol=EMBED_TOL, rtol=0)
    finally:
        for mgr in (tm, jplain, jbroken):
            mgr.close()


# -- (f): beside a model axis, in gloo ranks ------------------------------------------


def test_serve_places_the_group_at_the_first_seq_position(monkeypatch):
    """``serve()``'s group for ``{data: 2, seq: 2, model: 2}`` on eight
    cards: two ranks, places on cards ``[0, 1]`` and ``[4, 5]``, each
    place's block the four cards from its first; 2, 3, 6 and 7 hold
    nothing."""
    spawned = {}

    def spawn(ranks, backend, expert=1, blocks=None):
        spawned.update(ranks=ranks, backend=backend, expert=expert, blocks=blocks)
        return "group"

    monkeypatch.setattr(tp_group.TPGroup, "spawn", staticmethod(spawn))
    monkeypatch.setattr(tp_group, "_current", None)
    cards = [torch.device("cuda", i) for i in range(8)]
    cfg = validate_config_dict(_serve_config_dict("/nonexistent", {"data": 2, "seq": 2, "model": 2}))
    assert start_tensor_parallel(cfg, CPU, tp_devices=cards, tp_backend="gloo") == "group"
    assert spawned["ranks"] == [[cards[0], cards[4]], [cards[1], cards[5]]]
    assert spawned["blocks"] == [cards[:4], cards[4:]]
    # a replica plan and a mesh over that group: one place each data place
    group = tp_group.TPGroup.__new__(tp_group.TPGroup)
    group.size, group.data, group.block, group.shape = 2, 2, 2, {"data": 2, "expert": 1, "model": 2}
    group.places, group.blocks = spawned["ranks"], spawned["blocks"]
    group._views = [type("Place", (), {"index": d, "tp": None, "ep": None})() for d in range(2)]
    monkeypatch.setattr(tp_group, "_current", group)
    mesh = tmesh.build_mesh({"data": 2, "seq": 2, "model": 2})
    assert mesh.shape == {"data": 2, "seq": 2, "model": 2} and [p.index for p in mesh.places] == [0, 1]
    assert mesh.data_devices == [cards[0], cards[4]] and mesh.idle_devices == [2, 3, 6, 7]
    one = tmesh.build_mesh({"model": 2, "seq": 2})  # the prefix: place 0's block
    assert one.shape == {"model": 2, "seq": 2} and one.devices == cards[:4] and [p.index for p in one.places] == [0]
    with pytest.raises(ValueError, match="not a multiple of the running group's blocks of 2"):
        tmesh.build_mesh({"data": -1, "model": 2})
    monkeypatch.setenv("LUMEN_REPLICAS_CLIP", "2")
    plan = tfleet.plan_replicas("clip", {"seq": 2, "model": 2})
    assert (plan.replicas, plan.devices_per_replica) == (2, 4)
    assert [[p.index for p in m.places] for m in plan.meshes] == [[0], [1]]
    assert [m.shape for m in plan.meshes] == [{"seq": 2, "model": 2, "data": 1}] * 2
    with pytest.MonkeyPatch.context() as mp:  # JAX's plan of the same request on eight devices
        mp.setenv("LUMEN_REPLICAS_CLIP", "2")
        jplan = jfleet.plan_replicas("clip", {"seq": 2, "model": 2}, devices=jax.devices()[:8])
    assert (jplan.replicas, jplan.devices_per_replica) == (2, 4)
    assert [dict(m.shape) for m in jplan.meshes] == [m.shape for m in plan.meshes]


def _serve_config_dict(vlm_dir, axes: dict, cache=None) -> dict:
    """A deployment of one VLM service on ``mesh: axes``."""
    if cache is not None:
        os.makedirs(cache / "models")
        os.symlink(vlm_dir, cache / "models" / "TinyVLM")
    return {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache or "/nonexistent")},
        "deployment": {"mode": "hub", "services": ["vlm"]},
        "server": {"port": 50996, "host": "127.0.0.1"},
        "services": {"vlm": {
            "enabled": True, "package": "lumen_tpu.models.vlm",
            "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
            "backend_settings": {"dtype": "float32", "batch_size": 2, "batch_buckets": [16, 32],
                                 "mesh": {"axes": axes}},
            "models": {"vlm": {"model": "TinyVLM", "runtime": "jax"}},
        }},
    }


@pytest.fixture(scope="module")
def group_runs(dirs, tmp_path_factory):
    """The port's ranks (started first, in the background) and the JAX
    managers' answers at the same meshes."""
    from lumen_tpu.models.clip.manager import CLIPManager as JCLIPManager

    image = np.frombuffer(png_bytes(0), np.uint8)
    meta = dict(vlm_dir=dirs["vlm"], clip_dir=dirs["clip"], prompt=PROMPT, max_new=MAX_NEW, text=TEXT)
    cases = {
        "group": ("seq_group", 2, {"meta": {**meta, "places": 2, "block": 2}, "image": image}),
        "serve": ("seq_serve", 1, {"meta": {**meta, "max_new": 8, "config": _serve_config_dict(
            dirs["vlm"], {"data": 2, "seq": 2, "model": 2}, dirs["root"] / "serve_cache")}}),
    }
    with ThreadPoolExecutor(1) as pool:  # one case's ranks at a time (two starting at once can race for a port)
        ranks = {tag: pool.submit(run_ranks, case, world, inputs, tmp_path_factory.mktemp(case), timeout=150)
                 for tag, (case, world, inputs) in cases.items()}
        want = {}
        kw = dict(dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32), gen_batch_size=2,
                  gen_batch_latency_ms=1.0, gen_slots=2, gen_block=4)
        for tag, axes in (("model_seq", {"model": 2, "seq": 2}), ("data_seq_model", {"data": 2, "seq": 2, "model": 2})):
            mgr = JVlm(dirs["vlm"], mesh_axes=axes, **kw)
            mgr.initialize()
            try:
                r = mgr.generate([JChatMessage(role="user", content=PROMPT)], max_new_tokens=MAX_NEW)
                want[tag] = (list(r.tokens), r.text, dict(mgr.mesh.shape))
            finally:
                mgr.close()
        mgr = JCLIPManager(dirs["clip"], dtype="float32", batch_size=2, mesh_axes={"data": 2, "seq": 2, "model": 2})
        mgr.initialize()
        try:
            want["clip"] = (mgr.encode_image(png_bytes(0)), mgr.encode_text(TEXT), dict(mgr.mesh.shape))
        finally:
            mgr.close()
        return want, {tag: f.result() for tag, f in ranks.items()}


@pytest.mark.parametrize("tag", ["model_seq", "data_seq_model"])
def test_vlm_beside_a_model_axis_gives_the_jax_tokens(group_runs, tag):
    want, outs = group_runs
    out = outs["group"][0]
    tokens, text, shape = want[tag]
    assert int(out["block"]) == 2
    assert json.loads(str(out[f"{tag}_shape"])) == shape
    assert out[f"{tag}_tokens"].tolist() == tokens and str(out[f"{tag}_text"]) == text
    places = [0] if tag == "model_seq" else [0, 1]
    assert out[f"{tag}_places"].tolist() == places
    # one engine, on place 0: the other place holds no copy and runs nothing
    assert out[f"{tag}_engines"].tolist() == [0]
    programs = out[f"{tag}_programs"]
    assert (programs[:, 0] > 0).all() and (programs[:, 1] == 0).all(), programs


def test_clip_beside_a_model_axis_equals_the_jax_manager(group_runs):
    want, outs = group_runs
    out = outs["group"][0]
    image, text, shape = want["clip"]
    assert json.loads(str(out["clip_shape"])) == shape == {"data": 2, "seq": 2, "model": 2}
    assert out["clip_places"].tolist() == [0, 1]  # a copy of the rank's shards a data place
    np.testing.assert_allclose(out["clip_image"], image, rtol=TP_TOL, atol=TP_TOL)
    np.testing.assert_allclose(out["clip_text"], text, rtol=TP_TOL, atol=TP_TOL)
    assert (out["clip_programs"] > 0).all(), out["clip_programs"]  # both places, on both ranks


def test_serve_with_data_2_seq_2_model_2_on_eight_devices(group_runs):
    """``serve()`` starts two ranks of two places, each place a block of
    four devices (two ``seq`` positions of two ranks), and the service
    answers on ``{data: 2, seq: 2, model: 2}`` with the JAX manager's
    tokens; ``stop`` ends the worker rank."""
    want, outs = group_runs
    out = outs["serve"][0]
    assert json.loads(str(out["group_shape"])) == {"data": 2, "expert": 1, "model": 2}
    assert out["group_layout"].tolist() == [2, 2, 2, 4]  # ranks, block, places, devices a place
    assert json.loads(str(out["vlm_shape"])) == {"data": 2, "seq": 2, "model": 2}
    assert out["vlm_places"].tolist() == [0, 1]
    assert out["vlm_tokens"].tolist() == want["data_seq_model"][0][:8]
    assert out["worker_codes"].tolist() == [0]
