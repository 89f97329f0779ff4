"""Serving over a ``data`` axis above an ``expert x model`` group, and
replicas of such a group: the port against the JAX package's mesh runs
(the counterparts of ``tests/test_serving_tp.py``, ``tests/test_fleet.py``
and ``tests/test_pipeline.py::TestIngestWithTpManager``).

The JAX side runs in the pytest process on the simulated 8-device CPU
mesh. The port runs in gloo ranks of a serving group whose every rank
drives two (or four) data places, each the CPU named again
(``tests/torch_spmd_ranks.py``'s ``dp_tp*`` cases); the same tiny model
directories in float32, at the tolerances of
``tests/test_torch_serving_tp.py``:

- CLIP (f32, int8 ``dynamic`` and ``dequant``) at ``{data: 2, model: 2}``:
  a model copy a place, every place's programs on both ranks;
- the VLM's greedy tokens and streamed text at ``{data: 2, model: 2}``
  (the continuous engine on place 0 alone, and the coalescer), and at
  ``{model: 2}`` with ``LUMEN_REPLICAS_VLM=2``: an engine a place, each
  serving a request, on ``{"data": 1, "model": 2}`` a replica;
- the MoE decoder at ``{data: 2, expert: 2, model: 2}``;
- the photo ingest over a TP-sharded CLIP and face at ``{data: 4, model:
  2}``: the record equals ``encode_image`` and the JAX pipeline's record;
- ``serve()`` with ``{"data": 4, "model": 2}`` on eight devices serves
  that shape (it degraded to ``data: 1`` before the places existed).

Unit tests (no ranks): the place layout, replica plans and mesh checks
over a stand-in running group, and the ``cuda_h100_8_dp_tp`` preset.
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

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu_torch.app.config_gen import generate_config
from lumen_tpu_torch.app.presets import DETECTION_ORDER, PRESETS, detect_preset, supported_presets
from lumen_tpu_torch.runtime import fleet, mesh as tmesh, tp_group
from lumen_tpu_torch.serving.server import start_tensor_parallel
from tests.clip_fixtures import make_clip_model_dir, png_bytes
from tests.test_face import make_face_model_dir
from tests.test_serving_tp import make_moe_model_dir
from tests.test_vlm import make_vlm_model_dir
from tests.torch_spmd_ranks import StandInGroup, run_ranks

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs the simulated 8-device mesh")

PROMPT = "describe the image"
MAX_NEW = 12
TEXT = "a photo of a cat"
MESH = {"data": 2, "model": 2}
CLIP_RUNS = {"f32": (None, None), "int8_dynamic": ("int8", "dynamic"), "int8_dequant": ("int8", "dequant")}
#: CLIP embeddings: the JAX test's own tolerance
TOL = 2e-5
#: face boxes in pixels, and embedding cosines (``tests/test_torch_ingest.py``)
PX, COSINE = 1e-3, 0.99999
H100_NAME = "NVIDIA H100 80GB HBM3"
CPU = torch.device("cpu")
#: the port's rank spawns run one after another beside the JAX managers of
#: the same fixture (ranks of two cases starting at once can race for a port)
_POOL = ThreadPoolExecutor(max_workers=1)


# -- the place layout, replica plans and mesh checks (no ranks) ---------------


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("expert", [1, 2])
@pytest.mark.parametrize("model", [1, 2])
def test_rank_places_follow_the_mesh_order(data, expert, model):
    """Rank ``r = e * model + m`` keeps its ``(e, m)`` place and drives
    device ``d * expert * model + r`` of each data place ``d``: the
    data-major order of ``DeviceMesh.devices``, whose ``data_devices`` are
    rank 0's."""
    ranks = expert * model
    devices = [torch.device("cuda", i) for i in range(data * ranks)]
    per_rank = tp_group.rank_devices(devices, ranks)
    assert [tp_group.rank_place(r, model) for r in range(ranks)] == [(e, m) for e in range(expert)
                                                                      for m in range(model)]
    for r in range(ranks):
        assert per_rank[r] == [devices[d * ranks + r] for d in range(data)]
    shape = {"data": data, "expert": expert, "model": model}
    assert tmesh.DeviceMesh(devices, shape).data_devices == per_rank[0]
    with pytest.raises(ValueError, match="not whole data places"):
        tp_group.rank_devices(devices + devices[:1], ranks) if ranks > 1 else tp_group.rank_devices([], 1)


@pytest.fixture
def group(monkeypatch):
    def running(data: int, expert: int = 1, model: int = 2) -> StandInGroup:
        g = StandInGroup(data, expert, model)
        monkeypatch.setattr(tp_group, "_current", g)
        return g

    return running


def test_a_data_axis_resolves_against_the_group_places(group):
    g = group(4)
    mesh = tmesh.build_mesh({"data": 4, "model": 2})
    assert mesh.shape == {"data": 4, "model": 2} and mesh.group is g
    assert [p.index for p in mesh.places] == [0, 1, 2, 3] and mesh.tp is g.place(0).tp
    full = tmesh.build_mesh({"data": -1, "model": 2})
    assert full.shape == {"data": 4, "model": 2} and len(full.devices) == 8
    one = tmesh.build_mesh({"model": 2})  # the prefix: place 0 alone, as JAX serves {model: 2} on 8 devices
    assert one.shape == {"model": 2} and [p.index for p in one.places] == [0]
    sliced = tmesh.build_mesh({"data": -1, "model": 2}, places=[2, 3])
    assert sliced.shape == {"data": 2, "model": 2} and [p.index for p in sliced.places] == [2, 3]
    assert sliced.data_devices == [g.places[0][2], g.places[0][3]]


def test_a_mismatched_running_group_still_raises(group):
    group(4)
    with pytest.raises(ValueError, match="do not match the running group"):
        tmesh.build_mesh({"model": 4})
    with pytest.raises(ValueError, match="do not match the running group"):
        tmesh.build_mesh({"data": 2, "expert": 2, "model": 2})
    with pytest.raises(ValueError, match="needs 16 devices"):
        tmesh.build_mesh({"expert": 2, "model": 8})
    seq = tmesh.build_mesh({"seq": 2, "model": 2})  # the prefix: place 0's block (places 0 and 1), place 1 idle
    assert seq.shape == {"seq": 2, "model": 2} and [p.index for p in seq.places] == [0]


@pytest.mark.parametrize("want, replicas, places", [("2", 2, [[0, 1], [2, 3]]), ("max", 4, [[0], [1], [2], [3]]),
                                                    ("1", 1, [[0, 1, 2, 3]])])
def test_replicas_of_a_group_take_contiguous_places(group, monkeypatch, want, replicas, places):
    """Each replica keeps the group's axes and a contiguous slice of its
    data places, the rest of its slice on ``data`` (JAX ``plan_replicas``:
    ``{"model": 2, "data": 1}`` a replica at ``max`` on 8 devices)."""
    group(4)
    monkeypatch.setenv("LUMEN_REPLICAS_CLIP", want)
    axes = {"data": -1, "model": 2} if want == "1" else {"model": 2}
    plan = fleet.plan_replicas("clip", axes)
    assert plan.replicas == replicas and plan.devices_per_replica == 8 // replicas
    assert [[p.index for p in m.places] for m in plan.meshes] == places
    data = 4 // replicas
    assert all(m.shape == ({"data": data, "model": 2}) for m in plan.meshes)


def test_a_replica_count_that_does_not_divide_the_places_degrades(group, monkeypatch, caplog):
    group(4)
    monkeypatch.setenv("LUMEN_REPLICAS_FACE", "3")
    monkeypatch.setattr(fleet, "_clamp_warned", set())
    with caplog.at_level(logging.WARNING, logger=fleet.logger.name):
        plan = fleet.plan_replicas("face", {"data": -1, "model": 2})
    assert plan.replicas == 2 and "degrading to 2 replica(s)" in caplog.text
    # the JAX plan of the same request on 8 devices
    from lumen_tpu.runtime.fleet import plan_replicas as jplan

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_REPLICAS_FACE", "3")
        assert jplan("face", {"data": -1, "model": 2}).replicas == plan.replicas


def test_serve_resolves_the_data_axis_before_a_rank_starts(group, tmp_path):
    """The ``dp_tp`` preset's config over eight devices needs a group of
    four places; a running group of that shape is used (and one of its
    axes when no devices are named), one of another shape refuses (it
    would start a second group)."""
    cfg = generate_config("cuda_h100_8_dp_tp", tier="full")
    group(4)
    assert start_tensor_parallel(cfg, CPU, tp_devices=[CPU] * 8) is None
    assert start_tensor_parallel(cfg, CPU) is None  # no devices named: the running group's places
    group(1)
    with pytest.raises(RuntimeError, match="already running"):
        start_tensor_parallel(cfg, CPU, tp_devices=[CPU] * 8, tp_backend="gloo")


def test_the_dp_tp_preset_comes_after_the_data_parallel_one():
    assert PRESETS["cuda_h100_8_dp_tp"].mesh_axes == {"data": -1, "model": 2}
    assert PRESETS["cuda_h100_8_dp_tp"].chips == 8
    assert DETECTION_ORDER.index("cuda_h100_8_dp_tp") == DETECTION_ORDER.index("cuda_h100_8") + 1
    supported = [p.name for p in supported_presets("cuda", 8, H100_NAME)]
    assert supported[:2] == ["cuda_h100_8", "cuda_h100_8_dp_tp"]
    assert "cuda_h100_8_dp_tp" not in [p.name for p in supported_presets("cuda", 4, H100_NAME)]
    assert detect_preset("cuda", 8, H100_NAME).name == "cuda_h100_8"
    cfg = generate_config("cuda_h100_8_dp_tp", tier="full")  # selectable by name
    for name, svc in cfg.services.items():
        bs = svc.backend_settings
        assert bs.mesh.axes == {"data": -1, "model": 2} and bs.device == "cuda", name
        # CLIP and face batches over the four data places (JAX _tpu_preset: chips // model)
        assert bs.batch_size == {"clip": 64 * 4, "face": 16 * 4, "ocr": 8, "vlm": 8}[name], name


# -- the port in gloo ranks against the JAX managers ----------------------------


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dp_tp")

    def decoders():
        vlm = make_vlm_model_dir(root / "vlm")
        os.remove(os.path.join(vlm, "tokenizer_config.json"))  # the plain transcript on both packages
        return vlm, make_moe_model_dir(root / "moe")

    with ThreadPoolExecutor(1) as ex:  # the two slow directories at once
        made = ex.submit(decoders)
        clip = make_clip_model_dir(root / "clip")
        face_dir, det_cfg, rec_cfg = make_face_model_dir(root / "face")
        vlm, moe = made.result()
    return {"vlm": vlm, "moe": moe, "clip": clip, "face": (face_dir, det_cfg, rec_cfg), "root": root}


def _jax_vlm(model_dir, **kw):
    mgr = JVLMManager(model_dir, dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32),
                      gen_batch_size=2, gen_batch_latency_ms=1.0, **kw)
    mgr.initialize()
    return mgr


def _jax_generate(model_dir, mesh_axes, **kw):
    mgr = _jax_vlm(model_dir, mesh_axes=mesh_axes, **kw)
    try:
        r = mgr.generate([JChatMessage(role="user", content=PROMPT)], max_new_tokens=MAX_NEW)
        return list(r.tokens), r.text
    finally:
        mgr.close()


def _serve_config(dirs) -> dict:
    """A deployment of one CLIP service on ``mesh: {data: 4, model: 2}``."""
    cache = dirs["root"] / "serve_cache"
    os.makedirs(cache / "models")
    os.symlink(dirs["clip"], cache / "models" / "TinyCLIP")
    return {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache)},
        "deployment": {"mode": "hub", "services": ["clip"]},
        "server": {"port": 50997, "host": "127.0.0.1"},
        "services": {"clip": {
            "enabled": True, "package": "lumen_tpu.models.clip",
            "import_info": {"registry_class": "lumen_tpu.serving.services.clip_service.ClipService"},
            "backend_settings": {"dtype": "float32", "batch_size": 4, "mesh": {"axes": {"data": 4, "model": 2}}},
            "models": {"clip": {"model": "TinyCLIP", "runtime": "jax"}},
        }},
    }


def _ingest_items() -> list:
    return [png_bytes(seed=5)] * 3 + [png_bytes(seed=i, size=(96, 64, 128)[i % 3]) for i in range(5)] + [b"bad"]


@pytest.fixture(scope="module")
def runs(dirs, tmp_path_factory):
    """The port's ranks (started first, in the background) and the JAX
    managers' answers at the same meshes."""
    from lumen_tpu.models.clip.manager import CLIPManager as JCLIPManager
    from lumen_tpu.models.face import FaceManager as JFace
    from lumen_tpu.pipeline.photo import PhotoIngestPipeline as JPipeline

    face_dir, det_cfg, rec_cfg = dirs["face"]
    items = _ingest_items()
    image = np.frombuffer(png_bytes(0), np.uint8)
    meta = dict(vlm_dir=dirs["vlm"], moe_dir=dirs["moe"], clip_dir=dirs["clip"], face_dir=face_dir,
                prompt=PROMPT, max_new=MAX_NEW, text=TEXT)
    cases = {
        "dp_tp": ("dp_tp", 2, {"meta": {**meta, "places": 2}, "image": image}),
        "moe": ("dp_tp_moe", 4, {"meta": {**meta, "places": 2, "expert": 2}}),
        "ingest": ("dp_tp_ingest", 2, {"meta": {**meta, "places": 4}, "n_items": np.asarray(len(items)),
                                       **{f"item_{i}": np.frombuffer(b, np.uint8) for i, b in enumerate(items)}}),
        "serve": ("dp_tp_serve", 1, {"meta": {"config": _serve_config(dirs)}, "image": image}),
    }
    ranks = {tag: _POOL.submit(run_ranks, case, world, inputs, tmp_path_factory.mktemp(case), timeout=150)
             for tag, (case, world, inputs) in cases.items()}
    want = {}
    for tag, (quant, kernel) in CLIP_RUNS.items():
        with pytest.MonkeyPatch.context() as mp:
            if kernel:
                mp.setenv("LUMEN_Q8_KERNEL", kernel)
            mgr = JCLIPManager(dirs["clip"], dtype="float32", batch_size=2, mesh_axes=MESH, quantize=quant)
            mgr.initialize()
        try:
            want[f"clip_{tag}"] = (mgr.encode_image(png_bytes(0)), mgr.encode_text(TEXT))
        finally:
            mgr.close()
    for tag, kw in (("continuous", {"scheduler": "continuous", "gen_slots": 2, "gen_block": 4}),
                    ("coalesce", {"scheduler": "coalesce"})):
        want[f"vlm_{tag}"] = _jax_generate(dirs["vlm"], MESH, **kw)
    want["moe"] = _jax_generate(dirs["moe"], {"data": 2, "expert": 2, "model": 2}, gen_slots=2, gen_block=4)
    axes = {"data": 4, "model": 2}
    clip = JCLIPManager(dirs["clip"], dtype="float32", batch_size=4, mesh_axes=axes)
    face = JFace(face_dir, dtype="float32", batch_size=4, detector_cfg=det_cfg, embedder_cfg=rec_cfg, mesh_axes=axes)
    clip.initialize()
    face.initialize()
    try:
        pipe = JPipeline(clip.mesh, clip=clip, face=face, batch_size=8, on_decode_error="record")
        want["ingest"] = list(pipe.run(items))
    finally:
        face.close()
        clip.close()
    return want, {tag: f.result() for tag, f in ranks.items()}


@pytest.mark.parametrize("tag", list(CLIP_RUNS))
def test_clip_at_data_2_model_2_matches_jax(runs, tag):
    want, outs = runs
    out = outs["dp_tp"][0]
    assert json.loads(str(out[f"clip_{tag}_shape"])) == MESH
    assert out[f"clip_{tag}_places"].tolist() == [0, 1]  # a copy of the rank's shards a place
    np.testing.assert_allclose(out[f"clip_{tag}_image"], want[f"clip_{tag}"][0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out[f"clip_{tag}_text"], want[f"clip_{tag}"][1], rtol=TOL, atol=TOL)
    # both ranks ran programs at both places (placement, and a part of each batch)
    programs = out[f"clip_{tag}_programs"]
    assert programs.shape == (2, 2) and (programs > 0).all(), programs


@pytest.mark.parametrize("tag", ["continuous", "coalesce"])
def test_vlm_at_data_2_model_2_matches_jax(runs, tag):
    want, outs = runs
    out = outs["dp_tp"][0]
    tokens, text = want[f"vlm_{tag}"]
    assert json.loads(str(out[f"vlm_{tag}_shape"])) == MESH
    assert out[f"vlm_{tag}_tokens"].tolist() == tokens
    assert str(out[f"vlm_{tag}_text"]) == text and str(out[f"vlm_{tag}_stream"]) == text
    if tag == "continuous":
        # one engine, on place 0; the other place holds no copy and runs nothing
        assert out["vlm_continuous_engines"].tolist() == [0]
        assert out["vlm_continuous_programs"][:, 1].tolist() == [0, 0]


def test_vlm_replicas_of_a_group_each_serve(runs):
    """``LUMEN_REPLICAS_VLM=2`` at ``{model: 2}`` over the four devices of
    two places: an engine a place, ``{"data": 1, "model": 2}`` a replica
    (JAX ``plan_replicas`` of the same request on as many devices), and
    each engine's request the JAX manager's tokens."""
    from lumen_tpu.runtime.fleet import plan_replicas as jplan

    want, outs = runs
    out = outs["dp_tp"][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_REPLICAS_VLM", "2")
        jshapes = [dict(m.shape) for m in jplan("vlm", {"model": 2}, devices=jax.devices()[:4]).meshes]
    assert json.loads(str(out["replica_shapes"])) == jshapes == [{"model": 2, "data": 1}] * 2
    assert out["replica_places"].tolist() == [0, 1]
    tokens, text = want["vlm_continuous"]
    for i in range(2):
        assert out[f"replica_{i}_tokens"].tolist() == tokens, i
        assert str(out[f"replica_{i}_text"]) == text and str(out[f"replica_{i}_stream"]) == text, i
        # the engine's place ran its programs on both ranks; place 0 also
        # prepares every request (as the JAX manager prepares on replica 0)
        programs = out[f"replica_{i}_programs"]
        assert (programs[:, i] > 0).all(), (i, programs)
    assert (out["replica_0_programs"][:, 1] == 0).all()


def test_moe_at_data_2_expert_2_model_2_matches_jax(runs):
    want, outs = runs
    out = outs["moe"][0]
    assert json.loads(str(out["continuous_shape"])) == {"data": 2, "expert": 2, "model": 2}
    assert out["continuous_tokens"].tolist() == want["moe"][0]
    assert str(out["continuous_text"]) == want["moe"][1] == str(out["continuous_stream"])


def test_ingest_over_a_tp_sharded_clip_matches_jax(runs):
    """The twin of ``TestIngestWithTpManager`` at ``{data: 4, model: 2}``:
    the ingest record of the repeated photo equals ``encode_image`` (the
    JAX test's atol) and every record the JAX pipeline's; face on the same
    mesh runs on rank 0's devices of the four places, its weights whole."""
    want, outs = runs
    out = outs["ingest"][0]
    assert json.loads(str(out["shapes"])) == [{"data": 4, "model": 2}] * 2
    assert out["clip_places"].tolist() == [0, 1, 2, 3]
    assert json.loads(str(out["face_devices"])) == ["cpu"] * 4
    np.testing.assert_allclose(out["clip_embedding"][0], out["direct"], atol=TOL)
    faces = json.loads(str(out["faces"]))
    n_faces = 0
    for i, j in enumerate(want["ingest"]):
        assert bool(out["errors"][i]) == bool(j.error), i
        if j.error:
            continue
        np.testing.assert_allclose(out["clip_embedding"][i], j.clip_embedding, atol=TOL, rtol=0)
        assert len(faces[i]) == len(j.faces), i
        for tf, jf in zip(faces[i], j.faces):
            np.testing.assert_allclose(tf["bbox"], jf.bbox, atol=PX)
            assert float(np.dot(tf["embedding"], jf.embedding)) >= COSINE
        n_faces += len(j.faces)
    assert n_faces > 0 and out["errors"][-1]
    assert (out["programs"] > 0).all(), out["programs"]  # every place's part, on both ranks


def test_serve_with_data_4_model_2_on_eight_devices(runs):
    """``serve()`` with ``mesh: {data: 4, model: 2}`` and eight devices:
    a group of two ranks of four places, the service on ``{"data": 4,
    "model": 2}`` (not the ``data: 1`` a group of two devices left it),
    its embedding the JAX manager's, and ``stop`` ends the worker rank."""
    want, outs = runs
    out = outs["serve"][0]
    assert json.loads(str(out["clip_shape"])) == {"data": 4, "model": 2}
    assert json.loads(str(out["group_shape"])) == {"data": 4, "expert": 1, "model": 2}
    np.testing.assert_allclose(out["clip_image"], want["clip_f32"][0], rtol=TOL, atol=TOL)
    programs = out["place_programs"]
    assert programs.shape == (2, 4) and (programs > 0).all(), programs
    assert out["worker_codes"].tolist() == [0]
