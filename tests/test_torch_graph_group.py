"""Exported (ONNX) vision towers beside a ``model`` axis: the port in gloo
ranks against the JAX package's managers on the simulated 8-device CPU
mesh (the graph-tower twins of ``tests/test_torch_dp_tp.py``).

The port runs in the ranks of a serving group whose every rank drives two
data places, each the CPU named again (``tests/torch_spmd_ranks.py``'s
``graph_*`` cases), on the directories of ``tests/test_torch_vlm_graph.py``
(``make_fastvlm_dir``: a decoder-only checkpoint beside
``onnx/vision_encoder.onnx``; the JAX suite's ``make_fastvlm_style_dir``)
and ``tests/test_torch_clip_graph.py`` (export-only CLIP towers), in
float32, at those files' tolerances:

- the VLM's greedy tokens and streamed text at ``{model: 2}`` (continuous
  engine, coalescer, int8 on the dequant route), at ``{data: 2, model:
  2}``, and with ``LUMEN_REPLICAS_VLM=2`` (each engine serving), equal to
  the JAX manager's at the same mesh; the tower on rank 0 alone;
- the splice program's output equal on both ranks and to the mesh-less
  port's prepare step;
- graph CLIP at ``{data: 2, model: 2}`` and with ``LUMEN_REPLICAS_CLIP=2``
  at ``{model: 2}``, equal to the JAX manager's at the same mesh (where the
  JAX manager serves it: ROADMAP C), with no program of the group run;
- ``serve()`` of the ``cuda_h100_8_dp_tp`` preset's full tier, its
  directories graph-tower stand-ins under the catalog names, on eight
  places: every service up, none degraded; and of its graph ``clip`` block
  alone, whose group then runs no program: healthy, and it stops.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke
from lumen_tpu.models.clip import CLIPManager as JCLIPManager
from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu_torch.app.config_gen import generate_config
from tests.clip_fixtures import png_bytes as clip_png
from tests.test_clip_graph import make_export_dir
from tests.test_face_graph import make_graph_face_model_dir
from tests.test_ocr_graph import make_graph_ocr_model_dir
from tests.test_torch_clip_graph import ATOL, COSINE
from tests.test_torch_vlm_graph import FAST_IMG, make_fastvlm_dir
from tests.test_vlm import png_bytes
from tests.test_vlm_vision_graph import make_fastvlm_style_dir
from tests.torch_spmd_ranks import run_ranks

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs the simulated 8-device mesh")

PROMPT = "describe <image>"
MAX_NEW = 8
TEXT = "a photo of a cat"
N_IMAGES = 2
#: the splice program against the mesh-less prepare step, and across ranks
SPLICE_ATOL = 1e-6
VLM_RUNS = {"model2": ({"model": 2}, {"scheduler": "continuous", "gen_slots": 2, "gen_block": 4}),
            "coalesce": ({"model": 2}, {"scheduler": "coalesce"}),
            "int8": ({"model": 2}, {"quantize": "int8"}),
            "data2": ({"data": 2, "model": 2}, {"scheduler": "continuous", "gen_slots": 2, "gen_block": 4})}


def _images() -> list[bytes]:
    return [png_bytes(FAST_IMG, seed=10 + i) for i in range(N_IMAGES)]


def _jax_vlm(model_dir, mesh_axes, images, **kw) -> list:
    mgr = JVLMManager(model_dir, dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32),
                      gen_batch_size=2, gen_batch_latency_ms=1.0, mesh_axes=mesh_axes, **kw)
    mgr.initialize()
    try:
        return [(list(r.tokens), r.text) for r in (
            mgr.generate([JChatMessage(role="user", content=PROMPT)], image_bytes=image, max_new_tokens=MAX_NEW)
            for image in images)]
    finally:
        mgr.close()


def _jax_clip(model_dir, mesh_axes) -> tuple:
    mgr = JCLIPManager(model_dir, dtype="float32", batch_size=2, mesh_axes=mesh_axes)
    mgr.initialize()
    try:
        return mgr.encode_image(clip_png(seed=0)), mgr.encode_text(TEXT)
    finally:
        mgr.close()


def _preset_config(cache: Path) -> dict:
    """``generate_config("cuda_h100_8_dp_tp", tier="full")`` moved to the
    CPU in float32, loopback, no mDNS."""
    raw = generate_config("cuda_h100_8_dp_tp", tier="full", cache_dir=str(cache)).model_dump(exclude_none=True)
    assert sorted(raw["services"]) == ["clip", "face", "ocr", "vlm"]
    for svc in raw["services"].values():
        svc["backend_settings"].update(dtype="float32", device="cpu")
        assert svc["backend_settings"]["mesh"]["axes"] == {"data": -1, "model": 2}
    raw["server"].update(host="127.0.0.1", mdns={"enabled": False})
    return raw


def _preset_cache(root: Path, vlm: str, clip: str) -> Path:
    """A model cache holding graph-tower stand-ins under the preset's
    catalog names."""
    cache = root / "preset_cache"
    models = cache / "models"
    models.mkdir(parents=True)
    for name, src in (("FastVLM-0.5B", vlm), ("MobileCLIP2-S2", clip),
                      ("buffalo_l", make_graph_face_model_dir(root / "face")),
                      ("PP-OCRv5_mobile", make_graph_ocr_model_dir(root / "ocr"))):
        chip_smoke.link_model_dir(Path(src), models / name, "jax")
    return cache


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks (started first, in the background, one case after
    the other; the face and OCR directories of the preset's tier are made
    between them) and the JAX managers' answers at the same meshes."""
    root = tmp_path_factory.mktemp("torch_graph_group")
    vlm, style = make_fastvlm_dir(root / "fast"), make_fastvlm_style_dir(root / "style")
    clip, _, _ = make_export_dir(root / "clip")
    images = _images()
    canvas = np.random.RandomState(7).randint(0, 256, (FAST_IMG, FAST_IMG, 3)).astype(np.uint8)
    clip_image = np.frombuffer(clip_png(seed=0), np.uint8)
    meta = dict(vlm_dir=vlm, style_dir=style, clip_dir=clip, prompt=PROMPT, max_new=MAX_NEW, text=TEXT)
    group_inputs = {"meta": {**meta, "places": 2}, "n_images": np.asarray(N_IMAGES), "canvas": canvas,
                    "clip_image": clip_image, **{f"image_{i}": np.frombuffer(b, np.uint8) for i, b in enumerate(images)}}

    def ranks():
        group = run_ranks("graph_group", 2, group_inputs, root / "graph_group", timeout=240)
        config = _preset_config(_preset_cache(root, vlm, clip))
        clip_only = {**config, "deployment": {**config["deployment"], "services": ["clip"]},
                     "services": {"clip": config["services"]["clip"]}}
        serve_inputs = {"meta": {"config": config, "clip_config": clip_only, "prompt": PROMPT, "max_new": 4},
                        "image": np.frombuffer(images[0], np.uint8), "clip_image": clip_image}
        return {"group": group, "serve": run_ranks("graph_serve", 1, serve_inputs, root / "graph_serve", timeout=240)}

    with ThreadPoolExecutor(max_workers=1) as ex:
        port = ex.submit(ranks)
        want = {tag: _jax_vlm(vlm, mesh, images, **kw) for tag, (mesh, kw) in VLM_RUNS.items()}
        want["style"] = _jax_vlm(style, {"model": 2}, images[:1], gen_slots=2, gen_block=4)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LUMEN_REPLICAS_VLM", "2")
            want["replicas"] = _jax_vlm(vlm, {"model": 2}, images[:1], gen_slots=2, gen_block=4)
        want["clip_data2"] = _jax_clip(clip, {"data": 2, "model": 2})
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LUMEN_REPLICAS_CLIP", "2")
            want["clip_r2"] = _jax_clip(clip, {"model": 2})
        want["clip_meshless"] = _jax_clip(clip, None)
        return want, port.result()


def assert_same_vectors(t, j) -> None:
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= ATOL
    assert float(np.dot(t, j) / (np.linalg.norm(t) * np.linalg.norm(j))) >= COSINE


@pytest.mark.parametrize("tag", list(VLM_RUNS) + ["style"])
def test_graph_vlm_tokens_match_jax_at_the_mesh(runs, tag):
    """Greedy tokens, text and streamed text equal the JAX manager's at the
    same mesh; no rank's model holds a vision tower, and the tower's
    weights are on rank 0's device."""
    want, outs = runs
    out = outs["group"][0]
    mesh = VLM_RUNS[tag][0] if tag in VLM_RUNS else {"model": 2}
    assert json.loads(str(out[f"{tag}_shape"])) == mesh
    for i, (tokens, text) in enumerate(want[tag]):
        assert out[f"{tag}_{i}_tokens"].tolist() == tokens, i
        assert str(out[f"{tag}_{i}_text"]) == text == str(out[f"{tag}_{i}_stream"]), i
    assert out[f"{tag}_no_vision"].tolist() == [True, True]
    assert str(out[f"{tag}_tower_device"]) == "cpu"


def test_the_images_condition_the_tokens(runs):
    """The two photos give different greedy tokens (on both packages), so
    equal tokens hold the tower's output, not only the decoder's."""
    want, outs = runs
    assert want["model2"][0][0] != want["model2"][1][0]
    out = outs["group"][0]
    assert out["model2_0_tokens"].tolist() != out["model2_1_tokens"].tolist()


def test_the_splice_program_equals_the_meshless_prepare_step(runs):
    """Rank 0's output of the splice program equals the mesh-less port's
    prepare step on the same pixels, and rank 1's handle equals rank 0's."""
    _, outs = runs
    out = outs["group"][0]
    assert out["splice_0"].shape == out["splice_meshless"].shape
    np.testing.assert_allclose(out["splice_0"], out["splice_meshless"], atol=SPLICE_ATOL, rtol=0)
    np.testing.assert_allclose(out["splice_1"], out["splice_0"], atol=SPLICE_ATOL, rtol=0)


def test_graph_vlm_replicas_of_a_group_each_serve(runs):
    """``LUMEN_REPLICAS_VLM=2`` at ``{model: 2}`` over two places: an engine
    a place, each engine's request the JAX manager's tokens, its place's
    programs run on both ranks (place 0 prepares every request)."""
    want, outs = runs
    out = outs["group"][0]
    assert out["replica_places"].tolist() == [0, 1]
    (tokens, text), = want["replicas"]
    for i in range(2):
        assert out[f"replica{i}_0_tokens"].tolist() == tokens, i
        assert str(out[f"replica{i}_0_text"]) == text == str(out[f"replica{i}_0_stream"]), i
        programs = out[f"replica{i}_programs"]
        assert (programs[:, i] > 0).all(), (i, programs)


@pytest.mark.parametrize("tag", ["clip_data2", "clip_r2"])
def test_graph_clip_matches_jax_and_runs_no_program(runs, tag):
    """Graph CLIP embeddings equal the JAX manager's at the same mesh (each
    replica's, with two); a copy of the towers a data place of each
    replica, on rank 0; the group ran no program for it."""
    want, outs = runs
    out = outs["group"][0]
    image, text = want[tag]
    assert_same_vectors(out[f"{tag}_image"], image)
    assert_same_vectors(out[f"{tag}_text"], text)
    assert_same_vectors(out[f"{tag}_image"], want["clip_meshless"][0])
    shapes, places = json.loads(str(out[f"{tag}_shapes"])), json.loads(str(out[f"{tag}_places"]))
    if tag == "clip_data2":
        assert shapes == [{"data": 2, "model": 2}] and places == [[0, 1]]
        assert out[f"{tag}_copies"].tolist() == [2]
    else:
        assert shapes == [{"model": 2, "data": 1}] * 2 and places == [[0], [1]]
        assert out[f"{tag}_copies"].tolist() == [1, 1]
        for r in range(2):
            assert_same_vectors(out[f"{tag}_{r}_image"], image)
            assert_same_vectors(out[f"{tag}_{r}_text"], text)
    assert int(out[f"{tag}_programs"]) == 0


def test_the_dp_tp_preset_boots_every_service_on_eight_places(runs):
    """``serve()`` of the ``cuda_h100_8_dp_tp`` full tier with graph-tower
    directories for ``vlm`` (FastVLM-0.5B) and ``clip`` (MobileCLIP2-S2):
    a group of two ranks of four places, every service healthy and none a
    ``DegradedService`` (the exported towers raised on a model axis
    before), a caption and an embedding, and ``stop`` ends the worker."""
    want, outs = runs
    out = outs["serve"][0]
    services = json.loads(str(out["services"]))
    assert sorted(services) == ["clip", "face", "ocr", "vlm"]
    for name, (kind, healthy, error) in services.items():
        assert kind != "DegradedService" and healthy and not error, (name, kind, error)
    assert json.loads(str(out["group_shape"])) == {"data": 4, "expert": 1, "model": 2}
    assert json.loads(str(out["meshes"])) == {"vlm": {"data": 4, "model": 2}, "clip": {"data": 4, "model": 2}}
    assert len(out["vlm_tokens"]) >= 1
    assert_same_vectors(out["clip_image"], want["clip_meshless"][0])
    assert out["place_programs"].shape == (2, 4)
    assert out["worker_codes"].tolist() == [0]


def test_a_group_serving_only_graph_clip_stays_healthy_and_stops(runs):
    """``serve()`` of the preset's ``clip`` block alone on four devices
    still starts the group (its mesh names a model axis), though graph
    CLIP runs no program on it: the service answers with the mesh-less
    embedding, Health and the group stay up, and ``stop`` ends the worker
    promptly."""
    want, outs = runs
    out = outs["serve"][0]
    assert_same_vectors(out["clip_only_image"], want["clip_meshless"][0])
    assert out["clip_only_healthy"].tolist() == [True, True]
    assert int(out["clip_only_programs"]) == 0
    assert out["clip_only_codes"].tolist() == [0] and float(out["clip_only_stop_s"]) < 30
