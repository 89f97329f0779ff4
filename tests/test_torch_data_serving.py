"""Serving and ingest over a ``data`` axis, the port against the JAX
package on the CPU: the JAX managers on the suite's forced CPU devices at
``mesh_axes``, the port's on the CPU named once a data place
(``devices=``), each place holding its own copy of the weights; the same
seeded model directories and inputs.

- CLIP at ``{"data": 2}`` and ``{"data": 4}``, batch 8: image and text
  embeddings within ``EMBED_TOL`` and ``classify`` labels equal (scores
  within it), every place's vision tower running its part of a full
  batch; int8 (W8A8 ``dynamic``) at ``{"data": 2}``: one ``QDense`` copy a
  place, embeddings within ``Q8_COSINE`` of the JAX int8 manager's;
- face at ``{"data": 2}``: detections and embeddings as
  ``tests/test_torch_face.py`` holds them;
- the photo ingest (CLIP and face stages) over ``{"data": 4}`` against
  the JAX pipeline over ``build_mesh({"data": -1}, devices=jax.devices()
  [:4])``; a batch size that does not split over 4 raises in both;
- the VLM's continuous engine at ``{"data": 4}``: the JAX manager's greedy
  tokens, on one copy of the model (place 0's).
"""

from __future__ import annotations

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
from lumen_tpu.pipeline import PhotoIngestPipeline as JPhotoIngest
from lumen_tpu.runtime.mesh import build_mesh as jax_build_mesh
from lumen_tpu_torch.models import face as tface
from lumen_tpu_torch.models.clip import CLIPManager as TClip
from lumen_tpu_torch.models.vlm import VLMManager as TVlm
from lumen_tpu_torch.models.vlm.chat import ChatMessage
from lumen_tpu_torch.ops.quant import QDense
from lumen_tpu_torch.pipeline import PhotoIngestPipeline as TPhotoIngest
from lumen_tpu_torch.runtime.mesh import build_mesh
from test_torch_face import assert_same_faces, port_configs
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture
from tests.clip_fixtures import make_clip_model_dir, png_bytes
from tests.test_face import make_face_model_dir
from tests.test_vlm import make_vlm_model_dir

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs the simulated 8-device mesh")

CPU = torch.device("cpu")
#: embeddings and label scores: the same float32 towers in two libraries
#: (the existing CLIP parity tests' tolerance)
EMBED_TOL = 1e-5
#: int8 towers against the JAX int8 towers (``tests/test_torch_clip_quant.py``)
Q8_COSINE = 0.99999
#: face boxes in pixels, and embedding cosines (``tests/test_torch_ingest.py``)
PX, COSINE = 1e-3, 0.99999
BATCH = 8


@pytest.fixture(autouse=True)
def fixed_window(monkeypatch):
    """A fixed 200 ms collection window: the eight concurrent requests of
    a case fill one batch, so every place runs a part."""
    monkeypatch.setenv("LUMEN_BATCH_ADAPTIVE", "0")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data_axis")
    face_dir, det_cfg, rec_cfg = make_face_model_dir(root / "face")
    vlm_dir = make_vlm_model_dir(root / "vlm")
    os.remove(os.path.join(vlm_dir, "tokenizer_config.json"))  # the plain transcript on both packages
    return {"clip": make_clip_model_dir(root / "clip"), "face": (face_dir, det_cfg, rec_cfg), "vlm": vlm_dir}


def _concurrently(fn, items) -> list:
    with ThreadPoolExecutor(len(items)) as ex:
        return list(ex.map(fn, items))


def _clip_pair(clip_dir: str, dp: int, **kw):
    jm = JClip(clip_dir, dataset="Tiny", dtype="float32", batch_size=BATCH, max_batch_latency_ms=200,
               mesh_axes={"data": dp}, **kw)
    tm = TClip(clip_dir, dataset="Tiny", dtype="float32", batch_size=BATCH, max_batch_latency_ms=200,
               mesh_axes={"data": dp}, device="cpu", devices=[CPU] * dp, **kw)
    jm.initialize()
    tm.initialize()
    return jm, tm


def _count_parts(models) -> list:
    """Rows each place's vision tower runs, by a forward hook."""
    rows = [[] for _ in models]
    for i, m in enumerate(models):
        m.vision.register_forward_hook(lambda mod, args, out, i=i: rows[i].append(args[0].shape[0]))
    return rows


@pytest.mark.parametrize("dp", [2, 4])
def test_clip_embeddings_and_labels_equal_the_jax_manager(dirs, dp):
    jm, tm = _clip_pair(dirs["clip"], dp)
    try:
        assert tm.mesh.shape == dict(jm.mesh.shape) == {"data": dp}
        assert len({id(m) for m in tm.place_models}) == dp and tm.model is tm.place_models[0]
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


def test_clip_int8_runs_a_qdense_copy_a_place(dirs, monkeypatch):
    monkeypatch.setenv("LUMEN_CLIP_Q8_ROUTE", "int8")
    jm, tm = _clip_pair(dirs["clip"], 2, quantize="int8")
    try:
        assert tm.quant_route == jm.quant_route == "int8"
        q = [[m for m in place.modules() if isinstance(m, QDense)] for place in tm.place_models]
        assert len(q[0]) == len(q[1]) > 0 and not {id(m) for m in q[0]} & {id(m) for m in q[1]}
        images = [png_bytes(seed=10 + i, size=48) for i in range(BATCH)]
        got = np.stack(_concurrently(tm.encode_image, images))
        want = np.stack(_concurrently(jm.encode_image, images))
        assert (np.sum(got * want, -1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)).min() > Q8_COSINE
    finally:
        tm.close()
        jm.close()


def test_face_detections_and_embeddings_equal_the_jax_manager(dirs):
    face_dir, det_cfg, rec_cfg = dirs["face"]
    tdet, trec = port_configs(det_cfg, rec_cfg)
    jm = JFace(face_dir, dtype="float32", batch_size=4, max_batch_latency_ms=200, detector_cfg=det_cfg,
               embedder_cfg=rec_cfg, mesh_axes={"data": 2})
    tm = tface.FaceManager(face_dir, dtype="float32", batch_size=4, max_batch_latency_ms=200, detector_cfg=tdet,
                           embedder_cfg=trec, mesh_axes={"data": 2}, device="cpu", devices=[CPU] * 2)
    jm.initialize()
    tm.initialize()
    try:
        assert tm.mesh.shape == {"data": 2} and len({id(v) for v in tm.det_places}) == 2
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


def _ingest_items() -> list:
    return [png_bytes(seed=i, size=(96, 64, 128)[i % 3]) for i in range(11)] + [b"not an image"]


def test_photo_ingest_over_four_places_equals_the_jax_pipeline(dirs):
    face_dir, det_cfg, rec_cfg = dirs["face"]
    tdet, trec = port_configs(det_cfg, rec_cfg)
    axes = {"data": 4}
    jax_side = (JClip(dirs["clip"], dataset="Tiny", dtype="float32", batch_size=4, mesh_axes=axes),
                JFace(face_dir, dtype="float32", batch_size=4, detector_cfg=det_cfg, embedder_cfg=rec_cfg,
                      mesh_axes=axes))
    port_side = (TClip(dirs["clip"], dataset="Tiny", dtype="float32", batch_size=4, mesh_axes=axes, device="cpu",
                       devices=[CPU] * 4),
                 tface.FaceManager(face_dir, dtype="float32", batch_size=4, detector_cfg=tdet, embedder_cfg=trec,
                                   mesh_axes=axes, device="cpu", devices=[CPU] * 4))
    for mgr in (*jax_side, *port_side):
        mgr.initialize()
    try:
        jmesh = jax_build_mesh({"data": -1}, devices=jax.devices()[:4])
        tmesh = build_mesh({"data": -1}, devices=[CPU] * 4)
        for pipeline, mesh, (clip, face) in ((JPhotoIngest, jmesh, jax_side), (TPhotoIngest, tmesh, port_side)):
            with pytest.raises(ValueError, match="not a multiple"):
                pipeline(mesh, clip=clip, face=face, batch_size=6)
        records = []
        for pipeline, mesh, (clip, face) in ((JPhotoIngest, jmesh, jax_side), (TPhotoIngest, tmesh, port_side)):
            pipe = pipeline(mesh, clip=clip, face=face, batch_size=8, classify_top_k=2, on_decode_error="record")
            records.append(list(pipe.run(_ingest_items())))
        assert pipe.engine._place_fns["clip"][1] is not pipe.engine._place_fns["clip"][0]
        assert (pipe.stats.batches, pipe.stats.items) == (2, 12)
    finally:
        for mgr in (*jax_side, *port_side):
            mgr.close()
    n_faces = 0
    for j, t in zip(*records):
        assert (t.index, t.sha256, bool(t.error)) == (j.index, j.sha256, bool(j.error))
        if j.error:
            continue
        np.testing.assert_allclose(t.clip_embedding, j.clip_embedding, atol=EMBED_TOL, rtol=0)
        assert [l for l, _ in t.labels] == [l for l, _ in j.labels] and len(t.labels) == 2
        assert len(t.faces) == len(j.faces)
        for tf, jf in zip(t.faces, j.faces):
            np.testing.assert_allclose(tf.bbox, jf.bbox, atol=PX)
            assert float(np.dot(tf.embedding, jf.embedding)) >= COSINE
        n_faces += len(t.faces)
    assert records[1][-1].error and n_faces > 0


def test_vlm_engine_at_four_places_gives_the_jax_tokens(dirs):
    kw = dict(dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32), gen_slots=2, gen_block=4)
    jm = JVlm(dirs["vlm"], mesh_axes={"data": 4}, **kw)
    jm.initialize()
    tm = TVlm.from_model_dir(dirs["vlm"], device="cpu", mesh_axes={"data": 4}, devices=[CPU] * 4, **kw)
    try:
        assert tm.mesh.shape == dict(jm.mesh.shape) == {"data": 4}
        # one engine, on place 0, over the one copy of the model
        assert len(tm._engines) == 1 and tm.fleet_plan.replicas == 1
        assert tm.engine.gen.model is tm.model
        image = png_bytes(seed=3, size=40)
        for content, img in (("describe the image", image), ("hello there", None)):
            j = jm.generate([JChatMessage(role="user", content=content)], image_bytes=img, max_new_tokens=10)
            t = tm.generate([ChatMessage(role="user", content=content)], image_bytes=img, max_new_tokens=10)
            assert t.tokens == list(j.tokens) and t.text == j.text and t.tokens
    finally:
        tm.close()
        jm.close()
