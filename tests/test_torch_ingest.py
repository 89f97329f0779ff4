"""The port's ingest pipeline, photo task graph and CLI, held against the
JAX package on the CPU.

- ``IngestPipeline`` semantics, each case run on both packages (``pkg``;
  the JAX side on the suite's 8-device CPU mesh, the port on the CPU
  device): order, values and padding, several stages merged into one
  record, one decode shared by every stage, producer errors, empty
  input, the data-axis check, the task graph (validation, derived nodes,
  ``_sha256`` and duplicates), the ``cache_output=False`` node re-fired
  on cache hits and never cached, and batch salvage (a poison item, a
  dead device, a shed).
- ``PhotoIngestPipeline``: the port against the JAX one on the tiny
  CLIP/face/OCR/VLM model directories of the JAX suite, the same PNGs:
  embeddings within 1e-5, labels equal (scores within 1e-5), faces equal
  (boxes within 1e-3 px, embeddings at cosine >= 0.99999), OCR texts
  equal, greedy captions equal; the device-set guard, caption fan-out.
- The CLI: ``python -m lumen_tpu_torch.pipeline.cli`` against
  ``scripts/ingest.py`` on one YAML and 80 PNGs (two chunks, as
  ``tests/test_ingest_cli.py``): equal rows (embeddings within 1e-5,
  captions equal), whole-run stats, and ``--resume`` with a torn tail.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import lumen_tpu.pipeline as jpipeline
import lumen_tpu.pipeline.ingest as jingest
import lumen_tpu.runtime.quarantine as jquarantine
import lumen_tpu.runtime.result_cache as jresult_cache
import lumen_tpu.utils.deadline as jdeadline
import lumen_tpu_torch.pipeline as tpipeline
import lumen_tpu_torch.pipeline.ingest as tingest
import lumen_tpu_torch.runtime.quarantine as tquarantine
import lumen_tpu_torch.runtime.result_cache as tresult_cache
import lumen_tpu_torch.utils.deadline as tdeadline
from lumen_tpu.runtime.mesh import build_mesh as jax_build_mesh
from lumen_tpu_torch.runtime.mesh import DeviceMesh, build_mesh
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture
from tests.clip_fixtures import make_clip_model_dir, png_bytes
from tests.test_face import make_face_model_dir
from tests.test_ocr import make_ocr_model_dir
from tests.test_vlm import make_vlm_model_dir

#: embeddings and label scores: the same float32 towers in two libraries
EMBED_TOL = 1e-5
#: face boxes in pixels, and embedding cosines
PX, COSINE = 1e-3, 0.99999
POISON = 666


class Pkg:
    """One package's side of a generic engine case."""

    def __init__(self, name: str):
        self.name = name
        self.jax = name == "jax"
        self.pipeline = jpipeline if self.jax else tpipeline
        self.ingest = jingest if self.jax else tingest
        self.quarantine = jquarantine if self.jax else tquarantine
        self.result_cache = jresult_cache if self.jax else tresult_cache
        self.deadline = jdeadline if self.jax else tdeadline
        self.mesh = jax_build_mesh({"data": -1}) if self.jax else build_mesh(devices=[torch.device("cpu")])
        self.dp = self.mesh.shape["data"]

    def stage(self, name: str, fn, **kw):
        return self.pipeline.Stage(
            name=name,
            preprocess=lambda item: np.array([item], np.float32),
            device_fn=fn,
            postprocess=lambda decoded, row: float(row[0]),
            **kw,
        )

    def make(self, stages, **kw):
        return self.pipeline.IngestPipeline(self.mesh, stages, **{"batch_size": 8, **kw})


@pytest.fixture(scope="module", params=["jax", "torch"])
def pkg(request):
    return Pkg(request.param)


@pytest.fixture()
def cache_on(pkg, monkeypatch):
    monkeypatch.setenv("LUMEN_CACHE_BYTES", str(32 * 1024 * 1024))
    pkg.result_cache.reset_result_cache()
    yield pkg.result_cache.get_result_cache()
    pkg.result_cache.reset_result_cache()


@pytest.fixture()
def registry(pkg, monkeypatch):
    # A name of its own: registering the default name would take over the
    # shared registry's gauge provider, and closing would leave it gone.
    reg = pkg.quarantine.QuarantineRegistry(ttl_s=60, name="quarantine:test_torch_ingest")
    monkeypatch.setattr(pkg.quarantine, "_shared", reg)
    yield reg
    reg.close()


# -- the generic engine, both packages ------------------------------------------------


def test_order_values_and_padding(pkg):
    seen = []

    def double(x):
        seen.append((type(x).__module__.split(".")[0], tuple(x.shape)))
        return x * 2

    pipe = pkg.make([pkg.stage("double", double)])
    items = list(range(20))  # 2 full batches + ragged tail of 4
    records = pipe.run_all(items)
    assert [r["_index"] for r in records] == items
    assert [r["double"] for r in records] == [2.0 * i for i in items]
    assert (pipe.stats.items, pipe.stats.batches) == (20, 3)
    assert pipe.stats.items_per_sec > 0
    assert {shape for _, shape in seen} == {(8, 1)}  # every batch padded to the batch size
    if not pkg.jax:
        assert {mod for mod, _ in seen} == {"torch"}  # placed on the mesh's device as tensors
        assert pipe.stats.syncs == 0  # the CPU device makes no device-to-host copy


def test_multiple_stages_merge_into_one_record(pkg):
    records = pkg.make([pkg.stage("add1", lambda x: x + 1), pkg.stage("neg", lambda x: -x)]).run_all(range(5))
    assert (records[3]["add1"], records[3]["neg"]) == (4.0, -3.0)


def test_decode_shared_across_stages(pkg):
    calls = []

    def decode(item):
        calls.append(item)
        return item

    s = pkg.stage("s", lambda x: x)
    pkg.make([s, pkg.pipeline.Stage("t", s.preprocess, s.device_fn)], decode=decode).run_all(range(6))
    assert sorted(calls) == list(range(6))  # decoded once per item


def test_producer_error_propagates(pkg):
    def bad_decode(item):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        pkg.make([pkg.stage("s", lambda x: x)], decode=bad_decode).run_all(range(4))


def test_batch_size_must_divide_data_axis(pkg):
    mesh = pkg.mesh if pkg.jax else DeviceMesh([torch.device("cpu")], {"data": 8})
    with pytest.raises(ValueError, match="multiple"):
        pkg.pipeline.IngestPipeline(mesh, [pkg.stage("s", lambda x: x)], batch_size=6)


def test_empty_input(pkg):
    assert pkg.make([pkg.stage("s", lambda x: x)]).run_all([]) == []


def test_graph_validation(pkg):
    build, Stage = pkg.ingest._build_graph, pkg.pipeline.Stage
    src = pkg.stage("a", lambda x: x)
    with pytest.raises(ValueError, match="duplicate"):
        build([src, src])
    with pytest.raises(ValueError, match="unknown stage"):
        build([src, Stage("d", inputs=("nope",))])
    with pytest.raises(ValueError, match="must not set"):
        build([src, Stage("d", preprocess=src.preprocess, inputs=("a",))])
    with pytest.raises(ValueError, match="needs both"):
        build([Stage("a", preprocess=src.preprocess)])
    with pytest.raises(ValueError, match="cycle"):
        build([src, Stage("x", inputs=("y",)), Stage("y", inputs=("x",))])
    device, derived = build([Stage("late", inputs=("early",)), Stage("early", inputs=("a", "_sha256")), src])
    assert [s.name for s in device] == ["a"] and [s.name for s in derived] == ["early", "late"]


def test_derived_nodes_and_sha256(pkg):
    Stage = pkg.pipeline.Stage
    seen = []
    pipe = pkg.make(
        [
            Stage("sum", postprocess=lambda decoded, deps: deps["plus"] + deps["double"], inputs=("plus", "double")),
            pkg.stage("double", lambda x: x * 2),
            Stage("plus", postprocess=lambda decoded, deps: (seen.append(decoded), deps["double"] + 1)[1],
                  inputs=("double",)),
        ],
        decode=lambda b: int.from_bytes(b, "big"),
    )
    items = [int(i % 5).to_bytes(2, "big") for i in range(9)]
    records = pipe.run_all(items)
    assert [r["sum"] for r in records] == [4 * (i % 5) + 1 for i in range(9)]
    assert sorted(seen) == sorted(i % 5 for i in range(9))  # the decoded item on the miss path
    assert all(len(r["_sha256"]) == 64 for r in records)
    assert pipe.stats.duplicates == 4


def _side_effect_pipe(pkg, sink_calls):
    def sink(decoded, deps):
        sink_calls.append((decoded, deps["double"], deps.get("_sha256")))
        return "indexed"

    return pkg.make(
        [
            pkg.stage("double", lambda x: x * 2),
            pkg.pipeline.Stage("index", postprocess=sink, inputs=("double", "_sha256"), cache_output=False),
        ],
        decode=lambda b: int.from_bytes(b, "big"),
        cache_namespace="ingest/dag-test/m@1",
    )


def test_side_effect_refires_on_cache_hits(pkg, cache_on):
    sink_calls: list = []
    pipe = _side_effect_pipe(pkg, sink_calls)
    items = [int(i).to_bytes(2, "big") for i in range(10)]
    cold = pipe.run_all(items)
    assert len(sink_calls) == 10 and all(r["index"] == "indexed" for r in cold)
    assert sink_calls[3][:2] == (3, 6.0) and sink_calls[3][2] is not None
    warm = pipe.run_all(items)
    assert pipe.stats.cache_hits == 10 and pipe.stats.cache_hit_rate == 1.0
    assert len(sink_calls) == 20  # re-fired on every hit, decoded=None
    assert sink_calls[13][:2] == (None, 6.0) and sink_calls[13][2] is not None
    assert all(r["index"] == "indexed" for r in warm)
    key = pkg.result_cache.make_key(pipe.cache_namespace, pipe.cache_options, items[7])
    found, rec = cache_on.get(key)
    assert found and rec == {"double": 14.0}  # no side-effect value, no positional meta


def test_poison_item_becomes_error_record(pkg, registry):
    def check_fn(batch):
        if bool((batch[:, 0] == POISON).any()):
            raise RuntimeError("device choked on poison row")
        return batch * 4

    items = [0, 1, POISON, 3, 4, 5, 6, 7]
    records = pkg.make([pkg.stage("s", check_fn)], workers=1).run_all(items)
    assert [r["_index"] for r in records] == list(range(8))
    errors = [r for r in records if r.get("_error")]
    assert [r["_index"] for r in errors] == [2] and "poison" in errors[0]["_error"]
    assert all(r["s"] == 4.0 * items[r["_index"]] for r in records if not r.get("_error"))


def test_poison_bytes_are_quarantined_then_rejected_pre_decode(pkg, registry):
    decoded = []

    def decode(b):
        decoded.append(b)
        return int.from_bytes(b, "big")

    def check_fn(batch):
        if bool((batch[:, 0] == POISON).any()):
            raise RuntimeError("poison")
        return batch

    pipe = pkg.make([pkg.stage("s", check_fn)], decode=decode, cache_namespace="ingest/poison-test")
    items = [int(i).to_bytes(2, "big") for i in (1, POISON, 3)]
    first = pipe.run_all(items)
    assert "poison" in first[1]["_error"] and len(registry) == 1
    decoded.clear()
    second = pipe.run_all(items)
    assert second[1]["_error"].startswith("quarantined") and POISON.to_bytes(2, "big") not in decoded
    assert pipe.stats.quarantined == 1


def test_all_fail_salvage_is_device_failure_nothing_quarantined(pkg, registry):
    def dead_device(batch):
        raise RuntimeError("device dead")

    records = pkg.make([pkg.stage("s", dead_device)], batch_size=pkg.dp, workers=1, decode=lambda b: b[0],
                       cache_namespace="ingest/dead").run_all([b"a", b"b", b"c", b"d"])
    assert all("batch:" in r["_error"] for r in records)
    assert len(registry) == 0


def test_queue_full_is_a_shed_nothing_quarantined(pkg, registry):
    calls = []

    def shedding(batch):
        calls.append(1)
        raise pkg.deadline.QueueFull("admission queue full; request shed")

    records = pkg.make([pkg.stage("s", shedding)], workers=1, decode=lambda b: b[0], cache_namespace="ingest/shed").run_all(
        [bytes([i]) for i in range(4)])
    assert all(r["_error"].startswith("shed:") for r in records)
    assert len(calls) == 1 and len(registry) == 0


# -- the photo task graph, port vs JAX ---------------------------------------------------


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """The JAX suite's tiny model directories, each served by both
    packages' managers (float32)."""
    from lumen_tpu.models.clip import CLIPManager as JClip
    from lumen_tpu.models.face import FaceManager as JFace
    from lumen_tpu.models.ocr import OcrManager as JOcr
    from lumen_tpu.models.vlm import VLMManager as JVlm
    from lumen_tpu_torch.models import face as tface
    from lumen_tpu_torch.models.clip import CLIPManager as TClip
    from lumen_tpu_torch.models.ocr import OcrManager as TOcr
    from lumen_tpu_torch.models.vlm import VLMManager as TVlm

    root = tmp_path_factory.mktemp("torch_ingest_families")
    clip_dir = make_clip_model_dir(root / "clip")
    face_dir, det_cfg, rec_cfg = make_face_model_dir(root / "face")
    ocr_dir = make_ocr_model_dir(root / "ocr")
    vlm_dir = make_vlm_model_dir(root / "vlm")
    tdet = tface.DetectorConfig(**{f: getattr(det_cfg, f) for f in det_cfg.__dataclass_fields__})
    trec = tface.IResNetConfig(**{f: getattr(rec_cfg, f) for f in rec_cfg.__dataclass_fields__})
    jax_side = {
        "clip": JClip(clip_dir, dataset="Tiny", dtype="float32", batch_size=4),
        "face": JFace(face_dir, dtype="float32", batch_size=4, detector_cfg=det_cfg, embedder_cfg=rec_cfg),
        "ocr": JOcr(ocr_dir, dtype="float32"),
        "vlm": JVlm(vlm_dir, dtype="float32", max_seq=128, max_new_cap=8, prefill_buckets=(32,)),
    }
    port_side = {
        "clip": TClip(clip_dir, dataset="Tiny", dtype="float32", batch_size=4, device="cpu"),
        "face": tface.FaceManager(face_dir, dtype="float32", batch_size=4, detector_cfg=tdet, embedder_cfg=trec,
                                  device="cpu"),
        "ocr": TOcr(ocr_dir, dtype="float32", device="cpu"),
    }
    for mgr in (*jax_side.values(), *port_side.values()):
        mgr.initialize()
    port_side["vlm"] = TVlm.from_model_dir(vlm_dir, device="cpu", dtype="float32", max_seq=128, max_new_cap=8,
                                           prefill_buckets=(32,))
    yield jax_side, port_side
    for mgr in (*jax_side.values(), *port_side.values()):
        mgr.close()


def photo_items() -> list[bytes]:
    """PNGs the tiny face and OCR models answer on: noise at the face
    detector's and the OCR buckets' sizes, one undecodable item."""
    return [png_bytes(seed=i, size=(96, 64, 128)[i % 3]) for i in range(7)] + [b"not an image"]


def test_photo_records_equal_the_jax_pipeline(families):
    jax_side, port_side = families
    records = []
    for side, mesh in ((jax_side, jax_build_mesh({"data": -1})), (port_side, build_mesh(devices=[torch.device("cpu")]))):
        pipe = (jpipeline if side is jax_side else tpipeline).PhotoIngestPipeline(
            mesh, clip=side["clip"], face=side["face"], ocr=side["ocr"], vlm=side["vlm"], caption=True,
            caption_max_tokens=4, batch_size=8, classify_top_k=2, on_decode_error="record",
        )
        records.append(pipe.run_with_captions(photo_items()))
    n_faces = n_ocr = 0
    for j, t in zip(*records):
        assert (t.index, t.sha256, bool(t.error)) == (j.index, j.sha256, bool(j.error))
        if j.error:
            assert t.clip_embedding is None and t.caption is None
            continue
        np.testing.assert_allclose(t.clip_embedding, j.clip_embedding, atol=EMBED_TOL, rtol=0)
        assert [l for l, _ in t.labels] == [l for l, _ in j.labels] and len(t.labels) == 2
        np.testing.assert_allclose([s for _, s in t.labels], [s for _, s in j.labels], atol=EMBED_TOL, rtol=0)
        assert len(t.faces) == len(j.faces)
        for tf, jf in zip(t.faces, j.faces):
            np.testing.assert_allclose(tf.bbox, jf.bbox, atol=PX)
            assert float(np.dot(tf.embedding, jf.embedding)) >= COSINE
        assert [r.text for r in t.ocr] == [r.text for r in j.ocr]
        for tr, jr in zip(t.ocr, j.ocr):
            np.testing.assert_allclose(tr.box, jr.box, atol=PX)
        assert t.caption == j.caption and t.caption
        n_faces += len(t.faces)
        n_ocr += len(t.ocr)
    assert records[1][-1].error
    assert n_faces > 0  # the random detector finds faces in noise; OCR: next test


def text_pages() -> list[np.ndarray]:
    """Bright text-like bars on dark grounds (``tests/test_ocr.py``'s
    ``text_image``), in three sizes."""
    import cv2

    pages = []
    for w, h in ((120, 60), (100, 90), (128, 40)):
        img = np.zeros((h, w, 3), np.uint8)
        cv2.rectangle(img, (10, h // 3), (w - 10, h // 3 + 20), (255, 255, 255), -1)
        cv2.rectangle(img, (20, 2), (w // 2, 10), (200, 200, 200), -1)
        pages.append(img)
    return pages


def test_ocr_records_equal_the_jax_pipeline(tmp_path):
    """OCR through both pipelines on text pages, with the pack's
    detection threshold set midway in the widest gap of the pages' maps
    near 0.3 (as ``tests/test_torch_ocr.py`` asks its pages): boxes within
    1e-3 px, texts equal, confidences within 1e-5."""
    import cv2

    from lumen_tpu.models.ocr import OcrManager as JOcr
    from lumen_tpu_torch.models.ocr import OcrManager as TOcr
    from lumen_tpu_torch.ops.image import letterbox_numpy

    model_dir = make_ocr_model_dir(tmp_path)
    pages = text_pages()
    probe = JOcr(model_dir, dtype="float32")
    probe.initialize()
    try:
        maps = [np.asarray(probe._run_detector(probe.det_vars, letterbox_numpy(p, 128)[0][None]))[0] for p in pages]
    finally:
        probe.close()
    v = np.unique(np.concatenate([m.ravel() for m in maps]).astype(np.float64))
    pts = np.concatenate([[0.2], v[(v > 0.2) & (v < 0.4)], [0.4]])
    k = int(np.argmax(np.diff(pts)))
    info_path = os.path.join(model_dir, "model_info.json")
    info = json.load(open(info_path))
    info["extra_metadata"]["ocr"].update(det_threshold=float((pts[k] + pts[k + 1]) / 2), box_threshold=0.0)
    json.dump(info, open(info_path, "w"))
    items = [cv2.imencode(".png", p)[1].tobytes() for p in pages]
    got = []
    for jax_side in (True, False):
        mgr = JOcr(model_dir, dtype="float32") if jax_side else TOcr(model_dir, dtype="float32", device="cpu")
        mgr.initialize()
        try:
            mesh = jax_build_mesh({"data": -1}) if jax_side else build_mesh(devices=[torch.device("cpu")])
            pipe = (jpipeline if jax_side else tpipeline).PhotoIngestPipeline(mesh, ocr=mgr, batch_size=8)
            got.append([r.ocr for r in pipe.run(items)])
        finally:
            mgr.close()
    n = 0
    for jres, tres in zip(*got):
        assert len(tres) == len(jres)
        for tr, jr in zip(tres, jres):
            np.testing.assert_allclose(tr.box, jr.box, atol=PX)
            assert tr.text == jr.text
            assert abs(tr.confidence - jr.confidence) <= EMBED_TOL
        n += len(tres)
    assert n > 0


def test_photo_pipeline_matches_the_single_item_managers(families):
    """The batched path against the port's own per-request path."""
    _, port_side = families
    mesh = build_mesh(devices=[torch.device("cpu")])
    payload = png_bytes(seed=5, size=96)
    clip_rec = list(tpipeline.PhotoIngestPipeline(mesh, clip=port_side["clip"], batch_size=8).run([payload] * 3))[0]
    np.testing.assert_allclose(clip_rec.clip_embedding, port_side["clip"].encode_image(payload), atol=2e-5)
    face_rec = list(tpipeline.PhotoIngestPipeline(mesh, face=port_side["face"], batch_size=8).run([payload] * 2))[0]
    direct = port_side["face"].detect_and_extract(payload)
    assert len(face_rec.faces) == len(direct)
    for got, want in zip(face_rec.faces, direct):
        np.testing.assert_allclose(got.bbox, want.bbox, atol=PX)
        np.testing.assert_allclose(got.embedding, want.embedding, atol=2e-5)


def test_index_node_refires_on_cache_hits(families, monkeypatch):
    _, port_side = families
    monkeypatch.setenv("LUMEN_CACHE_BYTES", str(32 * 1024 * 1024))
    tresult_cache.reset_result_cache()
    indexed = []
    try:
        pipe = tpipeline.PhotoIngestPipeline(
            build_mesh(devices=[torch.device("cpu")]), clip=port_side["clip"], batch_size=8,
            on_decode_error="record", index=lambda sha, out: indexed.append((sha, out["embedding"])) or "ok",
        )
        items = [png_bytes(seed=i) for i in range(5)] + [b"not an image"]
        cold = list(pipe.run(items))
        warm = list(pipe.run(items))
    finally:
        tresult_cache.reset_result_cache()
    assert pipe.stats.cache_hits == 5 and pipe.stats.items == 6
    assert len(indexed) == 10 and [sha for sha, _ in indexed[:5]] == [r.sha256 for r in cold[:5]]
    for (_, a), (_, b) in zip(indexed[:5], indexed[5:]):
        np.testing.assert_array_equal(a, b)
    assert [r.sha256 for r in warm] == [r.sha256 for r in cold]


def test_device_set_guard_and_requirements(families):
    _, port_side = families
    with pytest.raises(ValueError, match="differ from pipeline mesh"):
        tpipeline.PhotoIngestPipeline(DeviceMesh([torch.device("meta")], {"data": 1}), clip=port_side["clip"])
    mesh = build_mesh(devices=[torch.device("cpu")])
    with pytest.raises(ValueError):
        tpipeline.PhotoIngestPipeline(mesh)
    with pytest.raises(ValueError, match="vlm"):
        tpipeline.PhotoIngestPipeline(mesh, clip=port_side["clip"], caption=True)
    with pytest.raises(ValueError, match="clip manager"):
        tpipeline.PhotoIngestPipeline(mesh, face=port_side["face"], index=lambda *a: None)


def test_captions_overlap_and_record_errors(families):
    _, port_side = families
    poison = png_bytes(seed=1)

    class GateVlm:
        """generate() blocks until both workers are inside (the fan-out
        overlaps), and fails for one payload."""

        mesh = None

        def __init__(self):
            self.gate = threading.Barrier(2, timeout=10)

        def _ensure_ready(self):
            pass

        def generate(self, messages, image_bytes=None, max_new_tokens=0):
            self.gate.wait()
            if image_bytes == poison:
                raise RuntimeError("caption boom")
            return type("R", (), {"text": "a photo"})()

    pipe = tpipeline.PhotoIngestPipeline(build_mesh(devices=[torch.device("cpu")]), clip=port_side["clip"],
                                         vlm=GateVlm(), caption=True, batch_size=8, caption_workers=2)
    records = pipe.run_with_captions([png_bytes(seed=0), poison, png_bytes(seed=2), png_bytes(seed=3)])
    assert [r.caption for r in records] == ["a photo", None, "a photo", "a photo"]
    assert "caption boom" in records[1].error


# -- the CLI, port vs scripts/ingest.py ---------------------------------------------------


@pytest.fixture(scope="module")
def cli_cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ingest_cli")
    make_clip_model_dir(root)
    make_vlm_model_dir(root)
    photos = root / "photos"
    photos.mkdir()
    for i in range(80):  # chunk size floors at 64 -> two chunks (64 + 16)
        (photos / f"p{i:03d}.png").write_bytes(png_bytes(seed=i % 5))
    (root / "cfg.yaml").write_text(f"""
metadata:
  version: "1.0.0"
  region: other
  cache_dir: {root}
deployment:
  mode: hub
  services: [clip, vlm]
server:
  port: 50934
  host: 127.0.0.1
  mdns:
    enabled: false
services:
  clip:
    enabled: true
    package: lumen_tpu.serving.services.clip_service
    import_info:
      registry_class: lumen_tpu.serving.services.clip_service.ClipService
    backend_settings: {{dtype: float32, batch_size: 4}}
    models:
      clip: {{model: TinyCLIP, runtime: jax, dataset: Tiny}}
  vlm:
    enabled: true
    package: lumen_tpu.serving.services.vlm_service
    import_info:
      registry_class: lumen_tpu.serving.services.vlm_service.VlmService
    backend_settings: {{dtype: float32, batch_size: 2}}
    models:
      vlm: {{model: TinyVLM, runtime: jax}}
""")
    return root


def jax_cli():
    scripts = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import ingest

    return ingest


def stats_line(out: str) -> dict:
    line = [l for l in out.splitlines() if "stage stats" in l][-1]
    return json.loads(line.split("stage stats: ")[1])


def test_cli_rows_equal_the_jax_script(cli_cache, capsys):
    from lumen_tpu_torch.pipeline import cli

    rows = {}
    for name, main in (("jax", jax_cli().main), ("torch", cli.main)):
        out = cli_cache / f"idx_{name}.jsonl"
        assert main([
            "--config", str(cli_cache / "cfg.yaml"), "--input", str(cli_cache / "photos"), "--output", str(out),
            "--families", "clip,vlm", "--caption-max-tokens", "3", "--batch-size", "8", "--classify-top-k", "2",
            "--platform", "cpu",
        ]) == 0
        rows[name] = [json.loads(l) for l in open(out)]
        assert stats_line(capsys.readouterr().out)["items"] == 80
    assert len(rows["torch"]) == len(rows["jax"]) == 80
    for t, j in zip(rows["torch"], rows["jax"]):
        assert sorted(t) == sorted(j) == ["caption", "clip_embedding", "labels", "path"]
        assert (t["path"], t["caption"]) == (j["path"], j["caption"]) and t["caption"]
        a, b = (np.frombuffer(base64.b64decode(r["clip_embedding"]), "<f4") for r in (t, j))
        np.testing.assert_allclose(a, b, atol=EMBED_TOL, rtol=0)
        assert [l["label"] for l in t["labels"]] == [l["label"] for l in j["labels"]]


def test_cli_resume_keeps_rows_and_drops_the_torn_tail(cli_cache, capsys):
    from lumen_tpu_torch.pipeline import cli

    photos = cli_cache / "photos"
    all_paths = sorted(str(photos / n) for n in os.listdir(photos))
    out = cli_cache / "resume.jsonl"
    with open(out, "w") as f:
        for p in all_paths[:70]:
            f.write(json.dumps({"path": p, "clip_embedding": "kept"}) + "\n")
        f.write('{"path": "' + all_paths[70] + '", "clip_emb')  # no newline
    args = ["--config", str(cli_cache / "cfg.yaml"), "--input", str(photos), "--output", str(out),
            "--families", "clip", "--batch-size", "8", "--embed-encoding", "list", "--platform", "cpu", "--resume"]
    assert cli.main(args) == 0
    captured = capsys.readouterr()
    rows = [json.loads(l) for l in open(out)]
    assert [r["path"] for r in rows] == all_paths
    assert all(r["clip_embedding"] == "kept" for r in rows[:70])
    assert all(isinstance(r["clip_embedding"], list) and len(r["clip_embedding"]) == 32 for r in rows[70:])
    assert "resume: 70 image(s) already indexed, 10 to go" in captured.out
    assert "resume warning: existing rows use b64 embeddings but --embed-encoding is list" in captured.err
    assert cli.main(args) == 0
    assert "nothing to do" in capsys.readouterr().out
    assert len(open(out).read().splitlines()) == 80


def test_cli_needs_a_card_unless_asked_for_the_cpu(cli_cache):
    from lumen_tpu_torch.pipeline import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", str(cli_cache / "cfg.yaml"), "--input", str(cli_cache / "photos"),
                  "--output", str(cli_cache / "x.jsonl")])
    with pytest.raises(SystemExit):
        cli.main(["--config", "x", "--input", "y", "--output", "z", "--platform", "tpu"])
