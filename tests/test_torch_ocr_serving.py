"""The port's OCR service over gRPC, held against the JAX server on the CPU.

Both packages boot their own ``serve()`` from one deployment, float32:

- an ``ocr`` service on ``tests/test_ocr.py``'s native checkpoints (pages
  asked at a gap threshold), on ``tests/test_ocr_graph.py``'s PP-OCR-style
  graph pack and on its pack with an orientation classifier
  (``use_angle_cls`` on and off): equal item counts, boxes within 1e-4 px,
  equal texts, confidences within 1e-5, for PNG bytes and for the
  ``tensor/raw`` pixels; bad meta answers ``INVALID_ARGUMENT`` on both;
  task lists and capability keys are equal (the runtime differs:
  ``torch-cpu``), and the port's service is healthy, no longer degraded;
- an OCR directory whose detector checkpoint is missing boots the service
  degraded on both, answering ``UNAVAILABLE``;
- a YAML of the shape ``generate_config(preset, tier="full")`` writes
  (ocr, clip, face, vlm), pointed at tiny directories, boots all four
  services on the port with none degraded, and each answers.
"""

from __future__ import annotations

import json
import os

import cv2
import numpy as np
import pytest
import torch
from google.protobuf import empty_pb2

from lumen_tpu.app.config_gen import generate_config
from lumen_tpu.serving.proto import ml_service_pb2 as pb
from lumen_tpu_torch.core.config import validate_config_dict as port_config
from lumen_tpu_torch.ops.image import letterbox_numpy
from lumen_tpu_torch.serving import server as port_server
from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload
from test_torch_face_serving import boot_both, call, deployment
from test_torch_ocr import gap_threshold
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture
from tests.clip_fixtures import make_clip_model_dir
from tests.test_face import make_face_model_dir
from tests.test_ocr import make_ocr_model_dir, text_image
from tests.test_ocr_graph import _upright_crop, make_cls_ocr_model_dir, make_graph_ocr_model_dir
from tests.test_vlm import make_vlm_model_dir

PX, CONF = 1e-4, 1e-5


def ocr_service(model: str) -> dict:
    return {
        "enabled": True, "package": "lumen_tpu.models.ocr",
        "import_info": {"registry_class": "lumen_tpu.serving.services.ocr_service.OcrService"},
        "backend_settings": {"dtype": "float32", "batch_size": 4},
        "models": {"ocr": {"model": model, "runtime": "jax"}},
    }


@pytest.fixture(scope="module")
def native_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ocr_native_srv")
    make_ocr_model_dir(root)
    yield from boot_both(deployment(str(root), {"ocr": ocr_service("TinyOCR")}))


@pytest.fixture(scope="module")
def graph_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ocr_graph_srv")
    make_graph_ocr_model_dir(root)
    make_cls_ocr_model_dir(root)
    yield from boot_both(deployment(str(root), {"ocr": ocr_service("GraphOCR")}))


@pytest.fixture(scope="module")
def cls_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ocr_cls_srv")
    make_cls_ocr_model_dir(root)
    yield from boot_both(deployment(str(root), {"ocr": ocr_service("ClsOCR")}))


def png(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".png", np.ascontiguousarray(img[..., ::-1]))
    assert ok
    return buf.tobytes()


def both(servers, payload: bytes, mime: str = "image/png", **meta) -> tuple[dict, dict]:
    jstub, tstub, _ = servers
    out = []
    for stub in (jstub, tstub):
        code, body = call(stub, "ocr", payload, mime, **meta)
        assert code == 0, code
        out.append(body)
    return out[0], out[1]


def assert_same_items(jbody: dict, tbody: dict) -> None:
    assert tbody["count"] == jbody["count"] == len(tbody["items"])
    assert tbody["model_id"] == jbody["model_id"]
    for t, j in zip(tbody["items"], jbody["items"]):
        np.testing.assert_allclose(t["box"], j["box"], atol=PX, rtol=0)
        assert t["text"] == j["text"]
        assert abs(t["confidence"] - j["confidence"]) <= CONF


def band_page() -> np.ndarray:
    img = np.zeros((240, 320, 3), np.uint8)
    img[100:140, 40:280] = 255
    return img


def test_ocr_service_is_served_not_degraded(graph_servers):
    jstub, tstub, thandle = graph_servers
    caps = []
    for stub in (jstub, tstub):
        cap = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
        assert {t.name for t in cap.tasks} == {"ocr"}
        caps.append(cap)
        _, call_ = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
        assert json.loads(dict(call_.trailing_metadata())["lumen-service-status"]) == {"ocr": "healthy"}
    assert caps[1].runtime == "torch-cpu"
    svc = thandle.services["ocr"]
    assert type(svc).__name__ == "OcrService" and svc.healthy()
    jextra = dict(jax_capability_extra(graph_servers))
    assert sorted(svc.capability().extra) == sorted(jextra)
    for key in ("det_buckets", "rec_height", "vocab_size", "bulk_stream", "replicas"):
        assert svc.capability().extra[key] == jextra[key], key


def jax_capability_extra(servers) -> dict:
    """The JAX service's capability ``extra`` (``GetCapabilities`` drops
    it by design; ``StreamCapabilities`` carries each service's)."""
    jstub = servers[0]
    for cap in jstub.StreamCapabilities(empty_pb2.Empty(), timeout=30):
        if {t.name for t in cap.tasks} == {"ocr"}:
            return cap.extra
    raise AssertionError("no ocr capability on the JAX server")


def test_graph_pack_answers_alike(graph_servers):
    jbody, tbody = both(graph_servers, png(band_page()))
    assert tbody["count"] == 1 and "a" in tbody["items"][0]["text"]
    assert_same_items(jbody, tbody)
    payload, meta = tensor_payload(band_page())
    jbody, tbody = both(graph_servers, payload, TENSOR_MIME, **meta)
    assert_same_items(jbody, tbody)
    for kw in ({"det_thresh": "0.4", "box_thresh": "0.3"}, {"unclip_ratio": "2.0", "rec_thresh": "0.0"},
               {"detection_threshold": "0.6", "ocr.use_angle_cls": "yes"}):
        jbody, tbody = both(graph_servers, png(band_page()), **kw)
        assert_same_items(jbody, tbody)


def test_native_pages_answer_alike_at_a_gap_threshold(native_servers):
    """The tiny seeded detector scores every pixel near 0.495: a threshold
    in the widest gap of its values around 0.3 (``test_torch_ocr.
    gap_threshold``: 0.3 itself here) asks both servers a question no
    rounding can tip."""
    mgr = native_servers[2].services["ocr"].manager
    page = text_image()
    prob = mgr._run_detector(mgr.det_vars, torch.from_numpy(letterbox_numpy(page, 128)[0][None]))
    thr = gap_threshold(prob[0].numpy())
    jbody, tbody = both(native_servers, png(page), det_thresh=str(thr), box_thresh="0.0", rec_thresh="0.0")
    assert tbody["count"] > 0
    assert_same_items(jbody, tbody)
    payload, meta = tensor_payload(page)
    jbody, tbody = both(native_servers, payload, TENSOR_MIME, det_thresh=str(thr), box_thresh="0.0",
                        rec_thresh="0.0", **meta)
    assert_same_items(jbody, tbody)


def test_angle_cls_answers_alike(cls_servers):
    """A 180-degree line on a dim ground, read with and without the
    classifier. (On a black ground the fixture's crafted recognizer ties
    two classes exactly at the crop's edge frames, where the two packages'
    roundings pick different winners.)"""
    page = np.full((96, 320, 3), 40, np.uint8)
    page[24:72, 40:280] = np.ascontiguousarray(_upright_crop(240)[::-1, ::-1])  # a 180-degree line
    for flag in ("true", "0", "on"):
        jbody, tbody = both(cls_servers, png(page), use_angle_cls=flag, det_thresh="0.1", box_thresh="0.1",
                            rec_thresh="0.0")
        assert_same_items(jbody, tbody)


def test_bad_meta_is_invalid_argument_on_both(graph_servers):
    jstub, tstub, _ = graph_servers
    for stub in (jstub, tstub):
        for meta in ({"det_thresh": "zzz"}, {"use_angle_cls": "maybe"}, {"unclip_ratio": ""}):
            code, _ = call(stub, "ocr", png(band_page()), **meta)
            assert code == pb.ERROR_CODE_INVALID_ARGUMENT, meta
        code, _ = call(stub, "ocr", b"not an image")
        assert code == pb.ERROR_CODE_INVALID_ARGUMENT


def test_missing_ocr_weights_boot_the_service_degraded_on_both(tmp_path):
    root = tmp_path / "missing"
    model_dir = make_ocr_model_dir(root)
    os.remove(os.path.join(model_dir, "detection.safetensors"))
    gen = boot_both(deployment(str(root), {"ocr": ocr_service("TinyOCR")}))
    jstub, tstub, thandle = next(gen)
    try:
        assert "no detection weights" in thandle.services["ocr"].error
        for stub in (jstub, tstub):
            code, _ = call(stub, "ocr", png(band_page()))
            assert code == pb.ERROR_CODE_UNAVAILABLE
    finally:
        gen.close()


def test_full_tier_yaml_boots_every_service_on_the_port(tmp_path):
    """``generate_config(preset, tier="full")``'s YAML (hub of ocr, clip,
    face, vlm, each with the preset's backend settings), pointed at tiny
    directories in float32: every service is up on the port, none
    degraded, and each family answers."""
    make_graph_ocr_model_dir(tmp_path)
    make_clip_model_dir(tmp_path)
    make_face_model_dir(tmp_path)
    make_vlm_model_dir(tmp_path)
    raw = generate_config("tpu_v5e_1", tier="full", cache_dir=str(tmp_path)).model_dump(exclude_none=True)
    assert sorted(raw["services"]) == ["clip", "face", "ocr", "vlm"]
    models = {"ocr": "GraphOCR", "clip": "TinyCLIP", "face": "TinyFace", "vlm": "TinyVLM"}
    for name, svc in raw["services"].items():
        svc["backend_settings"]["dtype"] = "float32"
        svc["models"][name]["model"] = models[name]
    raw["services"]["clip"]["models"]["clip"]["dataset"] = "Tiny"
    raw["server"]["mdns"]["enabled"] = False
    handle = port_server.serve(port_config(raw), port_override=0, skip_download=True, device="cpu")
    try:
        assert {n: s.healthy() for n, s in handle.services.items()} == {n: True for n in models}
        assert not any(getattr(s, "error", None) for s in handle.services.values())
        import grpc

        from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub

        with grpc.insecure_channel(f"127.0.0.1:{handle.port}") as channel:
            stub = InferenceStub(channel)
            _, call_ = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
            status = json.loads(dict(call_.trailing_metadata())["lumen-service-status"])
            assert status == {n: "healthy" for n in models}
            code, body = call(stub, "ocr", png(band_page()))
            assert code == 0 and body["count"] == 1
            code, body = call(stub, "clip_image_embed", png(band_page()))
            assert code == 0 and len(body["vector"]) > 0
            code, body = call(stub, "face_detect", png(band_page()))
            assert code == 0
            code, body = call(stub, "vlm_generate", png(band_page()), messages=json.dumps(
                [{"role": "user", "content": "describe"}]), max_new_tokens=4)
            assert code == 0 and body["generated_tokens"] >= 1
    finally:
        handle.stop(grace=1.0)
