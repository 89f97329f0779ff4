"""The port's face service over gRPC, held against the JAX server on the CPU.

Both packages boot their own ``serve()`` from one deployment, float32:

- a ``face`` service on ``tests/test_face_graph.py``'s InsightFace-style
  pack (``det_10g.onnx`` + ``w600k_r50.onnx`` on each package's ONNX
  bridge): ``face_detect``, ``face_embed`` (with and without landmarks)
  and ``face_detect_and_embed`` answer alike — equal face counts, boxes
  and landmarks within 0.05 px, confidences within 1e-4, embedding cosine
  >= 0.99999 — for PNG bytes and for the ``tensor/raw`` pixels; invalid
  landmarks answer ``INVALID_ARGUMENT`` on both; task lists and capability
  keys are equal, and the port's service is healthy, no longer degraded;
- a hub of ``clip`` (``tests/test_clip_graph.py``'s export-only towers,
  with a label set) and ``face`` (``tests/test_face.py``'s native
  checkpoints): the CLIP tasks answer within max |diff| 1e-4 and cosine
  >= 0.99999, the face tasks within the bounds above;
- a face directory whose detector checkpoint is missing boots the face
  service degraded on both (the hard fail), answering ``UNAVAILABLE``.
"""

from __future__ import annotations

import json
import os
import socket
from pathlib import Path

import cv2
import grpc
import numpy as np
import pytest
from google.protobuf import empty_pb2

from lumen_tpu.core.config import validate_config_dict as jax_config
from lumen_tpu.serving import server as jax_server
from lumen_tpu.serving.proto import ml_service_pb2 as pb
from lumen_tpu.serving.proto.ml_service_pb2_grpc import InferenceStub
from lumen_tpu_torch.core.config import validate_config_dict as port_config
from lumen_tpu_torch.serving import server as port_server
from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture
from tests.clip_fixtures import png_bytes
from tests.test_clip_graph import make_export_dir
from tests.test_face import make_face_model_dir
from tests.test_face_graph import _two_blob_image, make_graph_face_model_dir

PX, SCORE, COSINE, ATOL = 0.05, 1e-4, 0.99999, 1e-4
FACE_TASKS = {"face_detect", "face_embed", "face_detect_and_embed"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def face_service(model: str) -> dict:
    return {
        "enabled": True, "package": "lumen_tpu.models.face",
        "import_info": {"registry_class": "lumen_tpu.serving.services.face_service.FaceService"},
        "backend_settings": {"dtype": "float32", "batch_size": 4},
        "models": {"face": {"model": model, "runtime": "jax"}},
    }


def deployment(cache_dir: str, services: dict) -> dict:
    mode = ({"mode": "single", "service": next(iter(services))} if len(services) == 1
            else {"mode": "hub", "services": sorted(services)})
    return {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": cache_dir},
        "deployment": mode,
        "server": {"port": 50997, "host": "127.0.0.1"},
        "services": services,
    }


def boot_both(raw: dict):
    jhandle = jax_server.serve(jax_config(raw), port_override=free_port(), skip_download=True)
    thandle = port_server.serve(port_config(raw), port_override=0, skip_download=True, device="cpu")
    jchan = grpc.insecure_channel(f"127.0.0.1:{jhandle.port}")
    tchan = grpc.insecure_channel(f"127.0.0.1:{thandle.port}")
    try:
        yield InferenceStub(jchan), InferenceStub(tchan), thandle
    finally:
        jchan.close()
        tchan.close()
        thandle.stop(grace=1.0)
        jhandle.stop(grace=1.0)


@pytest.fixture(scope="module")
def face_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_face_serving")
    make_graph_face_model_dir(root)
    yield from boot_both(deployment(str(root), {"face": face_service("GraphFace")}))


@pytest.fixture(scope="module")
def hub_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_face_hub")
    clip_dir, _, _ = make_export_dir(root)
    info = json.loads((Path(clip_dir) / "model_info.json").read_text())
    info["datasets"] = {"Tiny": {"labels": "datasets/tiny/labels.json", "embeddings": "datasets/tiny/embeddings.npy"}}
    (Path(clip_dir) / "model_info.json").write_text(json.dumps(info))
    (Path(clip_dir) / "datasets" / "tiny").mkdir(parents=True)
    (Path(clip_dir) / "datasets" / "tiny" / "labels.json").write_text(json.dumps(["cat", "dog", "car", "tree"]))
    make_face_model_dir(root)
    clip = {
        "enabled": True, "package": "lumen_tpu.models.clip",
        "import_info": {"registry_class": "lumen_tpu.serving.services.clip_service.ClipService"},
        "backend_settings": {"dtype": "float32", "batch_size": 4},
        "models": {"clip": {"model": "TinyMobileCLIP", "runtime": "onnx", "dataset": "Tiny"}},
    }
    yield from boot_both(deployment(str(root), {"clip": clip, "face": face_service("TinyFace")}))


def call(stub, task: str, payload: bytes, mime: str = "image/png", **meta) -> tuple[int, dict | None]:
    req = pb.InferRequest(correlation_id="f", task=task, payload=bytes(payload), payload_mime=mime,
                          meta={k: str(v) for k, v in meta.items()})
    last = list(stub.Infer(iter([req]), timeout=120))[-1]
    if last.HasField("error") and last.error.code:
        return last.error.code, None
    return 0, json.loads(last.result)


def both(servers, *args, **meta) -> tuple[dict, dict]:
    jstub, tstub, _ = servers
    out = []
    for stub in (jstub, tstub):
        code, body = call(stub, *args, **meta)
        assert code == 0, (args[0], code)
        out.append(body)
    return out[0], out[1]


def cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def assert_same_faces(jbody: dict, tbody: dict, embeddings: bool = False) -> None:
    assert tbody["count"] == jbody["count"] == len(tbody["faces"])
    assert tbody["model_id"] == jbody["model_id"]
    for t, j in zip(tbody["faces"], jbody["faces"]):
        np.testing.assert_allclose(t["bbox"], j["bbox"], atol=PX)
        if j["landmarks"] is None:
            assert t["landmarks"] is None
        else:
            np.testing.assert_allclose(t["landmarks"], j["landmarks"], atol=PX)
        assert abs(t["confidence"] - j["confidence"]) <= SCORE
        if embeddings:
            assert len(t["embedding"]) == len(j["embedding"])
            assert cosine(t["embedding"], j["embedding"]) >= COSINE


def blob_png() -> bytes:
    ok, buf = cv2.imencode(".png", _two_blob_image()[..., ::-1])
    assert ok
    return buf.tobytes()


def test_face_service_is_served_not_degraded(face_servers):
    jstub, tstub, thandle = face_servers
    caps = []
    for stub in (jstub, tstub):
        cap = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
        assert {t.name for t in cap.tasks} == FACE_TASKS
        caps.append(cap)
        _, call_ = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
        assert json.loads(dict(call_.trailing_metadata())["lumen-service-status"]) == {"face": "healthy"}
    assert caps[1].runtime == "torch-cpu"
    svc = thandle.services["face"]
    assert type(svc).__name__ == "FaceService" and svc.healthy()
    tcap = svc.capability()
    assert tcap.extra["det_size"] == "128" and tcap.extra["embedding_dim"] == "512"


def test_face_detect_answers_alike(face_servers):
    jbody, tbody = both(face_servers, "face_detect", blob_png())
    assert tbody["count"] >= 2
    assert_same_faces(jbody, tbody)
    jbody, tbody = both(face_servers, "face_detect", blob_png(), conf_threshold=0.1, max_faces=3, nms_threshold=0.6)
    assert_same_faces(jbody, tbody)


def test_face_embed_answers_alike(face_servers):
    crop = png_bytes(seed=3, size=120)
    jbody, tbody = both(face_servers, "face_embed", crop)
    assert_same_faces(jbody, tbody, embeddings=True)
    lm = json.dumps([[40, 50], [80, 50], [60, 70], [45, 95], [75, 95]])
    jbody, tbody = both(face_servers, "face_embed", crop, landmarks=lm)
    assert_same_faces(jbody, tbody, embeddings=True)


def test_face_detect_and_embed_answers_alike(face_servers):
    jbody, tbody = both(face_servers, "face_detect_and_embed", blob_png(), max_faces=2)
    assert tbody["count"] == 2 and all(f["embedding"] for f in tbody["faces"])
    assert_same_faces(jbody, tbody, embeddings=True)


def test_tensor_raw_answers_what_the_photo_answers(face_servers):
    payload, meta = tensor_payload(_two_blob_image())
    for task in ("face_detect", "face_detect_and_embed"):
        jbody, tbody = both(face_servers, task, payload, TENSOR_MIME, **meta)
        assert_same_faces(jbody, tbody, embeddings=task != "face_detect")
        _, png = both(face_servers, task, blob_png())
        assert_same_faces(png, tbody, embeddings=task != "face_detect")


def test_invalid_landmarks_answer_invalid_argument_on_both(face_servers):
    jstub, tstub, _ = face_servers
    for stub in (jstub, tstub):
        code, _ = call(stub, "face_embed", png_bytes(size=40), landmarks="[[1,2]]")
        assert code == pb.ERROR_CODE_INVALID_ARGUMENT
        code, _ = call(stub, "face_detect", png_bytes(size=40), max_faces="many")
        assert code == pb.ERROR_CODE_INVALID_ARGUMENT


def test_hub_serves_graph_clip_and_native_face_alike(hub_servers):
    jstub, tstub, thandle = hub_servers
    tasks = [{t.name for t in stub.GetCapabilities(empty_pb2.Empty(), timeout=30).tasks} for stub in (jstub, tstub)]
    assert tasks[1] == tasks[0] and FACE_TASKS | {"clip_image_embed", "clip_classify"} <= tasks[1]
    assert thandle.services["clip"].managers["clip"]._graphs is not None
    img = png_bytes(seed=9, size=64)
    jbody, tbody = both(hub_servers, "clip_image_embed", img)
    assert np.abs(np.subtract(tbody["vector"], jbody["vector"])).max() <= ATOL
    assert cosine(tbody["vector"], jbody["vector"]) >= COSINE
    jbody, tbody = both(hub_servers, "clip_text_embed", b"a photo of a dog", "text/plain")
    assert cosine(tbody["vector"], jbody["vector"]) >= COSINE
    jbody, tbody = both(hub_servers, "clip_classify", img, top_k=3)
    assert [x["label"] for x in tbody["labels"]] == [x["label"] for x in jbody["labels"]]
    np.testing.assert_allclose([x["score"] for x in tbody["labels"]], [x["score"] for x in jbody["labels"]],
                               atol=ATOL)
    jbody, tbody = both(hub_servers, "face_detect", png_bytes(seed=4, size=96), conf_threshold=0.0, max_faces=4)
    assert tbody["count"] > 0
    assert_same_faces(jbody, tbody)
    jbody, tbody = both(hub_servers, "face_detect_and_embed", png_bytes(seed=4, size=96), conf_threshold=0.0,
                        max_faces=2)
    assert_same_faces(jbody, tbody, embeddings=True)


def test_missing_face_weights_boot_the_service_degraded_on_both(tmp_path):
    root = tmp_path / "missing"
    model_dir, _, _ = make_face_model_dir(root)
    os.remove(os.path.join(model_dir, "detection.safetensors"))
    gen = boot_both(deployment(str(root), {"face": face_service("TinyFace")}))
    jstub, tstub, thandle = next(gen)
    try:
        assert "no detection weights" in thandle.services["face"].error
        for stub in (jstub, tstub):
            code, _ = call(stub, "face_detect", png_bytes(size=40))
            assert code == pb.ERROR_CODE_UNAVAILABLE
    finally:
        gen.close()
