"""The port's CLIP service over gRPC, held against the JAX server on the CPU.

Both packages boot their own ``serve()`` on ``tests/clip_fixtures``'s tiny
CLIP model directory (HF names, a 3-label dataset whose embeddings are
computed at start-up), float32, with the result cache at a 64 MiB budget
(the suite turns it off). Then, over real gRPC:

- ``clip_image_embed``, ``clip_text_embed``, ``clip_classify`` and
  ``clip_scene_classify`` answer alike: vectors and scores within atol
  1e-5, labels in equal order, for requests sent one at a time and in a
  concurrent burst (the micro-batcher coalesces it);
- the ``tensor/raw`` path (the ``clip_resize`` pixels of a photo) answers
  what the photo's PNG answers, on both;
- a malformed image answers the same error code on both;
- the task lists and the capability ``extra`` keys are equal;
- a repeated request is answered from the result cache on both
  (``cache_hit`` in the response meta, no batch run on the port);
- with a ``clip`` and a ``bioclip`` model configured (a second copy of
  the directory named ``TinyBioCLIP``: ImageNet statistics, raw-cosine
  scores), the ``bioclip_*`` and ``smartclip_*`` tasks answer alike too.
"""

from __future__ import annotations

import json
import shutil
import socket
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import grpc
import numpy as np
import pytest
from google.protobuf import empty_pb2

from lumen_tpu.core.config import validate_config_dict as jax_config
from lumen_tpu.runtime import result_cache as jresult_cache
from lumen_tpu.serving import server as jax_server
from lumen_tpu.serving.proto import ml_service_pb2 as pb
from lumen_tpu.serving.proto.ml_service_pb2_grpc import InferenceStub
from lumen_tpu.utils.host_decode import _spec_clip_resize
from lumen_tpu_torch.core.config import validate_config_dict as port_config
from lumen_tpu_torch.runtime import result_cache as tresult_cache
from lumen_tpu_torch.serving import server as port_server
from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture
from tests.clip_fixtures import make_clip_model_dir, png_bytes

ATOL = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def deployment(cache_dir: str, bioclip: bool = False) -> dict:
    models = {"clip": {"model": "TinyCLIP", "runtime": "jax", "dataset": "Tiny"}}
    if bioclip:
        models["bioclip"] = {"model": "TinyBioCLIP", "runtime": "jax", "dataset": "Tiny"}
    return {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": cache_dir},
        "deployment": {"mode": "single", "service": "clip"},
        "server": {"port": 50996, "host": "127.0.0.1"},
        "services": {
            "clip": {
                "enabled": True,
                "package": "lumen_tpu.models.clip",
                "import_info": {"registry_class": "lumen_tpu.serving.services.clip_service.ClipService"},
                "backend_settings": {"dtype": "float32", "batch_size": 4},
                "models": models,
            }
        },
    }


def boot_both(tmp_path_factory, label: str, bioclip: bool = False):
    root = tmp_path_factory.mktemp(label)
    model_dir = Path(make_clip_model_dir(root))
    if bioclip:
        bio = model_dir.parent / "TinyBioCLIP"
        shutil.copytree(model_dir, bio)
        info = json.loads((bio / "model_info.json").read_text())
        (bio / "model_info.json").write_text(json.dumps({**info, "name": "TinyBioCLIP"}))
    raw = deployment(str(root), bioclip)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_COMPILE_CACHE", "0")
        mp.setenv("LUMEN_CACHE_BYTES", str(64 << 20))
        jresult_cache.reset_result_cache()
        tresult_cache.reset_result_cache()
        jresult_cache.get_result_cache()
        tresult_cache.get_result_cache()
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
        jresult_cache.reset_result_cache()
        tresult_cache.reset_result_cache()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    yield from boot_both(tmp_path_factory, "torch_clip_serving")


@pytest.fixture(scope="module")
def smart_servers(tmp_path_factory):
    yield from boot_both(tmp_path_factory, "torch_smartclip_serving", bioclip=True)


def call(stub, task: str, payload: bytes, mime: str, **meta) -> tuple[int, dict | None, dict]:
    """(error code, body, response meta) of one Infer stream."""
    req = pb.InferRequest(correlation_id="c", task=task, payload=bytes(payload), payload_mime=mime,
                          meta={k: str(v) for k, v in meta.items()})
    last = list(stub.Infer(iter([req]), timeout=120))[-1]
    if last.HasField("error") and last.error.code:
        return last.error.code, None, dict(last.meta)
    return 0, json.loads(last.result), dict(last.meta)


def both(servers, *args, **meta) -> tuple[dict, dict]:
    jstub, tstub, _ = servers
    out = []
    for stub in (jstub, tstub):
        code, body, _ = call(stub, *args, **meta)
        assert code == 0, (args[0], code)
        out.append(body)
    return out[0], out[1]


def assert_same_embedding(jbody: dict, tbody: dict) -> None:
    assert tbody["dim"] == jbody["dim"] and tbody["model_id"] == jbody["model_id"]
    got, want = np.asarray(tbody["vector"]), np.asarray(jbody["vector"])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-5


def assert_same_labels(jbody: dict, tbody: dict) -> None:
    assert [x["label"] for x in tbody["labels"]] == [x["label"] for x in jbody["labels"]]
    np.testing.assert_allclose([x["score"] for x in tbody["labels"]], [x["score"] for x in jbody["labels"]],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_image_embed_matches(servers, seed):
    assert_same_embedding(*both(servers, "clip_image_embed", png_bytes(seed), "image/png"))


@pytest.mark.parametrize("text", ["a photo of a cat", "dog", "car car of photo a"])
def test_text_embed_matches(servers, text):
    assert_same_embedding(*both(servers, "clip_text_embed", text.encode(), "text/plain"))


@pytest.mark.parametrize("seed", [4, 5])
def test_classify_matches(servers, seed):
    jbody, tbody = both(servers, "clip_classify", png_bytes(seed), "image/png", top_k=3)
    assert len(tbody["labels"]) == 3
    assert_same_labels(jbody, tbody)


@pytest.mark.parametrize("seed", [6, 7])
def test_scene_classify_matches(servers, seed):
    jbody, tbody = both(servers, "clip_scene_classify", png_bytes(seed), "image/png")
    assert len(tbody["labels"]) == 3  # the default top_k of the scene task
    assert_same_labels(jbody, tbody)


def test_concurrent_burst_matches(servers):
    """Eight photos at once: the port's batcher coalesces them (a batch of
    more than one item ran) and every answer is the JAX server's."""
    jstub, tstub, thandle = servers
    batcher = thandle.services["clip"].managers["clip"]._image_batcher
    photos = [png_bytes(100 + i, size=48) for i in range(8)]
    before = dict(batcher.stats)
    with ThreadPoolExecutor(8) as pool:
        port = list(pool.map(lambda p: call(tstub, "clip_image_embed", p, "image/png"), photos))
    jax = [call(jstub, "clip_image_embed", p, "image/png") for p in photos]
    for (jcode, jbody, _), (tcode, tbody, _) in zip(jax, port):
        assert jcode == tcode == 0
        assert_same_embedding(jbody, tbody)
    batches = batcher.stats["batches"] - before["batches"]
    assert batcher.stats["items"] - before["items"] == 8 and batches < 8


def test_tensor_raw_path_matches_the_png_path(servers):
    photo = png_bytes(9, size=56)
    pixels = _spec_clip_resize(photo, {"size": 32})
    payload, meta = tensor_payload(pixels)
    jtensor, ttensor = both(servers, "clip_image_embed", payload, TENSOR_MIME, **meta)
    jpng, tpng = both(servers, "clip_image_embed", photo, "image/png")
    assert_same_embedding(jtensor, ttensor)
    np.testing.assert_allclose(ttensor["vector"], tpng["vector"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(jtensor["vector"], jpng["vector"], atol=1e-6, rtol=0)


def test_invalid_image_answers_the_same_code(servers):
    jstub, tstub, _ = servers
    codes = [call(stub, "clip_image_embed", b"\xff\xd8 not an image", "image/jpeg")[0] for stub in (jstub, tstub)]
    assert codes[0] == codes[1] == pb.ERROR_CODE_INVALID_ARGUMENT
    codes = [call(stub, "clip_text_embed", b"", "text/plain")[0] for stub in (jstub, tstub)]
    assert codes[0] == codes[1] == pb.ERROR_CODE_INVALID_ARGUMENT


def test_task_lists_and_capability_keys_match(servers):
    jstub, tstub, _ = servers
    jcaps, tcaps = (stub.GetCapabilities(empty_pb2.Empty(), timeout=30) for stub in (jstub, tstub))
    assert sorted(t.name for t in tcaps.tasks) == sorted(t.name for t in jcaps.tasks) == [
        "clip_classify", "clip_image_embed", "clip_scene_classify", "clip_text_embed"]
    assert tcaps.runtime == "torch-cpu"
    jextra, textra = (next(iter(stub.StreamCapabilities(empty_pb2.Empty(), timeout=30))).extra
                      for stub in (jstub, tstub))
    assert sorted(textra) == sorted(jextra)
    for key in ("embed_dims", "quant_routes", "bulk_stream", "replicas"):
        assert textra[key] == jextra[key], key
    embed = next(t for t in tcaps.tasks if t.name == "clip_image_embed")
    assert TENSOR_MIME in list(embed.input_mimes)


def test_repeat_is_answered_from_the_result_cache(servers):
    jstub, tstub, thandle = servers
    batcher = thandle.services["clip"].managers["clip"]._image_batcher
    photo = png_bytes(21)
    for stub in (jstub, tstub):
        code, first, meta1 = call(stub, "clip_image_embed", photo, "image/png")
        items = batcher.stats["items"]
        code2, second, meta2 = call(stub, "clip_image_embed", photo, "image/png")
        assert code == code2 == 0
        assert "cache_hit" not in meta1 and meta2.get("cache_hit") == "1"
        assert second["vector"] == first["vector"]
        if stub is tstub:
            assert batcher.stats["items"] == items  # no device call for the repeat


def test_bioclip_and_smartclip_tasks_match(smart_servers):
    jstub, tstub, thandle = smart_servers
    jcaps, tcaps = (stub.GetCapabilities(empty_pb2.Empty(), timeout=30) for stub in (jstub, tstub))
    tasks = sorted(t.name for t in tcaps.tasks)
    assert tasks == sorted(t.name for t in jcaps.tasks)
    assert {"bioclip_classify", "smartclip_bioclassify", "smartclip_scene_classify"} <= set(tasks)
    managers = thandle.services["clip"].managers
    assert managers["bioclip"]._image_batcher.name == "bioclip-image"  # scoped per manager
    photo = png_bytes(31)
    assert_same_embedding(*both(smart_servers, "bioclip_image_embed", photo, "image/png"))
    assert_same_embedding(*both(smart_servers, "smartclip_text_embed", b"a photo of a dog", "text/plain"))
    for task in ("bioclip_classify", "smartclip_bioclassify", "smartclip_classify"):
        jbody, tbody = both(smart_servers, task, photo, "image/png", top_k=2)
        assert_same_labels(jbody, tbody)
    # bioclip scores are raw cosines (no softmax): they need not sum to 1
    jbody, tbody = both(smart_servers, "bioclip_classify", photo, "image/png", top_k=3)
    assert abs(sum(x["score"] for x in tbody["labels"]) - 1.0) > 1e-3
    codes = [call(stub, "smartclip_bioclassify", photo, "image/png", namespace="other")[0]
             for stub in (jstub, tstub)]
    assert codes[0] == codes[1] == pb.ERROR_CODE_INVALID_ARGUMENT
