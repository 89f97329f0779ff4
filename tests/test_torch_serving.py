"""The port's serving layer against the JAX server, over real gRPC.

One tiny model directory (``tests/test_vlm.py::make_vlm_model_dir``:
native safetensors, config.json, a WordLevel tokenizer, a Jinja2 chat
template, model_info.json) is served twice on the CPU in f32: by the JAX
package (its ``VlmService`` behind its ``HubRouter`` on a gRPC server)
and by the port's ``serve()`` from a deployment config naming the JAX
service class (``lumen_tpu.serving.services.vlm_service.VlmService``),
which the port's loader maps onto its own. Both get the same requests;
greedy decoding must agree exactly (the tolerance of the earlier slices):

- stream deltas byte-equal, and the final ``TextGenerationV1`` JSON equal
  except its timing keys;
- the same wire error codes for a bad image and for missing messages;
- the same task names and input/output mimes in ``GetCapabilities``
  (the runtime differs by design).

Every request carries a distinct prompt, so the JAX server's result
cache (on by default) never answers one of them from an earlier one.
"""

from __future__ import annotations

import json
from concurrent import futures

import grpc
import pytest
from google.protobuf import empty_pb2

from lumen_tpu.core.config import validate_config_dict as jax_config
from lumen_tpu.serving import HubRouter as JHubRouter
from lumen_tpu.serving.proto import ml_service_pb2 as pb
from lumen_tpu.serving.proto.ml_service_pb2_grpc import InferenceStub, add_InferenceServicer_to_server
from lumen_tpu.serving.server import build_services as jax_build_services
from lumen_tpu_torch.core.config import validate_config_dict as port_config
from lumen_tpu_torch.serving import server as port_server
from test_vlm import make_vlm_model_dir, png_bytes

TIMING_KEYS = ("generation_time_ms", "tokens_per_second", "ttft_ms")


def deployment(cache_dir: str) -> dict:
    return {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": cache_dir},
        "deployment": {"mode": "single", "service": "vlm"},
        "server": {"port": 50999, "host": "127.0.0.1"},
        "services": {
            "vlm": {
                "enabled": True,
                "package": "lumen_tpu.models.vlm",
                "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
                "backend_settings": {"dtype": "float32", "batch_size": 2, "batch_buckets": [16, 32]},
                "models": {"vlm": {"model": "TinyVLM", "runtime": "jax"}},
            }
        },
    }


@pytest.fixture(scope="module")
def stubs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    make_vlm_model_dir(root)
    raw = deployment(str(root))
    jservices = jax_build_services(jax_config(raw))
    jserver = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    add_InferenceServicer_to_server(JHubRouter(jservices), jserver)
    jport = jserver.add_insecure_port("127.0.0.1:0")
    jserver.start()
    handle = port_server.serve(port_config(raw), port_override=0, skip_download=True, device="cpu")
    jchan = grpc.insecure_channel(f"127.0.0.1:{jport}")
    tchan = grpc.insecure_channel(f"127.0.0.1:{handle.port}")
    yield InferenceStub(jchan), InferenceStub(tchan), handle
    jchan.close()
    tchan.close()
    handle.stop(grace=1.0)
    jserver.stop(0)
    for svc in jservices.values():
        svc.close()


def infer(stub, task: str, prompt: str | None, image: bytes = b"", **meta) -> list:
    if prompt is not None:
        meta["messages"] = json.dumps([{"role": "user", "content": prompt}])
    req = pb.InferRequest(
        correlation_id="c0", task=task, payload=image, payload_mime="image/png",
        meta={k: str(v) for k, v in meta.items()},
    )
    return list(stub.Infer(iter([req]), timeout=120))


def split(responses) -> tuple[list[bytes], dict | None, int]:
    """(delta chunks, final body without timing keys, error code)."""
    *deltas, last = responses
    if last.HasField("error") and last.error.code:
        return [r.result for r in deltas], None, last.error.code
    body = json.loads(last.result)
    assert "cached" not in body["metadata"]  # computed, not a result-cache replay
    for key in TIMING_KEYS:
        body["metadata"].pop(key, None)
    return [r.result for r in deltas], body, 0


REQUESTS = [
    ("vlm_generate", "describe the image", 1, {"max_new_tokens": 8}),
    ("vlm_generate_stream", "a cat", 2, {"max_new_tokens": 8}),
    ("vlm_generate", "the dog", None, {"max_new_tokens": 6}),
    ("vlm_generate_stream", "a dog the cat", None, {"max_new_tokens": 7}),
    ("vlm_generate_stream", "describe a cat", 3, {"max_new_tokens": 9, "add_generation_prompt": "false"}),
]


@pytest.mark.parametrize("task,prompt,seed,meta", REQUESTS, ids=[f"{t}-{p}" for t, p, _, _ in REQUESTS])
def test_requests_match_the_jax_server(stubs, task, prompt, seed, meta):
    jstub, tstub, _ = stubs
    image = b"" if seed is None else png_bytes(seed=seed)
    want = split(infer(jstub, task, prompt, image, **meta))
    got = split(infer(tstub, task, prompt, image, **meta))
    assert got == want
    deltas, body, code = got
    assert code == 0 and body["generated_tokens"] > 0
    if task == "vlm_generate_stream":
        assert b"".join(deltas).decode() == body["text"]


@pytest.mark.parametrize("task", ["vlm_generate", "vlm_generate_stream"])
def test_stop_sequences_match_the_jax_server(stubs, task):
    jstub, tstub, _ = stubs
    prompt, image = "describe the dog", png_bytes(seed=4)
    _, full, _ = split(infer(jstub, "vlm_generate", prompt, image, max_new_tokens=10))
    words = full["text"].split()
    assert len(words) >= 3
    stops = json.dumps([words[2]])
    want = split(infer(jstub, task, prompt, image, max_new_tokens=10, stop_sequences=stops))
    got = split(infer(tstub, task, prompt, image, max_new_tokens=10, stop_sequences=stops))
    assert got == want
    assert got[1]["finish_reason"] == "stop_sequence"


@pytest.mark.parametrize("task", ["vlm_generate", "vlm_generate_stream"])
@pytest.mark.parametrize("case", ["bad_image", "no_messages"])
def test_errors_match_the_jax_server(stubs, task, case):
    jstub, tstub, _ = stubs
    if case == "bad_image":
        args = (f"{case} {task}", b"not an image")
    else:
        args = (None, png_bytes(seed=5))
    want = split(infer(jstub, task, *args))
    got = split(infer(tstub, task, *args))
    assert got[2] == want[2] == pb.ERROR_CODE_INVALID_ARGUMENT
    assert got[0] == want[0] == []


def test_capabilities_match_the_jax_server(stubs):
    jstub, tstub, handle = stubs
    want = jstub.GetCapabilities(empty_pb2.Empty(), timeout=30)
    got = tstub.GetCapabilities(empty_pb2.Empty(), timeout=30)

    def tasks(cap):
        return [(t.name, tuple(t.input_mimes), tuple(t.output_mimes)) for t in cap.tasks]

    assert tasks(got) == tasks(want)
    assert {t[0] for t in tasks(got)} == {"vlm_generate", "vlm_generate_stream"}
    assert list(got.model_ids) == list(want.model_ids) == ["TinyVLM"]
    assert got.runtime == "torch-cpu"
    (stream_cap,) = tstub.StreamCapabilities(empty_pb2.Empty(), timeout=30)
    assert stream_cap.extra["kv_layout"].startswith("paged(") and stream_cap.extra["device"] == "cpu"
    assert tstub.Health(empty_pb2.Empty(), timeout=30) == empty_pb2.Empty()
    assert type(handle.services["vlm"]).__module__ == "lumen_tpu_torch.serving.services.vlm_service"
