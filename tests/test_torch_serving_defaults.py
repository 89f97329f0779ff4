"""The JAX server's default VLM serving behaviour, held against the port's
over real gRPC on the CPU.

Both packages boot their own ``serve()`` on ``tests/test_vlm.py``'s tiny
model directory (the deployment of ``tests/test_torch_serving.py``, f32)
with the metrics sidecar on an OS-assigned loopback port, the result
cache at a 64 MiB budget and the circuit breaker at its production
default of 6 failures (the suite turns both off). Then:

- a repeated greedy ``vlm_generate`` is answered from the result cache on
  both servers (``cached`` in the metadata, the same text);
- ``Health`` carries the same trailing keys (the breaker and quarantine
  ones included);
- the VLM path's names in ``/metrics.json`` (task histograms, ``vlm.*``
  histograms, ``vlm_*`` and ``cache_*`` counters, the
  ``vlm-continuous:{name}`` gauge keys) are the same;
- with the spill tier off (``LUMEN_VLM_SPILL_BYTES=0``) and a pool of 6
  pages (``LUMEN_VLM_KV_PAGES``), two concurrent sampled streams cannot
  both finish: one is preempted after it streamed, and both servers shed
  it with the same error (``UNAVAILABLE``, the wire form of
  RESOURCE_EXHAUSTED) and the same ``lumen-retry-after-ms`` hint key.
"""

from __future__ import annotations

import gc
import json
import socket
import threading
import urllib.error
import urllib.request

import grpc
import pytest
from google.protobuf import empty_pb2

from lumen_tpu.core.config import validate_config_dict as jax_config
from lumen_tpu.runtime import quarantine as jquarantine
from lumen_tpu.runtime import result_cache as jresult_cache
from lumen_tpu.serving import server as jax_server
from lumen_tpu.serving.proto import ml_service_pb2 as pb
from lumen_tpu.serving.proto.ml_service_pb2_grpc import InferenceStub
from lumen_tpu.utils import qos as jqos
from lumen_tpu_torch.core.config import validate_config_dict as port_config
from lumen_tpu_torch.runtime import quarantine as tquarantine
from lumen_tpu_torch.runtime import result_cache as tresult_cache
from lumen_tpu_torch.serving import server as port_server
from lumen_tpu_torch.utils import qos as tqos
from lumen_tpu_torch.utils.qos import RETRY_AFTER_META
from test_torch_serving import deployment, infer
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture
from test_vlm import make_vlm_model_dir, png_bytes


def free_port() -> int:
    """A port for the JAX ``serve()``, which reads ``port_override=0`` as
    "the configured port"."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reset_process_state() -> None:
    """Give both servers the process-wide state a fresh server process has,
    so ``Health`` reports theirs alone. Each package keeps a registry of
    live WFQ admission queues (``utils/qos.py``, weakly held; Health's
    ``lumen-qos-status``) that holds the queue of every micro-batcher not
    yet garbage-collected: a CLIP manager closed by an earlier test file on
    the same worker (``tests/test_clip.py``, ``tests/test_host_lane.py``)
    sits in a reference cycle until the collector runs, and its
    ``clip-image``/``clip-text`` queues showed up on the JAX server's
    Health only. The collector cannot drop a queue whose batcher is still
    live: earlier files on the same worker leave running batchers behind
    (``tests/test_torch_search.py``'s ``search:t*`` shards,
    ``tests/test_torch_ingest.py``'s ``clip-*``/``face-*``,
    ``tests/test_torch_batcher.py``'s ``multi``/``dead-fetch``), in one
    package's registry and not the other's, and the port server's Health
    then carried ``lumen-qos-status`` alone. So both registries start
    empty, as in a fresh process. Also dropped: both quarantine registries
    (Health's ``lumen-quarantine-size``) and both tenant quotas. The
    breakers are per service, built by each ``serve()``."""
    gc.collect()
    for quarantine, qos in ((jquarantine, jqos), (tquarantine, tqos)):
        quarantine.reset_quarantine()
        qos.reset_quota()
        qos._wfq_registry.clear()


def boot_both(tmp_path_factory, label: str, **env):
    """Both servers on one model directory, with ``env`` set while they are
    built; yields ``(jax stub, port stub, jax handle, port handle)``."""
    reset_process_state()
    root = tmp_path_factory.mktemp(label)
    make_vlm_model_dir(root)
    raw = deployment(str(root))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_COMPILE_CACHE", "0")
        mp.setenv("LUMEN_CACHE_BYTES", str(64 << 20))
        mp.setenv("LUMEN_BREAKER_FAILURES", "6")
        for k, v in env.items():
            mp.setenv(k, v)
        # Rebuilt under this environment (the JAX serve() builds its cache
        # lazily, after the environment is restored).
        jresult_cache.reset_result_cache()
        tresult_cache.reset_result_cache()
        jresult_cache.get_result_cache()
        jhandle = jax_server.serve(jax_config(raw), port_override=free_port(), skip_download=True, metrics_port=0)
        thandle = port_server.serve(port_config(raw), port_override=0, skip_download=True, metrics_port=0,
                                    device="cpu")
    jchan = grpc.insecure_channel(f"127.0.0.1:{jhandle.port}")
    tchan = grpc.insecure_channel(f"127.0.0.1:{thandle.port}")
    try:
        yield InferenceStub(jchan), InferenceStub(tchan), jhandle, thandle
    finally:
        jchan.close()
        tchan.close()
        thandle.stop(grace=1.0)
        jhandle.stop(grace=1.0)
        # The suite runs with the result cache off: leave it so.
        jresult_cache.reset_result_cache()
        tresult_cache.reset_result_cache()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    yield from boot_both(tmp_path_factory, "serving_defaults")


@pytest.fixture(scope="module")
def shed_servers(tmp_path_factory):
    yield from boot_both(tmp_path_factory, "serving_shed", LUMEN_VLM_SPILL_BYTES="0", LUMEN_VLM_KV_PAGES="6")


def final(responses) -> pb.InferResponse:
    return responses[-1]


def test_repeated_greedy_request_is_cached_on_both(servers):
    jstub, tstub, _, _ = servers
    image = png_bytes(seed=11)
    bodies = {}
    for name, stub in (("jax", jstub), ("port", tstub)):
        first, second = (
            json.loads(final(infer(stub, "vlm_generate", "describe the cat", image, max_new_tokens=6)).result)
            for _ in range(2)
        )
        assert "cached" not in first["metadata"]
        assert second["metadata"]["cached"] is True
        assert second["text"] == first["text"] and second["generated_tokens"] == first["generated_tokens"]
        bodies[name] = first
    assert bodies["port"]["text"] == bodies["jax"]["text"]


def test_health_trailing_keys_match(servers):
    jstub, tstub, _, _ = servers
    keys, trailers = [], []
    for stub in (jstub, tstub):
        _, call = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
        trailing = dict(call.trailing_metadata())
        keys.append(sorted(trailing))
        trailers.append(trailing)
        assert json.loads(trailing["lumen-breaker-status"]) == {"vlm": "closed"}
        assert trailing["lumen-quarantine-size"] == "0"
    jax_only, port_only = sorted(set(keys[0]) - set(keys[1])), sorted(set(keys[1]) - set(keys[0]))
    assert keys[1] == keys[0], (
        f"Health trailing keys differ: JAX only {jax_only} {[trailers[0][k] for k in jax_only]}, "
        f"port only {port_only} {[trailers[1][k] for k in port_only]}"
    )


def metrics_json(handle) -> dict:
    url = f"http://127.0.0.1:{handle.metrics_server.port}/metrics.json"
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.load(resp)


def vlm_names(before: dict, after: dict) -> dict:
    """The VLM path's names in a ``/metrics.json`` pair: histograms whose
    count moved, counters that moved, and the engine's gauge keys."""

    def moved(section: str, value) -> list:
        old = before.get(section, {})
        return sorted(k for k, v in after.get(section, {}).items() if k not in old or value(v) != value(old[k]))

    tasks = [k for k in moved("tasks", lambda v: v["count"]) if k.startswith("vlm")]
    counters = [k for k in moved("counters", lambda v: v) if k.startswith(("vlm_", "cache_"))]
    gauges = sorted(after["gauges"]["vlm-continuous:TinyVLM"])
    return {"tasks": tasks, "counters": counters, "gauges": gauges}


def test_metrics_json_names_match(servers):
    jstub, tstub, jhandle, thandle = servers
    names = []
    for stub, handle in ((jstub, jhandle), (tstub, thandle)):
        before = metrics_json(handle)
        for task in ("vlm_generate_stream", "vlm_generate"):
            for _ in range(2):  # a miss, then a result-cache hit for the unary task
                r = final(infer(stub, task, "a dog", png_bytes(seed=12), max_new_tokens=5))
                assert not r.error.code
        after = metrics_json(handle)
        names.append(vlm_names(before, after))
        assert {"vlm.ttft", "vlm.decode_tps", "vlm_generate", "vlm_generate_stream"} <= set(names[-1]["tasks"])
        assert "cache_hits" in names[-1]["counters"]
        assert "device_memory" in after
    assert names[1] == names[0]


def test_profiler_endpoints_write_a_chrome_trace(servers, tmp_path):
    """The sidecar's ``jax.profiler`` control, ported to a ``torch.profiler``
    session: start, a second start refused, stop writes ``trace.json``
    into the requested directory, a second stop refused."""
    *_, thandle = servers

    def post(path: str):
        req = urllib.request.Request(f"http://127.0.0.1:{thandle.metrics_server.port}{path}", method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.load(resp)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    trace_dir = tmp_path / "trace"
    assert post(f"/profiler/start?dir={trace_dir}") == (200, {"tracing": True, "dir": str(trace_dir)})
    assert post(f"/profiler/start?dir={trace_dir}")[0] == 409
    assert post("/profiler/stop") == (200, {"stopped": True, "dir": str(trace_dir)})
    assert post("/profiler/stop")[0] == 409
    assert "traceEvents" in json.loads((trace_dir / "trace.json").read_text())


def test_preempted_sampled_stream_is_shed_alike(shed_servers):
    """The repair of the port's preemption shed: a sampled stream preempted
    after it delivered tokens answers RESOURCE_EXHAUSTED (``UNAVAILABLE``
    on the wire) with ``lumen-retry-after-ms`` on both servers, not
    INTERNAL."""
    jstub, tstub, jhandle, thandle = shed_servers
    sheds = []
    for stub in (jstub, tstub):
        out: dict[int, list] = {}

        def run(i):
            out[i] = infer(stub, "vlm_generate_stream", f"the {'cat' if i else 'dog'}", b"", max_new_tokens=40,
                           do_sample="true", temperature=0.01)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        finals = [final(out[i]) for i in range(2)]
        shed = [r for r in finals if r.error.code]
        assert len(shed) == 1, [(r.error.code, r.error.message) for r in finals]
        assert any(not r.is_final for r in out[finals.index(shed[0])])  # it had streamed
        sheds.append(shed[0])
    for r in sheds:
        assert r.error.code == pb.ERROR_CODE_UNAVAILABLE, r.error.message
        assert int(r.meta[RETRY_AFTER_META]) > 0
    assert sorted(sheds[1].meta) == sorted(sheds[0].meta)
    for handle in (jhandle, thandle):
        mgr = handle.services["vlm"].manager
        eng = mgr._continuous if hasattr(mgr, "_continuous") else mgr.engine
        assert eng.preempt_failed == 1 and eng.spills == 0
