"""The port's ``HubRouter`` (the JAX router without its federation half)
and the port's server lifecycle, over real gRPC on the CPU, with echo
services standing in for model services (the pattern of
``tests/test_serving_grpc.py``)."""

from __future__ import annotations

import json
from concurrent import futures

import grpc
import pytest
from google.protobuf import empty_pb2

from lumen_tpu_torch.serving import BaseService, DegradedService, HubRouter, TaskDefinition, TaskRegistry
from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
from lumen_tpu_torch.serving.server import ServerHandle


class EchoService(BaseService):
    def __init__(self, name: str, runtime: str = "torch-cpu"):
        registry = TaskRegistry(name)
        registry.register(TaskDefinition(name=f"{name}_echo", handler=self._echo))
        registry.register(TaskDefinition(name=f"{name}_stream", handler=self._stream))
        super().__init__(registry)
        self.runtime = runtime
        self.closed = False

    def capability(self):
        return self.registry.build_capability(model_ids=[f"{self.registry.service_name}-v0"], runtime=self.runtime)

    def close(self):
        self.closed = True

    def _echo(self, payload, mime, meta):
        return payload, mime or "application/octet-stream", {"echoed": "1"}

    def _stream(self, payload, mime, meta):
        for i in range(3):
            yield f"chunk{i}".encode(), "text/plain", {}


@pytest.fixture()
def hub():
    services = {"echo": EchoService("echo"), "broken": DegradedService("broken", "boom", tasks=["broken_run"])}
    router = HubRouter(services)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    router.attach_to_server(server)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    yield InferenceStub(channel), router, ServerHandle(server, port, router, recovery=None)
    channel.close()
    server.stop(0)


def call(stub, task: str, payload: bytes = b"hi") -> list:
    req = pb.InferRequest(correlation_id="c", task=task, payload=payload, payload_mime="text/plain")
    return list(stub.Infer(iter([req]), timeout=30))


def test_routes_unary_and_streaming_tasks(hub):
    stub, _, _ = hub
    (r,) = call(stub, "echo_echo")
    assert r.result == b"hi" and r.meta["echoed"] == "1" and "lat_ms" in r.meta
    assert [r.result for r in call(stub, "echo_stream")] == [b"chunk0", b"chunk1", b"chunk2"]


@pytest.mark.parametrize("task,code", [
    ("nope", pb.ERROR_CODE_UNAVAILABLE),  # a degraded sibling may own it
    ("broken_run", pb.ERROR_CODE_UNAVAILABLE),  # the degraded service's own route
    ("fed_cache_lookup", pb.ERROR_CODE_UNAVAILABLE),  # reserved tasks are not ported: routed like any
])
def test_unroutable_tasks_answer_in_band(hub, task, code):
    stub, _, _ = hub
    (r,) = call(stub, task)
    assert r.error.code == code


def test_unknown_task_without_degraded_services_is_a_client_error():
    router = HubRouter({"echo": EchoService("echo")})
    first = pb.InferRequest(correlation_id="c", task="fed_kv_put")
    (r,) = router.Infer(iter([first]), None)
    assert r.error.code == pb.ERROR_CODE_INVALID_ARGUMENT and "echo_echo" in r.error.detail


def test_capabilities_aggregate_the_live_services_runtime(hub):
    stub, _, _ = hub
    cap = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
    assert cap.runtime == "torch-cpu"  # the degraded placeholder's "none" does not count
    assert {t.name for t in cap.tasks} >= {"echo_echo", "echo_stream", "broken_run"}
    mixed = HubRouter({"a": EchoService("a"), "b": EchoService("b", runtime="torch-cuda")})
    assert mixed.GetCapabilities(None, None).runtime == "torch"


def test_health_reports_degraded_services_in_trailing_metadata(hub):
    stub, _, _ = hub
    _, call_ = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
    trailing = dict(call_.trailing_metadata())
    assert json.loads(trailing["lumen-service-status"]) == {"broken": "degraded", "echo": "healthy"}
    assert "lumen-fed-status" not in trailing and "lumen-quarantine-size" not in trailing


def test_hot_swap_replaces_the_degraded_service(hub):
    stub, router, _ = hub
    placeholder = router.services["broken"]
    router.replace_service("broken", EchoService("broken"))
    (r,) = call(stub, "broken_echo")
    assert r.result == b"hi"
    (r,) = call(stub, "broken_run")  # the placeholder's route went with it
    assert r.error.code == pb.ERROR_CODE_INVALID_ARGUMENT
    assert placeholder is not router.services["broken"]


def test_drain_refuses_new_streams_then_stops_and_closes(hub):
    stub, router, handle = hub
    router.begin_drain(retry_after_s=2.0)
    (r,) = call(stub, "echo_echo")
    assert r.error.code == pb.ERROR_CODE_UNAVAILABLE and r.meta["lumen-retry-after-ms"] == "2000"
    handle.drain_and_stop(drain_s=0.5)
    assert router.services["echo"].closed
