"""Graceful drain of the port's server, on the CPU (the mirror of
``tests/test_drain.py``): a real ``serve()`` with ``device="cpu"`` whose
drain completes in-flight work, answers late requests UNAVAILABLE with a
``lumen-retry-after-ms`` hint and records ``server_drain`` events; the
announce hold (``LUMEN_DRAIN_ANNOUNCE_S``) keeps an idle server open until
a watching front has read the draining flag, and the front then records
one drain handoff and no ``fed_peer_down``; an unwatched drain is not held;
and the CLI (``--device cpu``) drains on SIGTERM and exits 0."""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import grpc
import pytest
from google.protobuf import empty_pb2

from lumen_tpu_torch.core.config import validate_config_dict
from lumen_tpu_torch.serving.base_service import BaseService
from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
from lumen_tpu_torch.serving.registry import TaskDefinition, TaskRegistry
from lumen_tpu_torch.serving.router import FED_CAPACITY_META
from lumen_tpu_torch.serving.server import serve
from lumen_tpu_torch.utils import telemetry
from lumen_tpu_torch.utils.qos import RETRY_AFTER_META

ROOT = Path(__file__).resolve().parents[1]


class SlowEchoService(BaseService):
    """``slow_echo``: sleeps ``meta["sleep_s"]`` and echoes the payload, so
    a stream stays in flight across a drain."""

    def __init__(self):
        registry = TaskRegistry("slow")
        registry.register(TaskDefinition(name="slow_echo", handler=self._slow, description="sleep, then echo"))
        super().__init__(registry)

    @classmethod
    def from_config(cls, service_config, cache_dir, device=None):  # noqa: ARG003
        return cls()

    def capability(self):
        return self.registry.build_capability(model_ids=["slow"], runtime="none")

    def _slow(self, payload, mime, meta):
        time.sleep(float(meta.get("sleep_s", "0.5")))
        return payload, mime or "text/plain", {"slow": "1"}


def drain_config(tmp_path) -> dict:
    return {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(tmp_path / "cache")},
        "deployment": {"mode": "hub", "services": ["echo", "slow"]},
        "server": {"port": 50953, "host": "127.0.0.1"},
        "services": {
            "echo": {"enabled": True, "package": "lumen_tpu",
                     "import_info": {"registry_class": "lumen_tpu.serving.echo.EchoService"},
                     "models": {"echo": {"model": "test/model-echo"}}},
            "slow": {"enabled": True, "package": "lumen_tpu",
                     "import_info": {"registry_class": f"{__name__}.SlowEchoService"},
                     "models": {"slow": {"model": "test/model-slow"}}},
        },
    }


def req(task: str, cid: str = "c1", meta: dict | None = None):
    return pb.InferRequest(correlation_id=cid, task=task, payload=b"x", payload_mime="text/plain", meta=meta or {})


@pytest.fixture()
def booted(tmp_path, monkeypatch):
    monkeypatch.delenv("LUMEN_FED_PEERS", raising=False)
    handle = serve(validate_config_dict(drain_config(tmp_path)), port_override=0, skip_download=True, device="cpu")
    chan = grpc.insecure_channel(f"127.0.0.1:{handle.port}")
    grpc.channel_ready_future(chan).result(timeout=10)
    yield handle, InferenceStub(chan)
    chan.close()
    handle.stop(grace=0.2)


def test_drain_completes_inflight_rejects_late_and_records(booted):
    handle, stub = booted
    results: dict = {}

    def inflight():
        (results["r"],) = stub.Infer(iter([req("slow_echo", meta={"sleep_s": "1.0"})]))

    t = threading.Thread(target=inflight, daemon=True)
    t.start()
    time.sleep(0.3)
    assert handle.router.active_streams() == 1
    handle.router.begin_drain(retry_after_s=5.0)
    (late,) = stub.Infer(iter([req("echo", cid="late")]))
    assert late.error.code == pb.ERROR_CODE_UNAVAILABLE and "drain" in late.error.message
    assert int(late.meta[RETRY_AFTER_META]) >= 1
    t0 = time.monotonic()
    handle.drain_and_stop(drain_s=8.0)
    assert time.monotonic() - t0 < 8.0
    t.join(timeout=5)
    r = results["r"]
    assert not r.HasField("error") and r.result == b"x" and r.meta.get("slow") == "1"
    drains = [e for e in telemetry.export_events()["events"] if e["kind"] == "server_drain"]
    assert "drain started" in drains[-2]["message"] and "drain complete" in drains[-1]["message"]


def test_idle_drain_holds_for_a_watching_front(booted, monkeypatch):
    monkeypatch.setenv("LUMEN_FED_CAPACITY", "1")
    handle, stub = booted

    def probe() -> dict:
        _, call = stub.Health.with_call(empty_pb2.Empty())
        return json.loads(dict(call.trailing_metadata())[FED_CAPACITY_META])

    assert probe()["draining"] == 0 and handle.router.capacity_probe_age() is not None
    done = threading.Event()
    t0 = time.monotonic()
    t = threading.Thread(target=lambda: (handle.drain_and_stop(drain_s=8.0), done.set()), daemon=True)
    t.start()
    assert not done.wait(0.8), "idle drain tore down before the flag was gossiped"
    assert probe()["draining"] == 1
    assert done.wait(4.0), "drain never completed after the probe"
    assert time.monotonic() - t0 < 5.0
    t.join(timeout=5)


def test_unwatched_drain_is_not_held(booted, monkeypatch):
    monkeypatch.setenv("LUMEN_FED_CAPACITY", "1")
    handle, _ = booted
    assert handle.router.capacity_probe_age() is None
    t0 = time.monotonic()
    handle.drain_and_stop(drain_s=8.0)
    assert time.monotonic() - t0 < 2.0


def test_a_watching_front_records_one_handoff_and_no_peer_down(booted, monkeypatch):
    """A port ``FederationManager`` polling the backend with capacity
    gossip on: the backend's drain is announced on a probe, the front
    zeroes its weight and records one ``fed_drain_handoff``, and no
    failure ever ejects it."""
    from lumen_tpu_torch.runtime.federation import FederationManager, PeerSpec
    from lumen_tpu_torch.utils.metrics import metrics

    monkeypatch.setenv("LUMEN_FED_CAPACITY", "1")
    handle, _ = booted
    name = f"127.0.0.1:{handle.port}"
    before = metrics.counter_value("fed_drain_handoffs")
    telemetry.reset_hub()
    front = FederationManager([PeerSpec(name), PeerSpec("127.0.0.1:1")], poll_s=0.2, failures=2)
    front.start()
    try:
        deadline = time.monotonic() + 10
        while not front.peers[name].capacity and time.monotonic() < deadline:
            time.sleep(0.05)
        assert front.peers[name].capacity.get("draining") == 0
        handle.drain_and_stop(drain_s=8.0)
        assert metrics.counter_value("fed_drain_handoffs") == before + 1
        assert front.peers[name].weight == 0.0
        downs = [e for e in telemetry.export_events()["events"]
                 if e["kind"] == "fed_peer_down" and e["component"] == name]
        assert downs == []
    finally:
        front.close()
        telemetry.reset_hub()


def test_cli_drains_on_sigterm_and_exits_zero(tmp_path):
    """``python -m lumen_tpu_torch.serving.server --device cpu`` as a child:
    SIGTERM while a slow request is in flight; the request completes, a
    late one gets the retry hint, and the process exits 0."""
    cfg_path = tmp_path / "drain.json"  # JSON is valid YAML
    cfg = drain_config(tmp_path)
    cfg["services"]["slow"]["import_info"]["registry_class"] = "test_torch_drain.SlowEchoService"
    cfg_path.write_text(json.dumps(cfg))
    env = {**os.environ, "LUMEN_DRAIN_S": "10", "LUMEN_BREAKER_FAILURES": "0",
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])}
    env.pop("LUMEN_FED_PEERS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "lumen_tpu_torch.serving.server", "--config", str(cfg_path), "--skip-download",
         "--device", "cpu", "--port", "0"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        port = None
        deadline = time.monotonic() + 120
        for line in proc.stderr:
            m = re.search(r"service\(s\) on 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
            if time.monotonic() > deadline:
                break
        assert port, "the child never reached its readiness line"
        threading.Thread(target=proc.stderr.read, daemon=True).start()
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        grpc.channel_ready_future(chan).result(timeout=20)
        stub = InferenceStub(chan)
        results: dict = {}

        def inflight():
            (results["r"],) = stub.Infer(iter([req("slow_echo", meta={"sleep_s": "3.0"})]), timeout=30)

        t = threading.Thread(target=inflight, daemon=True)
        t.start()
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        time.sleep(1.5)
        (late,) = stub.Infer(iter([req("echo", cid="late")]), timeout=10)
        assert late.error.code == pb.ERROR_CODE_UNAVAILABLE and int(late.meta[RETRY_AFTER_META]) >= 1
        t.join(timeout=20)
        r = results.get("r")
        assert r is not None and not r.HasField("error") and r.result == b"x"
        assert proc.wait(timeout=20) == 0
        chan.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
