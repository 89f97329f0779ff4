"""The port's fleet layer held against the JAX package's, on the CPU.

- **The ring.** For seeded peer sets and weights, the port's and the JAX
  ``HashRing`` give identical ``owners`` for 1,000 keys and identical
  ``shares`` (exact).
- **The front tier.** A port front and a JAX front over the same
  in-process echo peers send each payload to the same peer. Failover, the
  in-band shed, the exhausted hops, the relayed retry hint, the peer-cache
  lookup answered at the front, health and capabilities behave as in
  ``tests/test_federation.py::TestFrontTier``: each such case runs on both
  packages.
- **Search fan-out.** A port front over two port search backends answers
  a query with the merged top-k of every shard (the exact oracle) and
  partitions an upsert by shard.
- **Cache lookups.** A peer-cache blob that names a JAX-package class is a
  miss in the port, never an import of it; a blob of plain values is a hit.
- **Boot.** ``serve()`` of the port as two echo backends and a front tier
  over real gRPC (the front resolves no device); with ``LUMEN_FED_PEERS``
  unset a port server boots unchanged: no poll thread, no gauge, no hook.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import random
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from lumen_tpu.runtime import federation as jfed
from lumen_tpu.serving import router as jrouter
from lumen_tpu.serving.echo import EchoService as JEchoService
from lumen_tpu.serving.proto import ml_service_pb2 as jpb
from lumen_tpu.utils.qos import RETRY_AFTER_META as J_RETRY
from lumen_tpu_torch.runtime import federation as pfed
from lumen_tpu_torch.serving import router as prouter
from lumen_tpu_torch.serving.echo import EchoService as PEchoService
from lumen_tpu_torch.serving.proto import ml_service_pb2 as ppb
from lumen_tpu_torch.utils.qos import RETRY_AFTER_META as P_RETRY

ROOT = Path(__file__).resolve().parents[1]

PKGS = {
    "jax": SimpleNamespace(fed=jfed, router=jrouter, echo=JEchoService, pb=jpb, retry=J_RETRY),
    "port": SimpleNamespace(fed=pfed, router=prouter, echo=PEchoService, pb=ppb, retry=P_RETRY),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def req(pb, task: str, payload: bytes = b"x", meta: dict | None = None):
    return pb.InferRequest(correlation_id="c1", task=task, payload=payload,
                           payload_mime="application/octet-stream", meta=meta or {})


class InProcStub:
    """A peer without a socket; counts Infer calls so routing tests see
    who served."""

    def __init__(self, servicer):
        self.servicer = servicer
        self.infer_calls = 0

    def Infer(self, request_iterator, timeout=None, metadata=None):  # noqa: N802, ARG002
        self.infer_calls += 1
        return self.servicer.Infer(request_iterator, None)

    def Health(self, request, timeout=None):  # noqa: N802, ARG002
        return self.servicer.Health(request, None)

    def GetCapabilities(self, request, timeout=None):  # noqa: N802, ARG002
        return self.servicer.GetCapabilities(request, None)

    def StreamCapabilities(self, request, timeout=None):  # noqa: N802, ARG002
        return self.servicer.StreamCapabilities(request, None)


class WireStub(InProcStub):
    """A peer of the other package: requests and responses cross as their
    serialized bytes."""

    def __init__(self, servicer, req_cls, resp_cls):
        super().__init__(servicer)
        self.req_cls, self.resp_cls = req_cls, resp_cls

    def Infer(self, request_iterator, timeout=None, metadata=None):  # noqa: N802, ARG002
        self.infer_calls += 1
        msgs = [self.req_cls.FromString(m.SerializeToString()) for m in request_iterator]
        return [self.resp_cls.FromString(r.SerializeToString()) for r in self.servicer.Infer(iter(msgs), None)]


class FakeRpcError(grpc.RpcError):
    def __init__(self, code=grpc.StatusCode.UNAVAILABLE):
        super().__init__()
        self._code = code

    def code(self):
        return self._code


class DeadStub:
    def Infer(self, request_iterator, timeout=None, metadata=None):  # noqa: N802, ARG002
        raise FakeRpcError()

    Health = Infer


def front_of(pkg, stubs: dict, **kw):
    m = pkg.fed.FederationManager([pkg.fed.PeerSpec(n) for n in stubs], stub_factory=lambda a: stubs[a], **kw)
    return pkg.router.FederationRouter(m), m


def echo_peer(pkg):
    return InProcStub(pkg.router.HubRouter({"echo": pkg.echo()}))


class Ctx:
    def __init__(self):
        self.trailing = {}

    def set_trailing_metadata(self, md):
        self.trailing.update(dict(md))

    def abort(self, code, detail):
        raise RuntimeError(f"aborted: {code}: {detail}")


# -- the ring ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_ring_owners_and_shares_match_jax_exactly(seed):
    rng = random.Random(seed)
    names = [f"10.0.{rng.randrange(256)}.{rng.randrange(256)}:{rng.randrange(1024, 65535)}"
             for _ in range(rng.randrange(1, 7))]
    weights = None
    if seed % 2:
        weights = {n: rng.choice([0.0, 0.05, 0.3, 0.5, 1.0, 1.7]) for n in names if rng.random() < 0.7}
    j = jfed.HashRing(names, weights=weights)
    p = pfed.HashRing(names, weights=weights)
    assert p.shares() == j.shares()
    skip = {names[0]} if len(names) > 2 else set()
    for i in range(1000):
        key = hashlib.sha256(f"{seed}/{i}".encode()).hexdigest()[: rng.choice([64, 64, 16, 5])]
        n = rng.randrange(1, 4)
        assert p.owners(key, n, skip) == j.owners(key, n, skip)


def test_ring_properties_hold_in_both_packages(pkg):
    ring = pkg.fed.HashRing
    a, b = ring(["h1:1", "h2:1", "h3:1"]), ring(["h3:1", "h1:1", "h2:1"])
    keys = [digest(f"k{i}".encode()) for i in range(300)]
    assert [a.owner(k) for k in keys] == [b.owner(k) for k in keys]
    assert abs(sum(a.shares().values()) - 1.0) < 1e-9
    smaller = ring(["h1:1", "h2:1"])
    moved = [k for k in keys if a.owner(k) != "h3:1" and smaller.owner(k) != a.owner(k)]
    assert moved == []  # only the departed peer's arcs move
    assert set(ring(["h1:1", "h2:1"], weights={"h2:1": 0.0}).shares()) == {"h1:1", "h2:1"}
    assert ring(["h1:1", "h2:1"], weights={"h2:1": 0.0}).owners(keys[0], 2) == ["h1:1"]


def test_peer_specs_parse_alike(monkeypatch):
    monkeypatch.setenv("LUMEN_FED_PEERS", " a:1 , b:2@9100, a:1, bad, c:3@d:4,")
    got = [[(s.addr, s.sidecar) for s in mod.parse_peer_specs()] for mod in (jfed, pfed)]
    assert got[0] == got[1] == [("a:1", None), ("b:2", "b:9100"), ("c:3", "d:4")]


# -- the front tier ------------------------------------------------------------


def test_port_and_jax_fronts_send_each_payload_to_the_same_peer():
    """Both fronts over the same three port echo peers (the JAX front's
    messages cross as bytes): every payload lands on the same peer, and a
    meta-borne request (empty payload) too."""
    names = ["a:1", "b:1", "c:1"]
    peers = {n: prouter.HubRouter({"echo": PEchoService()}) for n in names}
    served = {}
    for key, pkg in PKGS.items():
        stubs = {n: (InProcStub(r) if key == "port" else WireStub(r, ppb.InferRequest, jpb.InferResponse))
                 for n, r in peers.items()}
        front, m = front_of(pkg, stubs)
        try:
            who = []
            for i in range(60):
                payload, meta = (f"p{i}".encode(), {}) if i % 3 else (b"", {"messages": f"m{i}"})
                before = {n: s.infer_calls for n, s in stubs.items()}
                (resp,) = list(front.Infer(iter([req(pkg.pb, "echo", payload, meta)]), None))
                assert not resp.HasField("error") and resp.result == payload
                who.append(next(n for n, s in stubs.items() if s.infer_calls > before[n]))
            served[key] = who
        finally:
            m.close()
    assert served["port"] == served["jax"]
    assert len(set(served["port"])) == 3


def test_affinity_and_chunked_payload_route_alike(pkg):
    stubs = {"a:1": echo_peer(pkg), "b:1": echo_peer(pkg)}
    front, m = front_of(pkg, stubs)
    try:
        payload = b"A" * 100
        for _ in range(3):
            (resp,) = list(front.Infer(iter([req(pkg.pb, "echo", payload)]), None))
            assert resp.result == payload
        chunks = [
            pkg.pb.InferRequest(correlation_id="c1", task="echo", payload=payload[:50],
                                payload_mime="application/octet-stream", seq=0, total=2),
            pkg.pb.InferRequest(correlation_id="c1", payload=payload[50:], seq=1, total=2, offset=50),
        ]
        (resp,) = list(front.Infer(iter(chunks), None))
        assert resp.result == payload
        assert sorted(s.infer_calls for s in stubs.values()) == [0, 4]
    finally:
        m.close()


def test_transport_failover_to_successor(pkg):
    payload = b"failover-me"
    owner = pkg.fed.HashRing(["a:1", "b:1"]).owner(digest(payload))
    other = "b:1" if owner == "a:1" else "a:1"
    live = echo_peer(pkg)
    front, m = front_of(pkg, {owner: DeadStub(), other: live}, failures=10)
    try:
        (resp,) = list(front.Infer(iter([req(pkg.pb, "echo", payload)]), None))
        assert resp.result == payload and live.infer_calls == 1
        assert m.peers[owner].streak == 1 and m.peers[other].stats["failovers"] == 1
    finally:
        m.close()


def test_client_deadline_is_not_a_peer_health_verdict(pkg):
    payload = b"impatient-client"
    owner = pkg.fed.HashRing(["a:1", "b:1"]).owner(digest(payload))
    other = "b:1" if owner == "a:1" else "a:1"

    class TimedOut:
        def Infer(self, it, timeout=None, metadata=None):  # noqa: N802, ARG002
            raise FakeRpcError(grpc.StatusCode.DEADLINE_EXCEEDED)

    untouched = echo_peer(pkg)
    front, m = front_of(pkg, {owner: TimedOut(), other: untouched}, failures=1)
    try:
        with pytest.raises(grpc.RpcError):
            list(front.Infer(iter([req(pkg.pb, "echo", payload)]), None))
        assert m.peers[owner].streak == 0 and m.peers[owner].state == pkg.fed.SERVING
        assert untouched.infer_calls == 0
    finally:
        m.close()


def test_inband_shed_spills_without_ejecting(pkg):
    payload = b"shed-me"
    owner = pkg.fed.HashRing(["a:1", "b:1"]).owner(digest(payload))
    other = "b:1" if owner == "a:1" else "a:1"
    draining = pkg.router.HubRouter({"echo": pkg.echo()})
    draining.begin_drain(retry_after_s=2.0)
    front, m = front_of(pkg, {owner: InProcStub(draining), other: echo_peer(pkg)})
    try:
        (resp,) = list(front.Infer(iter([req(pkg.pb, "echo", payload)]), None))
        assert resp.result == payload and not resp.HasField("error")
        assert m.peers[owner].stats["sheds"] == 1 and m.peers[owner].state == pkg.fed.SERVING
    finally:
        m.close()


def test_exhausted_hops_relay_the_retry_hint(pkg):
    """Every peer draining: the last peer's in-band answer is relayed
    verbatim with its retry hint, which is echoed into the trailer."""
    stubs = {}
    for name in ("a:1", "b:1"):
        r = pkg.router.HubRouter({"echo": pkg.echo()})
        r.begin_drain(retry_after_s=3.0)
        stubs[name] = InProcStub(r)
    front, m = front_of(pkg, stubs, hops=2)
    ctx = Ctx()
    try:
        (resp,) = list(front.Infer(iter([req(pkg.pb, "echo", b"nowhere")]), ctx))
        assert resp.error.code == pkg.pb.ERROR_CODE_UNAVAILABLE
        assert int(resp.meta[pkg.retry]) == 3000 and ctx.trailing[pkg.retry] == "3000"
    finally:
        m.close()


def test_all_dead_synthesizes_unavailable_with_hint(pkg):
    front, m = front_of(pkg, {"a:1": DeadStub(), "b:1": DeadStub()}, failures=10)
    try:
        (resp,) = list(front.Infer(iter([req(pkg.pb, "echo", b"void")]), None))
        assert resp.error.code == pkg.pb.ERROR_CODE_UNAVAILABLE and "peer" in resp.error.message
        assert int(resp.meta[pkg.retry]) >= 1
    finally:
        m.close()


def test_front_answers_cache_lookup_miss_without_forwarding(pkg):
    backend = echo_peer(pkg)
    front, m = front_of(pkg, {"a:1": backend})
    try:
        (resp,) = list(front.Infer(iter([req(pkg.pb, "fed_cache_lookup", b"ns/t/m@0:00ff",
                                             {"wait_ms": "10000"})]), None))
        assert resp.meta["fed_cache"] == "miss" and backend.infer_calls == 0
    finally:
        m.close()


def test_front_health_capabilities_and_hub_fed_status(pkg):
    stubs = {"a:1": echo_peer(pkg), "b:1": echo_peer(pkg)}
    front, m = front_of(pkg, stubs)
    try:
        ctx = Ctx()
        front.Health(None, ctx)
        assert json.loads(ctx.trailing["lumen-fed-status"])["peers"] == {"a:1": "serving", "b:1": "serving"}
        agg = front.GetCapabilities(None, None)
        names = [t.name for t in agg.tasks]
        assert agg.service_name == "fed-front" and "echo" in names and len(names) == len(set(names))
        assert {c.extra["fed_peer"] for c in front.StreamCapabilities(None, None)} == {"a:1", "b:1"}
        for name in ("a:1", "b:1"):
            for _ in range(3):
                m.record_failure(m.peers[name], "x")
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            front.Health(None, Ctx())
    finally:
        m.close()
    hub_m = pkg.fed.FederationManager([pkg.fed.PeerSpec("a:1"), pkg.fed.PeerSpec("b:1")], self_name="a:1",
                                      stub_factory=lambda a: DeadStub())
    hub = pkg.router.HubRouter({"echo": pkg.echo()})
    hub.federation = hub_m
    try:
        ctx = Ctx()
        hub.Health(None, ctx)
        status = json.loads(ctx.trailing["lumen-fed-status"])
        assert status["self"] == "a:1" and set(status["peers"]) == {"a:1", "b:1"}
    finally:
        hub_m.close()


def test_peer_health_streak_ejects_and_probe_readmits(pkg):
    m = pkg.fed.FederationManager([pkg.fed.PeerSpec("a:1"), pkg.fed.PeerSpec("b:1")],
                                  stub_factory=lambda a: echo_peer(pkg), failures=2, eject_s=0.1)
    try:
        peer = m.peers["a:1"]
        m.record_failure(peer, "x")
        assert peer.state == pkg.fed.SERVING
        m.record_failure(peer, "x")
        assert peer.state == pkg.fed.EJECTED
        assert all(p.name == "b:1" for p in m.plan(digest(b"q")))
        m._probe(peer, True)
        assert peer.state == pkg.fed.SERVING and peer.streak == 0
    finally:
        m.close()


# -- capacity gossip and the drain handoff (both packages) ----------------------


def test_drain_flip_zeroes_weight_and_hands_off_hot_keys(pkg, monkeypatch):
    monkeypatch.setenv("LUMEN_FED_CAPACITY", "1")
    pushed = []

    class Peer(InProcStub):
        def Infer(self, request_iterator, timeout=None, metadata=None):  # noqa: N802, ARG002
            (first,) = list(request_iterator)
            if first.meta.get("op") == "put":
                pushed.append(first.meta["key"])
                return [pkg.pb.InferResponse(correlation_id="x", is_final=True, meta={"fed_cache": "stored"})]
            return [pkg.pb.InferResponse(correlation_id="x", is_final=True, result=pickle.dumps({"v": 1}),
                                         meta={"fed_cache": "hit"})]

    m = pkg.fed.FederationManager([pkg.fed.PeerSpec(n) for n in ("a:1", "b:1", "c:1")],
                                  stub_factory=lambda a: Peer(None))
    try:
        key = "vlm/t/m@0:" + digest(b"hot")
        m._note_capacity(m.peers["a:1"], {"draining": 1, "hot": [key]})
        assert m.peers["a:1"].weight == 0.0 and "a:1" not in {m.ring.owner(digest(f"{i}".encode()))
                                                              for i in range(200)}
        deadline = time.monotonic() + 10
        while not pushed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pushed == [key]
    finally:
        m.close()


# -- search fan-out (the port's search service behind a port front) -------------


def test_search_fanout_merges_every_shard_and_partitions_upserts(monkeypatch):
    """Two port ``search`` backends on the CPU behind a port front: an
    upsert is split by ``shard_of`` (each backend stores only what it
    owns), and every query visits all shards and equals the exact
    oracle."""
    from lumen_tpu_torch.runtime.ann import exact_oracle, shard_of
    from lumen_tpu_torch.serving.services.search_service import SearchService
    from lumen_tpu_torch.utils.tensorwire import BUNDLE_MIME, pack_bundle

    monkeypatch.setenv("LUMEN_ANN_SHARDS", "3")
    backends = {n: SearchService(dim=16, device="cpu") for n in ("a:1", "b:1")}
    stubs = {n: InProcStub(prouter.HubRouter({"search": s})) for n, s in backends.items()}
    front, m = front_of(PKGS["port"], stubs)
    try:
        rng = np.random.default_rng(0)
        vecs = rng.normal(size=(300, 16)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        ids = [f"v{i}" for i in range(300)]
        body = pack_bundle([vecs, np.frombuffer(json.dumps(ids).encode(), np.uint8)])
        up = ppb.InferRequest(correlation_id="u", task="search_upsert", payload=body, payload_mime=BUNDLE_MIME)
        (resp,) = list(front.Infer(iter([up]), None))
        doc = json.loads(resp.result)
        assert doc["added"] == 300 and doc["shards"] == 3
        owners = {s: m.ring.owner(hashlib.sha256(f"ann/default/{s}".encode()).hexdigest()) for s in range(3)}
        for name, svc in backends.items():
            held = {i for shard in svc.index.shards_for("default").values() for i in shard._ids}
            assert held == {i for i in ids if owners[shard_of(i, 3)] == name}
        for qi in range(8):
            q = vecs[qi * 7] + 0.1 * rng.normal(size=16).astype(np.float32)
            qr = ppb.InferRequest(correlation_id="q", task="search_query", payload_mime="application/json",
                                  payload=json.dumps({"vector": q.tolist()}).encode(), meta={"k": "10"})
            (resp,) = list(front.Infer(iter([qr]), None))
            got = json.loads(resp.result)
            want_ids, _ = exact_oracle(ids, vecs, q[None], 10)
            assert got["ids"] == want_ids and got["shards"] == 3
    finally:
        m.close()
        for svc in backends.values():
            svc.close()


# -- peer-cache lookups ----------------------------------------------------------


def test_peer_cache_hit_round_trips_plain_values():
    blob = pickle.dumps({"text": "a cat", "tokens": [1, 2, 3]})

    class Owner:
        def Infer(self, it, timeout=None, metadata=None):  # noqa: N802, ARG002
            return [ppb.InferResponse(correlation_id="c", is_final=True, result=blob, meta={"fed_cache": "hit"})]

    m = pfed.FederationManager([pfed.PeerSpec("a:1"), pfed.PeerSpec("b:1")], self_name="a:1",
                               stub_factory=lambda a: Owner())
    try:
        assert m._lookup_once(m.peers["b:1"], "k", 1.0) == (True, {"text": "a cat", "tokens": [1, 2, 3]})
        assert m.peers["b:1"].stats["cache_hits"] == 1
    finally:
        m.close()


def test_a_blob_naming_a_jax_package_class_is_a_miss_never_an_import(tmp_path):
    """The blob pickles a JAX-package result object. In a process that has
    only the port loaded, the lookup answers miss (and the drain-handoff
    import stores nothing), and the JAX package stays unimported."""
    from lumen_tpu.core.result_schemas import TextGenerationV1

    blob = pickle.dumps(TextGenerationV1(text="a cat", finish_reason="length", generated_tokens=2,
                                         input_tokens=3, model_id="m"))
    assert b"lumen_tpu.core" in blob
    (tmp_path / "blob").write_bytes(blob)
    code = f"""
import json, sys
from lumen_tpu_torch.runtime import federation as fed, result_cache as rc
from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
blob = open({str(tmp_path / "blob")!r}, "rb").read()
class Owner:
    def Infer(self, it, timeout=None, metadata=None):
        return [pb.InferResponse(correlation_id="c", is_final=True, result=blob, meta={{"fed_cache": "hit"}})]
m = fed.FederationManager([fed.PeerSpec("a:1"), fed.PeerSpec("b:1")], self_name="a:1", stub_factory=lambda a: Owner())
got = m._lookup_once(m.peers["b:1"], "k", 1.0)
m.close()
imported = rc.peer_import("k", blob)
print(json.dumps([got[0], got[1] is None, imported, sorted(k for k in sys.modules if k.split(".")[0] == "lumen_tpu")]))
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "LUMEN_CACHE_BYTES": str(1 << 20)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False, True, False, []]


# -- serve(): front tier and backends over real gRPC ----------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def echo_config(tmp_path, name: str, enabled: bool = True) -> dict:
    return {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(tmp_path / f"cache-{name}")},
        "deployment": {"mode": "hub", "services": ["echo"]},
        "server": {"port": free_port(), "host": "127.0.0.1"},
        "services": {"echo": {
            "enabled": enabled, "package": "lumen_tpu",
            "import_info": {"registry_class": "lumen_tpu.serving.echo.EchoService"},
            "models": {"echo": {"model": "test/model-echo"}},
        }},
    }


def test_serve_front_tier_end_to_end_with_peer_kill(tmp_path, monkeypatch):
    """Two port echo backends and a port front tier over loopback gRPC.
    The front boots without ``device=`` and resolves none (on a machine
    without a card, resolving one would raise); a killed backend's
    payloads fail over, and the poller ejects it with a ``fed_peer_down``
    event."""
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
    from lumen_tpu_torch.serving.server import serve
    from lumen_tpu_torch.utils import telemetry

    monkeypatch.delenv("LUMEN_FED_PEERS", raising=False)
    telemetry.reset_hub()
    backends = [serve(validate_config_dict(echo_config(tmp_path, f"b{i}")), skip_download=True, device="cpu")
                for i in range(2)]
    front = chan = None
    try:
        peers = ",".join(f"127.0.0.1:{b.port}" for b in backends)
        monkeypatch.setenv("LUMEN_FED_PEERS", peers)
        monkeypatch.setenv("LUMEN_FED_POLL_S", "0.2")
        monkeypatch.setenv("LUMEN_FED_FAILURES", "2")
        monkeypatch.setenv("LUMEN_FED_EJECT_S", "60")
        front = serve(validate_config_dict(echo_config(tmp_path, "front", enabled=False)), skip_download=True,
                      metrics_port=0)
        assert isinstance(front.router, prouter.FederationRouter) and front.federation is not None
        assert any(t.name == "fed-poll" for t in threading.enumerate())
        chan = grpc.insecure_channel(f"127.0.0.1:{front.port}")
        grpc.channel_ready_future(chan).result(timeout=10)
        stub = InferenceStub(chan)
        for i in range(10):
            (resp,) = list(stub.Infer(iter([req(ppb, "echo", f"p{i}".encode())])))
            assert resp.result == f"p{i}".encode()
        _, call = stub.Health.with_call(empty_pb2.Empty(), timeout=5)
        trailing = {i.key: i.value for i in call.trailing_metadata()}
        assert sorted(json.loads(trailing["lumen-fed-status"])["peers"]) == sorted(peers.split(","))
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{front.metrics_server.port}/peers", timeout=5) as r:
            view = json.loads(r.read().decode())
        assert view["enabled"] and view["mode"] == "front"
        backends[0].stop(grace=0.5)
        for i in range(20):
            (resp,) = list(stub.Infer(iter([req(ppb, "echo", f"k{i}".encode())])))
            assert resp.result == f"k{i}".encode(), resp
        dead = f"127.0.0.1:{backends[0].port}"
        deadline = time.monotonic() + 10
        while front.federation.peers[dead].state != pfed.EJECTED and time.monotonic() < deadline:
            time.sleep(0.1)
        assert front.federation.peers[dead].state == pfed.EJECTED
        assert "fed_peer_down" in [e["kind"] for e in telemetry.export_events()["events"]]
    finally:
        if chan is not None:
            chan.close()
        if front is not None:
            front.stop(grace=0.5)
        for b in backends[1:]:
            b.stop(grace=0.5)
        pfed.install_federation(None)
        telemetry.reset_hub()
    assert not any(t.name == "fed-poll" for t in threading.enumerate())
    assert pfed.get_federation() is None


def test_unset_peers_boot_single_host_unchanged(tmp_path, monkeypatch):
    """``LUMEN_FED_PEERS`` unset: a plain ``HubRouter``, no federation, no
    poll thread, no ``federation:*`` gauge, no peer-cache hook, and
    ``Health`` carries no fleet key."""
    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.runtime.result_cache import get_result_cache
    from lumen_tpu_torch.serving.server import serve
    from lumen_tpu_torch.utils.metrics import metrics

    monkeypatch.delenv("LUMEN_FED_PEERS", raising=False)
    monkeypatch.delenv("LUMEN_FED_DISCOVER", raising=False)
    handle = serve(validate_config_dict(echo_config(tmp_path, "solo")), skip_download=True, device="cpu")
    try:
        assert handle.federation is None and handle.router.federation is None
        assert handle.router.kv_migration is None and type(handle.router) is prouter.HubRouter
        assert not any(t.name == "fed-poll" for t in threading.enumerate())
        assert not [k for k in metrics.snapshot().get("gauges", {}) if k.startswith("federation:")]
        assert get_result_cache().peer_lookup is None
        ctx = Ctx()
        handle.router.Health(None, ctx)
        assert "lumen-fed-status" not in ctx.trailing
    finally:
        handle.stop(grace=0.5)


def test_no_services_and_no_peers_refuses_to_boot(tmp_path, monkeypatch):
    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.serving.server import serve

    monkeypatch.delenv("LUMEN_FED_PEERS", raising=False)
    with pytest.raises(SystemExit):
        serve(validate_config_dict(echo_config(tmp_path, "none", enabled=False)), skip_download=True)
