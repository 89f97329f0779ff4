"""Disaggregated prefill/decode in the port, held against the JAX package.

The mirror of ``tests/test_disagg.py`` for ``lumen_tpu_torch``:

- the router's reserved ``fed_kv_put`` task and the role-aware forward
  plan behave the same in both packages (each case runs on both);
- the port's decode sink refuses a malformed commit (unknown op,
  truncated stream, bad crc, layout mismatch, wrong page count) with the
  same typed in-band answer;
- on the tiny f32 model of ``tests/test_vlm.py`` (the port through
  ``VLMManager.from_model_dir``, so weights, tokenizer and template are the
  JAX manager's own), a row migrated from one port engine to another
  decodes the JAX manager's local greedy tokens with zero prefill on the
  decode engine, counters and pages balanced on both;
- across packages, both ways: a commit made by the port's prefill engine
  decodes on the JAX ``VlmService.handle_kv_put``, and a JAX commit on the
  port's, token-identical at greedy. The in-process stubs carry every
  message through its serialized bytes, so each side parses the other's
  wire;
- the local ladder: a dead, refusing or mid-stream-dying decode host, and
  exhausted migration lanes, all end in the colocated tokens with none
  repeated.
"""

from __future__ import annotations

import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
from google.protobuf import empty_pb2

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu.runtime import federation as jfed
from lumen_tpu.serving import router as jrouter
from lumen_tpu.serving.echo import EchoService as JEchoService
from lumen_tpu.serving.proto import ml_service_pb2 as jpb
from lumen_tpu.serving.services.vlm_service import VlmService as JVlmService
from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager, migration
from lumen_tpu_torch.models.vlm.continuous import _STREAM_END
from lumen_tpu_torch.runtime import federation as pfed
from lumen_tpu_torch.serving import router as prouter
from lumen_tpu_torch.serving.echo import EchoService as PEchoService
from lumen_tpu_torch.serving.proto import ml_service_pb2 as ppb
from lumen_tpu_torch.serving.services.vlm_service import VlmService
from lumen_tpu_torch.utils import disagg
from lumen_tpu_torch.utils.tensorwire import BUNDLE_MIME
from test_torch_spill import assert_balanced, count_prefill_rows, one_torch_thread  # noqa: F401 - autouse
from test_vlm import make_vlm_model_dir

PKGS = {
    "jax": SimpleNamespace(fed=jfed, router=jrouter, echo=JEchoService, pb=jpb),
    "port": SimpleNamespace(fed=pfed, router=prouter, echo=PEchoService, pb=ppb),
}

PROMPTS = ["the quick brown fox", "alpha beta gamma", "hello"]
MAX_NEW = 8


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def reset_counters(fed_mod) -> None:
    for k in fed_mod.MIGRATION:
        fed_mod.MIGRATION[k] = 0


class IdleStub:
    def Infer(self, request_iterator, timeout=None, metadata=None):  # noqa: N802, ARG002
        raise AssertionError("plan tests never dispatch")

    Health = Infer


def plan_manager(pkg, names, roles=None):
    m = pkg.fed.FederationManager([pkg.fed.PeerSpec(n) for n in names], stub_factory=lambda addr: IdleStub())
    for n, r in (roles or {}).items():
        m.peers[n].role = r
    return m


def kv_req(pb, meta=None, **kw):
    return pb.InferRequest(correlation_id="k1", task=pkg_task(), meta=meta or {}, **kw)


def pkg_task() -> str:
    assert jrouter.FED_KV_PUT_TASK == prouter.FED_KV_PUT_TASK == "fed_kv_put"
    return prouter.FED_KV_PUT_TASK


# -- the router's reserved task and the role-aware plan (both packages) ------


class TestRouterKvPut:
    def test_no_sink_is_typed_refusal(self, pkg):
        router = pkg.router.HubRouter({"echo": pkg.echo()})
        (resp,) = list(router.Infer(iter([kv_req(pkg.pb)]), None))
        assert resp.meta["fed_kv"] == "refused"
        assert resp.error.code == pkg.pb.ERROR_CODE_UNAVAILABLE
        assert "no KV migrations" in resp.error.message

    def test_drain_gate_applies(self, pkg):
        router = pkg.router.HubRouter({"echo": pkg.echo()})
        router.kv_migration = object()  # would crash if reached
        router._draining = True
        (resp,) = list(router.Infer(iter([kv_req(pkg.pb)]), None))
        assert resp.HasField("error") and resp.meta.get("fed_kv") != "tok"

    def test_sink_crash_answers_in_band(self, pkg):
        class Boom:
            def handle_kv_put(self, first, it, ctx):
                raise RuntimeError("sink exploded")
                yield  # pragma: no cover

        router = pkg.router.HubRouter({"echo": pkg.echo()})
        router.kv_migration = Boom()
        (resp,) = list(router.Infer(iter([kv_req(pkg.pb)]), None))
        assert resp.meta["fed_kv"] == "refused"
        assert resp.error.code == pkg.pb.ERROR_CODE_INTERNAL and "sink exploded" in resp.error.message

    def test_front_tier_refuses_without_forwarding(self, pkg):
        m = plan_manager(pkg, ["a:1"])
        try:
            (resp,) = list(pkg.router.FederationRouter(m).Infer(iter([kv_req(pkg.pb)]), None))
            assert resp.meta["fed_kv"] == "refused" and resp.error.code == pkg.pb.ERROR_CODE_UNAVAILABLE
        finally:
            m.close()


class TestDisaggPlan:
    NAMES = ["a:1", "b:1", "c:1"]

    def _plan(self, m, task="vlm_generate"):
        return m.disagg_plan(task, [m.peers[n] for n in self.NAMES])

    @pytest.mark.parametrize("roles, task, want_lead, want_owner", [
        ({}, "vlm_generate", None, None),
        ({"a:1": "decode", "b:1": "prefill", "c:1": "prefill"}, "clip_image_embed", None, None),
        ({"a:1": "decode", "b:1": "prefill", "c:1": "decode"}, "vlm_generate", "b:1", "a:1"),
        ({"a:1": "both", "b:1": "prefill", "c:1": "decode"}, "vlm_generate_stream", "a:1", None),
        ({"a:1": "prefill", "b:1": "prefill", "c:1": "prefill"}, "vlm_generate", None, None),
    ])
    def test_plan_matches_between_packages(self, roles, task, want_lead, want_owner):
        got = []
        for pkg in PKGS.values():
            m = plan_manager(pkg, self.NAMES, roles)
            try:
                plan, owner = self._plan(m, task)
                got.append(([p.name for p in plan], owner))
            finally:
                m.close()
        assert got[0] == got[1]
        names, owner = got[1]
        assert owner == want_owner
        assert names[0] == (want_lead or self.NAMES[0])


# -- the port's decode sink: the refusal ladder -------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_vlm_model_dir(tmp_path_factory.mktemp("torch_disagg"))


def port_mgr(model_dir) -> VLMManager:
    return VLMManager.from_model_dir(
        model_dir, device="cpu", dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32),
        gen_slots=4, gen_block=4, page_size=16,
    )


def jax_mgr(model_dir) -> JVLMManager:
    mgr = JVLMManager(model_dir, dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32),
                      scheduler="continuous", gen_slots=4, gen_block=4)
    mgr.initialize()
    return mgr


@pytest.fixture(scope="module")
def jax_local(model_dir):
    """The JAX manager's local greedy tokens for PROMPTS."""
    mgr = jax_mgr(model_dir)
    try:
        return {p: mgr.generate([JChatMessage(role="user", content=p)], max_new_tokens=MAX_NEW).tokens
                for p in PROMPTS}
    finally:
        mgr.close()


@pytest.fixture(scope="module")
def sink(model_dir):
    mgr = port_mgr(model_dir)
    yield VlmService(mgr, service_name="vlm"), mgr
    mgr.close()


def commit(n_page_leaves: int, leaves: list, crc=None, n_pages: int = 1, **over):
    blob, real_crc = migration.pack_payload(leaves)
    meta = dict(migration.commit_meta(
        crc=real_crc if crc is None else crc, n_page_leaves=n_page_leaves, n_pages=n_pages, n_shared=0,
        page_size=16, cur_tok=1, cur_len=17, n_gen=0, prompt_len=16, max_new=4, temperature=0.0, top_p=1.0,
        do_sample=False, repetition_penalty=1.0, manifest=[],
    ))
    meta.update(over)
    return kv_req(ppb, meta, payload=blob, payload_mime=BUNDLE_MIME, seq=0, total=1)


class TestKvPutService:
    def _run(self, svc, first, rest=()):
        return list(svc.handle_kv_put(first, iter(rest), None))

    def _layers(self, mgr) -> int:
        return len(mgr.engine.pool["caches"])

    def _good_leaves(self, mgr, n_pages: int = 1):
        k = mgr.engine.pool["caches"][0]["k"]
        page = np.zeros((n_pages, *k.shape[1:]), np.float32)
        seen = np.zeros((mgr.cfg.decoder.vocab_size,), np.bool_)
        return [page] * (2 * self._layers(mgr)) + [seen, np.zeros((2,), np.uint32), np.ones((1, 16), np.int32)]

    def test_unknown_op_refused(self, sink):
        svc, _ = sink
        reset_counters(pfed)
        (resp,) = self._run(svc, kv_req(ppb, {"op": "teleport"}))
        assert resp.meta["fed_kv"] == "refused" and resp.error.code == ppb.ERROR_CODE_INVALID_ARGUMENT
        assert pfed.MIGRATION["in_rejected"] == 1

    def test_offer_answers_cached_prefix_pages(self, sink):
        svc, _ = sink
        (resp,) = self._run(svc, kv_req(ppb, {"op": "offer", "manifest": migration.manifest_csv([b"\x01" * 32])}))
        assert resp.meta["fed_kv"] == "ok" and resp.meta["hit"] == "0"  # no prefix cache here
        (resp,) = self._run(svc, kv_req(ppb, {"op": "offer", "manifest": "zz-not-hex"}))
        assert resp.meta["fed_kv"] == "ok" and resp.meta["hit"] == "0"

    def test_truncated_commit_stream_refused(self, sink):
        svc, mgr = sink
        first = commit(2 * self._layers(mgr), self._good_leaves(mgr))
        first.total = 3
        (resp,) = self._run(svc, first)
        assert resp.meta["fed_kv"] == "refused" and "chunk" in resp.error.message

    def test_bad_crc_refused(self, sink):
        svc, mgr = sink
        blob_crc = migration.pack_payload(self._good_leaves(mgr))[1]
        (resp,) = self._run(svc, commit(2 * self._layers(mgr), self._good_leaves(mgr), crc=blob_crc ^ 0xDEAD))
        assert resp.meta["fed_kv"] == "refused" and "crc" in resp.error.message

    def test_layout_mismatch_refused(self, sink):
        """A peer of another depth (one layer's K only) is refused by name,
        never scattered into the pool."""
        svc, mgr = sink
        (resp,) = self._run(svc, commit(1, self._good_leaves(mgr)[:1] + self._good_leaves(mgr)[-3:]))
        assert resp.meta["fed_kv"] == "refused" and resp.error.code == ppb.ERROR_CODE_INVALID_ARGUMENT
        assert "page layout mismatch" in resp.error.message

    def test_page_count_and_size_mismatch_refused(self, sink):
        svc, mgr = sink
        leaves = self._good_leaves(mgr, n_pages=2)
        (resp,) = self._run(svc, commit(2 * self._layers(mgr), leaves, n_pages=1))
        assert "commit declared 1" in resp.error.message
        (resp,) = self._run(svc, commit(2 * self._layers(mgr), self._good_leaves(mgr), page_size="32"))
        assert "page size mismatch" in resp.error.message
        (resp,) = self._run(svc, commit(2 * self._layers(mgr), self._good_leaves(mgr)[:-1]))
        assert "expected" in resp.error.message and resp.meta["fed_kv"] == "refused"


# -- migration end to end, within the port and across packages --------------


class WireStub:
    """The federation dispatcher's stub, landing in a router of either
    package in process: every request and response crosses as its
    serialized bytes (the wire without the socket)."""

    def __init__(self, servicer, req_cls, resp_cls):
        self.servicer, self.req_cls, self.resp_cls = servicer, req_cls, resp_cls
        self.commits = 0

    def Infer(self, request_iterator, timeout=None, metadata=None):  # noqa: N802, ARG002
        msgs = [self.req_cls.FromString(m.SerializeToString()) for m in request_iterator]
        if msgs and msgs[0].meta.get("op") != "offer":
            self.commits += 1
        for resp in self.servicer.Infer(iter(msgs), None):
            yield self.resp_cls.FromString(resp.SerializeToString())

    def Health(self, request, timeout=None):  # noqa: N802, ARG002
        return empty_pb2.Empty()


def sink_router(pkg, service):
    router = pkg.router.HubRouter({"vlm": service})
    router.kv_migration = service
    return router


def port_migrate(mgr, prompt: str, max_new: int = MAX_NEW, stream_q=None) -> list[int]:
    req, _ = mgr._make_gen_request([ChatMessage("user", prompt)], None, max_new, 0.0, 1.0, False, 1.0, True)
    req.stream_q = stream_q
    req.migrate_to = "b:1"
    toks, n, _ = mgr.engine.submit(req).result(timeout=120)
    return [int(t) for t in toks[:n]]


def jax_migrate(mgr, prompt: str, max_new: int = MAX_NEW) -> list[int]:
    e, pos, ln, ids, _ = mgr._prepare_inputs([JChatMessage(role="user", content=prompt)], None, True)
    req = mgr._make_gen_request(e, pos, ln, ids, max_new, 0.0, 1.0, False, 1.0)
    req.migrate_to = "b:1"
    toks, _n, _eos = mgr._pick_engine().submit(req).result(timeout=120)
    return [int(t) for t in np.asarray(toks)]


def jax_balanced(eng) -> None:
    deadline = time.time() + 20
    while eng._slots and time.time() < deadline:
        time.sleep(0.01)
    stats = eng.kv.stats()
    assert stats.pages_live == 0 and stats.allocated_total == stats.freed_total


def fed_of(pkg, stub_b):
    return pkg.fed.FederationManager(
        [pkg.fed.PeerSpec("a:1"), pkg.fed.PeerSpec("b:1")], self_name="a:1",
        stub_factory=lambda addr: stub_b if addr == "b:1" else IdleStub(),
    )


def test_port_to_port_migration_matches_jax_with_zero_decode_prefill(model_dir, jax_local):
    reset_counters(pfed)
    mgr_a, mgr_b = port_mgr(model_dir), port_mgr(model_dir)
    stub = WireStub(sink_router(PKGS["port"], VlmService(mgr_b, "vlm")), ppb.InferRequest, ppb.InferResponse)
    fed = fed_of(PKGS["port"], stub)
    mgr_a.engine.migrator = fed.kv_migrate
    full, chunks, restore = count_prefill_rows(mgr_b.engine)
    try:
        got = [port_migrate(mgr_a, p) for p in PROMPTS]
        assert got == [jax_local[p] for p in PROMPTS]
        assert full == [] and chunks == []  # zero re-prefill on the decode host
        eng_a, eng_b = mgr_a.engine, mgr_b.engine
        assert stub.commits == len(PROMPTS)
        assert (eng_a.migrated_out, eng_a.migrate_out_failed) == (len(PROMPTS), 0)
        assert (eng_b.migrated_in, eng_b.migrate_in_rejected) == (len(PROMPTS), 0)
        assert eng_b.gauges()["migrated_in"] == len(PROMPTS)
        assert pfed.MIGRATION["puts"] == pfed.MIGRATION["in_commits"] == len(PROMPTS)
        assert pfed.MIGRATION["put_bytes"] > 0 and pfed.MIGRATION["put_failures"] == 0
        assert_balanced(eng_a)
        assert_balanced(eng_b)
    finally:
        restore()
        fed.close()
        mgr_a.close()
        mgr_b.close()


def test_port_commit_decodes_on_the_jax_sink(model_dir, jax_local):
    reset_counters(pfed)
    reset_counters(jfed)
    mgr_a, jmgr_b = port_mgr(model_dir), jax_mgr(model_dir)
    stub = WireStub(sink_router(PKGS["jax"], JVlmService(jmgr_b, "vlm")), jpb.InferRequest, ppb.InferResponse)
    fed = fed_of(PKGS["port"], stub)
    mgr_a.engine.migrator = fed.kv_migrate
    eng_b = jmgr_b._pick_engine()
    prefills: list[int] = []
    real = eng_b.gen._prefill

    def counting(params, embeds, *a, **kw):
        prefills.append(int(embeds.shape[0]))
        return real(params, embeds, *a, **kw)

    eng_b.gen._prefill = counting
    try:
        got = [port_migrate(mgr_a, p) for p in PROMPTS]
        assert got == [jax_local[p] for p in PROMPTS]
        assert prefills == []
        assert eng_b.migrated_in == len(PROMPTS) and eng_b.migrate_in_rejected == 0
        assert jfed.MIGRATION["in_commits"] == pfed.MIGRATION["puts"] == len(PROMPTS)
        assert mgr_a.engine.migrate_out_failed == 0
        assert_balanced(mgr_a.engine)
        jax_balanced(eng_b)
    finally:
        eng_b.gen._prefill = real
        fed.close()
        mgr_a.close()
        jmgr_b.close()


def test_sampled_port_commits_carry_distinct_keys_to_the_jax_sink(model_dir):
    """Two sampled rows of one prompt, migrated from the port to the JAX
    sink: each commit's rng leaf is a fresh ``uint32[2]`` from the prefill
    engine's generator, so the JAX rows sample from different keys."""
    mgr_a, jmgr_b = port_mgr(model_dir), jax_mgr(model_dir)
    svc = JVlmService(jmgr_b, "vlm")
    keys = []
    real = svc._kv_build_row

    def build(eng, m, leaves, nbytes):
        req, rec = real(eng, m, leaves, nbytes)
        keys.append((np.asarray(req.rng), np.asarray(rec.rng), m["do_sample"]))
        return req, rec

    svc._kv_build_row = build
    stub = WireStub(sink_router(PKGS["jax"], svc), jpb.InferRequest, ppb.InferResponse)
    fed = fed_of(PKGS["port"], stub)
    mgr_a.engine.migrator = fed.kv_migrate
    try:
        for _ in range(2):
            req, _ = mgr_a._make_gen_request([ChatMessage("user", PROMPTS[0])], None, MAX_NEW, 1.0, 1.0, True, 1.0,
                                             True)
            req.migrate_to = "b:1"
            toks, n, _ = mgr_a.engine.submit(req).result(timeout=120)
            assert n == len(toks[:n]) > 0
        assert stub.commits == 2 and mgr_a.engine.migrate_out_failed == 0
        (k1, r1, s1), (k2, r2, s2) = keys
        assert s1 and s2
        assert k1.dtype == np.uint32 and k1.shape == (2,) and (k1 == r1).all() and (k2 == r2).all()
        assert not (k1 == k2).all()
        jax_balanced(jmgr_b._pick_engine())
    finally:
        fed.close()
        mgr_a.close()
        jmgr_b.close()


def test_jax_commit_decodes_on_the_port_sink(model_dir, jax_local):
    reset_counters(pfed)
    reset_counters(jfed)
    jmgr_a, mgr_b = jax_mgr(model_dir), port_mgr(model_dir)
    stub = WireStub(sink_router(PKGS["port"], VlmService(mgr_b, "vlm")), ppb.InferRequest, jpb.InferResponse)
    fed = fed_of(PKGS["jax"], stub)
    eng_a = jmgr_a._pick_engine()
    eng_a.migrator = fed.kv_migrate
    full, chunks, restore = count_prefill_rows(mgr_b.engine)
    try:
        got = [jax_migrate(jmgr_a, p) for p in PROMPTS]
        assert got == [jax_local[p] for p in PROMPTS]
        assert full == [] and chunks == []
        assert mgr_b.engine.migrated_in == len(PROMPTS) and mgr_b.engine.migrate_in_rejected == 0
        assert pfed.MIGRATION["in_commits"] == jfed.MIGRATION["puts"] == len(PROMPTS)
        assert eng_a.migrate_out_failed == 0
        jax_balanced(eng_a)
        assert_balanced(mgr_b.engine)
    finally:
        restore()
        fed.close()
        jmgr_a.close()
        mgr_b.close()


def test_port_commit_keeps_the_jax_record_layout(model_dir):
    """The leaves a port commit ships: per-layer K/V page stacks
    ``[n_pages, kvh, page, dh]``, ``seen``, the JAX PRNG key's shape and
    dtype, and the prompt ids as ``int32 [1, S]``."""
    import jax

    reset_counters(pfed)
    mgr_a, mgr_b = port_mgr(model_dir), port_mgr(model_dir)
    inner = WireStub(sink_router(PKGS["port"], VlmService(mgr_b, "vlm")), ppb.InferRequest, ppb.InferResponse)
    shipped = []

    class Tap(WireStub):
        def Infer(self, request_iterator, timeout=None, metadata=None):  # noqa: N802
            msgs = list(request_iterator)
            if msgs[0].meta.get("op") == "commit":
                shipped.append(migration.unpack_payload(b"".join(m.payload for m in msgs), None))
            yield from inner.Infer(iter(msgs), timeout, metadata)

    fed = fed_of(PKGS["port"], Tap(None, None, None))
    mgr_a.engine.migrator = fed.kv_migrate
    try:
        port_migrate(mgr_a, PROMPTS[0])
        (leaves,) = shipped
        n_layers = len(mgr_a.engine.pool["caches"])
        k = mgr_a.engine.pool["caches"][0]["k"]
        assert len(leaves) == 2 * n_layers + 3
        assert all(leaf.shape[1:] == tuple(k.shape[1:]) for leaf in leaves[: 2 * n_layers])
        key = np.asarray(jax.random.PRNGKey(0))
        assert (leaves[-2].shape, leaves[-2].dtype) == (key.shape, key.dtype)
        assert leaves[-1].dtype == np.int32 and leaves[-1].shape[0] == 1
        assert leaves[-3].dtype == np.bool_ and leaves[-3].shape == (mgr_a.cfg.decoder.vocab_size,)
    finally:
        fed.close()
        mgr_a.close()
        mgr_b.close()


class DeadStub:
    def Infer(self, it, timeout=None, metadata=None):  # noqa: N802, ARG002
        import grpc

        class E(grpc.RpcError):
            def code(self):
                return grpc.StatusCode.UNAVAILABLE

        raise E()

    Health = Infer


def test_dead_refusing_or_busy_decode_host_falls_back_to_local_decode(model_dir, jax_local, monkeypatch):
    """The ladder's safe rungs: an unreachable decode host, a typed in-band
    refusal (no sink attached) and exhausted migration lanes all cost
    latency, never tokens."""
    monkeypatch.setenv("LUMEN_FED_KV_LANES", "1")
    mgr_a = port_mgr(model_dir)
    eng_a = mgr_a.engine
    sinkless = WireStub(PKGS["port"].router.HubRouter({"echo": PEchoService()}), ppb.InferRequest,
                        ppb.InferResponse)
    try:
        for i, stub in enumerate((DeadStub(), sinkless, "lanes")):
            reset_counters(pfed)
            fed = fed_of(PKGS["port"], IdleStub() if stub == "lanes" else stub)
            if stub == "lanes":
                assert fed._kv_lanes.acquire(blocking=False)  # the only lane is taken
            eng_a.migrator = fed.kv_migrate
            try:
                assert port_migrate(mgr_a, PROMPTS[i]) == jax_local[PROMPTS[i]]
            finally:
                fed.close()
            if stub == "lanes":
                assert pfed.MIGRATION["lane_busy"] == 1 and pfed.MIGRATION["puts"] == 0
            else:
                assert pfed.MIGRATION["put_failures"] == 1
            assert pfed.MIGRATION["in_rejected"] == 0  # refused at the router, or never sent
        assert eng_a.migrated_out == 3 and eng_a.migrate_out_failed == 3
        assert eng_a.gauges()["migrate_out_failed"] == 3
        assert_balanced(eng_a)
    finally:
        mgr_a.close()


def test_mid_stream_peer_death_never_duplicates_tokens(model_dir):
    """The decode host dies after the relay has streamed 8 tokens: the
    local replay's delivered watermark does not move back, so the
    client's stream is the colocated tokens, each once."""
    import grpc

    reset_counters(pfed)
    mgr_a, mgr_b = port_mgr(model_dir), port_mgr(model_dir)
    inner = WireStub(sink_router(PKGS["port"], VlmService(mgr_b, "vlm")), ppb.InferRequest, ppb.InferResponse)

    class CutMidStream:
        def Infer(self, it, timeout=None, metadata=None):  # noqa: N802, ARG002
            msgs = list(it)
            relayed = 0
            for resp in inner.Infer(iter(msgs), timeout):
                yield resp
                if resp.meta.get("fed_kv") == "tok":
                    relayed += len([p for p in resp.meta.get("toks", "").split(",") if p])
                    if relayed >= 8:
                        class E(grpc.RpcError):
                            def code(self):
                                return grpc.StatusCode.UNAVAILABLE

                        raise E()

        Health = inner.Health

    fed = fed_of(PKGS["port"], CutMidStream())
    mgr_a.engine.migrator = fed.kv_migrate
    try:
        prompt = PROMPTS[0]
        want = mgr_a.generate([ChatMessage("user", prompt)], max_new_tokens=16).tokens
        q = queue.SimpleQueue()
        got = port_migrate(mgr_a, prompt, max_new=16, stream_q=q)
        streamed = []
        while (item := q.get(timeout=60)) is not _STREAM_END:
            streamed.append(int(item))
        assert got == want and streamed == want
        assert mgr_a.engine.migrate_out_failed == 1 and pfed.MIGRATION["put_failures"] == 1
        assert_balanced(mgr_a.engine)
    finally:
        fed.close()
        mgr_a.close()
        mgr_b.close()


def test_manager_tags_rows_with_the_pinned_decode_owner(model_dir):
    """``_make_gen_request`` reads ``utils.disagg.current()``: a request
    dispatched with ``lumen-decode-owner`` carries ``migrate_to``, one
    without it does not."""
    mgr = port_mgr(model_dir)
    try:
        msgs = [ChatMessage("user", "hello")]
        req, _ = mgr._make_gen_request(msgs, None, 4, 0.0, 1.0, False, 1.0, True)
        assert req.migrate_to is None
        token = disagg.activate("b:1")
        try:
            req, _ = mgr._make_gen_request(msgs, None, 4, 0.0, 1.0, False, 1.0, True)
        finally:
            disagg.deactivate(token)
        assert req.migrate_to == "b:1"
    finally:
        mgr.close()


def test_interleaved_local_load_balances_both_engines(model_dir):
    """Migrated-in rows land while local requests run on the decode
    engine; at drain every page is freed on both engines."""
    mgr_a, mgr_b = port_mgr(model_dir), port_mgr(model_dir)
    stub = WireStub(sink_router(PKGS["port"], VlmService(mgr_b, "vlm")), ppb.InferRequest, ppb.InferResponse)
    fed = fed_of(PKGS["port"], stub)
    mgr_a.engine.migrator = fed.kv_migrate
    try:
        local: dict[int, object] = {}

        def run_local(i, p):
            local[i] = mgr_b.generate([ChatMessage("user", p)], max_new_tokens=8)

        threads = [threading.Thread(target=run_local, args=(i, p))
                   for i, p in enumerate(("gamma delta epsilon", "count to ten"))]
        for t in threads:
            t.start()
        got = [port_migrate(mgr_a, p) for p in PROMPTS]
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert all(got) and len(local) == 2 and all(r.tokens for r in local.values())
        assert_balanced(mgr_a.engine)
        assert_balanced(mgr_b.engine)
    finally:
        fed.close()
        mgr_a.close()
        mgr_b.close()
