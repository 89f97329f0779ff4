"""The port's ANN index and search service, held against ``exact_oracle``
and against the JAX server on the CPU.

- ``merge_topk``: the JAX merge's heap evicts the smallest id among equal
  scores, against its own "score descending, then id ascending" contract;
  the port's repaired merge equals the oracle on the same parts, and a
  hypothesis property holds it against the oracle on tie-heavy corpora.
- ``AnnShard``/``AnnIndex`` (the torch rewrite) equal ``exact_oracle``,
  ties included: growth, tiled vs single pass, k past the count, in-batch
  duplicates, the max-vectors refusal, updates in place. Scores within
  1e-5 (float32 products summed in another order than numpy's).
- Upsert during a query, held deterministically: a barrier parks the
  query between its launch and its resolve while a writer updates a row
  in place and appends rows; the answer is the index before the upsert,
  the next query's the index after it.
- ``SearchService`` on both servers over gRPC, booted from a YAML of the
  shape of ``bench.py``'s search deployment: equal ids and scores within
  1e-6 on tie-free data, equal error codes, the port's service healthy.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
from google.protobuf import empty_pb2
from hypothesis import given, settings, strategies as st

from lumen_tpu.runtime.ann import merge_topk as jax_merge_topk
from lumen_tpu.serving.proto import ml_service_pb2 as pb
from lumen_tpu_torch.runtime import ann
from lumen_tpu_torch.runtime.ann import AnnIndex, AnnShard, exact_oracle, merge_topk, normalize, shard_of
from lumen_tpu_torch.utils.tensorwire import BUNDLE_MIME, TENSOR_MIME, pack_bundle, tensor_payload
from test_torch_face_serving import boot_both

DIM = 32
#: scores: float32 products summed in another order than numpy's
SCORE_TOL = 1e-5
#: the two servers: the same float32 rows and products, different libraries
SERVER_SCORE_TOL = 1e-6


def _vecs(rng, n: int, dim: int = DIM) -> np.ndarray:
    return rng.standard_normal((n, dim)).astype(np.float32)


def _ids(n: int) -> list[str]:
    return [f"v{i:04d}" for i in range(n)]


def _tied(rng, n: int, pool: int = 3, dim: int = DIM) -> np.ndarray:
    """Rows drawn from a tiny pool: exact score ties everywhere."""
    rows = rng.standard_normal((pool, dim)).astype(np.float32)
    return rows[rng.integers(0, pool, size=n)]


def _shard(**kw) -> AnnShard:
    return AnnShard(DIM, name="t", device="cpu", **kw)


# -- merge_topk ----------------------------------------------------------------


def test_merge_tie_break_differs_from_jax_and_equals_the_oracle():
    """Three equal vectors, k = 2, over two shards: the oracle ranks
    ``a, b``; the JAX merge keeps ``b, c``; the port's merge ``a, b``."""
    v = np.ones((3, DIM), np.float32)
    q = np.ones(DIM, np.float32)
    parts = [exact_oracle(["b", "c"], v[:2], q, 2), exact_oracle(["a"], v[:1], q, 2)]
    want = exact_oracle(["a", "b", "c"], v, q, 2)
    assert want[0] == ["a", "b"]
    assert jax_merge_topk(parts, 2)[0] == ["b", "c"]
    assert merge_topk(parts, 2) == want


def test_merge_skips_empty_parts_and_never_pads():
    rng = np.random.default_rng(4)
    vecs, ids = _vecs(rng, 3), _ids(3)
    q = rng.standard_normal(DIM).astype(np.float32)
    got = merge_topk([([], []), exact_oracle(ids, vecs, q, 50), ([], [])], 50)
    assert got[0] == exact_oracle(ids, vecs, q, 50)[0] and len(got[0]) == 3
    assert merge_topk([([], []), ([], [])], 5) == ([], [])


@settings(max_examples=60, deadline=None)
@given(
    n=st.integers(min_value=0, max_value=64),
    k=st.integers(min_value=1, max_value=24),
    shards=st.integers(min_value=1, max_value=6),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_sharded_merge_equals_the_oracle_on_ties(n, k, shards, seed):
    """Per-shard top-k lists merged == one global oracle, on rows drawn
    from a pool of 3 (ties at every rank), empty shards included. Each
    shard's list ranks the global oracle's own scores of its rows (by
    ``exact_oracle``'s order), so equal rows tie exactly across shards too
    (a product over a subset can round a row's score differently): the
    merged ids and scores must equal the oracle's exactly."""
    rng = np.random.default_rng(seed)
    vecs = _tied(rng, n, dim=6) if n else np.zeros((0, 6), np.float32)
    ids = [f"v{i:03d}" for i in range(n)]
    q = rng.standard_normal(6).astype(np.float32)
    all_ids, all_scores = exact_oracle(ids, vecs, q, n)
    parts = []
    for s in range(shards):
        mine = [(i, sc) for i, sc in zip(all_ids, all_scores) if shard_of(i, shards) == s][:k]
        parts.append(([i for i, _ in mine], [sc for _, sc in mine]))
    assert merge_topk(parts, k) == exact_oracle(ids, vecs, q, k)


def test_shard_of_matches_the_jax_placement():
    from lumen_tpu.runtime.ann import shard_of as jax_shard_of

    for i in range(200):
        assert shard_of(f"photo-{i}", 3) == jax_shard_of(f"photo-{i}", 3)


# -- AnnShard / AnnIndex -------------------------------------------------------


def test_recall_is_exact_across_growth():
    rng = np.random.default_rng(7)
    shard = _shard()
    vecs, ids = _vecs(rng, 1500), _ids(1500)
    for lo in range(0, 1500, 500):  # past the 1024 floor: one doubling
        shard.upsert(ids[lo : lo + 500], vecs[lo : lo + 500])
    assert shard.capacity == 2048 and shard.count == 1500
    q = rng.standard_normal(DIM).astype(np.float32)
    got_ids, got_scores = shard.query(q, 10)
    want_ids, want_scores = exact_oracle(ids, vecs, q, 10)
    assert got_ids == want_ids
    np.testing.assert_allclose(got_scores, want_scores, atol=SCORE_TOL)


def test_update_in_place_changes_ranking_not_count():
    rng = np.random.default_rng(8)
    shard = _shard()
    vecs, ids = _vecs(rng, 20), _ids(20)
    shard.upsert(ids, vecs)
    q = rng.standard_normal(DIM).astype(np.float32)
    assert shard.upsert(["v0005"], q[None, :]) == (0, 1)
    assert shard.count == 20
    got_ids, got_scores = shard.query(q, 1)
    assert got_ids == ["v0005"] and got_scores[0] == pytest.approx(1.0, abs=SCORE_TOL)


@pytest.mark.parametrize("tile", [128, 8192])
@pytest.mark.parametrize("tied", [False, True])
def test_tiled_and_single_pass_equal_the_oracle(monkeypatch, tile, tied):
    monkeypatch.setenv("LUMEN_ANN_TILE", str(tile))
    rng = np.random.default_rng(9)
    vecs = _tied(rng, 700) if tied else _vecs(rng, 700)
    ids = _ids(700)[::-1]  # row order against id order: ties must sort by id
    shard = _shard()
    shard.upsert(ids, vecs)
    for k in (1, 15, 128):
        q = rng.standard_normal(DIM).astype(np.float32)
        got_ids, got_scores = shard.query(q, k)
        want_ids, want_scores = exact_oracle(ids, vecs, q, k)
        assert got_ids == want_ids
        np.testing.assert_allclose(got_scores, want_scores, atol=SCORE_TOL)


def test_a_tie_past_the_fetched_rows_is_rerun_exactly(monkeypatch):
    """200 equal rows, k = 5 from a pass at the k cap of 16: the pass
    fetches 16 of the tied rows in no defined order; the answer is the 5
    smallest ids, as the oracle's."""
    monkeypatch.setenv("LUMEN_ANN_K_CAP", "16")
    v = np.tile(np.linspace(-1, 1, DIM, dtype=np.float32), (200, 1))
    ids = [f"id{i:03d}" for i in range(200)][::-1]
    shard = _shard()
    shard.upsert(ids, v)
    scores, rows, partial = (np.asarray(t) for t in shard.query_raw(v[:1], 16))
    assert partial.tolist() == [True]
    got = shard.resolve_rows(scores, rows, partial, v[:1], 5)
    assert got[0][0] == exact_oracle(ids, v, v[0], 5)[0] == [f"id{i:03d}" for i in range(5)]


def test_k_past_count_and_empty_shard():
    rng = np.random.default_rng(10)
    shard = _shard()
    assert shard.query(rng.standard_normal(DIM).astype(np.float32), 5) == ([], [])
    shard.upsert(_ids(3), _vecs(rng, 3))
    ids, scores = shard.query(rng.standard_normal(DIM).astype(np.float32), 50)
    assert len(ids) == 3 and len(scores) == 3


def test_in_batch_duplicate_last_write_wins():
    rng = np.random.default_rng(11)
    shard = _shard()
    a, b = _vecs(rng, 1)[0], _vecs(rng, 1)[0]
    assert shard.upsert(["x", "x"], np.stack([a, b])) == (1, 0)
    assert shard.count == 1
    got_ids, got_scores = shard.query(b, 1)
    assert got_ids == ["x"] and got_scores[0] == pytest.approx(1.0, abs=SCORE_TOL)


def test_max_vectors_refused_with_clear_error(monkeypatch):
    monkeypatch.setenv("LUMEN_ANN_MAX_VECTORS", "4")
    rng = np.random.default_rng(12)
    shard = _shard()
    shard.upsert(_ids(4), _vecs(rng, 4))
    with pytest.raises(ValueError, match="LUMEN_ANN_MAX_VECTORS"):
        shard.upsert(["overflow"], _vecs(rng, 1))
    assert shard.count == 4


def test_index_partitions_and_merges_like_the_oracle():
    rng = np.random.default_rng(13)
    index = AnnIndex(DIM, device="cpu")
    vecs, ids = _tied(rng, 120), _ids(120)
    index.upsert("tenant-a", ids, vecs)
    assert sorted(index.shards_for("tenant-a")) == ["0", "1", "2"]
    for k in (1, 10, 60):
        q = rng.standard_normal(DIM).astype(np.float32)
        got_ids, got_scores, shards_read = index.query("tenant-a", q, k)
        want_ids, want_scores = exact_oracle(ids, vecs, q, k)
        assert got_ids == want_ids and shards_read == 3
        np.testing.assert_allclose(got_scores, want_scores, atol=SCORE_TOL)
    assert index.query("tenant-b", q, 10)[0] == []  # tenants are isolated


def test_entry_points_default_to_the_card():
    """No device argument means the card: without one they raise."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        AnnShard(DIM)
    with pytest.raises(RuntimeError, match="CUDA"):
        AnnIndex(DIM)


def test_upsert_during_query_sees_before_then_after():
    """A query parked between its launch and its resolve while a writer
    updates a committed row in place and appends rows: its answer is the
    index before the upsert (old score of the updated row, none of the new
    ids, the old count); the next query's is the index after it."""
    rng = np.random.default_rng(14)
    shard = _shard()
    vecs, ids = _vecs(rng, 40), _ids(40)
    shard.upsert(ids, vecs)
    q = rng.standard_normal(DIM).astype(np.float32)
    new_ids = [f"new{i}" for i in range(8)]
    new_vecs = np.concatenate([np.tile(q, (8, 1)) + 0.01 * _vecs(rng, 8), q[None] * 2.0])
    target = exact_oracle(ids, vecs, q, 1)[0][0]  # the top row, updated to -q below
    launched, written = threading.Event(), threading.Event()
    out = {}

    def reader():
        raw = shard.query_raw(q[None], 128)
        launched.set()
        assert written.wait(10)
        out["before"] = shard.resolve_rows(*(np.asarray(t) for t in raw), q[None], 128)

    t = threading.Thread(target=reader)
    t.start()
    assert launched.wait(10)
    shard.upsert(new_ids + [target], np.concatenate([new_vecs[:8], -q[None]]))
    written.set()
    t.join(10)
    assert not t.is_alive()
    before_ids, before_scores = out["before"][0][0], out["before"][1][0]
    assert (before_ids, len(before_ids)) == (exact_oracle(ids, vecs, q, 128)[0], 40)
    np.testing.assert_allclose(before_scores, exact_oracle(ids, vecs, q, 128)[1], atol=SCORE_TOL)
    after_vecs = np.concatenate([vecs, new_vecs[:8]])
    after_vecs[ids.index(target)] = -q
    after = shard.query(q, 128)
    assert after[0] == exact_oracle(ids + new_ids, after_vecs, q, 128)[0] and len(after[0]) == 48
    assert after[0][-1] == target and after[1][-1] == pytest.approx(-1.0, abs=SCORE_TOL)


def test_concurrent_queries_see_only_committed_states():
    """Queries racing appends and in-place updates under a short switch
    interval: every answer's count is one the writer committed, every id
    resolves to a committed vector, and every score is the cosine of one
    committed version of its row."""
    import sys

    rng = np.random.default_rng(15)
    shard = _shard()
    base = _vecs(rng, 16)
    shard.upsert(_ids(16), base)
    versions = {vid: [normalize(v)[0]] for vid, v in zip(_ids(16), base)}
    counts = {16}
    lock = threading.Lock()
    failures: list = []
    q = rng.standard_normal(DIM).astype(np.float32)
    qn = normalize(q)[0]

    def writer():
        wrng = np.random.default_rng(16)
        for step in range(12):
            new = [f"w{step:02d}-{j}" for j in range(8)]
            upd = [f"v{(step * 3 + j) % 16:04d}" for j in range(3)]
            vs = _vecs(wrng, 11)
            with lock:  # recorded BEFORE the commit
                for vid, v in zip(new + upd, vs):
                    versions.setdefault(vid, []).append(normalize(v)[0])
                counts.add(16 + 8 * (step + 1))
            shard.upsert(new + upd, vs)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        w = threading.Thread(target=writer)
        w.start()
        while w.is_alive() or not failures and len(counts) < 13:
            got_ids, got_scores = shard.query(q, 128)
            with lock:
                if len(got_ids) not in counts:
                    failures.append(("count", len(got_ids)))
                for vid, s in zip(got_ids, got_scores):
                    if not any(abs(float(v @ qn) - s) <= SCORE_TOL for v in versions.get(vid, [])):
                        failures.append(("score", vid, s))
            if not w.is_alive():
                break
        w.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not w.is_alive() and not failures, failures[:5]
    assert shard.count == 16 + 8 * 12


# -- SearchService over gRPC, both servers ----------------------------------------


def search_deployment(cache_dir: str) -> dict:
    """``bench.py``'s search deployment (``_searchbench_config``), naming
    the real service in its JAX form."""
    return {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": cache_dir},
        "deployment": {"mode": "hub", "services": ["search"]},
        "server": {"port": 50998, "host": "127.0.0.1"},
        "services": {
            "search": {
                "enabled": True,
                "package": "lumen_tpu",
                "import_info": {"registry_class": "lumen_tpu.serving.services.search_service.SearchService"},
                "backend_settings": {"batch_size": 4, "max_batch_latency_ms": 2.0},
                "models": {"search": {"model": "test/model-search"}},
            },
        },
    }


@pytest.fixture(scope="module")
def search_servers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_ANN_DIM", str(DIM))
        yield from boot_both(search_deployment(str(tmp_path_factory.mktemp("torch_search"))))


def call(stub, task: str, payload: bytes, mime: str, **meta) -> tuple[int, dict | None]:
    req = pb.InferRequest(correlation_id="s", task=task, payload=bytes(payload), payload_mime=mime,
                          meta={k: str(v) for k, v in meta.items()})
    last = list(stub.Infer(iter([req]), timeout=120))[-1]
    if last.HasField("error") and last.error.code:
        return last.error.code, None
    return 0, json.loads(last.result)


def bundle(ids, vecs) -> bytes:
    return pack_bundle([np.asarray(vecs, np.float32), np.frombuffer(json.dumps(ids).encode(), np.uint8)])


def test_search_service_is_served_not_degraded(search_servers):
    jstub, tstub, thandle = search_servers
    caps = []
    for stub in (jstub, tstub):
        cap = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
        assert {t.name for t in cap.tasks} == {"search_query", "search_upsert"}
        _, call_ = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
        assert json.loads(dict(call_.trailing_metadata())["lumen-service-status"]) == {"search": "healthy"}
        caps.append(cap)
    assert caps[1].runtime == "torch-cpu"
    assert sorted(caps[1].extra) == sorted(caps[0].extra)
    assert caps[1].extra["tensor_input:search_query"] == caps[0].extra["tensor_input:search_query"]


def test_both_servers_answer_alike(search_servers):
    jstub, tstub, _ = search_servers
    rng = np.random.default_rng(20)
    vecs, ids = _vecs(rng, 300), _ids(300)
    for stub in (jstub, tstub):
        for lo in range(0, 300, 100):
            code, body = call(stub, "search_upsert", bundle(ids[lo : lo + 100], vecs[lo : lo + 100]), BUNDLE_MIME,
                              tenant="t1")
            assert code == 0 and body["added"] == 100
        assert body["total"] == 300
    for i in range(12):
        q = rng.standard_normal(DIM).astype(np.float32)
        payload, meta = tensor_payload(q)
        answers = [call(stub, "search_query", bytes(payload), TENSOR_MIME, tenant="t1", k=3 + i, **meta)
                   for stub in (jstub, tstub)]
        (jc, jb), (tc, tb) = answers
        assert jc == tc == 0
        assert tb["ids"] == jb["ids"] == exact_oracle(ids, vecs, q, 3 + i)[0]
        np.testing.assert_allclose(tb["scores"], jb["scores"], atol=SERVER_SCORE_TOL, rtol=0)
        assert (tb["k"], tb["shards"], tb["tenant"]) == (jb["k"], jb["shards"], jb["tenant"]) == (3 + i, 3, "t1")


def test_json_paths_shard_pinning_and_errors_alike(search_servers):
    jstub, tstub, _ = search_servers
    v = np.random.default_rng(21).standard_normal(DIM).astype(np.float32)
    for stub in (jstub, tstub):
        code, body = call(stub, "search_upsert", json.dumps({"ids": ["only"], "vectors": [v.tolist()]}).encode(),
                          "application/json", tenant="t2", shard="1")
        assert code == 0 and body["added"] == 1
        for shard, want in (("0", []), ("1", ["only"])):
            code, body = call(stub, "search_query", json.dumps({"vector": v.tolist()}).encode(), "application/json",
                              tenant="t2", shard=shard, k=3)
            assert code == 0 and body["ids"] == want
    bad = [
        ("search_query", json.dumps({"vector": [0.0] * DIM}).encode(), "application/json", {"k": "zero"}),
        ("search_query", json.dumps({"vector": [0.0] * DIM}).encode(), "application/json", {"k": "0"}),
        ("search_query", json.dumps({"vector": [0.0] * (DIM + 1)}).encode(), "application/json", {}),
        ("search_upsert", json.dumps({"ids": ["a", "b"], "vectors": [[0.0] * DIM]}).encode(), "application/json", {}),
        ("search_upsert", b"not a bundle", BUNDLE_MIME, {}),
        ("search_upsert", bundle([], np.zeros((0, DIM))), BUNDLE_MIME, {}),
    ]
    for task, payload, mime, meta in bad:
        codes = [call(stub, task, payload, mime, **meta)[0] for stub in (jstub, tstub)]
        assert codes[0] == codes[1] == pb.ERROR_CODE_INVALID_ARGUMENT, (task, meta, codes)


def test_a_query_launched_before_an_upsert_answers_the_index_before_it(search_servers):
    """Through the port's service: the batcher's pass is parked after its
    launch while an upsert over gRPC rewrites the best row; the parked
    query answers with the old row, a later one with the new."""
    _, tstub, thandle = search_servers
    svc = thandle.services["search"]
    rng = np.random.default_rng(22)
    vecs, ids = _vecs(rng, 30), _ids(30)
    call(tstub, "search_upsert", bundle(ids, vecs), BUNDLE_MIME, tenant="t3", shard="0")
    shard = svc.index.shard("t3", "0")
    q = vecs[7]
    launched, written = threading.Event(), threading.Event()
    real = shard.query_raw

    def parked(batch, k):
        out = real(batch, k)
        if not launched.is_set():
            launched.set()
            assert written.wait(10)
        return out

    shard.query_raw = parked
    try:
        payload, meta = tensor_payload(q)
        res = {}
        t = threading.Thread(target=lambda: res.update(
            a=call(tstub, "search_query", bytes(payload), TENSOR_MIME, tenant="t3", shard="0", k=2, **meta)))
        t.start()
        assert launched.wait(10)
        code, _ = call(tstub, "search_upsert", bundle(["v0007"], -q[None]), BUNDLE_MIME, tenant="t3", shard="0")
        assert code == 0
        written.set()
        t.join(30)
    finally:
        shard.query_raw = real
    assert not t.is_alive()
    assert res["a"][1]["ids"] == exact_oracle(ids, vecs, q, 2)[0] and res["a"][1]["ids"][0] == "v0007"
    code, after = call(tstub, "search_query", bytes(payload), TENSOR_MIME, tenant="t3", shard="0", k=30, **meta)
    assert after["ids"][-1] == "v0007" and after["scores"][-1] == pytest.approx(-1.0, abs=SCORE_TOL)


def test_tf32_products_are_refused_on_the_card(monkeypatch):
    """The scoring refuses TF32 products on the card; the CPU path never
    asks (no TF32 there)."""
    monkeypatch.setattr(ann, "_tf32_matmul_on", lambda: True)
    shard = _shard()
    shard.upsert(_ids(4), _vecs(np.random.default_rng(23), 4))
    shard.device = __import__("torch").device("cuda", 0)
    with pytest.raises(RuntimeError, match="IEEE"):
        shard._check_ieee()
