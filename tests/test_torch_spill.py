"""The port's KV spill tier against the JAX engine's, on the CPU.

Both packages serve ``tests/test_vlm.py``'s tiny model directory in f32
(the port through ``VLMManager.from_model_dir``, so weights, tokenizer and
chat template are the JAX manager's own). A pool of 6 pages of 16 tokens
(5 usable) cannot hold two 40-token generations, so the newer row is
preempted; the pair is submitted while the engine's lock is held, so both
rows admit in one turn and the preemption is deterministic. The mirror of
``tests/test_vlm_continuous.py::TestKVSpillTier``:

- greedy tokens under pressure equal the JAX engine's unpressured ones,
  and a spilled row resumes with no second prefill;
- a sampled stream preempted mid-stream resumes and delivers every token
  exactly once;
- the ``kv_spill`` / ``kv_resume`` fault points degrade to redo;
- leases and pages balance at drain;
- the port's spill payload unpacks with the JAX package's
  ``migration.unpack_payload`` into the leaves of the JAX engine's record
  for the same row (shapes, dtypes, bytes; KV values within 1e-4);
- the ``vlm-continuous:*`` gauge keys and the ``vlm_*`` counters the
  drive moves are the JAX engine's.
"""

from __future__ import annotations

import queue
import time

import numpy as np
import pytest
import torch

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu.models.vlm import migration as jmigration
from lumen_tpu.models.vlm.continuous import ContinuousScheduler as JScheduler
from lumen_tpu.utils.metrics import metrics as jmetrics
from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
from lumen_tpu_torch.models.vlm.continuous import _STREAM_END
from lumen_tpu_torch.testing import faults
from lumen_tpu_torch.utils.metrics import metrics
from test_vlm import make_vlm_model_dir

PAIR = ("alpha beta", "gamma delta")
#: oldest greedy row, newest sampled stream (``TestKVSpillTier``'s pair)
SHORT, LONG = "hi", "gamma delta epsilon zeta eta theta"
MAX_NEW = 40
#: KV values of the two packages' spill payloads: f32 forwards that differ
#: only in summation order
KV_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run faster on one intra-op thread here, and it
    leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_vlm_model_dir(tmp_path_factory.mktemp("torch_spill"))


@pytest.fixture(scope="module")
def jax_serial(model_dir):
    """The JAX manager's unpressured greedy tokens for PAIR."""
    mgr = JVLMManager(model_dir, dtype="float32", max_seq=128, max_new_cap=64, prefill_buckets=(16,),
                      scheduler="continuous", gen_slots=2, gen_block=4)
    mgr.initialize()
    try:
        return [mgr.generate([JChatMessage(role="user", content=p)], max_new_tokens=MAX_NEW).tokens
                for p in PAIR]
    finally:
        mgr.close()


def port_manager(model_dir) -> VLMManager:
    return VLMManager.from_model_dir(
        model_dir, device="cpu", dtype="float32", max_seq=128, max_new_cap=64, prefill_buckets=(16,),
        gen_slots=2, gen_block=4, page_size=16, pool_pages=6,
    )


def jax_tiny(model_dir):
    """The JAX manager with ``TestKVSpillTier``'s tiny engine."""
    mgr = JVLMManager(model_dir, dtype="float32", max_seq=128, max_new_cap=64, prefill_buckets=(16,),
                      scheduler="continuous", gen_slots=2, gen_block=4)
    mgr.initialize()
    mgr._continuous.close()
    tiny = JScheduler(mgr.generator, mgr.params, slots=2, block=4, name=mgr.info.name, page_size=16, pages=6)
    mgr._continuous = tiny
    mgr._engines = [tiny]
    return mgr, tiny


def submit_pair(mgr, prompts=PAIR, sampled=(False, False)):
    """Submit one request per prompt under the engine's lock (one admission
    turn); returns the requests. A sampled request (near-greedy, 0.01, as
    in the JAX test: the sampled path without an EOS lottery) streams its
    token ids into ``req.stream_q``."""
    reqs = []
    for p, s in zip(prompts, sampled):
        req, _ = mgr._make_gen_request([ChatMessage("user", p)], None, MAX_NEW, 0.01 if s else 0.0, 1.0, s, 1.0, True)
        if s:
            req.stream_q = queue.SimpleQueue()
        reqs.append(req)
    with mgr.engine._cond:
        for req in reqs:
            mgr.engine.submit(req)
    return reqs


def jax_submit_pair(mgr, eng, prompts=PAIR):
    reqs = []
    for p in prompts:
        e, pos, ln, ids, _ = mgr._prepare_inputs([JChatMessage(role="user", content=p)], None, True)
        reqs.append(mgr._make_gen_request(e, pos, ln, ids, MAX_NEW, 0.0, 1.0, False, 1.0))
    with eng._cond:
        for req in reqs:
            eng.submit(req)
    return reqs


def tokens_of(req) -> list[int]:
    toks, n_gen, _ = req.future.result(timeout=120)
    return [int(t) for t in toks[:n_gen]]


def assert_balanced(eng) -> None:
    deadline = time.monotonic() + 20
    while eng._slots and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not eng._slots
    stats = eng.kv.stats()
    assert stats.pages_live == 0 and stats.allocated_total == stats.freed_total
    assert not eng._spill_ledger and eng._spill_bytes_live == 0
    if eng._spill_arena is not None:
        assert eng._spill_arena.live() == 0


def count_prefill_rows(eng) -> tuple[list, list, callable]:
    """Wrap the generator's prefill programs: rows of each full prefill and
    each chunk call; returns ``(full, chunks, restore)``."""
    gen = eng.gen
    full, chunks = [], []
    real_prefill, real_chunk = gen.prefill, gen.prefill_chunk

    def prefill(embeds, *a, **kw):
        full.append(int(embeds.shape[0]))
        return real_prefill(embeds, *a, **kw)

    def prefill_chunk(caches, embeds, *a, **kw):
        chunks.append(int(embeds.shape[1]))
        return real_chunk(caches, embeds, *a, **kw)

    gen.prefill, gen.prefill_chunk = prefill, prefill_chunk

    def restore():
        gen.prefill, gen.prefill_chunk = real_prefill, real_chunk

    return full, chunks, restore


def test_spill_resume_greedy_matches_jax_without_reprefill(model_dir, jax_serial):
    mgr = port_manager(model_dir)
    eng = mgr.engine
    full, chunks, restore = count_prefill_rows(eng)
    try:
        reqs = submit_pair(mgr)
        got = [tokens_of(r) for r in reqs]
        assert got == jax_serial
        assert eng.preemptions >= 1 and eng.spills == eng.preemptions
        assert eng.spill_resumes == eng.spills
        assert eng.preempt_redone == 0 and eng.preempt_failed == 0
        # Zero re-prefill: one prefill row per request, ever, and no chunk.
        assert sum(full) == 2 and chunks == []
        assert eng.admitted == 2 + eng.spill_resumes
        assert_balanced(eng)
    finally:
        restore()
        mgr.close()


def test_sampled_midstream_victim_resumes_exactly_once(model_dir):
    """The newest row, a sampled stream that already delivered tokens, is
    the victim: it resumes through the spill tier and its stream carries
    exactly the row's final tokens, in order."""
    mgr = port_manager(model_dir)
    eng = mgr.engine
    try:
        greedy, sampled = submit_pair(mgr, (SHORT, LONG), sampled=(False, True))
        streamed = []
        while (item := sampled.stream_q.get(timeout=120)) is not _STREAM_END:
            streamed.append(int(item))
        assert tokens_of(greedy)
        assert streamed == tokens_of(sampled) and streamed
        assert eng.preemptions >= 1 and eng.spills >= 1
        assert eng.spill_resumes == eng.spills and eng.preempt_failed == 0
        assert_balanced(eng)
    finally:
        mgr.close()


@pytest.mark.parametrize("point", ["kv_spill", "kv_resume"])
def test_fault_points_degrade_to_redo(model_dir, jax_serial, point):
    """An armed ``kv_spill`` fails every export; an armed ``kv_resume``
    (once) kills the re-install of a parked record. Either way the greedy
    victim restarts from its prompt, its tokens still the JAX engine's,
    and the dead record's lease is freed."""
    mgr = port_manager(model_dir)
    eng = mgr.engine
    faults.configure(point, **({} if point == "kv_spill" else {"times": 1}))
    try:
        got = [tokens_of(r) for r in submit_pair(mgr)]
        assert got == jax_serial
        assert eng.preemptions >= 1 and eng.preempt_redone >= 1
        if point == "kv_spill":
            assert eng.spills == 0
        else:
            assert eng.spills >= 1
        assert_balanced(eng)
    finally:
        faults.reset()
        mgr.close()


def test_drop_spill_idempotent_and_lease_balance(model_dir):
    from lumen_tpu_torch.models.vlm.continuous import _SpillRecord

    mgr = port_manager(model_dir)
    eng = mgr.engine
    try:
        req = submit_pair(mgr, PAIR[:1], sampled=(False,))[0]
        tokens_of(req)
        lease = eng._get_arena().acquire(1 << 10)
        assert lease is not None
        rec = _SpillRecord(n_pages=1, n_pad=1, nbytes=1 << 10, crc=0, cur_tok=0, cur_len=0, n_gen=0, lease=lease)
        req.spill = rec
        eng._spill_ledger[id(req)] = rec
        eng._spill_bytes_live += rec.nbytes
        assert eng._drop_spill(req) is rec
        assert eng._drop_spill(req) is None  # idempotent
        assert_balanced(eng)
    finally:
        mgr.close()


def capture_records(eng) -> list:
    """Wrap ``_park_spill`` to keep each record's packed blob and crc."""
    got = []
    real = eng._park_spill

    def park(req, record):
        blob = bytes(record.lease.buf[: record.nbytes]) if record.lease is not None else None
        got.append((record, blob))
        real(req, record)

    eng._park_spill = park
    return got


def test_payload_unpacks_with_the_jax_migration_module(model_dir):
    """The same greedy pair under the same pressure preempts the same row
    at the same step in both engines: the port's blob unpacks with the JAX
    ``migration.unpack_payload`` into the JAX record's leaf shapes and
    dtypes, byte count for byte count; the ``seen`` mask and the decode
    scalars are equal and the live KV pages agree within 1e-4."""
    jmgr, jeng = jax_tiny(model_dir)
    mgr = port_manager(model_dir)
    try:
        want, got = capture_records(jeng), capture_records(mgr.engine)
        jreqs = jax_submit_pair(jmgr, jeng)
        reqs = submit_pair(mgr)
        for j, t in zip(jreqs, reqs):
            j.future.result(timeout=120)
            tokens_of(t)
        assert want and got
        (jrec, jblob), (rec, blob) = want[0], got[0]
        assert jblob is not None and blob is not None  # both took the shm arena
        jleaves = jmigration.unpack_payload(jblob, jrec.crc)
        leaves = jmigration.unpack_payload(blob, rec.crc)
        assert [(a.shape, a.dtype) for a in leaves] == [(a.shape, a.dtype) for a in jleaves]
        assert rec.nbytes == jrec.nbytes and len(blob) == len(jblob)
        assert (rec.n_pages, rec.n_pad, rec.prompt_len) == (jrec.n_pages, jrec.n_pad, jrec.prompt_len)
        assert (rec.cur_tok, rec.cur_len, rec.n_gen) == (jrec.cur_tok, jrec.cur_len, jrec.n_gen)
        assert rec.tokens == jrec.tokens
        np.testing.assert_array_equal(leaves[-1], jleaves[-1])  # seen
        for a, b in zip(leaves[:-1], jleaves[:-1]):
            live = slice(0, rec.n_pages)  # pad pages hold dump-page garbage
            np.testing.assert_allclose(a[live], b[live], atol=KV_ATOL, rtol=0)
        assert_balanced(mgr.engine)
    finally:
        mgr.close()
        jmgr.close()


def test_gauges_and_counters_match_the_jax_engine(model_dir):
    """After the same pressured drive, the two engines publish the same
    ``vlm-continuous:*`` gauge keys and move the same ``vlm_*`` counters."""

    def vlm_counters(registry) -> dict:
        return {k: v for k, v in registry.snapshot().get("counters", {}).items() if k.startswith("vlm_")}

    jmgr, jeng = jax_tiny(model_dir)
    mgr = port_manager(model_dir)
    try:
        j0, t0 = vlm_counters(jmetrics), vlm_counters(metrics)
        for r in jax_submit_pair(jmgr, jeng):
            r.future.result(timeout=120)
        for r in submit_pair(mgr):
            tokens_of(r)
        assert_balanced(mgr.engine)
        j1, t1 = vlm_counters(jmetrics), vlm_counters(metrics)
        moved = lambda before, after: sorted(k for k, v in after.items() if v != before.get(k, 0))  # noqa: E731
        assert moved(t0, t1) == moved(j0, j1)
        assert "vlm_spills" in moved(t0, t1)
        gauges = metrics.snapshot()["gauges"]["vlm-continuous:TinyVLM"]
        jgauges = jmetrics.snapshot()["gauges"]["vlm-continuous:TinyVLM"]
        assert sorted(gauges) == sorted(jgauges)
        assert gauges["spill_bytes_budget"] == jgauges["spill_bytes_budget"] == 256 << 20
        for key in ("preempted", "spilled", "spill_resumed", "preempt_redone", "admitted", "pages_live"):
            assert gauges[key] == jgauges[key], key
    finally:
        mgr.close()
        jmgr.close()
