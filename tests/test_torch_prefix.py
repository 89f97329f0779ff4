"""The port's prefix KV cache against the JAX engine's, on the CPU.

Both packages serve ``tests/test_vlm.py``'s tiny model directory in f32
with ``LUMEN_VLM_PREFIX_BYTES`` set and a 32-token prefill chunk, so a
text prompt of bucket 32 admits directly and an image prompt (35 live
positions) goes through the chunk lane. The mirror of
``tests/test_vlm_continuous.py::TestPrefixReuseAndSpec``'s prefix tests:

- a repeated prompt admits through the cache: no full prefill, one
  suffix chunk, the JAX engine's tokens and ``prefix_hit`` metadata;
- one photo asked several questions behind a shared lead: the later
  questions seed their lane scratch from the cached page and prefill only
  the positions after it, with the JAX engine's tokens and ``prefix_hit``;
- two rows on one cached prefix under a pool that must preempt: the
  spill exports only the private suffix, resume re-attaches the shared
  page, and pages balance at drain.

Greedy tokens must be equal (the tolerance of the earlier slices).
"""

from __future__ import annotations

import pytest

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
from test_torch_spill import (  # noqa: F401 - one_torch_thread is an autouse fixture
    assert_balanced, count_prefill_rows, one_torch_thread, submit_pair, tokens_of,
)
from test_vlm import make_vlm_model_dir, png_bytes

#: 20 live tokens under the (16, 32) buckets: one full cached page, a hit
#: covers 16 / 20 = 0.8 (``TestPrefixReuseAndSpec.PROMPT``).
PROMPT = "the quick brown fox jumps over the lazy dog again and again and again"
#: a lead long enough that image + lead fill the first page.
LEAD = " ".join(f"w{i}" for i in range(40, 54))
QUESTIONS = ("describe the cat", "a dog", "the image")
KW = dict(dtype="float32", max_seq=128, max_new_cap=64, prefill_buckets=(16, 32), gen_slots=4, gen_block=4)


@pytest.fixture(scope="module")
def managers(tmp_path_factory):
    model_dir = make_vlm_model_dir(tmp_path_factory.mktemp("torch_prefix"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_VLM_PREFIX_BYTES", str(8 << 20))
        mp.setenv("LUMEN_VLM_PREFILL_CHUNK", "32")
        jmgr = JVLMManager(model_dir, scheduler="continuous", **KW)
        jmgr.initialize()
        tmgr = VLMManager.from_model_dir(model_dir, device="cpu", prefill_chunk=32, **KW)
        yield model_dir, jmgr, tmgr
    tmgr.close()
    jmgr.close()


def both(jmgr, tmgr, content: str, image: bytes | None = None, max_new: int = 8):
    want = jmgr.generate([JChatMessage(role="user", content=content)], image_bytes=image, max_new_tokens=max_new)
    got = tmgr.generate([ChatMessage("user", content)], image_bytes=image, max_new_tokens=max_new)
    return want, got


def test_prefix_hit_skips_covered_prefill(managers):
    _, jmgr, tmgr = managers
    eng = tmgr.engine
    assert eng.prefix is not None
    hits0, misses0 = eng.prefix_hits, eng.prefix_misses
    want, got = both(jmgr, tmgr, PROMPT)
    assert got.tokens == want.tokens
    assert got.metadata["prefix_hit"] == want.metadata["prefix_hit"] == 0.0  # on, cold
    assert (eng.prefix_hits, eng.prefix_misses) == (hits0, misses0 + 1)
    full, chunks, restore = count_prefill_rows(eng)
    try:
        want2, got2 = both(jmgr, tmgr, PROMPT)
    finally:
        restore()
    assert got2.tokens == want2.tokens == got.tokens
    assert got2.metadata["prefix_hit"] == want2.metadata["prefix_hit"] == 0.8  # 16 / 20 tokens
    assert eng.prefix_hits == hits0 + 1 and eng.prefix_hit_pages >= 1
    # The covered page never reaches the decoder again: no full prefill,
    # one chunk over the rest of the 32-position span.
    assert full == [] and chunks == [16]
    gauges, jgauges = eng.gauges(), jmgr._continuous._gauge_fn()
    assert sorted(gauges) == sorted(jgauges)
    assert gauges["prefix_entries"] >= 1 and gauges["prefix_hits"] == eng.prefix_hits


def test_photo_questions_share_the_image_prefix(managers):
    """Photo-library traffic: one photo, a shared lead, several questions in
    two waves. The first question prefills cold through the chunk lane;
    the others seed their scratch from the cached page and start chunking
    after it."""
    _, jmgr, tmgr = managers
    image = png_bytes(seed=7)
    eng = tmgr.engine
    full, chunks, restore = count_prefill_rows(eng)
    try:
        cold = both(jmgr, tmgr, f"{LEAD} {QUESTIONS[0]}", image)
        cold_chunks, chunks[:] = list(chunks), []
        warm = [both(jmgr, tmgr, f"{LEAD} {q}", image) for q in QUESTIONS[1:]]
    finally:
        restore()
    for want, got in [cold, *warm]:
        assert got.tokens == want.tokens
        assert got.metadata["prefix_hit"] == want.metadata["prefix_hit"]
    assert cold[1].metadata["prefix_hit"] == 0.0
    assert all(got.metadata["prefix_hit"] > 0 for _, got in warm)
    # 35 positions (27 live): the cold lane job runs one 32-position chunk;
    # a warm one starts after the 16 covered positions.
    assert full == [] and cold_chunks == [32]
    assert chunks == [35 - 16] * len(warm)


def test_shared_prefix_spill_resume_balanced(managers, monkeypatch):
    """Both rows of a pressured pair attach one cached prefix page, so the
    victim holds a shared page: only its private suffix is exported, the
    shared page re-attaches on resume, and pages and leases balance."""
    model_dir, jmgr, _ = managers
    want = jmgr.generate([JChatMessage(role="user", content=PROMPT)], max_new_tokens=40).tokens
    monkeypatch.setenv("LUMEN_VLM_PREFIX_BYTES", str(8 << 20))
    mgr = VLMManager.from_model_dir(
        model_dir, device="cpu", dtype="float32", max_seq=128, max_new_cap=64, prefill_buckets=(16, 32),
        gen_slots=2, gen_block=4, page_size=16, pool_pages=6,
    )
    eng = mgr.engine
    try:
        seeded = mgr.generate([ChatMessage("user", PROMPT)], max_new_tokens=40)
        assert seeded.tokens == want
        full, chunks, restore = count_prefill_rows(eng)
        try:
            reqs = submit_pair(mgr, (PROMPT, PROMPT))
            got = [tokens_of(r) for r in reqs]
        finally:
            restore()
        assert got == [want, want]
        assert full == [] and len(chunks) == 2  # two hits, no re-prefill
        assert eng.prefix_hits >= 2
        # 2 rows x 4 pages on 1 shared page > 5 usable pages: a preemption
        # of a shared-prefix holder, through the spill tier.
        assert eng.preemptions >= 1 and eng.spills >= 1
        assert eng.spill_resumes == eng.spills and eng.preempt_failed == 0
        eng.prefix.clear()  # the cache holds the last references
        assert_balanced(eng)
    finally:
        mgr.close()
