"""The port's continuous engine end to end on the CPU, against the JAX
package's ``VLMManager`` on the same tiny model directory.

Both managers serve the tiny VLM in f32 from the same weights (the JAX
manager loads the directory; the port gets its ``params`` through
``params_from_jax``) and the same tokenizer file. The directory has no
``tokenizer_config.json``, so both render the plain ``<|role|>``
transcript (the port does not render Jinja2 templates yet). The port is
handed the pixels the JAX manager decodes for itself (``vlm_canvas``).
Greedy tokens must be identical, request for request, while the port
serves them concurrently: mixed budgets, a prompt long enough for the
chunked prefill lane (chunk 32), and requests arriving after decoding
has started.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu.utils.host_decode import _spec_vlm_canvas
from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, params_from_jax
from lumen_tpu_torch.models.vlm.continuous import PreemptionShed, _Request, _Slot
from test_vlm import make_vlm_model_dir, png_bytes

LONG = " ".join(f"w{i}" for i in range(16, 36))  # bucket 32: span 35 > chunk 32

#: (prompt, image seed or None, max_new_tokens, streaming, arrives late)
REQUESTS = [
    ("describe the image", 1, 16, False, False),
    ("a cat", None, 5, False, False),
    (LONG, 2, 9, True, False),
    ("the dog a cat", None, 12, False, True),
    ("a dog", 3, 16, True, True),
]


@pytest.fixture(scope="module")
def managers(tmp_path_factory):
    model_dir = make_vlm_model_dir(tmp_path_factory.mktemp("torch_vlm"))
    os.remove(os.path.join(model_dir, "tokenizer_config.json"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_VLM_PREFILL_CHUNK", "32")
        jmgr = JVLMManager(model_dir, dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32))
        jmgr.initialize()
    from tokenizers import Tokenizer

    tok = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    state = params_from_jax(jmgr.params)
    tmgr = VLMManager(
        VLMConfig.tiny(), state, tok, device="cpu", dtype="float32", max_seq=128,
        max_new_cap=16, prefill_buckets=(16, 32), prefill_chunk=32,
    )
    yield jmgr, tmgr, state, tok
    tmgr.close()
    jmgr.close()


def _pixels(seed):
    return None if seed is None else _spec_vlm_canvas(png_bytes(seed=seed), {"size": 32})


def test_concurrent_serving_matches_jax_manager(managers):
    jmgr, tmgr, _, _ = managers
    want = []
    for prompt, seed, n, _, _ in REQUESTS:
        r = jmgr.generate(
            [JChatMessage(role="user", content=prompt)],
            image_bytes=None if seed is None else png_bytes(seed=seed), max_new_tokens=n,
        )
        want.append(r)
    got: dict[int, object] = {}
    errors: list[BaseException] = []

    def run(i):
        prompt, seed, n, stream, _ = REQUESTS[i]
        msgs = [ChatMessage(role="user", content=prompt)]
        try:
            if stream:
                got[i] = list(tmgr.generate_stream(msgs, _pixels(seed), max_new_tokens=n))
            else:
                got[i] = tmgr.generate(msgs, _pixels(seed), max_new_tokens=n)
        except BaseException as e:  # noqa: BLE001 - surfaced by the asserts below
            errors.append(e)

    engine = tmgr.engine
    blocks0, chunks0 = engine.blocks_run, engine.chunks_run
    first = [threading.Thread(target=run, args=(i,)) for i, r in enumerate(REQUESTS) if not r[4]]
    for t in first:
        t.start()
    deadline = time.monotonic() + 60
    while engine.blocks_run == blocks0 and time.monotonic() < deadline and not errors:
        time.sleep(0.001)
    assert engine.blocks_run > blocks0, "decoding never started"
    late = [threading.Thread(target=run, args=(i,)) for i, r in enumerate(REQUESTS) if r[4]]
    for t in late:
        t.start()
    for t in first + late:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for i, (prompt, seed, n, stream, _) in enumerate(REQUESTS):
        if stream:
            chunks = got[i]
            assert chunks[-1].is_final
            assert chunks[-1].metadata["generated_tokens"] == len(want[i].tokens)
            assert "".join(c.text for c in chunks).strip() == want[i].text
            assert chunks[-1].metadata["ttft_ms"] > 0
        else:
            assert got[i].tokens == want[i].tokens, (i, prompt)
            assert got[i].text == want[i].text
            assert got[i].finish_reason == want[i].finish_reason
    assert engine.chunks_run > chunks0  # the long prompt took the chunk lane
    stats = engine.kv.stats()
    assert stats.pages_live == 0 and stats.allocated_total == stats.freed_total


def test_preemption_redoes_greedy_rows_token_identically(managers):
    """A pool too small for four rows' growth preempts the newest rows;
    greedy victims restart from their prompts and still answer exactly
    what an unpressured engine answers."""
    _, tmgr, state, tok = managers
    small = VLMManager(
        VLMConfig.tiny(), state, tok, device="cpu", dtype="float32", max_seq=128,
        max_new_cap=16, prefill_buckets=(16, 32), gen_slots=4, pool_pages=6, name="small",
    )
    prompts = ["a cat", "a dog", "the image", "describe a dog"]
    want = [tmgr.generate([ChatMessage("user", p)], max_new_tokens=16).tokens for p in prompts]
    try:
        out: dict[int, list] = {}
        threads = [
            threading.Thread(
                target=lambda i=i: out.__setitem__(
                    i, small.generate([ChatMessage("user", prompts[i])], max_new_tokens=16).tokens
                )
            )
            for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [out[i] for i in range(4)] == want
        eng = small.engine
        assert eng.preemptions > 0 and eng.preempt_redone == eng.preemptions
        assert eng.kv.stats().pages_live == 0
    finally:
        small.close()


def test_sampled_streamed_victim_is_shed(managers):
    """A sampled row that already streamed tokens cannot restart: it
    fails with the retryable PreemptionShed, and its pages return."""
    _, tmgr, _, _ = managers
    eng = tmgr.engine
    req, _ = tmgr._make_gen_request(
        [ChatMessage("user", "a cat")], None, 4, 1.0, 1.0, True, 1.0, True
    )
    req.delivered = 2
    # Install the row by hand while holding the engine's lock: the idle
    # loop thread waits on it and never sees the row.
    with eng._cond:
        slot = eng._free_slot()
        eng.kv.admit(slot, req.n_prompt)
        eng._slots[slot] = _Slot(request=req, prompt_len=req.n_prompt, seq=10**6)
        try:
            assert eng._preempt_newest(protect=-1)
        finally:
            eng._slots.pop(slot, None)
    with pytest.raises(PreemptionShed) as err:
        req.future.result(timeout=5)
    assert err.value.retry_after_s > 0
    assert eng.kv.owned_pages(slot) == []


def test_infeasible_request_fails_at_the_door(managers):
    _, tmgr, _, _ = managers
    req, _ = tmgr._make_gen_request([ChatMessage("user", "a cat")], None, 16, 0.0, 1.0, False, 1.0, True)
    req.n_prompt = 10_000
    with pytest.raises(ValueError, match="KV tokens"):
        tmgr.engine.submit(req)


def test_cancelled_stream_frees_its_slot(managers):
    _, tmgr, _, _ = managers
    stream = tmgr.generate_stream([ChatMessage("user", "a dog")], None, max_new_tokens=16)
    next(stream)
    stream.close()  # consumer gone mid-stream
    deadline = time.monotonic() + 30
    while tmgr.engine._slots and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not tmgr.engine._slots
    assert tmgr.engine.kv.stats().pages_live == 0


def test_close_fails_queued_requests(managers):
    _, _, state, tok = managers
    mgr = VLMManager(VLMConfig.tiny(), state, tok, device="cpu", dtype="float32", max_seq=128,
                     max_new_cap=16, prefill_buckets=(16, 32), name="closing")
    mgr.close()
    req, _ = mgr._make_gen_request([ChatMessage("user", "a cat")], None, 4, 0.0, 1.0, False, 1.0, True)
    with pytest.raises(RuntimeError, match="closed"):
        mgr.engine.submit(req)
    assert isinstance(req, _Request)


def test_pixels_are_checked(managers):
    _, tmgr, _, _ = managers
    with pytest.raises(ValueError, match="uint8"):
        tmgr.generate([ChatMessage("user", "a cat")], np.zeros((16, 16, 3), np.uint8), max_new_tokens=2)
    assert torch.equal(tmgr._pixels(np.full((32, 32, 3), 7, np.uint8))[0, 0, 0], torch.full((3,), 7, dtype=torch.uint8))
