"""The port's speculative decoding against the JAX package's, on the CPU
at the tiny configuration in f32.

Inputs come from numpy seeds and go through both packages. The JAX side
runs its own CPU route: ``paged_attention_varq_reference`` (never the
interpret-mode Pallas kernel) under its ``_verify`` program and its
continuous engine. On CPU tensors the port's ``paged_attention_varq_kernel``
runs its plain version. Tolerances: atol 1e-5 for the attention op and
the pool's K/V, identical tokens and counters for the programs.
"""

from __future__ import annotations

import importlib
import os
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu.models.vlm import generate as jgen
from lumen_tpu.models.vlm import modeling as jm
from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, params_from_jax
from lumen_tpu_torch.models.vlm import generate as tgen
from lumen_tpu_torch.models.vlm import modeling as tm
from lumen_tpu_torch.models.vlm.paged_kv import PagedKVPool
from lumen_tpu_torch.ops import attention as tatt
from test_vlm import make_vlm_model_dir

jatt = importlib.import_module("lumen_tpu.ops.attention")

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE, SLOTS, MAX_SEQ, BLOCK, WIDTH = 4, 4, 64, 4, 5


def _t(x):
    return torch.from_numpy(np.array(x))


def _window_case(b, w, h, kvh, d, page, maxp, seed):
    """Pages, ragged t = 0 visibilities whose windows fit the table, and
    tables whose entries past each row's window sit on the dump page."""
    rng = np.random.default_rng(seed)
    n_pages = maxp * b + 1
    q = rng.standard_normal((b, w, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, kvh, page, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, kvh, page, d)).astype(np.float32)
    bt = rng.integers(1, n_pages, size=(b, maxp)).astype(np.int32)
    kl = rng.integers(1, maxp * page - w + 2, size=(b,)).astype(np.int32)
    for r in range(b):
        bt[r, -(-(kl[r] + w - 1) // page):] = 0
    return q, kp, vp, bt, kl


class TestVerifyWindowAttention:
    @pytest.mark.parametrize(
        "b,w,h,kvh,d,page,maxp",
        [
            (3, 1, 4, 2, 8, 4, 5),  # W = 1: the single-token case
            (3, 2, 4, 2, 8, 4, 5),  # tiny-config GQA
            (2, 5, 14, 2, 64, 16, 8),  # Qwen2-0.5B verify shape (group 7, padded to 8)
            (4, 5, 6, 3, 16, 4, 7),  # odd everything, windows across page edges
        ],
    )
    def test_reference_matches_jax(self, b, w, h, kvh, d, page, maxp):
        q, kp, vp, bt, kl = _window_case(b, w, h, kvh, d, page, maxp, seed=b * 11 + w)
        want = jatt.paged_attention_varq_reference(*(jnp.asarray(x) for x in (q, kp, vp, bt, kl)))
        got = tatt.paged_attention_varq_reference(_t(q), _t(kp), _t(vp), _t(bt), _t(kl))
        assert got.shape == (b, w, h, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # The 4-D dispatch and the kernel wrapper on CPU tensors are the plain version.
        assert torch.equal(tatt.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(kl)), got)
        assert torch.equal(tatt.paged_attention_varq_kernel(_t(q), _t(kp), _t(vp), _t(bt), _t(kl)), got)

    def test_window_one_is_the_single_token_version(self):
        q, kp, vp, bt, kl = _window_case(3, 1, 14, 2, 64, 16, 6, seed=2)
        got = tatt.paged_attention_varq_reference(_t(q), _t(kp), _t(vp), _t(bt), _t(kl))[:, 0]
        want = tatt.paged_attention_reference(_t(q[:, 0]), _t(kp), _t(vp), _t(bt), _t(kl))
        torch.testing.assert_close(got, want, **TOL)

    def test_slot_t_is_a_decode_step_at_length_plus_t(self):
        """Window slot t gives what the single-token version gives at
        kv_lens + t: the property the greedy identity rests on."""
        q, kp, vp, bt, kl = _window_case(2, 5, 4, 2, 8, 4, 6, seed=4)
        win = tatt.paged_attention_varq_reference(_t(q), _t(kp), _t(vp), _t(bt), _t(kl))
        for t in range(5):
            one = tatt.paged_attention_reference(_t(q[:, t]), _t(kp), _t(vp), _t(bt), _t(kl + t))
            torch.testing.assert_close(win[:, t], one, **TOL)

    def test_kernel_source_names_the_tpu_kernel(self):
        text = tatt.PAGED_VARQ.source_path.read_text()
        assert 'extern "C" int lumen_paged_attention_varq(' in text
        assert "lumen_tpu/ops/attention.py:849" in text
        # Both paged kernels instantiate the one page walk (W = 1 bit for bit).
        assert '#include "paged_walk.cuh"' in text
        assert '#include "paged_walk.cuh"' in tatt.PAGED.source_path.read_text()


# -- Generator.verify against the JAX _verify ----------------------------------


@pytest.fixture(scope="module")
def gens():
    cfg = jm.VLMConfig.tiny()
    jmodel = jm.VLMModel(cfg)
    params = jmodel.init(
        jax.random.PRNGKey(3),
        jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3), jnp.float32),
    )["params"]
    tmodel = tm.VLMModel(tm.VLMConfig.tiny())
    tmodel.load_state_dict(params_from_jax(params))
    jg = jgen.Generator(jmodel, cfg, MAX_SEQ, 16, cache_dtype=jnp.float32)
    tg = tgen.Generator(tmodel.eval(), tm.VLMConfig.tiny(), MAX_SEQ, cache_dtype=torch.float32)
    return params, jmodel, jg, tg


def _clone_pool(pool):
    out = {}
    for name, value in pool.items():
        if name == "caches":
            out[name] = [{n: t.clone() for n, t in layer.items()} for layer in value]
        elif isinstance(value, torch.Tensor):
            out[name] = value.clone()
        else:
            out[name] = value.copy()
    return out


def test_verify_matches_jax_verify(gens):
    """Three rows decode a block, then one verify turn: a perfect draft
    that runs into the row's budget mid-window, a draft wrong at its
    second token, and a row with no draft (q_len 1). Tokens, counters and
    the pool's pages equal the JAX program's, and accepted tokens equal
    the plain sequential continuation."""
    params, jmodel, jg, tg = gens
    kv = PagedKVPool(SLOTS * (MAX_SEQ // PAGE) + 1, PAGE, SLOTS, MAX_SEQ // PAGE)
    jpool = jg.init_pool(SLOTS, page_size=PAGE)
    tpool = tg.init_pool(SLOTS, page_size=PAGE)
    rows = {0: (9, 7), 2: (14, 20), 3: (5, 20)}  # slot: (prompt, budget)
    prompt_len = {}
    for slot, (n, budget) in rows.items():
        rng = np.random.default_rng(slot + 20)
        ids = np.zeros((1, 16), np.int32)
        ids[0, :n] = rng.integers(3, 240, n)
        embeds = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), method=jm.VLMModel.embed_tokens))
        pos = np.arange(16, dtype=np.int32)[None]
        length = np.asarray([n], np.int32)
        f = lambda v, dt: jnp.asarray([v], dt)  # noqa: E731
        jc, jtok, jseen = jg._prefill(
            params, jnp.asarray(embeds), jnp.asarray(pos), jnp.asarray(length), jnp.asarray(ids),
            jax.random.PRNGKey(0), f(0.0, jnp.float32), f(1.0, jnp.float32), f(False, bool),
            f(1.0, jnp.float32), kv_len=16,
        )
        gp = (torch.tensor([0.0]), torch.tensor([1.0]), torch.tensor([False]), torch.tensor([1.0]))
        tc, ttok, tseen = tg.prefill(_t(embeds), _t(pos), _t(length), _t(ids).long(), None, *gp, kv_len=16)
        bt_row = kv.admit(slot, n)
        jpool = jg._admit(jpool, slot, jc, jtok, jseen, jnp.asarray(length), jnp.asarray(bt_row),
                          budget, 0.0, 1.0, False, 1.0)
        tg.admit(tpool, slot, tc, ttok, tseen, n, bt_row, budget, 0.0, 1.0, False, 1.0)
        prompt_len[slot] = n
    for slot in rows:
        kv.grow(slot, prompt_len[slot] + BLOCK)
    tables = kv.block_tables.copy()
    jpool, _, _ = jg._step_block(params, jpool, jnp.asarray(tables), jax.random.PRNGKey(0), block=BLOCK)
    tg.step_block(tpool, _t(tables), None, block=BLOCK)
    for slot in rows:
        kv.grow(slot, prompt_len[slot] + BLOCK + WIDTH)
    tables = kv.block_tables.copy()
    # The sequential continuation, from a copy of the pool.
    truth = tg.step_block(_clone_pool(tpool), _t(tables), None, block=WIDTH).numpy()
    draft = np.zeros((SLOTS, WIDTH), np.int32)
    q_lens = np.ones((SLOTS,), np.int32)
    draft[0, 1:] = truth[0, 1:]  # all right; the budget ends the row after 3 tokens
    draft[2, 1:] = truth[2, 1:]
    draft[2, 2] = (truth[2, 2] + 1) % 250  # right, then wrong
    q_lens[[0, 2]] = WIDTH
    jpool, _, jtoks = jg._verify(
        params, jpool, jnp.asarray(tables), jax.random.PRNGKey(0), jnp.asarray(draft),
        jnp.asarray(q_lens), width=WIDTH,
    )
    ttoks = tg.verify(tpool, _t(tables), None, _t(draft), _t(q_lens), WIDTH)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    for name in ("n_gen", "done", "eos", "cur_len", "cur_tok"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]), err_msg=name)
    np.testing.assert_array_equal(tpool["seen"].numpy(), np.asarray(jpool["seen"]))
    assert int(tpool["n_gen"][0]) == 7 and bool(tpool["done"][0])  # 3 emitted, then the budget
    np.testing.assert_array_equal(ttoks[0, :3].numpy(), truth[0, :3])
    # Row 2: the pending token and one accepted draft; the model's own
    # choice where the draft went wrong is the next pending token.
    np.testing.assert_array_equal(ttoks[2, :2].numpy(), truth[2, :2])
    assert int(ttoks[2, 2]) == tg.cfg.pad_token_id and int(tpool["cur_tok"][2]) == truth[2, 2]
    assert int(tpool["n_gen"][2]) == BLOCK + 2 and int(tpool["n_gen"][3]) == BLOCK + 1
    live = np.unique(kv.block_tables[[0, 2, 3]])
    live = live[live > 0]
    for jl, tl in zip(jpool["caches"], tpool["caches"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(tl[name][live].numpy(), np.asarray(jl[name])[live], **TOL)


# -- the continuous engine with speculation ------------------------------------

PROMPT = "the quick brown fox jumps over the lazy dog again and again and again"
KW = dict(dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32), gen_slots=4, gen_block=4)


@pytest.fixture(scope="module")
def spec_managers(tmp_path_factory):
    """JAX engine with LUMEN_VLM_SPEC_K=4; the port's engine with and
    without it, on the same weights and tokenizer file."""
    model_dir = make_vlm_model_dir(tmp_path_factory.mktemp("torch_spec"))
    os.remove(os.path.join(model_dir, "tokenizer_config.json"))
    from tokenizers import Tokenizer

    tok = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_VLM_SPEC_K", "4")
        jmgr = JVLMManager(model_dir, scheduler="continuous", **KW)
        jmgr.initialize()
        state = params_from_jax(jmgr.params)
        spec = VLMManager(VLMConfig.tiny(), state, tok, device="cpu", name="spec", **KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("LUMEN_VLM_SPEC_K", raising=False)
        plain = VLMManager(VLMConfig.tiny(), state, tok, device="cpu", name="plain", **KW)
    yield jmgr, spec, plain
    for mgr in (spec, plain, jmgr):
        mgr.close()


def test_spec_greedy_tokens_match_plain_and_jax(spec_managers):
    """LUMEN_VLM_SPEC_K=4: greedy tokens equal the port without
    speculation and the JAX engine with it, with real proposals and
    acceptances (twin of the JAX engine's own test)."""
    jmgr, spec, plain = spec_managers
    eng = spec.engine
    assert eng.spec_k == 4 and eng._spec_active() and plain.engine.spec_k == 0
    msgs = [ChatMessage(role="user", content=PROMPT)]
    base = plain.generate(msgs, max_new_tokens=12)
    res = spec.generate(msgs, max_new_tokens=12)
    want = jmgr.generate([JChatMessage(role="user", content=PROMPT)], max_new_tokens=12)
    assert res.tokens == base.tokens == want.tokens, (res.text, base.text, want.text)
    assert eng.spec_turns >= 1 and eng.spec_proposed > 0 and eng.spec_accepted > 0
    rate = res.metadata.get("spec_accept_rate")
    assert rate is not None and 0.0 < rate <= 1.0
    assert rate == want.metadata.get("spec_accept_rate")
    assert "spec_accept_rate" not in base.metadata
    assert plain.engine.spec_turns == 0


def test_spec_concurrent_rows_and_streams_match_plain(spec_managers):
    """Four rows at once (two streaming, one sampled that rides verify
    turns without drafting): greedy rows equal the plain engine, streams
    concatenate to the final text, and the pool drains."""
    _, spec, plain = spec_managers
    prompts = [PROMPT, "a cat a cat a cat", "the dog and the dog", "describe the image"]
    want = [plain.generate([ChatMessage("user", p)], max_new_tokens=14).tokens for p in prompts]
    got: dict[int, object] = {}
    errors: list[BaseException] = []

    def run(i):
        try:
            msgs = [ChatMessage("user", prompts[i])]
            if i == 1:
                got[i] = list(spec.generate_stream(msgs, max_new_tokens=14))
            elif i == 3:
                got[i] = spec.generate(msgs, max_new_tokens=14, temperature=0.9, do_sample=True)
            else:
                got[i] = spec.generate(msgs, max_new_tokens=14)
        except BaseException as e:  # noqa: BLE001 - surfaced by the asserts below
            errors.append(e)

    turns0 = spec.engine.spec_turns
    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert got[0].tokens == want[0] and got[2].tokens == want[2]
    chunks = got[1]
    assert chunks[-1].is_final and chunks[-1].metadata["generated_tokens"] == len(want[1])
    assert 1 <= len(got[3].tokens) <= 14 and "spec_accept_rate" not in got[3].metadata
    assert spec.engine.spec_turns > turns0
    stats = spec.engine.kv.stats()
    assert stats.pages_live == 0 and stats.allocated_total == stats.freed_total


def test_spec_window_at_a_page_bucket_edge(tmp_path):
    """Rows whose budget (prompt + max_new + 1) is 512 tokens, exactly 32
    pages of 16: their last verify windows reach past the budget. The
    shipped block tables must still address every window position of a
    live row (else the verify program's clamp moves the window onto the
    row's history), and greedy tokens equal the engine without
    speculation."""
    model_dir = make_vlm_model_dir(tmp_path)
    os.remove(os.path.join(model_dir, "tokenizer_config.json"))
    from tokenizers import Tokenizer

    tok = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    state = tm.init_random_(tm.VLMModel(VLMConfig.tiny()), 5).state_dict()
    kw = dict(KW, max_seq=1024, max_new_cap=512, page_size=16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_VLM_SPEC_K", "4")
        mp.setenv("LUMEN_VLM_SPEC_MIN_RATE", "0")
        spec = VLMManager(VLMConfig.tiny(), state, tok, device="cpu", name="edge-spec", **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("LUMEN_VLM_SPEC_K", raising=False)
        plain = VLMManager(VLMConfig.tiny(), state, tok, device="cpu", name="edge-plain", **kw)
    eng = spec.engine
    page = eng.kv.page_size
    verify = eng.gen.verify
    edge_windows, clamped = [], []

    def spy(pool, tables, generator, draft, q_lens, width):
        cap = tables.shape[1] * page
        for row in torch.nonzero(~pool["done"] & (pool["cur_len"] > 0)).flatten().tolist():
            end = int(pool["cur_len"][row]) + width
            if end > 512:
                edge_windows.append(end)
            if end > cap:
                clamped.append((row, end, cap))
        return verify(pool, tables, generator, draft, q_lens, width)

    eng.gen.verify = spy
    try:
        prompts = [PROMPT, "a cat a cat a cat", "the dog and the dog"]
        msgs = [[ChatMessage("user", p)] for p in prompts]
        budgets = [511 - len(spec._encode_prompt(m, False)) for m in msgs]
        want = [plain.generate(m, max_new_tokens=n).tokens for m, n in zip(msgs, budgets)]
        got = [spec.generate(m, max_new_tokens=n).tokens for m, n in zip(msgs, budgets)]
    finally:
        spec.close()
        plain.close()
    assert eng.spec_turns > 0 and edge_windows, "no verify window reached past a 512-token budget"
    assert not clamped, f"verify windows past the shipped tables (row, window end, capacity): {clamped}"
    assert got == want


def test_draft_row_prompt_lookup(spec_managers, monkeypatch):
    """Drafter semantics: earliest n-gram continuation, greedy rows only,
    capped at spec_k tokens (twin of the JAX engine's test)."""
    _, spec, _ = spec_managers
    sched = spec.engine
    monkeypatch.setattr(sched, "spec_k", 4)
    monkeypatch.setattr(sched, "spec_ngram", 3)

    def slot(toks, tokens, pending, sample=False):
        return SimpleNamespace(
            request=SimpleNamespace(do_sample=sample), text_toks=toks, tokens=tokens, pending_tok=pending,
        )

    assert sched._draft_row(slot([5, 7, 8, 9, 7, 8, 9, 7], [8], 9)) == [7, 8, 9, 7]
    assert sched._draft_row(slot([1, 2, 3, 4], [], 5)) == []
    assert sched._draft_row(slot([5, 7, 8, 9, 7, 8], [], 9, sample=True)) == []
    assert sched._draft_row(slot([7, 8, 7, 8], [], None)) == []


def test_spec_auto_disable_below_floor(spec_managers, monkeypatch):
    """Acceptance below LUMEN_VLM_SPEC_MIN_RATE after 64 proposals turns
    drafting off for good; fewer proposals are never enough evidence
    (twin of the JAX engine's test)."""
    _, spec, _ = spec_managers
    sched = spec.engine
    monkeypatch.setattr(sched, "spec_min_rate", 0.2)
    monkeypatch.setattr(sched, "spec_disabled", False)
    monkeypatch.setattr(sched, "spec_proposed", 100)
    monkeypatch.setattr(sched, "spec_accepted", 30)
    sched._spec_try_disable()
    assert not sched.spec_disabled and sched._spec_active()
    monkeypatch.setattr(sched, "spec_accepted", 10)
    sched._spec_try_disable()
    assert sched.spec_disabled and not sched._spec_active()
    monkeypatch.setattr(sched, "spec_disabled", False)
    monkeypatch.setattr(sched, "spec_proposed", 10)
    monkeypatch.setattr(sched, "spec_accepted", 0)
    sched._spec_try_disable()
    assert not sched.spec_disabled


def test_spec_knobs_are_the_jax_engines(monkeypatch):
    """K is clamped to 15 and the n-gram and floor knobs read as in JAX;
    a window wider than a row's remaining table falls back to a block."""
    from lumen_tpu_torch.models.vlm.continuous import ContinuousScheduler, _Slot

    monkeypatch.setenv("LUMEN_VLM_SPEC_K", "99")
    monkeypatch.setenv("LUMEN_VLM_SPEC_NGRAM", "2")
    monkeypatch.setenv("LUMEN_VLM_SPEC_MIN_RATE", "0.5")
    model = tm.init_random_(tm.VLMModel(VLMConfig.tiny()), 0)
    gen = tgen.Generator(model.eval(), VLMConfig.tiny(), 64, cache_dtype=torch.float32)
    sched = ContinuousScheduler(gen, slots=2, block=4, name="knobs", page_size=16)
    try:
        assert (sched.spec_k, sched.spec_ngram, sched.spec_min_rate) == (15, 2, 0.5)
        req = SimpleNamespace(do_sample=False, max_new=8, cancelled=False)
        # Hold the engine's lock: the idle loop thread waits on it and never
        # sees the hand-made row.
        with sched._cond:
            try:
                sched._slots[0] = _Slot(request=req, prompt_len=50, text_toks=[3, 4, 3], tokens=[], pending_tok=4)
                assert sched._spec_plan() == (0, {})  # 50 + 16 > the 64-token row
                sched._slots[0].prompt_len = 10
                width, drafts = sched._spec_plan()
                assert width == 16 and drafts == {0: [3, 4]}
                assert sched._row_need(sched._slots[0], width) == 10 + 8 + 1  # clamped to the budget
            finally:
                sched._slots.clear()
    finally:
        sched.close()
