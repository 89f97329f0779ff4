"""The port's ``Generator`` against the JAX package's, on the CPU at the
tiny configuration in f32: prefill (whole and chunked), admission into
the paged pool and block decode must give the same greedy tokens, and
the same pool state, as the JAX programs on the same weights and pages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.models.vlm import generate as jgen
from lumen_tpu.models.vlm import modeling as jm
from lumen_tpu_torch.models.vlm import generate as tgen
from lumen_tpu_torch.models.vlm import modeling as tm
from lumen_tpu_torch.models.vlm.convert import params_from_jax
from lumen_tpu_torch.models.vlm.paged_kv import PagedKVPool

PAGE, SLOTS, MAX_SEQ, BLOCK = 4, 4, 64, 4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def gens():
    cfg = jm.VLMConfig.tiny()
    jmodel = jm.VLMModel(cfg)
    params = jmodel.init(
        jax.random.PRNGKey(1),
        jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3), jnp.float32),
    )["params"]
    tmodel = tm.VLMModel(tm.VLMConfig.tiny())
    tmodel.load_state_dict(params_from_jax(params))
    jg = jgen.Generator(jmodel, cfg, MAX_SEQ, 16, cache_dtype=jnp.float32)
    tg = tgen.Generator(tmodel.eval(), tm.VLMConfig.tiny(), MAX_SEQ, cache_dtype=torch.float32)
    return params, jmodel, jg, tg


def _prompt(jmodel, params, n, bucket, seed):
    rng = np.random.default_rng(seed)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :n] = rng.integers(3, 240, n)
    embeds = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), method=jm.VLMModel.embed_tokens))
    pos = np.arange(bucket, dtype=np.int32)[None]
    return ids, embeds, pos, np.asarray([n], np.int32)


def test_prefill_and_chunked_prefill_match(gens):
    params, jmodel, jg, tg = gens
    ids, embeds, pos, length = _prompt(jmodel, params, 11, 16, seed=0)
    one = lambda v, dt: jnp.asarray([v], dt)  # noqa: E731
    jc, jtok, jseen = jg._prefill(
        params, jnp.asarray(embeds), jnp.asarray(pos), jnp.asarray(length), jnp.asarray(ids),
        jax.random.PRNGKey(0), one(0.0, jnp.float32), one(1.0, jnp.float32), one(False, bool),
        one(1.2, jnp.float32), kv_len=16,
    )
    gen_params = (torch.tensor([0.0]), torch.tensor([1.0]), torch.tensor([False]), torch.tensor([1.2]))
    tc, ttok, tseen = tg.prefill(
        _t(embeds), _t(pos), _t(length), _t(ids).long(), None, *gen_params, kv_len=16
    )
    assert ttok.tolist() == np.asarray(jtok).tolist()
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
    for jl, tl in zip(jc, tc):
        np.testing.assert_allclose(tl["k"].numpy(), np.asarray(jl["k"]), atol=1e-5, rtol=1e-5)

    # The same prompt through the chunk lane's programs, chunks of 8.
    scratch = tg.new_prefill_cache(16)
    for off in (0, 8):
        logits = tg.prefill_chunk(
            scratch, _t(embeds[:, off : off + 8]), _t(pos[:, off : off + 8]), off,
            torch.tensor([min(11, off + 8)]),
        )
    tok0, seen = tg.chunk_finish(
        logits, torch.tensor([11 - 1 - 8]), _t(ids).long(), _t(length), None, *gen_params
    )
    assert tok0.tolist() == ttok.tolist()
    assert torch.equal(seen, tseen)
    for a, b in zip(scratch, tc):
        torch.testing.assert_close(a["k"][:, :, :11], b["k"][:, :, :11], atol=1e-5, rtol=1e-5)


def test_paged_block_decode_matches(gens):
    """Three rows with different prompts, budgets and penalties (ending
    on budget or EOS mid-block) decode three blocks through one shared
    page pool."""
    params, jmodel, jg, tg = gens
    kv = PagedKVPool(SLOTS * (MAX_SEQ // PAGE) + 1, PAGE, SLOTS, MAX_SEQ // PAGE)
    jpool = jg.init_pool(SLOTS, page_size=PAGE)
    tpool = tg.init_pool(SLOTS, page_size=PAGE)
    rows = {0: (9, 6, 1.0), 2: (14, 12, 1.3), 3: (5, 3, 1.0)}  # slot: (prompt, budget, penalty)
    prompt_len = {}
    for slot, (n, budget, rep) in rows.items():
        ids, embeds, pos, length = _prompt(jmodel, params, n, 16, seed=slot + 10)
        f = lambda v, dt: jnp.asarray([v], dt)  # noqa: E731
        jc, jtok, jseen = jg._prefill(
            params, jnp.asarray(embeds), jnp.asarray(pos), jnp.asarray(length), jnp.asarray(ids),
            jax.random.PRNGKey(0), f(0.0, jnp.float32), f(1.0, jnp.float32), f(False, bool),
            f(rep, jnp.float32), kv_len=16,
        )
        tc, ttok, tseen = tg.prefill(
            _t(embeds), _t(pos), _t(length), _t(ids).long(), None,
            torch.tensor([0.0]), torch.tensor([1.0]), torch.tensor([False]), torch.tensor([rep]),
            kv_len=16,
        )
        assert ttok.tolist() == np.asarray(jtok).tolist()
        bt_row = kv.admit(slot, n)
        jpool = jg._admit(
            jpool, slot, jc, jtok, jseen, jnp.asarray(length), jnp.asarray(bt_row),
            budget, 0.0, 1.0, False, rep,
        )
        tg.admit(tpool, slot, tc, ttok, tseen, n, bt_row, budget, 0.0, 1.0, False, rep)
        prompt_len[slot] = n
    emitted = {s: 0 for s in rows}
    for _ in range(3):
        for slot in rows:
            kv.grow(slot, prompt_len[slot] + emitted[slot] + BLOCK)
        tables = kv.block_tables.copy()
        jpool, _, jtoks = jg._step_block(params, jpool, jnp.asarray(tables), jax.random.PRNGKey(0), block=BLOCK)
        ttoks = tg.step_block(tpool, _t(tables), None, block=BLOCK)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        for name in ("n_gen", "done", "eos", "cur_len", "cur_tok"):
            np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]), err_msg=name)
        for slot in rows:
            emitted[slot] = int(tpool["n_gen"][slot])
    for slot, (_, budget, _) in rows.items():  # every row ended: budget or EOS
        assert bool(tpool["done"][slot]) and 1 <= int(tpool["n_gen"][slot]) <= budget
    assert int(tpool["n_gen"][0]) == 6 and int(tpool["n_gen"][3]) == 3
    assert bool(tpool["done"][1])  # never-admitted slot stays free
    for jl, tl in zip(jpool["caches"], tpool["caches"]):
        for name in ("k", "v"):
            live = np.unique(kv.block_tables[[0, 2, 3]])
            live = live[live > 0]
            np.testing.assert_allclose(
                tl[name][live].numpy(), np.asarray(jl[name])[live], atol=1e-5, rtol=1e-5
            )
