"""Parity of the PyTorch port's VLM model with the JAX package's, on the
CPU at the tiny configuration, in f32.

Both models hold the same weights: the JAX package's Flax init, carried
over by ``params_from_jax``. Tolerances: atol 1e-5 / rtol 1e-5 for single
ops, atol 1e-4 for whole-model logits (a few layers of f32 summation in
another order).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.models.vlm import modeling as jm
from lumen_tpu_torch.models.vlm import modeling as tm
from lumen_tpu_torch.models.vlm.convert import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    jcfg = jm.VLMConfig.tiny()
    jmodel = jm.VLMModel(jcfg)
    params = jmodel.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, jcfg.vision.image_size, jcfg.vision.image_size, 3), jnp.float32),
    )["params"]
    tcfg = tm.VLMConfig.tiny()
    tmodel = tm.VLMModel(tcfg)
    tmodel.load_state_dict(params_from_jax(params), strict=True)
    return jcfg, jmodel, params, tcfg, tmodel.eval()


def test_tiny_config_matches_jax():
    assert dataclasses.asdict(tm.VLMConfig.tiny())["decoder"].items() <= dataclasses.asdict(
        jm.VLMConfig.tiny()
    )["decoder"].items()
    assert dataclasses.asdict(tm.VLMConfig.tiny())["vision"] == dataclasses.asdict(jm.VLMConfig.tiny())["vision"]
    assert tm.VLMConfig().decoder.dim_per_head == 64 and tm.VLMConfig().vision.num_tokens == 256


def test_from_hf_dense_and_moe_refused():
    hf = {"text_config": {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
                          "num_key_value_heads": 2, "vocab_size": 500},
          "vision_config": {"image_size": 64, "patch_size": 16}, "image_token_index": 7}
    t, j = tm.VLMConfig.from_hf(hf), jm.VLMConfig.from_hf(hf)
    assert (t.decoder.hidden_size, t.decoder.layers, t.decoder.kv_heads, t.image_token_id) == (
        j.decoder.hidden_size, j.decoder.layers, j.decoder.kv_heads, j.image_token_id)
    with pytest.raises(NotImplementedError):
        tm.VLMConfig.from_hf({"text_config": {"num_experts": 4}})


def test_rope_rotate():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    want = jm.rope_rotate(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tm.rope_rotate(_t(x), _t(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    want = jm.RMSNorm(1e-6).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = tm.RMSNorm(16, 1e-6)
    norm.weight.data = _t(scale)
    np.testing.assert_allclose(norm(_t(x)).detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("image_at", [0, 3, None])
def test_merge_image_embeddings(image_at):
    rng = np.random.default_rng(2)
    b, s, v, h = 2, 7, 4, 8
    text = rng.standard_normal((b, s, h)).astype(np.float32)
    vis = rng.standard_normal((b, v, h)).astype(np.float32)
    ids = rng.integers(10, 20, (b, s)).astype(np.int32)
    if image_at is not None:
        ids[0, image_at] = 99
        ids[1, s - 1 - image_at] = 99
    lengths = np.asarray([s, s - 2], np.int32)
    want = jm.merge_image_embeddings(
        jnp.asarray(text), jnp.asarray(vis), jnp.asarray(ids), 99, jnp.asarray(lengths)
    )
    got = tm.merge_image_embeddings(_t(text), _t(vis), _t(ids).long(), 99, _t(lengths))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_params_from_jax_covers_every_parameter(pair):
    _, _, params, tcfg, tmodel = pair
    sd = params_from_jax(params)
    assert set(sd) == set(tmodel.state_dict())
    # Dense kernels are transposed to nn.Linear's [out, in].
    q = params["decoder"]["layers_0"]["attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(sd["decoder.layers.0.attn.q_proj.weight"].numpy(), np.asarray(q).T)


@pytest.mark.parametrize("with_image", [True, False])
def test_logits_match(pair, with_image):
    jcfg, jmodel, params, tcfg, tmodel = pair
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 200, (2, 9)).astype(np.int32)
    pixels = None
    if with_image:
        ids[:, 2] = jcfg.image_token_id
        pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jmodel.apply(
        {"params": params}, jnp.asarray(ids), None if pixels is None else jnp.asarray(pixels)
    )
    with torch.no_grad():
        got = tmodel(_t(ids).long(), None if pixels is None else _t(pixels))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_cached_prefill_then_paged_decode_match(pair):
    """Contiguous-cache prefill, then one paged decode step, against the
    JAX model's decode / decode_paged on the same pages."""
    jcfg, jmodel, params, tcfg, tmodel = pair
    rng = np.random.default_rng(4)
    b, s, page, pages, maxp = 2, 6, 4, 9, 4
    ids = rng.integers(3, 200, (b, s)).astype(np.int32)
    lengths = np.asarray([6, 4], np.int32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    embeds = jmodel.apply({"params": params}, jnp.asarray(ids), method=jm.VLMModel.embed_tokens)
    jcache = jm.init_kv_cache(jcfg, b, 8, jnp.float32)
    jlog, jcache = jmodel.apply(
        {"params": params}, embeds, jnp.asarray(pos), jcache, jnp.zeros((), jnp.int32),
        jnp.asarray(lengths), method=jm.VLMModel.decode,
    )
    tcache = tm.init_kv_cache(tcfg, b, 8, torch.float32)
    with torch.no_grad():
        tlog, tcache = tmodel.decode(_t(np.asarray(embeds)), _t(pos), tcache, 0, _t(lengths))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    for jl, tl in zip(jcache, tcache):
        np.testing.assert_allclose(tl["k"].numpy(), np.asarray(jl["k"]), **TOL)

    # One decode token per row through the paged pool.
    kp = rng.standard_normal((pages, jcfg.decoder.kv_heads, page, 8)).astype(np.float32)
    vp = rng.standard_normal((pages, jcfg.decoder.kv_heads, page, 8)).astype(np.float32)
    bt = np.asarray([[3, 5, 0, 0], [1, 7, 2, 0]], np.int32)
    off = np.asarray([5, 9], np.int32)
    tok = rng.integers(3, 200, (b, 1)).astype(np.int32)
    emb = jmodel.apply({"params": params}, jnp.asarray(tok), method=jm.VLMModel.embed_tokens)
    jpool = [{"k": jnp.asarray(kp), "v": jnp.asarray(vp)} for _ in range(jcfg.decoder.layers)]
    jlog2, jpool = jmodel.apply(
        {"params": params}, emb, jnp.asarray(off[:, None]), jpool, jnp.asarray(bt),
        jnp.asarray(off), jnp.asarray(off + 1), method=jm.VLMModel.decode_paged,
    )
    tpool = [{"k": _t(kp).clone(), "v": _t(vp).clone()} for _ in range(tcfg.decoder.layers)]
    with torch.no_grad():
        tlog2, tpool = tmodel.decode_paged(
            _t(np.asarray(emb)), _t(off[:, None]), tpool, _t(bt), _t(off), _t(off + 1)
        )
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), atol=1e-4, rtol=1e-4)
    for jl, tl in zip(jpool, tpool):  # the pool was written in place
        np.testing.assert_allclose(tl["k"].numpy(), np.asarray(jl["k"]), **TOL)
        np.testing.assert_allclose(tl["v"].numpy(), np.asarray(jl["v"]), **TOL)


def test_init_random_is_seeded():
    cfg = tm.VLMConfig.tiny()
    a, b = tm.init_random_(tm.VLMModel(cfg), 7), tm.init_random_(tm.VLMModel(cfg), 7)
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    assert torch.equal(a.decoder.final_norm.weight, torch.ones(cfg.decoder.hidden_size))
    c = tm.init_random_(tm.VLMModel(cfg), 8)
    assert not torch.equal(a.decoder.embed_tokens.weight, c.decoder.embed_tokens.weight)
