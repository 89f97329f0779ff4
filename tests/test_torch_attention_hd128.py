"""The head_dim-128 attention of the Qwen2-MoE decoder (Qwen1.5-MoE-A2.7B
widths: 16 heads, 16 KV heads of 128), on the CPU.

The port's plain versions -- what each kernel wrapper runs on CPU tensors,
and what ``chip_smoke.py`` holds the ``<128>`` CUDA instances to on the
card -- against the JAX ``*_reference`` functions on the same numpy
inputs (the JAX Pallas kernels are held to those references in their own
tests, in interpret mode, so they are not run again here). fp32,
atol/rtol 1e-5. Then the wrappers' head_dim gates: 128 is taken, 32 and
80 are refused before any kernel is touched.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu_torch.ops import attention as tatt

jatt = importlib.import_module("lumen_tpu.ops.attention")

TOL = dict(atol=1e-5, rtol=1e-5)
D = 128


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("b,h,sq,sk,causal", [(1, 16, 265, 265, True), (2, 4, 77, 77, False), (1, 2, 50, 130, True)])
def test_flash_reference_matches_jax(b, h, sq, sk, causal):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, h, sq, D), (b, h, sk, D), (b, h, sk, D)))
    want = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tatt.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "b,sq,sk,offs,valid",
    [
        (1, 256, 832, [0], [256]),  # a caption prompt's first chunk against the 832-slot scratch
        (1, 9, 832, [256], [265]),  # its second chunk
        (2, 63, 320, [256, 37], [265, 100]),  # two rows, different offsets
    ],
)
def test_cache_reference_matches_jax(b, sq, sk, offs, valid):
    rng = np.random.default_rng(sq)
    h = 16
    q = rng.standard_normal((b, h, sq, D)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, D)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, D)).astype(np.float32)
    qo, kv = np.array(offs, np.int32), np.array(valid, np.int32)
    want = jatt._decode_masked(*(jnp.asarray(x) for x in (q, k, v, qo, kv)), None)
    got = tatt.flash_attention_cache(_t(q), _t(k), _t(v), _t(qo), _t(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_case(b, w, h, kvh, page, maxp, seed):
    rng = np.random.default_rng(seed)
    n_pages = maxp * b + 1
    q = rng.standard_normal((b, w, h, D) if w else (b, h, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, kvh, page, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, kvh, page, D)).astype(np.float32)
    bt = rng.integers(1, n_pages, size=(b, maxp)).astype(np.int32)
    kl = rng.integers(1, maxp * page - max(w, 1) + 2, size=(b,)).astype(np.int32)
    for r in range(b):
        bt[r, -(-(kl[r] + max(w, 1) - 1) // page):] = 0
    return q, kp, vp, bt, kl


@pytest.mark.parametrize("b,h,kvh,page,maxp", [(8, 16, 16, 16, 32), (3, 4, 2, 4, 9)])
def test_paged_reference_matches_jax(b, h, kvh, page, maxp):
    q, kp, vp, bt, kl = _paged_case(b, 0, h, kvh, page, maxp, seed=b + h)
    want = jatt.paged_attention_reference(*(jnp.asarray(x) for x in (q, kp, vp, bt, kl)))
    got = tatt.paged_attention_kernel(_t(q), _t(kp), _t(vp), _t(bt), _t(kl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(tatt.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(kl)), got)


@pytest.mark.parametrize("b,w,h,kvh,page,maxp", [(8, 5, 16, 16, 16, 34), (2, 3, 4, 2, 4, 7)])
def test_varq_reference_matches_jax(b, w, h, kvh, page, maxp):
    q, kp, vp, bt, kl = _paged_case(b, w, h, kvh, page, maxp, seed=b * 7 + w)
    want = jatt.paged_attention_varq_reference(*(jnp.asarray(x) for x in (q, kp, vp, bt, kl)))
    got = tatt.paged_attention_varq_kernel(_t(q), _t(kp), _t(vp), _t(bt), _t(kl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_head_dim_gates():
    """The card's wrappers take head_dim 128 and refuse 32 and 80 with a
    ValueError before touching a kernel (meta tensors: no device, no
    build; a CPU tensor would run the plain version instead)."""
    assert 128 in tatt.FLASH_HEAD_DIMS and tatt.DECODER_HEAD_DIMS == (64, 128)
    for d in (32, 80):
        q = torch.empty((1, 2, 8, d), device="meta")
        with pytest.raises(ValueError, match="head_dim"):
            tatt.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="head_dim"):
            tatt.flash_attention_cache(q, q, q, torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32))
        pages = torch.empty((4, 2, 16, d), device="meta")
        with pytest.raises(ValueError, match="head_dim"):
            tatt.paged_attention_kernel(torch.empty((1, 2, d), device="meta"), pages, pages,
                                        torch.ones((1, 2), dtype=torch.int32), torch.ones(1, dtype=torch.int32))
