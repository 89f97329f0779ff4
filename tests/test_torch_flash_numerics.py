"""Numerics of the bf16 tensor-core flash tile (``csrc/flash_tile_bf16.cuh``),
emulated in plain PyTorch on the CPU and held against the JAX package.

The tile cannot run here (a CUDA kernel has no interpret mode), but its
rounding can be repeated exactly in kind: fp32 scores of bf16 Q and K,
scaled in fp32 by ``scale * log2(e)``; an online softmax over 64-key tiles
with ``exp2``, the tiles dealt alternately to two parts that are merged at
the end (the tile's key split); the unnormalised P rounded to bf16 before
``P @ V``; an fp32 accumulator; one division by ``max(l, 1e-20)`` and one
bf16 rounding of the output. Only the order of the fp32 sums differs from
the card.

Held against the JAX ``attention_reference`` / ``_decode_masked`` run in
fp32 on the same bf16 values, within ``chip_smoke.py``'s tolerance
``1e-2 + 1e-2 * |ref|`` -- at the serving path's shapes (the vision
tower's [1,12,256,64]; a caption prompt's two chunks against the 832-slot
scratch) and the edge cases of the 64-key tile that ``chip_smoke.py``
checks on the card, at head_dim 64 and at the OCR recognizer's 16. This
shows on the CPU that the design fits the tolerance before the card is
asked.
"""

from __future__ import annotations

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jatt = importlib.import_module("lumen_tpu.ops.attention")

ATOL = RTOL = 1e-2  # chip_smoke.ATOL / RTOL
NEG_INF = -1e30
TILE = 64  # flash_tile_bf16.cuh: kFlashMmaKeys
SPLIT = 2  # flash_tile_bf16.cuh: kFlashSplit, warps sharing a row group's key tiles


def tile_emulation(q, k, v, q_offsets, kv_valid, causal: bool, scale: float | None = None):
    """The bf16 tile's arithmetic on fp32 tensors holding bf16 values:
    ``q`` [B,H,Sq,D], ``k``/``v`` [B,H,Sk,D]; sample b's query i sees key
    j iff j < min(kv_valid[b], Sk) and (not causal or j <= q_offsets[b] + i).
    Key tile t goes to part t % SPLIT, each part keeps its own online
    softmax, and the parts are merged in order at the end."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    sl2 = torch.tensor(np.float32(scale) * np.float32(math.log2(math.e)))
    out = torch.empty(b, h, sq, d, dtype=torch.bfloat16)
    rows = torch.arange(sq)
    for bi in range(b):
        lim = min(int(kv_valid[bi]), sk)
        kend = min(lim, int(q_offsets[bi]) + sq) if causal else lim
        parts = [[torch.full((h, sq), NEG_INF), torch.zeros(h, sq), torch.zeros(h, sq, d)] for _ in range(SPLIT)]
        for t, kb in enumerate(range(0, kend, TILE)):
            part = parts[t % SPLIT]
            m, l, acc = part
            keys = torch.arange(kb, kb + TILE)
            kt = torch.zeros(h, TILE, d)
            vt = torch.zeros(h, TILE, d)
            n = min(kb + TILE, kend) - kb  # rows at or past kend are zero-filled
            kt[:, :n], vt[:, :n] = k[bi, :, kb:kb + n], v[bi, :, kb:kb + n]
            s = torch.matmul(q[bi], kt.transpose(-1, -2)) * sl2
            live = (keys < lim)[None, :].expand(sq, TILE)
            if causal:
                live = live & (keys[None, :] <= int(q_offsets[bi]) + rows[:, None])
            s = torch.where(live, s, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            part[:] = m_new, alpha * l + p.sum(-1), alpha[..., None] * acc + torch.matmul(p.bfloat16().float(), vt)
        m, l, acc = parts[0]
        for mp, lp, accp in parts[1:]:
            m_new = torch.maximum(m, mp)
            a, c = torch.exp2(m - m_new), torch.exp2(mp - m_new)
            m, l, acc = m_new, l * a + lp * c, acc * a[..., None] + accp * c[..., None]
        out[bi] = (acc / l.clamp_min(1e-20)[..., None]).bfloat16()
    return out


def _bf16_values(rng, *shape):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.bfloat16().float()


def _hold(got, want):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    worst = float((diff - (ATOL + RTOL * np.abs(want))).max())
    assert worst <= 0, f"max |diff| {diff.max():.3e} is outside 1e-2 + 1e-2|ref| by {worst:.3e}"


# flash_attention: (b, h, sq, sk, causal, head_dim) -- the vision tower, a
# non-causal length off the 64-key tile, and the causal cases of
# chip_smoke.py (square, and sk > sq with the sk - sq diagonal offset);
# at head_dim 16 (one k16 step of Q K^T, two n8 output tiles) the native
# OCR recognizer's 240-token bucket, a length off the tile, and a causal
# case.
FLASH_CASES = {
    "vision [1,12,256,64]": (1, 12, 256, 256, False, 64),
    "non-causal sk=100": (1, 12, 100, 100, False, 64),
    "causal 77": (2, 14, 77, 77, True, 64),
    "causal 50 vs 130": (1, 14, 50, 130, True, 64),
    "svtr [2,4,240,16]": (2, 4, 240, 240, False, 16),
    "d16 sk=100": (1, 4, 100, 100, False, 16),
    "d16 causal 77": (1, 4, 77, 77, True, 16),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_tile_numerics(case):
    b, h, sq, sk, causal, d = FLASH_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _bf16_values(rng, b, h, sq, d), _bf16_values(rng, b, h, sk, d), _bf16_values(rng, b, h, sk, d)
    got = tile_emulation(q, k, v, [sk - sq] * b, [sk] * b, causal)
    want = jatt.attention_reference(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), causal=causal)
    _hold(got, want)


# flash_attention_cache against the 832-slot scratch: (sq, q_offsets,
# kv_valid) -- a caption prompt's two chunks, kv_valid on either side of
# the 64-key tile, a diagonal crossing a tile mid-warp, and two-row
# batches with different offsets.
CACHE_CASES = {
    "chunk 1": (256, [0], [256]),
    "chunk 2": (63, [256], [265]),
    "kv_valid 63": (48, [15], [63]),
    "kv_valid 64": (48, [16], [64]),
    "kv_valid 65": (48, [17], [65]),
    "kv_valid 127": (48, [79], [127]),
    "diagonal mid-tile": (64, [100], [164]),
    "two rows 256": (256, [0, 256], [256, 300]),
    "two rows 63": (63, [256, 37], [265, 100]),
}


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_flash_cache_tile_numerics(case):
    sq, offs, valid = CACHE_CASES[case]
    b = len(offs)
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _bf16_values(rng, b, 14, sq, 64), _bf16_values(rng, b, 14, 832, 64), _bf16_values(rng, b, 14, 832, 64)
    got = tile_emulation(q, k, v, offs, valid, causal=True)
    want = jatt._decode_masked(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(offs, jnp.int32), jnp.asarray(valid, jnp.int32), None,
    )
    _hold(got, want)


def test_emulation_rounds_p():
    """The emulation is not the reference under another name: rounding P
    to bf16 moves the output off the fp32 reference rounded once (by less
    than half the tolerance), so the tests above do measure the tile's
    rounding."""
    rng = np.random.default_rng(0)
    q, k, v = (_bf16_values(rng, 1, 2, 128, 64) for _ in range(3))
    got = tile_emulation(q, k, v, [0], [128], causal=False).float()
    want = torch.from_numpy(np.array(jatt.attention_reference(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))))
    exact = want.bfloat16().float()  # the reference rounded once, as the tile's output is
    assert not torch.equal(got, exact)
    assert float((got - want).abs().max()) < 0.5 * ATOL
