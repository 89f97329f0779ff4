"""Numerics of the bf16 tensor-core flash kernels, emulated in plain
PyTorch on the CPU and held against the JAX package.

A CUDA kernel has no interpret mode, but its rounding can be repeated
exactly in kind: fp32 scores of bf16 Q and K; an online softmax with
``exp2`` over key tiles; the unnormalised P rounded to bf16 before ``P @
V``; an fp32 accumulator; one division by ``max(l, 1e-20)`` and one bf16
rounding of the output. Only the order of the fp32 sums differs from the
card. Two tiles are emulated:

- ``flash_attention``'s (``csrc/flash_plan_bf16.cuh``), following the plan
  the kernel takes for the shape (``ops.attention.flash_plan``): the short
  path's whole-sequence steps or the long path's ring tiles and key split,
  the score tiles a warp computes (none past its keys, in pairs at
  head_dim 16), the max taken on unscaled scores with the scale folded
  into one FMA where no mask is needed, and the row sums of the bf16 P as
  the tensor cores take them;
- ``flash_attention_cache``'s (``csrc/flash_tile_bf16.cuh``, unchanged):
  64-key tiles dealt alternately to two parts merged at the end, scores
  scaled before the max, the row sums of the fp32 P.

Held against the JAX ``attention_reference`` / ``_decode_masked`` run in
fp32 on the same bf16 values, within ``chip_smoke.py``'s tolerance
``1e-2 + 1e-2 * |ref|`` -- at the kernel table's shapes (small batches of
them) and the edge cases ``chip_smoke.py`` checks on the card. This shows
on the CPU that a design fits the tolerance before the card is asked.
"""

from __future__ import annotations

import importlib
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu_torch.ops import attention as A

jatt = importlib.import_module("lumen_tpu.ops.attention")

ATOL = RTOL = 1e-2  # chip_smoke.ATOL / RTOL
NEG_INF = -1e30
TILE = 64  # flash_tile_bf16.cuh: kFlashMmaKeys (the cache kernel's tile)
SPLIT = 2  # flash_tile_bf16.cuh: kFlashSplit, warps sharing a row group's key tiles
#: the H100's shared memory: an SM's, what the runtime reserves a block,
#: and the most one block may opt into
SM_SMEM_BYTES, SMEM_RESERVED_BYTES, BLOCK_SMEM_MAX = 233_472, 1024, 232_448


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round float64 values to float32 once (an FMA's single rounding)."""
    return x.to(torch.float32)


def plan_emulation(q, k, v, causal: bool, scale: float | None = None):
    """``flash_attention``'s bf16 kernel on fp32 tensors holding bf16
    values (``q`` [B,H,Sq,D], ``k``/``v`` [B,H,Sk,D]), following the plan
    of the shape: row group g (16 rows) computes the key tiles below its
    ``kend_w`` -- tile t (``plan["keys"]`` keys) in key part t % split, a
    part's state merged in part order at the end -- and within a tile
    only the score tiles (8 keys) below ``kend_w``, in pairs at head_dim
    16. A tile crossing a bound for some row of the group scales, masks
    and then takes the max; one that does not takes the max of the
    unscaled scores and folds the scale into one FMA."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    plan = A.flash_plan(sq, sk, d, causal)
    bk, split, nt = plan["keys"], plan["split"], plan["keys"] // 8
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    sl2 = torch.tensor(np.float32(scale) * np.float32(math.log2(math.e)))
    q_off = sk - sq
    rows = torch.arange(sq)
    w0 = rows // 16 * 16  # each row's group's first row
    kend_w = torch.full((sq,), sk) if not causal else torch.clamp(q_off + w0 + 16, max=sk)
    kend_w = torch.clamp(kend_w, min=0)
    diag0 = q_off + w0
    out = torch.empty(b, h, sq, d, dtype=torch.bfloat16)
    for bi in range(b):
        parts = [[torch.full((h, sq), NEG_INF), torch.zeros(h, sq), torch.zeros(h, sq, d)] for _ in range(split)]
        for t in range(-(-sk // bk)):
            kb = t * bk
            active = kb < kend_w  # [Sq]: rows whose group computes this tile
            if not bool(active.any()):
                continue
            m, l, acc = parts[t % split]
            ncomp = torch.clamp((kend_w - kb + 7) // 8, max=nt)
            if d == 16:
                ncomp = (ncomp + 1) // 2 * 2
            kc = kb + 8 * ncomp  # [Sq]: first key not computed
            mask = (kc > sk) | ((kc - 1 > diag0) if causal else torch.zeros(sq, dtype=torch.bool))
            keys = torch.arange(kb, kb + bk)
            computed = keys[None, :] < kc[:, None]  # [Sq, BK]
            kt = torch.zeros(h, bk, d)
            vt = torch.zeros(h, bk, d)
            n = min(kb + bk, sk) - kb
            kt[:, :n], vt[:, :n] = k[bi, :, kb:kb + n], v[bi, :, kb:kb + n]
            s = torch.matmul(q[bi], kt.transpose(-1, -2))  # [H, Sq, BK] fp32
            live = (keys[None, :] < sk) & ((keys[None, :] <= rows[:, None] + q_off) if causal else True)
            # fold: max of the unscaled scores, x = fma(s, sl2, -m)
            mx_u = torch.where(computed, s, torch.tensor(NEG_INF)).amax(-1)
            m_fold = torch.maximum(m, mx_u * sl2)
            x_fold = _f32(s.double() * sl2.double() - m_fold[..., None].double())
            # mask: scale, mask, max, x = s - m
            s_sc = torch.where(live, s * sl2, torch.tensor(NEG_INF))
            m_mask = torch.maximum(m, torch.where(computed, s_sc, torch.tensor(NEG_INF)).amax(-1))
            x_mask = s_sc - m_mask[..., None]
            m_new = torch.where(mask, m_mask, m_fold)
            x = torch.where(mask[:, None], x_mask, x_fold)
            p = torch.where(computed, torch.exp2(x), torch.zeros(()))
            pb = p.bfloat16().float()
            alpha = torch.exp2(m - m_new)
            sel = active[None, :]
            part = [torch.where(sel, m_new, m), torch.where(sel, l * alpha + pb.sum(-1), l),
                    torch.where(sel[..., None], alpha[..., None] * acc + torch.matmul(pb, vt), acc)]
            parts[t % split] = part
        m, l, acc = parts[0]
        for mp, lp, accp in parts[1:]:
            m_new = torch.maximum(m, mp)
            a, c = torch.exp2(m - m_new), torch.exp2(mp - m_new)
            m, l, acc = m_new, l * a + lp * c, acc * a[..., None] + accp * c[..., None]
        out[bi] = (acc / l.clamp_min(1e-20)[..., None]).bfloat16()
    return out


def tile_emulation(q, k, v, q_offsets, kv_valid, causal: bool, scale: float | None = None):
    """The cache kernel's bf16 tile (``flash_tile_bf16.cuh``) on fp32
    tensors holding bf16 values:
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
# case; then small batches of the kernel table's six shapes (the short
# path's CLIP towers, the long path's VLM tower, head_dim-128 causal
# forward and SVTR buckets), the short path past 128 query rows and at
# head_dim 128, and a causal head_dim-16 call over several row blocks.
FLASH_CASES = {
    "vision [1,12,256,64]": (1, 12, 256, 256, False, 64),
    "non-causal sk=100": (1, 12, 100, 100, False, 64),
    "causal 77": (2, 14, 77, 77, True, 64),
    "causal 50 vs 130": (1, 14, 50, 130, True, 64),
    "svtr [2,4,240,16]": (2, 4, 240, 240, False, 16),
    "d16 sk=100": (1, 4, 100, 100, False, 16),
    "d16 causal 77": (1, 4, 77, 77, True, 16),
    "clip vision [2,2,50,64]": (2, 2, 50, 50, False, 64),
    "clip text [2,2,77,64] causal": (2, 2, 77, 77, True, 64),
    "hd128 [1,2,265,128] causal": (1, 2, 265, 265, True, 128),
    "vlm vision [1,2,256,64]": (1, 2, 256, 256, False, 64),
    "svtr [1,2,240,16]": (1, 2, 240, 240, False, 16),
    "svtr [1,1,1920,16]": (1, 1, 1920, 1920, False, 16),
    "short path sq 200 vs sk 64": (1, 2, 200, 64, False, 64),
    "hd128 short [1,2,77,128]": (1, 2, 77, 77, False, 128),
    "d16 causal [1,2,300,16]": (1, 2, 300, 300, True, 16),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_tile_numerics(case):
    b, h, sq, sk, causal, d = FLASH_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _bf16_values(rng, b, h, sq, d), _bf16_values(rng, b, h, sk, d), _bf16_values(rng, b, h, sk, d)
    got = plan_emulation(q, k, v, causal)
    want = jatt.attention_reference(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), causal=causal)
    _hold(got, want)


def test_plan_emulation_differs_from_the_cache_tile():
    """The two emulations are not one: the plan's row sums of bf16 P and
    its scale folded into the exponent move the output off the cache
    tile's, so each test above measures its own kernel's rounding."""
    rng = np.random.default_rng(1)
    q, k, v = (_bf16_values(rng, 1, 2, 240, 16) for _ in range(3))
    assert not torch.equal(plan_emulation(q, k, v, False), tile_emulation(q, k, v, [0], [240], causal=False))


# (sq, sk, head_dim, causal): the kernel table's six shapes, the short
# path at its edges (sk 128 and 129, 200 query rows, 300 rows against
# 16 keys), sq != sk causal, head_dim 16 causal.
PLAN_SHAPES = [
    (50, 50, 64, False), (77, 77, 64, True), (265, 265, 128, True), (256, 256, 64, False),
    (960, 960, 16, False), (1920, 1920, 16, False), (128, 128, 64, False), (129, 129, 64, True),
    (200, 64, 64, False), (50, 130, 64, True), (77, 77, 128, False), (1, 1, 16, False), (16, 300, 128, True),
    (300, 16, 128, False), (960, 960, 16, True),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s[:3])) + ("c" if s[3] else ""))
def test_flash_plan_invariants(shape):
    sq, sk, d, causal = shape
    # batch * heads is no input of the plan (so a row's bits do not depend
    # on the batch; chip_smoke.py holds one image alone and in a batch of
    # 64 bitwise equal on the card)
    assert list(inspect.signature(A.flash_plan).parameters) == ["sq", "sk", "head_dim", "causal"]
    plan = A.flash_plan(sq, sk, d, causal)
    # every query row in exactly one row group of one block
    covered = torch.zeros(sq, dtype=torch.int32)
    for rb in range(plan["row_blocks"]):
        covered[rb * plan["rows"]:(rb + 1) * plan["rows"]] += 1
    assert bool((covered == 1).all())
    assert plan["threads"] == 32 * plan["rows"] // 16 * plan["split"] <= 1024
    assert plan["smem"] <= BLOCK_SMEM_MAX
    assert plan["path"] == ("short" if sk <= 128 else "long")
    if plan["path"] == "short":
        # K and V of every key, once, and the block's Q rows
        assert plan["smem"] == (2 * (-(-sk // 16) * 16) + plan["rows"]) * (d + 8) * 2 and plan["split"] == 1
    assert plan["heaviest_first"] == int(causal and plan["row_blocks"] > 1)


@pytest.mark.parametrize("shape", [(64, 12, 50, False), (64, 8, 77, True)], ids=["clip vision", "clip text"])
def test_clip_plans_keep_four_blocks_an_sm(shape):
    """At the CLIP towers' bulk batches the short path's shared memory
    leaves room for at least 4 blocks on an SM (registers permitting:
    ``chip_smoke.py`` prints the occupancy calculator's count), so the 768
    / 512 (b, h) fit in about one wave."""
    b, h, s, causal = shape
    plan = A.flash_plan(s, s, 64, causal)
    assert plan["path"] == "short" and plan["row_blocks"] == 1
    assert SM_SMEM_BYTES // (plan["smem"] + SMEM_RESERVED_BYTES) >= 4


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
