"""Numerics of the paged walk (``csrc/paged_walk.cuh``), emulated in plain
PyTorch on the CPU and held against the JAX package.

The kernel cannot run here (a CUDA kernel has no interpret mode), but its
algorithm can be repeated in kind, block by block as the plan
(``ops.attention.paged_plan``, the twin of the C plan) cuts a call: a
(row, KV-head set, slot group) holds every query row of its KV heads and
window slots; its span of ``span`` absolute key positions is copied once
(keys up to the group's longest slot); each row's keys at or past its own
slot length ``kv_lens + t`` are masked; per span and row, fp32 scores
(four chains over d mod 4, then (c0 + c1) + (c2 + c3)), the span's max
``m``, ``p = exp(s - m)``, its sum ``l`` and ``acc = p @ V`` with the keys
in order (``p`` rounded to bf16 first on the tensor-core path: bf16 at a
GQA group of two or more); a row with one live span divides directly,
otherwise its spans are merged in span order, each rescaled to the row's
largest span max; one rounding of the output to the storage dtype. Every
operation is elementwise over the block's rows, so a row's result cannot
depend on its neighbours here; that it does not on the card is checked
there (``chip_smoke.py`` phase 2, bitwise).

Held against the JAX ``paged_attention_reference`` /
``paged_attention_varq_reference`` in fp32 on the same bf16 values, within
``chip_smoke.py``'s tolerance ``1e-2 + 1e-2 * |ref|``, at 14/2 heads and
head_dim 64 (Qwen2-0.5B) and 16/16 heads and head_dim 128 (Qwen1.5-MoE-
A2.7B), pages of 16: lengths 1, span - 1, span, span + 1, 500 and 2048,
tables padded with the dump page 0, verify windows of 5 and 16 slots that
cross span and page edges, and the fp32 instances. The emulation's own
bits do not change with the block-table width (``maxp`` 32 vs 128) or the
window (slot t of W = 5 is the single-token walk at ``kv_lens + t``): the
per-slot masks and live-span counts are right. And the plan's invariants:
a function of (group, head_dim, window, dtype), no padding row at a group
of one, the W = 5 window in one slot group, one partial per query row and
span of the table.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu_torch.ops import attention as tatt

jatt = importlib.import_module("lumen_tpu.ops.attention")

ATOL = RTOL = 1e-2  # chip_smoke.ATOL / RTOL
H, KVH, D, PAGE = 14, 2, 64, 16  # Qwen2-0.5B
SPAN = tatt.paged_plan(H // KVH, D, 1, torch.bfloat16)["span"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_walk_emulation(q, k_pages, v_pages, block_tables, kv_lens, out_dtype=torch.bfloat16):
    """The walk's arithmetic on fp32 tensors holding ``out_dtype`` values,
    block by block as the plan cuts the call: ``q`` [B, W, H, D] (slot t
    of row b sees ``kv_lens[b] + t`` keys), pages [P, KVH, page, D],
    ``block_tables`` [B, MAXP]. Returns [B, W, H, D] in ``out_dtype``."""
    b, w, h, d = q.shape
    _, kvh, page, _ = k_pages.shape
    maxp = block_tables.shape[1]
    group = h // kvh
    plan = tatt.paged_plan(group, d, w, out_dtype)
    span, kh_blk, slots_blk = plan["span"], plan["kv_heads"], plan["slots"]
    cap = maxp * page
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    out = torch.empty(b, w, h, d, dtype=out_dtype)
    for bi in range(b):
        for kv0 in range(0, kvh, kh_blk):
            heads = range(kv0, min(kvh, kv0 + kh_blk))
            for t0 in range(0, w, slots_blk):
                slots = range(t0, min(w, t0 + slots_blk))
                rows = [(kh, t, gi) for kh in heads for t in slots for gi in range(group)]
                qr = torch.stack([q[bi, t, kh * group + gi] for kh, t, gi in rows])  # [R, D]
                khr = torch.tensor([kh - kv0 for kh, _, _ in rows])
                lens = torch.tensor([min(int(kv_lens[bi]) + t, cap) for _, t, _ in rows])
                len_hi = min(int(kv_lens[bi]) + slots[-1], cap)  # the keys the block copies
                parts = []
                for start in range(0, len_hi, span):
                    pos = torch.arange(start, start + span)
                    copied = pos < len_hi
                    pids = block_tables[bi, torch.clamp(pos // page, max=maxp - 1)].long()
                    blk = torch.tensor(list(heads))
                    kb = k_pages[pids[:, None], blk[None, :], (pos % page)[:, None]]  # [S, KH, D]
                    vb = v_pages[pids[:, None], blk[None, :], (pos % page)[:, None]]
                    kb = torch.where(copied[:, None, None], kb, 0.0).transpose(0, 1)[khr]  # [R, S, D]
                    vb = torch.where(copied[:, None, None], vb, 0.0).transpose(0, 1)[khr]
                    prod = qr[:, None, :] * kb  # exact for bf16 values, as the FMA's product
                    c = torch.zeros(len(rows), span, 4)
                    for i in range(d // 4):  # four chains over d mod 4, d in order
                        c = c + prod[..., 4 * i:4 * i + 4]
                    dot = (c[..., 0] + c[..., 1]) + (c[..., 2] + c[..., 3])
                    n_row = torch.clamp(lens - start, max=span)  # the row's live keys in this span
                    s = torch.where(torch.arange(span)[None, :] < n_row[:, None], dot * scale,
                                    torch.tensor(-1e30))
                    m = s.amax(-1)
                    p = torch.exp(s - m[:, None])
                    l = p.sum(-1)
                    if plan["mma"]:
                        p = p.bfloat16().float()  # P's A fragments
                    acc = torch.zeros(len(rows), d)
                    for j in range(span):  # keys in order
                        acc = acc + p[:, j:j + 1] * vb[:, j]
                    parts.append((m, l, acc, n_row > 0))
                nl = (lens + span - 1) // span
                for r, (kh, t, gi) in enumerate(rows):
                    live = [(mm[r], ll[r], aa[r]) for mm, ll, aa, ok in parts[: int(nl[r])]]
                    assert all(ok[r] for _, _, _, ok in parts[: int(nl[r])])
                    if len(live) == 1:
                        o = live[0][2] / live[0][1]
                    else:  # span order, each rescaled to the row's largest span max
                        mx = max(mm for mm, _, _ in live)
                        lsum, a = torch.tensor(0.0), torch.zeros(d)
                        for mm, ll, aa in live:
                            f = torch.exp(mm - mx)
                            lsum = lsum + ll * f
                            a = a + aa * f
                        o = a / lsum
                    out[bi, t, kh * group + gi] = o.to(out_dtype)
    return out


def _values(rng, *shape, dtype=torch.bfloat16):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(dtype).float()


def _case(lens, maxp, seed, reach=0, kvh=KVH, d=D, dtype=torch.bfloat16):
    """Pages for ``lens`` rows in a pool of ``len(lens) * maxp + 1`` pages,
    each row on its own shuffled pages; every other row's table padded
    with the dump page 0 past the pages its keys (and ``reach`` more
    window positions) occupy."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    pool = b * maxp + 1
    kp, vp = _values(rng, pool, kvh, PAGE, d, dtype=dtype), _values(rng, pool, kvh, PAGE, d, dtype=dtype)
    bt = (rng.permutation(pool - 1)[: b * maxp].reshape(b, maxp) + 1).astype(np.int32)
    for r, n in enumerate(lens):
        if r % 2:
            bt[r, -(-(n + reach) // PAGE):] = 0
    return rng, kp, vp, torch.from_numpy(bt), torch.tensor(lens, dtype=torch.int32)


def _hold(got, want):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    worst = float((diff - (ATOL + RTOL * np.abs(want))).max())
    assert worst <= 0, f"max |diff| {diff.max():.3e} is outside 1e-2 + 1e-2|ref| by {worst:.3e}"


def _jax(fn, *args):
    return fn(*(jnp.asarray(a.numpy()) for a in args))


LENGTHS = [1, SPAN - 1, SPAN, SPAN + 1, 500, 2048]


def test_span_is_a_fixed_count_of_key_positions():
    """The span is a compile-time count of key positions of the instance
    (4 pages of 16 at the serving page size), not derived from maxp, the
    batch or W; the grid covers the table's key positions in spans, and
    the workspace is one partial (acc, m, l) per query row and span."""
    text = (tatt.CSRC / "paged_walk.cuh").read_text()
    assert f"struct PagedShape<__nv_bfloat16, {D}> {{\n  static constexpr int kSpan = {SPAN}," in text
    assert SPAN % PAGE == 0
    for w in (1, 5, 16):
        assert tatt.paged_plan(H // KVH, D, w, torch.bfloat16)["span"] == SPAN
    plan = tatt.paged_plan(H // KVH, D, 1, torch.bfloat16)
    size = tatt.paged_launch(plan, 8, 1, H, KVH, 32, PAGE, D)
    assert size["grid"] == (8 * KVH, 32 * PAGE // SPAN)
    assert size["workspace"] == 8 * H * (32 * PAGE // SPAN) * (D + 2) * 4


def test_decode_lengths_against_jax():
    """One decode token per row at lengths 1, span - 1, span, span + 1, 500
    and 2048 (maxp 128), tables padded with the dump page."""
    rng, kp, vp, bt, kl = _case(LENGTHS, 128, seed=11)
    q = _values(rng, len(LENGTHS), H, D)
    got = split_walk_emulation(q[:, None], kp, vp, bt, kl)[:, 0]
    _hold(got, _jax(jatt.paged_attention_reference, q, kp, vp, bt, kl))


@pytest.mark.parametrize("window", [5, 16])
def test_verify_windows_cross_a_span_edge(window):
    """Verify windows whose slots cross the edges at span and 2 * span
    (and a page edge), against the JAX window reference."""
    lens = [SPAN - 2, 2 * SPAN - 3, 1, 500 - window + 1, SPAN - window + 2]
    maxp = 40
    rng, kp, vp, bt, kl = _case(lens, maxp, seed=window, reach=window - 1)
    q = _values(rng, len(lens), window, H, D)
    got = split_walk_emulation(q, kp, vp, bt, kl)
    _hold(got, _jax(jatt.paged_attention_varq_reference, q, kp, vp, bt, kl))


def test_bits_do_not_depend_on_the_table_width():
    """A row's output is the same bits with its table padded to 32 pages
    and to 128 (a decode step's bucket vs a verify turn's)."""
    lens = [1, SPAN - 1, SPAN, SPAN + 1, 333, 500]
    rng, kp, vp, bt32, kl = _case(lens, 32, seed=3)
    q = _values(rng, len(lens), 1, H, D)
    bt128 = torch.zeros((len(lens), 128), dtype=torch.int32)  # dump page past the first 32
    bt128[:, :32] = bt32
    narrow = split_walk_emulation(q, kp, vp, bt32, kl)
    wide = split_walk_emulation(q, kp, vp, bt128, kl)
    assert torch.equal(narrow, wide)


def test_bits_do_not_depend_on_the_window():
    """Slot t of a W = 5 window -- computed in one block with the other
    four slots, over keys copied up to the window's longest slot -- is
    the single-token walk at length kv_lens + t, bit for bit (W = 1 is
    the decode kernel): each slot's mask and live-span count are its own."""
    lens = [SPAN - 3, 2 * SPAN - 2, 7, 500]
    rng, kp, vp, bt, kl = _case(lens, 40, seed=8, reach=4)
    q = _values(rng, len(lens), 5, H, D)
    window = split_walk_emulation(q, kp, vp, bt, kl)
    for t in range(5):
        single = split_walk_emulation(q[:, t:t + 1], kp, vp, bt, kl + t)
        assert torch.equal(window[:, t:t + 1], single), t


def test_fp32_instance_splits_too():
    """The fp32 instance runs the same split and merge: with no final
    rounding the merged output is close to the plain one-pass softmax but
    not its bits, so the emulation does measure the split."""
    lens = [3 * SPAN + 5, 2048]
    rng, kp, vp, bt, kl = _case(lens, 128, seed=21)
    q = _values(rng, len(lens), H, D)
    got = split_walk_emulation(q[:, None], kp, vp, bt, kl, out_dtype=torch.float32)[:, 0]
    plain = tatt.paged_attention_reference(q, kp, vp, bt, kl)
    assert not torch.equal(got, plain)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
    _hold(got, _jax(jatt.paged_attention_reference, q, kp, vp, bt, kl))


#: (heads, kv_heads, head_dim, dtype, lengths, window, maxp): the
#: Qwen1.5-MoE-A2.7B decoder's 16/16 heads of 128 (bf16: the FMA path, two
#: KV heads a block) at the decode lengths and windows crossing span and
#: page edges, and the fp32 instances of both decoders (FMA path).
WALKS = {
    "hd128 decode": (16, 16, 128, torch.bfloat16, LENGTHS, 0, 128),
    "hd128 verify W=5": (16, 16, 128, torch.bfloat16, [SPAN - 2, 2 * SPAN - 3, 1, 496, SPAN - 3], 5, 40),
    "hd128 verify W=16": (16, 16, 128, torch.bfloat16, [SPAN - 2, 1, 485, SPAN - 14], 16, 40),
    "hd128 fp32 decode": (16, 16, 128, torch.float32, [1, SPAN + 1, 500], 0, 40),
    "hd64 fp32 verify W=5": (H, KVH, D, torch.float32, [SPAN - 2, 1, 496], 5, 40),
}


@pytest.mark.parametrize("case", list(WALKS))
def test_walk_against_jax(case):
    """The walk at the Qwen2-MoE decoder's widths and in fp32, against the
    JAX references (the decode reference for W = 0, the window reference
    otherwise)."""
    h, kvh, d, dtype, lens, window, maxp = WALKS[case]
    rng, kp, vp, bt, kl = _case(lens, maxp, seed=sum(lens) + window, reach=max(window - 1, 0), kvh=kvh, d=d,
                                dtype=dtype)
    q = _values(rng, len(lens), max(window, 1), h, d, dtype=dtype)
    got = split_walk_emulation(q, kp, vp, bt, kl, out_dtype=dtype)
    if window:
        _hold(got, _jax(jatt.paged_attention_varq_reference, q, kp, vp, bt, kl))
    else:
        _hold(got[:, 0], _jax(jatt.paged_attention_reference, q[:, 0], kp, vp, bt, kl))


#: (group, head_dim, window, dtype) of every paged call the decoders make,
#: the engine's widest window, and fp32 instances
PLANS = [
    (7, 64, 1, torch.bfloat16), (7, 64, 5, torch.bfloat16), (7, 64, 16, torch.bfloat16),
    (1, 128, 1, torch.bfloat16), (1, 128, 5, torch.bfloat16), (1, 128, 16, torch.bfloat16),
    (7, 64, 5, torch.float32), (2, 128, 16, torch.float32),
]


@pytest.mark.parametrize("group,head_dim,window,dtype", PLANS)
def test_plan_invariants(group, head_dim, window, dtype):
    """The plan packs real query rows (KV heads x slots x group; at a group
    of one no row is padding, and the bf16 GQA group takes the tensor
    cores), takes the W = 5 window in one slot group (K/V copied once),
    splits the window into equal slot groups that cover it, fits the
    card's shared memory, and -- with it the grid and the workspace -- does
    not change with the batch, maxp or the lengths: the workspace is one
    partial (acc, m, l) per query row and span of the table."""
    plan = tatt.paged_plan(group, head_dim, window, dtype)
    assert plan == tatt.paged_plan(group, head_dim, window, dtype)
    assert plan["rows"] == plan["kv_heads"] * plan["slots"] * group
    assert plan["mma"] == int(dtype == torch.bfloat16 and group >= 2)
    if plan["mma"]:
        assert plan["kv_heads"] == 1  # a 16-row tile holds rows of one KV head
    if group == 1:
        assert plan["kv_heads"] > 1 or dtype == torch.float32
    assert plan["slot_groups"] * plan["slots"] >= window > (plan["slot_groups"] - 1) * plan["slots"]
    if window <= 5:
        assert plan["slot_groups"] == 1
    assert 128 <= plan["threads"] <= 256 and plan["threads"] % 32 == 0
    assert plan["smem"] <= 227 * 1024
    kv_heads = 16 if group == 1 else 2
    heads = kv_heads * group
    for batch, maxp in ((1, 32), (8, 32), (8, 128), (64, 34)):
        size = tatt.paged_launch(plan, batch, window, heads, kv_heads, maxp, PAGE, head_dim)
        spans = _cdiv(maxp * PAGE, plan["span"])
        assert size["grid"] == (batch * _cdiv(kv_heads, plan["kv_heads"]) * plan["slot_groups"], spans)
        assert size["counters"] == size["grid"][0]
        assert size["workspace"] == batch * window * heads * spans * (head_dim + 2) * 4
