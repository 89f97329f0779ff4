"""Numerics of the split paged walk (``csrc/paged_walk.cuh``), emulated in
plain PyTorch on the CPU and held against the JAX package.

The kernel cannot run here (a CUDA kernel has no interpret mode), but its
algorithm can be repeated in kind: a slot's live keys cut into spans of
``kPagedSpan`` absolute key positions (read from the ``.cuh``); per span,
fp32 scores of the GQA group's heads, the span's max ``m``, ``p = exp(s -
m)``, its sum ``l`` and ``acc = p @ V``; a slot with one live span divides
directly, otherwise the partials are merged in span order by the online
softmax's update (rescaled to the running max); one rounding of the
output to the storage dtype. Only the
order of the fp32 sums inside a span differs from the card.

Held against the JAX ``paged_attention_reference`` /
``paged_attention_varq_reference`` in fp32 on the same bf16 values, within
``chip_smoke.py``'s tolerance ``1e-2 + 1e-2 * |ref|``, at 14/2 heads and
head_dim 64 (Qwen2-0.5B), pages of 16: lengths 1, span - 1, span, span + 1,
500 and 2048, tables padded with the dump page 0, and verify windows of 5
and 16 slots that cross a span edge. The determinism rule the greedy
identity of speculation leans on is shown here on the emulation: a
query's output bits do not change with the block-table width (``maxp`` 32
vs 128) or the window (W = 1 vs W = 5).
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
SPAN = tatt.paged_walk_constants()["span"]  # kPagedSpan of csrc/paged_walk.cuh
H, KVH, D, PAGE = 14, 2, 64, 16


def split_walk_emulation(q, k_pages, v_pages, block_tables, kv_lens, out_dtype=torch.bfloat16):
    """The split walk's arithmetic on fp32 tensors holding bf16 values: ``q``
    [B, W, H, D] (slot t of row b sees ``kv_lens[b] + t`` keys), pages [P,
    KVH, page, D], ``block_tables`` [B, MAXP]. Returns [B, W, H, D] in
    ``out_dtype``."""
    b, w, h, d = q.shape
    _, kvh, page, _ = k_pages.shape
    maxp = block_tables.shape[1]
    group = h // kvh
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    out = torch.empty(b, w, h, d, dtype=out_dtype)
    for bi in range(b):
        for t in range(w):
            n_len = min(int(kv_lens[bi]) + t, maxp * page)
            pos = torch.arange(n_len)
            pids = block_tables[bi, pos // page].long()
            for kh in range(kvh):
                keys = k_pages[pids, kh, pos % page]  # [len, D]; nothing past len is read
                vals = v_pages[pids, kh, pos % page]
                qg = q[bi, t, kh * group:(kh + 1) * group]  # [group, D]
                parts = []
                for start in range(0, n_len, SPAN):
                    ks, vs = keys[start:start + SPAN], vals[start:start + SPAN]
                    s = torch.matmul(qg, ks.T) * scale
                    m = s.amax(-1)
                    p = torch.exp(s - m[:, None])
                    parts.append((m, p.sum(-1), torch.matmul(p, vs)))
                mx, l, a = parts[0]
                for ms, ls, acc in parts[1:]:  # span order, the online update
                    mn = torch.maximum(mx, ms)
                    c_run, c_span = torch.exp(mx - mn), torch.exp(ms - mn)
                    l = ls * c_span + l * c_run
                    a = acc * c_span[:, None] + a * c_run[:, None]
                    mx = mn
                o = a / l[:, None]
                out[bi, t, kh * group:(kh + 1) * group] = o.to(out_dtype)
    return out


def _bf16_values(rng, *shape):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.bfloat16().float()


def _case(lens, maxp, seed, reach=0):
    """Pages for ``lens`` rows in a pool of ``len(lens) * maxp + 1`` pages,
    each row on its own shuffled pages; every other row's table padded
    with the dump page 0 past the pages its keys (and ``reach`` more
    window positions) occupy."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    pool = b * maxp + 1
    kp, vp = _bf16_values(rng, pool, KVH, PAGE, D), _bf16_values(rng, pool, KVH, PAGE, D)
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
    """The span is a compile-time count of key positions (4 pages of 16
    at the serving page size), not derived from maxp, the batch or W."""
    text = (tatt.CSRC / "paged_walk.cuh").read_text()
    assert f"constexpr int kPagedSpan = {SPAN};" in text
    assert SPAN % PAGE == 0
    assert tatt.paged_grid(16, 32, PAGE) == (32 * PAGE // SPAN, 16)
    assert tatt.paged_workspace_bytes(16, 32, PAGE, D) == 16 * (32 * PAGE // SPAN) * 8 * (D + 2) * 4


def test_decode_lengths_against_jax():
    """One decode token per row at lengths 1, span - 1, span, span + 1, 500
    and 2048 (maxp 128), tables padded with the dump page."""
    rng, kp, vp, bt, kl = _case(LENGTHS, 128, seed=11)
    q = _bf16_values(rng, len(LENGTHS), H, D)
    got = split_walk_emulation(q[:, None], kp, vp, bt, kl)[:, 0]
    _hold(got, _jax(jatt.paged_attention_reference, q, kp, vp, bt, kl))


@pytest.mark.parametrize("window", [5, 16])
def test_verify_windows_cross_a_span_edge(window):
    """Verify windows whose slots cross the edges at span and 2 * span
    (and a page edge), against the JAX window reference."""
    lens = [SPAN - 2, 2 * SPAN - 3, 1, 500 - window + 1, SPAN - window + 2]
    maxp = 40
    rng, kp, vp, bt, kl = _case(lens, maxp, seed=window, reach=window - 1)
    q = _bf16_values(rng, len(lens), window, H, D)
    got = split_walk_emulation(q, kp, vp, bt, kl)
    _hold(got, _jax(jatt.paged_attention_varq_reference, q, kp, vp, bt, kl))


def test_bits_do_not_depend_on_the_table_width():
    """A row's output is the same bits with its table padded to 32 pages
    and to 128 (a decode step's bucket vs a verify turn's)."""
    lens = [1, SPAN - 1, SPAN, SPAN + 1, 333, 500]
    rng, kp, vp, bt32, kl = _case(lens, 32, seed=3)
    q = _bf16_values(rng, len(lens), 1, H, D)
    bt128 = torch.zeros((len(lens), 128), dtype=torch.int32)  # dump page past the first 32
    bt128[:, :32] = bt32
    narrow = split_walk_emulation(q, kp, vp, bt32, kl)
    wide = split_walk_emulation(q, kp, vp, bt128, kl)
    assert torch.equal(narrow, wide)


def test_bits_do_not_depend_on_the_window():
    """Slot t of a W = 5 window is the single-token walk at length
    kv_lens + t, bit for bit (W = 1 is the decode kernel)."""
    lens = [SPAN - 3, 2 * SPAN - 2, 7, 500]
    rng, kp, vp, bt, kl = _case(lens, 40, seed=8, reach=4)
    q = _bf16_values(rng, len(lens), 5, H, D)
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
    q = _bf16_values(rng, len(lens), H, D)
    got = split_walk_emulation(q[:, None], kp, vp, bt, kl, out_dtype=torch.float32)[:, 0]
    plain = tatt.paged_attention_reference(q, kp, vp, bt, kl)
    assert not torch.equal(got, plain)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
    _hold(got, _jax(jatt.paged_attention_reference, q, kp, vp, bt, kl))
