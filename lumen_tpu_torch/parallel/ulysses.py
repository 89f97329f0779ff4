"""Ulysses-style all-to-all sequence parallelism (twin of
``lumen_tpu/parallel/ulysses.py``).

The second long-context strategy next to :mod:`.ring_attention`: instead
of rotating K/V blocks, swap the sharded dim:

1. Q/K/V arrive sequence-sharded ``[B, H, S/n, D]`` per rank;
2. one all-to-all per tensor over the axis's group swaps the sharded dim
   -- each rank now holds ``[B, H/n, S, D]``: the FULL sequence for a
   subset of heads;
3. ``ops.attention.attention`` runs locally per head group (the flash
   kernel on CUDA tensors, the plain attention on CPU tensors);
4. one all-to-all back returns the sequence-sharded layout.

The exchanges are ``torch.distributed.nn.functional.all_to_all_single``,
which is differentiable; the local attention is differentiable on the
CPU (on the card the flash kernel has no backward and refuses operands
that require grad). Heads must divide by the axis size.
"""

from __future__ import annotations

import torch

from ..ops.attention import attention
from ..runtime.mesh import SEQ_AXIS
from .spmd import all_to_all, axis_group


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, H, s, D] (sequence block) -> [B, H/n, n*s, D] (head group)."""
    b, h, s, d = x.shape
    blocks = x.reshape(b, n, h // n, s, d).permute(1, 0, 2, 3, 4)  # head group j -> rank j
    got = all_to_all(blocks, group)  # [n (source rank = sequence block), B, H/n, s, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, H/n, S, D] -> [B, H, S/n, D]: the inverse exchange."""
    b, hl, s_full, d = x.shape
    s = s_full // n
    blocks = x.reshape(b, hl, n, s, d).permute(2, 0, 1, 3, 4)  # sequence block j -> rank j
    got = all_to_all(blocks, group)  # [n (source rank = head group), B, H/n, s, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * hl, s, d)


def _ulysses_local(q, k, v, group, n: int, causal: bool, scale: float | None) -> torch.Tensor:
    qh, kh, vh = (_seq_to_heads(t, group, n) for t in (q, k, v))
    out = attention(qh.contiguous(), kh.contiguous(), vh.contiguous(), causal=causal, scale=scale)
    return _heads_to_seq(out, group, n)


def ulysses_attention(q, k, v, mesh, causal: bool = False, scale: float | None = None, axis_name: str = SEQ_AXIS):
    """Exact attention with Q/K/V (DTensors on ``mesh``) sequence-sharded
    over ``axis_name``, computed via the all-to-all head/sequence layout
    swap; returns a DTensor placed as ``q``.

    Requires ``S % n == 0`` and ``H % n == 0`` for ``n`` the axis size
    (GQA callers ``repeat_kv`` first so K/V carry as many heads as Q)."""
    from torch.distributed.tensor import DTensor

    group, n, _ = axis_group(mesh, axis_name)
    if q.shape[1] % n:
        raise ValueError(
            f"heads ({q.shape[1]}) must divide by mesh axis {axis_name!r} size {n} "
            "for all-to-all sequence parallelism; use ring_attention otherwise"
        )
    out = _ulysses_local(q.to_local(), k.to_local(), v.to_local(), group, n, causal, scale)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)
