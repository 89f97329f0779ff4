"""Ring attention: exact attention over sequences sharded across a mesh
axis (twin of ``lumen_tpu/parallel/ring_attention.py``).

Each rank holds a sequence block of Q/K/V; K/V blocks rotate around the
ring of the axis's process group (``ring_shift``: ``batch_isend_irecv``
to the next rank) while a blockwise online-softmax accumulator keeps the
math exact -- memory per rank is O(seq / n). The rotation after the last
block is skipped. Differentiable: the rotation's backward sends the
gradient the other way round the ring (the JAX transpose of
``ppermute``).

Layout: ``[batch, heads, seq_block, head_dim]`` per rank; the public
wrapper takes DTensors ``[B, H, S, D]`` sharded over the axis on dim 2.
"""

from __future__ import annotations

import math

import torch

from ..runtime.mesh import SEQ_AXIS
from .spmd import axis_group, ring_shift

NEG_INF = -1e30


def _ring_attention_local(q, k, v, group, n: int, my_idx: int, causal: bool, scale: float | None) -> torch.Tensor:
    b, h, sq, d = q.shape
    sk = k.shape[2]
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * sm_scale
    q_pos = my_idx * sq + torch.arange(sq, device=q.device)  # global positions of local queries

    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        # After i rotations we hold the block originally on rank (my - i) mod n.
        src = (my_idx - i) % n
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float())
        if causal:
            k_pos = src * sk + torch.arange(sk, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk.float())
        m = m_new
        if i < n - 1:  # the last step's rotation would be discarded
            k_blk, v_blk = ring_shift(k_blk, group), ring_shift(v_blk, group)
    # Fully-masked rows (causal with padding) have l = 0; emit zeros.
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, causal: bool = False, scale: float | None = None, axis_name: str = SEQ_AXIS):
    """Exact attention with Q/K/V (DTensors on ``mesh``) sequence-sharded
    over ``axis_name``; returns a DTensor placed as ``q``.

    Requires ``S % mesh axis size == 0`` (pad upstream). Batch and head
    dims may be split over other axes of the mesh."""
    from torch.distributed.tensor import DTensor

    group, n, my_idx = axis_group(mesh, axis_name)
    out = _ring_attention_local(q.to_local(), k.to_local(), v.to_local(), group, n, my_idx, causal, scale)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)
