"""Tensor and expert parallelism for serving: a rank's place on a
``model`` and an ``expert`` axis, and the collectives a Megatron-split
forward and an expert-split MoE layer insert themselves (no autograd).

One process drives one device, and each rank holds plain local tensors:
the slice that :func:`~lumen_tpu_torch.parallel.sharding.local_state_dict`
takes from a ``state_dict`` by the TP rules. A module built with a
:class:`TensorParallel` holds its share of the heads and of the MLP width
and calls, after each row-parallel projection (``out_proj``/``o_proj``,
``fc2``/``down_proj``), :meth:`TensorParallel.sum`, and after a lookup in a
width-split table, :meth:`TensorParallel.gather`. The data plane is
``broadcast`` and ``all_reduce`` only, the two collectives
``torch.distributed``'s backend table lists for gloo on CUDA tensors as well
as for NCCL.

Attention splits by whole heads (:meth:`TensorParallel.attn_plan`): a rank
holds ``heads / size`` query heads and the KV heads they read. Where
``kv_heads`` is smaller than the axis, each rank keeps the one KV head its
query heads use (Megatron's rule); where the heads do not divide, the whole
attention block replicates and no sum follows it.

On an ``expert`` axis (:class:`ExpertParallel`) a rank holds ``E / size``
experts of every MoE bank and the whole router; the tokens are the same on
every rank, so each routes them all, runs its own experts and adds the
routed rows over the axis (``parallel.moe``). A group of ``expert x
model`` ranks sums each ``model`` split over the ranks that share an
expert place and each expert split over the ranks that share a model
place. A collective of an axis of size 1 is the identity. Over a ``data``
axis of a group each data place has its own ``TensorParallel`` and
``ExpertParallel`` (``runtime.tp_group.GroupPlace``): the same rank and
sizes, and the place's own subgroups, bound to the place's device under
NCCL; a rank's shards are the same at every place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class AttnPlan:
    """One rank's heads of an attention block: query heads ``[q_lo, q_lo +
    q_heads)``, KV heads ``[kv_lo, kv_lo + kv_heads)``, and whether this
    rank is the first holder of its KV heads (``kv_owner``: the rank that
    contributes them when a row's pages are gathered across the axis)."""

    q_lo: int
    q_heads: int
    kv_lo: int
    kv_heads: int
    kv_owner: bool
    split: bool


class _Axis:
    """A rank's place on one axis of a serving group: ``size`` ranks, this
    one ``rank``, the data-plane ``group`` of the ranks along the axis
    (None: the default group)."""

    axis = ""

    def __init__(self, size: int, rank: int, group=None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a {self.axis} axis of {size}")
        self.size, self.rank, self.group = size, rank, group

    def __repr__(self) -> str:
        return f"{type(self).__name__}(rank {self.rank} of {self.size})"

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' partials, taken in fp32 and rounded to
        ``x.dtype`` once; every rank gets the same bits. A contiguous fp32
        ``x`` is summed in place."""
        if self.size == 1:
            return x
        y = x.float().contiguous()
        dist.all_reduce(y, group=self.group)
        return y.to(x.dtype)


class TensorParallel(_Axis):
    """This rank's place on a serving mesh's ``model`` axis: ``size``
    ranks, this one ``rank``, the data-plane ``group`` (None: the default
    group). ``runtime`` is the rank-0/worker runtime that dispatches the
    rank's programs (``runtime.tp_group.TPGroup``), or None. At ``size``
    1 nothing splits and no collective runs."""

    axis = "model"

    def __init__(self, size: int, rank: int, group=None, runtime=None):
        super().__init__(size, rank, group)
        self.runtime = runtime

    # -- the split plan (shared by the module shapes and local_state_dict) ---

    def split(self, n: int, unit: int = 1) -> slice | None:
        """This rank's ``[lo, hi)`` of a dimension of ``n`` elements split
        in whole ``unit``s, or None when the units do not divide (the
        dimension replicates)."""
        if unit <= 0 or n % unit or (n // unit) % self.size:
            return None
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def attn_plan(self, heads: int, kv_heads: int) -> AttnPlan:
        """The heads of an attention block with ``heads`` query and
        ``kv_heads`` KV heads (module docstring)."""
        if self.size == 1 or heads % self.size or not (kv_heads % self.size == 0 or self.size % kv_heads == 0):
            return AttnPlan(0, heads, 0, kv_heads, self.rank == 0, False)
        hl = heads // self.size
        if kv_heads % self.size == 0:
            kl = kv_heads // self.size
            return AttnPlan(self.rank * hl, hl, self.rank * kl, kl, True, True)
        per_kv = self.size // kv_heads
        return AttnPlan(self.rank * hl, hl, self.rank // per_kv, 1, self.rank % per_kv == 0, True)

    # -- the collectives -------------------------------------------------------

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks (a row's ``|x|.max()``
        from each rank's columns)."""
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def gather(self, x: torch.Tensor, width: int, dim: int = -1) -> torch.Tensor:
        """The full ``width`` of dimension ``dim`` from each rank's
        contiguous slice of it, built from an ``all_reduce`` of zero-padded
        slices in fp32 (exact: every element is one rank's value plus
        zeros, and bf16 and fp16 values are fp32 values). A
        tensor already ``width`` wide is returned as it is (its table
        replicated)."""
        n = x.shape[dim]
        if n == width:
            return x
        if n * self.size != width:
            raise ValueError(f"gather: a slice of {n} on {self.size} ranks is not {width} wide")
        shape = list(x.shape)
        shape[dim] = width
        out = x.new_zeros(shape, dtype=torch.float32)
        out.narrow(dim, self.rank * n, n).copy_(x)
        dist.all_reduce(out, group=self.group)
        return out.to(x.dtype)

    def gather_heads(self, x: torch.Tensor, plan: AttnPlan, kv_heads: int, dim: int = 1) -> torch.Tensor:
        """Every KV head of a paged or contiguous KV tensor whose dimension
        ``dim`` holds this rank's ``plan`` heads: each head comes from its
        owner rank (ranks that share a KV head, or a replicated block, add
        it once). The sum runs over this axis's group: in an ``expert x
        model`` group the ranks of one expert place hold every head once
        between them, and each expert place gathers its own. A tensor that
        already holds every head is returned as it is."""
        if x.shape[dim] == kv_heads:
            return x
        shape = list(x.shape)
        shape[dim] = kv_heads
        out = x.new_zeros(shape, dtype=torch.float32)
        if plan.kv_owner:
            out.narrow(dim, plan.kv_lo, plan.kv_heads).copy_(x)
        dist.all_reduce(out, group=self.group)
        return out.to(x.dtype)


class ExpertParallel(_Axis):
    """This rank's place on a serving mesh's ``expert`` axis: ``size``
    ranks, this one ``rank``, the data-plane ``group`` of the ranks that
    share its ``model`` place (None: the default group). The rank holds
    the experts :meth:`experts` names of every MoE bank; :meth:`sum` adds
    the routed rows over the axis."""

    axis = "expert"

    def experts(self, n: int) -> slice:
        """This rank's ``[lo, lo + n / size)`` of ``n`` experts."""
        if n % self.size:
            raise ValueError(f"{n} experts do not split over an expert axis of {self.size}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def row_parallel(linear, x: torch.Tensor, tp: "TensorParallel | None", split: bool) -> torch.Tensor:
    """A row-parallel projection (``nn.Linear`` or ``QDense``) on this
    rank's input columns: the partial product, the sum over the axis, then
    the bias once. Unsplit (or without ``tp``) it is the plain call."""
    if tp is None or not split:
        return linear(x)
    if isinstance(linear, torch.nn.Linear):
        y = torch.nn.functional.linear(x, linear.weight)
    elif linear.kernel_mode == "dynamic":
        # W8A8 quantizes each token with its whole row's |x|.max().
        y = linear.project(x, amax=tp.max(x.abs().amax(dim=-1, keepdim=True).float()))
    else:
        y = linear.project(x)
    y = tp.sum(y)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)
