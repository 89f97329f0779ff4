"""What the port's SPMD functions share: the counterparts of the JAX
collectives that ``shard_map`` bodies call (``ppermute`` around a ring,
``psum`` of a replicated result) as autograd functions over a
``torch.distributed`` group, and the axis checks of the public wrappers.

A JAX collective is transposed by autodiff; here each one is an
``autograd.Function`` whose backward is that transpose, and every rank
must reach it in the same order, forward and backward. A shard_map body
that selects with ``jnp.where`` keeps both branches in the graph on every
device; callers here keep that, so no rank skips a backward collective
another rank waits in.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..runtime.mesh import axis_sizes


def axis_group(mesh, axis_name: str):
    """``(group, size, rank in the group)`` of ``axis_name`` on a process
    mesh; a mesh without the axis raises the JAX error."""
    sizes = axis_sizes(mesh)
    if axis_name not in sizes:
        raise ValueError(f"mesh has no axis {axis_name!r}; axes: {tuple(sizes)}")
    group = mesh.get_group(axis_name)
    return group, sizes[axis_name], dist.get_rank(group)


def local_of(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a DTensor (a plain tensor is its own block)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the group rank ``step`` ahead and receive from the one
    ``step`` behind, all ranks at once (``batch_isend_irecv``: a blocking
    send first on every rank would deadlock)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (me + step) % n), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - step) % n), group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """JAX ``ppermute`` with ``[(i, (i + 1) % n)]``: forward sends to
    ``i + 1`` and receives from ``i - 1``; the backward (its transpose)
    sends the gradient to ``i - 1`` and receives from ``i + 1``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    return _RingShift.apply(x, group)


class _SumReplicated(torch.autograd.Function):
    """JAX ``psum`` whose result every rank then holds alike (a
    ``shard_map`` out_spec of ``P()``): forward all-reduces, and the
    backward hands each rank's contribution the replicated cotangent
    unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _SumReplicated.apply(x, group)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 (the autograd semantics of
    ``torch.distributed.nn.functional.all_gather``: the backward SUMS the
    ranks' gradients of the gathered rows and hands each rank its own
    block). Written out because that function's gloo backward addresses a
    subgroup's ranks by their group index as if global, which fails on
    any group but the world."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        rows = grad.shape[0] // dist.get_world_size(ctx.group)
        me = dist.get_rank(ctx.group)
        return grad[me * rows : (me + 1) * rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherRows.apply(x, group)


class _ReplicatedInput(torch.autograd.Function):
    """An input every rank holds alike (a ``shard_map`` in_spec of
    ``P()``) that each rank then uses on its own share of the work: the
    forward passes it through, and the backward sums the ranks'
    gradients, so every rank holds the whole one, as JAX transposes it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def replicated_input(x: torch.Tensor, group) -> torch.Tensor:
    return _ReplicatedInput.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """JAX tiled ``all_to_all`` over dim 0 (``split_axis = concat_axis =
    0``): block ``j`` of ``x`` goes to group rank ``j``, and block ``j`` of
    the result came from rank ``j``. Differentiable (its backward is the
    reverse exchange); a one-rank group exchanges too, so the card runs it
    at world size 1."""
    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()  # (empty_like of a permuted view keeps its strides; the exchange writes densely)
    return all_to_all_single(torch.empty_like(x), x, group=group)
