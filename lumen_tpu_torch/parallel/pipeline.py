"""Pipeline parallelism: a GPipe-style microbatch schedule over a
``stage`` mesh axis (twin of ``lumen_tpu/parallel/pipeline.py``).

The JAX module traces ONE ``shard_map`` program; here every rank of the
axis's process group runs the same schedule on its stage:

1. the layer stack's parameters carry a leading ``[n_stages, ...]`` dim
   sharded over ``stage`` (DTensors, ``Shard(0)``) -- each rank holds only
   its stage's weights;
2. ``n_micro + n_stages - 1`` ticks; every tick each stage applies its
   layers to its current activation and hands the result to the next
   stage (``ring_shift``);
3. stage 0 injects a fresh microbatch each tick (zeros on the drain
   ticks); the last stage's outputs are summed to every rank.

Differentiable: the handoff's backward runs the ring the other way and
the final sum hands each rank the replicated cotangent, so autograd
through :func:`pipeline_apply` is the reverse pipeline, as ``jax.grad``
makes it. Stage selection is a ``torch.where`` on every rank, as the JAX
body's ``jnp.where``, so every rank reaches every handoff's backward.

Bubble fraction is ``(n_stages-1)/(n_micro+n_stages-1)``; pick ``n_micro
>= 4*n_stages`` to amortize.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..runtime.mesh import STAGE_AXIS
from .spmd import axis_group, local_of, replicated_input, ring_shift, sum_replicated


def stack_stage_params(per_stage_params: list) -> dict:
    """Stack one ``{name: tensor}`` dict per stage into one whose tensors
    carry a leading ``[n_stages, ...]`` dim (place it with
    :func:`stage_sharding`)."""
    return {k: torch.stack([p[k] for p in per_stage_params]) for k in per_stage_params[0]}


def stage_sharding(mesh, axis_name: str = STAGE_AXIS) -> list:
    """DTensor placements for stacked stage params: the leading dim over
    ``axis_name``, replicated over the mesh's other axes."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis_name else Replicate() for name in mesh.mesh_dim_names]


def _stage_slice(t: torch.Tensor, stage: int) -> torch.Tensor:
    """This rank's stage of a stacked tensor: the local block of a DTensor
    sharded over the axis, or row ``stage`` of a full tensor."""
    from torch.distributed.tensor import DTensor

    return t.to_local()[0] if isinstance(t, DTensor) else t[stage]


def _pipeline_local(params: dict, microbatches: torch.Tensor, *, stage_fn: Callable, group, n_stages: int,
                    stage: int) -> torch.Tensor:
    """Per-rank body: ``params`` leaves are this stage's slice;
    ``microbatches`` is the full ``[n_micro, mb, ...]`` (replicated)."""
    n_micro = microbatches.shape[0]
    first = torch.tensor(stage == 0, device=microbatches.device)
    carry = torch.zeros_like(microbatches[0])
    zero = torch.zeros_like(microbatches[0])
    ys = []
    for t in range(n_micro + n_stages - 1):
        # Stage 0 consumes the injected microbatch; later stages consume
        # whatever the previous stage handed them last tick.
        mb_in = microbatches[t] if t < n_micro else zero
        y = stage_fn(params, torch.where(first, mb_in, carry))
        ys.append(y)
        if t < n_micro + n_stages - 2:  # the last tick's handoff has no reader
            carry = ring_shift(y, group)
    # Microbatch m leaves the last stage at tick m + n_stages - 1.
    outs = torch.stack(ys[n_stages - 1 : n_stages - 1 + n_micro])
    last = torch.tensor(stage == n_stages - 1, device=outs.device)
    outs = torch.where(last, outs, torch.zeros_like(outs))
    return sum_replicated(outs, group)


def pipeline_apply(stage_fn: Callable, stacked_params: dict, x: torch.Tensor, mesh, n_microbatches: int,
                   axis_name: str = STAGE_AXIS) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` pipelined applications of ``stage_fn``.

    - ``stage_fn(params, mb) -> mb_out`` applies ONE stage's layers to one
      microbatch; input and output have the same shape and dtype.
    - ``stacked_params``: ``{name: DTensor}`` with leading ``[n_stages,
      ...]`` dims sharded over ``axis_name`` (:func:`stack_stage_params`,
      :func:`stage_sharding`).
    - ``x``: the global batch ``[B, ...]``, the same on every rank (a
      plain tensor or a replicated DTensor), ``B % n_microbatches == 0``.

    Returns the plain ``[B, ...]`` result, the same on every rank."""
    group, n_stages, stage = axis_group(mesh, axis_name)
    x = local_of(x)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by n_microbatches {n_microbatches}")
    n_leading = {t.shape[0] for t in stacked_params.values()}
    if n_leading != {n_stages}:
        raise ValueError(
            f"stacked params leading dims {n_leading} != n_stages {n_stages}; "
            "build them with stack_stage_params (one entry per stage)"
        )
    params = {k: _stage_slice(t, stage) for k, t in stacked_params.items()}
    x = replicated_input(x, group)  # stage 0 reads it
    mbs = x.reshape((n_microbatches, b // n_microbatches) + tuple(x.shape[1:]))
    out = _pipeline_local(params, mbs, stage_fn=stage_fn, group=group, n_stages=n_stages, stage=stage)
    return out.reshape((b,) + tuple(out.shape[2:]))
