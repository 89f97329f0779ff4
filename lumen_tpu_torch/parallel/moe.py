"""A top-k routed mixture-of-experts FFN (twin of
``lumen_tpu/parallel/moe.py``): single-device, over the ``expert`` axis
of a serving group, or with GShard all-to-all dispatch over an ``expert``
axis of a process mesh.

On one device (what a serving replica runs, ``runtime/mesh.py``):

- the EXACT path (``capacity_factor=None``, what ``MoEFFN`` serves):
  the ``T * k`` (token, choice) assignments are sorted by expert and the
  expert bank runs as three grouped products over the sorted rows -- the
  JAX ``lax.ragged_dot`` calls. :func:`grouped_mm` is
  ``torch._grouped_mm`` for bfloat16 and on the CPU (``ragged_dot`` is an
  XLA op, not a Pallas kernel, so it stays a library call there, as it
  was one in JAX), and the hand-written kernel ``csrc/grouped_mm.cu``
  (:func:`grouped_mm_kernel`) for float16 and float32 on the card, where
  ``torch._grouped_mm`` takes bfloat16 only. The group ends stay on the
  device: no ``.tolist()``, no host sync, so a decode step enqueues
  without waiting for the router;
- the CAPACITY path (a finite ``capacity_factor``): GShard routing into
  ``C`` slots an expert, overflow dropped, dispatch and combine as
  einsums against one-hot masks, the bank as a batched einsum.

Over a process mesh (``runtime.mesh.build_process_mesh``; the tokens
and the banks DTensors split over the ``expert`` axis, the router
replicated), each rank routes its tokens into ``C`` slots an expert and
ONE all-to-all each way (``torch.distributed.nn.functional.
all_to_all_single``, differentiable) carries the slots to the rank that
holds the expert and back: the JAX ``shard_map`` body.
``capacity_factor=None`` there sets ``C`` to the local token count (no
drop).

Over a serving group's ``expert`` axis (a ``runtime.mesh.DeviceMesh``
built on a running ``expert x model`` group, or the rank's
``parallel.tp.ExpertParallel``; what ``MoEFFN`` passes), every rank holds
the same tokens, the whole router and ``E / n`` experts of each bank. Each
rank routes every token, runs the grouped products over the assignments
of its own experts only and writes their rows into a zeroed fp32 ``[T,
k, D]`` buffer; ONE ``all_reduce`` over the axis adds the buffers. Each
slot has one writer, so the sum adds zeros to it and is exact, and the
weighting over ``k`` then runs as on one device: the output is the
mesh-less one up to what the grouped product does per row. The data
plane is ``all_reduce`` only (no all-to-all): gloo has it for CUDA
tensors, and a serving group's tokens are already on every rank.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.nn import functional as F

from ..ops.attention import _DTYPE_CODES
from ..ops.cuda_build import CudaKernel
from ..runtime.mesh import EXPERT_AXIS, DeviceMesh
from .spmd import all_to_all, axis_group, local_of, replicated_input
from .tp import ExpertParallel


class MoEParams(NamedTuple):
    """Weights for a routed SwiGLU expert bank (the JAX layout).

    ``router``: [D, E] -- token -> expert logits, computed in fp32.
    ``w_gate``/``w_up``: [E, D, F]; ``w_down``: [E, F, D].
    """

    router: torch.Tensor
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor


def init_moe_params(
    generator: torch.Generator, d_model: int, d_ff: int, n_experts: int, dtype=torch.float32
) -> MoEParams:
    """Seeded normal weights scaled by fan-in (JAX ``init_moe_params``), on
    the generator's device; the router in fp32."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    scale_in, scale_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return MoEParams(
        router=normal(d_model, n_experts) * scale_in,
        w_gate=(normal(n_experts, d_model, d_ff) * scale_in).to(dtype),
        w_up=(normal(n_experts, d_model, d_ff) * scale_in).to(dtype),
        w_down=(normal(n_experts, d_ff, d_model) * scale_out).to(dtype),
    )


def moe_sharding(mesh, axis_name: str = EXPERT_AXIS) -> MoEParams:
    """DTensor placements matching :func:`moe_ffn` on a process mesh: the
    banks split their leading (expert) dim over the axis; the router is
    replicated (``distribute_tensor(t, mesh, placements)``)."""
    from torch.distributed.tensor import Replicate, Shard

    bank = [Shard(0) if name == axis_name else Replicate() for name in mesh.mesh_dim_names]
    return MoEParams(router=[Replicate()] * mesh.ndim, w_gate=bank, w_up=bank, w_down=bank)


def _topk_gates(x: torch.Tensor, router: torch.Tensor, k: int, norm_topk: bool):
    """Softmax-then-top-k routing: ``[T, k]`` gate values + expert ids, the
    softmax in fp32 over ``x @ router``."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)  # [T, E]
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # descending, as lax.top_k
    if norm_topk:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_vals, gate_idx


_P, _I = ctypes.c_void_p, ctypes.c_int
#: the grouped product in float16 and float32 on the card
#: (``csrc/grouped_mm.cu``)
GROUPED_MM = CudaKernel("grouped_mm", "grouped_mm", "lumen_grouped_mm", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
#: every kernel of this module, for builds and launch counts.
KERNELS = (GROUPED_MM,)
#: the dtypes :func:`grouped_mm_kernel` takes on the card
GROUPED_MM_DTYPES = (torch.float16, torch.float32)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``x`` [N, K] rows sorted by group, ``w`` [G, K, M], ``ends`` [G]
    int32 cumulative row ends (group g is rows ``ends[g-1]:ends[g]``) ->
    [N, M]: each group's rows times its matrix (JAX ``lax.ragged_dot``;
    an empty group costs nothing). K and M must be 16-byte multiples of
    the element size. The dtype picks the route: on the card bfloat16 runs
    ``torch._grouped_mm`` and float16 and float32 :func:`grouped_mm_kernel`
    (another dtype raises); on the CPU every dtype runs
    ``torch._grouped_mm``. Neither route falls back to the other."""
    align = 16 // x.element_size()
    if x.shape[1] % align or w.shape[2] % align:
        raise ValueError(f"grouped_mm: widths {x.shape[1]} and {w.shape[2]} must be multiples of {align}")
    if x.is_cuda and x.dtype != torch.bfloat16:
        return grouped_mm_kernel(x, w, ends)
    return torch._grouped_mm(x.contiguous(), w, offs=ends)


def grouped_mm_kernel(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The grouped product in float16 or float32 (:func:`grouped_mm`'s
    contract; rows past ``ends[-1]`` are zero): the CUDA kernel
    ``csrc/grouped_mm.cu`` on CUDA tensors, which reads ``ends`` on the
    device (no host sync), sums in fp32 and rounds to ``x.dtype`` once;
    :func:`grouped_mm_reference` on CPU tensors. A CUDA tensor the kernel
    does not take raises."""
    if x.device.type == "cpu":
        return grouped_mm_reference(x, w, ends)
    n, k = x.shape
    g, k2, m = w.shape
    if x.dtype not in GROUPED_MM_DTYPES or w.dtype != x.dtype:
        raise ValueError(f"grouped_mm: {x.dtype} x {w.dtype}; the kernel takes float16 or float32 for both")
    if k2 != k or ends.shape != (g,) or g < 1:
        raise ValueError(f"grouped_mm: x {tuple(x.shape)}, w {tuple(w.shape)}, ends {tuple(ends.shape)}")
    align = 16 // x.element_size()
    if k % align or m % align:
        raise ValueError(f"grouped_mm: widths {k} and {m} must be multiples of {align}")
    x = x.contiguous()
    ends = ends.to(torch.int32).contiguous()
    for name, t in (("x", x), ("w", w), ("ends", ends)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"grouped_mm: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"grouped_mm: {name} must be contiguous and 16-byte aligned")
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        GROUPED_MM.launch(
            x.data_ptr(), w.data_ptr(), ends.data_ptr(), out.data_ptr(), n, k, m, g, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream, dtype=x.dtype,
        )
    return out


def grouped_mm_reference(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grouped_mm` and :func:`grouped_mm_kernel`:
    one matrix product a group, the group bounds read on the host, rows
    past the last end zero."""
    out = x.new_zeros((x.shape[0], w.shape[2]))
    start = 0
    for g, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[g]
        start = end
    return out


def _moe_exact_local(
    params: MoEParams, x: torch.Tensor, *, n_experts: int, k: int, norm_topk: bool, mm=grouped_mm
) -> torch.Tensor:
    """Exact (zero-drop) single-device MoE (JAX ``_moe_exact_local``): the
    ``T * k`` assignments sorted stably by expert, three grouped products
    over the sorted rows, the rows put back and weighted by their gates
    in fp32. ``mm`` is the grouped product (the tests pass the plain one)."""
    t, d = x.shape
    gate_vals, gate_idx = _topk_gates(x, params.router, k, norm_topk)
    e_flat = gate_idx.reshape(-1)  # [N], N = T*k; index t*k+j = (token t, choice j)
    order = torch.sort(e_flat, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    xs = x.repeat_interleave(k, dim=0)[order].to(params.w_gate.dtype)  # [N, D]
    # Group sizes by scatter-add (torch.bincount sizes its output from the
    # data on the card: a host sync), then their running ends.
    sizes = torch.zeros(n_experts, dtype=torch.int32, device=x.device)
    sizes.scatter_add_(0, e_flat, torch.ones_like(e_flat, dtype=torch.int32))
    ends = sizes.cumsum(0, dtype=torch.int32)
    hg = mm(xs, params.w_gate, ends)
    hu = mm(xs, params.w_up, ends)
    ys = mm(F.silu(hg) * hu, params.w_down, ends)  # [N, D]
    ys = ys[inv].reshape(t, k, d).float()
    return (ys * gate_vals[..., None]).sum(dim=1).to(x.dtype)


def _moe_exact_ep(
    params: MoEParams, x: torch.Tensor, ep: ExpertParallel, *, n_experts: int, k: int, norm_topk: bool,
    mm=grouped_mm,
) -> torch.Tensor:
    """The exact path on one rank of a serving ``expert`` axis (module
    docstring): ``params`` holds this rank's ``E / n`` experts of each bank
    and the whole router. The assignments are sorted stably with this
    rank's experts first (expert ``e`` sorts as ``(e - lo) mod E``), so its
    groups are the mesh-less path's groups, rows and order; rows past the
    last local group end, which ``torch._grouped_mm`` leaves undefined,
    are dropped by a select, never by a product with zero (``NaN * 0`` is
    ``NaN``). No host sync."""
    t, d = x.shape
    local = ep.experts(n_experts)
    n_local = local.stop - local.start
    gate_vals, gate_idx = _topk_gates(x, params.router, k, norm_topk)
    key = (gate_idx.reshape(-1) - local.start) % n_experts  # this rank's experts are 0..n_local-1
    order = torch.sort(key, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    xs = x.repeat_interleave(k, dim=0)[order].to(params.w_gate.dtype)
    sizes = torch.zeros(n_experts, dtype=torch.int32, device=x.device)
    sizes.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    ends = sizes[:n_local].cumsum(0, dtype=torch.int32)
    hg = mm(xs, params.w_gate, ends)
    hu = mm(xs, params.w_up, ends)
    ys = mm(F.silu(hg) * hu, params.w_down, ends)[inv].reshape(t, k, d).float()
    mine = (key < n_local).reshape(t, k, 1)
    ys = ep.sum(torch.where(mine, ys, ys.new_zeros(())))
    return (ys * gate_vals[..., None]).sum(dim=1).to(x.dtype)


def _moe_local_ep(params: MoEParams, x: torch.Tensor, ep: ExpertParallel, *, n_experts: int, k: int,
                  capacity: int, norm_topk: bool) -> torch.Tensor:
    """The capacity path on one rank of a serving ``expert`` axis: the
    routing of :func:`_moe_local` over every token, this rank's experts'
    slots through its banks into a zeroed fp32 ``[E, C, D]`` buffer,
    summed over the axis (one writer a slot), then the combine."""
    t = x.shape[0]
    local = ep.experts(n_experts)
    dispatch, combine = _route(x, params.router, n_experts, k, capacity, norm_topk)
    buf = torch.einsum("td,tec->ecd", x.float(), dispatch[:, local]).to(params.w_gate.dtype)
    out = torch.zeros((n_experts, capacity, x.shape[1]), dtype=torch.float32, device=x.device)
    out[local] = _expert_ffn(params, buf).float()
    y = torch.einsum("ecd,tec->td", ep.sum(out), combine)
    return y.to(x.dtype).reshape(t, -1)


def _route(x: torch.Tensor, router: torch.Tensor, n_experts: int, k: int, capacity: int, norm_topk: bool = True):
    """Top-k capacity-limited routing for ``x: [T, D]`` (JAX ``_route``):
    ``dispatch: [T, E, C]`` one-hot (token t occupies slot c of expert e)
    and ``combine: [T, E, C]`` (the same support, scaled by the gate).
    All rank-0 choices claim slots before any rank-1 choice."""
    t = x.shape[0]
    gate_vals, gate_idx = _topk_gates(x, router, k, norm_topk)
    sel = F.one_hot(gate_idx, n_experts).float()  # [T, k, E]
    flat = sel.transpose(0, 1).reshape(k * t, n_experts)
    pos = flat.cumsum(dim=0) - 1.0  # slot index per (choice, expert)
    pos = pos.reshape(k, t, n_experts).transpose(0, 1)  # [T, k, E]
    slot = (pos * sel).sum(-1)  # [T, k] slot within the chosen expert
    fits = (slot < capacity) & (sel.sum(-1) > 0)
    # jax.nn.one_hot: an index outside [0, C) is an all-zero row
    slot_oh = (slot.long()[..., None] == torch.arange(capacity, device=x.device)).float()  # [T, k, C]
    choice = sel * fits[..., None]  # [T, k, E]
    dispatch = torch.einsum("tke,tkc->tec", choice, slot_oh)
    combine = torch.einsum("tke,tkc,tk->tec", choice, slot_oh, gate_vals)
    return dispatch, combine


def _expert_ffn(params: MoEParams, xs: torch.Tensor) -> torch.Tensor:
    """SwiGLU over the expert bank: ``xs: [E, N, D]``."""
    gate = torch.einsum("end,edf->enf", xs, params.w_gate)
    up = torch.einsum("end,edf->enf", xs, params.w_up)
    return torch.einsum("enf,efd->end", F.silu(gate) * up, params.w_down)


def _moe_local(
    params: MoEParams,
    x: torch.Tensor,
    *,
    n_experts: int,
    k: int,
    capacity: int,
    n_shards: int = 1,
    group=None,
    norm_topk: bool = True,
) -> torch.Tensor:
    """The capacity path (JAX ``_moe_local``): dispatch into ``[E, C, D]``,
    the bank, combine. With ``group`` (``n_shards`` ranks, each holding
    ``E / n`` experts of the bank) the slots go to their expert's rank and
    back by one all-to-all each way."""
    t = x.shape[0]
    dispatch, combine = _route(x, params.router, n_experts, k, capacity, norm_topk)
    buf = torch.einsum("td,tec->ecd", x.float(), dispatch).to(params.w_gate.dtype)  # [E, C, D]
    if group is not None:
        # [E, C, D] -> every rank holds its E/n local experts with the
        # slots from ALL n shards: [E/n, n*C, D].
        e_local = n_experts // n_shards
        buf = all_to_all(buf, group)
        buf = buf.reshape(n_shards, e_local, capacity, -1).transpose(0, 1).reshape(e_local, n_shards * capacity, -1)
        out = _expert_ffn(params, buf)
        out = out.reshape(e_local, n_shards, capacity, -1).transpose(0, 1).reshape(n_experts, capacity, -1)
        out = all_to_all(out, group)
    else:
        out = _expert_ffn(params, buf)
    y = torch.einsum("ecd,tec->td", out.float(), combine)
    return y.to(x.dtype).reshape(t, -1)


def moe_ffn(
    params: MoEParams,
    x: torch.Tensor,
    mesh=None,
    *,
    k: int = 2,
    capacity_factor: float | None = 1.25,
    axis_name: str = EXPERT_AXIS,
    norm_topk: bool = True,
) -> torch.Tensor:
    """Apply the routed expert FFN to ``x: [T, D]`` (flatten [B, S, D]
    upstream), on ``x``'s device (JAX ``moe_ffn``).

    ``capacity_factor=None`` is EXACT routing (nothing drops), the grouped
    products over expert-sorted assignments; a factor sets ``C = max(1,
    int(factor * k * T / E))`` slots an expert.

    ``mesh``: None; a serving ``runtime.mesh.DeviceMesh`` or the rank's
    ``parallel.tp.ExpertParallel`` (an ``expert`` axis above 1 runs the
    serving path of the module docstring: the banks hold this rank's
    ``E / n`` experts, the router and ``x`` are whole and the same on every
    rank, and so is the result); or a process mesh. On a process mesh with
    ``axis_name`` (any size), ``x`` [T, D] and the banks are DTensors split
    over that axis on dim 0 (``T`` and ``E`` must divide by its size, ``C``
    counts the local tokens), the router replicated, and the result is a
    DTensor placed as ``x``."""
    ep = None
    if isinstance(mesh, DeviceMesh):
        n = mesh.shape.get(axis_name, 1)
        if n > 1:
            ep = mesh.ep
            if ep is None or ep.size != n:
                raise RuntimeError(
                    f"mesh {mesh.shape}: an {axis_name!r} axis of {n} serves on a running expert x model group "
                    f"of {n} expert places, and this mesh has none; build the mesh with runtime.mesh.build_mesh "
                    f"while a group runs (serve() starts one for a config whose mesh names the axis; "
                    f"runtime.tp_group.TPGroup.spawn(devices, backend, expert={n}) starts one directly), or pass "
                    "the rank's parallel.tp.ExpertParallel; SPMD callers pass a process mesh "
                    "(runtime.mesh.build_process_mesh)"
                )
    elif isinstance(mesh, ExpertParallel):
        ep = mesh if mesh.size > 1 else None
    elif mesh is not None and axis_name in mesh.mesh_dim_names:
        return _moe_ffn_sharded(params, x, mesh, k=k, capacity_factor=capacity_factor, axis_name=axis_name,
                                norm_topk=norm_topk)
    n_experts = params.router.shape[1]
    if params.w_gate.shape[0] != (n_experts if ep is None else n_experts // ep.size):
        raise ValueError(f"the banks hold {params.w_gate.shape[0]} of {n_experts} experts on {ep or 'one device'}")
    if capacity_factor is None:
        if ep is not None:
            return _moe_exact_ep(params, x, ep, n_experts=n_experts, k=k, norm_topk=norm_topk)
        return _moe_exact_local(params, x, n_experts=n_experts, k=k, norm_topk=norm_topk)
    capacity = max(1, int(capacity_factor * k * x.shape[0] / n_experts))
    if ep is not None:
        return _moe_local_ep(params, x, ep, n_experts=n_experts, k=k, capacity=capacity, norm_topk=norm_topk)
    return _moe_local(params, x, n_experts=n_experts, k=k, capacity=capacity, norm_topk=norm_topk)


def _moe_ffn_sharded(params: MoEParams, x, mesh, *, k: int, capacity_factor: float | None, axis_name: str,
                     norm_topk: bool):
    """Expert-parallel :func:`moe_ffn` (the JAX ``shard_map`` over
    ``axis_name``): each rank's tokens, its slice of the banks, the full
    router."""
    from torch.distributed.tensor import DTensor

    group, n, _ = axis_group(mesh, axis_name)
    n_experts = params.w_gate.shape[0]
    if x.shape[0] % n or n_experts % n:
        raise ValueError(
            f"tokens ({x.shape[0]}) and experts ({n_experts}) must divide by mesh axis {axis_name!r} size {n}"
        )
    t_local = x.shape[0] // n
    capacity = t_local if capacity_factor is None else max(1, int(capacity_factor * k * t_local / n_experts))
    router = params.router.full_tensor() if isinstance(params.router, DTensor) else params.router
    router = replicated_input(router, group)  # each rank routes its own tokens
    local = MoEParams(router, local_of(params.w_gate), local_of(params.w_up), local_of(params.w_down))
    y = _moe_local(local, x.to_local(), n_experts=n_experts, k=k, capacity=capacity, n_shards=n, group=group,
                   norm_topk=norm_topk)
    return DTensor.from_local(y, mesh, x.placements, run_check=False)
