"""Sharding rules: map parameter names to partition specs, and place
parameters on a process mesh as DTensors (twin of
``lumen_tpu/parallel/sharding.py``).

The JAX rules match Flax tree paths (``vision/blocks_0/attn/q_proj/kernel``)
and a Flax ``kernel`` is ``[in, out]``. The rules here match the port's
``state_dict`` names (``vision.blocks.0.attn.q_proj.weight``) in the port's
layouts: ``nn.Linear.weight`` is ``[out, in]``, so the JAX column-parallel
``P(None, "model")`` on a kernel is ``P("model", None)`` on the weight
(``Shard(0)``), and the row-parallel ``P("model", None)`` is ``P(None,
"model")`` (``Shard(1)``). Biases follow their output dimension, as in
JAX. ``nn.Embedding.weight`` is ``[vocab, width]`` as the Flax table, so
the embedding rule keeps its spec. ``QDense``'s ``q`` keeps the JAX
``[in, out]`` layout, and so does its rule. ``tests/test_torch_sharding``
holds every rule against the JAX rule on the parameter's JAX path
(``models.vlm.convert.tree_paths``), transposed where the layout is.

A :class:`PartitionSpec` names, per tensor dimension, the mesh axis (or
tuple of axes) it is split over, or None; :func:`shard_params` turns it
into DTensor placements on a ``torch.distributed`` ``DeviceMesh``
(``runtime.mesh.build_process_mesh``), the counterpart of a
``NamedSharding``. A serving rank of a ``model`` or ``expert`` axis takes
its plain local slices instead (:func:`local_state_dict`, by whole
heads).
"""

from __future__ import annotations

import copy
import logging
import math
import re
from typing import Callable, Iterable, Mapping

import torch

from ..runtime.mesh import DeviceMesh, axis_sizes

logger = logging.getLogger(__name__)


class PartitionSpec(tuple):
    """``P("model", None)``: one entry per leading tensor dimension (JAX
    ``PartitionSpec``); trailing dimensions not named are unsharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

#: (name regex, PartitionSpec); first match wins, default = replicated
ShardingRule = tuple[str, PartitionSpec]

# Megatron layout for transformer blocks: attention QKV and MLP-up weights
# shard their output dim (rows of ``[out, in]``), attention-out and
# MLP-down their input dim -> one all-reduce per block. Embedding tables
# (``nn.Embedding.weight``, ``[vocab, width]``) and the bare position /
# class / token-type embeddings shard their width, as the JAX
# ``.*embedding$`` rule does.
TRANSFORMER_TP_RULES: list[ShardingRule] = [
    (r".*(q_proj|k_proj|v_proj|qkv|fc1|gate_proj|up_proj)\.weight$", P("model", None)),
    (r".*(q_proj|k_proj|v_proj|qkv|fc1|gate_proj|up_proj)\.bias$", P("model")),
    (r".*(o_proj|out_proj|fc2|down_proj)\.weight$", P(None, "model")),
    (r".*(_embedding|_embeddings|embed_tokens)\.weight$", P(None, "model")),
    (r".*_embedding$", P(None, "model")),
]

# Tensor-parallel rules for int8 projections (``ops/quant.QDense``: ``q``
# ``[in, out]`` int8 and ``scale [out]``, the JAX layout): the same
# Megatron split, the scale (and bias) of a column-parallel projection
# along its output dim; a row-parallel projection's scale and bias
# replicate. Prepend to TRANSFORMER_TP_RULES.
INT8_TP_RULES: list[ShardingRule] = [
    (r".*(q_proj|k_proj|v_proj|qkv|fc1|gate_proj|up_proj)\.q$", P(None, "model")),
    (r".*(q_proj|k_proj|v_proj|qkv|fc1|gate_proj|up_proj)\.(scale|bias)$", P("model")),
    (r".*(o_proj|out_proj|fc2|down_proj)\.q$", P("model", None)),
]

# Expert parallelism for MoE decoder layers (``models/vlm/modeling.MoEFFN``,
# banks ``[E, ...]`` in the JAX layout): the banks split their expert dim
# over ``expert``; the router replicates. Prepend to the TP rules when the
# mesh carries both axes.
MOE_EP_RULES: list[ShardingRule] = [
    (r".*mlp\.(w_gate|w_up|w_down)$", P("expert")),
    (r".*mlp\.router$", P()),
]


def spec_for(name: str, rules: Iterable[ShardingRule]) -> PartitionSpec:
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    return P()


def sanitize_spec(spec: PartitionSpec, shape: tuple[int, ...], mesh, path: str = "") -> PartitionSpec:
    """Degrade a spec so it is valid for a concrete tensor (JAX
    ``sanitize_spec``): axes not in the mesh replicate, specs longer than
    the tensor's rank replicate, and a sharded dim must divide evenly
    (else that dim replicates). Tuple entries (one dim over several axes)
    are supported. Degradations are logged so a typo'd axis or odd dim
    doesn't silently disable TP."""
    sizes = axis_sizes(mesh)
    if len(spec) > len(shape):
        if len(spec) > 0:
            logger.debug("spec %s has higher rank than leaf %s%s; replicating", spec, shape, f" at {path}" if path else "")
        return P()
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if entry is None:
            out.append(None)
            continue
        known = [a for a in axes if a in sizes]
        size = math.prod(sizes[a] for a in known)
        if len(known) != len(axes) or dim % size != 0:
            logger.warning(
                "degrading sharding %s for dim %d%s (unknown axis or indivisible); replicating that dim",
                entry, dim, f" at {path!r}" if path else "",
            )
            out.append(None)
        else:
            out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements_for(spec: PartitionSpec, mesh) -> list:
    """DTensor placements, one a mesh dim, for a sanitized spec: ``Shard(d)``
    on each mesh axis that tensor dim ``d`` names, ``Replicate()`` on the
    rest. A dim over several axes splits in mesh-axis order."""
    from torch.distributed.tensor import Replicate, Shard

    placements = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if e == name or (isinstance(e, tuple) and name in e)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return placements


def shard_params(params: Mapping[str, torch.Tensor], mesh, rules: Iterable[ShardingRule] | None = None) -> dict:
    """Place ``{name: tensor}`` (a ``state_dict``'s shape) onto the process
    mesh by the rules, as DTensors (specs that don't fit a tensor's
    rank/shape or the mesh degrade to replication). Every rank passes the
    same full tensors, on the mesh's device type."""
    from torch.distributed.tensor import distribute_tensor

    rules = list(rules or [])
    out = {}
    for name, t in params.items():
        spec = sanitize_spec(spec_for(name, rules), tuple(t.shape), mesh, path=name)
        out[name] = distribute_tensor(t.detach(), mesh, placements_for(spec, mesh))
    return out


def replicate(params, mesh):
    """Every tensor replicated on every rank of a process mesh (DTensors,
    ``shard_params`` with no rules, as the JAX ``shard_params``). On a
    serving :class:`~lumen_tpu_torch.runtime.mesh.DeviceMesh`: one copy a
    data place, in place order -- the one place a model is copied onto a
    mesh's cards. ``params`` is a module (place 0 gets the module itself,
    moved; each other place a deep copy, made before the move), or a
    callable ``place(device)`` that makes one copy on a device (a graph's
    ``OnnxModule.place``)."""
    if not isinstance(mesh, DeviceMesh):
        return shard_params(params, mesh, [])
    first, *rest = mesh.data_devices
    if isinstance(params, torch.nn.Module):
        copies = [copy.deepcopy(params).to(d) for d in rest]
        return [params.to(first), *copies]
    return [params(d) for d in (first, *rest)]


#: projections whose split dimension counts query heads, and KV heads
_QUERY_PROJ = re.compile(r"(^|\.)(q_proj|o_proj|out_proj)\.(weight|bias|q|scale)$")
_KV_PROJ = re.compile(r"(^|\.)(k_proj|v_proj)\.(weight|bias|q|scale)$")

#: ``heads(name)``: the ``(heads, kv_heads, head_dim)`` of the attention
#: block a parameter belongs to, or None outside attention
HeadLayout = Callable[[str], "tuple[int, int, int] | None"]


def tp_split(name: str, shape: tuple[int, ...], rules: Iterable[ShardingRule], tp,
             heads: HeadLayout | None = None, ep=None) -> "tuple[PartitionSpec, int | None, slice | None]":
    """How a serving rank holds the parameter ``name``: ``tp`` is its place
    on the ``model`` axis (``parallel.tp.TensorParallel``), ``ep`` on the
    ``expert`` axis (``parallel.tp.ExpertParallel``, or None without one).
    Returns ``(spec, dim, rows)``: the spec its slice carries, the split
    dimension and this rank's ``[lo, hi)`` of it (``None, None`` when it
    replicates). No rule splits one tensor over both axes.

    The rule is the JAX one -- first match of ``rules`` (``MOE_EP_RULES``
    first, so the expert banks split over ``expert`` and the router stays
    whole), then :func:`sanitize_spec` against the axes -- with one
    difference: a projection of an attention block (``heads`` names its
    layout) splits by WHOLE heads, ``tp.attn_plan``. JAX's
    ``sanitize_spec`` checks only that the column count divides, so at
    ``model`` 4 it would cut Qwen2-0.5B's 2 KV heads of 64 columns into
    half-heads (128 / 4 = 32 columns a device), which GSPMD computes
    through collectives inside attention; a rank here runs attention on
    local heads only. So where ``kv_heads`` is smaller than the axis each
    rank keeps the KV head its query heads read (Megatron's rule), and
    where the query heads do not divide the whole block replicates (and
    its module skips the sum)."""
    sizes = {"model": tp.size} if ep is None else {"model": tp.size, "expert": ep.size}
    layout = heads(name) if heads is not None else None
    if layout is not None and (_QUERY_PROJ.search(name) or _KV_PROJ.search(name)):
        # Whole heads decide, not the column count.
        spec = spec_for(name, rules)
        spec = spec if len(spec) <= len(shape) else P()
    else:
        spec = sanitize_spec(spec_for(name, rules), shape, sizes, path=name)
        layout = None
    dims = [(d, e) for d, e in enumerate(spec) if e in sizes]
    if not dims:
        return P(), None, None
    dim, axis = dims[0]
    if axis == "expert":
        return spec, dim, ep.experts(shape[dim])
    if layout is not None:
        h, kvh, dh = layout
        plan = tp.attn_plan(h, kvh)
        if not plan.split:
            return P(), None, None
        if _QUERY_PROJ.search(name):
            return spec, dim, slice(plan.q_lo * dh, (plan.q_lo + plan.q_heads) * dh)
        rows = slice(plan.kv_lo * dh, (plan.kv_lo + plan.kv_heads) * dh)
        if plan.kv_heads * tp.size != kvh:
            # Fewer KV heads than ranks: the slice is a head every rank
            # group shares, not a 1/size block (no JAX spec describes it).
            spec = P(*(None if e == "model" else e for e in spec))
            while spec and spec[-1] is None:
                spec = P(*spec[:-1])
        return spec, dim, rows
    rows = tp.split(shape[dim])
    return (spec, dim, rows) if rows is not None else (P(), None, None)


def local_state_dict(state: Mapping[str, torch.Tensor], rules: Iterable[ShardingRule], tp,
                     heads: HeadLayout | None = None, ep=None) -> dict[str, torch.Tensor]:
    """This serving rank's local slice of every tensor of ``state`` (plain
    tensors, no DTensor): the rules and whole-head splits of
    :func:`tp_split` on the rank's ``model`` place ``tp`` and ``expert``
    place ``ep``. Slices are contiguous copies, so the full tensors can be
    freed."""
    rules = list(rules)
    out = {}
    for name, t in state.items():
        _, dim, rows = tp_split(name, tuple(t.shape), rules, tp, heads, ep)
        out[name] = t if dim is None else t.narrow(dim, rows.start, rows.stop - rows.start).contiguous()
    return out
