"""Checkpoint loading: safetensors / torch checkpoints -> torch tensors.

The port of ``lumen_tpu/runtime/weights.py``. Handles:

- ``.safetensors`` (single files or a ``*.safetensors.index.json`` with
  its shards), read with ``safetensors.torch`` so every tensor keeps its
  stored dtype (a bf16 checkpoint stays bf16: no host fp32 copy of the
  whole model, as the JAX loader's numpy route makes);
- torch ``.bin``/``.pt`` pickles (``weights_only`` load);
- the layout helpers and the regex rename-rule engine the model
  converters build on. The helpers keep the JAX package's target layout
  (Flax ``Dense`` ``[in, out]``, conv ``HWIO``), so the converters' rule
  tables are the JAX package's own; they return views, and the
  converter's last step lays them out for ``nn.Linear``.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Callable, Iterable

import torch

logger = logging.getLogger(__name__)


class WeightLoadError(Exception):
    pass


# -- raw state-dict loading -------------------------------------------------


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    try:
        return dict(load_file(path))
    except Exception as e:  # noqa: BLE001
        raise WeightLoadError(f"cannot load safetensors file {path}: {e}") from e


def load_sharded_safetensors(index_path: str) -> dict[str, torch.Tensor]:
    with open(index_path, "r", encoding="utf-8") as f:
        index = json.load(f)
    base = os.path.dirname(index_path)
    out: dict[str, torch.Tensor] = {}
    for shard in sorted(set(index["weight_map"].values())):
        out.update(load_safetensors(os.path.join(base, shard)))
    return out


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]
    return {k: v.detach() for k, v in state.items() if isinstance(v, torch.Tensor)}


def load_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """Load whatever checkpoint format a model directory carries, preferring
    safetensors (sharded, then single), then torch pickles."""
    index = [f for f in os.listdir(model_dir) if f.endswith(".safetensors.index.json")]
    if index:
        return load_sharded_safetensors(os.path.join(model_dir, index[0]))
    st = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if st:
        out: dict[str, torch.Tensor] = {}
        for f in st:
            out.update(load_safetensors(os.path.join(model_dir, f)))
        return out
    binaries = sorted(
        f for f in os.listdir(model_dir) if f.endswith((".bin", ".pt")) and not f.startswith(".")
    )
    if binaries:
        out = {}
        for f in binaries:
            out.update(load_torch_checkpoint(os.path.join(model_dir, f)))
        return out
    raise WeightLoadError(f"no checkpoint files found in {model_dir}")


# -- layout conversion ------------------------------------------------------


def linear_kernel(w: torch.Tensor) -> torch.Tensor:
    """torch ``nn.Linear.weight`` [out, in] -> Flax ``Dense`` kernel [in, out] (a view)."""
    return w.t()


def conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """torch conv weight OIHW -> Flax conv kernel HWIO (a view)."""
    return w.permute(2, 3, 1, 0)


# -- rename-rule engine -----------------------------------------------------

#: (regex pattern, replacement-template, optional value transform)
RenameRule = tuple[str, str, Callable[[torch.Tensor], torch.Tensor] | None]


def apply_rules(
    state: dict[str, torch.Tensor],
    rules: Iterable[RenameRule],
    strict: bool = False,
    drop: Iterable[str] = (),
) -> dict[str, torch.Tensor]:
    """Map checkpoint keys to param-tree paths via the first matching rule.

    Output keys are '/'-separated param paths (e.g.
    ``vision/blocks_0/attn/q_proj/kernel``). ``drop`` patterns are removed
    silently; unmatched keys raise (strict) or are logged and skipped.
    """
    compiled = [(re.compile(p), t, fn) for p, t, fn in rules]
    dropped = [re.compile(p) for p in drop]
    out: dict[str, torch.Tensor] = {}
    unmatched: list[str] = []
    for key, value in state.items():
        if any(d.search(key) for d in dropped):
            continue
        for pat, template, fn in compiled:
            m = pat.fullmatch(key)
            if m:
                out[m.expand(template)] = fn(value) if fn else value
                break
        else:
            unmatched.append(key)
    if unmatched:
        msg = f"{len(unmatched)} checkpoint keys unmatched by rename rules: {unmatched[:8]}"
        if strict:
            raise WeightLoadError(msg)
        logger.warning(msg)
    return out


def unflatten(flat: dict[str, torch.Tensor]) -> dict:
    """'/'-separated flat keys -> nested param dict (a Flax-style tree)."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise WeightLoadError(f"key {key!r} conflicts with leaf at {p!r}")
        if isinstance(node.get(parts[-1]), dict):
            raise WeightLoadError(f"key {key!r} conflicts with existing subtree")
        node[parts[-1]] = value
    return tree


# -- native checkpoint format ------------------------------------------------
#
# The JAX package's "jax" runtime format: safetensors whose keys are
# '/'-separated Flax paths prefixed with the variable collection
# (``params/...`` or ``batch_stats/...``).


def is_native_checkpoint(state: dict[str, torch.Tensor]) -> bool:
    return all(k.startswith(("params/", "batch_stats/")) for k in state)


def split_collections(flat: dict[str, torch.Tensor]) -> dict[str, dict]:
    """'params/a/b', 'batch_stats/a/b' flat keys -> {'params': tree, ...}."""
    grouped: dict[str, dict[str, torch.Tensor]] = {}
    for key, value in flat.items():
        coll, _, rest = key.partition("/")
        if not rest:
            raise WeightLoadError(f"native checkpoint key missing collection prefix: {key!r}")
        grouped.setdefault(coll, {})[rest] = value
    return {coll: unflatten(tree) for coll, tree in grouped.items()}
