"""Parameter conversion from the JAX package's Flax tree to the port's
``state_dict``, so both packages compute the same function in the tests.

Layout choice: the port uses ``nn.Linear`` (weight ``[out, in]``), so
every Flax ``Dense`` kernel (``[in, out]``) is transposed; the patch
embedding's HWIO conv kernel ``[P, P, C, W]`` flattens to ``[W, P*P*C]``.
Norm ``scale`` and embedding ``embedding`` leaves become ``weight``;
``layers_<i>`` / ``blocks_<i>`` become ``layers.<i>`` / ``blocks.<i>``.
Loading a checkpoint directory (safetensors + tokenizer) is not ported
yet.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(layers|blocks)_(\d+)$")
_RENAME = {"scale": "weight", "embedding": "weight", "kernel": "weight"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``params`` tree of the JAX ``VLMModel`` (leaves as numpy or
    anything ``np.asarray`` takes) -> ``state_dict`` of the port's
    ``VLMModel``, in float32."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(flax_params):
        arr = np.asarray(leaf, dtype=np.float32)
        *parents, name = path
        parents = [".".join(m.groups()) if (m := _INDEXED.match(p)) else p for p in parents]
        if name == "kernel":
            arr = arr.reshape(-1, arr.shape[-1]).T  # [in..., out] -> [out, in]
        out[".".join(parents + [_RENAME.get(name, name)])] = torch.tensor(arr)
    return out
