"""Parameter conversion from the JAX package's Flax tree to the port's
``state_dict``, so both packages compute the same function in the tests,
and the int8 quantization of the decoder's projections.

Layout choice: the port uses ``nn.Linear`` (weight ``[out, in]``), so
every Flax ``Dense`` kernel (``[in, out]``) is transposed; the patch
embedding's HWIO conv kernel ``[P, P, C, W]`` flattens to ``[W, P*P*C]``.
Norm ``scale`` and embedding ``embedding`` leaves become ``weight``;
``layers_<i>`` / ``blocks_<i>`` become ``layers.<i>`` / ``blocks.<i>``.
A ``QDense`` (int8) module keeps its leaves as they are: ``q`` int8
``[in, out]``, ``scale`` fp32 ``[out]`` -- the port's ``QDense`` has the
JAX layout. Loading a checkpoint directory (safetensors + tokenizer) is
not ported yet.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from ...ops.quant import quantize_state_int8

_INDEXED = re.compile(r"^(layers|blocks)_(\d+)$")
_RENAME = {"scale": "weight", "embedding": "weight", "kernel": "weight"}

#: decoder projections ``QDense`` replaces when ``weight_quant="int8"``
#: (JAX ``_QUANT_KERNEL``): attention q/k/v/o, SwiGLU gate/up/down and an
#: untied lm_head. Embeddings and norms stay in the policy dtype.
_QUANT_WEIGHT = re.compile(
    r"^decoder\..*(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj|lm_head)\.weight$"
)


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
    ``VLMModel``: float leaves in float32, ``QDense`` leaves as they are."""
    leaves = list(_flatten(flax_params))
    quantized = {path[:-1] for path, _ in leaves if path[-1] == "q"}
    out: dict[str, torch.Tensor] = {}
    for path, leaf in leaves:
        *parents, name = path
        if tuple(parents) in quantized:  # QDense: q int8 [in, out], scale fp32 [out]
            arr = np.asarray(leaf, dtype=np.int8 if name == "q" else np.float32)
        else:
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                arr = arr.reshape(-1, arr.shape[-1]).T  # [in..., out] -> [out, in]
            name = _RENAME.get(name, name)
        parents = [".".join(m.groups()) if (m := _INDEXED.match(p)) else p for p in parents]
        out[".".join(parents + [name])] = torch.tensor(arr)
    return out


def quantize_decoder_int8(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Weight-only int8 for the decoder's projections (JAX
    ``quantize_decoder_int8``): each matching ``weight`` becomes ``q`` +
    ``scale`` (see ``ops.quant.quantize_linear_int8``). Apply AFTER the
    dtype-policy cast; the vision tower is never quantized."""
    return quantize_state_int8(state, _QUANT_WEIGHT)
