"""OCR checkpoint conversion (the port of ``lumen_tpu/models/ocr/convert.py``).

Native lumen-tpu checkpoints (``params/...`` / ``batch_stats/...`` flat
safetensors) load directly. Paddle-format checkpoints have no torch-style
state dict to convert mechanically — the reference consumes them as opaque
ONNX graphs (``lumen_ocr/backends/onnxrt_backend.py``) — so non-native
files get a clear re-export error instead of a silent wrong-weights load.

Then :func:`ocr_params_from_jax` lays the Flax variable tree out as the
``state_dict`` of the port's ``DBNet`` / ``SVTRRecognizer`` /
``TextlineClassifier``: conv kernels HWIO -> OIHW, Dense kernels
transposed, the DB head's transposed-conv kernels (Flax ``ConvTranspose``,
``transpose_kernel=False``, ``SAME``) as ``nn.ConvTranspose2d`` weights
[in, out, kh, kw] flipped in both spatial dims, BatchNorm and LayerNorm
``scale`` -> ``weight``, ``pos_embed`` as it is.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ...runtime.weights import WeightLoadError, is_native_checkpoint, split_collections
from ..face.convert import _flatten, flatten_variables

__all__ = ["convert_ocr_checkpoint", "flatten_variables", "ocr_params_from_jax"]


def convert_ocr_checkpoint(state: dict[str, torch.Tensor]) -> dict:
    """-> {'params': ..., 'batch_stats': ...} variable collections."""
    if is_native_checkpoint(state):
        return split_collections(state)
    raise WeightLoadError(
        "no conversion rules for non-native OCR checkpoint "
        f"(keys like {sorted(state)[:4]}); re-export in the native format "
        "(flatten_variables + safetensors)"
    )


#: Flax leaf name -> the port's state name, by collection
_LEAF = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "kernel"): "weight",
    ("params", "pos_embed"): "pos_embed",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def ocr_params_from_jax(variables: Mapping, module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Flax variables (``params`` and ``batch_stats``) of the JAX ``DBNet``,
    ``SVTRRecognizer`` or ``TextlineClassifier`` (leaves as torch tensors,
    numpy or anything ``np.asarray`` takes) -> ``state_dict`` of the port's
    ``module`` of the same architecture (its submodules tell the transposed
    convs from the plain ones); numpy leaves come in as float32."""
    out: dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        for path, leaf in _flatten(tree):
            *parents, name = path.split("/")
            t = leaf if isinstance(leaf, torch.Tensor) else torch.tensor(np.asarray(leaf, np.float32))
            if name == "kernel":
                owner = module.get_submodule(".".join(parents))
                if isinstance(owner, torch.nn.ConvTranspose2d):
                    t = t.permute(2, 3, 0, 1).flip(2, 3)
                else:
                    t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
            try:
                name = _LEAF[(coll, name)]
            except KeyError as e:
                raise WeightLoadError(f"unexpected OCR variable {coll}/{path}") from e
            out[".".join(parents + [name])] = t.contiguous()
    return out
