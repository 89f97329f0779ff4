"""Face checkpoint conversion (the port of ``lumen_tpu/models/face/convert.py``).

Two sources, converted to the JAX package's Flax variable tree exactly as
the JAX converter converts them:

- **native** checkpoints (the lumen-tpu ``jax`` runtime format): safetensors
  whose keys are '/'-separated Flax paths prefixed with the variable
  collection (``params/...`` or ``batch_stats/...``) — loaded directly;
- **torch IResNet** state dicts (InsightFace ArcFace layout: ``conv1``,
  ``bn1``, ``prelu``, ``layer{1-4}.{i}.{bn1,conv1,bn2,prelu,conv2,bn3,
  downsample.0,downsample.1}``, final ``bn2``, ``fc``, ``features``) —
  converted by the JAX package's rules. The FC kernel needs an
  NCHW->NHWC flatten permute because torch flattens [C, H, W] and flax
  flattens [H, W, C].

Then :func:`face_params_from_jax` lays that tree out as the ``state_dict``
of the port's ``FaceDetector`` / ``IResNet`` (conv kernels HWIO -> OIHW,
Dense kernels transposed, BatchNorm ``scale``/``mean``/``var`` renamed),
which ``load_state_dict(strict=True)`` gates.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ...runtime.weights import (
    WeightLoadError,
    apply_rules,
    conv_kernel,
    is_native_checkpoint,
    split_collections,
)

__all__ = [
    "convert_face_checkpoint",
    "convert_iresnet",
    "face_params_from_jax",
    "fc_kernel_from_torch",
    "flatten_variables",
    "is_native_checkpoint",
    "split_collections",
]


def fc_kernel_from_torch(w: torch.Tensor, c: int, h: int, ww: int) -> torch.Tensor:
    """torch FC weight [out, C*H*W] -> flax Dense kernel [(H*W*C), out]."""
    out_dim = w.shape[0]
    return w.reshape(out_dim, c, h, ww).permute(0, 2, 3, 1).reshape(out_dim, h * ww * c).t().contiguous()


def _bn(src: str, dst: str):
    return [
        (rf"{src}\.weight", rf"params/{dst}/scale", None),
        (rf"{src}\.bias", rf"params/{dst}/bias", None),
        (rf"{src}\.running_mean", rf"batch_stats/{dst}/mean", None),
        (rf"{src}\.running_var", rf"batch_stats/{dst}/var", None),
    ]


def iresnet_rules(final_c: int, final_hw: int):
    rules = [
        (r"conv1\.weight", r"params/stem_conv/kernel", conv_kernel),
        *_bn("bn1", "stem_bn"),
        (r"prelu\.weight", r"params/stem_prelu/alpha", None),
        (
            r"fc\.weight",
            r"params/fc/kernel",
            lambda w: fc_kernel_from_torch(w, final_c, final_hw, final_hw),
        ),
        (r"fc\.bias", r"params/fc/bias", None),
        *_bn("bn2", "final_bn"),
        *_bn("features", "features"),
    ]
    # layerS.I.* -> layer{S}_{I}/*
    rules += [
        (r"layer(\d+)\.(\d+)\.conv1\.weight", r"params/layer\1_\2/conv1/kernel", conv_kernel),
        (r"layer(\d+)\.(\d+)\.conv2\.weight", r"params/layer\1_\2/conv2/kernel", conv_kernel),
        (r"layer(\d+)\.(\d+)\.prelu\.weight", r"params/layer\1_\2/prelu/alpha", None),
        (r"layer(\d+)\.(\d+)\.downsample\.0\.weight", r"params/layer\1_\2/down_conv/kernel", conv_kernel),
    ]
    for bn_name in ("bn1", "bn2", "bn3"):
        rules += [
            (rf"layer(\d+)\.(\d+)\.{bn_name}\.weight", rf"params/layer\1_\2/{bn_name}/scale", None),
            (rf"layer(\d+)\.(\d+)\.{bn_name}\.bias", rf"params/layer\1_\2/{bn_name}/bias", None),
            (rf"layer(\d+)\.(\d+)\.{bn_name}\.running_mean", rf"batch_stats/layer\1_\2/{bn_name}/mean", None),
            (rf"layer(\d+)\.(\d+)\.{bn_name}\.running_var", rf"batch_stats/layer\1_\2/{bn_name}/var", None),
        ]
    rules += _bn(r"layer(\d+)\.(\d+)\.downsample\.1", r"layer\1_\2/down_bn")
    return rules


def convert_iresnet(state: dict[str, torch.Tensor], final_c: int, final_hw: int) -> dict:
    flat = apply_rules(
        state,
        iresnet_rules(final_c, final_hw),
        drop=[r"num_batches_tracked"],
    )
    return split_collections(flat)


def convert_face_checkpoint(state: dict[str, torch.Tensor], kind: str, **kw) -> dict:
    """-> {'params': ..., 'batch_stats': ...} variable collections."""
    if is_native_checkpoint(state):
        return split_collections(state)
    if kind == "recognition":
        return convert_iresnet(state, **kw)
    raise WeightLoadError(
        f"no conversion rules for non-native {kind!r} checkpoint "
        f"(keys like {sorted(state)[:4]}); re-export in the native format"
    )


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def flatten_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """Inverse of :func:`split_collections` (for saving native checkpoints)."""
    return {f"{coll}/{k}": v for coll, tree in variables.items() for k, v in _flatten(tree)}


#: Flax leaf name -> the port's (collection, state name)
_LEAF = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "alpha"): "alpha",
    ("params", "kernel"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def face_params_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax variables (``params`` and ``batch_stats``) of the JAX
    ``FaceDetector`` or ``IResNet`` (leaves as torch tensors, numpy or
    anything ``np.asarray`` takes) -> ``state_dict`` of the port's module:
    conv kernels HWIO -> OIHW, Dense kernels [in, out] -> [out, in], float
    leaves kept in their dtype (numpy leaves as float32)."""
    out: dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        for path, leaf in _flatten(tree):
            *parents, name = path.split("/")
            t = leaf if isinstance(leaf, torch.Tensor) else torch.tensor(np.asarray(leaf, np.float32))
            if name == "kernel":
                t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
            try:
                name = _LEAF[(coll, name)]
            except KeyError as e:
                raise WeightLoadError(f"unexpected face variable {coll}/{path}") from e
            out[".".join(parents + [name])] = t.contiguous()
    return out
