"""Image preprocessing (the port of ``lumen_tpu/ops/image.py``): the
normalization constants, the batched device-side ``resize_bilinear``,
``normalize`` and ``clip_preprocess``, and the host-decode re-exports.

The serving paths normalize inside each model's batched call (the CLIP
manager's image encoder divides the uint8 pixels by 255 and normalizes
there), so nothing in either package calls the three device functions;
they are public API. ``jax.image.resize`` antialiases when it downscales
(a triangle filter widened by the scale), and ``resize_bilinear`` keeps
that with ``F.interpolate(..., antialias=True)``: the two agree within
``tests/test_torch_ops_exports.py``'s tolerance, not bit for bit.
"""

from __future__ import annotations

# Normalization statistics (reference: clip loader defaults,
# packages/lumen-clip/src/lumen_clip/resources/loader.py:101-139).
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Host-side decode primitives live in the torch-free
# lumen_tpu_torch.utils.host_decode (the decode-pool workers import THAT
# module); re-exported here for the same import sites as the JAX package.
from ..utils.host_decode import (  # noqa: E402,F401
    DECODE_POLICY,
    _factor_from_hw,
    _reduced_decode_factor,
    decode_image_bytes,
    decode_image_bytes_scaled,
    letterbox_numpy,
    letterbox_params,
    probe_image_size,
)


def resize_bilinear(images, size: tuple[int, int], method: str = "bilinear"):
    """[B, H, W, C] uint8/float -> [B, size_h, size_w, C] float32, half-pixel
    centers, antialiased when it downscales (``jax.image.resize``)."""
    import torch
    from torch.nn import functional as F

    if method not in ("bilinear", "linear"):
        raise ValueError(f"resize_bilinear: method {method!r} is not bilinear")
    x = torch.as_tensor(images).float().permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()


def normalize(images, mean, std):
    """[B, H, W, C] in [0, 255] -> ``(x / 255 - mean) / std`` in float32."""
    import torch

    x = torch.as_tensor(images).float() / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def clip_preprocess(images, size: int = 224, mean: tuple[float, ...] = OPENAI_CLIP_MEAN,
                    std: tuple[float, ...] = OPENAI_CLIP_STD):
    """Batched CLIP preprocessing: a direct resize to ``size`` x ``size``
    then normalize, NHWC float32 (the reference preprocessor's
    semantics)."""
    return normalize(resize_bilinear(images, (size, size)), mean, std)
