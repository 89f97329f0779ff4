"""Image preprocessing constants and the host-decode re-exports (the
port's part of ``lumen_tpu/ops/image.py``).

Normalization runs on the device inside each model's batched call (the
CLIP manager's image encoder divides the uint8 pixels by 255 and
normalizes there). Not ported: the device-side ``resize_bilinear``,
``normalize`` and ``clip_preprocess`` of the JAX module. Nothing in either
package calls them (photo ingest landed without them); they are public
names only, queued with the package-level names (ROADMAP A3).
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
