"""Graph-backed CLIP towers: exported ``vision.onnx`` / ``text.onnx`` on the
port's ONNX bridge (the port of ``lumen_tpu/models/clip/graph.py``).

The reference's PRIMARY CLIP path is a dual-session onnxruntime backend
over exactly these exports (``packages/lumen-clip/src/lumen_clip/backends/
onnxrt_backend.py:72-745``: precision-aware ``{component}.{precision}.onnx``
file pick, input-dtype autodetect, context length read from the text
input's shape). Serving them through the bridge means model families whose
towers have no conversion rules — MobileCLIP2's FastViT hybrid vision
tower (the region=other config default), distilled/exported variants —
run on the card with the exporter's own weights.

Contract (reference ``image_to_vector``/``text_to_vector``): vision takes
``[B, 3, S, S]`` normalized pixels, text takes ``[B, L]`` token ids; both
emit ``[B, D]`` embeddings which the manager L2-normalizes (reference
``:486-489``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from ...onnx_bridge import OnnxModule, find_onnx_exports

logger = logging.getLogger(__name__)


def find_clip_onnx(model_dir: str, precision: str | None = None) -> dict[str, str]:
    """Locate ``vision*.onnx`` / ``text*.onnx`` with the reference's
    precision-preference chain (shared discovery helper)."""
    return find_onnx_exports(
        model_dir, {"vision": "vision", "text": "text"}, precision
    )


@dataclass
class ClipTowerGraph:
    """One exported tower as an eager forward on the bridge."""

    module: OnnxModule

    @classmethod
    def from_path(cls, path: str) -> "ClipTowerGraph":
        mod = OnnxModule.from_path(path)
        logger.info(
            "clip tower graph %s: %d MB params, inputs %s",
            os.path.basename(path), mod.param_bytes() >> 20, mod.input_shapes(),
        )
        return cls(module=mod)

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        out = self.module(params, {self.module.input_names[0]: x})[0]
        if not isinstance(out, torch.Tensor) or out.ndim != 2:
            raise ValueError(f"CLIP tower must emit [B, D], got {getattr(out, 'shape', out)}")
        return out

    def context_length(self, default: int) -> int:
        """Static text length from the export's input shape (reference
        detects it the same way, ``onnxrt_backend.py:212-217``)."""
        shape = next(iter(self.module.input_shapes().values()), ())
        if len(shape) == 2 and isinstance(shape[1], int) and shape[1] > 0:
            return int(shape[1])
        return default

    def probe_dim(self, example: np.ndarray, params: dict | None = None) -> int:
        """Output dim by one batch-1 forward of ``example`` (on the device
        of ``params``, the placed weights; the host weights by default)."""
        params = self.module.params if params is None else params
        device = next(iter(params.values())).device if params else torch.device("cpu")
        with torch.inference_mode():
            out = self(params, torch.from_numpy(np.ascontiguousarray(example)).to(device))
        return int(out.shape[1])
