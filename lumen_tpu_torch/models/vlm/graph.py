"""Graph-backed VLM vision tower: FastVLM's exported ``vision*.onnx`` on the
port's ONNX bridge (the port of ``lumen_tpu/models/vlm/graph.py``).

The reference serves FastVLM as three onnxruntime sessions -- vision.onnx,
embed.onnx, decoder.onnx (``packages/lumen-vlm/src/lumen_vlm/backends/
onnxrt_backend.py:107-140``). The decoder runs as the port's native Qwen2
(``modeling.py``); the vision tower is one static-shape forward per image,
which the bridge runs with the exporter's own weights, so FastViTHD-style
hybrid conv/attention towers need no conversion rules.

Contract (reference ``_run_vision_encoder:661-729``): input ``[B, 3, S,
S]`` normalized float32 pixels, output ``[B, N, H_decoder]`` projector-
space embeddings, ready to splice at the image-token position.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ...onnx_bridge import OnnxModule


def find_vision_onnx(model_dir: str) -> str | None:
    """Locate a ``vision*.onnx`` export: the bare directory first, then
    its ``onnx/`` subdirectory."""
    for d in (model_dir, os.path.join(model_dir, "onnx")):
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.startswith("vision") and name.endswith(".onnx"):
                return os.path.join(d, name)
    return None


@dataclass
class VisionGraph:
    """``[B, 3, S, S]`` normalized floats -> ``[B, N, H]`` splice-ready
    embeddings. The weights live in :attr:`module` (float32, host) until
    :meth:`place` copies them to a device; :meth:`release_weights` then
    drops the host copy."""

    module: OnnxModule

    @classmethod
    def from_path(cls, path: str) -> "VisionGraph":
        return cls(module=OnnxModule.from_path(path))

    def place(self, device) -> dict[str, torch.Tensor]:
        """The tower's float32 weights on ``device`` (one copy per device)."""
        return self.module.place(device)

    def bind(self, device=None):
        """``(fn, params)``: ``fn(params, pixels)`` -> a tuple of outputs,
        the weights placed on ``device`` (``cuda:0`` unless given)."""
        return self.module.bind(device=device)

    def release_weights(self) -> None:
        """Drop the host weights once a device copy exists."""
        self.module.release_weights()

    def __call__(self, params: dict, x_nchw: torch.Tensor) -> torch.Tensor:
        out = self.module(params, {self.module.input_names[0]: x_nchw})[0]
        if not isinstance(out, torch.Tensor) or out.ndim != 3:
            raise ValueError(f"vision graph output must be [B, N, H], got shape {tuple(np.shape(out))}")
        return out

    def probe(self, image_size: int, hidden_size: int, params: dict | None = None) -> int:
        """Run once on zeros to learn the token count, and check the
        embedding width against the decoder's hidden size. ``params`` are
        placed weights (the host weights by default); the probe runs on
        their device."""
        params = self.module.params if params is None else params
        device = next(iter(params.values())).device if params else torch.device("cpu")
        with torch.inference_mode():
            out = self(params, torch.zeros((1, 3, image_size, image_size), device=device))
        n, h = int(out.shape[1]), int(out.shape[2])
        if h != hidden_size:
            raise ValueError(
                f"vision graph emits width {h}, decoder hidden is {hidden_size}: "
                "the export must include the multimodal projector"
            )
        return n
