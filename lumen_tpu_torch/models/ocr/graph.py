"""Graph-backed OCR models: real PP-OCR ONNX exports on the port's bridge
(the port of ``lumen_tpu/models/ocr/graph.py``).

The reference serves PP-OCRv4/v5 det+rec ``.onnx`` files through onnxruntime
(``packages/lumen-ocr/src/lumen_ocr/backends/onnxrt_backend.py:43-633``).
Here the same files load through ``lumen_tpu_torch.onnx_bridge`` into eager
torch forwards on the serving device, so ``ocr`` produces the same answers
as the reference with the same weights. File discovery follows the
reference naming convention (``_find_model_file``, ``onnxrt_backend.py:
210-233``): ``detection.{precision}.onnx`` / ``recognition.{precision}.onnx``
with a bare ``detection.onnx`` fallback, plus the stock PaddleOCR export
names (``det*.onnx`` / ``rec*.onnx`` / ``cls*.onnx``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from ...onnx_bridge import OnnxModule, find_onnx_exports

logger = logging.getLogger(__name__)


def find_onnx_models(model_dir: str, precision: str | None = None) -> dict[str, str]:
    """Locate det/rec/cls ``.onnx`` files (shared precision-chain discovery).
    Returns a dict with any of the keys ``detection`` / ``recognition`` /
    ``classification`` (PP-OCR textline orientation, ``cls*.onnx``)."""
    return find_onnx_exports(
        model_dir,
        {"detection": "det", "recognition": "rec", "classification": "cls"},
        precision,
    )


def _ends_in_softmax(module: OnnxModule, output_name: str) -> bool:
    """True when the graph output is produced by a Softmax node (PP-OCR rec
    exports emit probabilities; torch CTC heads emit logits)."""
    for node in module.graph.nodes:
        if output_name in node.outputs:
            return node.op_type in ("Softmax", "LogSoftmax")
    return False


def _tensor(x, device) -> torch.Tensor:
    """A graph output as a device tensor (a static output is a constant)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x).to(device)


@dataclass
class DBNetGraph:
    """Detection graph: [B,3,H,W] normalized floats -> [B,H,W] prob map.

    PP-OCR det exports return a [B,1,H,W] sigmoid probability map; the
    adapter squeezes the channel to match the native DBNet contract.
    """

    module: OnnxModule

    @classmethod
    def from_path(cls, path: str) -> "DBNetGraph":
        return cls(module=OnnxModule.from_path(path))

    def __call__(self, params: dict, x_nchw: torch.Tensor) -> torch.Tensor:
        out = _tensor(self.module(params, {self.module.input_names[0]: x_nchw})[0], x_nchw.device)
        if out.ndim == 4:  # [B,1,H,W] or rarely [B,H,W,1]
            out = out[:, 0] if out.shape[1] == 1 else out[..., 0]
        return out.float()


@dataclass
class RecGraph:
    """Recognition graph: [B,3,H,W] normalized crops -> [B,T,V] CTC frames
    plus whether they are already softmax probabilities."""

    module: OnnxModule
    outputs_probs: bool

    @classmethod
    def from_path(cls, path: str) -> "RecGraph":
        module = OnnxModule.from_path(path)
        return cls(module=module, outputs_probs=_ends_in_softmax(module, module.output_names[0]))

    def __call__(self, params: dict, x_nchw: torch.Tensor) -> torch.Tensor:
        return _tensor(self.module(params, {self.module.input_names[0]: x_nchw})[0], x_nchw.device)


@dataclass
class ClsGraph:
    """Textline-orientation graph: [B,3,H,W] normalized crops -> [B,2]
    probabilities over (0deg, 180deg). PP-OCR's ``cls`` model (the
    reference declares the slot but never executes it —
    ``onnxrt_backend.py:73`` keeps ``cls_sess = None``; here it runs)."""

    module: OnnxModule
    outputs_probs: bool

    @classmethod
    def from_path(cls, path: str) -> "ClsGraph":
        module = OnnxModule.from_path(path)
        return cls(module=module, outputs_probs=_ends_in_softmax(module, module.output_names[0]))

    def __call__(self, params: dict, x_nchw: torch.Tensor) -> torch.Tensor:
        out = _tensor(self.module(params, {self.module.input_names[0]: x_nchw})[0], x_nchw.device)
        if not self.outputs_probs:
            out = torch.softmax(out.float(), dim=-1)
        return out.float()
