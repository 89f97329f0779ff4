"""Graph-backed face models: real InsightFace ONNX packs on the port's
bridge (the port of ``lumen_tpu/models/face/graph.py``).

The reference serves actual buffalo_l / antelopev2 SCRFD + ArcFace graphs
through onnxruntime (``packages/lumen-face/src/lumen_face/backends/
onnxrt_backend.py:485-1290``). Here the same ``.onnx`` files load through
``lumen_tpu_torch.onnx_bridge`` into eager torch forwards on the serving
device, so ``face_detect`` / ``face_embed`` produce the *same answers* as
the reference with the *same weights* — no invented backbone, no
conversion lossage.

SCRFD output contract (reference ``insightface_specs.py`` groups output
indices by TYPE): with ``fmc`` strides the graph emits
``[score_s0..score_s{fmc-1}, bbox_s0.., (kps_s0..)]``; scores are
post-sigmoid, bbox/kps are anchor distances in stride units. The adapter
regroups them per stride for ``decode_detections(scores_are_logits=False)``.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import torch

from ...onnx_bridge import OnnxModule

logger = logging.getLogger(__name__)

_DEFAULT_STRIDES = (8, 16, 32)


def find_onnx_models(model_dir: str) -> dict[str, str]:
    """Locate detector/recognizer ``.onnx`` files in a model dir (stock
    InsightFace pack layout: ``det_10g.onnx`` + ``w600k_r50.onnx``; native
    layout: ``detection.onnx`` + ``recognition.onnx``). Classification is
    by declared input size: recognizers take 112x112 crops."""
    found: dict[str, str] = {}
    for name in sorted(os.listdir(model_dir)):
        if not name.endswith(".onnx"):
            continue
        path = os.path.join(model_dir, name)
        stem = name.lower()
        if "rec" in stem or stem.startswith("w600k") or stem.startswith("glintr"):
            found.setdefault("recognition", path)
        elif "det" in stem or "scrfd" in stem:
            found.setdefault("detection", path)
        else:
            # fall back to input-shape sniffing
            try:
                mod = OnnxModule.from_path(path)
                shape = next(iter(mod.input_shapes().values()), ())
                hw = [d for d in shape[-2:] if isinstance(d, int)]
                key = "recognition" if hw and max(hw) <= 128 else "detection"
                found.setdefault(key, path)
            except Exception:  # noqa: BLE001 - unparseable file, skip
                logger.warning("skipping unparseable onnx file %s", path)
    return found


def _tensor(x, device) -> torch.Tensor:
    """A graph output as a device tensor (a static output is a constant)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x).to(device)


@dataclass
class ScrfdGraph:
    """SCRFD detector graph + output regrouping."""

    module: OnnxModule
    strides: tuple[int, ...]
    num_anchors: int
    with_kps: bool
    num_kps: int

    @classmethod
    def from_path(cls, path: str, num_anchors: int = 2) -> "ScrfdGraph":
        module = OnnxModule.from_path(path)
        n_out = len(module.output_names)
        if n_out % 3 == 0 and n_out >= 9:
            fmc = n_out // 3
            with_kps = True
        elif n_out % 2 == 0 and n_out >= 6:
            fmc = n_out // 2
            with_kps = False
        else:
            raise ValueError(
                f"unexpected SCRFD output count {n_out} in {path} "
                "(want fmc*2 or fmc*3 tensors)"
            )
        strides = _DEFAULT_STRIDES if fmc == 3 else tuple(8 * (2**i) for i in range(fmc))
        return cls(
            module=module,
            strides=strides,
            num_anchors=num_anchors,
            with_kps=with_kps,
            num_kps=5,
        )

    def __call__(self, params: dict, x_nchw: torch.Tensor) -> dict[int, dict]:
        """Run the graph; regroup outputs as ``{stride: {scores [B,M],
        bbox [B,M,4], kps [B,M,2K]}}`` for ``decode_detections``. Exports
        that drop the batch dim of their outputs regroup by ``b``."""
        outs = self.module(params, {self.module.input_names[0]: x_nchw})
        fmc = len(self.strides)
        b = x_nchw.shape[0]
        dev = x_nchw.device
        per_stride: dict[int, dict] = {}
        for i, stride in enumerate(self.strides):
            scores = _tensor(outs[i], dev).reshape(b, -1)
            bbox = _tensor(outs[fmc + i], dev).reshape(b, -1, 4)
            if self.with_kps:
                kps = _tensor(outs[2 * fmc + i], dev).reshape(b, -1, 2 * self.num_kps)
            else:
                kps = torch.zeros(bbox.shape[:2] + (2 * self.num_kps,), dtype=bbox.dtype, device=dev)
            per_stride[stride] = {"scores": scores, "bbox": bbox, "kps": kps}
        return per_stride


@dataclass
class ArcFaceGraph:
    """Recognition graph: [B,3,112,112] -> [B,512] (normalization is the
    manager's job, matching the native path)."""

    module: OnnxModule

    @classmethod
    def from_path(cls, path: str) -> "ArcFaceGraph":
        return cls(module=OnnxModule.from_path(path))

    def __call__(self, params: dict, x_nchw: torch.Tensor) -> torch.Tensor:
        out = self.module(params, {self.module.input_names[0]: x_nchw})[0]
        return _tensor(out, x_nchw.device)
