"""ONNX -> PyTorch bridge (the port of ``lumen_tpu/onnx_bridge``): load the
reference's ONNX model zoo (InsightFace SCRFD/ArcFace packs, exported CLIP
towers, PP-OCR det/rec) as eager torch forwards with a real params dict —
no onnxruntime, no foreign runtime in the serving path."""

from .discovery import find_onnx_exports
from .executor import OnnxModule
from .proto import OnnxGraph, load_onnx, parse_onnx

__all__ = ["OnnxModule", "OnnxGraph", "load_onnx", "parse_onnx", "find_onnx_exports"]
