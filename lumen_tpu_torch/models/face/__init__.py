"""Face model family: SCRFD-style detector + ArcFace embedder, native
modules or InsightFace ONNX packs on the bridge."""

from .convert import convert_face_checkpoint, face_params_from_jax, flatten_variables
from .manager import FaceDetection, FaceManager, FaceSpec
from .modeling import (
    ARCFACE_TEMPLATE,
    DetectorConfig,
    FaceDetector,
    IResNet,
    IResNetConfig,
    anchor_centers,
    decode_detections,
    distance2bbox,
    distance2kps,
)

__all__ = [
    "FaceManager",
    "FaceDetection",
    "FaceSpec",
    "FaceDetector",
    "DetectorConfig",
    "IResNet",
    "IResNetConfig",
    "ARCFACE_TEMPLATE",
    "anchor_centers",
    "decode_detections",
    "distance2bbox",
    "distance2kps",
    "convert_face_checkpoint",
    "face_params_from_jax",
    "flatten_variables",
]
