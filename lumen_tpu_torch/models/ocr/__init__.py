"""OCR model family: DBNet detector + SVTR-style CTC recognizer, native
modules or PP-OCR ONNX packs on the bridge."""

from .convert import convert_ocr_checkpoint, flatten_variables, ocr_params_from_jax
from .manager import OcrManager, OcrResult, OcrSpec
from .modeling import (
    ClsConfig,
    DBNet,
    DBNetConfig,
    SVTRConfig,
    SVTRRecognizer,
    TextlineClassifier,
)
from .postprocess import (
    box_score_fast,
    boxes_from_prob_map,
    order_quad,
    rotate_crop,
    sorted_boxes,
    unclip_rect,
)

__all__ = [
    "OcrManager",
    "OcrResult",
    "OcrSpec",
    "DBNet",
    "DBNetConfig",
    "SVTRRecognizer",
    "SVTRConfig",
    "TextlineClassifier",
    "ClsConfig",
    "convert_ocr_checkpoint",
    "flatten_variables",
    "ocr_params_from_jax",
    "boxes_from_prob_map",
    "box_score_fast",
    "unclip_rect",
    "order_quad",
    "sorted_boxes",
    "rotate_crop",
]
