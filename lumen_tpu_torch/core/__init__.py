"""Core layer: configuration, model manifests, result schemas, resources.

The port's copy of ``lumen_tpu/core``: the counterpart of the reference's
``lumen-resources`` package.
"""

from .config import LumenConfig, ServiceConfig, ModelConfig, load_config
from .exceptions import (
    ConfigError,
    DownloadError,
    ModelInfoError,
    PlatformUnavailableError,
    ResourceError,
    ValidationError,
)
from .model_info import ModelInfo, load_model_info
from .result_schemas import (
    EmbeddingV1,
    FaceV1,
    LabelsV1,
    OCRV1,
    TextGenerationV1,
    schema_for,
    validate_result,
)

__all__ = [
    "LumenConfig",
    "ServiceConfig",
    "ModelConfig",
    "load_config",
    "ModelInfo",
    "load_model_info",
    "ResourceError",
    "ConfigError",
    "DownloadError",
    "ModelInfoError",
    "PlatformUnavailableError",
    "ValidationError",
    "EmbeddingV1",
    "FaceV1",
    "OCRV1",
    "LabelsV1",
    "TextGenerationV1",
    "schema_for",
    "validate_result",
]
