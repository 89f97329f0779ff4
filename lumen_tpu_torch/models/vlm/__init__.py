"""VLM family of the port: a native ViT or an exported (ONNX) vision tower
+ Qwen2-style decoder, on the paged continuous engine or the coalescing
scheduler."""

from .chat import ChatMessage, VlmTokenizer, render_chat
from .continuous import ContinuousScheduler, PreemptionShed
from .convert import params_from_jax
from .generate import GenerateOutput, Generator
from .manager import GenerationChunk, GenerationResult, VLMManager
from .modeling import (
    DecoderConfig,
    VisionTowerConfig,
    VLMConfig,
    VLMModel,
    init_kv_cache,
    init_paged_kv_cache,
    init_random_,
    merge_image_embeddings,
)

__all__ = [
    "ChatMessage",
    "VlmTokenizer",
    "render_chat",
    "ContinuousScheduler",
    "PreemptionShed",
    "params_from_jax",
    "GenerateOutput",
    "Generator",
    "GenerationChunk",
    "GenerationResult",
    "VLMManager",
    "DecoderConfig",
    "VisionTowerConfig",
    "VLMConfig",
    "VLMModel",
    "init_kv_cache",
    "init_paged_kv_cache",
    "init_random_",
    "merge_image_embeddings",
]
