"""VLM family of the port: ViT vision encoder + Qwen2-style decoder on the
paged continuous engine."""

from .chat import ChatMessage, VlmTokenizer, render_chat
from .continuous import ContinuousScheduler, PreemptionShed
from .convert import params_from_jax
from .generate import Generator
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
