"""CLIP model family: PyTorch towers, checkpoint conversion, manager."""

from .convert import clip_params_from_jax, convert_clip_checkpoint, convert_hf_clip, convert_openclip
from .manager import SCENE_LABELS, CLIPManager
from .modeling import CLIPConfig, CLIPModel, TowerConfig
from .tokenizer import ClipTokenizer

__all__ = [
    "CLIPConfig",
    "CLIPModel",
    "TowerConfig",
    "CLIPManager",
    "SCENE_LABELS",
    "ClipTokenizer",
    "clip_params_from_jax",
    "convert_clip_checkpoint",
    "convert_hf_clip",
    "convert_openclip",
]
