"""Plain PyTorch ops and the CUDA kernel wrappers of the port: attention
(the flash, cache and paged kernels), image ops, NMS, CTC, sampling (the
names of ``lumen_tpu/ops/__init__.py``).

Counterparts with another name or none: ``nms_torch`` stands for the JAX
``nms_jax``; the JAX flash dispatch gates (``flash_enabled``,
``flash_for_seq``, ``record_flash_ab``) have no twin, since a CUDA tensor
launches its kernel or raises (``ops.attention``); and the function
``attention`` stays ``ops.attention.attention``, since ``ops.attention``
is the module of the kernels' wrappers, counters and plans."""

from .attention import (
    attention_cached,
    attention_reference,
    flash_attention,
    flash_attention_cache,
    repeat_kv,
)
from .ctc import ctc_collapse, ctc_greedy_device, load_ctc_vocab
from .image import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    clip_preprocess,
    decode_image_bytes,
    letterbox_numpy,
    letterbox_params,
    normalize,
    resize_bilinear,
)
from .nms import nms_numpy, nms_torch
from .sampling import apply_repetition_penalty, greedy, sample, top_p_filter

__all__ = [
    "attention_cached",
    "attention_reference",
    "flash_attention",
    "flash_attention_cache",
    "repeat_kv",
    "ctc_greedy_device",
    "ctc_collapse",
    "load_ctc_vocab",
    "clip_preprocess",
    "decode_image_bytes",
    "letterbox_numpy",
    "letterbox_params",
    "normalize",
    "resize_bilinear",
    "OPENAI_CLIP_MEAN",
    "OPENAI_CLIP_STD",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "nms_torch",
    "nms_numpy",
    "greedy",
    "sample",
    "top_p_filter",
    "apply_repetition_penalty",
]
