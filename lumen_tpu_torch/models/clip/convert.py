"""Checkpoint conversion for the port's ``CLIPModel``: HF transformers
CLIP, ChineseCLIP (CN-CLIP) and OpenCLIP ``state_dict``s, and the JAX
package's Flax tree (the tests' path).

``convert_clip_checkpoint`` (JAX ``convert.py:192``) renames a checkpoint
with the JAX package's own rule tables (copied below) into the Flax tree
layout, then ``models/vlm/convert.state_from_tree`` lays that tree out for
the port (Dense kernels transposed to ``nn.Linear``'s ``[out, in]``, the
patch embedding's HWIO conv kernel flattened to ``[W, P*P*C]``, norm
``scale`` / embedding ``embedding`` leaves renamed ``weight``). The port's
gate is ``CLIPModel.load_state_dict(strict=True)``: names AND shapes must
match before any weight is served. ``quantize_clip_int8`` turns the
block projections of a cast ``state_dict`` into ``QDense``'s ``q`` +
``scale`` (JAX ``quantize_clip_int8``).
"""

from __future__ import annotations

import logging
import re
from typing import Mapping

import numpy as np
import torch

from ...ops.quant import quantize_state_int8
from ...runtime.weights import apply_rules, conv_kernel, linear_kernel, unflatten
from ..vlm.convert import state_from_tree

logger = logging.getLogger(__name__)

_ATTN = r"(q_proj|k_proj|v_proj)"

HF_RULES = [
    # text tower
    (r"text_model\.embeddings\.token_embedding\.weight", r"text/token_embedding/embedding", None),
    (r"text_model\.embeddings\.position_embedding\.weight", r"text/position_embedding", None),
    (rf"text_model\.encoder\.layers\.(\d+)\.self_attn\.{_ATTN}\.weight", r"text/blocks_\1/attn/\2/kernel", linear_kernel),
    (rf"text_model\.encoder\.layers\.(\d+)\.self_attn\.{_ATTN}\.bias", r"text/blocks_\1/attn/\2/bias", None),
    (r"text_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.weight", r"text/blocks_\1/attn/out_proj/kernel", linear_kernel),
    (r"text_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.bias", r"text/blocks_\1/attn/out_proj/bias", None),
    (r"text_model\.encoder\.layers\.(\d+)\.layer_norm1\.weight", r"text/blocks_\1/ln1/scale", None),
    (r"text_model\.encoder\.layers\.(\d+)\.layer_norm1\.bias", r"text/blocks_\1/ln1/bias", None),
    (r"text_model\.encoder\.layers\.(\d+)\.layer_norm2\.weight", r"text/blocks_\1/ln2/scale", None),
    (r"text_model\.encoder\.layers\.(\d+)\.layer_norm2\.bias", r"text/blocks_\1/ln2/bias", None),
    (r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.weight", r"text/blocks_\1/mlp/fc1/kernel", linear_kernel),
    (r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.bias", r"text/blocks_\1/mlp/fc1/bias", None),
    (r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.weight", r"text/blocks_\1/mlp/fc2/kernel", linear_kernel),
    (r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.bias", r"text/blocks_\1/mlp/fc2/bias", None),
    (r"text_model\.final_layer_norm\.weight", r"text/final_ln/scale", None),
    (r"text_model\.final_layer_norm\.bias", r"text/final_ln/bias", None),
    (r"text_projection\.weight", r"text/projection/kernel", linear_kernel),
    # vision tower ("pre_layrnorm" is HF's actual key spelling)
    (r"vision_model\.embeddings\.class_embedding", r"vision/class_embedding", None),
    (r"vision_model\.embeddings\.patch_embedding\.weight", r"vision/patch_embed/kernel", conv_kernel),
    (r"vision_model\.embeddings\.position_embedding\.weight", r"vision/position_embedding", None),
    (r"vision_model\.pre_layrnorm\.weight", r"vision/pre_ln/scale", None),
    (r"vision_model\.pre_layrnorm\.bias", r"vision/pre_ln/bias", None),
    (rf"vision_model\.encoder\.layers\.(\d+)\.self_attn\.{_ATTN}\.weight", r"vision/blocks_\1/attn/\2/kernel", linear_kernel),
    (rf"vision_model\.encoder\.layers\.(\d+)\.self_attn\.{_ATTN}\.bias", r"vision/blocks_\1/attn/\2/bias", None),
    (r"vision_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.weight", r"vision/blocks_\1/attn/out_proj/kernel", linear_kernel),
    (r"vision_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.bias", r"vision/blocks_\1/attn/out_proj/bias", None),
    (r"vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.weight", r"vision/blocks_\1/ln1/scale", None),
    (r"vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.bias", r"vision/blocks_\1/ln1/bias", None),
    (r"vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.weight", r"vision/blocks_\1/ln2/scale", None),
    (r"vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.bias", r"vision/blocks_\1/ln2/bias", None),
    (r"vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.weight", r"vision/blocks_\1/mlp/fc1/kernel", linear_kernel),
    (r"vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.bias", r"vision/blocks_\1/mlp/fc1/bias", None),
    (r"vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.weight", r"vision/blocks_\1/mlp/fc2/kernel", linear_kernel),
    (r"vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.bias", r"vision/blocks_\1/mlp/fc2/bias", None),
    (r"vision_model\.post_layernorm\.weight", r"vision/post_ln/scale", None),
    (r"vision_model\.post_layernorm\.bias", r"vision/post_ln/bias", None),
    (r"visual_projection\.weight", r"vision/projection/kernel", linear_kernel),
    (r"logit_scale", r"logit_scale", None),
]

HF_DROP = [r"position_ids$", r"logit_bias"]


def convert_hf_clip(state: Mapping[str, torch.Tensor]) -> dict:
    """HF ``CLIPModel`` names -> the Flax tree (torch leaves)."""
    return unflatten(apply_rules(dict(state), HF_RULES, drop=HF_DROP))


# -- ChineseCLIP (CN-CLIP) --------------------------------------------------
# BERT text encoder ("encoder.layer.N.attention.self.query" naming) + the
# standard HF CLIP vision tower. Reference loads these through the
# ChineseCLIPModel torch path (``torch_backend.py:340-393``).

_VISION_AND_SCALE_RULES = [r for r in HF_RULES if r[0].startswith(("vision", "visual", "logit"))]

CNCLIP_RULES = [
    (r"text_model\.embeddings\.word_embeddings\.weight", r"text/word_embeddings/embedding", None),
    (r"text_model\.embeddings\.position_embeddings\.weight", r"text/position_embedding", None),
    (r"text_model\.embeddings\.token_type_embeddings\.weight", r"text/token_type_embedding", None),
    (r"text_model\.embeddings\.LayerNorm\.weight", r"text/embed_ln/scale", None),
    (r"text_model\.embeddings\.LayerNorm\.bias", r"text/embed_ln/bias", None),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.self\.query\.weight", r"text/blocks_\1/attn/q_proj/kernel", linear_kernel),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.self\.query\.bias", r"text/blocks_\1/attn/q_proj/bias", None),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.self\.key\.weight", r"text/blocks_\1/attn/k_proj/kernel", linear_kernel),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.self\.key\.bias", r"text/blocks_\1/attn/k_proj/bias", None),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.self\.value\.weight", r"text/blocks_\1/attn/v_proj/kernel", linear_kernel),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.self\.value\.bias", r"text/blocks_\1/attn/v_proj/bias", None),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.output\.dense\.weight", r"text/blocks_\1/attn/out_proj/kernel", linear_kernel),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.output\.dense\.bias", r"text/blocks_\1/attn/out_proj/bias", None),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.output\.LayerNorm\.weight", r"text/blocks_\1/ln1/scale", None),
    (r"text_model\.encoder\.layer\.(\d+)\.attention\.output\.LayerNorm\.bias", r"text/blocks_\1/ln1/bias", None),
    (r"text_model\.encoder\.layer\.(\d+)\.intermediate\.dense\.weight", r"text/blocks_\1/mlp/fc1/kernel", linear_kernel),
    (r"text_model\.encoder\.layer\.(\d+)\.intermediate\.dense\.bias", r"text/blocks_\1/mlp/fc1/bias", None),
    (r"text_model\.encoder\.layer\.(\d+)\.output\.dense\.weight", r"text/blocks_\1/mlp/fc2/kernel", linear_kernel),
    (r"text_model\.encoder\.layer\.(\d+)\.output\.dense\.bias", r"text/blocks_\1/mlp/fc2/bias", None),
    (r"text_model\.encoder\.layer\.(\d+)\.output\.LayerNorm\.weight", r"text/blocks_\1/ln2/scale", None),
    (r"text_model\.encoder\.layer\.(\d+)\.output\.LayerNorm\.bias", r"text/blocks_\1/ln2/bias", None),
    (r"text_projection\.weight", r"text/projection/kernel", linear_kernel),
] + _VISION_AND_SCALE_RULES

CNCLIP_DROP = [r"position_ids$", r"text_model\.pooler\."]


def convert_cnclip(state: Mapping[str, torch.Tensor]) -> dict:
    return unflatten(apply_rules(dict(state), CNCLIP_RULES, drop=CNCLIP_DROP))


# -- OpenCLIP ---------------------------------------------------------------

OPENCLIP_RULES = [
    (r"visual\.class_embedding", r"vision/class_embedding", None),
    (r"visual\.conv1\.weight", r"vision/patch_embed/kernel", conv_kernel),
    (r"visual\.positional_embedding", r"vision/position_embedding", None),
    (r"visual\.ln_pre\.weight", r"vision/pre_ln/scale", None),
    (r"visual\.ln_pre\.bias", r"vision/pre_ln/bias", None),
    (rf"visual\.transformer\.resblocks\.(\d+)\.attn\.{_ATTN}\.weight", r"vision/blocks_\1/attn/\2/kernel", linear_kernel),
    (rf"visual\.transformer\.resblocks\.(\d+)\.attn\.{_ATTN}\.bias", r"vision/blocks_\1/attn/\2/bias", None),
    (r"visual\.transformer\.resblocks\.(\d+)\.attn\.out_proj\.weight", r"vision/blocks_\1/attn/out_proj/kernel", linear_kernel),
    (r"visual\.transformer\.resblocks\.(\d+)\.attn\.out_proj\.bias", r"vision/blocks_\1/attn/out_proj/bias", None),
    (r"visual\.transformer\.resblocks\.(\d+)\.ln_1\.weight", r"vision/blocks_\1/ln1/scale", None),
    (r"visual\.transformer\.resblocks\.(\d+)\.ln_1\.bias", r"vision/blocks_\1/ln1/bias", None),
    (r"visual\.transformer\.resblocks\.(\d+)\.ln_2\.weight", r"vision/blocks_\1/ln2/scale", None),
    (r"visual\.transformer\.resblocks\.(\d+)\.ln_2\.bias", r"vision/blocks_\1/ln2/bias", None),
    (r"visual\.transformer\.resblocks\.(\d+)\.mlp\.c_fc\.weight", r"vision/blocks_\1/mlp/fc1/kernel", linear_kernel),
    (r"visual\.transformer\.resblocks\.(\d+)\.mlp\.c_fc\.bias", r"vision/blocks_\1/mlp/fc1/bias", None),
    (r"visual\.transformer\.resblocks\.(\d+)\.mlp\.c_proj\.weight", r"vision/blocks_\1/mlp/fc2/kernel", linear_kernel),
    (r"visual\.transformer\.resblocks\.(\d+)\.mlp\.c_proj\.bias", r"vision/blocks_\1/mlp/fc2/bias", None),
    (r"visual\.ln_post\.weight", r"vision/post_ln/scale", None),
    (r"visual\.ln_post\.bias", r"vision/post_ln/bias", None),
    # [width, embed_dim] already in jax orientation
    (r"visual\.proj", r"vision/projection/kernel", None),
    (r"token_embedding\.weight", r"text/token_embedding/embedding", None),
    (r"positional_embedding", r"text/position_embedding", None),
    (rf"transformer\.resblocks\.(\d+)\.attn\.{_ATTN}\.weight", r"text/blocks_\1/attn/\2/kernel", linear_kernel),
    (rf"transformer\.resblocks\.(\d+)\.attn\.{_ATTN}\.bias", r"text/blocks_\1/attn/\2/bias", None),
    (r"transformer\.resblocks\.(\d+)\.attn\.out_proj\.weight", r"text/blocks_\1/attn/out_proj/kernel", linear_kernel),
    (r"transformer\.resblocks\.(\d+)\.attn\.out_proj\.bias", r"text/blocks_\1/attn/out_proj/bias", None),
    (r"transformer\.resblocks\.(\d+)\.ln_1\.weight", r"text/blocks_\1/ln1/scale", None),
    (r"transformer\.resblocks\.(\d+)\.ln_1\.bias", r"text/blocks_\1/ln1/bias", None),
    (r"transformer\.resblocks\.(\d+)\.ln_2\.weight", r"text/blocks_\1/ln2/scale", None),
    (r"transformer\.resblocks\.(\d+)\.ln_2\.bias", r"text/blocks_\1/ln2/bias", None),
    (r"transformer\.resblocks\.(\d+)\.mlp\.c_fc\.weight", r"text/blocks_\1/mlp/fc1/kernel", linear_kernel),
    (r"transformer\.resblocks\.(\d+)\.mlp\.c_fc\.bias", r"text/blocks_\1/mlp/fc1/bias", None),
    (r"transformer\.resblocks\.(\d+)\.mlp\.c_proj\.weight", r"text/blocks_\1/mlp/fc2/kernel", linear_kernel),
    (r"transformer\.resblocks\.(\d+)\.mlp\.c_proj\.bias", r"text/blocks_\1/mlp/fc2/bias", None),
    (r"ln_final\.weight", r"text/final_ln/scale", None),
    (r"ln_final\.bias", r"text/final_ln/bias", None),
    (r"text_projection", r"text/projection/kernel", None),
    (r"logit_scale", r"logit_scale", None),
]

OPENCLIP_DROP = [r"attn_mask", r"\.attn\.in_proj_(weight|bias)$"]


def _split_fused_qkv(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """OpenCLIP fuses qkv as ``attn.in_proj_weight`` [3*width, width]; split
    into the separate projections our module (and HF) use."""
    out = dict(state)
    for key in list(state):
        if key.endswith("attn.in_proj_weight"):
            prefix = key[: -len("in_proj_weight")]
            for name, part in zip("qkv", torch.chunk(state[key], 3, dim=0)):
                out[f"{prefix}{name}_proj.weight"] = part
        elif key.endswith("attn.in_proj_bias"):
            prefix = key[: -len("in_proj_bias")]
            for name, part in zip("qkv", torch.chunk(state[key], 3, dim=0)):
                out[f"{prefix}{name}_proj.bias"] = part
    return out


def convert_openclip(state: Mapping[str, torch.Tensor]) -> dict:
    return unflatten(apply_rules(_split_fused_qkv(state), OPENCLIP_RULES, drop=OPENCLIP_DROP))


def convert_clip_checkpoint(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Sniff the checkpoint family, convert, and lay the tree out as the
    port's ``CLIPModel`` ``state_dict`` (tensors keep their stored dtype)."""
    if any(k.startswith("text_model.encoder.layer.") for k in state):
        # BERT-style text encoder ("layer", not "layers") = ChineseCLIP.
        tree = convert_cnclip(state)
    elif any(k.startswith(("text_model.", "vision_model.")) for k in state):
        tree = convert_hf_clip(state)
    elif any(k.startswith(("visual.", "transformer.")) for k in state):
        tree = convert_openclip(state)
    else:
        raise ValueError(
            f"unrecognized CLIP checkpoint family (keys like: {sorted(state)[:5]})"
        )
    return state_from_tree(tree)


def clip_params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``params`` tree of the JAX ``CLIPModel`` (leaves as numpy or
    anything ``np.asarray`` takes) -> ``state_dict`` of the port's
    ``CLIPModel``: float leaves in float32, ``QDense``'s ``q`` in int8."""

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        a = np.asarray(node)
        return torch.tensor(a if a.dtype == np.int8 else np.asarray(a, dtype=np.float32))

    return state_from_tree(walk(flax_params))


def _clip_quant_pattern(towers: str) -> re.Pattern:
    """The block projections ``QDense`` replaces when ``weight_quant="int8"``
    (JAX ``_clip_quant_pattern``), in the port's ``state_dict`` names."""
    return re.compile(rf"^({towers})\.blocks\.\d+\.(attn\.(q|k|v|out)_proj|mlp\.fc[12])\.weight$")


_CLIP_QUANT_WEIGHT = _clip_quant_pattern("vision|text")
_CLIP_QUANT_WEIGHT_VISION_ONLY = _clip_quant_pattern("vision")


def quantize_clip_int8(state: Mapping[str, torch.Tensor], include_text: bool = True) -> dict[str, torch.Tensor]:
    """The CLIP towers' block projections as per-output-channel int8
    (``ops.quant.quantize_linear_int8``; JAX ``quantize_clip_int8``). Apply
    AFTER the dtype-policy cast. ``include_text=False`` keeps the text
    tower in full precision: BERT-text models (ChineseCLIP), whose blocks
    have no ``QDense``."""
    return quantize_state_int8(state, _CLIP_QUANT_WEIGHT if include_text else _CLIP_QUANT_WEIGHT_VISION_ONLY)
