"""Checkpoint conversion for the port's ``VLMModel``: HF/FastVLM-named and
native (flax-flattened) checkpoints, the JAX package's Flax tree (the
tests' path), and the int8 quantization of the decoder's projections.

``convert_vlm_checkpoint`` (JAX ``convert.py:157``) renames a checkpoint
with the JAX package's own rule tables (copied below) into the Flax tree
layout, then ``state_from_tree`` lays that tree out for the port:
``nn.Linear`` weights are ``[out, in]``, so every Flax ``Dense`` kernel
(``[in, out]``) is transposed; the patch embedding's HWIO conv kernel
``[P, P, C, W]`` flattens to ``[W, P*P*C]``. Norm ``scale`` and embedding
``embedding`` leaves become ``weight``; ``layers_<i>`` / ``blocks_<i>``
become ``layers.<i>`` / ``blocks.<i>``. A ``QDense`` (int8) module keeps
its leaves as they are: ``q`` int8 ``[in, out]``, ``scale`` fp32
``[out]`` -- the port's ``QDense`` has the JAX layout. Tensors keep the
dtype they were stored in. ``export_hf_checkpoint`` is the inverse for
the dense model: a port ``state_dict`` under the HF/FastVLM names.

Not ported: the Qwen2-MoE rules (``MoEFFN`` is not ported); a checkpoint
with MoE layers raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import re
from typing import Mapping

import numpy as np
import torch

from ...ops.quant import quantize_state_int8
from ...runtime.weights import (
    apply_rules,
    conv_kernel,
    is_native_checkpoint,
    linear_kernel,
    split_collections,
    unflatten,
)

_INDEXED = re.compile(r"^(layers|blocks)_(\d+)$")
_RENAME = {"scale": "weight", "embedding": "weight", "kernel": "weight"}

#: decoder projections ``QDense`` replaces when ``weight_quant="int8"``
#: (JAX ``_QUANT_KERNEL``): attention q/k/v/o, SwiGLU gate/up/down and an
#: untied lm_head. Embeddings and norms stay in the policy dtype.
_QUANT_WEIGHT = re.compile(
    r"^decoder\..*(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj|lm_head)\.weight$"
)

_QKV = r"(q_proj|k_proj|v_proj)"

#: the JAX package's ``DECODER_RULES`` without the Qwen2-MoE entries
DECODER_RULES = [
    (r"model\.embed_tokens\.weight", r"decoder/embed_tokens/embedding", None),
    (rf"model\.layers\.(\d+)\.self_attn\.{_QKV}\.weight", r"decoder/layers_\1/attn/\2/kernel", linear_kernel),
    (rf"model\.layers\.(\d+)\.self_attn\.{_QKV}\.bias", r"decoder/layers_\1/attn/\2/bias", None),
    (r"model\.layers\.(\d+)\.self_attn\.o_proj\.weight", r"decoder/layers_\1/attn/o_proj/kernel", linear_kernel),
    (r"model\.layers\.(\d+)\.mlp\.gate_proj\.weight", r"decoder/layers_\1/mlp/gate_proj/kernel", linear_kernel),
    (r"model\.layers\.(\d+)\.mlp\.up_proj\.weight", r"decoder/layers_\1/mlp/up_proj/kernel", linear_kernel),
    (r"model\.layers\.(\d+)\.mlp\.down_proj\.weight", r"decoder/layers_\1/mlp/down_proj/kernel", linear_kernel),
    (r"model\.layers\.(\d+)\.input_layernorm\.weight", r"decoder/layers_\1/input_norm/scale", None),
    (r"model\.layers\.(\d+)\.post_attention_layernorm\.weight", r"decoder/layers_\1/post_attn_norm/scale", None),
    (r"model\.norm\.weight", r"decoder/final_norm/scale", None),
    (r"lm_head\.weight", r"decoder/lm_head/kernel", linear_kernel),
]

#: checkpoint keys of Qwen2-MoE layers (router, experts, shared expert)
_MOE_KEY = re.compile(r"model\.layers\.\d+\.mlp\.(gate|experts\.\d+|shared_expert|shared_expert_gate)\.")

VISION_RULES = [
    (r"vision_tower\.patch_embed\.weight", r"vision/patch_embed/kernel", conv_kernel),
    (r"vision_tower\.patch_embed\.bias", r"vision/patch_embed/bias", None),
    (r"vision_tower\.position_embedding", r"vision/position_embedding", None),
    (rf"vision_tower\.blocks\.(\d+)\.attn\.{_QKV}\.weight", r"vision/blocks_\1/attn/\2/kernel", linear_kernel),
    (rf"vision_tower\.blocks\.(\d+)\.attn\.{_QKV}\.bias", r"vision/blocks_\1/attn/\2/bias", None),
    (r"vision_tower\.blocks\.(\d+)\.attn\.out_proj\.weight", r"vision/blocks_\1/attn/out_proj/kernel", linear_kernel),
    (r"vision_tower\.blocks\.(\d+)\.attn\.out_proj\.bias", r"vision/blocks_\1/attn/out_proj/bias", None),
    (r"vision_tower\.blocks\.(\d+)\.norm1\.weight", r"vision/blocks_\1/ln1/scale", None),
    (r"vision_tower\.blocks\.(\d+)\.norm1\.bias", r"vision/blocks_\1/ln1/bias", None),
    (r"vision_tower\.blocks\.(\d+)\.norm2\.weight", r"vision/blocks_\1/ln2/scale", None),
    (r"vision_tower\.blocks\.(\d+)\.norm2\.bias", r"vision/blocks_\1/ln2/bias", None),
    (r"vision_tower\.blocks\.(\d+)\.mlp\.fc1\.weight", r"vision/blocks_\1/mlp/fc1/kernel", linear_kernel),
    (r"vision_tower\.blocks\.(\d+)\.mlp\.fc1\.bias", r"vision/blocks_\1/mlp/fc1/bias", None),
    (r"vision_tower\.blocks\.(\d+)\.mlp\.fc2\.weight", r"vision/blocks_\1/mlp/fc2/kernel", linear_kernel),
    (r"vision_tower\.blocks\.(\d+)\.mlp\.fc2\.bias", r"vision/blocks_\1/mlp/fc2/bias", None),
    (r"vision_tower\.post_norm\.weight", r"vision/post_ln/scale", None),
    (r"vision_tower\.post_norm\.bias", r"vision/post_ln/bias", None),
    (r"multi_modal_projector\.linear_1\.weight", r"vision/proj_fc1/kernel", linear_kernel),
    (r"multi_modal_projector\.linear_1\.bias", r"vision/proj_fc1/bias", None),
    (r"multi_modal_projector\.linear_2\.weight", r"vision/proj_fc2/kernel", linear_kernel),
    (r"multi_modal_projector\.linear_2\.bias", r"vision/proj_fc2/bias", None),
    # HF-CLIP-style vision tower naming (llava checkpoints that embed a
    # CLIPVisionModel): map encoder layers onto the same block tree.
    (r"vision_tower\.vision_model\.embeddings\.patch_embedding\.weight", r"vision/patch_embed/kernel", conv_kernel),
    (r"vision_tower\.vision_model\.embeddings\.patch_embedding\.bias", r"vision/patch_embed/bias", None),
    (r"vision_tower\.vision_model\.embeddings\.position_embedding\.weight", r"vision/position_embedding", None),
    (rf"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.self_attn\.{_QKV}\.weight", r"vision/blocks_\1/attn/\2/kernel", linear_kernel),
    (rf"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.self_attn\.{_QKV}\.bias", r"vision/blocks_\1/attn/\2/bias", None),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.weight", r"vision/blocks_\1/attn/out_proj/kernel", linear_kernel),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.bias", r"vision/blocks_\1/attn/out_proj/bias", None),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.weight", r"vision/blocks_\1/ln1/scale", None),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.bias", r"vision/blocks_\1/ln1/bias", None),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.weight", r"vision/blocks_\1/ln2/scale", None),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.bias", r"vision/blocks_\1/ln2/bias", None),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.weight", r"vision/blocks_\1/mlp/fc1/kernel", linear_kernel),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.bias", r"vision/blocks_\1/mlp/fc1/bias", None),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.weight", r"vision/blocks_\1/mlp/fc2/kernel", linear_kernel),
    (r"vision_tower\.vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.bias", r"vision/blocks_\1/mlp/fc2/bias", None),
    (r"vision_tower\.vision_model\.post_layernorm\.weight", r"vision/post_ln/scale", None),
    (r"vision_tower\.vision_model\.post_layernorm\.bias", r"vision/post_ln/bias", None),
]

DROP = [
    r"rotary_emb\.inv_freq$",
    r"position_ids$",
    r"vision_tower\.vision_model\.embeddings\.class_embedding",
    r"vision_tower\.vision_model\.pre_layrnorm\.",
]

#: port ``state_dict`` name -> HF/FastVLM name, the inverse of the first
#: matching rule above for every dense-model parameter
_HF_NAMES = [
    (r"decoder\.embed_tokens\.weight", r"model.embed_tokens.weight"),
    (r"decoder\.layers\.(\d+)\.attn\.(\w+)\.(weight|bias)", r"model.layers.\1.self_attn.\2.\3"),
    (r"decoder\.layers\.(\d+)\.mlp\.(\w+)\.weight", r"model.layers.\1.mlp.\2.weight"),
    (r"decoder\.layers\.(\d+)\.input_norm\.weight", r"model.layers.\1.input_layernorm.weight"),
    (r"decoder\.layers\.(\d+)\.post_attn_norm\.weight", r"model.layers.\1.post_attention_layernorm.weight"),
    (r"decoder\.final_norm\.weight", r"model.norm.weight"),
    (r"decoder\.lm_head\.weight", r"lm_head.weight"),
    (r"vision\.(patch_embed\.\w+|position_embedding|blocks\.\d+\.(attn|mlp)\.\w+\.\w+)", r"vision_tower.\1"),
    (r"vision\.blocks\.(\d+)\.ln([12])\.(weight|bias)", r"vision_tower.blocks.\1.norm\2.\3"),
    (r"vision\.post_ln\.(weight|bias)", r"vision_tower.post_norm.\1"),
    (r"vision\.proj_fc([12])\.(weight|bias)", r"multi_modal_projector.linear_\1.\2"),
]


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_from_tree(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax-layout params tree (torch tensor leaves, kept in their dtype)
    -> ``state_dict`` of the port's ``VLMModel``."""
    leaves = list(_flatten(tree))
    quantized = {path[:-1] for path, _ in leaves if path[-1] == "q"}
    out: dict[str, torch.Tensor] = {}
    for path, t in leaves:
        *parents, name = path
        if tuple(parents) not in quantized:
            if name == "kernel":
                t = t.reshape(-1, t.shape[-1]).t()  # [in..., out] -> [out, in]
            name = _RENAME.get(name, name)
        parents = [".".join(m.groups()) if (m := _INDEXED.match(p)) else p for p in parents]
        out[".".join(parents + [name])] = t.contiguous()
    return out


def params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``params`` tree of the JAX ``VLMModel`` (leaves as numpy or
    anything ``np.asarray`` takes) -> ``state_dict`` of the port's
    ``VLMModel``: float leaves in float32, ``QDense`` leaves as they are."""
    leaves = list(_flatten(flax_params))
    quantized = {path[:-1] for path, _ in leaves if path[-1] == "q"}
    tree: dict = {}
    for path, leaf in leaves:
        *parents, name = path
        dtype = np.int8 if tuple(parents) in quantized and name == "q" else np.float32
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = torch.tensor(np.asarray(leaf, dtype=dtype))
    return state_from_tree(tree)


def convert_vlm_checkpoint(
    state: Mapping[str, torch.Tensor], tie_word_embeddings: bool = True
) -> dict[str, torch.Tensor]:
    """A loaded checkpoint (``runtime.weights.load_state_dict``) -> the
    port's ``state_dict``, which ``VLMModel.load_state_dict(strict=True)``
    takes. Native (``params/``-pathed) checkpoints are the JAX package's
    Flax tree; HF/FastVLM names go through the rename rules after the
    JAX converter's prefix normalization (``language_model.`` wrappers,
    ``model.vision_tower.``)."""
    if is_native_checkpoint(state):
        return state_from_tree(split_collections(dict(state))["params"])
    normalized: dict[str, torch.Tensor] = {}
    for key, val in state.items():
        key = key.removeprefix("language_model.")
        if key.startswith("model.vision_tower."):
            key = key.removeprefix("model.")
        if _MOE_KEY.match(key):
            raise NotImplementedError(
                f"checkpoint has Qwen2-MoE layers ({key}); MoEFFN is not ported to lumen_tpu_torch yet"
            )
        normalized[key] = val
    drop = list(DROP)
    if tie_word_embeddings:
        drop.append(r"^lm_head\.weight$")
    return state_from_tree(unflatten(apply_rules(normalized, DECODER_RULES + VISION_RULES, drop=drop)))


def export_hf_checkpoint(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A dense port ``state_dict`` under the HF/FastVLM names
    ``convert_vlm_checkpoint`` reads (its inverse): linear weights are
    ``[out, in]`` in both, the patch embedding goes back to an OIHW conv
    weight."""
    rules = [(re.compile(p), t) for p, t in _HF_NAMES]
    out: dict[str, torch.Tensor] = {}
    for key, t in state.items():
        for pat, template in rules:
            if m := pat.fullmatch(key):
                break
        else:
            raise KeyError(f"no HF name for {key!r}")
        if key == "vision.patch_embed.weight":  # [W, P*P*C] (row, column, channel) -> OIHW
            width, n = t.shape
            p = math.isqrt(n // 3)
            t = t.reshape(width, p, p, 3).permute(0, 3, 1, 2)
        out[m.expand(template)] = t.contiguous()
    return out


def quantize_decoder_int8(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Weight-only int8 for the decoder's projections (JAX
    ``quantize_decoder_int8``): each matching ``weight`` becomes ``q`` +
    ``scale`` (see ``ops.quant.quantize_linear_int8``). Apply AFTER the
    dtype-policy cast; the vision tower is never quantized."""
    return quantize_state_int8(state, _QUANT_WEIGHT)
