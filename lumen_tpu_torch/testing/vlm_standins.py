"""Seeded VLM stand-ins and the model directories they are served from:
the dense Qwen2 decoder of ``VLMConfig()`` and a Qwen2-MoE decoder at
Qwen1.5-MoE-A2.7B's widths (:func:`qwen15_moe_a27b`), each behind the
native ViT tower.

No checkpoint ships with the repository and there is no network, so the
serving checks run on seeded weights. :func:`write_model_dir` lays one out
as the loader reads a model directory: ``model.safetensors`` under the
HF/FastVLM names (a MoE layer's under the HF ``Qwen2MoeForCausalLM``
names: ``mlp.gate``, ``mlp.experts.<i>.*``, ``mlp.shared_expert.*``,
``mlp.shared_expert_gate``), ``config.json`` (LLaVA-style ``text_config``
with the Qwen2-MoE keys + ``vision_config``), a WordLevel
``tokenizer.json`` of every id, a chat template and ``model_info.json``.
:func:`seeded_state` makes the weights in the serving dtype on the device
directly: at Qwen1.5-MoE-A2.7B's 14.3B parameters an fp32 model (57 GB)
and its bf16 copy would not fit one 80 GB card together.
"""

from __future__ import annotations

import json
from pathlib import Path

#: words the tokenizer knows besides its ``w<id>`` filler tokens
WORDS = ("user", "assistant", "describe", "this", "photo", "in", "one", "detailed", "sentence", "caption",
         "image", "a", "red", "car", "on", "wet", "road")

CHAT_TEMPLATE = (
    "{% for m in messages %}<|im_start|>{{ m.role }}\n{{ m.content }}<|im_end|>\n{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


def qwen15_moe_a27b(layers: int = 24):
    """``VLMConfig()`` with the decoder at Qwen1.5-MoE-A2.7B's widths (the
    ``config.json`` of ``Qwen/Qwen1.5-MoE-A2.7B``; the defaults of HF's
    ``Qwen2MoeConfig`` but for ``rope_theta`` and the context): hidden 2048,
    16 heads and 16 KV heads of head_dim 128, 60 experts of width 1408,
    top-4 without renormalization, a shared expert of 5632, every layer
    sparse, vocab 151,936 with an untied ``lm_head``. ``layers`` cuts the
    depth (24 in the checkpoint)."""
    from ..models.vlm.modeling import DecoderConfig, VLMConfig

    return VLMConfig(decoder=DecoderConfig(
        hidden_size=2048, layers=layers, heads=16, kv_heads=16, intermediate_size=5632, vocab_size=151936,
        rope_theta=1_000_000.0, rms_norm_eps=1e-6, max_position_embeddings=8192, tie_word_embeddings=False,
        moe_experts=60, moe_top_k=4, moe_intermediate_size=1408, moe_shared_intermediate=5632, moe_every=1,
        moe_norm_topk=False, moe_dense_layers=(),
    ))


def seeded_state(cfg, seed: int, device="cpu", dtype=None) -> dict:
    """The ``state_dict`` of a ``VLMModel(cfg)`` holding ``init_random_``'s
    weights for ``seed``, made in ``dtype`` (default float32) on ``device``
    with no other copy: the model is built on the meta device, cast, then
    given storage on ``device``."""
    import torch

    from ..models.vlm.modeling import VLMModel, init_random_

    with torch.device("meta"):
        model = VLMModel(cfg)
    model = model.to(dtype=dtype or torch.float32).to_empty(device=device)
    with torch.no_grad():
        init_random_(model, seed)
    return model.state_dict()


def hf_config(cfg) -> dict:
    """``config.json`` (LLaVA-style ``text_config`` + ``vision_config``) that
    ``VLMConfig.from_hf`` reads back as ``cfg``; a MoE decoder's text
    config carries the ``Qwen2MoeConfig`` keys."""
    d, v = cfg.decoder, cfg.vision
    text = {
        "hidden_size": d.hidden_size, "num_hidden_layers": d.layers, "num_attention_heads": d.heads,
        "num_key_value_heads": d.kv_heads, "intermediate_size": d.intermediate_size,
        "vocab_size": d.vocab_size, "head_dim": d.head_dim, "rope_theta": d.rope_theta,
        "rms_norm_eps": d.rms_norm_eps, "max_position_embeddings": d.max_position_embeddings,
        "tie_word_embeddings": d.tie_word_embeddings, "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id, "pad_token_id": cfg.pad_token_id,
    }
    if d.moe_experts:
        text.update({
            "num_experts": d.moe_experts, "num_experts_per_tok": d.moe_top_k,
            "moe_intermediate_size": d.moe_intermediate_size,
            "shared_expert_intermediate_size": d.moe_shared_intermediate,
            "decoder_sparse_step": d.moe_every, "norm_topk_prob": d.moe_norm_topk,
            "mlp_only_layers": list(d.moe_dense_layers),
        })
    return {
        "text_config": text,
        "vision_config": {
            "image_size": v.image_size, "patch_size": v.patch_size, "hidden_size": v.width,
            "num_hidden_layers": v.layers, "num_attention_heads": v.heads,
            "image_mean": list(v.mean), "image_std": list(v.std),
        },
        "image_token_index": cfg.image_token_id,
    }


def write_tokenizer(path: Path, cfg) -> None:
    """A ``tokenizers`` WordLevel vocabulary of all ``vocab_size`` ids: the
    config's special ids as special tokens, ``WORDS`` at ids 1000 on,
    ``w<id>`` for the rest, so every id the model can emit decodes and
    distinct non-special ids decode to distinct words."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers

    vocab_size = cfg.decoder.vocab_size
    names = {cfg.bos_token_id: "<|endoftext|>", cfg.eos_token_id: "<|im_end|>", cfg.image_token_id: "<image>"}
    names.setdefault(cfg.pad_token_id, "<pad>")
    names[next(i for i in range(vocab_size - 1, 0, -1) if i not in names)] = "<|im_start|>"
    special = list(names.values())
    names[next(i for i in range(3, vocab_size) if i not in names)] = "<unk>"
    for k, word in enumerate(WORDS):
        names[1000 + k] = word
    vocab = {names.get(i, f"w{i}"): i for i in range(vocab_size)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens([AddedToken(s, special=True) for s in special])
    tok.save(str(path))


def write_model_dir(root: Path, name: str, cfg, state) -> Path:
    """A model directory as the loader reads one, under
    ``<root>/models/<name>``: ``model.safetensors`` under the names
    ``convert_vlm_checkpoint`` reads, ``config.json``, ``tokenizer.json``,
    ``tokenizer_config.json`` with a chat template, and
    ``model_info.json``. ``state`` is the port's ``state_dict`` (any
    device: each tensor is copied to the host as it is written)."""
    from safetensors.torch import save_file

    from ..models.vlm.convert import export_hf_checkpoint

    model_dir = Path(root) / "models" / name
    model_dir.mkdir(parents=True)
    save_file({k: v.cpu() for k, v in export_hf_checkpoint(state).items()}, str(model_dir / "model.safetensors"))
    (model_dir / "config.json").write_text(json.dumps(hf_config(cfg)))
    write_tokenizer(model_dir / "tokenizer.json", cfg)
    (model_dir / "tokenizer_config.json").write_text(json.dumps({"chat_template": CHAT_TEMPLATE}))
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": name, "version": "1.0.0", "description": "seeded random weights",
        "model_type": "vlm", "source": {"format": "custom", "repo_id": f"LumilioPhotos/{name}"},
        "runtimes": {"jax": {"available": True, "files": ["model.safetensors"]}},
    }))
    return model_dir
