"""VLM in PyTorch: ViT vision encoder + Qwen2-style causal decoder (twin
of ``lumen_tpu/models/vlm/modeling.py``, dense decoder only).

The decoder runs three ways, as in the JAX package: cacheless (tests,
causal flash attention), against a contiguous per-request KV buffer
(prefill chunks, :func:`~lumen_tpu_torch.ops.attention.attention_cached`)
and against the shared paged KV pool (continuous decode,
:func:`~lumen_tpu_torch.ops.attention.paged_attention`). Where JAX
returned an updated cache, the KV buffers here are written IN PLACE (the
JAX programs donated them) and returned for the same call shape.

Submodule and parameter names follow the Flax tree (``layers.0.attn.
q_proj``, ``input_norm``, ``embed_tokens``, ...) so ``convert.py`` maps
one onto the other by name. With ``DecoderConfig.weight_quant="int8"``
the seven projections of every layer (and an untied lm_head) are
``QDense`` modules holding ``q``/``scale`` in the JAX layout. Not ported
yet: the MoE FFN.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.attention import attention, attention_cached, paged_attention, repeat_kv
from ...ops.quant import QDense
from ..clip.modeling import Block, PatchEmbed


@dataclass(frozen=True)
class DecoderConfig:
    hidden_size: int = 896
    layers: int = 24
    heads: int = 14
    kv_heads: int = 2
    intermediate_size: int = 4864
    vocab_size: int = 151936
    head_dim: int | None = None  # None -> hidden_size // heads
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = True
    # Weight-only int8 for the attention + MLP projections (per output
    # channel scales): decode at small batch streams the weights, so int8
    # halves the dominant traffic. Embeddings, norms and a tied lm_head
    # stay in the policy dtype. Set by the serving layer
    # (``VLMManager(quantize="int8")``), not by checkpoints.
    weight_quant: str | None = None  # None | "int8"
    #: int8 execution mode; only "dequant" is ported ("dynamic" raises).
    weight_quant_kernel: str = "dequant"

    @property
    def dim_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.heads


@dataclass(frozen=True)
class VisionTowerConfig:
    image_size: int = 1024
    patch_size: int = 64
    width: int = 768
    layers: int = 12
    heads: int = 12
    mean: tuple[float, float, float] = (0.0, 0.0, 0.0)
    std: tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class VLMConfig:
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    vision: VisionTowerConfig = field(default_factory=VisionTowerConfig)
    image_token_id: int = 151646
    bos_token_id: int = 151643
    eos_token_id: int = 151645
    pad_token_id: int = 151643

    @classmethod
    def tiny(cls) -> "VLMConfig":
        """Small config for CPU tests (same numbers as the JAX ``tiny``)."""
        return cls(
            decoder=DecoderConfig(
                hidden_size=32,
                layers=2,
                heads=4,
                kv_heads=2,
                intermediate_size=64,
                vocab_size=256,
                rope_theta=10_000.0,
                max_position_embeddings=128,
            ),
            vision=VisionTowerConfig(image_size=32, patch_size=16, width=48, layers=2, heads=4),
            image_token_id=250,
            bos_token_id=1,
            eos_token_id=2,
            pad_token_id=0,
        )

    @classmethod
    def from_hf(cls, cfg: dict[str, Any]) -> "VLMConfig":
        """Build from an HF LLaVA-style ``config.json`` (``text_config`` +
        ``vision_config``) or a flat Qwen2-style decoder config. Dense
        decoders only: an MoE config is refused until MoE is ported."""
        text = cfg.get("text_config", cfg)
        vis = cfg.get("vision_config", {})
        if text.get("num_experts", 0):
            raise NotImplementedError("MoE decoders are not ported to lumen_tpu_torch yet")
        decoder = DecoderConfig(
            hidden_size=text.get("hidden_size", 896),
            layers=text.get("num_hidden_layers", 24),
            heads=text.get("num_attention_heads", 14),
            kv_heads=text.get("num_key_value_heads", text.get("num_attention_heads", 14)),
            intermediate_size=text.get("intermediate_size", 4864),
            vocab_size=text.get("vocab_size", 151936),
            head_dim=text.get("head_dim"),
            rope_theta=text.get("rope_theta", 1_000_000.0),
            rms_norm_eps=text.get("rms_norm_eps", 1e-6),
            max_position_embeddings=text.get("max_position_embeddings", 32768),
            tie_word_embeddings=text.get("tie_word_embeddings", cfg.get("tie_word_embeddings", True)),
        )
        vision = VisionTowerConfig(
            image_size=vis.get("image_size", 1024),
            patch_size=vis.get("patch_size", 64),
            width=vis.get("hidden_size", 768),
            layers=vis.get("num_hidden_layers", 12),
            heads=vis.get("num_attention_heads", 12),
            mean=tuple(vis.get("image_mean", (0.0, 0.0, 0.0))),
            std=tuple(vis.get("image_std", (1.0, 1.0, 1.0))),
        )
        return cls(
            decoder=decoder,
            vision=vision,
            image_token_id=cfg.get("image_token_index", cfg.get("image_token_id", 151646)),
            bos_token_id=text.get("bos_token_id", 151643),
            eos_token_id=text.get("eos_token_id", 151645),
            pad_token_id=text.get("pad_token_id", text.get("bos_token_id", 151643)),
        )


# -- KV cache ---------------------------------------------------------------


def init_kv_cache(cfg: VLMConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device=None):
    """Contiguous per-layer cache ``[batch, kv_heads, max_seq, dh]``."""
    d = cfg.decoder
    shape = (batch, d.kv_heads, max_seq, d.dim_per_head)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(d.layers)
    ]


def init_paged_kv_cache(cfg: VLMConfig, pages: int, page_size: int, dtype=torch.bfloat16, device=None):
    """Per-layer paged pool ``[pages, kv_heads, page_size, dh]``, shared by
    every decode row through block tables. Page 0 is the dump page."""
    d = cfg.decoder
    shape = (pages, d.kv_heads, page_size, d.dim_per_head)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(d.layers)
    ]


# -- modules ----------------------------------------------------------------


def _dense(cfg: DecoderConfig, in_features: int, out_features: int, bias: bool) -> nn.Module:
    """Dense factory for the decoder projections: honors ``weight_quant``
    (JAX ``_dense``)."""
    if cfg.weight_quant == "int8":
        return QDense(in_features, out_features, bias=bias, kernel_mode=cfg.weight_quant_kernel)
    if cfg.weight_quant is not None:
        raise ValueError(f"weight_quant must be None or 'int8', got {cfg.weight_quant!r}")
    return nn.Linear(in_features, out_features, bias=bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (x32 * self.weight.float()).to(x.dtype)


def rope_rotate(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, HF half-split convention. ``x`` [B, H, S, D],
    ``positions`` [B, S] absolute token positions."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[:, None, :, None].float() * inv_freq  # [B, 1, S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        dh = cfg.dim_per_head
        self.q_proj = _dense(cfg, cfg.hidden_size, cfg.heads * dh, True)
        self.k_proj = _dense(cfg, cfg.hidden_size, cfg.kv_heads * dh, True)
        self.v_proj = _dense(cfg, cfg.hidden_size, cfg.kv_heads * dh, True)
        self.o_proj = _dense(cfg, cfg.heads * dh, cfg.hidden_size, False)

    def forward(self, x, positions, cache, cache_offset, kv_valid_len, block_tables=None):
        """``x`` [B, S, hidden]. With a contiguous cache, new K/V are
        written at ``cache_offset`` (an int for a prefill segment shared
        by the batch, a [B] tensor for one decode token per row) and
        attention runs against the whole buffer masked to
        ``kv_valid_len`` [B]. With ``block_tables`` [B, max_pages] the
        cache is the paged pool: token t of a row lands in the page + slot
        its table maps ``cache_offset + t`` to, and attention is the paged
        kernel over the row's pages only -- one decode token (s == 1), or
        the speculative verify window (s > 1), where ``kv_valid_len``
        stays the t = 0 visibility and slot t sees ``kv_valid_len + t``
        keys."""
        c = self.cfg
        b, s, _ = x.shape
        dh = c.dim_per_head
        q = self.q_proj(x).reshape(b, s, c.heads, dh).transpose(1, 2)
        k = self.k_proj(x).reshape(b, s, c.kv_heads, dh).transpose(1, 2)
        v = self.v_proj(x).reshape(b, s, c.kv_heads, dh).transpose(1, 2)
        q = rope_rotate(q, positions, c.rope_theta).contiguous()
        k = rope_rotate(k, positions, c.rope_theta)
        n_rep = c.heads // c.kv_heads

        if block_tables is not None:
            page = cache["k"].shape[2]
            off = cache_offset.long()[:, None] + torch.arange(s, device=x.device)  # [B, S]
            rows = torch.arange(b, device=x.device)[:, None]
            page_idx = block_tables.long()[rows, off // page]
            slot = off % page
            # In place (JAX donated the pool). Rows own their frontier
            # pages exclusively; free rows all dump into page 0.
            cache["k"][page_idx, :, slot] = k.transpose(1, 2).to(cache["k"].dtype)
            cache["v"][page_idx, :, slot] = v.transpose(1, 2).to(cache["v"].dtype)
            if s == 1:
                out = paged_attention(
                    q[:, :, 0].contiguous(), cache["k"], cache["v"], block_tables, kv_valid_len
                )[:, :, None, :]
            else:
                out = paged_attention(
                    q.transpose(1, 2).contiguous(), cache["k"], cache["v"], block_tables, kv_valid_len
                ).transpose(1, 2)
        elif cache is not None:
            if isinstance(cache_offset, int):
                # Prefill: one contiguous segment at a shared offset.
                cache["k"][:, :, cache_offset : cache_offset + s] = k.to(cache["k"].dtype)
                cache["v"][:, :, cache_offset : cache_offset + s] = v.to(cache["v"].dtype)
            else:
                # Decode: one token per sample at a per-sample slot.
                if s != 1:
                    raise ValueError("per-sample cache offsets need a single-token segment")
                rows = torch.arange(b, device=x.device)
                off = cache_offset.long()
                cache["k"][rows, :, off] = k[:, :, 0].to(cache["k"].dtype)
                cache["v"][rows, :, off] = v[:, :, 0].to(cache["v"].dtype)
            out = attention_cached(
                q,
                repeat_kv(cache["k"].to(x.dtype), n_rep),
                repeat_kv(cache["v"].to(x.dtype), n_rep),
                q_offsets=positions[:, 0],
                kv_valid=kv_valid_len,
            )
        else:
            # Cacheless forward: positions are arange rows, so the mask is
            # exactly the causal triangle.
            out = attention(
                q, repeat_kv(k.contiguous(), n_rep), repeat_kv(v.contiguous(), n_rep), causal=True
            )
        out = out.transpose(1, 2).reshape(b, s, c.heads * dh)
        return self.o_proj(out), cache


class SwiGLU(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.gate_proj = _dense(cfg, cfg.hidden_size, cfg.intermediate_size, False)
        self.up_proj = _dense(cfg, cfg.hidden_size, cfg.intermediate_size, False)
        self.down_proj = _dense(cfg, cfg.intermediate_size, cfg.hidden_size, False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = DecoderAttention(cfg)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = SwiGLU(cfg)

    def forward(self, x, positions, cache, cache_offset, kv_valid_len, block_tables=None):
        h, cache = self.attn(
            self.input_norm(x), positions, cache, cache_offset, kv_valid_len, block_tables
        )
        x = x + h
        return x + self.mlp(self.post_attn_norm(x)), cache


class Decoder(nn.Module):
    """Causal LM over input embeddings, so vision embeddings can be
    spliced upstream."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = (
            None if cfg.tie_word_embeddings else _dense(cfg, cfg.hidden_size, cfg.vocab_size, False)
        )

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(self, embeds, positions, caches, cache_offset, kv_valid_len, block_tables=None):
        x = embeds
        for i, layer in enumerate(self.layers):
            x, _ = layer(
                x, positions, caches[i] if caches is not None else None,
                cache_offset, kv_valid_len, block_tables,
            )
        x = self.final_norm(x)
        if self.lm_head is None:
            logits = x @ self.embed_tokens.weight.to(x.dtype).T
        else:
            logits = self.lm_head(x)
        return logits, caches


class VisionEncoder(nn.Module):
    """ViT over large patches -> [B, num_tokens, width], then a 2-layer
    GELU MLP projector into the decoder's hidden space (LLaVA layout)."""

    def __init__(self, cfg: VLMConfig):
        super().__init__()
        v = cfg.vision
        self.patch_embed = PatchEmbed(v.width, v.patch_size, use_bias=True)
        self.position_embedding = nn.Parameter(torch.zeros(v.num_tokens, v.width))
        self.blocks = nn.ModuleList(Block(v.width, v.heads, "gelu", 1e-6) for _ in range(v.layers))
        self.post_ln = nn.LayerNorm(v.width, eps=1e-6)
        self.proj_fc1 = nn.Linear(v.width, cfg.decoder.hidden_size)
        self.proj_fc2 = nn.Linear(cfg.decoder.hidden_size, cfg.decoder.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(pixel_values)
        x = x + self.position_embedding.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.post_ln(x)
        return self.proj_fc2(F.gelu(self.proj_fc1(x), approximate="tanh"))


class VLMModel(nn.Module):
    def __init__(self, cfg: VLMConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionEncoder(cfg)
        self.decoder = Decoder(cfg.decoder)

    def encode_vision(self, pixel_values):
        return self.vision(pixel_values)

    def embed_tokens(self, input_ids):
        return self.decoder.embed(input_ids)

    def decode(self, embeds, positions, caches, cache_offset, kv_valid_len):
        return self.decoder(embeds, positions, caches, cache_offset, kv_valid_len)

    def decode_paged(self, embeds, positions, caches, block_tables, cache_offset, kv_valid_len):
        """Decode against the paged KV pool: one token per row, or a
        speculative verify window of ``embeds.shape[1]`` tokens per row."""
        return self.decoder(embeds, positions, caches, cache_offset, kv_valid_len, block_tables)

    def forward(self, input_ids, pixel_values=None):
        """Cacheless forward: embeds ids, splices one image per sample at
        the image-token position when pixels are given, returns logits."""
        embeds = self.decoder.embed(input_ids)
        if pixel_values is not None:
            vis = self.vision(pixel_values)
            embeds, positions, _ = merge_image_embeddings(
                embeds, vis, input_ids, self.cfg.image_token_id
            )
        else:
            b, s = input_ids.shape
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        kv = torch.full((embeds.shape[0],), embeds.shape[1], device=embeds.device)
        logits, _ = self.decoder(embeds, positions, None, None, kv)
        return logits


def merge_image_embeddings(text_embeds, vision_embeds, input_ids, image_token_id, input_lengths=None):
    """LLaVA-style splice with static shapes: the first ``<image>``
    placeholder is replaced by the ``V`` vision tokens. Returns ``(merged
    [B, L, H], positions [B, L], lengths [B])`` with ``L = S - 1 + V``;
    ``lengths`` is the post-splice live token count."""
    b, s = input_ids.shape
    v = vision_embeds.shape[1]
    length = s - 1 + v
    dev = input_ids.device
    if input_lengths is None:
        input_lengths = torch.full((b,), s, device=dev)
    is_img = input_ids == image_token_id
    has_image = is_img.any(dim=1)
    idx = torch.where(has_image, is_img.int().argmax(dim=1), torch.full_like(has_image, s, dtype=torch.long))
    pos = torch.arange(length, device=dev)[None, :]
    idx_b = idx[:, None]
    in_image = (pos >= idx_b) & (pos < idx_b + v) & has_image[:, None]
    text_src = torch.where(pos < idx_b, pos, pos - (v - 1)).clamp(0, s - 1)
    vis_src = (pos - idx_b).clamp(0, v - 1)
    h = text_embeds.shape[-1]
    gathered_text = torch.gather(text_embeds, 1, text_src[:, :, None].expand(b, length, h))
    gathered_vis = torch.gather(
        vision_embeds.to(text_embeds.dtype), 1, vis_src[:, :, None].expand(b, length, h)
    )
    merged = torch.where(in_image[:, :, None], gathered_vis, gathered_text)
    positions = pos.expand(b, length)
    lengths = torch.where(has_image, input_lengths - 1 + v, input_lengths)
    return merged, positions, lengths


@torch.no_grad()
def init_random_(model: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Seeded random weights in place (no checkpoint ships with the repo):
    normal(0, ``std``) for projections, embeddings and position tables,
    ones for norm scales, zeros for biases. One generator on the model's
    device walks the parameters in name order, so a seed names one model
    on a given device."""
    gen = None
    for name, p in sorted(model.named_parameters()):
        if gen is None:
            gen = torch.Generator(device=p.device)
            gen.manual_seed(seed)
        parent, _, leaf = name.rpartition(".")
        owner = model.get_submodule(parent)
        if isinstance(owner, (RMSNorm, nn.LayerNorm)) and leaf == "weight":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)
    return model
