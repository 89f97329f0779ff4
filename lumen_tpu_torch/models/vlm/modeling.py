"""VLM in PyTorch: ViT vision encoder + Qwen2-style causal decoder (twin
of ``lumen_tpu/models/vlm/modeling.py``), dense or Qwen2-MoE.

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
``QDense`` modules holding ``q``/``scale`` in the JAX layout. A
Qwen2-MoE decoder (``DecoderConfig.moe_experts > 0``) replaces the MLP of
its sparse layers by ``MoEFFN``: a router, stacked ``[E, ...]`` expert
banks run through :func:`~lumen_tpu_torch.parallel.moe.moe_ffn` with
exact routing, and a sigmoid-gated shared expert; under int8 only the
shared expert's projections turn ``QDense``.

With ``tp`` (a :class:`~lumen_tpu_torch.parallel.tp.TensorParallel`) the
model holds one rank's shards of a ``model`` axis (``parallel.sharding.
local_state_dict``): each attention block ``heads / size`` query heads and
the KV heads they read, so the KV caches and the paged pool hold only this
rank's KV heads ``[pages, kv_heads_local, page, dh]``; the MLPs their share
of the intermediate width; the token table and the vision position table
their share of the width. A block sums after ``o_proj`` and ``down_proj``
(and the vision tower after ``out_proj``, ``fc2`` and the projector's
``proj_fc2``, which the JAX ``fc2`` rule also splits); the token lookup is
gathered to the full width, and the tied ``lm_head``'s partial logits are
summed. In a MoE layer the shared expert splits and sums as an MLP; the
router and the expert banks stay whole on a ``model`` axis (the JAX rules
leave them), so the routed output is complete on every rank and added
once. With ``ep`` (a :class:`~lumen_tpu_torch.parallel.tp.ExpertParallel`)
a rank holds ``E / size`` experts of each bank and the routed rows are
summed over the ``expert`` axis (``parallel.moe``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.attention import attention, attention_cached, paged_attention, repeat_kv
from ...ops.quant import QDense
from ...parallel.moe import MoEParams, moe_ffn
from ...parallel.tp import ExpertParallel, TensorParallel, row_parallel
from ..clip.modeling import Block, PatchEmbed, _local_width


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
    # Mixture-of-experts decoder (Qwen2-MoE layout; 0 experts = dense):
    # layer i is sparse iff (i + 1) % moe_every == 0 and i is not in
    # moe_dense_layers (HF decoder_sparse_step / mlp_only_layers). Routing
    # is exact (no token drops), as HF's dense-gather reference.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_intermediate_size: int | None = None  # None -> intermediate_size
    moe_shared_intermediate: int = 0  # > 0 adds Qwen2-MoE's shared expert
    moe_every: int = 1
    moe_norm_topk: bool = True
    moe_dense_layers: tuple[int, ...] = ()
    # Weight-only int8 for the attention + MLP projections (per output
    # channel scales): decode at small batch streams the weights, so int8
    # halves the dominant traffic. Embeddings, norms and a tied lm_head
    # stay in the policy dtype. Set by the serving layer
    # (``VLMManager(quantize="int8")``), not by checkpoints.
    weight_quant: str | None = None  # None | "int8"
    #: int8 execution mode: "dequant" (weight-only) or "dynamic" (W8A8),
    #: from ``LUMEN_Q8_KERNEL`` (``ops.quant.resolve_q8_kernel``).
    weight_quant_kernel: str = "dequant"

    @property
    def dim_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.heads

    def is_moe_layer(self, i: int) -> bool:
        return self.moe_experts > 0 and i not in self.moe_dense_layers and (i + 1) % self.moe_every == 0


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
        ``vision_config``) or a flat Qwen2-style decoder config; the
        Qwen2-MoE keys with the JAX defaults."""
        text = cfg.get("text_config", cfg)
        vis = cfg.get("vision_config", {})
        experts = text.get("num_experts", 0)
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
            moe_experts=experts,
            # HF Qwen2MoeConfig defaults num_experts_per_tok to 4 and
            # norm_topk_prob to False.
            moe_top_k=text.get("num_experts_per_tok", 4 if experts else 2),
            moe_intermediate_size=text.get("moe_intermediate_size"),
            moe_shared_intermediate=text.get("shared_expert_intermediate_size", 0),
            moe_every=text.get("decoder_sparse_step", 1),
            moe_norm_topk=text.get("norm_topk_prob", not experts),
            moe_dense_layers=tuple(text.get("mlp_only_layers", ())),
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


class KVCache(list):
    """A decoder's per-layer ``{"k", "v"}`` buffers: a list that a
    tensor-parallel group registers as one rank-local object (each rank's
    holds its own KV heads)."""

    _tp_local = True


def init_kv_cache(cfg: VLMConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device=None,
                  kv_heads: int | None = None):
    """Contiguous per-layer cache ``[batch, kv_heads, max_seq, dh]``
    (``kv_heads``: a tensor-parallel rank's own count)."""
    d = cfg.decoder
    shape = (batch, kv_heads or d.kv_heads, max_seq, d.dim_per_head)
    return KVCache(
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(d.layers)
    )


def init_paged_kv_cache(cfg: VLMConfig, pages: int, page_size: int, dtype=torch.bfloat16, device=None,
                        kv_heads: int | None = None):
    """Per-layer paged pool ``[pages, kv_heads, page_size, dh]``, shared by
    every decode row through block tables. Page 0 is the dump page."""
    d = cfg.decoder
    shape = (pages, kv_heads or d.kv_heads, page_size, d.dim_per_head)
    return KVCache(
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(d.layers)
    )


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
    def __init__(self, cfg: DecoderConfig, tp: TensorParallel | None = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        dh = cfg.dim_per_head
        #: this rank's heads (``parallel.tp.AttnPlan``), None without tp
        self.plan = tp.attn_plan(cfg.heads, cfg.kv_heads) if tp is not None else None
        self.split = self.plan is not None and self.plan.split
        self.heads = self.plan.q_heads if self.split else cfg.heads
        self.kv_heads = self.plan.kv_heads if self.split else cfg.kv_heads
        self.q_proj = _dense(cfg, cfg.hidden_size, self.heads * dh, True)
        self.k_proj = _dense(cfg, cfg.hidden_size, self.kv_heads * dh, True)
        self.v_proj = _dense(cfg, cfg.hidden_size, self.kv_heads * dh, True)
        self.o_proj = _dense(cfg, self.heads * dh, cfg.hidden_size, False)

    def forward(self, x, positions, cache, cache_offset, kv_valid_len, block_tables=None, kv_bound=None):
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
        keys. ``kv_bound`` is ``kv_valid_len.max()`` as the caller's host
        loop knows it (see ``attention_cached``)."""
        c = self.cfg
        b, s, _ = x.shape
        dh = c.dim_per_head
        q = self.q_proj(x).reshape(b, s, self.heads, dh).transpose(1, 2)
        k = self.k_proj(x).reshape(b, s, self.kv_heads, dh).transpose(1, 2)
        v = self.v_proj(x).reshape(b, s, self.kv_heads, dh).transpose(1, 2)
        q = rope_rotate(q, positions, c.rope_theta).contiguous()
        k = rope_rotate(k, positions, c.rope_theta)
        n_rep = self.heads // self.kv_heads

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
                kv_bound=kv_bound,
            )
        else:
            # Cacheless forward: positions are arange rows, so the mask is
            # exactly the causal triangle.
            out = attention(
                q, repeat_kv(k.contiguous(), n_rep), repeat_kv(v.contiguous(), n_rep), causal=True
            )
        out = out.transpose(1, 2).reshape(b, s, self.heads * dh)
        return row_parallel(self.o_proj, out, self.tp, self.split), cache


class SwiGLU(nn.Module):
    def __init__(self, cfg: DecoderConfig, intermediate: int | None = None, tp: TensorParallel | None = None):
        super().__init__()
        full = intermediate or cfg.intermediate_size
        inter = _local_width(full, tp)
        self.tp, self.split = tp, inter != full
        self.gate_proj = _dense(cfg, cfg.hidden_size, inter, False)
        self.up_proj = _dense(cfg, cfg.hidden_size, inter, False)
        self.down_proj = _dense(cfg, inter, cfg.hidden_size, False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_parallel(self.down_proj, F.silu(self.gate_proj(x)) * self.up_proj(x), self.tp, self.split)


class MoEFFN(nn.Module):
    """Qwen2-MoE sparse MLP (JAX ``MoEFFN``): a softmax router, a top-k
    routed SwiGLU expert bank, and an optional sigmoid-gated shared expert.
    The routed compute is :func:`~lumen_tpu_torch.parallel.moe.moe_ffn`
    with exact routing, so outputs match HF's ``Qwen2MoeSparseMoeBlock``.
    ``router`` is [D, E] (the softmax runs in fp32); the banks ``w_gate``
    / ``w_up`` [E, D, F] and ``w_down`` [E, F, D] are cast to the
    activations' dtype at the call, as in JAX; ``shared_gate`` is a
    bias-free [D -> 1] projection that int8 leaves in the policy dtype.

    With ``ep`` the banks hold this rank's ``E / size`` experts (whole when
    the experts do not divide, as the JAX ``sanitize_spec`` leaves them)
    and ``moe_ffn`` sums the routed rows over the ``expert`` axis; with
    ``tp`` the shared expert is a tensor-parallel ``SwiGLU``."""

    def __init__(self, cfg: DecoderConfig, tp: TensorParallel | None = None, ep: ExpertParallel | None = None):
        super().__init__()
        self.cfg = cfg
        e, d = cfg.moe_experts, cfg.hidden_size
        f = cfg.moe_intermediate_size or cfg.intermediate_size
        self.ep = ep if ep is not None and ep.size > 1 and e % ep.size == 0 else None
        local = e if self.ep is None else e // self.ep.size
        self.router = nn.Parameter(torch.zeros(d, e))
        self.w_gate = nn.Parameter(torch.zeros(local, d, f))
        self.w_up = nn.Parameter(torch.zeros(local, d, f))
        self.w_down = nn.Parameter(torch.zeros(local, f, d))
        if cfg.moe_shared_intermediate:
            self.shared = SwiGLU(cfg, intermediate=cfg.moe_shared_intermediate, tp=tp)
            self.shared_gate = nn.Linear(d, 1, bias=False)
        else:
            self.shared = self.shared_gate = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, d = x.shape
        params = MoEParams(
            router=self.router, w_gate=self.w_gate.to(x.dtype), w_up=self.w_up.to(x.dtype),
            w_down=self.w_down.to(x.dtype),
        )
        y = moe_ffn(
            params, x.reshape(b * s, d), self.ep, k=c.moe_top_k, capacity_factor=None, norm_topk=c.moe_norm_topk
        ).reshape(b, s, d)
        if self.shared is not None:
            y = y + torch.sigmoid(self.shared_gate(x)) * self.shared(x)
        return y


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, layer_idx: int = 0, tp: TensorParallel | None = None,
                 ep: ExpertParallel | None = None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = DecoderAttention(cfg, tp)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MoEFFN(cfg, tp, ep) if cfg.is_moe_layer(layer_idx) else SwiGLU(cfg, tp=tp)

    def forward(self, x, positions, cache, cache_offset, kv_valid_len, block_tables=None, kv_bound=None):
        h, cache = self.attn(
            self.input_norm(x), positions, cache, cache_offset, kv_valid_len, block_tables, kv_bound
        )
        x = x + h
        return x + self.mlp(self.post_attn_norm(x)), cache


class Decoder(nn.Module):
    """Causal LM over input embeddings, so vision embeddings can be
    spliced upstream."""

    def __init__(self, cfg: DecoderConfig, tp: TensorParallel | None = None, ep: ExpertParallel | None = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.embed_tokens = nn.Embedding(cfg.vocab_size, _local_width(cfg.hidden_size, tp))
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, tp, ep) for i in range(cfg.layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = (
            None if cfg.tie_word_embeddings else _dense(cfg, cfg.hidden_size, cfg.vocab_size, False)
        )

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(input_ids)
        return x if self.tp is None else self.tp.gather(x, self.cfg.hidden_size)

    def forward(self, embeds, positions, caches, cache_offset, kv_valid_len, block_tables=None, kv_bound=None,
                last=None):
        """Logits ``[B, S, V]``; with ``last`` ([B] positions) only each
        row's logits at its ``last`` position, ``[B, 1, V]``: a prefill
        reads no other, and on a model axis the partial logits summed
        shrink by the sequence length."""
        x = embeds
        for i, layer in enumerate(self.layers):
            x, _ = layer(
                x, positions, caches[i] if caches is not None else None,
                cache_offset, kv_valid_len, block_tables, kv_bound,
            )
        if last is not None:
            x = x[torch.arange(x.shape[0], device=x.device), last.long()][:, None]
        x = self.final_norm(x)
        if self.lm_head is None:
            w = self.embed_tokens.weight
            if w.shape[1] != x.shape[-1]:
                # A width-split tied table: this rank's columns of x give
                # partial logits, summed over the axis.
                lo = self.tp.rank * w.shape[1]
                logits = self.tp.sum(x[..., lo : lo + w.shape[1]] @ w.to(x.dtype).T)
            else:
                logits = x @ w.to(x.dtype).T
        else:
            logits = self.lm_head(x)
        return logits, caches


class VisionEncoder(nn.Module):
    """ViT over large patches -> [B, num_tokens, width], then a 2-layer
    GELU MLP projector into the decoder's hidden space (LLaVA layout)."""

    def __init__(self, cfg: VLMConfig, tp: TensorParallel | None = None):
        super().__init__()
        v = cfg.vision
        hidden = cfg.decoder.hidden_size
        self.tp = tp
        self.patch_embed = PatchEmbed(v.width, v.patch_size, use_bias=True)
        self.position_embedding = nn.Parameter(torch.zeros(v.num_tokens, _local_width(v.width, tp)))
        self.blocks = nn.ModuleList(Block(v.width, v.heads, "gelu", 1e-6, tp=tp) for _ in range(v.layers))
        self.post_ln = nn.LayerNorm(v.width, eps=1e-6)
        inner = _local_width(hidden, tp)
        self.proj_split = inner != hidden
        self.proj_fc1 = nn.Linear(v.width, inner)
        self.proj_fc2 = nn.Linear(inner, hidden)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(pixel_values)
        pos = self.position_embedding
        if self.tp is not None:
            pos = self.tp.gather(pos, x.shape[-1])
        x = x + pos.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.post_ln(x)
        return row_parallel(self.proj_fc2, F.gelu(self.proj_fc1(x), approximate="tanh"), self.tp, self.proj_split)


class VLMModel(nn.Module):
    def __init__(self, cfg: VLMConfig, tp: TensorParallel | None = None, ep: ExpertParallel | None = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.vision = VisionEncoder(cfg, tp)
        self.decoder = Decoder(cfg.decoder, tp, ep)

    def encode_vision(self, pixel_values):
        return self.vision(pixel_values)

    def embed_tokens(self, input_ids):
        return self.decoder.embed(input_ids)

    def decode(self, embeds, positions, caches, cache_offset, kv_valid_len, kv_bound=None, last=None):
        """Decode against a contiguous KV cache; ``kv_bound`` is the host's
        ``kv_valid_len.max()`` for a single-token step (no sync); ``last``
        keeps one position's logits a row (``Decoder.forward``)."""
        return self.decoder(embeds, positions, caches, cache_offset, kv_valid_len, kv_bound=kv_bound, last=last)

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
    normal(0, ``std``) for projections, embeddings, position tables, MoE
    routers and expert banks, ones for norm scales, zeros for biases. One
    generator on the model's device walks the parameters in name order, so
    a seed names one model on a given device."""
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
