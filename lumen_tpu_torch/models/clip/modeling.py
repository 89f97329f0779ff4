"""CLIP in PyTorch: ViT image tower + causal text transformer, or the
ChineseCLIP BERT text tower (twin of ``lumen_tpu/models/clip/modeling.py``).

Submodule names follow the Flax parameter tree (``attn/q_proj``, ``ln1``,
``mlp/fc1``, ``blocks_<i>`` -> ``blocks.<i>``, ...), so
``models/clip/convert.py`` maps one onto the other by name; the VLM vision
tower borrows ``Block`` and ``PatchEmbed``. Images are channels-last
``[B, H, W, 3]``, as in the JAX package.

Every unmasked attention call (both CLIP towers) runs the port's
``flash_attention`` kernel on CUDA tensors; the BERT tower's padded call
passes a mask and runs the plain version, as the JAX ``attention`` sends
masked calls to its XLA reference. With ``weight_quant="int8"`` the
ViT and causal text blocks' q/k/v/out and fc1/fc2 projections are
``QDense`` (``weight_quant_kernel``: ``dynamic`` W8A8 by default, or
``dequant``), as the JAX ``_block_dense``; the BERT tower stays in the
policy dtype.

With ``tp`` (a :class:`~lumen_tpu_torch.parallel.tp.TensorParallel`) a
module holds one rank's shards of a ``model`` axis, the slice
``parallel.sharding.local_state_dict`` takes by the TP rules: ``heads /
size`` heads a block, ``4 * width / size`` MLP columns, and the width of
the embedding tables. It sums after ``out_proj`` and after ``fc2``, and
gathers the width after each embedding lookup.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch
from torch import nn
from torch.nn import functional as F

from torch.utils.checkpoint import checkpoint

from ...ops.attention import attention
from ...ops.quant import QDense
from ...parallel.tp import TensorParallel, row_parallel


@dataclass(frozen=True)
class TowerConfig:
    width: int
    layers: int
    heads: int


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_size: int = 224
    patch_size: int = 32
    vision: TowerConfig = field(default_factory=lambda: TowerConfig(768, 12, 12))
    text: TowerConfig = field(default_factory=lambda: TowerConfig(512, 12, 8))
    vocab_size: int = 49408
    context_length: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    #: EOT/EOS token id for text pooling; None = argmax convention (OpenAI
    #: CLIP's EOT is the highest vocab id, so argmax finds it).
    eot_token_id: int | None = None
    #: Text tower architecture: "clip" (causal pre-LN transformer, EOT
    #: pooling) or "bert" (ChineseCLIP: bidirectional post-LN BERT with
    #: padding mask, CLS pooling).
    text_arch: str = "clip"
    text_hidden_act: str | None = None  # None -> hidden_act ("gelu" for bert)
    text_layer_norm_eps: float | None = None  # None -> layer_norm_eps
    pad_token_id: int = 0  # bert padding-mask id ([PAD]=0 for BERT vocabs)
    #: Serving-side text length cap (BERT checkpoints carry a 512-row
    #: position table but queries are short; the tower slices positions
    #: to the input's length, so the tokenizer/batcher pad to this).
    text_serving_length: int | None = None
    #: int8 tower blocks (None | "int8"), set by the serving layer
    #: (``CLIPManager(quantize="int8")``), not by checkpoints.
    weight_quant: str | None = None
    weight_quant_kernel: str = "dynamic"

    @property
    def serving_text_length(self) -> int:
        return min(self.text_serving_length or self.context_length, self.context_length)

    @classmethod
    def tiny(cls) -> "CLIPConfig":
        """Small config for tests (fast CPU parity runs)."""
        return cls(
            embed_dim=32,
            image_size=32,
            patch_size=16,
            vision=TowerConfig(64, 2, 4),
            text=TowerConfig(48, 2, 4),
            vocab_size=128,
            context_length=16,
        )

    @classmethod
    def from_hf(cls, cfg: dict[str, Any]) -> "CLIPConfig":
        """Build from an HF ``CLIPConfig``-style dict (``config.json``).
        ChineseCLIP (CN-CLIP) configs are recognized by their BERT-shaped
        text_config and mapped to the ``bert`` text arch."""
        v, t = cfg["vision_config"], cfg["text_config"]
        is_cnclip = (
            cfg.get("model_type") == "chinese_clip"
            or t.get("model_type") == "chinese_clip_text_model"
        )
        is_bert = is_cnclip or "type_vocab_size" in t
        return cls(
            embed_dim=cfg.get("projection_dim", 512),
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 32),
            vision=TowerConfig(
                v.get("hidden_size", 768),
                v.get("num_hidden_layers", 12),
                v.get("num_attention_heads", 12),
            ),
            text=TowerConfig(
                t.get("hidden_size", 768 if is_bert else 512),
                t.get("num_hidden_layers", 12),
                t.get("num_attention_heads", 12 if is_bert else 8),
            ),
            vocab_size=t.get("vocab_size", 21128 if is_bert else 49408),
            context_length=t.get("max_position_embeddings", 512 if is_bert else 77),
            eot_token_id=t.get("eos_token_id"),
            hidden_act=v.get("hidden_act", "quick_gelu"),
            layer_norm_eps=v.get("layer_norm_eps", 1e-5),
            text_arch="bert" if is_bert else "clip",
            text_hidden_act=t.get("hidden_act", "gelu") if is_bert else None,
            text_layer_norm_eps=t.get("layer_norm_eps", 1e-12) if is_bert else None,
            pad_token_id=t.get("pad_token_id", 0),
            # CN-CLIP's published context is 52 tokens; pad to that, not to
            # the checkpoint's 512-row position table.
            text_serving_length=52 if is_cnclip else None,
        )


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        # HF "gelu" is the exact erf form.
        return lambda x: F.gelu(x, approximate="none")
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    return getattr(F, name)


def _block_dense(in_features: int, out_features: int, quant: str | None, quant_kernel: str) -> nn.Module:
    """Projection factory for the transformer blocks (JAX
    ``_block_dense``): ``QDense`` when int8."""
    if quant == "int8":
        return QDense(in_features, out_features, kernel_mode=quant_kernel)
    if quant is not None:
        raise ValueError(f"weight_quant must be None or 'int8', got {quant!r}")
    return nn.Linear(in_features, out_features)


def _local_width(n: int, tp: TensorParallel | None) -> int:
    """This rank's share of a width-split dimension of ``n`` (all of it
    when the split does not divide)."""
    return n // tp.size if tp is not None and tp.split(n) is not None else n


class Attention(nn.Module):
    """Multi-head self-attention; ``attention`` is the function it calls
    on ``[B, H, S, D]`` heads, or None for this module's ``attention``
    (the ``ops.attention`` dispatch: the flash kernel on CUDA tensors),
    looked up at each call. With ``tp`` it holds this rank's heads and sums
    the ``out_proj`` partials."""

    def __init__(
        self, width: int, heads: int, quant: str | None = None, quant_kernel: str = "dynamic", attention=None,
        tp: TensorParallel | None = None,
    ):
        super().__init__()
        self.width, self.heads = width, heads
        self.attention = attention
        self.tp = tp
        plan = tp.attn_plan(heads, heads) if tp is not None else None
        self.split = plan is not None and plan.split
        self.local_heads = plan.q_heads if self.split else heads
        inner = self.local_heads * (width // heads)
        self.q_proj = _block_dense(width, inner, quant, quant_kernel)
        self.k_proj = _block_dense(width, inner, quant, quant_kernel)
        self.v_proj = _block_dense(width, inner, quant, quant_kernel)
        self.out_proj = _block_dense(inner, width, quant, quant_kernel)

    def forward(self, x: torch.Tensor, causal: bool = False, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, s, _ = x.shape
        hd = self.width // self.heads

        def heads(t):
            return t.reshape(b, s, self.local_heads, hd).transpose(1, 2).contiguous()

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        out = (self.attention or attention)(q, k, v, mask=mask, causal=causal)
        return row_parallel(self.out_proj, out.transpose(1, 2).reshape(b, s, self.local_heads * hd), self.tp,
                            self.split)


class Mlp(nn.Module):
    def __init__(
        self, width: int, hidden_act: str, quant: str | None = None, quant_kernel: str = "dynamic",
        tp: TensorParallel | None = None,
    ):
        super().__init__()
        self.tp = tp
        inner = _local_width(width * 4, tp)
        self.split = inner != width * 4
        self.fc1 = _block_dense(width, inner, quant, quant_kernel)
        self.fc2 = _block_dense(inner, width, quant, quant_kernel)
        self.act = _act(hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_parallel(self.fc2, self.act(self.fc1(x)), self.tp, self.split)


class Block(nn.Module):
    """Pre-LN residual block (CLIP layout)."""

    def __init__(
        self, width: int, heads: int, hidden_act: str, eps: float,
        quant: str | None = None, quant_kernel: str = "dynamic", attention=None,
        tp: TensorParallel | None = None,
    ):
        super().__init__()
        self.ln1 = nn.LayerNorm(width, eps=eps)
        self.attn = Attention(width, heads, quant, quant_kernel, attention, tp)
        self.ln2 = nn.LayerNorm(width, eps=eps)
        self.mlp = Mlp(width, hidden_act, quant, quant_kernel, tp)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), causal=causal)
        return x + self.mlp(self.ln2(x))


class BertBlock(nn.Module):
    """Post-LN residual block (BERT layout, ChineseCLIP's text encoder):
    LayerNorm AFTER each residual add, bidirectional attention with a
    padding mask."""

    def __init__(self, width: int, heads: int, hidden_act: str, eps: float, attention=None,
                 tp: TensorParallel | None = None):
        super().__init__()
        self.attn = Attention(width, heads, attention=attention, tp=tp)
        self.ln1 = nn.LayerNorm(width, eps=eps)
        self.mlp = Mlp(width, hidden_act, tp=tp)
        self.ln2 = nn.LayerNorm(width, eps=eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.attn(x, mask=mask))
        return self.ln2(x + self.mlp(x))


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as reshape + matmul (JAX
    ``PatchEmbed``). Input ``[B, H, W, C]`` channels-last, as in the JAX
    package; ``weight`` is ``[width, P*P*C]`` over patches flattened in
    (row, column, channel) order."""

    def __init__(self, width: int, patch: int, channels: int = 3, use_bias: bool = False):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(width, patch * patch * channels))
        self.bias = nn.Parameter(torch.zeros(width)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        return F.linear(x, self.weight, self.bias)


def _run_blocks(blocks: nn.ModuleList, x: torch.Tensor, remat: bool, *args) -> torch.Tensor:
    """Apply the blocks in turn; with ``remat`` each block is checkpointed
    (its input saved, its activations recomputed in the backward)."""
    for blk in blocks:
        x = checkpoint(blk, x, *args, use_reentrant=False) if remat else blk(x, *args)
    return x


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, attention=None, remat: bool = False, tp: TensorParallel | None = None):
        super().__init__()
        v = cfg.vision
        self.remat = remat
        self.tp = tp
        self.patch_embed = PatchEmbed(v.width, cfg.patch_size)
        self.class_embedding = nn.Parameter(torch.zeros(v.width))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Parameter(torch.zeros(n_pos, _local_width(v.width, tp)))
        self.pre_ln = nn.LayerNorm(v.width, eps=cfg.layer_norm_eps)
        self.blocks = nn.ModuleList(
            Block(v.width, v.heads, cfg.hidden_act, cfg.layer_norm_eps, cfg.weight_quant, cfg.weight_quant_kernel,
                  attention, tp)
            for _ in range(v.layers)
        )
        self.post_ln = nn.LayerNorm(v.width, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(v.width, cfg.embed_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] preprocessed floats -> [B, embed_dim] (unnormalized)."""
        x = self.patch_embed(pixel_values)
        cls_tok = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        pos = self.position_embedding
        if self.tp is not None:
            pos = self.tp.gather(pos, x.shape[-1])
        x = torch.cat([cls_tok, x], dim=1) + pos.to(x.dtype)
        x = _run_blocks(self.blocks, self.pre_ln(x), self.remat)
        return self.projection(self.post_ln(x[:, 0]))


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, attention=None, remat: bool = False, tp: TensorParallel | None = None):
        super().__init__()
        t = cfg.text
        self.cfg = cfg
        self.remat = remat
        self.tp = tp
        local = _local_width(t.width, tp)
        self.token_embedding = nn.Embedding(cfg.vocab_size, local)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.context_length, local))
        self.blocks = nn.ModuleList(
            Block(t.width, t.heads, cfg.hidden_act, cfg.layer_norm_eps, cfg.weight_quant, cfg.weight_quant_kernel,
                  attention, tp)
            for _ in range(t.layers)
        )
        self.final_ln = nn.LayerNorm(t.width, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(t.width, cfg.embed_dim, bias=False)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, S] token ids (right-padded) -> [B, embed_dim] pooled at the
        EOT position (the configured EOT id's first occurrence, or the
        argmax of the ids: OpenAI CLIP's EOT is the highest id)."""
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids)
        x = x + self.position_embedding[:s].to(x.dtype)
        if self.tp is not None:
            x = self.tp.gather(x, self.cfg.text.width)
        x = self.final_ln(_run_blocks(self.blocks, x, self.remat, True))
        eot_id = self.cfg.eot_token_id
        if eot_id is not None:
            eot = torch.argmax((input_ids == eot_id).int(), dim=-1)
        else:
            eot = torch.argmax(input_ids, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return self.projection(pooled)


class BertTextTower(nn.Module):
    """ChineseCLIP text tower: BERT encoder + CLS pooling + projection."""

    def __init__(self, cfg: CLIPConfig, attention=None, remat: bool = False, tp: TensorParallel | None = None):
        super().__init__()
        t = cfg.text
        self.cfg = cfg
        self.remat = remat
        self.tp = tp
        eps = cfg.text_layer_norm_eps or cfg.layer_norm_eps
        act = cfg.text_hidden_act or "gelu"
        local = _local_width(t.width, tp)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, local)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.context_length, local))
        # Single-segment inputs: token type 0 everywhere (the table is kept
        # 2-row for checkpoint parity).
        self.token_type_embedding = nn.Parameter(torch.zeros(2, local))
        self.embed_ln = nn.LayerNorm(t.width, eps=eps)
        self.blocks = nn.ModuleList(BertBlock(t.width, t.heads, act, eps, attention, tp) for _ in range(t.layers))
        self.projection = nn.Linear(t.width, cfg.embed_dim, bias=False)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        x = self.word_embeddings(input_ids)
        x = x + self.position_embedding[:s].to(x.dtype) + self.token_type_embedding[0].to(x.dtype)
        if self.tp is not None:
            x = self.tp.gather(x, self.cfg.text.width)
        x = self.embed_ln(x)
        # Bidirectional with right-padding masked out: [B, 1, 1, S].
        mask = (input_ids != self.cfg.pad_token_id)[:, None, None, :]
        x = _run_blocks(self.blocks, x, self.remat, mask)
        return self.projection(x[:, 0])  # [CLS]


class CLIPModel(nn.Module):
    """Dual-tower CLIP; ``logit_scale`` is the exported temperature (its
    log).

    ``attention`` is what every block's attention calls: by default
    (None) the ``ops.attention`` dispatch (the flash kernel on CUDA
    tensors, which has no backward); the trainer passes
    ``attention_reference``. ``remat`` checkpoints each transformer block
    (training only)."""

    def __init__(self, cfg: CLIPConfig, attention=None, remat: bool = False, tp: TensorParallel | None = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.vision = VisionTower(cfg, attention, remat, tp)
        text = BertTextTower if cfg.text_arch == "bert" else TextTower
        self.text = text(cfg, attention, remat, tp)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, pixel_values: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        return _maybe_normalize(self.vision(pixel_values), normalize)

    def encode_text(self, input_ids: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        return _maybe_normalize(self.text(input_ids), normalize)

    def forward(self, pixel_values: torch.Tensor, input_ids: torch.Tensor) -> dict:
        img = self.encode_image(pixel_values)
        txt = self.encode_text(input_ids)
        logits_per_image = torch.exp(self.logit_scale.float()) * img @ txt.T
        return {
            "image_embeds": img,
            "text_embeds": txt,
            "logits_per_image": logits_per_image,
            "logits_per_text": logits_per_image.T,
        }


def _maybe_normalize(z: torch.Tensor, normalize: bool) -> torch.Tensor:
    if not normalize:
        return z
    # fp32 norm regardless of compute dtype; unit-norm output is the
    # backend contract.
    z32 = z.float()
    return z32 / torch.clamp(torch.linalg.vector_norm(z32, dim=-1, keepdim=True), min=1e-12)
