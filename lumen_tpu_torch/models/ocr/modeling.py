"""OCR models in PyTorch: DBNet text detector + SVTR-style CTC recognizer +
textline orientation classifier (the port of ``lumen_tpu/models/ocr/
modeling.py``).

The reference runs PaddleOCR ONNX graphs opaquely and implements the
pipeline logic around them
(``packages/lumen-ocr/src/lumen_ocr/backends/onnxrt_backend.py:43-633``).
Here the nets are explicit ``nn.Module``s with the JAX package's
architecture and parameter tree (``ocr_params_from_jax`` in ``convert.py``
maps one onto the other):

- :class:`DBNet` — differentiable-binarization detector: ResNet-ish
  backbone (strides 4/8/16/32), FPN fusion to stride 4, head with two 2x
  transposed convs back to full resolution, sigmoid probability map.
- :class:`SVTRRecognizer` — attention-based text recognizer: conv patch
  embedding collapses height 48 -> 12 and width /4, global-mixing
  transformer blocks (their attention is the ``flash_attention`` kernel on
  the card, head_dim 16 at the default width), mean-pool over height,
  per-timestep vocab logits for CTC decode (blank 0).
- :class:`TextlineClassifier` — the PP-OCR ``cls`` shape: crops -> logits
  over (0deg, 180deg).

They take NCHW input (the manager transposes the NHWC pixels). All
BatchNorms run in inference mode with Flax's epsilon (1e-5); the LayerNorms
take ``cfg.eps``. The JAX ``ConvTranspose`` correlates an un-flipped kernel
over the stride-dilated input with ``SAME`` padding; at kernel 2, stride 2
that is ``nn.ConvTranspose2d`` with the kernel flipped in both spatial
dims, which ``convert.py`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import attention
from ..face.modeling import BatchNorm, ConvBnAct, ResBlock

__all__ = [
    "BatchNorm",
    "ClsConfig",
    "ConvBnAct",
    "DBNet",
    "DBNetConfig",
    "ResBlock",
    "SVTRConfig",
    "SVTRRecognizer",
    "TextlineClassifier",
]


@dataclass(frozen=True)
class DBNetConfig:
    width: int = 64  # backbone base width
    fpn_width: int = 256
    head_width: int = 64

    @classmethod
    def tiny(cls) -> "DBNetConfig":
        return cls(width=8, fpn_width=16, head_width=8)


class DBNet(nn.Module):
    """[B, 3, H, W] normalized floats -> [B, H, W] float32 probability map
    in [0, 1]. H and W must be multiples of 32 (the manager's letterbox
    buckets guarantee it)."""

    def __init__(self, cfg: DBNetConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.stem = ConvBnAct(3, w, stride=2)  # /2
        self.stage1 = ResBlock(w, w, stride=2)  # /4
        self.stage2 = ResBlock(w, w * 2, stride=2)  # /8
        self.stage3 = ResBlock(w * 2, w * 4, stride=2)  # /16
        self.stage4 = ResBlock(w * 4, w * 8, stride=2)  # /32
        quarter = max(cfg.fpn_width // 4, 1)
        for i, c in enumerate((w, w * 2, w * 4, w * 8)):
            setattr(self, f"lateral{i}", ConvBnAct(c, cfg.fpn_width, kernel=1))
            setattr(self, f"smooth{i}", ConvBnAct(cfg.fpn_width, quarter))
        self.head_conv = ConvBnAct(4 * quarter, cfg.head_width)
        self.head_up1 = nn.ConvTranspose2d(cfg.head_width, cfg.head_width, 2, 2, bias=False)
        self.head_bn1 = BatchNorm(cfg.head_width)
        self.head_up2 = nn.ConvTranspose2d(cfg.head_width, 1, 2, 2)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for stage in (self.stage1, self.stage2, self.stage3, self.stage4):
            x = stage(x)
            feats.append(x)
        # FPN: lateral 1x1 to fpn_width, top-down nearest-up add (exact
        # power-of-two factors, where torch's nearest is jax.image.resize's).
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(len(laterals) - 2, -1, -1):
            laterals[i] = laterals[i] + F.interpolate(laterals[i + 1], size=laterals[i].shape[2:], mode="nearest")
        # Smooth each level to fpn_width/4 and concat at stride 4.
        target = laterals[0].shape[2:]
        merged = []
        for i, lat in enumerate(laterals):
            p = getattr(self, f"smooth{i}")(lat)
            if p.shape[2:] != target:
                p = F.interpolate(p, size=target, mode="nearest")
            merged.append(p)
        h = self.head_conv(torch.cat(merged, dim=1))
        h = torch.relu(self.head_bn1(self.head_up1(h)))
        h = self.head_up2(h)
        return torch.sigmoid(h[:, 0].float())


# -- recognizer -------------------------------------------------------------


@dataclass(frozen=True)
class SVTRConfig:
    vocab_size: int = 6625  # ppocr_keys_v1 (6623) + blank + space
    height: int = 48
    max_width: int = 640  # widest rec bucket; pos embed is sized for it
    width: int = 64  # embed dim
    heads: int = 4
    layers: int = 4
    hidden_act: str = "gelu"
    eps: float = 1e-6

    @classmethod
    def tiny(cls, vocab_size: int = 40) -> "SVTRConfig":
        return cls(vocab_size=vocab_size, height=32, max_width=64, width=16, heads=2, layers=1)


class _MixBlock(nn.Module):
    """Pre-LN residual transformer block, global token mixing."""

    def __init__(self, width: int, heads: int, hidden_act: str, eps: float):
        super().__init__()
        self.heads = heads
        self.ln1 = nn.LayerNorm(width, eps=eps)
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)
        self.ln2 = nn.LayerNorm(width, eps=eps)
        self.fc1 = nn.Linear(width, width * 4)
        self.fc2 = nn.Linear(width * 4, width)

    def forward(self, x):
        b, s, w = x.shape
        h = self.ln1(x)
        split = lambda t: t.reshape(b, s, self.heads, w // self.heads).transpose(1, 2).contiguous()  # noqa: E731
        q, k, v = split(self.q_proj(h)), split(self.k_proj(h)), split(self.v_proj(h))
        attn = attention(q, k, v).transpose(1, 2).reshape(b, s, w)
        x = x + self.out_proj(attn)
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class SVTRRecognizer(nn.Module):
    """[B, 3, height, W] normalized crops -> [B, W//4, vocab] CTC logits
    (two stride-2 stages in the patch embed)."""

    def __init__(self, cfg: SVTRConfig):
        super().__init__()
        self.cfg = cfg
        self.patch1 = ConvBnAct(3, cfg.width // 2, stride=2)  # H/2, W/2
        self.patch2 = ConvBnAct(cfg.width // 2, cfg.width, stride=2)  # H/4, W/4
        # 2D positional grid sized for the widest bucket, sliced per actual
        # width so every bucket shares the same (prefix of) positions.
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.height // 4, cfg.max_width // 4, cfg.width))
        nn.init.normal_(self.pos_embed, std=0.02)
        for i in range(cfg.layers):
            setattr(self, f"block{i}", _MixBlock(cfg.width, cfg.heads, cfg.hidden_act, cfg.eps))
        self.ln_out = nn.LayerNorm(cfg.width, eps=cfg.eps)
        self.ctc_head = nn.Linear(cfg.width, cfg.vocab_size)

    def forward(self, x):
        c = self.cfg
        x = self.patch2(self.patch1(x))
        b, d, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, d)
        tokens = tokens + self.pos_embed[:, :h, :w].reshape(1, h * w, d).to(tokens.dtype)
        for i in range(c.layers):
            tokens = getattr(self, f"block{i}")(tokens)
        tokens = self.ln_out(tokens)
        feat = tokens.reshape(b, h, w, d).mean(dim=1)  # pool height -> [B, T, d]
        return self.ctc_head(feat)


# -- textline orientation classifier ----------------------------------------


@dataclass(frozen=True)
class ClsConfig:
    """PP-OCR ``cls`` model shape: 3x48x192 crops -> 2 classes (0, 180)."""

    height: int = 48
    width: int = 192
    channels: tuple[int, ...] = (16, 32, 64)

    @classmethod
    def tiny(cls) -> "ClsConfig":
        return cls(height=32, width=64, channels=(8, 16))


class TextlineClassifier(nn.Module):
    """[B, 3, H, W] normalized crops -> [B, 2] orientation logits
    (class 0 = upright, class 1 = rotated 180deg)."""

    def __init__(self, cfg: ClsConfig):
        super().__init__()
        self.cfg = cfg
        cin = 3
        for i, c in enumerate(cfg.channels):
            setattr(self, f"conv{i}", ConvBnAct(cin, c, stride=2))
            cin = c
        self.head = nn.Linear(cin, 2)

    def forward(self, x):
        for i in range(len(self.cfg.channels)):
            x = getattr(self, f"conv{i}")(x)
        return self.head(x.mean(dim=(2, 3)))  # global average pool
