"""The CLIP transformer pieces the VLM vision tower borrows (twin of the
matching parts of ``lumen_tpu/models/clip/modeling.py``): ``_act``,
``Attention``, ``Mlp``, the pre-LN ``Block`` and ``PatchEmbed``.

Submodule names follow the Flax parameter tree (``attn/q_proj``,
``ln1``, ``mlp/fc1``, ...) so ``models/vlm/convert.py`` maps one onto
the other by name. The CLIP towers themselves are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.attention import attention


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        # HF "gelu" is the exact erf form.
        return lambda x: F.gelu(x, approximate="none")
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    return getattr(F, name)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width, self.heads = width, heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, s, _ = x.shape
        hd = self.width // self.heads

        def heads(t):
            return t.reshape(b, s, self.heads, hd).transpose(1, 2).contiguous()

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        out = attention(q, k, v, causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, self.width))


class Mlp(nn.Module):
    def __init__(self, width: int, hidden_act: str):
        super().__init__()
        self.fc1 = nn.Linear(width, width * 4)
        self.fc2 = nn.Linear(width * 4, width)
        self.act = _act(hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    """Pre-LN residual block (CLIP layout)."""

    def __init__(self, width: int, heads: int, hidden_act: str, eps: float):
        super().__init__()
        self.ln1 = nn.LayerNorm(width, eps=eps)
        self.attn = Attention(width, heads)
        self.ln2 = nn.LayerNorm(width, eps=eps)
        self.mlp = Mlp(width, hidden_act)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), causal=causal)
        return x + self.mlp(self.ln2(x))


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
