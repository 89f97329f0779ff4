"""A seeded stand-in for FastVLM's exported vision tower (FastViTHD plus the
``mlp2x_gelu`` projector), for writing ``vision_encoder.onnx`` test
directories.

The real ``FastVLM-0.5B`` files are not in the repository. The stand-in
keeps the tower's contract on the wire -- ``[B, 3, S, S]`` normalized
pixels in, ``[B, (S / 64)^2, 896]`` projector-space tokens out -- and the
layout of ``apple/ml-fastvlm``'s ``fastvithd`` (``mci.py``) as far as it
is known here (``PERF.md`` §4 lists each width and marks the ones that
are not certain), in its inference-mode (reparameterized) form:

- a stem of three convolutions (3x3 stride 2, depthwise 3x3 stride 2,
  1x1), each with GELU: stride 4;
- five stages of ``layers`` blocks at ``embed_dims`` channels, a
  patch-embedding between stages (a 7x7 stride-2 convolution grouped by
  input channel, then 1x1, each with GELU): stride 64 in all;
- RepMixer blocks in the first three stages (a depthwise 3x3 token mixer,
  then a ConvFFN: depthwise 7x7 + BatchNorm, 1x1 up by ``mlp_ratio``,
  GELU, 1x1 down, behind a layer scale);
- attention blocks in the last two, each stage opened by a conditional
  positional encoding (a depthwise 7x7 convolution with a residual): a
  channel LayerNorm (``ReduceMean``/``Pow``/``Sqrt`` in the export), then
  multi-head self-attention over the flattened grid at head_dim 32 (a 5-D
  ``qkv`` reshape), then the ConvFFN, both behind layer scales;
- a 3x3 expansion to ``cls_ratio`` times the last width (grouped by the
  input channel) with squeeze-excite (``GlobalAveragePool``), GELU;
- the projector: ``Linear(3072, 896)``, exact (``Erf``) GELU,
  ``Linear(896, 896)`` over the 256 tokens of a 1024-pixel image.

Weights are seeded He-normal draws (so activations keep their scale
through the tower's 40-odd convolutions), the RepMixer token mixers an
identity kernel plus a layer-scaled draw (what reparameterization folds a
trained mixer into), the layer scales at FastViT's 1e-5, BatchNorm
statistics seeded away from the identity so the normalization does
arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class FastViTHDConfig:
    """Widths of the stand-in; the defaults are ``fastvithd``'s as recalled
    (``PERF.md`` §4) with FastVLM-0.5B's decoder width as the projector's."""

    layers: tuple[int, ...] = (2, 12, 24, 4, 2)
    embed_dims: tuple[int, ...] = (96, 192, 384, 768, 1536)
    mixers: tuple[str, ...] = ("repmixer", "repmixer", "repmixer", "attention", "attention")
    mlp_ratio: float = 4.0
    head_dim: int = 32
    cls_ratio: float = 2.0
    se_ratio: float = 0.0625
    hidden_size: int = 896
    image_size: int = 1024
    layer_scale: float = 1e-5

    @property
    def num_tokens(self) -> int:
        return (self.image_size // 64) ** 2

    @property
    def out_width(self) -> int:
        return int(self.embed_dims[-1] * self.cls_ratio)

    @classmethod
    def tiny(cls, hidden_size: int = 32, image_size: int = 128) -> "FastViTHDConfig":
        """The same layout at CPU-test widths: one block a stage."""
        return cls(layers=(1, 1, 1, 1, 1), embed_dims=(8, 8, 16, 16, 32), head_dim=8, hidden_size=hidden_size,
                   image_size=image_size, layer_scale=0.1)


def _conv_act(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups), nn.GELU())


class LayerNormChannel(nn.Module):
    """LayerNorm over the channels of ``[B, C, H, W]``, written out as
    FastViT writes it (the export's ``ReduceMean``/``Pow``/``Sqrt``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class ConvFFN(nn.Module):
    def __init__(self, dim: int, ratio: float):
        super().__init__()
        hidden = int(dim * ratio)
        self.conv = nn.Conv2d(dim, dim, 7, 1, 3, groups=dim, bias=False)
        self.bn = nn.BatchNorm2d(dim)
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.bn(self.conv(x)))))


class RepMixerBlock(nn.Module):
    def __init__(self, dim: int, ratio: float, layer_scale: float):
        super().__init__()
        self.mixer = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)
        self.ffn = ConvFFN(dim, ratio)
        self.scale = nn.Parameter(torch.full((dim, 1, 1), layer_scale))

    def forward(self, x):
        x = self.mixer(x)
        return x + self.scale * self.ffn(x)


class Attention(nn.Module):
    def __init__(self, dim: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = dim // head_dim, head_dim
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        t = x.flatten(2).transpose(1, 2)  # [B, N, C]
        qkv = self.qkv(t).reshape(b, n, 3, self.heads, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = torch.softmax((q * self.head_dim**-0.5) @ k.transpose(-2, -1), dim=-1)
        t = self.proj((att @ v).transpose(1, 2).reshape(b, n, c))
        return t.transpose(1, 2).reshape(b, c, h, w)


class AttentionBlock(nn.Module):
    def __init__(self, dim: int, ratio: float, head_dim: int, layer_scale: float):
        super().__init__()
        self.norm = LayerNormChannel(dim)
        self.attn = Attention(dim, head_dim)
        self.ffn = ConvFFN(dim, ratio)
        self.scale1 = nn.Parameter(torch.full((dim, 1, 1), layer_scale))
        self.scale2 = nn.Parameter(torch.full((dim, 1, 1), layer_scale))

    def forward(self, x):
        x = x + self.scale1 * self.attn(self.norm(x))
        return x + self.scale2 * self.ffn(x)


class PosConv(nn.Module):
    """Conditional positional encoding (RepCPE, reparameterized):
    ``x + dwconv7x7(x)``."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 7, 1, 3, groups=dim)

    def forward(self, x):
        return x + self.conv(x)


class SqueezeExcite(nn.Module):
    def __init__(self, dim: int, ratio: float):
        super().__init__()
        self.reduce = nn.Conv2d(dim, int(dim * ratio), 1)
        self.expand = nn.Conv2d(int(dim * ratio), dim, 1)

    def forward(self, x):
        s = F.adaptive_avg_pool2d(x, 1)
        return x * torch.sigmoid(self.expand(F.relu(self.reduce(s))))


class FastViTHDTower(nn.Module):
    """``[B, 3, S, S]`` normalized pixels -> ``[B, (S/64)^2, hidden_size]``."""

    def __init__(self, cfg: FastViTHDConfig = FastViTHDConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dims
        self.stem = nn.Sequential(_conv_act(3, d[0], 3, 2), _conv_act(d[0], d[0], 3, 2, groups=d[0]),
                                  _conv_act(d[0], d[0], 1))
        stages = []
        for i, (n, dim, mixer) in enumerate(zip(cfg.layers, d, cfg.mixers)):
            mods: list[nn.Module] = []
            if i > 0:
                mods += [_conv_act(d[i - 1], dim, 7, 2, groups=d[i - 1]), _conv_act(dim, dim, 1)]
            if mixer == "attention":
                mods.append(PosConv(dim))
                mods += [AttentionBlock(dim, cfg.mlp_ratio, cfg.head_dim, cfg.layer_scale) for _ in range(n)]
            else:
                mods += [RepMixerBlock(dim, cfg.mlp_ratio, cfg.layer_scale) for _ in range(n)]
            stages.append(nn.Sequential(*mods))
        self.stages = nn.Sequential(*stages)
        self.expand = nn.Conv2d(d[-1], cfg.out_width, 3, 1, 1, groups=d[-1])
        self.se = SqueezeExcite(cfg.out_width, cfg.se_ratio)
        self.proj_fc1 = nn.Linear(cfg.out_width, cfg.hidden_size)
        self.proj_fc2 = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        f = self.stages(self.stem(x))
        f = F.gelu(self.se(self.expand(f)))
        t = f.flatten(2).transpose(1, 2)  # [B, N, 3072]
        return self.proj_fc2(F.gelu(self.proj_fc1(t)))


def fastvithd_standin(seed: int, cfg: FastViTHDConfig = FastViTHDConfig()) -> FastViTHDTower:
    """The stand-in with seeded weights (see the module docstring), in eval
    mode on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    tower = FastViTHDTower(cfg)
    with torch.no_grad():
        for name, m in tower.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.02)
                if name.endswith(".mixer"):
                    m.weight.mul_(cfg.layer_scale)
                    m.weight[:, 0, 1, 1] += 1.0
            elif isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return tower.eval()
