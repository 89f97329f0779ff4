"""Seeded stand-ins for the InsightFace ``buffalo_l`` pack's two graphs, at
their published contracts and widths, for exporting test packs.

Copied from ``scripts/run_arch_parity.py`` (``_torch_iresnet50``,
``_torch_scrfd``, ``_randomize_bn_stats``; PARITY.md) so that the port and
``chip_smoke.py`` need nothing of that script; the IResNet takes its depth,
width, embedding size and input size as arguments (the script builds the
r50 defaults):

- :func:`iresnet_insightface` — torch IResNet in the exact InsightFace
  ``iresnet.py`` layout (``w600k_r50.onnx``'s: 3/4/14/3 blocks, PReLU,
  112x112 -> 512, 43,629,071 params at the defaults);
- :func:`scrfd_det10g` — SCRFD-shaped detector with ``det_10g.onnx``'s
  output contract (3 strides, 2 anchors, 9 outputs, 640x640; 5,840,644
  params);
- :func:`randomize_bn_stats` — BatchNorm statistics and affine params far
  from their init, from a seed.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def iresnet_insightface(layers=(3, 4, 14, 3), width: int = 64, embed: int = 512, input_size: int = 112) -> nn.Module:
    """torch IResNet in the exact InsightFace ``iresnet.py`` layout: key
    names (conv1/bn1/prelu, layerS.I.{bn1,conv1,bn2,prelu,conv2,bn3,
    downsample.0,downsample.1}, bn2, fc, features), block op order
    (BN->conv->BN->PReLU->conv->BN + shortcut), and epsilons (1e-5 blocks,
    2e-5 features BN) — the layout ``convert_iresnet`` targets. Takes
    NCHW pixels."""

    class IBasicBlock(nn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            self.bn1 = nn.BatchNorm2d(cin, eps=1e-5)
            self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)
            self.prelu = nn.PReLU(cout)
            self.conv2 = nn.Conv2d(cout, cout, 3, stride, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(cout, eps=1e-5)
            if stride != 1 or cin != cout:
                self.downsample = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride, bias=False),
                    nn.BatchNorm2d(cout, eps=1e-5),
                )
            else:
                self.downsample = None

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            y = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
            return y + idt

    class IResNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, width, 3, 1, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
            self.prelu = nn.PReLU(width)
            cin = width
            for s, n in enumerate(layers):
                cout = width * (2 ** s)
                blocks = []
                for i in range(n):
                    blocks.append(IBasicBlock(cin, cout, 2 if i == 0 else 1))
                    cin = cout
                setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            self.bn2 = nn.BatchNorm2d(cin, eps=1e-5)
            hw = input_size // 16
            self.fc = nn.Linear(cin * hw * hw, embed)
            self.features = nn.BatchNorm1d(embed, eps=2e-5)

        def forward(self, x):
            x = self.prelu(self.bn1(self.conv1(x)))
            for s in range(len(layers)):
                x = getattr(self, f"layer{s + 1}")(x)
            x = self.bn2(x)
            x = torch.flatten(x, 1)
            return self.features(self.fc(x))

    return IResNet()


def scrfd_det10g(width: int = 40) -> nn.Module:
    """SCRFD-shaped detector: ResNet backbone -> PAFPN neck -> per-stride
    heads emitting det_10g's 9-output contract (3 scores [B,M,1] post-
    sigmoid, 3 bbox [B,M,4], 3 kps [B,M,10]; anchor-major, stride units;
    reference ``insightface_specs.py:11-159``, ``onnxrt_backend.py:882-1154``).
    Takes NCHW pixels."""
    NA = 2  # anchors per cell

    class Res(nn.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.c1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.b1 = nn.BatchNorm2d(cout)
            self.c2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.b2 = nn.BatchNorm2d(cout)
            self.down = (
                nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))
                if (stride != 1 or cin != cout) else None
            )

        def forward(self, x):
            idt = x if self.down is None else self.down(x)
            y = F.relu(self.b1(self.c1(x)))
            return F.relu(idt + self.b2(self.c2(y)))

    class Head(nn.Module):
        def __init__(self, c):
            super().__init__()
            self.stack = nn.Sequential(Res(c, c), Res(c, c))
            self.score = nn.Conv2d(c, NA * 1, 3, 1, 1)
            self.bbox = nn.Conv2d(c, NA * 4, 3, 1, 1)
            self.kps = nn.Conv2d(c, NA * 10, 3, 1, 1)

        def forward(self, x):
            b = x.shape[0]
            f = self.stack(x)

            def flat(t, ch):
                # [B, NA*ch, H, W] -> anchor-major [B, H*W*NA, ch]
                h, w = t.shape[2], t.shape[3]
                return t.view(b, NA, ch, h, w).permute(0, 3, 4, 1, 2).reshape(b, -1, ch)

            # Trained SCRFD regresses positive distances; random weights
            # don't, which would make nearly every decoded box degenerate
            # (x2 < x1). abs()+0.5 keeps the stand-in's boxes valid without
            # changing the output contract.
            return (
                torch.sigmoid(flat(self.score(f), 1)),
                flat(self.bbox(f), 4).abs() + 0.5,
                flat(self.kps(f), 10),
            )

    class SCRFD(nn.Module):
        def __init__(self, w=width):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, w, 3, 2, 1, bias=False), nn.BatchNorm2d(w), nn.ReLU(),
                Res(w, w),
            )
            self.s8 = nn.Sequential(Res(w, w * 2, 2), Res(w * 2, w * 2), Res(w * 2, w * 2))
            self.s16 = nn.Sequential(Res(w * 2, w * 4, 2), Res(w * 4, w * 4), Res(w * 4, w * 4))
            self.s32 = nn.Sequential(Res(w * 4, w * 8, 2), Res(w * 8, w * 8))
            c = w * 2
            self.l8 = nn.Conv2d(w * 2, c, 1)
            self.l16 = nn.Conv2d(w * 4, c, 1)
            self.l32 = nn.Conv2d(w * 8, c, 1)
            self.smooth8 = nn.Conv2d(c, c, 3, 1, 1)
            self.smooth16 = nn.Conv2d(c, c, 3, 1, 1)
            self.heads = nn.ModuleList([Head(c) for _ in range(3)])

        def forward(self, x):
            x = self.stem(x)          # stride 2... pooled to 4 below
            x = F.max_pool2d(x, 2)    # stride 4
            f8 = self.s8(x)           # stride 8
            f16 = self.s16(f8)        # stride 16
            f32 = self.s32(f16)       # stride 32
            p32 = self.l32(f32)
            p16 = self.smooth16(self.l16(f16) + F.interpolate(p32, scale_factor=2.0, mode="nearest"))
            p8 = self.smooth8(self.l8(f8) + F.interpolate(p16, scale_factor=2.0, mode="nearest"))
            s8, b8, k8 = self.heads[0](p8)
            s16, b16, k16 = self.heads[1](p16)
            s32, b32, k32 = self.heads[2](p32)
            return s8, s16, s32, b8, b16, b32, k8, k16, k32

    return SCRFD()


def randomize_bn_stats(model: nn.Module, seed: int) -> None:
    """Random-but-realistic BN running stats + affine params: a published
    checkpoint's stats are far from the (0, 1) init, so parity must survive
    non-trivial normalization at every layer."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_mean") and m.running_mean is not None:
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                if m.weight is not None:
                    m.weight.normal_(1.0, 0.1, generator=g)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1, generator=g)


def native_face_checkpoint(module: nn.Module) -> dict[str, torch.Tensor]:
    """The port's ``FaceDetector`` / ``IResNet`` state as a native checkpoint
    (the JAX package's '/'-pathed Flax variables, ``params/`` and
    ``batch_stats/``): the inverse of ``face_params_from_jax``, for writing
    ``detection.safetensors`` / ``recognition.safetensors`` test packs."""
    out = {}
    for key, t in module.state_dict().items():
        *parents, name = key.split(".")
        if name == "weight" and t.ndim >= 2:
            coll, leaf, t = "params", "kernel", (t.permute(2, 3, 1, 0) if t.ndim == 4 else t.t())
        else:
            coll, leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"), "alpha": ("params", "alpha"),
                          "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}[name]
        out["/".join([coll, *parents, leaf])] = t.detach().contiguous().cpu()
    return out
