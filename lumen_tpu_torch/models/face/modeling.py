"""Face models in PyTorch: SCRFD-style detector + ArcFace (IResNet) embedder
(the port of ``lumen_tpu/models/face/modeling.py``).

The reference runs InsightFace ONNX packs as opaque graphs and implements
the interesting logic around them (SCRFD decode, alignment —
``packages/lumen-face/src/lumen_face/backends/onnxrt_backend.py:485-1417``).
Here the nets are explicit ``nn.Module``s with the JAX package's
architecture and parameter tree (``face_params_from_jax`` in
``convert.py`` maps one onto the other):

- :class:`FaceDetector` — anchor-free multi-stride detector with SCRFD
  output semantics: per stride s in {8, 16, 32}, ``num_anchors=2`` per cell,
  sigmoid scores, bbox distances (l, t, r, b) and 5-point kps distances,
  decoded by ``distance2bbox``/``distance2kps`` against anchor centers
  (reference decode: ``onnxrt_backend.py:425-470, 882-1154``).
- :class:`IResNet` — InsightFace's ArcFace recognition backbone (r18/r34/
  r50/r100): 3x3 stem, IBasicBlocks with BN-conv-BN-PReLU-conv-BN, final
  BN-dropout-FC-BN to a 512-d embedding.

Both take NHWC pixels, as the JAX modules do, and run NCHW inside. All
BatchNorms run in inference mode (training face models is out of scope).
The decode (:func:`decode_detections`) runs on the device in the batched
call, like the JAX program; its top-k is a stable sort, so equal scores
keep the lower index first as ``lax.top_k`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

# Canonical 5-point ArcFace alignment template for a 112x112 crop
# (lfw/"arcface_src" landmark positions, public InsightFace constant).
ARCFACE_TEMPLATE = (
    (38.2946, 51.6963),
    (73.5318, 51.5014),
    (56.0252, 71.7366),
    (41.5493, 92.3655),
    (70.7299, 92.2041),
)


@dataclass(frozen=True)
class DetectorConfig:
    input_size: int = 640
    strides: tuple[int, ...] = (8, 16, 32)
    num_anchors: int = 2
    num_kps: int = 5
    width: int = 64  # backbone base width
    fpn_width: int = 64

    @classmethod
    def tiny(cls) -> "DetectorConfig":
        return cls(input_size=64, width=8, fpn_width=8)


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 (Flax ``BatchNorm`` with
    ``use_running_average=True``): ``weight``/``bias`` are Flax's
    ``scale``/``bias``, the buffers its ``batch_stats`` ``mean``/``var``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class ConvBnAct(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1, act: bool = True):
        super().__init__()
        # Explicit k//2 padding, as the JAX module pads (torch-compatible
        # at stride 2, where SAME would pad (0, 1) at even sizes).
        self.conv = nn.Conv2d(cin, features, kernel, stride, kernel // 2, bias=False)
        self.bn = BatchNorm(features)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.act else x


class ResBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBnAct(cin, features, stride=stride)
        self.conv2 = ConvBnAct(features, features, act=False)
        self.down = (
            ConvBnAct(cin, features, kernel=1, stride=stride, act=False)
            if stride != 1 or cin != features else None
        )

    def forward(self, x):
        residual = x if self.down is None else self.down(x)
        return torch.relu(self.conv2(self.conv1(x)) + residual)


def _flat(t: torch.Tensor, ch: int) -> torch.Tensor:
    """[B, A*ch, H, W] -> [B, H*W*A, ch], anchor-major per cell (the Flax
    NHWC reshape)."""
    b = t.shape[0]
    return t.permute(0, 2, 3, 1).reshape(b, -1, ch)


class _DetHead(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        a = cfg.num_anchors
        self.num_kps = cfg.num_kps
        self.tower = ConvBnAct(cfg.fpn_width, cfg.fpn_width)
        self.cls = nn.Conv2d(cfg.fpn_width, a, 1)
        self.reg = nn.Conv2d(cfg.fpn_width, 4 * a, 1)
        self.kps = nn.Conv2d(cfg.fpn_width, 2 * cfg.num_kps * a, 1)

    def forward(self, x):
        h = self.tower(x)
        return {
            "scores": _flat(self.cls(h), 1)[..., 0],
            "bbox": _flat(self.reg(h), 4),
            "kps": _flat(self.kps(h), 2 * self.num_kps),
        }


def _nearest_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` on NCHW: source index
    ``floor((i + 0.5) * in / out)`` in float32, per spatial dim."""
    for d, n in ((2, size[0]), (3, size[1])):
        m = x.shape[d]
        if m == n:
            continue
        idx = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n).long()
        x = x.index_select(d, idx)
    return x


class FaceDetector(nn.Module):
    """Multi-stride anchor-free face detector.

    Input: [B, S, S, 3] normalized floats. Output per stride: dict with
    ``scores`` [B, H*W*A], ``bbox`` [B, H*W*A, 4] (distances), ``kps``
    [B, H*W*A, 2*num_kps] (distances), flattened anchor-major like SCRFD.
    """

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.stem = ConvBnAct(3, w, stride=2)  # /2
        self.stage1 = ResBlock(w, w, stride=2)  # /4
        self.stage2 = ResBlock(w, w * 2, stride=2)  # /8
        self.stage3 = ResBlock(w * 2, w * 4, stride=2)  # /16
        self.stage4 = ResBlock(w * 4, w * 8, stride=2)  # /32
        for i, c in enumerate((w * 2, w * 4, w * 8)):
            self.add_module(f"lateral{i}", ConvBnAct(c, cfg.fpn_width, kernel=1))
        self.head = _DetHead(cfg)  # shared across strides

    def forward(self, x):
        x = self.stage1(self.stem(x.permute(0, 3, 1, 2)))
        feats = []
        for stage in (self.stage2, self.stage3, self.stage4):
            x = stage(x)
            feats.append(x)
        # FPN: top-down pathway.
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(len(laterals) - 2, -1, -1):
            laterals[i] = laterals[i] + _nearest_resize(laterals[i + 1], tuple(laterals[i].shape[2:]))
        return {stride: self.head(feat) for stride, feat in zip(self.cfg.strides, laterals)}


# -- ArcFace / IResNet ------------------------------------------------------


@dataclass(frozen=True)
class IResNetConfig:
    layers: tuple[int, ...] = (3, 4, 14, 3)  # r50
    embed_dim: int = 512
    input_size: int = 112
    width: int = 64

    @classmethod
    def r18(cls) -> "IResNetConfig":
        return cls(layers=(2, 2, 2, 2))

    @classmethod
    def r100(cls) -> "IResNetConfig":
        return cls(layers=(3, 13, 30, 3))

    @classmethod
    def tiny(cls) -> "IResNetConfig":
        return cls(layers=(1, 1, 1, 1), width=8, input_size=32, embed_dim=64)


class PReLU(nn.Module):
    """Channel-wise PReLU over dim 1 (``alpha`` is the Flax param)."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype).view(1, -1, 1, 1) * x)


class IBasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = nn.Conv2d(cin, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.prelu = PReLU(features)
        # Symmetric (1, 1) padding at stride 2, as torch IResNet pads (the
        # JAX module pads explicitly for the same reason).
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn3 = BatchNorm(features)
        if stride != 1 or cin != features:
            self.down_conv = nn.Conv2d(cin, features, 1, stride, bias=False)
            self.down_bn = BatchNorm(features)
        else:
            self.down_conv = self.down_bn = None

    def forward(self, x):
        y = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return y + residual


class IResNet(nn.Module):
    """ArcFace recognition net: [B, 112, 112, 3] aligned crops (normalized
    (x-127.5)/127.5 upstream) -> [B, embed_dim] embeddings (unnormalized;
    the manager L2-normalizes, matching the backend contract)."""

    def __init__(self, cfg: IResNetConfig):
        super().__init__()
        self.cfg = cfg
        self.stem_conv = nn.Conv2d(3, cfg.width, 3, 1, 1, bias=False)
        self.stem_bn = BatchNorm(cfg.width)
        self.stem_prelu = PReLU(cfg.width)
        cin = cfg.width
        for stage, blocks in enumerate(cfg.layers):
            feats = cfg.width * (2**stage)
            for i in range(blocks):
                self.add_module(f"layer{stage + 1}_{i}", IBasicBlock(cin, feats, stride=2 if i == 0 else 1))
                cin = feats
        self.final_bn = BatchNorm(cin)
        hw = -(-cfg.input_size // 16)
        self.fc = nn.Linear(cin * hw * hw, cfg.embed_dim)
        self.features = BatchNorm(cfg.embed_dim, eps=2e-5)

    def forward(self, x):
        x = self.stem_prelu(self.stem_bn(self.stem_conv(x.permute(0, 3, 1, 2))))
        for stage, blocks in enumerate(self.cfg.layers):
            for i in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
        x = self.final_bn(x)
        # Flatten in the Flax (H, W, C) order the fc kernel was laid out for.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.features(self.fc(x))


# -- device-side SCRFD decode ----------------------------------------------


def anchor_centers(size: int, stride: int, num_anchors: int, device=None) -> torch.Tensor:
    """[H*W*A, 2] pixel-space anchor centers for one stride (anchor-major
    per cell, matching the SCRFD flattening)."""
    n = size // stride
    ys, xs = torch.meshgrid(torch.arange(n, device=device), torch.arange(n, device=device), indexing="ij")
    pts = torch.stack([xs, ys], dim=-1).reshape(-1, 2) * stride
    return pts.repeat_interleave(num_anchors, dim=0).to(torch.float32)


def distance2bbox(centers: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """(cx, cy) + (l, t, r, b) distances -> (x1, y1, x2, y2)."""
    x1 = centers[..., 0] - distances[..., 0]
    y1 = centers[..., 1] - distances[..., 1]
    x2 = centers[..., 0] + distances[..., 2]
    y2 = centers[..., 1] + distances[..., 3]
    return torch.stack([x1, y1, x2, y2], dim=-1)


def distance2kps(centers: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """[..., 2K] kps distance offsets -> [..., K, 2] absolute points."""
    k = distances.shape[-1] // 2
    d = distances.reshape(*distances.shape[:-1], k, 2)
    return torch.stack(
        [centers[..., None, 0] + d[..., 0], centers[..., None, 1] + d[..., 1]], dim=-1
    )


def decode_detections(
    outputs: dict[int, dict[str, torch.Tensor]],
    input_size: int,
    num_anchors: int,
    stride_scale_distances: bool = True,
    max_detections: int = 128,
    scores_are_logits: bool = True,
):
    """Decode all strides to a fixed-size candidate set on the device.

    Returns (boxes [B, N, 4], kps [B, N, K, 2], scores [B, N]) where N =
    ``max_detections``, selected by top score across all strides, best
    first, equal scores lower index first. NMS runs afterwards
    (``ops.nms.nms_torch``).

    ``scores_are_logits``: the native detector head emits raw logits; real
    SCRFD ONNX graphs end in a Sigmoid, so their scores pass through
    unchanged (the reference consumes them directly, ``onnxrt_backend.py:
    882-1154``).
    """
    all_boxes, all_kps, all_scores = [], [], []
    for stride, out in outputs.items():
        device = out["bbox"].device
        centers = anchor_centers(input_size, stride, num_anchors, device)  # [M, 2]
        scale = float(stride) if stride_scale_distances else 1.0
        boxes = distance2bbox(centers[None], out["bbox"].float() * scale)
        kps = distance2kps(centers[None], out["kps"].float() * scale)
        scores = out["scores"].float()
        if scores_are_logits:
            scores = torch.sigmoid(scores)
        all_boxes.append(boxes)
        all_kps.append(kps)
        all_scores.append(scores)
    boxes = torch.cat(all_boxes, dim=1)
    kps = torch.cat(all_kps, dim=1)
    scores = torch.cat(all_scores, dim=1)
    k = min(max_detections, scores.shape[1])
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    kps = torch.gather(kps, 1, idx[..., None, None].expand(-1, -1, kps.shape[2], 2))
    return boxes, kps, top_scores
