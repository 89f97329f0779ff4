"""Seeded stand-ins for the ``PP-OCRv5_mobile`` pack's three graphs, written
to the pack's published contract, for exporting test packs; synthetic
pages of text lines to drive them; and the native checkpoint writer.

The real files are not in the repository. The stand-ins keep the
contracts a PP-OCR ONNX pack has on the wire and the widths of the
PaddleOCR ``PP-OCRv5_mobile`` configs as far as they are known here
(``PERF.md`` §4 lists each number with its source and marks the ones
that are not certain):

- :class:`PPOCRDet` — ``PP-OCRv5_mobile_det``: ``[B, 3, H, W]`` (H, W
  multiples of 32) -> ``[B, 1, H, W]`` sigmoid map. A depthwise-separable
  backbone with HardSwish and squeeze-excite (HardSigmoid) in its last
  stage, in the channel plan of PPLCNetV3 at scale 0.75 (strides 4/8/16/32
  projected to 12/18/42/360 channels); an RSE-FPN neck of 96 channels
  with nearest ``Resize``; a DB head (3x3 conv to 24, two 2x2 stride-2
  ``ConvTranspose``, sigmoid).
- :class:`PPOCRRec` — ``PP-OCRv5_mobile_rec``: ``[B, 3, 48, W]`` -> ``[B,
  W/8, V]`` ending in ``Softmax``. A conv backbone in PPLCNetV3's rec
  channel plan at scale 0.95 (16/32/64/128/240/480; strides (2, 1) and
  (1, 2) take 48 x W to 3 x W/4, an average pool [3, 2] to 1 x W/8); an
  SVTR neck (dims 120, 2 blocks of 8 heads, MLP ratio 2, Swish) whose
  attention exports as ``MatMul``/``Softmax``; a CTC head over the
  PP-OCRv5 dictionary plus blank and space.
- :class:`PPOCRCls` — the textline orientation classifier: ``[B, 3, 48,
  192]`` -> ``[B, 2]`` softmax over (0, 180 degrees), a MobileNetV3-small
  x0.35-like conv stack, global average pool and a linear head.

Seeded heads answer nothing useful (a seeded detector scores every pixel
near 0.5 and yields one page-sized contour), so :func:`write_ppocr_pack`
calibrates each head on synthetic pages (:func:`synthetic_page`: dark
text lines drawn with ``cv2.putText`` on a light ground): the detector's
last transposed conv is fit by ridge regression to the text lines' boxes,
the recognizer's CTC head is scaled until its steps are confident, and
the classifier's head is fit to tell upright lines from rotated ones.
Before that, every BatchNorm takes its input's statistics on those pages
(:func:`fit_bn_stats`), as a trained net's are its data's.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .face_standins import randomize_bn_stats

#: the PP-OCRv5 dictionary's size (``ppocrv5_dict.txt``; not certain here)
PPOCRV5_DICT_SIZE = 18383
#: widths of the stand-ins at the pack's published sizes (PERF.md §4)
DET_CHANNELS = (12, 24, 48, 96, 192, 384)  # stem, blocks2-6 of PPLCNetV3 x0.75
DET_OUT = (12, 18, 42, 360)  # the det backbone's 1x1 projections, mv_c (16, 24, 56, 480) x 0.75
DET_NECK = 96  # RSEFPN out_channels
REC_CHANNELS = (16, 32, 64, 128, 240, 480)  # PPLCNetV3 rec x0.95, make_divisible(., 16)
REC_DIMS, REC_DEPTH, REC_HEADS = 120, 2, 8  # SVTR neck
CLS_CHANNELS = (8, 16, 24, 48)  # a MobileNetV3-small x0.35-like stack


def _act(kind: str | None) -> nn.Module:
    return {"hswish": nn.Hardswish(), "relu": nn.ReLU(), "swish": nn.SiLU(), None: nn.Identity()}[kind]


class ConvBN(nn.Sequential):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, act: str | None = "hswish"):
        pad = (k[0] // 2, k[1] // 2) if isinstance(k, tuple) else k // 2
        super().__init__(nn.Conv2d(cin, cout, k, stride, pad, groups=groups, bias=False), nn.BatchNorm2d(cout),
                         _act(act))


class SE(nn.Module):
    """Squeeze-excite with HardSigmoid (PPLCNet's)."""

    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Conv2d(c, max(c // reduction, 1), 1)
        self.fc2 = nn.Conv2d(max(c // reduction, 1), c, 1)

    def forward(self, x):
        s = F.adaptive_avg_pool2d(x, 1)
        return x * F.hardsigmoid(self.fc2(F.relu(self.fc1(s))))


class DSBlock(nn.Module):
    """Depthwise kxk (stride) + optional SE + pointwise 1x1, HardSwish."""

    def __init__(self, cin, cout, k=3, stride=1, se=False):
        super().__init__()
        self.dw = ConvBN(cin, cin, k, stride, groups=cin)
        self.se = SE(cin) if se else nn.Identity()
        self.pw = ConvBN(cin, cout, 1)

    def forward(self, x):
        return self.pw(self.se(self.dw(x)))


class RSELayer(nn.Module):
    """RSE-FPN's conv + squeeze-excite with a shortcut."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)
        self.se = SE(cout)

    def forward(self, x):
        x = self.conv(x)
        return x + self.se(x)


class PPOCRDet(nn.Module):
    """The detector stand-in (module docstring)."""

    def __init__(self, channels=DET_CHANNELS, out=DET_OUT, neck=DET_NECK):
        super().__init__()
        c0, c1, c2, c3, c4, c5 = channels
        self.stem = ConvBN(3, c0, 3, 2)
        self.blocks2 = DSBlock(c0, c1)
        self.blocks3 = nn.Sequential(DSBlock(c1, c2, 3, 2), DSBlock(c2, c2))
        self.blocks4 = nn.Sequential(DSBlock(c2, c3, 3, 2), DSBlock(c3, c3))
        self.blocks5 = nn.Sequential(DSBlock(c3, c4, 3, 2), *[DSBlock(c4, c4, 5) for _ in range(4)])
        self.blocks6 = nn.Sequential(DSBlock(c4, c5, 5, 2, se=True), DSBlock(c5, c5, 5, se=True),
                                     DSBlock(c5, c5, 5), DSBlock(c5, c5, 5))
        self.proj = nn.ModuleList(ConvBN(c, o, 1) for c, o in zip((c2, c3, c4, c5), out))
        self.ins_conv = nn.ModuleList(RSELayer(o, neck, 1) for o in out)
        self.inp_conv = nn.ModuleList(RSELayer(neck, neck // 4, 3) for _ in out)
        q = neck // 4
        self.head_conv = ConvBN(neck, q, 3, act="relu")
        self.head_up1 = nn.ConvTranspose2d(q, q, 2, 2)
        self.head_bn = nn.BatchNorm2d(q)
        self.head_up2 = nn.ConvTranspose2d(q, 1, 2, 2)

    def features(self, x):
        """The DB head's input to its last transposed conv: [B, neck/4, H/2, W/2]."""
        x = self.blocks2(self.stem(x))
        feats = []
        for stage in (self.blocks3, self.blocks4, self.blocks5, self.blocks6):
            x = stage(x)
            feats.append(x)
        ins = [conv(proj(f)) for conv, proj, f in zip(self.ins_conv, self.proj, feats)]
        for i in range(len(ins) - 2, -1, -1):  # top-down, nearest x2
            ins[i] = ins[i] + F.interpolate(ins[i + 1], scale_factor=2.0, mode="nearest")
        ps = [conv(p) for conv, p in zip(self.inp_conv, ins)]
        ps = [F.interpolate(p, scale_factor=float(2 ** i), mode="nearest") if i else p for i, p in enumerate(ps)]
        h = self.head_conv(torch.cat(ps[::-1], dim=1))
        return F.relu(self.head_bn(self.head_up1(h)))

    def forward(self, x):
        return torch.sigmoid(self.head_up2(self.features(x)))


class _SVTRBlock(nn.Module):
    """SVTR global mixing: pre-LN attention (MatMul/Softmax on export) and a
    Swish MLP of ratio 2."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, 2 * dim)
        self.fc2 = nn.Linear(2 * dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * (c // self.heads) ** -0.5, dim=-1)
        x = x + self.proj(torch.matmul(att, v).transpose(1, 2).reshape(b, n, c))
        return x + self.fc2(F.silu(self.fc1(self.norm2(x))))


class PPOCRRec(nn.Module):
    """The recognizer stand-in (module docstring)."""

    def __init__(self, vocab: int, channels=REC_CHANNELS, dims=REC_DIMS, depth=REC_DEPTH, heads=REC_HEADS):
        super().__init__()
        c0, c1, c2, c3, c4, c5 = channels
        self.stem = ConvBN(3, c0, 3, 2)  # 24 x W/2
        self.blocks = nn.Sequential(
            DSBlock(c0, c1), DSBlock(c1, c2), DSBlock(c2, c2),
            DSBlock(c2, c3, 3, (2, 1)), DSBlock(c3, c3),  # 12 x W/2
            DSBlock(c3, c4, 3, (1, 2)), *[DSBlock(c4, c4, 5) for _ in range(4)],  # 12 x W/4
            DSBlock(c4, c5, 5, (2, 1), se=True), DSBlock(c5, c5, 5, se=True),  # 6 x W/4
            DSBlock(c5, c5, 5, (2, 1)), DSBlock(c5, c5, 5),  # 3 x W/4
        )
        self.conv1 = ConvBN(c5, c5 // 8, (1, 3), act="swish")
        self.conv2 = ConvBN(c5 // 8, dims, 1, act="swish")
        self.svtr = nn.Sequential(*[_SVTRBlock(dims, heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(dims, eps=1e-6)
        self.conv3 = ConvBN(dims, c5, 1, act="swish")
        self.conv4 = ConvBN(2 * c5, c5 // 8, (1, 3), act="swish")
        self.conv1x1 = ConvBN(c5 // 8, dims, 1, act="swish")
        self.ctc = nn.Linear(dims, vocab)

    def features(self, x):
        """The CTC head's input: [B, W/8, dims]."""
        x = F.avg_pool2d(self.blocks(self.stem(x)), (3, 2))  # [B, C, 1, W/8]
        z = self.conv2(self.conv1(x))
        b, c, h, w = z.shape
        z = self.norm(self.svtr(z.flatten(2).transpose(1, 2)))
        z = self.conv3(z.transpose(1, 2).reshape(b, c, h, w))
        z = self.conv1x1(self.conv4(torch.cat([x, z], dim=1)))
        return z.squeeze(2).transpose(1, 2)

    def forward(self, x):
        return torch.softmax(self.ctc(self.features(x)), dim=-1)


class PPOCRCls(nn.Module):
    """The orientation classifier stand-in (module docstring)."""

    def __init__(self, channels=CLS_CHANNELS):
        super().__init__()
        layers, cin = [ConvBN(3, channels[0], 3, 2)], channels[0]
        for c in channels[1:]:
            layers.append(DSBlock(cin, c, 3, 2, se=True))
            cin = c
        self.body = nn.Sequential(*layers)
        self.fc = nn.Linear(cin, 2)

    def features(self, x):
        return self.body(x).mean(dim=(2, 3))

    def forward(self, x):
        return torch.softmax(self.fc(self.features(x)), dim=-1)


# -- synthetic pages ------------------------------------------------------------

_WORDS = ("lumen", "photo", "library", "receipt", "total", "invoice", "date", "2024", "page", "street", "amount",
          "paid", "thank", "you", "order", "item", "price", "qty", "tax", "card", "cash", "change", "store", "open",
          "hours", "monday", "friday", "coffee", "bread", "milk", "eggs", "notes", "meeting", "room", "floor")


def render_line(text: str, scale: float, thickness: int, ink: int) -> np.ndarray:
    """One dark text line on white, cut to its ink with a margin: [h, w] uint8."""
    import cv2

    (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
    pad = max(4, int(th * 0.4))
    img = np.full((th + base + 2 * pad, tw + 2 * pad), 255, np.uint8)
    cv2.putText(img, text, (pad, pad + th), cv2.FONT_HERSHEY_SIMPLEX, scale, ink, thickness, cv2.LINE_AA)
    return img


def synthetic_page(seed: int, width: int = 1280, height: int = 960, lines: int = 10,
                   rotated_share: float = 0.0) -> tuple[np.ndarray, list[dict]]:
    """A light page (``height`` x ``width`` RGB uint8) with ``lines`` dark
    text lines of seeded words at seeded sizes, a ``rotated_share`` of them
    turned 180 degrees; returns the pixels and each line's box (x0, y0,
    x1, y1), text and orientation."""
    rng = np.random.default_rng(seed)
    ground = rng.uniform(215, 250)
    page = np.clip(ground + rng.normal(0, 4, (height, width)), 0, 255)
    out, y = [], int(rng.integers(10, 40))
    scale_hi = max(0.6, min(2.2, height / (lines * 30.0)))
    for _ in range(lines):
        text = " ".join(rng.choice(_WORDS, int(rng.integers(2, 5))))
        scale = float(rng.uniform(0.6, scale_hi))
        line = render_line(text, scale, max(1, int(round(scale * 2))), int(rng.integers(0, 70))).astype(np.float32)
        h, w = line.shape
        if y + h > height or w > width - 8:
            break
        x = int(rng.integers(4, width - w - 3))
        rotated = bool(rng.random() < rotated_share)
        if rotated:
            line = line[::-1, ::-1]
        ink = line < 200
        page[y:y + h, x:x + w][ink] = line[ink]
        out.append({"box": (x, y, x + w, y + h), "text": text, "rotated": rotated})
        y += h + int(rng.integers(6, 40))
    tint = rng.uniform(0.92, 1.0, 3)
    rgb = np.clip(page[..., None] * tint, 0, 255).astype(np.uint8)
    return rgb, out


def line_crops(seed: int, n: int, height: int = 48) -> list[np.ndarray]:
    """``n`` upright text-line crops (RGB uint8) of seeded words."""
    rng = np.random.default_rng(seed)
    crops = []
    for _ in range(n):
        text = " ".join(rng.choice(_WORDS, int(rng.integers(1, 4))))
        g = render_line(text, float(rng.uniform(0.8, 1.6)), 2, int(rng.integers(0, 70)))
        crops.append(np.repeat(g[..., None], 3, axis=2))
    return crops


# -- calibration ------------------------------------------------------------------


def _nchw(pixels: np.ndarray, mean, std) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(pixels)).float() / 255.0
    return ((x - torch.tensor(mean)) / torch.tensor(std)).permute(0, 3, 1, 2)


def fit_bn_stats(model: nn.Module, x: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics (``nn.BatchNorm2d`` or the
    port's inference ``BatchNorm``) to its own input's per-channel mean and
    variance on ``x``, layer by layer in one forward: a trained net's
    statistics are its data's, while seeded ones shrink the signal layer by
    layer until the features no longer see the input."""

    def take(m, args):
        t = args[0].double()
        dims = [0, *range(2, t.dim())]
        m.running_mean.copy_(t.mean(dims))
        m.running_var.copy_(t.var(dims, unbiased=False))

    hooks = [m.register_forward_pre_hook(take) for m in model.modules()
             if isinstance(getattr(m, "running_var", None), torch.Tensor)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()


def db_head(det: nn.Module) -> tuple:
    """(head conv, its BatchNorm, first transposed conv, its BatchNorm,
    last transposed conv) of the stand-in's or the port's native DB head."""
    if isinstance(det, PPOCRDet):
        return det.head_conv[0], det.head_conv[1], det.head_up1, det.head_bn, det.head_up2
    return det.head_conv.conv, det.head_conv.bn, det.head_up1, det.head_bn1, det.head_up2


def calibrate_det(det: nn.Module, pages: list[np.ndarray], masks: list[np.ndarray], logit: float = 8.0,
                  ridge: float = 1e-4, lift: float = 16.0) -> None:
    """Calibrate a DB head (``PPOCRDet``'s or the native ``DBNet``'s: a 3x3
    conv + BN + ReLU, a 2x2 transposed conv + BN + ReLU, a 2x2 transposed
    conv, sigmoid) so its map is high on the strokes of text: a ridge
    regression over the head conv's 3x3 window of fused neck features
    (stride 4) fits logits of +``logit`` where a 4 x 4 cell of ``masks``
    (0/1 stroke maps of the letterboxed ``pages``) holds ink and -``logit``
    elsewhere; channel 0 of the head conv computes the fit (lifted by
    ``lift`` past its ReLU), and the two transposed convs carry channel 0
    up to full resolution and take the lift off."""
    from ..models.ocr.manager import DET_MEAN, DET_STD

    conv, bn, up1, bn2, up2 = db_head(det)
    seen: dict = {}
    hook = conv.register_forward_hook(lambda m, i, o: seen.update(x=i[0]))
    gram, rhs = 0.0, 0.0
    try:
        with torch.no_grad():
            for page, mask in zip(pages, masks):
                det(_nchw(page[None], DET_MEAN, DET_STD))
                u = F.unfold(seen["x"], 3, padding=1)[0]  # [9 C, cells]
                cell = F.max_pool2d(torch.from_numpy(mask)[None, None].double(), 4).flatten() * 2 * logit - logit
                for lo in range(0, u.shape[1], 16384):  # bounded memory at 960 x 960
                    xb = u[:, lo:lo + 16384].t().double()
                    xb = torch.cat([xb, torch.ones(len(xb), 1, dtype=xb.dtype)], 1)
                    gram = gram + xb.t() @ xb
                    rhs = rhs + xb.t() @ cell[lo:lo + 16384]
    finally:
        hook.remove()
    gram = gram + ridge * gram.diagonal().mean() * torch.eye(gram.shape[0], dtype=gram.dtype)
    sol = torch.linalg.solve(gram, rhs)
    with torch.no_grad():
        conv.weight[0] = sol[:-1].reshape(conv.weight.shape[1:]).float()
        for b in (bn, bn2):  # channel 0: identity, then + bias
            b.running_mean[0], b.running_var[0], b.weight[0], b.bias[0] = 0.0, 1.0 - b.eps, 1.0, 0.0
        bn.bias[0] = float(sol[-1]) + lift
        up1.weight[:, 0] = 0.0
        up1.weight[0, 0] = 1.0
        if up1.bias is not None:
            up1.bias[0] = 0.0
        up2.weight.zero_()
        up2.weight[0, 0] = 1.0
        up2.bias.fill_(-lift)


def calibrate_ctc(rec: nn.Module, head: nn.Linear, crops: list[np.ndarray], confidence: float = 0.9) -> None:
    """Scale a recognizer's CTC ``head`` until the median step's top
    probability is ``confidence`` on ``crops`` (seeded heads spread each
    step over the whole dictionary: every answer would fall under the 0.5
    threshold)."""
    from ..models.ocr.manager import REC_MEAN, REC_STD

    seen: list = []
    hook = head.register_forward_hook(lambda m, i, o: seen.append(o[0].double()))
    try:
        with torch.no_grad():
            for c in crops:
                rec(_nchw(c[None], REC_MEAN, REC_STD))
    finally:
        hook.remove()
    z = torch.cat(seen)
    lo, hi = 0.0, 1.0
    while torch.softmax(z * hi, -1).amax(-1).median() < confidence:
        hi *= 2
    for _ in range(40):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if torch.softmax(z * mid, -1).amax(-1).median() < confidence else (lo, mid)
    with torch.no_grad():
        head.weight.mul_(hi)
        head.bias.mul_(hi)


def calibrate_cls(cls: nn.Module, head: nn.Linear, crops: list[np.ndarray], logit: float = 6.0,
                  ridge: float = 1e-4) -> None:
    """Fit an orientation classifier's 2-way ``head`` by ridge regression on
    its pooled input features so an upright crop (``crops``, letterboxed
    to the classifier's size) scores class 0 by a logit margin of 2
    ``logit`` and the same crop turned 180 degrees class 1."""
    from ..models.ocr.manager import REC_MEAN, REC_STD

    up = np.stack(crops)
    down = np.ascontiguousarray(up[:, ::-1, ::-1])
    seen: list = []
    hook = head.register_forward_hook(lambda m, i, o: seen.append(i[0].double()))
    try:
        with torch.no_grad():
            cls(_nchw(up, REC_MEAN, REC_STD))
            cls(_nchw(down, REC_MEAN, REC_STD))
    finally:
        hook.remove()
    f = torch.cat(seen)
    x = torch.cat([f, torch.ones(len(f), 1, dtype=f.dtype)], 1)
    y = torch.cat([torch.full((len(up),), logit), torch.full((len(up),), -logit)]).double()
    gram = x.t() @ x
    sol = torch.linalg.solve(gram + ridge * gram.diagonal().mean() * torch.eye(x.shape[1], dtype=x.dtype), x.t() @ y)
    with torch.no_grad():
        head.weight.copy_(torch.stack([sol[:-1], -sol[:-1]]).float() / 2)
        head.bias.copy_(torch.tensor([sol[-1], -sol[-1]]).float() / 2)


def calibration_pages(seed: int, n: int, page_hw=(960, 1280), bucket: int = 960) -> tuple[list, list]:
    """``n`` synthetic pages letterboxed to ``bucket`` (as the manager
    feeds its detector) and their stroke masks: dark pixels inside the
    lines' boxes."""
    from ..ops.image import letterbox_numpy

    pages, masks = [], []
    for i in range(n):
        page, lines = synthetic_page(seed + i, page_hw[1], page_hw[0], rotated_share=0.2)
        boxed, scale, top, left = letterbox_numpy(page, bucket)
        ink = np.zeros(boxed.shape[:2], np.float64)
        for ln in lines:
            x0, y0, x1, y1 = ln["box"]
            ys = slice(int(top + y0 * scale), int(math.ceil(top + y1 * scale)))
            xs = slice(int(left + x0 * scale), int(math.ceil(left + x1 * scale)))
            ink[ys, xs] = boxed[ys, xs].mean(-1) < 150
        pages.append(boxed)
        masks.append(ink)
    return pages, masks


def calibrate_all(det: nn.Module, rec: nn.Module, rec_head: nn.Linear, cls: nn.Module, cls_head: nn.Linear,
                  seed: int, page_hw, det_bucket: int, cls_hw=(48, 192), calib_pages: int = 2) -> None:
    """Every BatchNorm to its data's statistics, then the three heads
    (detector, CTC, orientation), on seeded synthetic pages and crops."""
    from ..models.ocr.manager import DET_MEAN, DET_STD, REC_MEAN, REC_STD

    pages, masks = calibration_pages(seed + 10, calib_pages, page_hw, det_bucket)
    fit_bn_stats(det, _nchw(np.stack(pages), DET_MEAN, DET_STD))
    calibrate_det(det, pages, masks)
    crops = line_crops(seed + 20, 256)
    rec_crops = [letterbox_cls(c, 48, 320) for c in crops[:24]]
    fit_bn_stats(rec, _nchw(np.stack(rec_crops), REC_MEAN, REC_STD))
    calibrate_ctc(rec, rec_head, rec_crops[:8])
    cls_crops = [letterbox_cls(c, *cls_hw) for c in crops]
    both = np.stack(cls_crops + [np.ascontiguousarray(c[::-1, ::-1]) for c in cls_crops])
    fit_bn_stats(cls, _nchw(both, REC_MEAN, REC_STD))
    calibrate_cls(cls, cls_head, cls_crops)


def letterbox_cls(crop: np.ndarray, h: int = 48, w: int = 192) -> np.ndarray:
    """A crop resized to height ``h`` (width capped at ``w``) on a zero ``h``
    x ``w`` canvas, as the OCR manager feeds its classifier."""
    import cv2

    out = np.zeros((h, w, 3), np.uint8)
    new_w = min(max(int(round(crop.shape[1] * h / max(crop.shape[0], 1))), 1), w)
    out[:, :new_w] = cv2.resize(crop, (new_w, h), interpolation=cv2.INTER_LINEAR)
    return out


def charset(n: int) -> list[str]:
    """``n`` distinct one-character dictionary lines: printable ASCII, then
    CJK ideographs (a stand-in of the PP-OCRv5 dictionary's size)."""
    chars = [chr(c) for c in range(33, 127)]
    chars += [chr(0x4E00 + i) for i in range(max(0, n - len(chars)))]
    return chars[:n]


def write_ppocr_pack(model_dir: Path, seed: int, *, dict_size: int = PPOCRV5_DICT_SIZE, det_channels=DET_CHANNELS,
                     det_out=DET_OUT, det_neck=DET_NECK, rec_channels=REC_CHANNELS, rec_dims=REC_DIMS,
                     rec_depth=REC_DEPTH, rec_heads=REC_HEADS, cls_channels=CLS_CHANNELS, page_hw=(960, 1280),
                     det_bucket: int = 960, calib_pages: int = 2) -> dict:
    """The stand-in ``PP-OCRv5_mobile`` pack in ``model_dir``: ``det.onnx``,
    ``rec.onnx``, ``cls.onnx`` (exported on the CPU from seeded weights and
    BN statistics, heads calibrated), ``ppocr_keys_v1.txt`` (``dict_size``
    lines) and ``model_info.json``. Returns the three modules (float32,
    CPU, eval) by name."""
    from .onnx_export import export_onnx

    torch.manual_seed(seed)
    det = PPOCRDet(det_channels, det_out, det_neck)
    rec = PPOCRRec(dict_size + 2, rec_channels, rec_dims, rec_depth, rec_heads)
    cls = PPOCRCls(cls_channels)
    for i, m in enumerate((det, rec, cls)):
        randomize_bn_stats(m, seed + 1 + i)
        m.eval()
    calibrate_all(det, rec, rec.ctc, cls, cls.fc, seed, page_hw, det_bucket, calib_pages=calib_pages)
    model_dir.mkdir(parents=True, exist_ok=True)
    export_onnx(det, (torch.zeros(1, 3, 64, 64),), str(model_dir / "det.onnx"), input_names=["x"],
                dynamic_axes={"x": {0: "b", 2: "h", 3: "w"}})
    export_onnx(rec, (torch.zeros(1, 3, 48, 320),), str(model_dir / "rec.onnx"), input_names=["x"],
                dynamic_axes={"x": {0: "b", 3: "w"}})
    export_onnx(cls, (torch.zeros(1, 3, 48, 192),), str(model_dir / "cls.onnx"), input_names=["x"],
                dynamic_axes={"x": {0: "b"}})
    (model_dir / "ppocr_keys_v1.txt").write_text("\n".join(charset(dict_size)) + "\n", encoding="utf-8")
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": model_dir.name, "version": "1.0.0", "description": "seeded stand-ins of the PP-OCRv5 mobile pack",
        "model_type": "ocr", "source": {"format": "custom", "repo_id": f"LumilioPhotos/{model_dir.name}"},
        "runtimes": {"onnx": {"available": True, "files": ["det.onnx", "rec.onnx", "cls.onnx"]}},
    }))
    return {"det": det, "rec": rec, "cls": cls}


def native_ocr_checkpoint(module: nn.Module) -> dict[str, torch.Tensor]:
    """The port's ``DBNet`` / ``SVTRRecognizer`` / ``TextlineClassifier``
    state as a native checkpoint (the JAX package's '/'-pathed Flax
    variables, ``params/`` and ``batch_stats/``): the inverse of
    ``ocr_params_from_jax``, for writing ``*.safetensors`` test packs."""
    out = {}
    for key, t in module.state_dict().items():
        *parents, name = key.split(".")
        owner = module.get_submodule(".".join(parents))
        if name == "weight" and isinstance(owner, nn.ConvTranspose2d):
            coll, leaf, t = "params", "kernel", t.flip(2, 3).permute(2, 3, 0, 1)
        elif name == "weight" and t.ndim >= 2:
            coll, leaf, t = "params", "kernel", (t.permute(2, 3, 1, 0) if t.ndim == 4 else t.t())
        else:
            coll, leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                          "pos_embed": ("params", "pos_embed"), "running_mean": ("batch_stats", "mean"),
                          "running_var": ("batch_stats", "var")}[name]
        out["/".join([coll, *parents, leaf])] = t.detach().contiguous().cpu()
    return out


def write_native_ocr_dir(model_dir: Path, seed: int, det_cfg, rec_cfg, cls_cfg, *, page_hw=(960, 1280),
                         det_bucket: int = 960) -> dict:
    """A native OCR directory: the port's ``DBNet`` / ``SVTRRecognizer`` /
    ``TextlineClassifier`` at the given configs with seeded weights and BN
    statistics, calibrated as the stand-in pack is (:func:`calibrate_all`),
    written as the JAX package's native safetensors, with a charset of
    ``rec_cfg.vocab_size - 2`` lines and the configs in ``model_info.json``
    (the default width buckets: ``rec_cfg.max_width`` is their widest, 640).
    Returns the three modules (float32, CPU, eval) by name."""
    from safetensors.torch import save_file

    from ..models.ocr import DBNet, SVTRRecognizer, TextlineClassifier

    torch.manual_seed(seed)
    det, rec, cls = DBNet(det_cfg), SVTRRecognizer(rec_cfg), TextlineClassifier(cls_cfg)
    for i, m in enumerate((det, rec, cls)):
        randomize_bn_stats(m, seed + 1 + i)
        m.eval()
    calibrate_all(det, rec, rec.ctc_head, cls, cls.head, seed, page_hw, det_bucket,
                  cls_hw=(cls_cfg.height, cls_cfg.width))
    model_dir.mkdir(parents=True, exist_ok=True)
    files = {"detection.safetensors": det, "recognition.safetensors": rec, "classification.safetensors": cls}
    for name, module in files.items():
        save_file(native_ocr_checkpoint(module), str(model_dir / name))
    (model_dir / "ppocr_keys_v1.txt").write_text("\n".join(charset(rec_cfg.vocab_size - 2)) + "\n", encoding="utf-8")
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": model_dir.name, "version": "1.0.0", "description": "seeded native OCR modules",
        "model_type": "ocr", "source": {"format": "custom", "repo_id": f"LumilioPhotos/{model_dir.name}"},
        "runtimes": {"jax": {"available": True, "files": sorted(files)}},
        "extra_metadata": {
            "ocr": {"rec_height": rec_cfg.height},
            "detector": {"width": det_cfg.width, "fpn_width": det_cfg.fpn_width, "head_width": det_cfg.head_width},
            "recognizer": {"vocab_size": rec_cfg.vocab_size, "height": rec_cfg.height, "max_width": rec_cfg.max_width,
                           "width": rec_cfg.width, "heads": rec_cfg.heads, "layers": rec_cfg.layers},
            "classifier": {"height": cls_cfg.height, "width": cls_cfg.width, "channels": list(cls_cfg.channels)},
        },
    }))
    return {"det": det, "rec": rec, "cls": cls}
