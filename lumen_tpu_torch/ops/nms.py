"""Non-maximum suppression (the port of ``lumen_tpu/ops/nms.py``).

Two implementations with one semantics:

- :func:`nms_torch` — the twin of ``nms_jax``: fixed box count, a keep
  mask, on the device, for a whole batch at once, so detection
  post-processing stays inside the batched device call;
- :func:`nms_numpy` — host variant for per-request threshold overrides,
  same greedy IoU-suppression semantics as the reference's pure-numpy NMS
  (``lumen_face/backends/onnxrt_backend.py:391-423``), handed to the
  native C library (``lumen_tpu_torch/native``) when that is built.

Boxes are ``[..., N, 4]`` as ``(x1, y1, x2, y2)``.
"""

from __future__ import annotations

import numpy as np
import torch


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """[B, N, 4] -> [B, N, N] pairwise IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, :, None] + area[:, None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_torch(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.4) -> torch.Tensor:
    """Greedy NMS as a keep-mask over N static boxes, for a batch.

    ``boxes`` [B, N, 4], ``scores`` [B, N] -> keep [B, N] bool. Scan the
    boxes in score order: a box is kept iff no higher-scoring kept box
    overlaps it above the threshold. Invalid boxes should carry score
    -inf (they are never kept). The score order is a stable sort, so
    equal scores keep the lower index first, as ``jnp.argsort`` does.

    One scan step per candidate covers the whole batch ([B, N] masks):
    four launches a step, ``4 N`` a batch, however many images it holds.
    """
    b, n = scores.shape
    order = torch.sort(-scores, dim=1, stable=True).indices
    boxes_sorted = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
    # earlier[:, i, j]: sorted box j (j < i) overlaps box i too much.
    earlier = (iou_matrix(boxes_sorted) > iou_threshold) & torch.ones(
        n, n, dtype=torch.bool, device=scores.device).tril(-1)
    keep = torch.isfinite(torch.gather(scores, 1, order))
    for i in range(n):
        # Suppressed if any earlier kept box overlaps too much.
        keep[:, i].logical_and_(~(earlier[:, i] & keep).any(-1))
    # Map keep decisions back to original box order.
    return torch.zeros_like(keep).scatter(1, order, keep)


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.4) -> np.ndarray:
    """Host greedy NMS; returns kept indices sorted by descending score.

    Delegates to the native C core when available (GIL-free, no O(N) python
    loop); the numpy path below is the reference implementation and fallback.
    """
    if len(boxes) == 0:
        return np.empty((0,), np.int64)
    from .. import native

    if native.available():
        return native.nms_f32(boxes, scores, iou_threshold)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    # Stable sort so score ties break deterministically (higher index first
    # after the reverse) and agree with the native C path's tie-break.
    order = scores.argsort(kind="stable")[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-9)
        order = order[1:][iou <= iou_threshold]
    return np.asarray(keep, np.int64)
