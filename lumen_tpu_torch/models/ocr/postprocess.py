"""Host-side OCR postprocessing (control-flow-heavy CV stays on CPU; the
port's copy of ``lumen_tpu/models/ocr/postprocess.py``).

Semantics mirror the reference's DBNet postprocess and crop pipeline
(``packages/lumen-ocr/src/lumen_ocr/backends/onnxrt_backend.py:380-533``):
probability map -> contours -> minAreaRect quads -> region score gate ->
polygon unclip -> rescale to original coordinates; reading-order box sort;
perspective-warp crops with rot90 for vertical text.

One deliberate substitution: the reference offsets arbitrary contour
polygons with pyclipper/shapely (``_unclip:470-476``). This image has
neither, and the offset is only ever applied to a ``minAreaRect``
*rectangle*, for which the Minkowski offset is exact: grow both rect sides
by ``2 * d`` where ``d = area * unclip_ratio / perimeter``.
"""

from __future__ import annotations

import numpy as np


def boxes_from_prob_map(
    prob: np.ndarray,
    det_threshold: float = 0.3,
    box_threshold: float = 0.6,
    unclip_ratio: float = 1.5,
    max_candidates: int = 1000,
    min_size: float = 3.0,
    dest_hw: tuple[int, int] | None = None,
    scale: float = 1.0,
    pad_top: int = 0,
    pad_left: int = 0,
) -> list[tuple[np.ndarray, float]]:
    """Probability map [H, W] -> list of (quad [4, 2] float32, score).

    ``scale``/``pad_*`` undo the manager's letterbox so boxes land in
    original-image coordinates clipped to ``dest_hw`` (h, w).
    """
    import cv2

    binary = (prob > det_threshold).astype(np.uint8)
    contours, _ = cv2.findContours(binary, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
    results: list[tuple[np.ndarray, float]] = []
    for contour in contours[:max_candidates]:
        rect = cv2.minAreaRect(contour)
        if min(rect[1]) < min_size:
            continue
        score = box_score_fast(prob, cv2.boxPoints(rect))
        if score < box_threshold:
            continue
        rect = unclip_rect(rect, unclip_ratio)
        if min(rect[1]) < min_size + 2:
            continue
        box = order_quad(cv2.boxPoints(rect))
        # Undo letterbox: subtract padding, divide by scale.
        box[:, 0] = (box[:, 0] - pad_left) / scale
        box[:, 1] = (box[:, 1] - pad_top) / scale
        if dest_hw is not None:
            h, w = dest_hw
            box[:, 0] = np.clip(box[:, 0], 0, w - 1)
            box[:, 1] = np.clip(box[:, 1], 0, h - 1)
        results.append((box.astype(np.float32), float(score)))
    return results


def box_score_fast(prob: np.ndarray, quad: np.ndarray) -> float:
    """Mean probability inside the quad (reference ``_box_score_fast``)."""
    import cv2

    h, w = prob.shape
    xs = np.clip(np.floor(quad[:, 0]).astype(int), 0, w - 1)
    ys = np.clip(np.floor(quad[:, 1]).astype(int), 0, h - 1)
    xmin, xmax = xs.min(), min(int(np.ceil(quad[:, 0].max())), w - 1)
    ymin, ymax = ys.min(), min(int(np.ceil(quad[:, 1].max())), h - 1)
    mask = np.zeros((ymax - ymin + 1, xmax - xmin + 1), np.uint8)
    shifted = quad.copy()
    shifted[:, 0] -= xmin
    shifted[:, 1] -= ymin
    cv2.fillPoly(mask, [np.round(shifted).astype(np.int32)], 1)
    region = prob[ymin : ymax + 1, xmin : xmax + 1]
    if mask.sum() == 0:
        return 0.0
    return float(cv2.mean(region, mask)[0])


def unclip_rect(rect, unclip_ratio: float):
    """Offset a cv2 RotatedRect outward by ``d = area * ratio / perimeter``
    (exact Minkowski offset for rectangles; see module docstring)."""
    (cx, cy), (rw, rh), angle = rect
    area = rw * rh
    perimeter = 2.0 * (rw + rh)
    if perimeter <= 0:
        return rect
    d = area * unclip_ratio / perimeter
    return ((cx, cy), (rw + 2.0 * d, rh + 2.0 * d), angle)


def order_quad(pts: np.ndarray) -> np.ndarray:
    """Order 4 points clockwise from top-left (reference ``_get_mini_boxes``
    index juggling, ``onnxrt_backend.py:434-453``)."""
    pts = pts[np.argsort(pts[:, 0])]
    left, right = pts[:2], pts[2:]
    left = left[np.argsort(left[:, 1])]  # tl, bl
    right = right[np.argsort(right[:, 1])]  # tr, br
    return np.array([left[0], right[0], right[1], left[1]], dtype=np.float32)


def sorted_boxes(boxes: list[np.ndarray], line_tolerance: float = 10.0) -> list[int]:
    """Reading order: top-down, then left-right within a ~line_tolerance px
    band (reference ``_sorted_boxes:478-494``). Returns index permutation."""
    order = sorted(range(len(boxes)), key=lambda i: (boxes[i][0][1], boxes[i][0][0]))
    for j in range(len(order) - 1):
        for k in range(j, -1, -1):
            a, b = boxes[order[k]], boxes[order[k + 1]]
            if abs(b[0][1] - a[0][1]) < line_tolerance and b[0][0] < a[0][0]:
                order[k], order[k + 1] = order[k + 1], order[k]
            else:
                break
    return order


def rotate_crop(img: np.ndarray, quad: np.ndarray) -> np.ndarray:
    """Perspective-warp the quad to an upright crop; rotate 90° when the
    crop is tall (vertical text), matching ``_get_rotate_crop_image``."""
    import cv2

    w = int(max(np.linalg.norm(quad[0] - quad[1]), np.linalg.norm(quad[2] - quad[3])))
    h = int(max(np.linalg.norm(quad[0] - quad[3]), np.linalg.norm(quad[1] - quad[2])))
    w, h = max(w, 1), max(h, 1)
    dst = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    matrix = cv2.getPerspectiveTransform(quad.astype(np.float32), dst)
    crop = cv2.warpPerspective(
        img, matrix, (w, h), borderMode=cv2.BORDER_REPLICATE, flags=cv2.INTER_CUBIC
    )
    if h * 1.0 / w >= 1.5:
        crop = np.rot90(crop)
    return crop
