"""Known InsightFace model-pack specs.

Role of the reference's hardcoded pack table
(``packages/lumen-face/src/lumen_face/backends/insightface_specs.py:11-159``):
a model dir named after a stock InsightFace pack works without any
``extra_metadata`` — the spec defaults are filled from this table, then
overridden by whatever the manifest declares.

Values are the public InsightFace pack conventions: SCRFD detector at
640x640 with mean/std 127.5/128 and score/NMS thresholds 0.4, ArcFace-style
recognizer at 112x112 BGR with mean/std 127.5/127.5.
"""

from __future__ import annotations

_SCRFD_ARC = {
    "det_size": 640,
    "det_mean": 127.5,
    "det_std": 128.0,
    "score_threshold": 0.4,
    "nms_threshold": 0.4,
    "min_face": 32,
    "max_face": 1000,
    "rec_size": 112,
    "rec_mean": 127.5,
    "rec_std": 127.5,
    "rec_color": "bgr",
}

#: pack name -> spec overrides (merged under model_info extras)
PACK_SPECS: dict[str, dict] = {
    "antelopev2": dict(_SCRFD_ARC),
    "buffalo_l": dict(_SCRFD_ARC),
    "buffalo_m": dict(_SCRFD_ARC),
    "buffalo_s": dict(_SCRFD_ARC),
    "buffalo_sc": dict(_SCRFD_ARC),
}


def pack_overrides(model_id: str) -> dict:
    """Spec overrides for a known pack (EXACT match on the lowered model id,
    like the reference's ``PACK_SPECS.get(pack_key)`` — substring matching
    would silently flip preprocessing for unrelated models whose name merely
    contains a pack name); empty dict for unknown models."""
    return dict(PACK_SPECS.get(model_id.lower(), {}))
