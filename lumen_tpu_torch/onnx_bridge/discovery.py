"""Shared export-file discovery: locate ``<prefix>*.onnx`` components in a
model dir with the reference's precision-preference chain
(``{component}.{precision}.onnx`` -> fp32 -> fp16,
``packages/lumen-clip/src/lumen_clip/backends/onnxrt_backend.py:245-289``).
One implementation for every family's graph loader (clip/ocr/face/vlm
previously each carried a near-verbatim copy)."""

from __future__ import annotations

import os

PRECISION_ORDER = ["fp32", "fp16"]


def find_onnx_exports(
    model_dir: str,
    kinds: dict[str, str],
    precision: str | None = None,
) -> dict[str, str]:
    """``kinds``: {result_key: filename_prefix}. Scans the dir and its
    ``onnx/`` runtime subdir (reference layout, ``resources/loader.py:164``);
    within a component, prefers the requested precision, then fp32, then
    fp16, then bare ``<prefix>.onnx``."""
    names = sorted(os.listdir(model_dir)) if os.path.isdir(model_dir) else []
    sub = os.path.join(model_dir, "onnx")
    if os.path.isdir(sub):
        names += [os.path.join("onnx", n) for n in sorted(os.listdir(sub))]

    order = [precision] if precision else []
    order += [p for p in PRECISION_ORDER if p not in order]
    found: dict[str, str] = {}
    for kind, prefix in kinds.items():
        candidates = [
            n for n in names
            if n.endswith(".onnx") and os.path.basename(n).startswith(prefix)
        ]
        if not candidates:
            continue

        def rank(name: str) -> tuple:
            base = os.path.basename(name)
            for i, prec in enumerate(order):
                if f".{prec}." in base:
                    return (i, base)
            return (len(order), base)

        found[kind] = os.path.join(model_dir, sorted(candidates, key=rank)[0])
    return found
