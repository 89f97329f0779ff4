"""Host-side image decode for the VLM request path.

The port's copy of the part of ``lumen_tpu/utils/host_decode.py`` the VLM
manager calls: ``decode_image_bytes`` (cv2, PIL for formats cv2 cannot
read), its header probe, and ``vlm_canvas`` (the JAX ``_spec_vlm_canvas``
recipe: scaled decode + pad-to-square letterbox onto the vision tower's
canvas) as plain functions, run in the request's own thread. The
process-parallel decode pool and its named-spec registry are not ported
yet.
"""

from __future__ import annotations

import numpy as np

#: result-cache namespace qualifier for the scaled-decode generation: decode
#: resolution changes results, so disk-tier entries computed under one decode
#: policy must not answer for another. The JAX package's value; bump both
#: when the policy changes.
DECODE_POLICY = "sd1"


def probe_image_size(payload: bytes) -> tuple[int, int] | None:
    """Header-only (h, w) probe — no pixel decode. PIL reads just the
    container header lazily; anything unprobeable returns None (the caller
    falls back to a full decode)."""
    try:
        from io import BytesIO

        from PIL import Image

        with Image.open(BytesIO(payload)) as im:
            w, h = im.size
        return (int(h), int(w))
    except Exception:  # noqa: BLE001 - probe is best-effort by contract
        return None


def _factor_from_hw(hw: tuple[int, int] | None, max_edge: int) -> int:
    """Largest scaled-decode factor in {2, 4, 8} that keeps BOTH decoded
    dims >= ``max_edge`` (downstream resizes — square squash or letterbox
    — must only ever downscale). 1 = decode full; engages only when the
    target edge is <= half the source edge."""
    if hw is None or max_edge <= 0:
        return 1
    short = min(hw)
    factor = 1
    while factor < 8 and short // (factor * 2) >= max_edge:
        factor *= 2
    return factor


def _reduced_decode_factor(payload: bytes, max_edge: int) -> int:
    """Header probe + :func:`_factor_from_hw`; an unprobeable payload
    decodes full."""
    if max_edge <= 0:
        return 1
    return _factor_from_hw(probe_image_size(payload), max_edge)


def decode_image_bytes(
    payload: bytes, color: str = "rgb", max_edge: int | None = None, _factor: int | None = None
) -> np.ndarray:
    """Host-side decode to [H, W, 3] uint8 (cv2; PIL fallback for exotic
    formats). Undecodable bytes raise ``ValueError``.

    ``max_edge`` opts into SCALED decode: when the image is at least 2x
    oversized for the target edge, the JPEG is decoded directly at 1/2,
    1/4 or 1/8 scale (cv2 ``IMREAD_REDUCED_COLOR_*`` / PIL ``draft``) —
    the IDCT runs on a fraction of the blocks. Both decoded dims stay >=
    ``max_edge``, so downstream resize/letterbox to the target only ever
    downscales."""
    import cv2

    if _factor is not None:
        factor = _factor
    else:
        factor = _reduced_decode_factor(payload, max_edge) if max_edge else 1
    flag = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
            4: cv2.IMREAD_REDUCED_COLOR_4, 8: cv2.IMREAD_REDUCED_COLOR_8}[factor]
    buf = np.frombuffer(payload, dtype=np.uint8)
    try:
        img = cv2.imdecode(buf, flag)
        if img is None:
            from io import BytesIO

            from PIL import Image

            pil = Image.open(BytesIO(payload))
            if factor > 1:
                # draft() is JPEG-only and advisory; for other formats it
                # is a no-op and the full-size image decodes (correct,
                # just not reduced).
                pil.draft("RGB", (pil.size[0] // factor, pil.size[1] // factor))
            pil = pil.convert("RGB")
            img = np.asarray(pil)
            if color == "bgr":
                img = img[:, :, ::-1]
            return np.ascontiguousarray(img)
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 - normalize any decode failure
        raise ValueError(f"cannot decode image payload: {e}") from e
    if color == "rgb":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def vlm_canvas(payload: bytes, size: int) -> np.ndarray:
    """VLM's serving decode: scaled decode + pad-to-square letterbox onto
    the ``[size, size, 3]`` uint8 vision-tower canvas (image top-left,
    zero padding right and below)."""
    import cv2

    img = decode_image_bytes(payload, color="rgb", max_edge=size)
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[:nh, :nw] = resized
    return canvas
