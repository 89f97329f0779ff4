"""Host-side image decode: the torch-free half of the host lane.

The port's copy of ``lumen_tpu/utils/host_decode.py``. Every function here
runs on host CPU with cv2/PIL only — **no torch (or jax) import anywhere
in this module's import graph**. That is load-bearing: the process-parallel
decode pool (:mod:`lumen_tpu_torch.runtime.decode_pool`) spawns worker
processes whose entire job is running these functions, and a worker that
imported torch would pay seconds of startup and CUDA state it never uses.
Workers import THIS module (and the package ``__init__`` files above it,
which stay torch-free) and nothing heavier.

Two layers live here:

1. **The decode primitives** (``decode_image_bytes``,
   ``decode_image_bytes_scaled``, ``letterbox_numpy``, ...), re-exported
   by :mod:`lumen_tpu_torch.ops.image`.

2. **Named decode specs**: picklable-by-name decode/preprocess recipes
   (``spec name + params dict`` instead of a bound method), so the same
   call crosses a process boundary by reference. Workers resolve the
   name in their own interpreter; the parent never pickles a callable
   or a decoded pixel buffer — outputs land in a shared-memory slot the
   parent handed over (see :mod:`lumen_tpu_torch.utils.shm_arena`).

Thread mode runs the exact same spec functions, so thread- and
process-decoded tensors are bitwise identical by construction.

On a host without OpenCV, :func:`letterbox_numpy` falls back to the
native C letterbox (:mod:`lumen_tpu_torch.native`), imported inside that
branch so that a decode worker which never takes it loads no more.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable

import numpy as np

logger = logging.getLogger(__name__)


def letterbox_params(h: int, w: int, target: int) -> tuple[float, int, int, int, int]:
    """Aspect-preserving resize-with-padding geometry (host-side helper).

    Returns ``(scale, new_h, new_w, pad_top, pad_left)``; the inverse maps
    detector boxes back to original coordinates (reference face pipeline,
    ``lumen_face/backends/onnxrt_backend.py:749-808``).
    """
    scale = min(target / h, target / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    pad_top = (target - new_h) // 2
    pad_left = (target - new_w) // 2
    return scale, new_h, new_w, pad_top, pad_left


def letterbox_numpy(img: np.ndarray, target: int, fill: int = 0) -> tuple[np.ndarray, float, int, int]:
    """Host letterbox for a single decoded image [H, W, C] -> [target, target, C].

    cv2 (SIMD resize) when present; otherwise the fused native C letterbox,
    so the serving path also works in a no-OpenCV environment.
    """
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None and img.dtype == np.uint8:
        from .. import native

        if native.available():
            return native.letterbox_u8(img, target, fill)
    if cv2 is None:
        raise RuntimeError("letterbox requires cv2 or the native host-ops library")

    h, w = img.shape[:2]
    scale, new_h, new_w, pad_top, pad_left = letterbox_params(h, w, target)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    out = np.full((target, target, img.shape[2]), fill, dtype=img.dtype)
    out[pad_top : pad_top + new_h, pad_left : pad_left + new_w] = resized
    return out, scale, pad_top, pad_left


#: result-cache namespace qualifier for the scaled-decode generation.
#: Decode resolution changes result numerics (resampling, thresholded
#: detections): disk-tier entries computed under one decode policy must
#: not answer for another across deploys. Bump when the policy changes.
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
    formats).

    ``max_edge`` opts into SCALED decode: when the image is at least 2x
    oversized for the target edge, the JPEG is decoded directly at 1/2,
    1/4 or 1/8 scale (cv2 ``IMREAD_REDUCED_COLOR_*`` / PIL ``draft``) —
    the IDCT runs on a fraction of the blocks, cutting decode cost ~4x on
    typical photos. Both decoded dims stay >= ``max_edge``, so downstream
    resize/letterbox to the target only ever downscales. Callers that
    must map coordinates back to the original frame use
    :func:`decode_image_bytes_scaled` instead (``_factor`` lets it reuse
    its one header probe instead of probing twice)."""
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


def decode_image_bytes_scaled(
    payload: bytes, color: str = "rgb", max_edge: int | None = None
) -> tuple[np.ndarray, float, tuple[int, int]]:
    """Scaled decode WITH provenance: returns ``(img, decode_scale,
    orig_hw)`` where ``decode_scale = decoded_edge / original_edge``
    (1.0 = full decode). Callers that report coordinates (face boxes,
    OCR quads) fold ``decode_scale`` into their letterbox unmap so
    results stay in ORIGINAL image coordinates."""
    hw = probe_image_size(payload) if max_edge else None
    factor = _factor_from_hw(hw, max_edge) if max_edge else 1
    img = decode_image_bytes(payload, color=color, max_edge=max_edge, _factor=factor)
    if hw is None or min(hw) <= 0:
        return img, 1.0, img.shape[:2]
    # Long-edge ratio: robust to decoders that apply a 90-degree EXIF
    # rotation the header probe doesn't see; orig_hw is then derived from
    # the DECODED orientation so callers unclip against consistent axes.
    scale = max(img.shape[:2]) / max(hw)
    if scale >= 0.999:  # full decode (or non-reducible format)
        return img, 1.0, img.shape[:2]
    h, w = img.shape[:2]
    return img, scale, (round(h / scale), round(w / scale))


# ---------------------------------------------------------------------------
# Named decode specs: process-safe decode/preprocess recipes
# ---------------------------------------------------------------------------

#: spec fn(payload, params) -> ndarray OR (ndarray, extras) where extras is
#: a small picklable tuple of per-item provenance (scales, original dims,
#: error strings) that rides the result queue next to the pixels.
DecodeSpec = Callable[[bytes, dict], "np.ndarray | tuple[np.ndarray, tuple]"]

_SPECS: dict[str, DecodeSpec] = {}
_SPEC_EST: dict[str, Callable[[bytes, dict], int]] = {}

#: slot-size guess when the image header is unprobeable: big enough for a
#: full-decode 12 MP photo class; larger outputs take the pickled spill
#: path (correct, just not zero-copy) and are counted by the pool.
DEFAULT_EST_NBYTES = 16 << 20


def register_decode_spec(
    name: str,
    fn: DecodeSpec,
    est_nbytes: Callable[[bytes, dict], int] | None = None,
) -> None:
    """Register a named decode recipe. ``est_nbytes(payload, params)``
    sizes the shared-memory slot BEFORE the decode runs (the parent
    allocates, the worker writes); an estimate that comes in low is safe
    — the worker falls back to returning the array pickled ("spill")."""
    _SPECS[name] = fn
    if est_nbytes is not None:
        _SPEC_EST[name] = est_nbytes


def resolve_decode_spec(name: str) -> DecodeSpec:
    fn = _SPECS.get(name)
    if fn is None:
        raise KeyError(
            f"unknown decode spec {name!r} (registered: {sorted(_SPECS)})"
        )
    return fn


def spec_est_nbytes(name: str, payload: bytes, params: dict) -> int:
    est = _SPEC_EST.get(name)
    if est is None:
        return DEFAULT_EST_NBYTES
    try:
        return max(1, int(est(payload, params)))
    except Exception:  # noqa: BLE001 - a sizing guess must never fail a decode
        return DEFAULT_EST_NBYTES


def _est_fixed_square(payload: bytes, params: dict) -> int:
    size = int(params["size"])
    return size * size * 3


def _est_probe(payload: bytes, params: dict) -> int:
    """Decoded-size estimate from the image header: dims over the scaled
    decode factor, plus a row of slack for the decoder's rounding. The
    header probe here duplicates the one the decode itself runs (~0.1 ms
    against a 10-50 ms decode) — the price of parent-side allocation."""
    hw = probe_image_size(payload if isinstance(payload, bytes) else bytes(payload))
    if hw is None:
        return DEFAULT_EST_NBYTES
    max_edge = int(params.get("max_edge") or 0)
    f = _factor_from_hw(hw, max_edge) if max_edge else 1
    h, w = hw
    return (h // f + 2) * (w // f + 2) * 3


def _spec_decode(payload: bytes, params: dict) -> np.ndarray:
    return decode_image_bytes(
        payload, color=params.get("color", "rgb"),
        max_edge=params.get("max_edge"),
    )


def _spec_decode_scaled(payload: bytes, params: dict):
    img, scale, orig_hw = decode_image_bytes_scaled(
        payload, color=params.get("color", "rgb"),
        max_edge=params.get("max_edge"),
    )
    return img, (float(scale), int(orig_hw[0]), int(orig_hw[1]))


def _spec_clip_resize(payload: bytes, params: dict) -> np.ndarray:
    """CLIP's serving decode: scaled decode + square squash to the tower
    input (the former ``CLIPManager._decode_resize``, spec-ified so it can
    run in a decode worker process)."""
    import cv2

    size = int(params["size"])
    img = decode_image_bytes(payload, color="rgb", max_edge=size)
    return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)


def _spec_vlm_canvas(payload: bytes, params: dict) -> np.ndarray:
    """VLM's serving decode: scaled decode + pad-to-square letterbox onto
    the vision-tower canvas (the former ``VLMManager._decode_canvas``)."""
    return vlm_canvas(payload, int(params["size"]))


def vlm_canvas(payload: bytes, size: int) -> np.ndarray:
    """The ``vlm_canvas`` spec as a plain function: scaled decode +
    pad-to-square letterbox onto the ``[size, size, 3]`` uint8 canvas
    (image top-left, zero padding right and below)."""
    import cv2

    img = decode_image_bytes(payload, color="rgb", max_edge=size)
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[:nh, :nw] = resized
    return canvas


def _spec_photo(payload: bytes, params: dict):
    """The photo-ingest producer decode (mirrors
    ``PhotoIngestPipeline._decode`` for byte items): scaled decode with
    provenance and the per-item error-record policy. extras =
    ``(decode_scale, orig_h, orig_w, error_or_None)``."""
    max_edge = int(params.get("max_edge") or 0)
    try:
        if max_edge:
            img, dscale, orig_hw = decode_image_bytes_scaled(
                payload, color="rgb", max_edge=max_edge
            )
        else:
            img, dscale, orig_hw = decode_image_bytes(payload, color="rgb"), 1.0, None
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected HWC RGB image, got shape {img.shape}")
    except ValueError as e:
        if params.get("on_error") != "record":
            raise
        # Placeholder keeps batch shapes static; stages skip real work.
        return np.zeros((8, 8, 3), np.uint8), (1.0, 8, 8, str(e))
    oh, ow = orig_hw if orig_hw is not None else img.shape[:2]
    return img, (float(dscale), int(oh), int(ow), None)


def _spec_test_kill(payload: bytes, params: dict) -> np.ndarray:
    """Fault-injection spec (tests only): dies mid-decode exactly like a
    segfaulting image codec would — no cleanup, no exception."""
    import signal

    os.kill(os.getpid(), signal.SIGKILL)
    raise AssertionError("unreachable")  # pragma: no cover


def _spec_test_sleep(payload: bytes, params: dict) -> np.ndarray:
    time.sleep(float(params.get("s", 0.05)))
    return np.frombuffer(payload, np.uint8).copy()


register_decode_spec("decode", _spec_decode, _est_probe)
register_decode_spec("decode_scaled", _spec_decode_scaled, _est_probe)
register_decode_spec("clip_resize", _spec_clip_resize, _est_fixed_square)
register_decode_spec("vlm_canvas", _spec_vlm_canvas, _est_fixed_square)
register_decode_spec("photo", _spec_photo, _est_probe)
register_decode_spec("_test_kill", _spec_test_kill, lambda p, _: max(1, len(p)))
register_decode_spec("_test_sleep", _spec_test_sleep, lambda p, _: max(1, len(p)))


# ---------------------------------------------------------------------------
# Process-worker entry points
# ---------------------------------------------------------------------------

_WORKER_SEGMENTS: dict[str, Any] = {}


def proc_worker_init() -> None:
    """Worker-process initializer: cv2's internal thread pool is pinned to
    one thread — parallelism comes from the PROCESS pool; N workers each
    spawning cv2's own per-core threads would oversubscribe the host."""
    try:
        import cv2

        cv2.setNumThreads(1)
    except Exception:  # noqa: BLE001 - cv2 may be absent (PIL-only envs)
        pass


def _attach_segment(name: str):
    """Attach (and cache) a parent-created shared-memory segment, by
    direct mmap of its ``/dev/shm`` backing file where possible. The
    PARENT owns the lifecycle; going through
    ``multiprocessing.shared_memory`` here would enroll the segment in
    THIS process's resource tracker, which 'helpfully' unlinks tracked
    segments when the worker exits (bpo-38119) and would kill every
    sibling's slot — so the fallback path explicitly unregisters."""
    buf = _WORKER_SEGMENTS.get(name)
    if buf is None:
        import mmap

        path = f"/dev/shm/{name}"
        if os.path.exists(path):
            fd = os.open(path, os.O_RDWR)
            try:
                buf = mmap.mmap(fd, os.fstat(fd).st_size)
            finally:
                os.close(fd)
        else:  # pragma: no cover - non-Linux shm layout
            from multiprocessing import resource_tracker, shared_memory

            seg = shared_memory.SharedMemory(name=name)
            try:
                resource_tracker.unregister(seg._name, "shared_memory")
            except Exception:  # noqa: BLE001 - best-effort
                pass
            buf = seg.buf
        _WORKER_SEGMENTS[name] = buf
    return buf


def proc_decode_task(
    spec: str,
    payload: bytes,
    params: dict | None,
    slot_name: str | None,
    capacity: int,
    deadline: float | None,
):
    """One decode in a worker process. Returns a small picklable tuple:

    - ``("deadline", t_pc, t_mono)`` — expired while queued (the worker-
      side twin of the thread pool's pre-run deadline gate);
    - ``("shm", shape, dtype_str, extras, t0_pc, t1_pc, t0_mono, t1_mono)``
      — pixels are in the parent's slot, ONLY metadata crosses the pipe;
    - ``("raw", array, extras, ...timings)`` — no slot / output larger
      than the slot: the array itself is pickled back (the spill path).

    Timings are absolute ``perf_counter`` / ``monotonic`` stamps; on
    Linux both are CLOCK_MONOTONIC and therefore directly comparable
    across processes, which is what lets the parent stitch ``decode.*``
    trace spans and duty-meter credit with thread-mode fidelity.
    """
    t0_pc, t0_mono = time.perf_counter(), time.monotonic()
    if deadline is not None and t0_mono >= deadline:
        return ("deadline", t0_pc, t0_mono)
    fn = resolve_decode_spec(spec)
    out = fn(payload, dict(params) if params else {})
    extras = None
    if isinstance(out, tuple):
        out, extras = out
    arr = np.ascontiguousarray(out)
    t1_pc, t1_mono = time.perf_counter(), time.monotonic()
    if slot_name is not None and arr.nbytes <= capacity:
        buf = _attach_segment(slot_name)
        dst = np.frombuffer(buf, np.uint8, count=arr.nbytes)
        dst[:] = arr.view(np.uint8).reshape(-1)
        return ("shm", arr.shape, arr.dtype.str, extras, t0_pc, t1_pc, t0_mono, t1_mono)
    return ("raw", arr, extras, t0_pc, t1_pc, t0_mono, t1_mono)


def worker_main() -> None:  # pragma: no cover - exercised via subprocess
    """Entry point of one decode worker process (spawned by the pool as
    ``python -c "from lumen_tpu_torch.utils.host_decode import worker_main;
    worker_main()"``). Speaks a length-prefixed pickle protocol over
    stdin/stdout: each request is a :func:`proc_decode_task` argument
    tuple, each response its return tuple (exceptions cross as
    ``("error", type_name, message)``). ``None`` — or EOF — shuts the
    worker down.

    This replaces ``multiprocessing``'s own worker bootstrapping on
    purpose: a spawn/forkserver child re-imports the parent's
    ``__main__`` (for a server launched as ``python -m
    lumen_tpu_torch.serving.server`` that means torch, grpc and a model
    config per worker), while this entry imports exactly this torch-free
    module.
    """
    import pickle
    import struct
    import sys

    inp = sys.stdin.buffer
    # Claim the protocol fd, then point fd 1 at stderr: a stray print()
    # inside some codec must corrupt a log line, not the wire protocol.
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    proc_worker_init()
    while True:
        hdr = inp.read(8)
        if len(hdr) < 8:
            return
        (n,) = struct.unpack("<Q", hdr)
        task = pickle.loads(inp.read(n))
        if task is None:
            return
        try:
            res = proc_decode_task(*task)
        except BaseException as e:  # noqa: BLE001 - every verdict crosses the pipe
            res = ("error", type(e).__name__, str(e))
        blob = pickle.dumps(res, protocol=pickle.HIGHEST_PROTOCOL)
        out.write(struct.pack("<Q", len(blob)))
        out.write(blob)
        out.flush()
