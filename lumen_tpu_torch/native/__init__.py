"""ctypes bindings for the native host-ops library (``_src/host_ops.cpp``;
the port's copy of ``lumen_tpu/native``).

The C core covers the host half of the serving hot loops — letterbox/resize,
NMS, CTC collapse — GIL-free so the ingest pipeline's preprocess workers
scale across cores. Loading policy:

1. use ``build/lumen_tpu_torch/native/liblumen_host_ops-<abi>-<digest>.so``
   at the checkout's root if present and ABI-compatible (the JAX package
   builds into ``native/build/``; the two never share a library);
2. else, if a C++ toolchain is available, build it once (quiet, ~1s);
3. else mark the library unavailable — every caller has a numpy fallback,
   so the port stays runnable without a compiler.

``LUMEN_TPU_NO_NATIVE=1`` skips native entirely (debugging/benchmark A/B).
This is a host library, not a device path: its callers' numpy bodies give
the same answers.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

ABI_VERSION = 1

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_PKG_DIR))
_SRC_PATH = os.path.join(_PKG_DIR, "_src", "host_ops.cpp")


def _build_dir() -> str:
    """The checkout's ``build/lumen_tpu_torch/native`` (``build/`` is
    git-ignored); an installed package, whose site-packages may not be
    writable, builds into a per-user cache."""
    if os.access(_REPO_ROOT, os.W_OK):
        return os.path.join(_REPO_ROOT, "build", "lumen_tpu_torch", "native")
    return os.path.join(
        os.path.expanduser(os.environ.get("XDG_CACHE_HOME", "~/.cache")),
        "lumen-tpu-torch",
        "native",
    )


def _src_digest() -> str:
    """Short content hash of the C++ source: the cached .so is keyed on it
    so an edited host_ops.cpp (even without an ABI bump) rebuilds instead
    of silently loading the old binary."""
    import hashlib

    try:
        with open(_SRC_PATH, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()[:12]
    except OSError:
        return "nosrc"


_LIB_PATH = os.path.join(
    _build_dir(), f"liblumen_host_ops-{ABI_VERSION}-{_src_digest()}.so"
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build() -> bool:
    src = _SRC_PATH
    if not os.path.exists(src):
        return False
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    # Compile to a per-process temp path and os.replace (atomic on POSIX):
    # concurrent processes racing the first build must never dlopen a
    # half-written .so, and a killed compiler must not leave a corrupt final.
    tmp = f"{_LIB_PATH}.tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            logger.warning("native host-ops build failed:\n%s", proc.stderr[-2000:])
            return False
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.info("native host-ops build skipped: %s", e)
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.lumen_host_ops_abi_version.restype = ctypes.c_int
    lib.resize_bilinear_u8.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_int,
    ]
    lib.letterbox_u8.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.nms_f32.argtypes = [_f32p, _f32p, ctypes.c_int, ctypes.c_float, _i64p]
    lib.nms_f32.restype = ctypes.c_int
    lib.ctc_collapse_batch.argtypes = [
        _i32p, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p, _f32p, _i32p,
    ]
    return lib


def load() -> ctypes.CDLL | None:
    """The bound library, building it on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LUMEN_TPU_NO_NATIVE") == "1":
            return None
        for attempt in range(2):
            if os.path.exists(_LIB_PATH):
                try:
                    lib = _bind(ctypes.CDLL(_LIB_PATH))
                    if lib.lumen_host_ops_abi_version() == ABI_VERSION:
                        _lib = lib
                        logger.info("native host-ops loaded: %s", _LIB_PATH)
                        return _lib
                    logger.info("native host-ops ABI mismatch; rebuilding")
                    _unlink_quiet(_LIB_PATH)
                except (OSError, AttributeError) as e:
                    # Stale/corrupt artifact (OSError: unloadable;
                    # AttributeError: loadable but missing a symbol):
                    # remove it so the rebuild below gets a clean slate.
                    logger.warning("native host-ops load failed: %s", e)
                    _unlink_quiet(_LIB_PATH)
            if attempt == 0 and not _build():
                break
        return None


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def available() -> bool:
    return load() is not None


# -- op wrappers (numpy in, numpy out) --------------------------------------


def resize_bilinear_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """[H, W, C] uint8 -> [dh, dw, C] uint8 (bilinear, pixel-center aligned)."""
    lib = load()
    assert lib is not None, "native host-ops unavailable"
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((dh, dw, c), np.uint8)
    lib.resize_bilinear_u8(img, h, w, c, out, dh, dw)
    return out


def letterbox_u8(img: np.ndarray, target: int, fill: int = 0) -> tuple[np.ndarray, float, int, int]:
    """Fused aspect-preserving resize + centered pad; mirrors
    ``ops.image.letterbox_numpy``'s return contract."""
    lib = load()
    assert lib is not None, "native host-ops unavailable"
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((target, target, c), np.uint8)
    scale = ctypes.c_double()
    pad_top = ctypes.c_int()
    pad_left = ctypes.c_int()
    lib.letterbox_u8(img, h, w, c, out, target, fill,
                     ctypes.byref(scale), ctypes.byref(pad_top), ctypes.byref(pad_left))
    return out, scale.value, pad_top.value, pad_left.value


def nms_f32(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.4) -> np.ndarray:
    """Greedy IoU NMS; kept indices by descending score (same contract as
    ``ops.nms.nms_numpy``)."""
    lib = load()
    assert lib is not None, "native host-ops unavailable"
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = len(boxes)
    keep = np.empty((n,), np.int64)
    count = lib.nms_f32(boxes, scores, n, iou_threshold, keep)
    return keep[:count]


def ctc_collapse_batch(
    ids: np.ndarray, confs: np.ndarray, blank: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[B, T] ids/confs -> (emitted ids [B, T], confs [B, T], counts [B])."""
    lib = load()
    assert lib is not None, "native host-ops unavailable"
    ids = np.ascontiguousarray(ids, np.int32)
    confs = np.ascontiguousarray(confs, np.float32)
    b, t = ids.shape
    out_ids = np.empty((b, t), np.int32)
    out_confs = np.empty((b, t), np.float32)
    counts = np.empty((b,), np.int32)
    lib.ctc_collapse_batch(ids, confs, b, t, blank, out_ids, out_confs, counts)
    return out_ids, out_confs, counts
