"""The kernel build cache: where the port's compiled libraries live.

The JAX package's ``runtime/compile_cache.py`` persists XLA executables so
a warm restart skips compilation. The port compiles nothing through XLA:
its compile step is ``nvcc`` for each ``csrc/*.cu`` kernel library
(``ops/cuda_build.py``) and ``g++`` for the native host library
(``native/``), both built at first use and keyed by a hash of their
sources. This module owns the directory both write to, and feeds each
build that actually runs into the capacity telemetry. It keeps the JAX
names:

- :func:`enable_persistent_cache` (``serve()`` and the ingest CLI call it)
  sets the directory: ``path``, else ``LUMEN_COMPILE_CACHE_DIR``, else the
  checkout's ``build/lumen_tpu_torch/`` (git-ignored; an installed package
  whose tree is not writable uses ``$XDG_CACHE_HOME/lumen-tpu-torch``).
  ``LUMEN_COMPILE_CACHE=0`` builds into a fresh directory of this process,
  removed at exit: nothing persists, as in JAX.
- Every build that runs bumps the ``kernel_builds`` counter and the
  ``kernel_build_ms`` histogram (:func:`note_build`), which ``/stats``
  reports as its ``compile`` block. A library found already built counts
  nothing. :func:`install_compile_listener` keeps the JAX name and does
  nothing more: the count is always on.

Builds stay atomic across processes: each writes a per-process temporary
file and ``os.replace``-s it into place, so a supervised server and its
parent may share the directory.
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import tempfile
import threading
from pathlib import Path

logger = logging.getLogger(__name__)

#: the checkout's root, whose ``build/`` is git-ignored
_REPO_ROOT = Path(__file__).resolve().parents[2]
_lock = threading.Lock()
_dir: Path | None = None
_private: Path | None = None  # this process's directory under LUMEN_COMPILE_CACHE=0


def _default_dir() -> Path:
    if os.access(_REPO_ROOT, os.W_OK):
        return _REPO_ROOT / "build" / "lumen_tpu_torch"
    return Path(os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")) / "lumen-tpu-torch"


def _private_dir() -> Path:
    global _private
    if _private is None:
        _private = Path(tempfile.mkdtemp(prefix="lumen-kernels-"))
        atexit.register(shutil.rmtree, _private, True)
    return _private


def _resolve(path: str | None) -> Path:
    if os.environ.get("LUMEN_COMPILE_CACHE") == "0":
        return _private_dir()
    return Path(path or os.environ.get("LUMEN_COMPILE_CACHE_DIR") or _default_dir())


def build_dir() -> Path:
    """The directory kernel libraries build into and load from (resolved
    from the environment at first use unless
    :func:`enable_persistent_cache` set it)."""
    global _dir
    with _lock:
        if _dir is None:
            _dir = _resolve(None)
        return _dir


def enable_persistent_cache(path: str | None = None) -> str | None:
    """Point the kernel builds at their directory. Returns the directory,
    or None when ``LUMEN_COMPILE_CACHE=0`` gave this process a private
    one."""
    global _dir
    resolved = _resolve(path)
    resolved.mkdir(parents=True, exist_ok=True)
    with _lock:
        _dir = resolved
    if os.environ.get("LUMEN_COMPILE_CACHE") == "0":
        logger.info("kernel build cache off: building into %s for this process", resolved)
        return None
    logger.info("kernel build cache at %s", resolved)
    return str(resolved)


def install_compile_listener() -> bool:
    """The JAX name: every build that runs already feeds the telemetry."""
    return True


def note_build(name: str, seconds: float) -> None:
    """A library ``name`` was compiled in ``seconds`` (the build steps call
    this after a build that ran, never for a library found built)."""
    logger.info("built %s in %.1f s", name, seconds)
    from ..utils import telemetry
    from ..utils.metrics import metrics

    # metrics.count tees into the rolling window itself; the duration
    # histogram goes to telemetry directly (a metrics.observe would add a
    # "kernel_build_ms" row to the per-task table).
    metrics.count("kernel_builds")
    telemetry.observe("kernel_build_ms", seconds * 1e3)
