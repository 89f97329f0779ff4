"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point. It is
compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library
in the kernel build cache (``runtime/compile_cache.build_dir()``: by
default ``build/lumen_tpu_torch/`` at the repository root,
``LUMEN_COMPILE_CACHE_DIR`` moves it) and loaded with ``ctypes`` (no
PyTorch headers in the build: a source compiles in seconds). The
library's file name carries a hash of the sources and flags, so an edited
kernel is never served from a stale build; a build that runs is reported
to ``compile_cache.note_build``.

A :class:`CudaKernel` also counts its launches, in all, by instance (the
attention kernels' head_dim) and by (dtype, instance): ``chip_smoke.py``
zeroes the counts before it drives the serving path and reads them
afterwards, to show the path really went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..runtime import compile_cache

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needs the CUDA toolkit on PATH or /usr/local/cuda)")
    return path


class CudaKernel:
    """One ``csrc/<source>.cu`` library and the C function it exports."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        #: launches by template instance (``launch(..., instance=)``)
        self.instance_launches: dict[int, int] = {}
        #: launches by element type and instance (``launch(..., dtype=)``):
        #: ``{"float16": {64: n}}``
        self.dtype_launches: dict[str, dict] = {}
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def source_path(self) -> Path:
        return CSRC / f"{self.source}.cu"

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in sorted(CSRC.glob("*.cuh")) + [self.source_path]:
            h.update(path.read_bytes())
        return compile_cache.build_dir() / f"{self.source}-{h.hexdigest()[:12]}.so"

    def start_build(self) -> "tuple | None":
        """Start ``nvcc`` for this library unless it is already built;
        the caller waits (:func:`build_all` runs every build at once)."""
        lib = self.library_path()
        if lib.exists():
            return None
        nvcc = _nvcc()
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(self.source_path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, lib, time.perf_counter()

    def load(self):
        """The bound C function, building the library first if needed."""
        with self._lock:
            if self._fn is None:
                build = self.start_build()
                if build is not None:
                    _finish_build(self, build)
                self._lib = ctypes.CDLL(str(self.library_path()))
                fn = getattr(self._lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def query(self, symbol: str, *args: int) -> int:
        """Call another ``int f(int, ...)`` the library exports (a
        kernel's launch geometry, for reports); launches nothing."""
        self.load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_int
        return fn(*args)

    def launch(self, *args, instance: int | None = None, dtype=None) -> None:
        """Call the C entry point; raise on a non-zero CUDA error code
        (a refused launch never runs, and a later synchronize would not
        report it). ``instance`` names the template instance the call
        reaches (a head_dim), counted apart as well, and ``dtype`` (a
        ``torch.dtype`` or its name) its element type, counted by type
        and instance."""
        rc = self.load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error code {rc}")
        with self._lock:  # callers launch from several threads
            self.launches += 1
            if instance is not None:
                self.instance_launches[instance] = self.instance_launches.get(instance, 0) + 1
            if dtype is not None:
                by = self.dtype_launches.setdefault(str(dtype).removeprefix("torch."), {})
                by[instance] = by.get(instance, 0) + 1

    def zero_counts(self) -> None:
        """Set the launch counts, in all, by instance and by type, to 0."""
        with self._lock:
            self.launches = 0
            self.instance_launches = {}
            self.dtype_launches = {}


def _finish_build(kernel: CudaKernel, build: tuple) -> str:
    proc, tmp, lib, t0 = build
    out, _ = proc.communicate()
    log = lib.with_suffix(".log")
    log.write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {kernel.source_path}:\n{out}")
    os.replace(tmp, lib)
    compile_cache.note_build(lib.name, time.perf_counter() - t0)
    return out


def build_all(kernels) -> dict[str, str]:
    """Build every kernel's library at once (one ``nvcc`` per source, all
    started together) and load them. Returns each kernel's compiler log
    (``-Xptxas -v``: registers and shared memory per instantiation)."""
    builds = [(k, k.start_build()) for k in kernels]
    logs = {}
    for kernel, build in builds:
        if build is not None:
            logs[kernel.name] = _finish_build(kernel, build)
        else:
            log = kernel.library_path().with_suffix(".log")
            logs[kernel.name] = log.read_text() if log.exists() else ""
        kernel.load()
    return logs
