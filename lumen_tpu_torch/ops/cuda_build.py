"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point. It is
compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/lumen_tpu_torch/`` at the repository root and loaded with
``ctypes`` (no PyTorch headers in the build: a source compiles in
seconds). The library's file name carries a hash of the sources and flags,
so an edited kernel is never served from a stale build.

A :class:`CudaKernel` also counts its launches: ``chip_smoke.py`` zeroes
the counts before it drives the serving path and reads them afterwards,
to show the path really went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lumen_tpu_torch"
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
        return BUILD_DIR / f"{self.source}-{h.hexdigest()[:12]}.so"

    def start_build(self) -> "tuple | None":
        """Start ``nvcc`` for this library unless it is already built;
        the caller waits (:func:`build_all` runs every build at once)."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(self.source_path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, lib

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

    def launch(self, *args) -> None:
        """Call the C entry point; raise on a non-zero CUDA error code
        (a refused launch never runs, and a later synchronize would not
        report it)."""
        rc = self.load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error code {rc}")
        with self._lock:  # callers launch from several threads
            self.launches += 1


def _finish_build(kernel: CudaKernel, build: tuple) -> str:
    proc, tmp, lib = build
    out, _ = proc.communicate()
    log = lib.with_suffix(".log")
    log.write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {kernel.source_path}:\n{out}")
    os.replace(tmp, lib)
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
