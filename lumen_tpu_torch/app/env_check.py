"""CUDA environment checker + pip mirror selection for the control plane.

The port's counterpart of the JAX package's ``app/env_check.py``
(reference: ``lumen-app/src/lumen_app/utils/env_checker.py:27-826`` and the
CN-aware ``MirrorSelector``). On an NVIDIA host the questions are: is the
torch stack importable and built for CUDA, is ``nvcc`` there (the port
builds its kernels at first use, so a host without it fails at its first
launch: a required check), does the driver answer (``nvidia-smi``), are the
``/dev/nvidia*`` nodes present, is there disk for the model cache --
answered from metadata, the filesystem and subprocesses, WITHOUT creating
a CUDA context in the control plane (the server it spawns would share the
card with it; see ``app/hardware.py`` for the subprocess device probe).
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import sys
from dataclasses import dataclass
from importlib import metadata

#: the toolkit's default location when nvcc is not on PATH
CUDA_HOME_NVCC = "/usr/local/cuda/bin/nvcc"


@dataclass
class Check:
    name: str
    ok: bool
    detail: str
    required: bool = True

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "detail": self.detail,
            "required": self.required,
        }


def _version_of(*dists: str) -> str | None:
    for dist in dists:
        try:
            return f"{dist} {metadata.version(dist)}"
        except metadata.PackageNotFoundError:
            continue
    return None


def check_python() -> Check:
    v = sys.version_info
    detail = f"python {v.major}.{v.minor}.{v.micro}"
    return Check("python", (v.major, v.minor) >= (3, 11), detail)


def _torch_cuda_version() -> str | None:
    """The CUDA version the installed torch was built for, read in a
    subprocess (importing torch costs seconds and some memory; the control
    plane keeps neither)."""
    try:
        out = subprocess.run(
            [sys.executable, "-c", "import torch; print(torch.version.cuda or '')"],
            capture_output=True, text=True, timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def check_torch_stack() -> list[Check]:
    """Versions of the compute stack from dist metadata, and the CUDA
    version torch was built for."""
    out = []
    for name, dists, required in (
        ("torch", ("torch",), True),
        ("numpy", ("numpy",), True),
        ("grpcio", ("grpcio",), True),
        ("safetensors", ("safetensors",), True),
        ("triton", ("triton",), False),
    ):
        ver = _version_of(*dists)
        out.append(Check(name, ver is not None, ver or "not installed", required))
    if out[0].ok:
        cuda = _torch_cuda_version()
        out.append(Check(
            "torch_cuda", cuda is not None,
            f"torch built for CUDA {cuda}" if cuda else "torch has no CUDA build (CPU-only)",
        ))
    return out


def check_nvcc() -> Check:
    """The CUDA compiler the port builds its kernels with at first use."""
    path = shutil.which("nvcc") or (CUDA_HOME_NVCC if os.path.exists(CUDA_HOME_NVCC) else None)
    if path is None:
        return Check("nvcc", False, "nvcc not on PATH nor at /usr/local/cuda (the kernels cannot build)")
    try:
        out = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60)
        release = [line for line in out.stdout.splitlines() if "release" in line]
        detail = f"{path}: {release[-1].strip() if release else 'version unknown'}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return Check("nvcc", False, f"{path}: {e}")
    return Check("nvcc", out.returncode == 0, detail)


def check_driver() -> Check:
    """The NVIDIA driver, as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return Check("nvidia_driver", False, f"nvidia-smi unavailable: {e}")
    rows = out.stdout.strip().splitlines()
    if out.returncode != 0 or not rows:
        return Check("nvidia_driver", False, (out.stderr or out.stdout).strip()[-300:] or "no card listed")
    return Check("nvidia_driver", True, "; ".join(rows[:8]))


def check_gpu_devices() -> Check:
    nodes = sorted(glob.glob("/dev/nvidia*"))
    if nodes:
        return Check("gpu_devices", True, ", ".join(nodes[:8]))
    return Check("gpu_devices", False, "no /dev/nvidia* nodes")


def check_disk(cache_dir: str, need_gb: float = 10.0) -> Check:
    """Model cache needs room: the reference's full tier pulls several GB
    of weights (``lumen_resources/downloader.py``)."""
    path = os.path.expanduser(cache_dir)
    probe = path
    while probe and not os.path.exists(probe):
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    try:
        free_gb = shutil.disk_usage(probe or "/").free / 1e9
    except OSError as e:
        return Check("disk_space", False, f"cannot stat {probe!r}: {e}")
    return Check(
        "disk_space",
        free_gb >= need_gb,
        f"{free_gb:.1f} GB free at {probe} (need ~{need_gb:.0f} GB)",
    )


def environment_report(cache_dir: str = "~/.lumen-tpu", need_gb: float = 10.0) -> dict:
    """Aggregate check report for ``GET /api/v1/hardware/check``. ``ok``
    requires every *required* check: the torch stack built for CUDA,
    ``nvcc``, the driver, the device nodes and the disk; optional ones
    (``triton``) inform the wizard without blocking."""
    checks: list[Check] = [check_python(), *check_torch_stack(), check_nvcc(), check_driver(),
                           check_gpu_devices(), check_disk(cache_dir, need_gb)]
    return {
        "ok": all(c.ok for c in checks if c.required),
        "checks": [c.as_dict() for c in checks],
    }


def pip_index_url(region: str) -> str | None:
    """Region -> preferred PyPI index (None = default). Delegates to the
    package resolver so ONE module owns the mirror policy (the installer's
    pip step uses the same source via ``pip_index_args``)."""
    from lumen_tpu_torch.app.package_resolver import PYPI_OFFICIAL, pypi_indexes

    preferred = pypi_indexes(region)[0]
    return None if preferred == PYPI_OFFICIAL else preferred
