"""Hardware detection for the port's control plane.

The JAX package's ``app/hardware.py`` asks ``jax.devices()``; the port asks
torch: the platform (``cuda`` or ``cpu``), the first card's name, the card
count and each card's memory from ``torch.cuda.get_device_properties``.
The probe runs in a SUBPROCESS, so the control plane never holds a CUDA
context: one costs about half a gigabyte of the card, which the server the
app spawns would share. A probe that times out asks ``nvidia-smi``
instead (``_env_declared_gpu``), so a slow driver does not read as "no
card".
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
from dataclasses import dataclass, field

from .presets import (
    chip_spec,
    detect_preset,
    parse_generation,
    supported_presets,
)

logger = logging.getLogger(__name__)

_PROBE = r"""
import json
try:
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(json.dumps({
        "platform": "cuda" if n else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if n else "",
        "device_count": n,
        "device_memory_gb": [torch.cuda.get_device_properties(i).total_memory / 1e9 for i in range(n)],
    }))
except Exception as e:
    print(json.dumps({"platform": "none", "device_kind": "", "device_count": 0, "error": str(e)}))
"""


@dataclass
class HardwareInfo:
    platform: str  # "cuda" | "cpu" | "none"
    device_kind: str
    device_count: int
    process_count: int = 1
    cpu_count: int = 1
    memory_gb: float = 0.0
    device_memory_gb: float = 0.0  # the first card's total memory
    error: str | None = None
    env: dict[str, str] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "platform": self.platform,
            "device_kind": self.device_kind,
            "device_count": self.device_count,
            "process_count": self.process_count,
            "cpu_count": self.cpu_count,
            "memory_gb": round(self.memory_gb, 2),
            "device_memory_gb": round(self.device_memory_gb, 2),
            "error": self.error,
            "env": self.env,
        }


def _host_memory_gb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def _env_declared_gpu(timeout: float = 10.0) -> tuple[str, str, int, float] | None:
    """(platform, device_kind, device_count, memory GB of the first card)
    from ``nvidia-smi --query-gpu=name,memory.total --format=csv,noheader``
    alone -- asked when the live probe cannot answer in time; None when
    the tool is missing or lists no card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,memory.total", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=timeout,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    rows = [line.rsplit(",", 1) for line in out.stdout.strip().splitlines() if "," in line]
    if out.returncode != 0 or not rows:
        return None
    name, mem = rows[0][0].strip(), rows[0][1].strip()  # "81559 MiB"
    try:
        mem_gb = float(mem.split()[0]) * 2**20 / 1e9
    except ValueError:
        mem_gb = 0.0
    return "cuda", name, len(rows), mem_gb


def detect_hardware(timeout: float = 60.0) -> HardwareInfo:
    """Probe the cards in a subprocess; never creates a CUDA context in the
    control-plane process. A probe that times out on a host whose
    ``nvidia-smi`` lists cards still reports them, with the timeout
    recorded in ``error``."""
    probe = {"platform": "none", "device_kind": "", "device_count": 0}
    try:
        out = subprocess.run(
            [sys.executable, "-c", _PROBE],
            capture_output=True,
            text=True,
            timeout=timeout,
            env={**os.environ},
        )
        for line in (out.stdout or "").strip().splitlines():
            try:
                probe = json.loads(line)
                break
            except json.JSONDecodeError:
                continue
    except subprocess.TimeoutExpired:
        # Only a TIMEOUT asks the driver -- a spawn failure (OSError
        # below) keeps its real message instead of a misdiagnosis.
        declared = _env_declared_gpu()
        if declared is not None:
            probe["platform"], probe["device_kind"], probe["device_count"], mem = declared
            probe["device_memory_gb"] = [mem]
            probe["error"] = (
                f"live probe timed out after {timeout:.0f}s; cards taken from nvidia-smi"
            )
        else:
            probe["error"] = f"probe timed out after {timeout:.0f}s"
    except OSError as e:
        probe["error"] = str(e)

    cuda_env = {
        k: v
        for k, v in os.environ.items()
        if k.startswith(("CUDA_", "NVIDIA_", "LUMEN_COMPILE_")) and "KEY" not in k and "TOKEN" not in k
    }
    mems = probe.get("device_memory_gb") or [0.0]
    return HardwareInfo(
        platform=probe.get("platform", "none"),
        device_kind=probe.get("device_kind", ""),
        device_count=int(probe.get("device_count", 0)),
        cpu_count=os.cpu_count() or 1,
        memory_gb=_host_memory_gb(),
        device_memory_gb=float(mems[0]),
        error=probe.get("error"),
        env=cuda_env,
    )


def hardware_report(hw: HardwareInfo | None = None) -> dict:
    """Detection + the preset recommendation the wizard shows (the JAX
    report's keys; ``chip`` describes the first card)."""
    hw = hw or detect_hardware()
    plat = "cuda" if hw.platform == "cuda" and hw.device_count > 0 else "cpu"
    supported = supported_presets(plat, hw.device_count, hw.device_kind)
    best = supported[0] if supported else detect_preset(plat, hw.device_count)
    generation = parse_generation(hw.device_kind)
    spec = chip_spec(generation) if generation else None
    return {
        "hardware": hw.as_dict(),
        "generation": generation,
        "chip": (
            {
                "hbm_gb": spec.hbm_gb,
                "bf16_tflops": spec.bf16_tflops,
                "slice_bf16_tflops": spec.bf16_tflops * max(hw.device_count, 1),
            }
            if spec
            else None
        ),
        "recommended_preset": best.name,
        "supported_presets": [p.name for p in supported],
    }
