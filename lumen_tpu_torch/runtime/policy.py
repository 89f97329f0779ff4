"""Mixed-precision policy and device selection for the port.

Twin of ``lumen_tpu/runtime/policy.py``: bf16 weights and compute for
serving, f32 results; f32 throughout for the CPU tests. Device selection
replaces the JAX mesh for the single-card slice: the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype


_POLICIES = {
    # name -> (params, compute, output)
    "bfloat16": Policy(torch.bfloat16, torch.bfloat16, torch.float32),
    "float32": Policy(torch.float32, torch.float32, torch.float32),
    "float16": Policy(torch.float16, torch.float16, torch.float32),
}


def get_policy(name: str) -> Policy:
    try:
        return _POLICIES[name]
    except KeyError as e:
        raise ValueError(f"unknown dtype policy {name!r}; valid: {sorted(_POLICIES)}") from e


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` by default, which
    raises when no card is present; the CPU only when the caller passes
    ``device="cpu"`` (the tests do). Nothing falls back silently."""
    dev = torch.device(device if device is not None else "cuda:0")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on an NVIDIA GPU "
                "(pass device='cpu' explicitly to run the plain PyTorch path)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
