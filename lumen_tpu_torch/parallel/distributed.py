"""Process-group initialization (twin of ``lumen_tpu/parallel/distributed.py``).

The JAX package starts a ``jax.distributed`` runtime: one process a host,
driving every local device. The port starts a ``torch.distributed``
process group, and there ONE PROCESS DRIVES ONE DEVICE: a host with four
cards runs four ranks. So ``LUMEN_NUM_PROCESSES`` counts ranks (cards in
all, over every host), not hosts, and ``LUMEN_PROCESS_ID`` is the global
rank. Single-host, single-device use stays zero-config: nothing set, no
group, :func:`initialize` returns False.

Env convention (the JAX package's): ``LUMEN_COORDINATOR`` (host:port of
rank 0's TCP store), ``LUMEN_NUM_PROCESSES``, ``LUMEN_PROCESS_ID`` --
explicit arguments win over the environment.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str = "cuda",
) -> bool:
    """Join the process group if one is configured; True when a
    multi-process group is live, False for single-process operation (no
    group is opened).

    ``device`` is ``cuda`` (the ``nccl`` backend) unless the caller asks
    for ``cpu`` (``gloo``). On CUDA each rank binds its card,
    ``torch.cuda.set_device(rank % torch.cuda.device_count())`` -- one rank
    a card, ranks numbered host by host -- before the group (or the caller)
    makes a CUDA tensor. A second call returns True without a new group."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("LUMEN_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("LUMEN_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid_env = os.environ.get("LUMEN_PROCESS_ID")
        process_id = int(pid_env) if pid_env is not None else None

    if not coordinator_address or num_processes <= 1:
        logger.info("single-process mode (no process group)")
        return False
    if process_id is None:
        raise ValueError("a process group needs this process's rank (process_id or LUMEN_PROCESS_ID)")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): CUDA is not available; pass device='cpu' for gloo")
        local = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(local)
        dist.init_process_group(
            "nccl", init_method=f"tcp://{coordinator_address}", world_size=num_processes,
            rank=process_id, device_id=local,
        )
    elif device == "cpu":
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id
        )
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    logger.info(
        "process group up: rank %d/%d (%s)", dist.get_rank(), dist.get_world_size(), dist.get_backend()
    )
    return True


def is_primary() -> bool:
    """True on the process that should bind user-facing servers / write
    checkpoints: rank 0, or the only process when no group is live."""
    return not dist.is_initialized() or dist.get_rank() == 0
