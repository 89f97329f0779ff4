"""Training checkpoint/resume on ``torch.distributed.checkpoint`` (twin of
``lumen_tpu/training/checkpoint.py``, which is built on orbax).

A checkpoint is ``{params, opt_state}`` under ``<directory>/<step>/`` in
DCP's format, written by every rank for the shards it holds (a
replicated tensor once). A step counts once its ``.metadata`` exists:
DCP writes it last. Restored into ``*_like`` templates, tensors come back
with the templates' placements -- DCP reshards, the counterpart of orbax
re-applying the trainer's shardings -- so a resume may change the mesh;
without a template they come back as plain CPU tensors of the saved
shapes and dtypes.

The format is the port's own: this reads no orbax directory. Weights
cross between the packages through the converter
(``models.clip.convert.clip_params_from_jax``,
``training.clip_trainer.state_from_optax``), not through checkpoint
files.

Multi-process: every rank calls ``save`` and ``restore`` collectively
(do NOT gate on ``is_primary``); retention pruning runs on the primary
rank after a save has completed, between barriers. Without a process
group it works in the one process.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..parallel.distributed import is_primary

logger = logging.getLogger(__name__)

_DONE = ".metadata"


class TrainCheckpointer:
    """Save/restore ``{params, opt_state}`` bundles under a directory: keep
    the newest ``max_to_keep`` steps, and one checkpoint every
    ``keep_period`` steps for good (orbax ``CheckpointManager`` policy).
    With ``async_save`` a save returns once the tensors are staged in host
    memory and writes in the background; the next save, :meth:`wait` or
    :meth:`close` finishes it."""

    def __init__(self, directory: str, max_to_keep: int = 3, keep_period: int | None = None, async_save: bool = True):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.async_save = async_save
        self._pending = None  # (step, future) of an async save in flight
        # DCP's async path stages and coordinates on the CPU: an NCCL-only
        # group gets a gloo companion (made collectively, here).
        self._pg = None
        if dist.is_initialized():
            self._pg = dist.new_group(backend="gloo")
        if is_primary():
            os.makedirs(self.directory, exist_ok=True)
        self._barrier()

    def _barrier(self) -> None:
        if self._pg is not None:
            dist.barrier(group=self._pg)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    # -- save -------------------------------------------------------------

    def save(self, step: int, params: Any, opt_state: Any, wait: bool = False) -> None:
        self.wait()
        state = {"params": params, "opt_state": opt_state}
        if self.async_save:
            future = dcp.async_save(state, checkpoint_id=self._path(step), process_group=self._pg)
            self._pending = (step, future)
        else:
            dcp.save(state, checkpoint_id=self._path(step), process_group=self._pg)
            self._finished()
        if wait:
            self.wait()

    def _finished(self) -> None:
        """A save completed on every rank: prune on the primary rank."""
        self._barrier()
        if is_primary():
            for step in self._to_prune():
                shutil.rmtree(self._path(step), ignore_errors=True)
        self._barrier()

    def _to_prune(self) -> list[int]:
        steps = self.all_steps()
        old = steps[: -self.max_to_keep] if self.max_to_keep else []
        return [s for s in old if not (self.keep_period and s % self.keep_period == 0)]

    # -- restore ----------------------------------------------------------

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self, step: int | None = None, params_like: Any = None, opt_state_like: Any = None
    ) -> tuple[int, Any, Any]:
        """Restore (step, params, opt_state). Pass ``*_like`` templates
        (e.g. the freshly-initialized state) so tensors come back with the
        trainer's placements; the templates are not written to."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self._path(step)
        if not os.path.exists(os.path.join(path, _DONE)):
            raise FileNotFoundError(f"no checkpoint for step {step} under {self.directory}")
        saved = _saved_template(path)
        state = {
            "params": _empty_like(params_like) if params_like is not None else saved["params"],
            "opt_state": _empty_like(opt_state_like) if opt_state_like is not None else saved["opt_state"],
        }
        dcp.load(state, checkpoint_id=path, process_group=self._pg)
        logger.info("restored checkpoint step %d from %s", step, self.directory)
        return step, state["params"], state["opt_state"]

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and os.path.exists(os.path.join(self.directory, d, _DONE))
        )

    @property
    def in_flight(self) -> bool:
        """An async save has returned and is still writing."""
        return self._pending is not None and not self._pending[1].done()

    def wait(self) -> None:
        if self._pending is not None:
            _, future = self._pending
            self._pending = None
            future.result()
            self._finished()

    def close(self) -> None:
        self.wait()
        if self._pg is not None:
            dist.destroy_process_group(self._pg)
            self._pg = None


def _empty_like(tree):
    """Fresh tensors with the template's shapes, dtypes, devices and
    placements (DCP loads in place)."""
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    return torch.empty_like(tree)


def _saved_template(path: str) -> dict:
    """Plain CPU tensors of the saved shapes and dtypes, nested as saved
    (DCP records each flattened key's path)."""
    md = dcp.FileSystemReader(path).read_metadata()
    out: dict = {"params": {}, "opt_state": {}}
    for fqn, tmeta in md.state_dict_metadata.items():
        keys = md.planner_data[fqn]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(tmeta.size, dtype=tmeta.properties.dtype)
    return out
