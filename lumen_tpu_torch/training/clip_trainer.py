"""Contrastive (CLIP) training over a process mesh (twin of
``lumen_tpu/training/clip_trainer.py``).

InfoNCE over the global batch, AdamW with weight-decay masking, global-norm
clipping, parameters sharded over ``model`` by the tensor-parallel rules
and batches sharded over ``data``. The JAX trainer is one jitted program
and XLA inserts the collectives; here every rank runs the step on its own
shard, and the collectives are explicit:

- ``data``: each rank holds ``B / data`` rows. The embeddings are
  all-gathered over ``data`` with an autograd-aware gather
  (``parallel.spmd.gather_rows``, the semantics of
  ``torch.distributed.nn.functional.all_gather``) whose backward sums
  over ranks, so each rank's gradient is ``data`` times its share of the
  global one: the gradients are then AVERAGED over ``data``.
- ``model``: parameters are DTensors placed by ``TRANSFORMER_TP_RULES``;
  the forward runs on them under DTensor's sharding propagation (the
  counterpart of XLA's), and each rank updates its own shard.

The optimizer is the optax chain the JAX trainer builds, written out:
``clip_by_global_norm`` (``g / norm * max_norm`` when ``norm >=
max_norm``; the norm over whole parameters), then ``adamw`` with the
``warmup_cosine_decay_schedule`` evaluated at the count BEFORE the update
(the first step's rate is ``init_value = 0``) and the JAX decay mask, then
the ``logit_scale`` clamp to ln 100. ``opt_state`` is ``{name: {"step",
"exp_avg", "exp_avg_sq"}}`` per parameter (``torch.optim.AdamW``'s
names for optax's ``count``, ``mu`` and ``nu``).

Attention: the JAX trainer never reaches Pallas. ``_flash_usable``
(``lumen_tpu/ops/attention.py:408-431``) sends every sequence shorter
than ``LUMEN_FLASH_MIN_SEQ`` (256) to the XLA ``attention_reference``, and
the towers run at 50 and 77 tokens, so ``jax.value_and_grad``
differentiates XLA attention. The port's flash kernel has no backward,
so the trainer builds its towers on ``ops.attention.attention_reference``
under autograd, on every device.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from ..models.clip.convert import clip_params_from_jax
from ..models.clip.modeling import CLIPConfig, CLIPModel
from ..models.vlm.convert import tree_paths
from ..ops.attention import attention_reference
from ..parallel.sharding import TRANSFORMER_TP_RULES, shard_params
from ..parallel.spmd import gather_rows
from ..runtime.mesh import DATA_AXIS, MODEL_AXIS, axis_sizes

#: the temperature's ceiling, ``jnp.log(100.0)`` in float32
LOGIT_SCALE_MAX = float(np.log(np.float32(100.0)))


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.2
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    #: Recompute each transformer block's activations in the backward
    #: (``torch.utils.checkpoint``, non-reentrant, one checkpoint a block:
    #: only block inputs stay saved). The JAX trainer checkpoints the whole
    #: forward under ``dots_with_no_batch_dims_saveable``, which also keeps
    #: the weight-only matmul outputs; the loss and update are the same,
    #: only memory and recompute differ.
    remat: bool = False


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0.0, lr, warmup, total)`` at
    ``count``, in float32 as optax computes it."""
    f32 = np.float32
    peak, warmup = f32(cfg.learning_rate), cfg.warmup_steps
    if count < warmup:
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return float((f32(0.0) - peak) * frac + peak)
    decay_steps = cfg.total_steps - warmup
    t = f32(min(count - warmup, decay_steps))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay_steps), dtype=f32))
    return float(peak * cosine)


def contrastive_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor, logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the (global) batch; embeddings unit-norm.
    The temperature is clamped to ln(100) inside the loss as well as after
    each update, so even a corrupted checkpoint can't overflow exp()."""
    scale = torch.exp(torch.clamp(logit_scale, max=LOGIT_SCALE_MAX))
    logits = scale * img_emb @ txt_emb.T  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = torch.nn.functional.cross_entropy(logits, labels)
    lt = torch.nn.functional.cross_entropy(logits.T, labels)
    return (li + lt) / 2


def decay_mask(model: torch.nn.Module) -> dict[str, bool]:
    """JAX ``_decay_mask`` on each parameter's Flax path: no weight decay
    for rank <= 1 (biases, norm scales, scalars) or a path containing
    ``embedding``."""
    paths = tree_paths(model)
    return {n: p.dim() > 1 and "embedding" not in paths[n] for n, p in model.named_parameters()}


def _shard_dims(t: torch.Tensor) -> dict[str, int]:
    """``{mesh axis: tensor dim}`` a DTensor is split over ({} otherwise)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return {}
    return {
        name: p.dim for name, p in zip(t.device_mesh.mesh_dim_names, t.placements) if p.is_shard()
    }


def _init_param(name: str, path: str, shape: tuple, gen: torch.Generator) -> torch.Tensor:
    """The JAX CLIP's initializers, on the generator's device: Dense and
    patch kernels lecun-normal (truncated at two deviations), embedding
    tables normal(1/sqrt(width)), position / class / token-type
    embeddings normal(0.02), norm scales 1, biases 0."""
    dev = gen.device
    leaf = path.rsplit("/", 1)[-1]
    if name == "logit_scale":
        return torch.full(shape, math.log(1 / 0.07), device=dev)
    if leaf == "scale":
        return torch.ones(shape, device=dev)
    if leaf == "bias":
        return torch.zeros(shape, device=dev)
    if leaf == "embedding":
        return torch.randn(shape, generator=gen, device=dev) / math.sqrt(shape[-1])
    if leaf == "kernel":
        fan_in = shape[-1]  # [out, in] in the port's layout
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # lecun_normal's truncation correction
        t = torch.empty(shape, device=dev)
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
    return torch.randn(shape, generator=gen, device=dev) * 0.02


class ClipTrainer:
    """CLIP training step over an optional process mesh.

    ``mesh``: a ``runtime.mesh.build_process_mesh`` mesh with ``data`` and
    ``model`` axes (either may be absent or 1), or None for one process
    with no group. ``device``: where a mesh-less trainer places its state,
    the card unless the caller asks for the CPU; with a mesh, the mesh's
    device type (the rank's current CUDA device)."""

    def __init__(self, cfg: CLIPConfig, train_cfg: TrainConfig = TrainConfig(), mesh=None, device: str = "cuda"):
        if train_cfg.total_steps <= train_cfg.warmup_steps:
            # optax's cosine_decay_schedule refuses decay_steps <= 0
            raise ValueError(f"total_steps {train_cfg.total_steps} must exceed warmup_steps {train_cfg.warmup_steps}")
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.mesh = mesh
        sizes = axis_sizes(mesh)
        unknown = {a: s for a, s in sizes.items() if a not in (DATA_AXIS, MODEL_AXIS) and s > 1}
        if unknown:
            raise ValueError(f"ClipTrainer shards over data and model only; mesh has {unknown}")
        self.data_size = sizes.get(DATA_AXIS, 1)
        self.model_size = sizes.get(MODEL_AXIS, 1)
        if mesh is not None:
            device = mesh.device_type
        self.device = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
        self.model = CLIPModel(cfg, attention=attention_reference, remat=train_cfg.remat).to(self.device)
        self.model.requires_grad_(False)  # the step differentiates its own leaves
        self.decay = decay_mask(self.model)
        self._paths = tree_paths(self.model)

    # -- groups -----------------------------------------------------------

    def _group(self, axis: str):
        return self.mesh.get_group(axis) if self.mesh is not None and axis in self.mesh.mesh_dim_names else None

    # -- state ------------------------------------------------------------

    def init_state(self, generator: torch.Generator):
        """Seeded parameters (the JAX initializers) placed by the
        tensor-parallel rules, and a zero optimizer state. Every rank must
        pass a generator seeded alike."""
        params = self.place({
            n: _init_param(n, self._paths[n], tuple(p.shape), generator)
            for n, p in self.model.named_parameters()
        })
        return params, self.init_opt_state(params)

    def place(self, params: dict) -> dict:
        """``{name: full tensor}`` -> the trainer's placement: DTensors on
        the mesh by ``TRANSFORMER_TP_RULES``, or plain tensors on the
        trainer's device without a mesh."""
        params = {n: t.to(self.device, torch.float32) for n, t in params.items()}
        if self.mesh is None:
            return params
        return shard_params(params, self.mesh, TRANSFORMER_TP_RULES)

    def place_opt_state(self, opt_state: dict) -> dict:
        """A full optimizer state (``state_from_optax``) placed as
        :meth:`place` places the parameters."""
        mu = self.place({n: s["exp_avg"] for n, s in opt_state.items()})
        nu = self.place({n: s["exp_avg_sq"] for n, s in opt_state.items()})
        return {
            n: {"step": s["step"].to("cpu", torch.float32), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
            for n, s in opt_state.items()
        }

    @staticmethod
    def init_opt_state(params: dict) -> dict:
        return {
            n: {"step": torch.zeros((), dtype=torch.float32),
                "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
            for n, p in params.items()
        }

    # -- step -------------------------------------------------------------

    def make_train_step(self):
        """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

        ``batch``: ``{"pixel_values": [B, H, W, 3] float32, "input_ids":
        [B, S] int64}``, this rank's ``B = B_global / data`` rows (data rank
        ``d`` holds rows ``d*B : (d+1)*B`` of the global batch). ``metrics``
        are ``{"loss", "grad_norm"}`` device scalars (the norm of the
        unclipped gradients); reading them is the caller's sync."""
        return self._step

    def _forward_params(self, leaves: dict, params: dict) -> dict:
        """The tensors the forward reads: the local leaves, wrapped back as
        DTensors on the ``model`` sub-mesh when that axis splits them."""
        if self.model_size == 1:
            return leaves
        from torch.distributed.tensor import DTensor

        sub = self.mesh[MODEL_AXIS]
        i = self.mesh.mesh_dim_names.index(MODEL_AXIS)
        return {
            n: DTensor.from_local(t, sub, [params[n].placements[i]], run_check=False) for n, t in leaves.items()
        }

    def _loss_and_grads(self, params: dict, batch: dict):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        leaves = {
            n: (p.to_local() if isinstance(p, DTensor) else p).detach().requires_grad_() for n, p in params.items()
        }
        pixel_values = batch["pixel_values"].to(self.device, torch.float32)
        input_ids = batch["input_ids"].to(self.device)
        ctx = implicit_replication() if self.model_size > 1 else contextlib.nullcontext()
        # The backward runs inside the swap too: a checkpointed block (remat)
        # recomputes its forward there and must read the same tensors.
        with ctx, _swapped(self.model, self._forward_params(leaves, params)):
            out = self.model(pixel_values, input_ids)
            img, txt = out["image_embeds"], out["text_embeds"]
            if isinstance(img, DTensor):
                img, txt = img.full_tensor(), txt.full_tensor()
            if self.data_size > 1:
                group = self._group(DATA_AXIS)
                img, txt = gather_rows(img, group), gather_rows(txt, group)
            loss = contrastive_loss(img, txt, leaves["logit_scale"])
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        if self.data_size > 1:
            _all_reduce_mean(list(grads.values()), self._group(DATA_AXIS), self.data_size)
        return loss.detach(), grads

    def _global_norm(self, params: dict, grads: dict) -> torch.Tensor:
        """The norm over whole parameters: a ``model``-sharded gradient's
        squares summed over the ``model`` group, a replicated one's once."""
        sharded, whole = [], []
        for n, g in grads.items():
            dims = _shard_dims(params[n])
            if set(dims) - {MODEL_AXIS}:
                raise ValueError(f"{n} is split over {dims}; the trainer shards over model only")
            (sharded if dims else whole).append(g)
        total = torch.zeros((), device=self.device)
        if sharded:
            part = torch.stack([g.pow(2).sum() for g in sharded]).sum()
            dist.all_reduce(part, group=self._group(MODEL_AXIS))
            total = total + part
        if whole:
            total = total + torch.stack([g.pow(2).sum() for g in whole]).sum()
        return total.sqrt()

    def _step(self, params: dict, opt_state: dict, batch: dict):
        from torch.distributed.tensor import DTensor

        cfg = self.train_cfg
        loss, grads = self._loss_and_grads(params, batch)
        norm = self._global_norm(params, grads)
        # optax clip_by_global_norm: g * max_norm / norm when norm >= max_norm
        factor = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm), cfg.max_grad_norm / norm)
        names = list(grads)
        g = torch._foreach_mul([grads[n] for n in names], factor)
        count = int(opt_state[names[0]]["step"])  # host scalars: no device read
        lr = learning_rate(cfg, count)
        f32 = np.float32
        bc1 = float(f32(1) - f32(cfg.b1) ** f32(count + 1))
        bc2 = float(f32(1) - f32(cfg.b2) ** f32(count + 1))

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t

        mu = [local(opt_state[n]["exp_avg"]) for n in names]
        nu = [local(opt_state[n]["exp_avg_sq"]) for n in names]
        p = [local(params[n]).detach() for n in names]
        # optax update_moment: (1 - b) * g + b * m
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - cfg.b1), torch._foreach_mul(mu, cfg.b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - cfg.b2),
                                torch._foreach_mul(nu, cfg.b2))
        upd = list(torch._foreach_div(
            torch._foreach_div(mu, bc1), torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), cfg.eps)
        ))
        for i, n in enumerate(names):
            if self.decay[n]:
                upd[i] = upd[i] + cfg.weight_decay * p[i]
        new_p = list(torch._foreach_add(p, torch._foreach_mul(upd, -lr)))
        i = names.index("logit_scale")
        new_p[i] = torch.clamp(new_p[i], max=LOGIT_SCALE_MAX)

        def wrap(n, t):
            src = params[n]
            if isinstance(src, DTensor):
                return DTensor.from_local(t, src.device_mesh, src.placements, run_check=False)
            return t

        step = torch.tensor(float(count + 1), dtype=torch.float32)
        new_params = {n: wrap(n, t) for n, t in zip(names, new_p)}
        new_opt = {
            n: {"step": step.clone(), "exp_avg": wrap(n, m), "exp_avg_sq": wrap(n, v)}
            for n, m, v in zip(names, mu, nu)
        }
        return new_params, new_opt, {"loss": loss, "grad_norm": norm}


def state_from_optax(params: Mapping, opt_state: Any) -> tuple[dict, dict]:
    """The JAX trainer's ``(params, opt_state)`` (leaves as numpy or
    anything ``np.asarray`` takes) -> the port's full (unplaced) state:
    parameters through ``clip_params_from_jax``, and optax's
    ``ScaleByAdamState`` ``count``, ``mu`` and ``nu`` as each parameter's
    ``step``, ``exp_avg`` and ``exp_avg_sq`` through the same key map
    (kernels transposed alike). Place both with ``ClipTrainer.place`` and
    ``place_opt_state``."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no ScaleByAdamState (count, mu, nu)")
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    mu, nu = clip_params_from_jax(adam.mu), clip_params_from_jax(adam.nu)
    state = {n: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]} for n in mu}
    return clip_params_from_jax(params), state


def _find_adam_state(node):
    if hasattr(node, "mu") and hasattr(node, "nu") and hasattr(node, "count"):
        return node
    if isinstance(node, (tuple, list)):  # optax states are (named) tuples
        for child in node:
            if (found := _find_adam_state(child)) is not None:
                return found
    return None


@contextlib.contextmanager
def _swapped(model: torch.nn.Module, tensors: dict):
    """Run ``model`` on ``tensors`` in place of its parameters (what
    ``torch.func.functional_call`` does for one call), restoring them on
    exit."""
    owners = dict(model.named_modules())
    saved = []
    try:
        for name, t in tensors.items():
            parent, _, leaf = name.rpartition(".")
            module = owners[parent]
            saved.append((module, leaf, module._parameters[leaf]))
            module._parameters[leaf] = t
        yield
    finally:
        for module, leaf, p in reversed(saved):
            module._parameters[leaf] = p


def _all_reduce_mean(tensors: list, group, n: int) -> None:
    """Average ``tensors`` in place over ``group`` with one flat all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()
