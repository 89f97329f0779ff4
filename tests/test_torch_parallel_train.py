"""The port's CLIP trainer on gloo ranks against the JAX trainer on the
same mesh shape of the 8-device CPU mesh: three steps' losses, gradient
norms and every parameter at ``{"data": 2}``, ``{"data": 1, "model": 2}``
and ``{"data": 2, "model": 2}``. A factor of ``data`` in the gradient
reduction, a norm counted once per rank, or a sharded rule off by a
transpose would each show here, and nowhere in one process.

Both sides start from the JAX trainer's state after three steps on that
mesh (converted by ``state_from_optax``); the ranks get it, and the
global batch, as numpy and keep ``B / data`` rows each. Tolerances are
``test_torch_training``'s, but the parameters' absolute one is 4e-6: the
model axis splits sums the JAX program keeps whole."""

from __future__ import annotations

import numpy as np
import pytest

from lumen_tpu_torch.training.clip_trainer import state_from_optax
from lumen_tpu_torch.models.clip.convert import clip_params_from_jax
from test_torch_training import K_BIAS_ATOL, LOSS_RTOL, NORM_RTOL, TRAIN_KW, jax_run, make_batch
from torch_spmd_ranks import run_ranks

PARAM_ATOL = 4e-6


@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 1, "model": 2}, {"data": 2, "model": 2}],
                         ids=["data2", "model2", "data2-model2"])
def test_trainer_steps_match_jax_on_the_mesh(axes, tmp_path):
    batch = make_batch(n=8, seed=1)
    want = jax_run(TRAIN_KW, axes, batch)
    params, opt = state_from_optax(*want["start"])
    inputs = {f"p/{n}": t.numpy() for n, t in params.items()}
    inputs.update({f"mu/{n}": s["exp_avg"].numpy() for n, s in opt.items()})
    inputs.update({f"nu/{n}": s["exp_avg_sq"].numpy() for n, s in opt.items()})
    inputs["count"] = np.asarray(3.0, np.float32)
    inputs.update(batch)
    inputs["meta"] = {
        "axes": axes, "train": TRAIN_KW,
        "clip": {"embed_dim": 16, "image_size": 32, "patch_size": 16, "vocab_size": 64, "context_length": 8,
                 "vision": [32, 1, 2], "text": [32, 1, 2]},
    }
    world = int(np.prod(list(axes.values())))
    outs = run_ranks("train", world, inputs, tmp_path)
    ref = clip_params_from_jax(want["params"])
    for rank, out in enumerate(outs):  # every rank reports the same run
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(out["grad_norm"], want["grad_norm"], rtol=NORM_RTOL, err_msg=f"rank {rank}")
        for name, a in ref.items():
            atol = K_BIAS_ATOL if name.endswith("k_proj.bias") else PARAM_ATOL
            np.testing.assert_allclose(out[f"p/{name}"], a.numpy(), atol=atol, err_msg=f"rank {rank} {name}")
