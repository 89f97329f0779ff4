"""The port's CLIP trainer (``lumen_tpu_torch.training``) against the JAX
trainer, in one process on the CPU at a tiny config (as
``tests/test_training.py``): the loss, the decay set, the learning rate,
three steps from the same state at ``max_grad_norm`` binding and not,
``remat`` against plain, the converted optax state, the towers' attention
and the flash wrapper's refusal of autograd.

Both trainers start from the JAX state after three steps (the optax
``count`` is 3, so the steps compared move every parameter: at ``count =
0`` the schedule's rate is 0). Tolerances, float32: losses within 1e-6
relative, gradient norms within 1e-5 relative, parameters within 2e-6
absolute (parameters reach ~3; float32's epsilon there is 2.4e-7, and
three Adam steps of reordered sums stay within a few of them)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lumen_tpu.models.clip.modeling import CLIPConfig as JaxCLIPConfig, TowerConfig as JaxTower
from lumen_tpu.runtime.mesh import build_mesh
from lumen_tpu.training import ClipTrainer as JaxTrainer, TrainConfig as JaxTrainConfig
from lumen_tpu.training import contrastive_loss as jax_contrastive_loss
from lumen_tpu.training.clip_trainer import _decay_mask as jax_decay_mask
from lumen_tpu.parallel.sharding import keypath_str
from lumen_tpu_torch.models.clip.convert import clip_params_from_jax
from lumen_tpu_torch.models.clip.modeling import CLIPConfig, CLIPModel, TowerConfig
from lumen_tpu_torch.models.vlm.convert import state_from_tree, tree_paths
from lumen_tpu_torch.ops import attention as port_attention
from lumen_tpu_torch.training import ClipTrainer, TrainConfig, contrastive_loss
from lumen_tpu_torch.training.clip_trainer import decay_mask, learning_rate, state_from_optax

CLIP_KW = dict(embed_dim=16, image_size=32, patch_size=16, vocab_size=64, context_length=8)
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-6, 1e-5, 2e-6
#: A key projection's bias has an exact gradient of 0 (it adds one logit to
#: every key of a query, which the softmax cancels): what reaches it is
#: rounding (~1e-8), which Adam divides by its eps (1e-6), so each package
#: moves it by its own noise, a few hundredths of the rate a step. Held to
#: a tenth of the rate a step over three steps.
K_BIAS_ATOL = 3 * 0.1 * TRAIN_KW["learning_rate"]


def jax_cfg():
    return JaxCLIPConfig(vision=JaxTower(32, 1, 2), text=JaxTower(32, 1, 2), **CLIP_KW)


def port_cfg():
    return CLIPConfig(vision=TowerConfig(32, 1, 2), text=TowerConfig(32, 1, 2), **CLIP_KW)


def make_batch(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"pixel_values": rng.rand(n, 32, 32, 3).astype(np.float32),
            "input_ids": rng.randint(1, 64, (n, 8)).astype(np.int32)}


def port_batch(batch):
    return {"pixel_values": torch.tensor(batch["pixel_values"]),
            "input_ids": torch.tensor(batch["input_ids"].astype(np.int64))}


def jax_run(train_kw: dict, mesh_axes: dict, batch: dict, warm: int = 3, steps: int = 3) -> dict:
    """The JAX trainer on ``mesh_axes``: its state after ``warm`` steps (as
    numpy), then ``steps`` more steps' losses, norms and final params."""
    trainer = JaxTrainer(jax_cfg(), JaxTrainConfig(**train_kw), build_mesh(mesh_axes))
    params, opt = trainer.init_state(jax.random.PRNGKey(0))
    step = trainer.make_train_step()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(warm):
        params, opt, _ = step(params, opt, jb)
    start = (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt))
    losses, norms = [], []
    for _ in range(steps):
        params, opt, m = step(params, opt, jb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"start": start, "loss": losses, "grad_norm": norms, "params": jax.tree.map(np.asarray, params)}


def port_run(trainer: ClipTrainer, start, batch: dict, steps: int = 3) -> dict:
    params, opt = state_from_optax(*start)
    params, opt = trainer.place(params), trainer.place_opt_state(opt)
    step = trainer.make_train_step()
    losses, norms = [], []
    for _ in range(steps):
        params, opt, m = step(params, opt, port_batch(batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms, "params": params, "opt": opt}


def assert_same_run(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_RTOL)
    ref = clip_params_from_jax(want["params"])
    assert set(got["params"]) == set(ref)
    for name, t in got["params"].items():
        atol = K_BIAS_ATOL if name.endswith("k_proj.bias") else PARAM_ATOL
        np.testing.assert_allclose(t.detach().numpy(), ref[name].numpy(), atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def batch():
    return make_batch()


@pytest.fixture(scope="module")
def jax_runs(batch):
    """The JAX trainer's runs by ``max_grad_norm``, each compiled once for
    the tests that read it."""
    runs: dict = {}

    def get(max_grad_norm: float = 1.0) -> dict:
        if max_grad_norm not in runs:
            runs[max_grad_norm] = jax_run({**TRAIN_KW, "max_grad_norm": max_grad_norm}, {"data": 1}, batch)
        return runs[max_grad_norm]

    return get


@pytest.mark.parametrize("max_grad_norm", [1.0, 1e4], ids=["clip-binds", "clip-idle"])
def test_three_steps_match_jax(max_grad_norm, batch, jax_runs):
    kw = {**TRAIN_KW, "max_grad_norm": max_grad_norm}
    want = jax_runs(max_grad_norm)
    assert (min(want["grad_norm"]) > max_grad_norm) == (max_grad_norm == 1.0)  # binds, or not
    got = port_run(ClipTrainer(port_cfg(), TrainConfig(**kw), device="cpu"), want["start"], batch)
    assert_same_run(got, want)
    assert all(float(s["step"]) == 6 for s in got["opt"].values())


def test_remat_matches_plain(batch, jax_runs):
    """``remat`` checkpoints each block: the same loss, norm and update."""
    want = jax_runs()
    runs = [port_run(ClipTrainer(port_cfg(), TrainConfig(**TRAIN_KW, remat=r), device="cpu"), want["start"], batch,
                     steps=2) for r in (False, True)]
    np.testing.assert_allclose(runs[1]["loss"], runs[0]["loss"], rtol=1e-6)
    np.testing.assert_allclose(runs[1]["grad_norm"], runs[0]["grad_norm"], rtol=1e-6)
    for name, t in runs[0]["params"].items():
        np.testing.assert_allclose(runs[1]["params"][name].numpy(), t.numpy(), atol=1e-7, err_msg=name)


def test_contrastive_loss_matches_jax():
    rng = np.random.RandomState(5)
    img, txt = rng.randn(6, 16).astype(np.float32), rng.randn(6, 16).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    for scale in (np.log(1 / 0.07), 7.0):  # under and over the ln(100) clamp
        want = float(jax_contrastive_loss(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale, jnp.float32)))
        got = float(contrastive_loss(torch.tensor(img), torch.tensor(txt), torch.tensor(scale, dtype=torch.float32)))
        assert got == pytest.approx(want, rel=1e-6)


def test_decay_set_equals_jax(jax_runs):
    params = jax_runs()["start"][0]
    mask = jax_decay_mask(params)
    want = {keypath_str(k) for k, v in jax.tree_util.tree_flatten_with_path(mask)[0] if v}
    trainer = ClipTrainer(port_cfg(), TrainConfig(), device="cpu")
    paths = tree_paths(trainer.model)
    got = {paths[n] for n, decays in decay_mask(trainer.model).items() if decays}
    assert got == want
    assert "vision/patch_embed/kernel" in got and "text/token_embedding/embedding" not in got


def test_learning_rate_matches_the_optax_schedule():
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=3, total_steps=8)
    schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 8)
    for count in range(12):
        assert learning_rate(cfg, count) == pytest.approx(float(schedule(count)), rel=1e-6, abs=0)
    assert learning_rate(cfg, 0) == 0.0  # the first step moves nothing


def test_optax_state_converts_per_parameter(jax_runs):
    want = jax_runs()
    params, opt = state_from_optax(*want["start"])
    adam = want["start"][1][1][0]  # chain(clip, adamw(scale_by_adam, ...))
    mu = clip_params_from_jax(adam.mu)
    assert set(opt) == set(params) == set(mu)
    for name, s in opt.items():
        assert float(s["step"]) == 3.0
        assert s["exp_avg"].shape == params[name].shape
        torch.testing.assert_close(s["exp_avg"], mu[name], rtol=0, atol=0)


def test_trainer_towers_run_the_plain_attention():
    """The trainer builds its towers on ``attention_reference`` (the JAX
    trainer's XLA attention: seq 50/77 is under ``_flash_usable``'s 256);
    a default ``CLIPModel`` keeps the kernel dispatch."""
    trainer = ClipTrainer(port_cfg(), TrainConfig(), device="cpu")
    blocks = [*trainer.model.vision.blocks, *trainer.model.text.blocks]
    assert all(b.attn.attention is port_attention.attention_reference for b in blocks)
    served = CLIPModel(port_cfg())  # None: the module's ``attention`` dispatch, looked up at each call
    assert all(b.attn.attention is None for b in [*served.vision.blocks, *served.text.blocks])


def test_default_towers_look_the_dispatch_up_at_each_call(monkeypatch):
    """A default ``CLIPModel`` calls the modeling module's ``attention`` at
    call time, so a caller that swaps it (``chip_smoke.plain_attention``,
    the ONNX export) reaches every block; the trainer's explicit choice
    does not move."""
    from lumen_tpu_torch.models.clip import modeling

    calls = []

    def spy(q, k, v, mask=None, causal=False, scale=None):
        calls.append(causal)
        return port_attention.attention_reference(q, k, v, mask=mask, causal=causal, scale=scale)

    monkeypatch.setattr(modeling, "attention", spy)
    batch = port_batch(make_batch(n=2))
    with torch.no_grad():
        CLIPModel(port_cfg())(batch["pixel_values"], batch["input_ids"])
        assert calls == [False, True]  # one vision block, one causal text block
        ClipTrainer(port_cfg(), TrainConfig(), device="cpu").model(batch["pixel_values"], batch["input_ids"])
    assert calls == [False, True]


def test_flash_wrapper_refuses_operands_that_require_grad():
    """The kernel has no backward: with grad mode on, a device operand that
    requires grad raises before any launch (a meta tensor stands in for
    the card here); without grad the wrapper goes on to its operand
    checks."""
    q = torch.empty(1, 2, 8, 64, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        port_attention.flash_attention(q, q, q)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        port_attention.flash_attention(q, q, q)
    with torch.inference_mode(), pytest.raises(ValueError, match="CUDA"):
        port_attention.flash_attention(q.detach(), q.detach(), q.detach())


def test_tree_paths_invert_state_from_tree(jax_runs):
    """Each Flax leaf, tagged with its index, lands under the port name
    whose ``tree_paths`` entry is its path."""
    params = jax_runs()["start"][0]
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), [np.full(v.shape, i, np.float32) for i, (_, v) in enumerate(flat)]
    )
    names = state_from_tree(jax.tree.map(torch.tensor, tagged))
    paths = tree_paths(CLIPModel(port_cfg()))
    assert set(names) == set(paths)
    for name, t in names.items():
        assert keypath_str(flat[int(t.flatten()[0])][0]) == paths[name]
