"""The port's ``TrainCheckpointer`` (``torch.distributed.checkpoint``) in
one process with no group, on the CPU: a trainer state's round trip is
byte-equal, with and without templates and with an async save; retention
keeps the steps the JAX (orbax) checkpointer keeps for the same saves,
``keep_period`` included; an empty directory raises; a resumed run equals
the uninterrupted one."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.training import TrainCheckpointer as JaxCheckpointer
from lumen_tpu_torch.models.clip.modeling import CLIPConfig, TowerConfig
from lumen_tpu_torch.training import ClipTrainer, TrainCheckpointer, TrainConfig

CFG = CLIPConfig(embed_dim=16, image_size=32, patch_size=16, vision=TowerConfig(32, 1, 2),
                 text=TowerConfig(32, 1, 2), vocab_size=64, context_length=8)


@pytest.fixture(scope="module")
def trained():
    trainer = ClipTrainer(CFG, TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=20), device="cpu")
    params, opt = trainer.init_state(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {"pixel_values": torch.tensor(rng.rand(4, 32, 32, 3).astype(np.float32)),
             "input_ids": torch.tensor(rng.randint(1, 64, (4, 8)))}
    step = trainer.make_train_step()
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    return trainer, params, opt, batch


def _assert_bytes_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_bytes_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_is_byte_equal(trained, tmp_path, async_save):
    _, params, opt, _ = trained
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), async_save=async_save)
    ckpt.save(2, params, opt)
    ckpt.wait()
    assert ckpt.all_steps() == [2] and ckpt.latest_step() == 2
    step, p2, o2 = ckpt.restore(params_like=params, opt_state_like=opt)
    assert step == 2
    _assert_bytes_equal(p2, params)
    _assert_bytes_equal(o2, opt)
    assert p2["logit_scale"] is not params["logit_scale"]  # the templates are not written to
    _, p3, o3 = ckpt.restore(2)  # no template: the saved shapes and dtypes
    _assert_bytes_equal(p3, params)
    _assert_bytes_equal(o3, opt)
    ckpt.close()


def test_resume_continues_the_run(trained, tmp_path):
    trainer, params, opt, batch = trained
    step = trainer.make_train_step()
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), async_save=False)
    ckpt.save(2, params, opt)
    straight = []
    p, o = params, opt
    for _ in range(2):
        p, o, m = step(p, o, batch)
        straight.append(float(m["loss"]))
    _, p, o = ckpt.restore(params_like=params, opt_state_like=opt)
    resumed = []
    for _ in range(2):
        p, o, m = step(p, o, batch)
        resumed.append(float(m["loss"]))
    assert resumed == straight  # the CPU run is deterministic
    ckpt.close()


@pytest.mark.parametrize("max_to_keep, keep_period", [(2, None), (2, 3), (1, 2)])
def test_retention_keeps_what_orbax_keeps(tmp_path, max_to_keep, keep_period):
    steps = [1, 2, 3, 4, 5, 6, 7]
    port = TrainCheckpointer(str(tmp_path / "port"), max_to_keep=max_to_keep, keep_period=keep_period,
                             async_save=False)
    ref = JaxCheckpointer(str(tmp_path / "jax"), max_to_keep=max_to_keep, keep_period=keep_period,
                          async_save=False)
    for s in steps:
        port.save(s, {"w": torch.full((2,), float(s))}, {"n": torch.zeros(())})
        ref.save(s, {"w": jnp.full((2,), float(s))}, {"n": jnp.zeros(())}, wait=True)
    assert port.all_steps() == ref.all_steps()
    assert float(port.restore()[1]["w"][0]) == steps[-1]
    port.close()
    ref.close()


def test_restore_from_an_empty_directory_raises(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "none"), async_save=False)
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    ckpt.close()
