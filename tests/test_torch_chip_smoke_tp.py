"""Phase 17 of ``chip_smoke.py`` (serving over a ``model`` axis) runs to
its end on the CPU at a small configuration: the tiny VLM and a narrow
CLIP written as model directories, ``serve()`` over ``mesh: {model: 2}``
with two gloo ranks on the CPU (this process and the worker it starts),
every part (a)-(f) against TP = 1 managers, the launch gates emptied (the
plain paths launch nothing)."""

from __future__ import annotations

import dataclasses
import math

import torch

import chip_smoke
from lumen_tpu_torch.models.clip import CLIPConfig, CLIPModel
from lumen_tpu_torch.models.vlm import VLMConfig, VLMModel, init_random_
from lumen_tpu_torch.ops import quant_matmul
from lumen_tpu_torch.runtime import tp_group
from lumen_tpu_torch.testing.vlm_standins import write_model_dir


def test_chip_smoke_tp_drive_runs_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("LUMEN_DECODE_PROCS", "0")
    # the int8 routing rule is sticky for the process, and an earlier test
    # file on this worker may have served a model axis: start from none
    monkeypatch.setattr(quant_matmul, "_MESH_MODEL_AXIS", 1)
    cfg = VLMConfig.tiny()
    model = init_random_(VLMModel(cfg), 6)
    vlm_dir = write_model_dir(tmp_path / "cache", "SmokeVLM", cfg, model.state_dict())
    ccfg = dataclasses.replace(CLIPConfig.tiny(), vocab_size=2048, eot_token_id=2047)
    clip = init_random_(CLIPModel(ccfg), 8)
    with torch.no_grad():
        clip.logit_scale.fill_(math.log(1 / 0.07))
    clip_dir = chip_smoke.write_clip_model_dir(tmp_path / "cache", "SmokeCLIP", ccfg, clip.state_dict(), 100)
    photos = [chip_smoke.photo_jpeg(i, 320, 240) for i in range(8)]
    out = chip_smoke.drive_tp(0, "cpu", tmp_path, vlm_dir, clip_dir, photos, device="cpu", devices=["cpu", "cpu"],
                              kernels=(), int8_kernels=())
    assert tp_group.current() is None  # the group is stopped
    assert out["b_cos"] >= chip_smoke.TP_LOGIT_COSINE and out["b_rel"] <= chip_smoke.TP_LOGIT_REL
    assert out["b_prefix"] == out["b_lengths"] and out["c_prefix"] == out["c_lengths"]
    assert min(out["d_bf16_cos"] + out["d_w8a8_cos"]) >= chip_smoke.TP_CLIP_COSINE
    assert out["f_code"] and out["f_health"] == "UNAVAILABLE"
