"""Phase 18 of ``chip_smoke.py`` (the Qwen2-MoE decoder over an ``expert``
axis and a ``model`` axis) runs to its end on the CPU at a small
configuration: a tiny MoE VLM (4 experts, top-2, a shared expert) written
as a model directory, ``serve()`` over ``mesh: {expert: 2}`` in bf16 and
in int8 with speculation (two gloo ranks on the CPU: this process and the
worker it starts), then over ``{expert: 2, model: 2}`` (four ranks), each
against the mesh-less managers, the launch gates emptied (the plain paths
launch nothing)."""

from __future__ import annotations

import dataclasses

import chip_smoke
from lumen_tpu_torch.models.vlm import VLMConfig
from lumen_tpu_torch.ops import quant_matmul
from lumen_tpu_torch.runtime import tp_group


def test_chip_smoke_ep_drive_runs_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("LUMEN_DECODE_PROCS", "0")
    # the int8 routing rule is sticky for the process: start from no model axis
    monkeypatch.setattr(quant_matmul, "_MESH_MODEL_AXIS", 1)
    cfg = VLMConfig.tiny()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, moe_experts=4, moe_top_k=2, moe_intermediate_size=48, moe_shared_intermediate=40,
        moe_norm_topk=False))
    out = chip_smoke.drive_ep(0, "cpu", tmp_path, dir_cfg=cfg, device="cpu", n_photos=2, n_both=2, max_new=4,
                              spec_new=8, kernels=(), int8_kernels=())
    assert tp_group.current() is None  # both groups are stopped
    a, b, c = out["a"], out["b"], out["c"]
    assert a["experts_a_rank"] == 2
    for part in (a, c):
        assert part["cos"] >= chip_smoke.TP_LOGIT_COSINE and part["rel"] <= chip_smoke.TP_LOGIT_REL
        assert len(part["peak_gib"]) == len(part["launches"])
    assert len(a["launches"]) == 2 and len(c["launches"]) == 4 and len(b["launches"]) == 2
    assert b["lengths"] and len(b["prefix"]) == 2
    assert (tmp_path / "cache" / "models" / "SmokeMoE" / "model.safetensors").is_file()
