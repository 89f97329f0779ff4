"""Phase 16 of ``chip_smoke.py`` (CLIP training on the SPMD layer) runs to
its end on the CPU at a small configuration: a gloo group of world size
1, a two-layer CLIP at narrow widths, 16 steps on 8 pairs, the card-vs-CPU
parity on both sides of the CPU, and the SPMD functions at a small shape."""

from __future__ import annotations

import chip_smoke
from lumen_tpu_torch.models.clip.modeling import CLIPConfig, TowerConfig
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture


def test_chip_smoke_train_drive_runs_on_cpu(tmp_path):
    cfg = CLIPConfig(embed_dim=16, image_size=32, patch_size=16, vision=TowerConfig(32, 2, 2),
                     text=TowerConfig(32, 2, 2), vocab_size=64, context_length=8)
    out = chip_smoke.drive_train(0, "cpu", tmp_path, cfg=cfg, device="cpu", steps=16, batch_size=8,
                                 parity_batch=4, spmd_shape=(1, 4, 16, 8))
    assert out["losses"][-1] < out["losses"][0] and out["flash_launches"] == 0
    assert out["kept"] == [16] and out["resume_err"] <= chip_smoke.TRAIN_RESUME_RTOL
    assert set(out["spmd"]) == {"ring", "ulysses", "ring causal", "ulysses causal", "pipeline",
                                "moe expert-parallel"}
