"""Phase 15 of ``chip_smoke.py`` (the Qwen2-MoE VLM) runs to its end on
the CPU at a small configuration: a 2-layer MoE decoder (4 experts,
top-2, a shared expert) behind a one-layer ViT that keeps its 256 tokens,
in bf16, with the launch-count gates emptied (the plain paths launch no
kernel): (a) the paged engine in bf16, then int8 with speculation K = 4,
then the cacheless forward against the plain attention; (b) a model
directory under the HF Qwen2-MoE names served over gRPC, request 0 equal
to a direct manager; (c) the MoE layer against its per-expert loop."""

from __future__ import annotations

import dataclasses

import chip_smoke
from lumen_tpu_torch.models.vlm import VLMConfig
from lumen_tpu_torch.ops.quant import QDense
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture


def _small_moe(layers: int):
    base = VLMConfig()
    return dataclasses.replace(
        base,
        decoder=dataclasses.replace(
            base.decoder, hidden_size=128, layers=layers, heads=4, kv_heads=2, intermediate_size=256,
            vocab_size=4096, tie_word_embeddings=False, moe_experts=4, moe_top_k=2, moe_intermediate_size=64,
            moe_shared_intermediate=96, moe_norm_topk=False,
        ),
        vision=dataclasses.replace(base.vision, width=64, layers=1, heads=1),
        image_token_id=4000, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )


def test_chip_smoke_moe_drive_runs_on_cpu(tmp_path, monkeypatch):
    for name in ("PHASE15_KERNELS", "PHASE15_INT8_KERNELS", "PHASE15_GRPC_KERNELS"):
        monkeypatch.setattr(chip_smoke, name, ())
    monkeypatch.setattr(chip_smoke, "PHASE15_HD128", {"bf16": (), "int8": (), "forward": ()})
    out = chip_smoke.drive_moe(0, "cpu", tmp_path, cfg=_small_moe(2), dir_cfg=_small_moe(1), device="cpu")
    assert out["forward_cos"] > 0.9999  # plain attention on both sides
    assert not any(out["bf16"]["launches"].values()) and not any(out["grpc_launches"].values())
    assert out["bf16"]["tokens"] > 0 and out["int8"]["spec_turns"] > 0
    assert (tmp_path / "cache" / "models" / "SmokeMoE" / "model.safetensors").is_file()


def test_int8_count_covers_the_moe_layout():
    """A MoE decoder under int8 holds the QDense phase 15's int8 gate
    counts: four attention projections a layer, the shared expert's three,
    the untied lm_head."""
    cfg = _small_moe(2)
    from lumen_tpu_torch.models.vlm.modeling import VLMModel

    q = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, weight_quant="int8"))
    assert sum(isinstance(m, QDense) for m in VLMModel(q).decoder.modules()) == 2 * 7 + 1
