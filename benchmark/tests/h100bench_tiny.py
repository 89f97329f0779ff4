"""A tiny copy of the benchmark's cells for CPU tests: the same files'
layout (configuration, mix, cell rules, the real metric readers) at sizes
the CPU runs in seconds, in float32."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def tiny_config(moe: bool) -> dict:
    text = {
        "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "vocab_size": 4096, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 4096, "tie_word_embeddings": not moe, "bos_token_id": 1, "eos_token_id": 2,
        "pad_token_id": 0,
    }
    if moe:
        text.update({"num_experts": 4, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
                     "shared_expert_intermediate_size": 64, "norm_topk_prob": False, "decoder_sparse_step": 1})
    vision = {"hidden_size": 48, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 192,
              "image_size": 32, "patch_size": 16, "image_mean": [0.0, 0.0, 0.0], "image_std": [1.0, 1.0, 1.0],
              "layer_norm_eps": 1e-6}
    return {"name": "tiny-moe" if moe else "tiny-dense", "dtype": "float32", "image_token_index": 4000,
            "text_config": text, "vision_config": vision}


def make_bench(tmp: Path, moe: bool = False, limits=None):
    """A checkout-like folder holding one tiny cell ``tiny-cell``; returns
    its ``Bench``."""
    import sys

    sys.path.insert(0, str(BENCH))
    from harness.cells import Bench

    folder = tmp / "benchmark"
    for sub in ("configs", "traffic", "cells"):
        (folder / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", folder / "metrics", dirs_exist_ok=True)
    cfg = tiny_config(moe)
    (folder / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = {"loop": "closed", "clients": 4, "prompt_words": [4, 12], "max_tokens": [8, 24], "mix": 8,
           "repetition_penalty": 1.3}
    (folder / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    rules = {"sample": {"min_tokens": 40, "max_requests": 4},
             "limits": limits or {"gap_max": 1e-3, "gap_mean": 1e-4}}
    (folder / "cells" / "tiny-cell.json").write_text(json.dumps(rules))
    spec = {
        "configs": [{"name": "tiny", "file": "benchmark/configs/tiny.json"}],
        "workloads": [{"name": "tiny-cell", "config": "tiny", "traffic": "tiny-mix", "chips": 1}],
        "end_to_end": [
            {"name": "tok_s", "unit": "tokens/s"},
            {"name": "setup_s", "unit": "s"},
        ],
        "per_layer": [
            {"name": "decode_rows_mean", "unit": "rows"},
            {"name": "step_ms.decode", "unit": "ms"},
            {"name": "step_mfu", "unit": "%"},
        ],
    }
    return Bench(root=tmp, folder=folder, spec=spec)
