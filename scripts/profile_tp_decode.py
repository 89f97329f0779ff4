#!/usr/bin/env python3
"""Where a tensor-parallel decode's time goes, on one GPU: the same
full-width ``VLMConfig()`` (seeded bf16 weights) at TP = 1 and at TP = 2,
two ranks sharing the card over gloo (``runtime.tp_group``, as
``chip_smoke.py`` phase 17 runs them).

For each: one prefill chunk over a 265-token prompt (the vision tower's
prepare step included), then ``--blocks`` decode blocks of 8 steps over 8
rows, each timed with a device synchronization; at TP = 2 also
``torch.profiler``'s host-side table over two decode blocks on rank 0
(the collectives' own time: ``gloo`` all-reduces and broadcasts, with
their device-to-host copies).

Run from the repository root:

    python3 scripts/profile_tp_decode.py [--seed 0] [--blocks 4]

Prints one JSON line a configuration and the profiler's top rows.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def drive(mgr, blocks: int, rows: int = 8, page: int = 16, profile: bool = False) -> dict:
    """Prefill one prompt, admit it to ``rows`` slots, time decode blocks."""
    import numpy as np
    import torch

    from lumen_tpu_torch.models.vlm import ChatMessage

    gen, dev = mgr.generator, mgr.generator.device
    msgs = [ChatMessage("user", "describe this photo in one detailed sentence")]
    pixels = np.random.default_rng(0).integers(0, 256, (mgr.cfg.vision.image_size,) * 2 + (3,), dtype=np.uint8)
    pages = -(-gen.max_seq // page)
    pool = gen.init_pool(rows, pages=rows * pages + 1, page_size=page)
    tables = torch.arange(1, rows * pages + 1, dtype=torch.int32).reshape(rows, pages)
    rng = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds, positions, lengths, prompt_ids, _, _, n_live = mgr._prepare_inputs(msgs, pixels)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    params = (torch.zeros(1, device=dev), torch.ones(1, device=dev), torch.zeros(1, dtype=torch.bool, device=dev),
              torch.ones(1, device=dev))
    t0 = time.perf_counter()
    caches, tok0, seen = gen.prefill(embeds, positions, lengths, prompt_ids, rng, *params,
                                     kv_len=mgr.engine._admit_kv_len(int(embeds.shape[1])))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    for r in range(rows):
        gen.admit(pool, r, caches, tok0, seen, n_live, tables[r].numpy(), 10_000, 0.0, 1.0, False, 1.0)
    dev_tables = tables.to(dev)
    times = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        gen.step_block(pool, dev_tables, rng, 8).cpu()
        times.append(time.perf_counter() - t0)
    out = {"prepare_ms": prepare_s * 1e3, "prefill_ms": prefill_s * 1e3,
           "block_ms": [round(t * 1e3, 2) for t in times], "step_ms": sorted(times)[len(times) // 2] * 1e3 / 8}
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU]) as p:
            for _ in range(2):
                gen.step_block(pool, dev_tables, rng, 8).cpu()
        out["profile"] = p.key_averages().table(sort_by="self_cpu_time_total", row_limit=15)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--blocks", type=int, default=4)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from lumen_tpu_torch.models.vlm import VLMConfig, VLMManager, VLMModel, init_random_
    from lumen_tpu_torch.runtime.tp_group import TPGroup, rank_report
    from lumen_tpu_torch.testing.vlm_standins import write_model_dir

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    from lumen_tpu_torch.ops import attention, quant_matmul
    from lumen_tpu_torch.ops.cuda_build import build_all

    build_all(attention.KERNELS + quant_matmul.KERNELS)  # in parallel, before any rank launches
    cfg = VLMConfig()
    with tempfile.TemporaryDirectory(prefix="lumen-tp-profile-") as tmp:
        with torch.device("cuda"):
            model = VLMModel(cfg)
        init_random_(model, args.seed + 6)
        model_dir = write_model_dir(Path(tmp), "SmokeVLM", cfg, model.to(torch.bfloat16).state_dict())
        del model
        torch.cuda.empty_cache()
        one = VLMManager.from_model_dir(str(model_dir), device="cuda:0", dtype="bfloat16")
        print(json.dumps({"tp": 1, **drive(one, args.blocks), "card": card}), flush=True)
        one.close()
        del one
        torch.cuda.empty_cache()
        group = TPGroup.spawn(["cuda:0", "cuda:0"], "gloo")
        try:
            tp = VLMManager.from_model_dir(str(model_dir), device="cuda:0", dtype="bfloat16", mesh_axes={"model": 2})
            group.each_rank(rank_report, True)
            out = drive(tp, args.blocks, profile=True)
            table = out.pop("profile")
            launches = [r["launches"] for r in group.each_rank(rank_report)]
            print(json.dumps({"tp": 2, **out, "programs": group.programs, "launches": launches, "card": card}),
                  flush=True)
            print(table, flush=True)
            tp.close()
        finally:
            group.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
