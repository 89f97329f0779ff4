#!/usr/bin/env python3
"""Where the time goes in lumen_tpu_torch's serving path, on one GPU.

Serves the same full-width workload as ``chip_smoke.py`` phase 4
(``VLMConfig()``, seeded random bf16 weights, 8 slots, pages of 16, a
1025-page pool, prefill chunk 256; concurrent 1024x1024 caption requests
with 32-68 new tokens each, greedy) three times after a warm-up:

1. plain: wall time, aggregate decode tok/s and per-stream TTFT;
2. timed: the engine's programs (vision prepare, prefill chunks, chunk
   finish, admission, decode blocks) wrapped with synchronized host
   timers -- the per-layer split of the wall time;
3. traced: ``torch.profiler`` over the whole drive -- device time by
   kernel and the device's busy share of the wall time.

Run from the repository root:

    python3 scripts/profile_torch_serving.py [--seed 0] [--requests 8] [--out DIR]

Prints a summary; the profiler's full table goes to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--out", default="build/profile")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, VLMModel, init_random_
    from lumen_tpu_torch.ops.attention import KERNELS
    from lumen_tpu_torch.ops.cuda_build import build_all

    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    card = chip_smoke.card_line()
    build_all(KERNELS)
    cfg = VLMConfig()
    with torch.device("cuda:0"):
        model = VLMModel(cfg)
    init_random_(model, args.seed)
    mgr = VLMManager(
        cfg, model.to(torch.bfloat16).state_dict(),
        chip_smoke.WordTokenizer(cfg.decoder.vocab_size, {}), device="cuda:0",
        max_seq=2048, gen_slots=8, gen_block=8, page_size=16, pool_pages=1025, prefill_chunk=256,
    )
    rng = np.random.default_rng(args.seed)
    size = cfg.vision.image_size
    reqs = [
        ([ChatMessage("user", f"Describe image {i} in one detailed sentence.")],
         rng.integers(0, 256, (size, size, 3), np.uint8), 32 + 4 * (i % 9))
        for i in range(args.requests)
    ]

    def drive() -> dict:
        """All requests at once, as streams; returns wall, tokens, TTFTs."""
        metas: list[dict] = []
        lock = threading.Lock()

        def run(m, p, n):
            meta = list(mgr.generate_stream(m, p, max_new_tokens=n))[-1].metadata
            with lock:
                metas.append(meta)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=r) for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(m["generated_tokens"] for m in metas)
        ttft = sorted(m["ttft_ms"] for m in metas)
        return dict(wall_s=wall, tokens=tokens, tok_s=tokens / wall, ttft_ms=ttft)

    try:
        m, p, _ = reqs[0]
        mgr.generate(m, p, max_new_tokens=4)  # warm-up
        plain = drive()
        print(f"plain: {json.dumps(plain)} [{card}]", flush=True)

        # -- timed: synchronized host timers around the engine's programs.
        acc: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
        gen = mgr.generator

        def timed(name, fn):
            def wrapper(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    acc[name][0] += time.perf_counter() - t
                    acc[name][1] += 1
            return wrapper

        originals = {}
        for owner, name in ((mgr, "_prepare"), (gen, "prefill"), (gen, "prefill_chunk"),
                            (gen, "chunk_finish"), (gen, "admit"), (gen, "step_block")):
            originals[(owner, name)] = getattr(owner, name)
            setattr(owner, name, timed(name, originals[(owner, name)]))
        timed_run = drive()
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)
        split = {
            name: dict(s=round(t, 4), calls=n, share=round(t / timed_run["wall_s"], 4))
            for name, (t, n) in sorted(acc.items(), key=lambda kv: -kv[1][0])
        }
        steps = acc["step_block"][1] * mgr.engine.block
        print(f"timed: wall {timed_run['wall_s']:.3f} s; {json.dumps(split)}", flush=True)
        if steps:
            print(f"timed: decode {acc['step_block'][0] / steps * 1e3:.3f} ms per step of 8 slots "
                  f"[{card}]", flush=True)

        # -- traced: torch.profiler over one drive.
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = drive()
        events = prof.key_averages()

        def dev_self(e):
            return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

        busy_us = sum(dev_self(e) for e in events)
        busy = busy_us / 1e6 / traced["wall_s"]
        print(f"traced: wall {traced['wall_s']:.3f} s, device busy {busy_us / 1e6:.3f} s = "
              f"{100 * busy:.1f}% (idle {100 * (1 - busy):.1f}%) [{card}]", flush=True)
        top = sorted(events, key=dev_self, reverse=True)[:15]
        for e in top:
            print(f"  {dev_self(e) / 1e3:10.3f} ms  {e.count:7d}x  {e.key[:90]}")
        try:
            table = events.table(sort_by="self_device_time_total", row_limit=60)
        except (KeyError, AttributeError, ValueError):
            table = events.table(sort_by="self_cuda_time_total", row_limit=60)
        (out_dir / "key_averages.txt").write_text(table)
    finally:
        mgr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
