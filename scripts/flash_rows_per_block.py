#!/usr/bin/env python3
"""Rows per block (and ring depth) of the bf16 flash tile, measured on one
NVIDIA GPU.

``csrc/flash_tile_bf16.cuh`` gives each warp 16 query rows, a block
``kFlashWarps`` warps, and its K/V ring ``kFlashStages`` slots. This
script builds both flash libraries for each variant -- a set of those
constants -- from a copy of ``csrc/`` with the constants rewritten (the
repository's own build stays untouched), checks each variant against the
plain version, and times it with ``chip_smoke.device_ms`` (device time per
call from ``torch.profiler``) at the serving path's three shapes:

- the vision tower's ``[1, 12, 256, 64]``, bidirectional (120 launches in
  a ``chip_smoke.py`` phase 4 drive);
- prompt chunk 1: ``q [1, 14, 256, 64]``, q_off 0, 256 live keys of the
  832-slot scratch (240 launches);
- prompt chunk 2: ``q [1, 14, 63, 64]``, q_off 256, 265 live keys (240).

The variants are timed in turns (A, B, ..., B, A) within one process, and
the winner is the one with the least device time per drive (launches x
ms). By default the three block sizes at the committed key split and ring
depth: 16, 32 and 64 query rows (1, 2 or 4 row groups); constants not
named keep their committed values.

Run from the repository root:

    python3 scripts/flash_rows_per_block.py [--variants kFlashWarps=1 kFlashWarps=4,kFlashSplit=1 ...] [--seed 0]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: launches per chip_smoke.py phase-4 drive: vision tower, chunk 1, chunk 2.
LAUNCHES = {"vision": 120, "chunk 1": 240, "chunk 2": 240}


def build_variants(variants: list[str]) -> tuple[dict, dict]:
    """({variant: {kernel name: bound C function}}, {library: ptxas log}),
    built from rewritten copies of csrc/ under build/flash_rows_per_block/.
    A variant is ``NAME=VALUE[,NAME=VALUE...]`` over the tile's constants."""
    from lumen_tpu_torch.ops import attention as A
    from lumen_tpu_torch.ops.cuda_build import CSRC, NVCC_FLAGS, _nvcc

    out = ROOT / "build" / "flash_rows_per_block"
    procs = []
    for i, w in enumerate(variants):
        src = out / f"variant{i}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC, src)
        tile = src / "flash_tile_bf16.cuh"
        text = tile.read_text()
        for setting in w.split(","):
            name, value = setting.split("=")
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", text)
            if n != 1:
                raise RuntimeError(f"{name} not found in flash_tile_bf16.cuh")
        tile.write_text(text)
        for k in (A.FLASH, A.FLASH_CACHE):
            lib = src / f"{k.source}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(src), "-o", str(lib), str(src / f"{k.source}.cu")]
            procs.append((w, k, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns: dict = {w: {} for w in variants}
    logs = {}
    for w, k, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {k.source} at {w}:\n{text}")
        logs[f"{w} {k.source}"] = text
        fn = getattr(ctypes.CDLL(str(lib)), k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        fns[w][k.name] = fn
    return fns, logs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", default=["kFlashWarps=1", "kFlashWarps=2", "kFlashWarps=4"])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_rows_per_block.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from lumen_tpu_torch.ops import attention as A

    card = C.card_line()
    print(f"card: {card}", flush=True)
    fns, logs = build_variants(args.variants)
    for r in C.ptxas_report(logs):
        if "bf16" in r["func"]:
            print(f"  ptxas {r['lib']}: {r['func']}: {r['registers']} registers, {r['smem']} B smem, "
                  f"{r['spill_stores']} / {r['spill_loads']} B spill stores / loads", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def ints(x):
        return torch.tensor([x], device=dev, dtype=torch.int32)

    qv, kv_, vv = rnd(1, 12, 256, 64), rnd(1, 12, 256, 64), rnd(1, 12, 256, 64)
    k832, v832 = rnd(1, 14, 832, 64), rnd(1, 14, 832, 64)
    q1, q2 = rnd(1, 14, 256, 64), rnd(1, 14, 63, 64)
    off1, live1, off2, live2 = ints(0), ints(256), ints(256), ints(265)
    # shape: (kernel call, plain version, bound in bytes: each operand once)
    calls = {
        "vision": (lambda: A.flash_attention(qv, kv_, vv),
                   lambda: A.attention_reference(qv.float(), kv_.float(), vv.float()),
                   4 * qv.numel() * 2),
        "chunk 1": (lambda: A.flash_attention_cache(q1, k832, v832, off1, live1),
                    lambda: A._decode_masked(q1.float(), k832.float(), v832.float(), off1, live1),
                    (2 * q1.numel() + 2 * 14 * 256 * 64) * 2),
        "chunk 2": (lambda: A.flash_attention_cache(q2, k832, v832, off2, live2),
                    lambda: A._decode_masked(q2.float(), k832.float(), v832.float(), off2, live2),
                    (2 * q2.numel() + 2 * 14 * 265 * 64) * 2),
    }
    order = args.variants + args.variants[::-1]
    times: dict = {w: {s: [] for s in calls} for w in args.variants}
    try:
        for w in args.variants:
            A.FLASH._fn, A.FLASH_CACHE._fn = fns[w]["flash_attention"], fns[w]["flash_attention_cache"]
            for kernel, plain, _ in calls.values():
                C.max_err(kernel(), plain())
        for shape, (kernel, _, nbytes) in calls.items():
            for w in order:
                A.FLASH._fn, A.FLASH_CACHE._fn = fns[w]["flash_attention"], fns[w]["flash_attention_cache"]
                floor_ms = nbytes / C.HBM_BYTES_PER_S * 1e3
                times[w][shape].append(C.device_ms(kernel, 50, floor_ms=floor_ms, launches=1))
    finally:
        A.FLASH._fn = A.FLASH_CACHE._fn = None
    print(f"all variants agree with the plain version (tol {C.ATOL}+{C.RTOL}|ref|)", flush=True)
    per_drive = {}
    for w in args.variants:
        mean = {s: sum(t) / len(t) for s, t in times[w].items()}
        per_drive[w] = sum(LAUNCHES[s] * mean[s] for s in calls)
        print(f"{w}: "
              + "; ".join(f"{s} {mean[s]:.5f} ms ({' / '.join(f'{t:.5f}' for t in times[w][s])})" for s in calls)
              + f"; device time per drive {per_drive[w]:.3f} ms [{card}]", flush=True)
    best = min(per_drive, key=per_drive.get)
    print(f"winner: {best}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
