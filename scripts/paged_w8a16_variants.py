#!/usr/bin/env python3
"""Variants of the split paged walk and of the w8a16 split, measured on one
NVIDIA GPU.

``csrc/paged_walk.cuh`` cuts a row into spans of ``kPagedSpan`` key
positions, a block each; ``csrc/w8a16_matmul.cu`` cuts K into parts
(``kQmMaxParts``, ``kQmTargetBlocks``) walked through a ring of
``kQmStages`` 64-deep chunks. This script builds ``paged_attention`` and
``w8a16_matmul`` for each variant -- a set of those constants -- from a
copy of ``csrc/`` with the constants rewritten (the repository's own build
stays untouched), checks each variant against the plain versions, and
times it with ``chip_smoke.device_ms`` (device time per call from
``torch.profiler``) at the serving path's shapes:

- ``paged 2``: ``chip_smoke.py`` phase 2's decode call (q [8,14,64], lens
  1..500, maxp 32);
- ``paged 4``: a phase-4 decode step (8 rows of 266-333 live tokens);
- ``w8a16 <proj> <rows>``: the four Qwen2-0.5B projection shapes at 8
  (decode) and 40 rows (a W = 5 verify window), weights cycled past the
  L2 as a decode step finds them.

The variants are timed in turns (A, B, ..., B, A) within one process. A
variant is ``NAME=VALUE[,NAME=VALUE...]`` over those constants, or
``base`` for the committed ones; constants not named keep their committed
values. Run from the repository root:

    python3 scripts/paged_w8a16_variants.py [--variants base kPagedSpan=32 kQmStages=6 ...] [--seed 0]
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
#: the file each constant lives in
FILES = {"kPaged": "paged_walk.cuh", "kQm": "w8a16_matmul.cu"}


def build_variants(variants: list[str]) -> tuple[dict, dict, dict]:
    """({variant: {kernel name: bound C function}}, {variant: span},
    {library: ptxas log}), built from rewritten copies of csrc/ under
    build/paged_w8a16_variants/."""
    from lumen_tpu_torch.ops import attention as A
    from lumen_tpu_torch.ops import quant_matmul as QM
    from lumen_tpu_torch.ops.cuda_build import CSRC, NVCC_FLAGS, _nvcc

    out = ROOT / "build" / "paged_w8a16_variants"
    procs, spans = [], {}
    for i, w in enumerate(variants):
        src = out / f"variant{i}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC, src)
        for setting in ([] if w == "base" else w.split(",")):
            name, value = setting.split("=")
            path = src / next(f for prefix, f in FILES.items() if name.startswith(prefix))
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};",
                              path.read_text())
            if n != 1:
                raise RuntimeError(f"{name} not found in {path.name}")
            path.write_text(text)
        spans[w] = int(re.search(r"constexpr int kPagedSpan = (\d+);", (src / "paged_walk.cuh").read_text())[1])
        for k in (A.PAGED, QM.W8A16):
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
    return fns, spans, logs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", default=["base", "kPagedSpan=32", "kPagedSpan=128"])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("paged_w8a16_variants.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from lumen_tpu_torch.ops import attention as A
    from lumen_tpu_torch.ops import quant_matmul as QM

    card = C.card_line()
    print(f"card: {card}", flush=True)
    fns, spans, logs = build_variants(args.variants)
    for r in C.ptxas_report(logs):
        print(f"  ptxas {r['lib']}: {r['func']}: {r['registers']} registers, {r['smem']} B smem, "
              f"{r['spill_stores']} / {r['spill_loads']} B spill stores / loads", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    pages = 1025
    kp, vp = rnd(pages, 2, 16, 64), rnd(pages, 2, 16, 64)
    calls, floors = {}, {}
    for name, lens in (("paged 2", [1, 16, 17, 300, 333, 129, 64, 500]),
                       ("paged 4", [266, 281, 297, 305, 312, 320, 327, 333])):
        bt = (torch.randperm(pages - 1, generator=gen, device=dev)[: 8 * 32].reshape(8, 32) + 1).to(torch.int32)
        kl = torch.tensor(lens, device=dev, dtype=torch.int32)
        q = rnd(8, 14, 64)
        calls[name] = ((lambda q=q, bt=bt, kl=kl: A.paged_attention_kernel(q, kp, vp, bt, kl)),
                       (lambda q=q, bt=bt, kl=kl: A.paged_attention_reference(q.float(), kp.float(), vp.float(), bt, kl)),
                       None)
        floors[name] = (2 * q.numel() * 2 + 2 * sum(lens) * 2 * 64 * 2) / C.HBM_BYTES_PER_S * 1e3
    for proj, (k, n) in C.Q8_SHAPES.items():
        copies = max(2, -(-64 * 2**20 // (k * n)))
        qs = [torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8) for _ in range(copies)]
        scales = [torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4 for _ in range(copies)]
        for rows in (8, 40):
            x = rnd(rows, k)
            name = f"w8a16 {proj} {rows}"
            calls[name] = ((lambda x=x, q=qs[0], s=scales[0]: QM.w8a16_matmul(x, q, s)),
                           (lambda x=x, q=qs[0], s=scales[0]: QM.w8a16_reference(x.float(), q, s)),
                           list(zip([x] * copies, qs, scales)))
            floors[name] = (rows * k * 2 + k * n + n * 4 + rows * n * 2) / C.HBM_BYTES_PER_S * 1e3

    def use(w):
        A.PAGED._fn, QM.W8A16._fn = fns[w]["paged_attention"], fns[w]["w8a16_matmul"]
        A.paged_walk_constants = lambda: {"span": spans[w], "group_max": 8}

    constants = A.paged_walk_constants
    order = args.variants + args.variants[::-1]
    times: dict = {w: {s: [] for s in calls} for w in args.variants}
    try:
        for w in args.variants:
            use(w)
            for kernel, plain, _ in calls.values():
                C.max_err(kernel(), plain())
        for shape, (kernel, _, cycle) in calls.items():
            for w in order:
                use(w)
                fn = QM.w8a16_matmul if cycle else kernel
                times[w][shape].append(C.device_ms(fn, 100, cycle, floor_ms=floors[shape], launches=1))
    finally:
        A.PAGED._fn = QM.W8A16._fn = None
        A.paged_walk_constants = constants
    print(f"all variants agree with the plain versions (tol {C.ATOL}+{C.RTOL}|ref|)", flush=True)
    for w in args.variants:
        print(f"{w}: " + "; ".join(
            f"{s} {sum(t) / len(t):.5f} ms ({' / '.join(f'{x:.5f}' for x in t)})" for s, t in times[w].items())
            + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
