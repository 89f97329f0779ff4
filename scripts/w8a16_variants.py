#!/usr/bin/env python3
"""Variants of the w8a16 split, measured on one NVIDIA GPU.

``csrc/w8a16_matmul.cu`` cuts K into parts (``kQmMaxParts``,
``kQmTargetBlocks``) walked through a ring of ``kQmStages`` 64-deep
chunks. This script builds ``w8a16_matmul`` for each variant -- a set of
those constants -- from a copy of ``csrc/`` with the constants rewritten
(the repository's own build stays untouched), checks each variant against
the plain version, and times it with ``chip_smoke.device_ms`` (device time
per call from ``torch.profiler``) at the four Qwen2-0.5B projection shapes
at 8 (decode) and 40 rows (a W = 5 verify window), weights cycled past the
L2 as a decode step finds them (``w8a16 <proj> <rows>``). The paged walk's
variants are ``scripts/paged_walk_variants.py``.

The variants are timed in turns (A, B, ..., B, A) within one process. A
variant is ``NAME=VALUE[,NAME=VALUE...]`` over those constants, or
``base`` for the committed ones; constants not named keep their committed
values. Run from the repository root:

    python3 scripts/w8a16_variants.py [--variants base kQmStages=6 kQmMaxParts=4 ...] [--seed 0]
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


def build_variants(variants: list[str]) -> tuple[dict, dict]:
    """({variant: bound C function}, {library: ptxas log}), built from
    rewritten copies of csrc/ under build/w8a16_variants/."""
    from lumen_tpu_torch.ops import quant_matmul as QM
    from lumen_tpu_torch.ops.cuda_build import CSRC, NVCC_FLAGS, _nvcc

    out = ROOT / "build" / "w8a16_variants"
    procs = []
    for i, w in enumerate(variants):
        src = out / f"variant{i}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC, src)
        path = src / "w8a16_matmul.cu"
        for setting in ([] if w == "base" else w.split(",")):
            name, value = setting.split("=")
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};",
                              path.read_text())
            if n != 1:
                raise RuntimeError(f"{name} not found in {path.name}")
            path.write_text(text)
        lib = src / f"{QM.W8A16.source}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(src), "-o", str(lib), str(src / f"{QM.W8A16.source}.cu")]
        procs.append((w, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns, logs = {}, {}
    for w, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {QM.W8A16.source} at {w}:\n{text}")
        logs[f"{w} {QM.W8A16.source}"] = text
        fn = getattr(ctypes.CDLL(str(lib)), QM.W8A16.symbol)
        fn.argtypes, fn.restype = QM.W8A16.argtypes, ctypes.c_int
        fns[w] = fn
    return fns, logs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", default=["base", "kQmStages=4"])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("w8a16_variants.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from lumen_tpu_torch.ops import quant_matmul as QM

    card = C.card_line()
    print(f"card: {card}", flush=True)
    fns, logs = build_variants(args.variants)
    for r in C.ptxas_report(logs):
        print(f"  ptxas {r['lib']}: {r['func']}: {r['registers']} registers, {r['smem']} B smem, "
              f"{r['spill_stores']} / {r['spill_loads']} B spill stores / loads", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    calls, floors = {}, {}
    for proj, (k, n) in C.Q8_SHAPES.items():
        copies = max(2, -(-64 * 2**20 // (k * n)))
        qs = [torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8) for _ in range(copies)]
        scales = [torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4 for _ in range(copies)]
        for rows in (8, 40):
            x = torch.randn((rows, k), generator=gen, device=dev).to(torch.bfloat16)
            name = f"w8a16 {proj} {rows}"
            calls[name] = ((lambda x=x, q=qs[0], s=scales[0]: QM.w8a16_reference(x.float(), q, s)),
                           list(zip([x] * copies, qs, scales)))
            floors[name] = (rows * k * 2 + k * n + n * 4 + rows * n * 2) / C.HBM_BYTES_PER_S * 1e3
    order = args.variants + args.variants[::-1]
    times: dict = {w: {s: [] for s in calls} for w in args.variants}
    try:
        for w in args.variants:
            QM.W8A16._fn = fns[w]
            for plain, cycle in calls.values():
                C.max_err(QM.w8a16_matmul(*cycle[0]), plain())
        for shape, (_, cycle) in calls.items():
            for w in order:
                QM.W8A16._fn = fns[w]
                times[w][shape].append(C.device_ms(QM.w8a16_matmul, 100, cycle, floor_ms=floors[shape], launches=1))
    finally:
        QM.W8A16._fn = None
    print(f"all variants agree with the plain version (tol {C.ATOL}+{C.RTOL}|ref|)", flush=True)
    for w in args.variants:
        print(f"{w}: " + "; ".join(
            f"{s} {sum(t) / len(t):.5f} ms ({' / '.join(f'{x:.5f}' for x in t)})" for s, t in times[w].items())
            + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
