#!/usr/bin/env python3
"""Readings for a cell's correctness limits, on the card, in one process.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds <s> [--out <file>]

Runs the cell at its own load and size once a seed with the program as
the configuration states it: the lower readings, judged as a run judges
them (``correct``). On the same requests it reads the control, the
reference with float8 operands put in the program's place
(``judge.control_readings``), and judges those readings by the same
limits (``control_correct``, which has to come out false). Prints each
seed's readings as a JSON line; ``--out`` appends them to a file too. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Readings for a cell's correctness limits.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    run._clean_env()
    sys.path.insert(0, str(run.HERE))
    sys.path.insert(1, str(run.ROOT))
    import torch

    from harness import judge
    from harness.cells import Bench

    if not torch.cuda.is_available():
        run.log("needs a CUDA device")
        return 3
    run.log(f"card: {run.card_line(torch)}")
    bench = Bench()
    limits = bench.cell(args.workload)["limits"]
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        r = run.run_once(bench, args.workload, seed, args.seconds, False, t_start=t, control=True)
        control = r.get("_control") or {}
        control_ok, _ = judge.verdict(control, limits)
        line = {"workload": args.workload, "seed": seed, "program": r["_found"], "correct": r["correct"],
                "control_fp8": control, "control_correct": control_ok, "failed": r["failed"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
