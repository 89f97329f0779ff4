#!/usr/bin/env python3
"""Run one benchmark cell of the port once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root. Builds the cell's model from ``--seed`` on the
card, warms its shapes (set-up), drives its traffic through the program's
``VLMManager.generate_stream`` for ``--seconds``, checks the served tokens
against the plain float32 reference, and prints one JSON line last on
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics, read from the device trace of the window (``--trace
1``). Exits non-zero, printing no result, without the card or with JAX or
the JAX package loaded. See ``README.md``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: the program's kernel build cache: a fixed directory of the checkout
BUILD_DIR = ROOT / ".bench_build"
#: top-level module names that may not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "lumen_tpu")


def _clean_env() -> None:
    """The program's defaults: every ``LUMEN_*`` knob unset, the build cache
    inside the checkout, no JAX side of a library."""
    for key in [k for k in os.environ if k.startswith("LUMEN_")]:
        del os.environ[key]
    os.environ["LUMEN_COMPILE_CACHE_DIR"] = str(BUILD_DIR)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def host_probe_ms() -> float:
    """Milliseconds a fixed loop of Python takes on this host: the serving
    path is host-bound, so its rate follows the host's speed, which this
    reads apart from the program."""
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    return (time.perf_counter() - t) * 1e3


def rate_by_part(records: list, t0: float, t1: float, parts: int = 5) -> list:
    """Tokens a second streamed in each of ``parts`` equal parts of the
    window."""
    span = (t1 - t0) / parts
    counts = [0] * parts
    for r in records:
        for t, n in r.chunks:
            if t0 <= t <= t1:
                counts[min(int((t - t0) / span), parts - 1)] += n
    return [round(c / span, 3) for c in counts]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line(torch) -> str:
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "power limit not read"
    return f"{name}, {out}"


def run_once(bench, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda:0",
             t_start: float | None = None, control: bool = False) -> dict:
    """One run of a cell; returns the result line's object and, under
    ``_found``, the readings compared. ``control`` adds the float8
    reference's readings on the same requests (``_control``), which only
    ``control.py`` asks for."""
    import torch

    from harness import judge, serve, weights
    from harness.traffic import Traffic
    from reference import vlm as ref

    t_start = T_START if t_start is None else t_start
    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    rules = bench.cell(workload)
    traffic = Traffic(mix, seed)
    on_card = device.startswith("cuda")
    dtype = getattr(torch, cfg["dtype"])

    probe = host_probe_ms()
    t_in = time.perf_counter()
    state = weights.make(cfg, seed, device, dtype)
    if on_card:
        torch.cuda.synchronize()
    t_w = time.perf_counter()
    system = serve.System(cfg, state, device)
    t_m = time.perf_counter()
    tracer = None
    if trace:
        from harness.trace import Tracer

        tracer = Tracer()
        tracer.warm()
    warmed = system.warm(traffic)
    t_warm = time.perf_counter()
    if tracer is not None:
        tracer.start()
    system.start(traffic)
    steady = system.wait_steady()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: start to here {t_in - t_start:.3f}, weights {t_w - t_in:.3f}, manager "
        f"{t_m - t_w:.3f}, warm-up {t_warm - t_m:.3f} ({warmed} requests), load steady after {steady:.3f}; "
        f"host probe {probe:.3f} ms; {threading.active_count()} threads; window {seconds} s, "
        f"{'traced' if trace else 'untraced'}, seed {seed}")
    slots, block, buckets, chunk = system.slots, system.block, system.buckets, system.chunk
    win = system.run_window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    records = win["records"]
    failed = [r for r in records if r.error is not None]
    log(f"window tokens/s by fifth: {rate_by_part(records, win['t0'], win['t1'])}")
    if win["trace"] is not None:
        walks = win["trace"].time_of(lambda name: "paged_walk" in name)[0]
        launched = win["gauges1"]["paged_launches"] - win["gauges0"]["paged_launches"]
        log(f"trace: {len(win['trace'].ops)} device operations in {win['trace'].window_s:.3f} s; "
            f"{walks} paged walks of the {launched} the program launched in the window")
    for r in failed[:3]:
        log(f"request {r.index} failed: {r.error}")
    ctx = SimpleNamespace(
        workload=cell, config=cfg, shape=ref.shape_of(cfg), traffic=traffic, mix=mix,
        records=records, t0=win["t0"], t1=win["t1"], t_end=win["t_end"], window_s=win["t1"] - win["t0"],
        gauges0=win["gauges0"], gauges1=win["gauges1"], slots=slots, block=block, buckets=buckets,
        chunk=chunk, trace=win["trace"], setup_s=setup_s, state=state, device=device, seed=seed,
    )
    metrics = {}
    for m in bench.metrics_for(workload, trace):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_ref = time.perf_counter()
    sample_rule = rules["sample"]
    picked = judge.sample(records, seed, sample_rule["min_tokens"], sample_rule["max_requests"])
    found = judge.readings(cfg, state, traffic, picked, device, buckets) if picked else {}
    ok, checks = judge.verdict(found, rules["limits"])
    ok = ok and not failed
    log(f"reference over {found.get('requests', 0)} requests, {found.get('tokens', 0)} served tokens "
        f"in {time.perf_counter() - t_ref:.3f} s")

    result = {
        "correct": bool(ok),
        "attempted": len(records),
        "failed": len(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    dt = win["trace"]
    if dt is not None:
        result["device"]["busy_s"] = dt.busy_s()
        result["device"]["window_s"] = dt.window_s
        result["breakdown"] = {"device_ops": dt.top_ops(), "idle_gaps": dt.idle_gaps()}
    result["checks"] = checks
    result["_found"] = found
    if control and picked:
        result["_control"] = judge.control_readings(cfg, state, traffic, picked, device, buckets)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell of the port once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _clean_env()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    import torch

    from harness.cells import Bench

    bench = Bench()
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 3
    log(f"card: {card_line(torch)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_once(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; no result")
        return 4
    found = result.pop("_found")
    result.pop("_control", None)
    log(f"compared {found.get('tokens', 0)} served tokens of {found.get('requests', 0)} requests; readings "
        f"{json.dumps(found)}:")
    for name, c in result["checks"].items():
        log(f"  {name} {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
