#!/usr/bin/env python3
"""On-card smoke test of lumen_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of all five CUDA kernels (one ``nvcc`` per source, all
   started together), with each kernel function's registers, shared
   memory and spills from ptxas (the bf16 flash tile must not spill) and
   its count of tensor-core instructions (HMMA) from ``cuobjdump -sass``
   (the bf16 flash kernels must have some).
2. kernels vs plain: each kernel against its plain PyTorch version on the
   same seeded inputs, at the serving path's shapes plus ragged cases
   (for the flash kernels: lengths and ``kv_valid`` on either side of the
   64-key tile, causal diagonals crossing a tile, two-row batches, and the
   fp32 instance), with times for the kernel, the plain version, the
   card's bound and one PyTorch library call computing the same function
   (a yardstick only; the port never calls it). Times are device time per
   call from ``torch.profiler``, checked against lost events
   (``device_ms``); one w8a16 call is also timed with the host's launch
   path (CUDA events). The paged kernels are also checked at the edges of
   their 64-key span and on a 2048-token row, in both dtypes. Bitwise,
   the greedy identity of speculation leans on: the verify-window kernel
   at W = 1 equals the single-token kernel, a paged row's output does not
   depend on its table's width (32 vs 128 pages), and w8a16 rows do not
   depend on the row count (8 of 40, 1 of 64). The kernel lines print
   the span and its blocks and workspace, and each w8a16 shape's K split,
   blocks and ring.
3. reference: a small fp32 VLM served on the card (kernels) and on the
   CPU (plain versions) gives the same greedy tokens, and so does the
   card with speculative decoding (``LUMEN_VLM_SPEC_K=4``).
4. serving path at full width: ``VLMConfig()`` (Qwen2-0.5B decoder +
   1024/64 ViT, seeded random weights, bf16) behind ``VLMManager`` on the
   paged continuous engine; concurrent caption requests, streaming and
   late-arriving ones included. Launch counts are zeroed just before and
   read just after: every kernel of the path must have run. Greedy
   determinism is checked by repeating a request.
5. the int8 speculative path at full width: phase 4 with
   ``quantize="int8"`` and ``LUMEN_VLM_SPEC_K=4`` on templated prompts;
   the w8a16 and verify-window kernels must run, verify turns must be
   taken, every decoder projection must hold int8 weights.
6. the main path as users reach it, at full width: a ``VLMConfig()``
   model directory (seeded bf16 weights under the HF/FastVLM names,
   ``config.json``, a WordLevel ``tokenizer.json`` of all 151936 ids, a
   chat template, ``model_info.json``) written to a temporary directory,
   served by the port's ``serve()`` (``lumen_tpu_torch/serving/server.py``)
   from a deployment YAML that names the service in its JAX form. Over
   real gRPC: 10 ``vlm_generate_stream`` requests, 8 in flight at once,
   each with its own 1600x1200 JPEG (decoded and letterboxed by the
   server), then ``vlm_generate``, ``GetCapabilities``, ``Health`` and a
   malformed image (``INVALID_ARGUMENT``). Request 0 must equal a
   ``VLMManager`` built directly from the same weights on the same canvas;
   the bf16 path's three kernels must have run. Then a second server with
   ``quantize: int8`` and ``LUMEN_VLM_SPEC_K=4`` answers 4 templated
   requests, which must launch the w8a16 and verify-window kernels.

Every run drives all six phases. The kernel table's launch counts are
phase 6's (the bf16 server for the bf16 path's kernels, the int8 server
for the other two). The last two lines are the kernel table (JSON) and
the device line the harness reads; the card's name and power limit
precede them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet, dense): memory rate and bf16 / fp32
#: tensor-core rates, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}

#: kernel vs plain: |kernel - plain| <= ATOL + RTOL * |plain| elementwise,
#: with the plain version run in fp32 on the same (bf16) inputs. The
#: kernel accumulates in fp32 and rounds its output to bf16 once
#: (half an ulp: 2^-9 relative); the rest is summation order.
ATOL, RTOL = 1e-2, 1e-2

SOURCES = {
    "flash_attention": ("lumen_tpu_torch/csrc/flash_attention.cu", "lumen_tpu/ops/attention.py:173"),
    "flash_attention_cache": ("lumen_tpu_torch/csrc/flash_attention_cache.cu", "lumen_tpu/ops/attention.py:315"),
    "paged_attention": ("lumen_tpu_torch/csrc/paged_attention.cu", "lumen_tpu/ops/attention.py:676"),
    "paged_attention_varq": ("lumen_tpu_torch/csrc/paged_attention_varq.cu", "lumen_tpu/ops/attention.py:849"),
    "w8a16_matmul": ("lumen_tpu_torch/csrc/w8a16_matmul.cu", "lumen_tpu/ops/quant_matmul.py:76"),
}

#: the kernels each serving phase must launch: phase 4 the bf16 path
#: (single-token paged decode), phase 5 the int8 speculative path.
PHASE4_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention")
PHASE5_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention_varq", "w8a16_matmul")
#: phase 6 holds its bf16 server to PHASE4_KERNELS and its int8 + speculation
#: server to these
PHASE6_INT8_KERNELS = ("paged_attention_varq", "w8a16_matmul")

#: (K, N) of the decoder's projections (Qwen2-0.5B), the w8a16 shapes.
Q8_SHAPES = {
    "q_proj/o_proj": (896, 896),
    "k_proj/v_proj": (896, 128),
    "gate_proj/up_proj": (896, 4864),
    "down_proj": (4864, 896),
}


def all_kernels() -> tuple:
    from lumen_tpu_torch.ops import attention, quant_matmul

    return attention.KERNELS + quant_matmul.KERNELS


@contextlib.contextmanager
def env(**values: str):
    """Set environment knobs for the engines built inside; restore after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(
    fn, iters: int, args: list | None = None, *, floor_ms: float, launches: int | None = None,
    strict: bool = True, warmup: int = 3,
) -> float | None:
    """Device time of one call: the summed duration of the kernels (and
    copies) ``iters`` calls put on the card, from ``torch.profiler``, over
    ``iters``. Unlike ``cuda_ms`` it leaves out the host's launch path,
    which is longer than a small kernel. ``args``: argument tuples cycled
    call by call -- copies of the weights larger than the 50 MB L2 in all,
    so every launch reads its weights from device memory, as a decode
    step's layers do.

    The profiler can lose events: on the H100 machine (torch 2.11) a
    session came back with none at all, and one that loses some reads too
    low. A session counts only if every kernel in it ran a multiple of
    ``iters`` times (a call launches the same kernels each time), exactly
    ``launches`` kernels per call when given, and the time per call is not
    below ``floor_ms``, the call's bound. Otherwise it is profiled again, up
    to three times; then the run fails, or, with ``strict=False``, the
    reading is None: not valid, and never printed as a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = args or [()]
    for i in range(warmup):
        fn(*args[i % len(args)])
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*args[i % len(args)])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = {e.key: e.count for e in events}
        ms = sum(e.self_device_time_total for e in events) / iters / 1e3
        if not events:
            fault = "no device events"
        elif any(c % iters for c in counts.values()):
            fault = f"kernel counts {sorted(counts.values())} not multiples of {iters} calls"
        elif launches is not None and sum(counts.values()) != launches * iters:
            fault = f"{sum(counts.values())} kernels for {iters} calls of {launches}"
        elif ms < floor_ms:
            fault = f"{ms:.5f} ms a call, below the {floor_ms:.5f} ms bound"
        else:
            return ms
        log(f"torch.profiler session {attempt + 1} of 3 not valid: {fault}")
    if strict:
        raise AssertionError(f"torch.profiler gave no valid session in three: {fault}")
    return None


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref) -> float:
    """Max |out - ref|; fails when any element is outside the tolerance
    or not finite."""
    import torch

    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    if not bool(torch.isfinite(out).all()) or bool((diff > ATOL + RTOL * ref.abs()).any()):
        raise AssertionError(f"kernel disagrees with its plain version: max |diff| {diff.max().item():.3e}")
    return float(diff.max())


# -- phase 2: kernels vs plain ------------------------------------------------


def flash_tile_shape() -> dict:
    """Block shape of the bf16 flash tile, from the constants of
    ``csrc/flash_tile_bf16.cuh``: query rows (16 per row group), threads
    (a warp per row group and key part) and dynamic shared memory (the
    K/V ring and the Q/O rows, rows of 64 + 8 bf16)."""
    text = (ROOT / "lumen_tpu_torch" / "csrc" / "flash_tile_bf16.cuh").read_text()
    c = {n: int(re.search(rf"constexpr int {n} = (\d+);", text)[1])
         for n in ("kFlashWarps", "kFlashSplit", "kFlashStages")}
    rows = 16 * c["kFlashWarps"]
    return dict(rows=rows, threads=32 * c["kFlashWarps"] * c["kFlashSplit"],
                smem=(2 * c["kFlashStages"] * 64 + rows) * (64 + 8) * 2)


def check_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from lumen_tpu_torch.ops import attention as A

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf16 = torch.bfloat16
    tile = flash_tile_shape()

    def rnd(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def f32(*ts):
        return [t.float() for t in ts]

    rows = {}

    # flash_attention: the vision tower's [1, 12, 256, 64] bidirectional
    # call, a non-causal length off the 64-key tile, causal cases with
    # lengths off the tiles, and the fp32 instance (FMA tile) on one.
    errs = []
    for b, h, sq, sk, causal, dt in (
        (1, 12, 256, 256, False, bf16), (1, 12, 100, 100, False, bf16), (2, 14, 77, 77, True, bf16),
        (1, 14, 50, 130, True, bf16), (1, 14, 50, 130, True, torch.float32),
    ):
        q, k, v = rnd(b, h, sq, 64, dtype=dt), rnd(b, h, sk, 64, dtype=dt), rnd(b, h, sk, 64, dtype=dt)
        out = A.flash_attention(q, k, v, causal=causal)
        ref = A.attention_reference(*f32(q, k, v), causal=causal)
        errs.append(max_err(out, ref))
    q, k, v = rnd(1, 12, 256, 64), rnd(1, 12, 256, 64), rnd(1, 12, 256, 64)
    nb = 4 * q.numel() * 2
    fl = 4 * 12 * 256 * 256 * 64
    bms, by = bound(nb, fl, "bfloat16")
    rows["flash_attention"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: A.flash_attention(q, k, v), 50, floor_ms=bms, launches=1),
        plain_ms=device_ms(lambda: A.attention_reference(q, k, v), 20, floor_ms=bms),
        bound_ms=bms, bound_by=by,
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50, floor_ms=bms),
        blocks=-(-256 // tile["rows"]) * 12,
    )

    # flash_attention_cache against the 832-slot scratch: the chunk lane's
    # two chunks of a caption prompt (265 live tokens, bucket span 319), a
    # ragged two-row batch, kv_valid on either side of the 64-key tile, a
    # causal diagonal crossing a tile mid-warp, two rows with different
    # offsets, and the fp32 instance (FMA tile) on chunk 2.
    errs = []
    cases = (
        (1, 256, [0], [256], bf16),
        (1, 63, [256], [265], bf16),
        (2, 256, [0, 256], [256, 300], bf16),
        (1, 48, [15], [63], bf16),
        (1, 48, [16], [64], bf16),
        (1, 48, [17], [65], bf16),
        (1, 48, [79], [127], bf16),
        (1, 64, [100], [164], bf16),
        (2, 63, [256, 37], [265, 100], bf16),
        (1, 63, [256], [265], torch.float32),
    )
    for b, sq, offs, valid, dt in cases:
        q, k, v = rnd(b, 14, sq, 64, dtype=dt), rnd(b, 14, 832, 64, dtype=dt), rnd(b, 14, 832, 64, dtype=dt)
        qo = torch.tensor(offs, device=dev, dtype=torch.int32)
        kv = torch.tensor(valid, device=dev, dtype=torch.int32)
        out = A.flash_attention_cache(q, k, v, qo, kv)
        ref = A._decode_masked(*f32(q, k, v), qo, kv)
        errs.append(max_err(out, ref))

    def chunk(q, k, v, off: int, live: int) -> dict:
        """A prompt chunk ``q`` at offset ``off`` against the scratch
        ``k``/``v`` with ``live`` slots: kernel, plain, bound, and SDPA
        with the bool mask of the same function."""
        sq = q.shape[2]
        qo = torch.tensor([off], device=dev, dtype=torch.int32)
        kv = torch.tensor([live], device=dev, dtype=torch.int32)
        pairs = sum(min(live, off + i + 1) for i in range(sq))  # visible (query, key) pairs
        nb = 2 * q.numel() * 2 + 2 * 14 * live * 64 * 2  # q, out, live K/V slots
        bms, by = bound(nb, 4 * 14 * 64 * pairs, "bfloat16")
        slots = torch.arange(832, device=dev)
        rows_abs = off + torch.arange(sq, device=dev)
        mask = ((slots[None, :] < live) & (slots[None, :] <= rows_abs[:, None]))[None, None]
        return dict(
            ms=device_ms(lambda: A.flash_attention_cache(q, k, v, qo, kv), 50, floor_ms=bms, launches=1),
            plain_ms=device_ms(lambda: A._decode_masked(q, k, v, qo, kv), 20, floor_ms=bms),
            bound_ms=bms, bound_by=by,
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 50, floor_ms=bms),
            blocks=-(-sq // tile["rows"]) * 14,
        )

    k, v = rnd(1, 14, 832, 64), rnd(1, 14, 832, 64)
    c2 = chunk(rnd(1, 14, 63, 64), k, v, 256, 265)
    log(f"kernel flash_attention_cache chunk 2 (q [1,14,63,64], q_off 256, kv_valid 265): "
        f"kernel {c2['ms']:.4f} ms on the device ({c2['blocks']} blocks), plain {c2['plain_ms']:.4f} ms, "
        f"bound {c2['bound_ms']:.5f} ms ({c2['bound_by']}), library (SDPA, bool mask) {c2['library_ms']:.4f} ms")
    q = rnd(1, 14, 256, 64)
    c1 = chunk(q, k, v, 0, 256)
    # A stricter yardstick, printed only: SDPA is_causal on the 256 live
    # keys alone (it never sees the dead slots; the masked call above is
    # the one that computes the kernel's function).
    k256, v256 = k[:, :, :256].contiguous(), v[:, :, :256].contiguous()
    causal_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k256, v256, is_causal=True), 50,
                          floor_ms=c1["bound_ms"])
    log(f"kernel flash_attention_cache chunk 1: yardstick SDPA is_causal on the 256 live keys "
        f"{causal_ms:.4f} ms (printed only; the table's library call is SDPA with the bool mask)")
    rows["flash_attention_cache"] = dict(c1, max_abs_err=max(errs))

    # paged_attention: 8 decode rows over a 1025-page pool, ragged
    # lengths (one token, exactly one page, partial last pages, a long
    # row), tables padded with the dump page and stale page ids.
    pages = 1025
    span = A.paged_walk_constants()["span"]
    kp, vp = rnd(pages, 2, 16, 64), rnd(pages, 2, 16, 64)
    lens = [1, 16, 17, 300, 333, 129, 64, 500]

    def table(row_lens: list[int], maxp: int):
        perm = torch.randperm(pages - 1, generator=gen, device=dev)[: len(row_lens) * maxp]
        bt = (perm.reshape(len(row_lens), maxp) + 1).to(torch.int32)
        for r, n in enumerate(row_lens):
            if r % 2:
                bt[r, -(-n // 16):] = 0  # dump page
        return bt

    bt = table(lens, 32)
    kl = torch.tensor(lens, device=dev, dtype=torch.int32)
    q = rnd(8, 14, 64)
    out = A.paged_attention_kernel(q, kp, vp, bt, kl)
    errs = [max_err(out, A.paged_attention_reference(*f32(q, kp, vp), bt, kl))]
    # The span's edges and a 2048-token row (maxp 128), in both dtypes.
    edge = [span - 1, span, span + 1, 2048]
    bt_edge = table(edge, 128)
    kl_edge = torch.tensor(edge, device=dev, dtype=torch.int32)
    for dt in (bf16, torch.float32):
        qe = rnd(4, 14, 64, dtype=dt)
        kpe, vpe = kp.to(dt), vp.to(dt)
        out_e = A.paged_attention_kernel(qe, kpe, vpe, bt_edge, kl_edge)
        errs.append(max_err(out_e, A.paged_attention_reference(*f32(qe, kpe, vpe), bt_edge, kl_edge)))
    # Bitwise: a row's output does not depend on the table's width (a
    # decode step's page bucket vs a verify turn's).
    bt_wide = torch.zeros((8, 128), device=dev, dtype=torch.int32)
    bt_wide[:, :32] = bt
    if not torch.equal(A.paged_attention_kernel(q, kp, vp, bt_wide, kl), out):
        raise AssertionError("paged_attention: a row's output changed with the table padded from 32 to 128 pages")
    torch.cuda.synchronize()
    grid = A.paged_grid(8 * 2, 32, 16)
    working = 2 * sum(-(-n // span) for n in lens)
    ws_bytes = A.paged_workspace_bytes(8 * 2, 32, 16, 64)
    log(f"kernel paged_attention: lengths {span - 1}/{span}/{span + 1}/2048 (maxp 128) in bf16 and fp32 within "
        f"tolerance; rows bitwise equal with tables of 32 and 128 pages; span {span} key positions, "
        f"{working} working blocks of a {grid[0]}x{grid[1]} grid (128 threads), workspace {ws_bytes} B "
        f"at q [8,14,64], maxp 32")
    total = sum(lens)
    nb = 2 * q.numel() * 2 + bt.numel() * 4 + kl.numel() * 4 + 2 * total * 2 * 64 * 2
    bms, by = bound(nb, 4 * 14 * 64 * total, "bfloat16")
    rows["paged_attention"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: A.paged_attention_kernel(q, kp, vp, bt, kl), 100, floor_ms=bms, launches=1),
        plain_ms=device_ms(lambda: A.paged_attention_reference(q, kp, vp, bt, kl), 20, floor_ms=bms),
        bound_ms=bms, bound_by=by, library_ms=None,
    )
    for name, row in rows.items():
        blocks = (f" ({row['blocks']} blocks of {tile['rows']} query rows, {tile['threads']} threads, "
                  f"{tile['smem']} B dynamic shared memory)") if "blocks" in row else ""
        log(
            f"kernel {name}: max|diff| {row['max_abs_err']:.3e} (tol {ATOL}+{RTOL}|ref|), "
            f"kernel {row['ms']:.4f} ms on the device{blocks}, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), library "
            + ("n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms")
        )
    return rows


def kernel_name(mangled: str) -> str:
    """The unqualified name in an Itanium-mangled symbol:
    ``_ZN5lumen27flash_attention_bf16_kernelILi64EE...`` ->
    ``flash_attention_bf16_kernel``."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[i:])) is not None:
        n = int(m[0])
        name = mangled[i + len(m[0]):i + len(m[0]) + n]
        i += len(m[0]) + n
    return name


def ptxas_report(logs: dict) -> list[dict]:
    """Registers, shared memory and spills of every kernel function, from
    the ``-Xptxas -v`` logs of the build (one entry per library)."""
    report = []
    for lib, text in logs.items():
        func, spill = None, (0, 0)
        for line in text.splitlines():
            if "Compiling entry function" in line:
                func = kernel_name(line.split("'")[1])
            elif "spill stores" in line:
                n = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
                spill = (int(n[0]), int(n[1]))
            elif "Used" in line and "registers" in line and func:
                smem = re.search(r"(\d+) bytes smem", line)
                report.append(dict(lib=lib, func=func, registers=int(re.search(r"Used (\d+) registers", line)[1]),
                                   smem=int(smem[1]) if smem else 0, spill_stores=spill[0], spill_loads=spill[1]))
                func, spill = None, (0, 0)
    return report


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy in Triton's package."""
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(path):
        import triton

        path = str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    return path


def hmma_counts(kernels) -> dict:
    """HMMA (tensor-core matrix multiply) instructions per kernel function
    in each library's SASS, from ``cuobjdump -sass``."""
    tool = cuobjdump()
    counts = {}
    for k in kernels:
        sass = subprocess.run([tool, "-sass", str(k.library_path())], capture_output=True, text=True,
                              timeout=120, check=True).stdout
        func = None
        for line in sass.splitlines():
            if "Function :" in line:
                func = kernel_name(line.split("Function :")[1].strip())
                counts[func] = 0
            elif func and "HMMA" in line:
                counts[func] += 1
    return counts


def check_varq(seed: int) -> dict:
    """paged_attention_varq: 8 rows over the 1025-page pool at W = 1, 5
    (the smoke drive's K = 4) and 16 (K = 15, the most the engine takes);
    ragged lengths, windows crossing page boundaries, tables padded with
    the dump page and stale ids. W = 1 must equal the single-token kernel
    bit for bit."""
    import torch

    from lumen_tpu_torch.ops import attention as A

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    bf16 = torch.bfloat16
    pages, page, maxp = 1025, 16, 34
    kp = torch.randn((pages, 2, page, 64), generator=gen, device=dev).to(bf16)
    vp = torch.randn((pages, 2, page, 64), generator=gen, device=dev).to(bf16)
    lens = [1, 16, 15, 300, 333, 129, 62, 500]  # 15 + W and 62 + W cross a page edge
    kl = torch.tensor(lens, device=dev, dtype=torch.int32)
    errs = []
    cases = {}
    for w in (1, 5, 16):
        perm = torch.randperm(pages - 1, generator=gen, device=dev)[: 8 * maxp].reshape(8, maxp) + 1
        bt = perm.to(torch.int32)
        for r, n in enumerate(lens):
            if r % 2:
                bt[r, -(-(n + w - 1) // page):] = 0  # dump page past the window's last page
        q = torch.randn((8, w, 14, 64), generator=gen, device=dev).to(bf16)
        out = A.paged_attention_varq_kernel(q, kp, vp, bt, kl)
        ref = A.paged_attention_varq_reference(q.float(), kp.float(), vp.float(), bt, kl)
        errs.append(max_err(out, ref))
        if w == 1:
            single = A.paged_attention_kernel(q[:, 0].contiguous(), kp, vp, bt, kl)
            if not torch.equal(out[:, 0], single):
                raise AssertionError("paged_attention_varq at W = 1 differs from paged_attention")
        cases[w] = (q, bt)
    torch.cuda.synchronize()
    log("kernel paged_attention_varq: W = 1 equals paged_attention bit for bit")
    w = 5
    q, bt = cases[w]
    live = sum(n + w - 1 for n in lens)  # K/V slots some window slot reads
    seen = sum(n + t for n in lens for t in range(w))  # (slot, key) pairs
    nb = 2 * q.numel() * 2 + bt.numel() * 4 + kl.numel() * 4 + 2 * live * 2 * 64 * 2
    bms, by = bound(nb, 4 * 14 * 64 * seen, "bfloat16")
    row = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: A.paged_attention_varq_kernel(q, kp, vp, bt, kl), 100, floor_ms=bms, launches=1),
        plain_ms=device_ms(lambda: A.paged_attention_varq_reference(q, kp, vp, bt, kl), 20, floor_ms=bms),
        bound_ms=bms, bound_by=by, library_ms=None, shape="8 rows, W=5, 14/2 heads",
    )
    span = A.paged_walk_constants()["span"]
    grid = A.paged_grid(8 * 2 * w, maxp, page)
    working = 2 * sum(-(-(n + t) // span) for n in lens for t in range(w))
    log(
        f"kernel paged_attention_varq (W=5): max|diff| {row['max_abs_err']:.3e} (tol {ATOL}+{RTOL}|ref|), "
        f"kernel {row['ms']:.4f} ms on the device ({working} working blocks of a {grid[0]}x{grid[1]} grid, "
        f"span {span}, workspace {A.paged_workspace_bytes(8 * 2 * w, maxp, page, 64)} B), "
        f"plain {row['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}: "
        f"{nb} B / 3.35 TB/s vs {4 * 14 * 64 * seen} flop / 989 TFLOP/s), library none"
    )
    return row


def check_w8a16(seed: int) -> dict:
    """w8a16_matmul at every projection shape of the int8 decoder: rows 1,
    3, 8 (decode), 40 (a W = 5 verify window over 8 slots) and 64 (the
    routing limit) against the plain version; the first 8 rows of a
    40-row call must equal an 8-row call bit for bit. Times at 8 and 40
    rows, with weights cycled past the L2 as a decode step finds them.
    Returns the gate_proj row at 8 rows (the largest weight) for the
    kernel table, the other shapes under ``shapes``."""
    import torch

    from lumen_tpu_torch.ops import quant_matmul as QM

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    bf16 = torch.bfloat16
    x40 = x64 = None
    try:  # the yardstick call exists on the card's torch only if it has a CUDA kernel
        probe = torch.zeros((8, 64), device=dev, dtype=bf16)
        torch._weight_int8pack_mm(probe, torch.zeros((64, 64), device=dev, dtype=torch.int8),
                                  torch.ones(64, device=dev, dtype=bf16))
        int8pack = True
    except (RuntimeError, NotImplementedError) as e:
        log(f"w8a16 library yardstick: torch._weight_int8pack_mm has no CUDA kernel here ({type(e).__name__})")
        int8pack = False
    shapes = {}
    errs = []
    for name, (k, n) in Q8_SHAPES.items():
        parts = QM.w8a16_parts(k, n)
        lib_parts = QM.W8A16.query("lumen_w8a16_parts", k, n)
        if lib_parts != parts:
            raise AssertionError(f"w8a16_matmul {name}: the library splits K in {lib_parts}, the mirror in {parts}")
        copies = max(2, -(-64 * 2**20 // (k * n)))  # int8 copies > 64 MB: past the 50 MB L2
        qs = [torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8) for _ in range(copies)]
        scales = [torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4 for _ in range(copies)]
        q, scale = qs[0], scales[0]
        for rows in (1, 3, 8, 40, 64):
            x = torch.randn((rows, k), generator=gen, device=dev).to(bf16)
            out = QM.w8a16_matmul(x, q, scale)
            errs.append(max_err(out, QM.w8a16_reference(x.float(), q, scale)))
            if rows == 40:
                x40 = x
            if rows == 64:
                x64 = x
        head = QM.w8a16_matmul(x40[:8].contiguous(), q, scale)
        if not torch.equal(QM.w8a16_matmul(x40, q, scale)[:8], head):
            raise AssertionError(f"w8a16_matmul {name}: rows of a 40-row call differ from an 8-row call")
        if not torch.equal(QM.w8a16_matmul(x64, q, scale)[:1], QM.w8a16_matmul(x64[:1].contiguous(), q, scale)):
            raise AssertionError(f"w8a16_matmul {name}: the first row of a 64-row call differs from a 1-row call")
        for rows in (8, 40):
            x = torch.randn((rows, k), generator=gen, device=dev).to(bf16)
            args = list(zip([x] * copies, qs, scales))
            nb = rows * k * 2 + k * n + n * 4 + rows * n * 2
            fl = 2 * rows * k * n
            bms, by = bound(nb, fl, "bfloat16")
            wbf = [(x, qq.to(bf16)) for qq in qs]
            bf16_bound, _ = bound(nb + k * n, fl, "bfloat16")  # the yardstick reads bf16 weights
            packs = [(x, qq.T.contiguous(), ss.to(bf16)) for qq, ss in zip(qs, scales)] if int8pack else None
            shapes[f"{name} {rows}x{k}x{n}"] = dict(
                parts=parts, blocks=QM.w8a16_grid(rows, k, n),
                ms=device_ms(QM.w8a16_matmul, 100, args, floor_ms=bms, launches=1),
                plain_ms=device_ms(QM.w8a16_reference, 20, args, floor_ms=bms),
                bound_ms=bms, bound_by=by, bound_formula=f"{nb} B / 3.35 TB/s vs {fl} flop / 989 TFLOP/s",
                library_ms=device_ms(torch._weight_int8pack_mm, 100, packs, floor_ms=bms) if packs else None,
                bf16_matmul_ms=device_ms(torch.matmul, 100, wbf, floor_ms=bf16_bound, strict=False),
            )
            if (name, rows) == ("gate_proj/up_proj", 8):
                # Once: a call's cost with the host's launch path (CUDA
                # events), which sets the price at decode sizes.
                call_ms = cuda_ms(lambda: QM.w8a16_matmul(*args[0]), 100)
                log(f"kernel w8a16_matmul {name} 8x{k}x{n}: {call_ms:.4f} ms a call, launch path included")
            del wbf, packs
        del qs, scales
    torch.cuda.synchronize()
    log("kernel w8a16_matmul: rows 1/3/8/40/64 at every projection shape within tolerance; "
        "the first 8 rows of a 40-row call equal an 8-row call and the first row of a 64-row call "
        "a 1-row call, bit for bit")
    c = QM.w8a16_constants()
    for shape, r in shapes.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        yard = "not valid" if r["bf16_matmul_ms"] is None else f"{r['bf16_matmul_ms']:.4f} ms"
        tiles, parts, z, rt = r["blocks"]
        log(f"kernel w8a16_matmul {shape}: kernel {r['ms']:.4f} ms on the device "
            f"(K split in {parts}, {tiles * parts * z} blocks = {tiles} column tiles x {parts} parts x {z}, "
            f"{rt} row tile(s) a block, {c['stages'] if rt == 1 else c['stages_wide']} x {c['depth']}-deep "
            f"stages, no workspace), "
            f"plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bound_formula']}), "
            f"library (_weight_int8pack_mm) {lib}, yardstick bf16 torch.matmul {yard}")
    main = dict(shapes["gate_proj/up_proj 8x896x4864"], max_abs_err=max(errs), shape="gate_proj 8x896x4864")
    main["shapes"] = shapes
    return main


# -- shared: a word-level tokenizer with the HF tokenizers interface --------


class _Encoding:
    def __init__(self, ids):
        self.ids = ids


class WordTokenizer:
    """Whitespace word-level tokenizer: known words map to fixed ids, any
    other word to a stable id in [1000, vocab - 1000); decode prints ids
    as words."""

    def __init__(self, vocab_size: int, special: dict[str, int]):
        self.vocab_size = vocab_size
        self.special = special

    def _id(self, word: str) -> int:
        if word in self.special:
            return self.special[word]
        h = 0
        for ch in word.encode():
            h = (h * 131 + ch) % 1_000_003
        return 1000 + h % (self.vocab_size - 2000)

    def encode(self, text: str, add_special_tokens: bool = False) -> _Encoding:
        return _Encoding([self._id(w) for w in text.split()])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"w{i}" for i in ids)


# -- phase 3: small fp32 reference ------------------------------------------


def check_reference(seed: int) -> None:
    """A small fp32 VLM (head_dim 64, so every kernel takes it) served on
    the card and on the CPU from the same weights: same greedy tokens; and
    on the card with speculative decoding (K = 4): the same tokens again,
    through verify turns (in fp32 QDense would take its matmul branch, so
    the w8a16 kernel is held in phase 2)."""
    import dataclasses

    import numpy as np
    import torch

    from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, VLMModel, init_random_

    base = VLMConfig()
    cfg = dataclasses.replace(
        base,
        decoder=dataclasses.replace(
            base.decoder, hidden_size=256, layers=2, heads=4, kv_heads=2,
            intermediate_size=512, vocab_size=4096, rope_theta=10_000.0,
        ),
        vision=dataclasses.replace(base.vision, image_size=256, patch_size=32, width=128, layers=2, heads=2),
        image_token_id=4000, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    model = init_random_(VLMModel(cfg), seed)
    tok = WordTokenizer(cfg.decoder.vocab_size, {})
    rng = np.random.default_rng(seed)
    pixels = [rng.integers(0, 256, (256, 256, 3), np.uint8) for _ in range(2)]
    msgs = [[ChatMessage("user", f"describe picture {i} briefly")] for i in range(2)]
    from lumen_tpu_torch.ops.attention import PAGED_VARQ

    outs = {}
    for run, device, spec in (("card", "cuda:0", "0"), ("cpu", "cpu", "0"), ("card+spec", "cuda:0", "4")):
        with env(LUMEN_VLM_SPEC_K=spec, LUMEN_VLM_SPEC_MIN_RATE="0"):
            mgr = VLMManager(
                cfg, model.state_dict(), tok, device=device, dtype="float32", max_seq=256,
                max_new_cap=24, prefill_buckets=(16, 32), pool_pages=33, prefill_chunk=32,
            )
        try:
            PAGED_VARQ.launches = 0
            outs[run] = [mgr.generate(m, p, max_new_tokens=24).tokens for m, p in zip(msgs, pixels)]
            if spec != "0":
                eng = mgr.engine
                if eng.spec_turns == 0 or PAGED_VARQ.launches == 0:
                    raise AssertionError(
                        f"speculative run took {eng.spec_turns} verify turns, "
                        f"{PAGED_VARQ.launches} verify-window launches"
                    )
                log(f"reference: spec K=4 took {eng.spec_turns} verify turns, "
                    f"{eng.spec_accepted}/{eng.spec_proposed} drafted tokens accepted, "
                    f"{PAGED_VARQ.launches} paged_attention_varq launches")
        finally:
            mgr.close()
    if not outs["card"] == outs["cpu"] == outs["card+spec"]:
        raise AssertionError(f"card, CPU and card with speculation disagree: {outs}")
    log(f"reference: small fp32 VLM, card == CPU == card with speculation, greedy tokens "
        f"({[len(t) for t in outs['cpu']]} tokens)")


# -- phases 4 and 5: the serving path at full width -------------------------


def drive_serving(
    seed: int, card: str, cfg=None, device: str = "cuda:0", quantize: str | None = None,
    spec_k: int = 0, kernels: tuple = PHASE4_KERNELS,
) -> dict:
    """Phase 4 (defaults) or phase 5 (``quantize="int8"``, ``spec_k=4``):
    10 caption requests, 8 at once and 2 after decoding started, three of
    them streaming. Returns the drive's numbers, with every kernel's launch
    count during the drive under ``launches``. ``cfg``/``device`` let the
    CPU tests rehearse the drive at a small configuration (it then stops
    at the launch-count check: plain paths launch nothing)."""
    import numpy as np
    import torch

    from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, VLMModel, init_random_
    from lumen_tpu_torch.ops.quant import QDense

    label = f"phase {5 if quantize or spec_k else 4}"
    cfg = cfg or VLMConfig()
    t0 = time.perf_counter()
    with torch.device(device):
        model = VLMModel(cfg)
    init_random_(model, seed)
    state = model.to(torch.bfloat16).state_dict()
    del model
    tok = WordTokenizer(cfg.decoder.vocab_size, {})
    with env(LUMEN_VLM_SPEC_K=str(spec_k), LUMEN_VLM_SPEC_MIN_RATE="0"):
        mgr = VLMManager(
            cfg, state, tok, device=device, dtype="bfloat16", max_seq=2048,
            gen_slots=8, gen_block=8, page_size=16, pool_pages=8 * 2048 // 16 + 1, prefill_chunk=256,
            quantize=quantize,
        )
    del state  # the int8 model must not sit beside a bf16 copy of its projections
    log(f"{label}: VLMConfig() (quantize={quantize}, spec K={spec_k}) built in "
        f"{time.perf_counter() - t0:.1f} s, kv {mgr.kv_layout()}")
    if quantize:
        dec = mgr.model.decoder
        qd = [m for m in dec.modules() if isinstance(m, QDense)]
        linear = [n for n, m in dec.named_modules() if isinstance(m, torch.nn.Linear)]
        if len(qd) != 7 * cfg.decoder.layers or linear or any(m.q.dtype != torch.int8 for m in qd):
            raise AssertionError(f"int8 decoder: {len(qd)} QDense, float projections {linear[:3]}")
        if any(m.scale.dtype != torch.float32 for m in qd):
            raise AssertionError("int8 decoder: a scale lost its fp32")
        log(f"{label}: all {len(qd)} decoder projections hold int8 q and fp32 scale")
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def request(i: int):
        pixels = rng.integers(0, 256, (size, size, 3), np.uint8)
        if spec_k:  # templated traffic: the repeated phrase prompt lookup serves
            text = f"Caption image {i}: a red car on a wet road, a red car on a wet road, a red car on a wet road."
        else:
            text = f"Describe image {i} in one detailed sentence."
        return [ChatMessage("user", text)], pixels, 32 + 4 * (i % 9)

    all_k = all_kernels()
    try:
        # Warm-up (cuBLAS handles, allocator), not counted.
        m, p, _ = request(99)
        mgr.generate(m, p, max_new_tokens=4)
        sync()
        reqs = [request(i) for i in range(10)]
        results: dict[int, dict] = {}
        errors: list[BaseException] = []

        def run(i: int, stream: bool):
            m, p, n = reqs[i]
            try:
                t = time.perf_counter()
                if stream:
                    chunks = list(mgr.generate_stream(m, p, max_new_tokens=n))
                    meta = chunks[-1].metadata
                    results[i] = dict(n=meta["generated_tokens"], budget=n, ttft_ms=meta.get("ttft_ms"),
                                      tokens=None, s=time.perf_counter() - t)
                else:
                    r = mgr.generate(m, p, max_new_tokens=n)
                    results[i] = dict(n=len(r.tokens), budget=n, tokens=r.tokens, finish=r.finish_reason,
                                      s=time.perf_counter() - t)
            except BaseException as e:  # noqa: BLE001 - reported below, fails the run
                errors.append(e)

        eng = mgr.engine
        turns0, prop0, acc0 = eng.spec_turns, eng.spec_proposed, eng.spec_accepted
        blocks0 = eng.blocks_run
        for k in all_k:
            k.launches = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        stream_ids = {6, 7, 9}
        threads = [threading.Thread(target=run, args=(i, i in stream_ids)) for i in range(8)]
        for t in threads:
            t.start()
        # Late admissions: wait until decoding has started.
        deadline = time.perf_counter() + 300
        while eng.blocks_run == blocks0 and time.perf_counter() < deadline and not errors:
            time.sleep(0.005)
        if eng.blocks_run == blocks0:
            raise AssertionError("decoding never started")
        late = [threading.Thread(target=run, args=(i, i in stream_ids)) for i in (8, 9)]
        for t in late:
            t.start()
        for t in threads + late:
            t.join(timeout=600)
        wall = time.perf_counter() - t_start
        launches = {k.name: k.launches for k in all_k}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        turns, prop, acc = eng.spec_turns - turns0, eng.spec_proposed - prop0, eng.spec_accepted - acc0
        if errors:
            raise errors[0]
        if len(results) != 10:
            raise AssertionError(f"only {len(results)} of 10 requests answered")
        for i, r in results.items():
            if not 1 <= r["n"] <= r["budget"]:
                raise AssertionError(f"request {i}: {r['n']} tokens for a budget of {r['budget']}")
            if r["tokens"] is not None and not all(0 <= t < cfg.decoder.vocab_size for t in r["tokens"]):
                raise AssertionError(f"request {i}: token id out of range")
        if spec_k and (turns == 0 or prop == 0):
            raise AssertionError(f"speculation never verified: {turns} verify turns, {prop} proposals")
        missing = [name for name in kernels if launches[name] == 0]
        if missing:
            raise AssertionError(f"serving path never launched: {missing} (launches {launches})")
        total = sum(r["n"] for r in results.values())
        ttfts = sorted(r["ttft_ms"] for r in results.values() if r.get("ttft_ms") is not None)
        log(f"{label}: 10 requests (8 at once, 2 after decoding started; {len(stream_ids)} streaming), "
            f"{total} tokens in {wall:.3f} s = {total / wall:.1f} tok/s aggregate [{card}]")
        log(f"{label}: ttft_ms of streams {ttfts} [{card}]")
        log(f"{label}: peak device memory {peak / 2**30:.3f} GiB [{card}]")
        if spec_k:
            log(f"{label}: {turns} verify turns, {acc}/{prop} drafted tokens accepted "
                f"(rate {acc / prop:.3f})")
        log(f"{label}: launches {json.dumps(launches)}; decode turns {eng.blocks_run - blocks0}, "
            f"chunks {eng.chunks_run}, preemptions {eng.preemptions}")
        # Greedy determinism: request 0 again, alone.
        m, p, n = reqs[0]
        again = mgr.generate(m, p, max_new_tokens=n).tokens
        if again != results[0]["tokens"]:
            raise AssertionError("greedy request repeated gave different tokens")
        log(f"{label}: greedy repeat gives identical tokens")
        stats = eng.kv.stats()
        if stats.pages_live != 0:
            raise AssertionError(f"pages still live after drain: {stats}")
        return dict(
            launches=launches, tokens=total, wall_s=wall, tok_s=total / wall, ttft_ms=ttfts,
            peak_gib=peak / 2**30, spec_turns=turns, spec_proposed=prop, spec_accepted=acc,
        )
    finally:
        mgr.close()


# -- phase 6: the gRPC server from a model directory ---------------------------

#: words the phase-6 tokenizer knows besides its ``w<id>`` filler tokens
WORDS = ("user", "assistant", "describe", "this", "photo", "in", "one", "detailed", "sentence", "caption",
         "image", "a", "red", "car", "on", "wet", "road")

CHAT_TEMPLATE = (
    "{% for m in messages %}<|im_start|>{{ m.role }}\n{{ m.content }}<|im_end|>\n{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


def hf_config(cfg) -> dict:
    """``config.json`` (LLaVA-style ``text_config`` + ``vision_config``) that
    ``VLMConfig.from_hf`` reads back as ``cfg``."""
    d, v = cfg.decoder, cfg.vision
    return {
        "text_config": {
            "hidden_size": d.hidden_size, "num_hidden_layers": d.layers, "num_attention_heads": d.heads,
            "num_key_value_heads": d.kv_heads, "intermediate_size": d.intermediate_size,
            "vocab_size": d.vocab_size, "head_dim": d.head_dim, "rope_theta": d.rope_theta,
            "rms_norm_eps": d.rms_norm_eps, "max_position_embeddings": d.max_position_embeddings,
            "tie_word_embeddings": d.tie_word_embeddings, "bos_token_id": cfg.bos_token_id,
            "eos_token_id": cfg.eos_token_id, "pad_token_id": cfg.pad_token_id,
        },
        "vision_config": {
            "image_size": v.image_size, "patch_size": v.patch_size, "hidden_size": v.width,
            "num_hidden_layers": v.layers, "num_attention_heads": v.heads,
            "image_mean": list(v.mean), "image_std": list(v.std),
        },
        "image_token_index": cfg.image_token_id,
    }


def write_tokenizer(path: Path, cfg) -> None:
    """A ``tokenizers`` WordLevel vocabulary of all ``vocab_size`` ids: the
    config's special ids as special tokens, ``WORDS`` at ids 1000 on,
    ``w<id>`` for the rest, so every id the model can emit decodes and
    distinct non-special ids decode to distinct words."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers

    vocab_size = cfg.decoder.vocab_size
    names = {cfg.bos_token_id: "<|endoftext|>", cfg.eos_token_id: "<|im_end|>", cfg.image_token_id: "<image>"}
    names.setdefault(cfg.pad_token_id, "<pad>")
    names[next(i for i in range(vocab_size - 1, 0, -1) if i not in names)] = "<|im_start|>"
    special = list(names.values())
    names[next(i for i in range(3, vocab_size) if i not in names)] = "<unk>"
    for k, word in enumerate(WORDS):
        names[1000 + k] = word
    vocab = {names.get(i, f"w{i}"): i for i in range(vocab_size)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens([AddedToken(s, special=True) for s in special])
    tok.save(str(path))


def write_model_dir(root: Path, name: str, cfg, state) -> Path:
    """A model directory as the loader reads one: ``model.safetensors``
    under the HF/FastVLM names ``convert_vlm_checkpoint`` reads,
    ``config.json``, ``tokenizer.json``, ``tokenizer_config.json`` with a
    chat template, and ``model_info.json``."""
    from safetensors.torch import save_file

    from lumen_tpu_torch.models.vlm.convert import export_hf_checkpoint

    model_dir = root / "models" / name
    model_dir.mkdir(parents=True)
    save_file({k: v.cpu() for k, v in export_hf_checkpoint(state).items()}, str(model_dir / "model.safetensors"))
    (model_dir / "config.json").write_text(json.dumps(hf_config(cfg)))
    write_tokenizer(model_dir / "tokenizer.json", cfg)
    (model_dir / "tokenizer_config.json").write_text(json.dumps({"chat_template": CHAT_TEMPLATE}))
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": name, "version": "1.0.0", "description": "seeded random weights for chip_smoke.py",
        "model_type": "vlm", "source": {"format": "custom", "repo_id": f"LumilioPhotos/{name}"},
        "runtimes": {"jax": {"available": True, "files": ["model.safetensors"]}},
    }))
    return model_dir


def deployment_yaml(path: Path, cache_dir: Path, model: str, quantize: str | None) -> Path:
    """A single-service deployment naming the service in its JAX form, which
    the port's loader maps onto its own class."""
    settings = {"dtype": "bfloat16", "batch_size": 8}
    if quantize:
        settings["quantize"] = quantize
    import yaml

    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": {"mode": "single", "service": "vlm"},
        "server": {"port": 50051, "host": "127.0.0.1"},
        "services": {"vlm": {
            "enabled": True, "package": "lumen_tpu.models.vlm",
            "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
            "backend_settings": settings,
            "models": {"vlm": {"model": model, "runtime": "jax"}},
        }},
    }))
    return path


def photo_jpeg(seed: int, width: int = 1600, height: int = 1200) -> bytes:
    """A seeded photo-sized JPEG (smooth gradients plus noise), not of the
    canvas size, so the server's letterbox resize runs."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([x / width, y / height, (x + y) / (width + height)], -1) * rng.uniform(80, 200, 3)
    img = np.clip(base + rng.normal(0, 12, (height, width, 3)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def grpc_call(stub, task: str, payload: bytes, meta: dict, timeout: float = 600) -> dict:
    """One Infer stream: its deltas, the final body (or error code) and the
    client-side time to the first delta."""
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb

    req = pb.InferRequest(correlation_id="c", task=task, payload=payload, payload_mime="image/jpeg",
                          meta={k: str(v) for k, v in meta.items()})
    t0 = time.perf_counter()
    deltas, first, last = [], None, None
    for resp in stub.Infer(iter([req]), timeout=timeout):
        if not resp.is_final:
            first = first or time.perf_counter()
            deltas.append(resp.result)
        last = resp
    if last is None:
        raise AssertionError(f"{task}: the stream ended without a final message")
    out = dict(deltas=deltas, ttft_ms=None if first is None else (first - t0) * 1e3, s=time.perf_counter() - t0,
               code=last.error.code if last.HasField("error") else 0, mime=last.result_mime)
    if not out["code"]:
        out["body"] = json.loads(last.result)
    return out


def boot_server(yaml_path: Path, device: str):
    """``serve()`` in process on an OS-assigned port; returns the handle,
    a stub and the seconds from the call to the first ``Health`` that
    answers ok."""
    import grpc
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.core.config import load_config
    from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
    from lumen_tpu_torch.serving.server import serve

    t0 = time.perf_counter()
    handle = serve(load_config(str(yaml_path)), port_override=0, skip_download=True, device=device)
    channel = grpc.insecure_channel(f"127.0.0.1:{handle.port}")
    stub = InferenceStub(channel)
    while True:
        try:
            stub.Health(empty_pb2.Empty(), timeout=10)
            break
        except grpc.RpcError:
            if time.perf_counter() - t0 > 300:
                raise
            time.sleep(0.05)
    return handle, channel, stub, time.perf_counter() - t0


def drive_grpc(seed: int, card: str, cfg=None, device: str = "cuda:0") -> dict:
    """Phase 6: a full-width model directory served over real gRPC by the
    port's ``serve()``; bf16, then int8 with speculation. ``cfg``/``device``
    let the CPU tests rehearse it at a small configuration (it then stops at
    the launch-count check)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, VLMModel, init_random_
    from lumen_tpu_torch.models.vlm.chat import VlmTokenizer
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
    from lumen_tpu_torch.utils.host_decode import vlm_canvas
    from lumen_tpu_torch.utils.metrics import metrics

    cfg = cfg or VLMConfig()
    on_card = torch.device(device).type == "cuda"
    if VLMConfig.from_hf(hf_config(cfg)) != cfg:
        raise AssertionError("config.json does not read back as the served configuration")
    all_k = all_kernels()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="lumen-chip-smoke-") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        with torch.device(device):
            model = VLMModel(cfg)
        init_random_(model, seed + 6)
        state = model.to(torch.bfloat16).state_dict()
        del model
        model_dir = write_model_dir(root / "cache", "SmokeVLM", cfg, state)
        state = {k: v.cpu() for k, v in state.items()}  # for the direct manager; off the card meanwhile
        mb = sum(f.stat().st_size for f in model_dir.iterdir()) / 2**20
        log(f"phase 6: model directory of VLMConfig() (seeded bf16 weights, HF names) written in "
            f"{time.perf_counter() - t0:.1f} s, {mb:.0f} MiB: {sorted(f.name for f in model_dir.iterdir())}")
        prompt = json.dumps([{"role": "user", "content": "describe this photo in one detailed sentence"}])
        photos = [photo_jpeg(seed * 100 + i) for i in range(12)]

        # -- bf16 server: 10 streams, 8 in flight at once -----------------
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with env(LUMEN_VLM_SPEC_K="0"):
            handle, channel, stub, load_s = boot_server(
                deployment_yaml(root / "bf16.yaml", root / "cache", "SmokeVLM", None), device)
        try:
            mgr = handle.services["vlm"].manager
            log(f"phase 6: bf16 server up in {load_s:.2f} s (serve() to the first Health ok), port "
                f"{handle.port}, {type(handle.services['vlm']).__module__}, kv {mgr.kv_layout()}")
            budgets = [32 + 4 * i for i in range(10)]
            for k in all_k:
                k.launches = 0
            t_start = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as pool:
                streams = list(pool.map(lambda i: grpc_call(
                    stub, "vlm_generate_stream", photos[i], {"messages": prompt, "max_new_tokens": budgets[i]}),
                    range(10)))
            wall = time.perf_counter() - t_start
            unary = grpc_call(stub, "vlm_generate", photos[10], {"messages": prompt, "max_new_tokens": 16})
            launches = {k.name: k.launches for k in all_k}
            peak = torch.cuda.max_memory_allocated() if on_card else 0
            caps = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
            stub.Health(empty_pb2.Empty(), timeout=30)
            bad = grpc_call(stub, "vlm_generate_stream", b"\xff\xd8 not a jpeg", {"messages": prompt})
            for i, r in enumerate(streams + [unary]):
                if r["code"] or "text_generation" not in r["mime"]:
                    raise AssertionError(f"request {i}: no TextGenerationV1 final (code {r['code']}, {r['mime']})")
                body, budget = r["body"], (budgets + [16])[i]
                if not 1 <= body["generated_tokens"] <= budget:
                    raise AssertionError(f"request {i}: {body['generated_tokens']} tokens for a budget of {budget}")
                if i < 10 and b"".join(r["deltas"]).decode() != body["text"]:
                    raise AssertionError(f"stream {i}: deltas do not join to the final text")
            if bad["code"] != pb.ERROR_CODE_INVALID_ARGUMENT:
                raise AssertionError(f"a malformed image answered code {bad['code']}, not INVALID_ARGUMENT")
            if {t.name for t in caps.tasks} != {"vlm_generate", "vlm_generate_stream"} or caps.runtime != (
                    "torch-cuda" if on_card else "torch-cpu"):
                raise AssertionError(f"capabilities: {[t.name for t in caps.tasks]}, runtime {caps.runtime}")
            missing = [n for n in PHASE4_KERNELS if launches[n] == 0]
            if missing:
                raise AssertionError(f"the bf16 server never launched: {missing} (launches {launches})")
            tokens = sum(r["body"]["generated_tokens"] for r in streams)
            ttfts = [round(r["ttft_ms"], 2) for r in streams]
            log(f"phase 6: 10 vlm_generate_stream over gRPC (8 in flight, 1600x1200 JPEG each), {tokens} tokens "
                f"in {wall:.3f} s = {tokens / wall:.1f} tok/s aggregate [{card}]")
            log(f"phase 6: client-side ttft_ms (first delta) {ttfts}; server ttft_ms "
                f"{[r['body']['metadata'].get('ttft_ms') for r in streams]} [{card}]")
            log(f"phase 6: vlm_generate {unary['body']['generated_tokens']} tokens in {unary['s']:.3f} s; "
                f"GetCapabilities {caps.runtime} {sorted(t.name for t in caps.tasks)}; Health ok; malformed "
                f"image INVALID_ARGUMENT")
            log(f"phase 6: peak device memory {peak / 2**30:.3f} GiB [{card}]")
            log(f"phase 6: bf16 launches {json.dumps(launches)}")
            decode_ms = []
            for _ in range(5):
                t = time.perf_counter()
                vlm_canvas(photos[0], cfg.vision.image_size)
                decode_ms.append((time.perf_counter() - t) * 1e3)
            gap = [r["ttft_ms"] - r["body"]["metadata"]["ttft_ms"] for r in streams]
            task = metrics.snapshot()["tasks"]["vlm_generate_stream"]
            log(f"phase 6: service layer: host decode + letterbox of one 1600x1200 JPEG "
                f"{sorted(decode_ms)[2]:.1f} ms (median of 5, idle server); client ttft - server ttft "
                f"{min(gap):.1f}..{max(gap):.1f} ms (gRPC, dispatch, parse; the decode is inside the server's); server-side "
                f"vlm_generate_stream latency p50 {task['p50_ms']:.0f} ms (histogram bucket) over "
                f"{task['count']} streams [{card}]")
        finally:
            channel.close()
            handle.stop(grace=1.0)
        out.update(load_s=load_s, tokens=tokens, wall_s=wall, tok_s=tokens / wall, ttft_ms=ttfts,
                   peak_gib=peak / 2**30, launches=launches)

        # -- loading is lossless: request 0 on a manager built from `state` --
        direct = VLMManager(cfg, state, VlmTokenizer.from_model_dir(str(model_dir)), device=device,
                            dtype="bfloat16", gen_slots=8, gen_block=8)
        try:
            r = direct.generate([ChatMessage("user", "describe this photo in one detailed sentence")],
                                vlm_canvas(photos[0], cfg.vision.image_size), max_new_tokens=budgets[0])
            want = direct.tokenizer.decode(r.tokens)
        finally:
            direct.close()
        got = streams[0]["body"]
        if (got["generated_tokens"], got["text"]) != (len(r.tokens), want):
            raise AssertionError(f"request 0 over gRPC differs from the direct manager: "
                                 f"{got['generated_tokens']} tokens {got['text'][:80]!r} vs {len(r.tokens)} {want[:80]!r}")
        log(f"phase 6: request 0 == a direct VLMManager on the same weights and canvas ({len(r.tokens)} tokens)")
        del state

        # -- int8 server with speculation: 4 templated requests ---------------
        if on_card:
            torch.cuda.empty_cache()
        with env(LUMEN_VLM_SPEC_K="4", LUMEN_VLM_SPEC_MIN_RATE="0"):
            handle, channel, stub, load8_s = boot_server(
                deployment_yaml(root / "int8.yaml", root / "cache", "SmokeVLM", "int8"), device)
        try:
            eng = handle.services["vlm"].manager.engine
            templated = json.dumps([{"role": "user", "content":
                                     "caption this image : a red car on a wet road , a red car on a wet road ."}])
            for k in all_k:
                k.launches = 0
            turns0 = eng.spec_turns
            with ThreadPoolExecutor(max_workers=4) as pool:
                q8 = list(pool.map(lambda i: grpc_call(
                    stub, "vlm_generate_stream", photos[11 - i % 2], {"messages": templated, "max_new_tokens": 48}),
                    range(4)))
            launches8 = {k.name: k.launches for k in all_k}
            if any(r["code"] for r in q8):
                raise AssertionError(f"int8 server: codes {[r['code'] for r in q8]}")
            missing = [n for n in PHASE6_INT8_KERNELS if launches8[n] == 0]
            if missing or eng.spec_turns == turns0:
                raise AssertionError(f"the int8 server never launched {missing} "
                                     f"({eng.spec_turns - turns0} verify turns; launches {launches8})")
            log(f"phase 6: int8 + spec K=4 server up in {load8_s:.2f} s; 4 templated streams, "
                f"{sum(r['body']['generated_tokens'] for r in q8)} tokens, {eng.spec_turns - turns0} verify turns; "
                f"launches {json.dumps(launches8)}")
        finally:
            channel.close()
            handle.stop(grace=1.0)
        out.update(load8_s=load8_s, launches8=launches8)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not (ROOT / "lumen_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lumen_tpu_torch.ops.cuda_build import build_all

    kernels = all_kernels()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build_all(kernels)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for r in ptxas_report(logs):
        log(f"  ptxas {r['lib']}: {r['func']}: {r['registers']} registers, {r['smem']} B smem, "
            f"{r['spill_stores']} / {r['spill_loads']} B spill stores / loads")
        if "bf16" in r["func"] and r["spill_stores"] + r["spill_loads"]:
            raise AssertionError(f"{r['func']} spills: the bf16 flash tile must stay in registers")
    flash = [k for k in kernels if k.name in ("flash_attention", "flash_attention_cache")]
    hmma = hmma_counts(flash)
    log("sass (cuobjdump -sass), HMMA instructions: "
        + ", ".join(f"{func} {n}" for func, n in sorted(hmma.items())))
    bf16_funcs = [f for f in hmma if "bf16" in f]
    if len(bf16_funcs) != 2 or any(hmma[f] == 0 for f in bf16_funcs):
        raise AssertionError(f"the bf16 flash kernels must run on the tensor cores: HMMA {hmma}")

    rows = check_kernels(args.seed)
    rows["paged_attention_varq"] = check_varq(args.seed)
    rows["w8a16_matmul"] = check_w8a16(args.seed)
    check_reference(args.seed)
    drives = {4: drive_serving(args.seed, card)}
    drives[5] = drive_serving(args.seed, card, quantize="int8", spec_k=4, kernels=PHASE5_KERNELS)
    a, b = drives[4], drives[5]
    log(f"phase 4 vs 5 [{card}]: tok/s {a['tok_s']:.1f} (bf16) vs {b['tok_s']:.1f} (int8 + spec K=4); "
        f"peak GiB {a['peak_gib']:.3f} vs {b['peak_gib']:.3f}; stream ttft_ms {a['ttft_ms']} vs "
        f"{b['ttft_ms']}; accept rate {b['spec_accepted'] / max(b['spec_proposed'], 1):.3f}")
    grpc_drive = drive_grpc(args.seed, card)
    log(f"phase 6 [{card}]: load {grpc_drive['load_s']:.2f} s (bf16), {grpc_drive['load8_s']:.2f} s (int8); "
        f"{grpc_drive['tok_s']:.1f} tok/s aggregate over gRPC; client ttft_ms {grpc_drive['ttft_ms']}; "
        f"peak GiB {grpc_drive['peak_gib']:.3f}")

    table = []
    for k in kernels:
        source, replaces = SOURCES[k.name]
        row = rows[k.name]
        # Launches come from phase 6, the main path: the bf16 server for the
        # bf16 path's kernels, the int8 + speculation server for the others.
        launches = grpc_drive["launches" if k.name in PHASE4_KERNELS else "launches8"][k.name]
        table.append(dict(
            name=k.name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"],
        ))
    log(f"{card}")
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
