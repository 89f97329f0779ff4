#!/usr/bin/env python3
"""Variants of flash_attention's bf16 launch plans, timed in turns on one
NVIDIA GPU at the kernel table's six shapes.

``csrc/flash_plan_bf16.cuh`` fixes the plan of a call from its shape: the
short path (sk <= ``kFlashShortKeys``) or the long path, whose block is
``FlashLong<D>``'s row groups, key split, ring steps and keys a tile.
This script builds ``flash_attention.cu`` once per variant from a rewritten copy of
``csrc/`` (the repository's own build stays untouched), checks each
variant against the plain version at every shape, and times each with
``chip_smoke.device_ms`` (device time per call from ``torch.profiler``)
in turns: A, B, ..., B, A. A variant is ``base`` (this checkout) or
settings joined by ``+``:

- ``NAME=VALUE``: a ``constexpr int NAME`` of the header
  (``kFlashShortKeys=0`` sends every shape down the long path);
- ``long64=G/S/T/K/B``: ``FlashLong<64>``'s row groups, key split, ring
  steps, keys a tile and blocks an SM for ptxas;
- ``src=DIR``: build from ``DIR`` instead of this checkout's ``csrc/``
  (another checkout's, e.g. the parent commit's, unpacked with ``git
  archive`` into a directory ``.gitignore`` lists);
- ``patch=NAME``: a rewrite of the header (``PATCHES``): ``bulk``
  brings the long path's K/V tiles in with Hopper's 1-D ``cp.async.bulk``
  (one copy a padded row, an ``mbarrier`` a ring step) instead of 16-byte
  ``cp.async``; ``poly2``, ``poly4`` and ``poly8`` compute exp2 on the FMA
  pipe (a Cody-Waite split and a minimax cubic) for every 2nd, 4th or
  8th score tile at head_dim 16, the rest on the SFU; the diagnostic cuts
  ``noload`` and ``nocompute`` leave garbage, so they are timed but not
  checked.

Run from the repository root:

    python3 scripts/flash_plan_variants.py [--variants base long128=4/1/2/64/1 patch=poly4 ...] [--seed 0]
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
#: the kernel table's flash shapes: (b, h, s, head_dim, causal)
SHAPES = {
    "VLM vision": (1, 12, 256, 64, False),
    "CLIP vision": (64, 12, 50, 64, False),
    "CLIP text": (64, 8, 77, 64, True),
    "hd128 causal": (1, 16, 265, 128, True),
    "SVTR 320": (8, 4, 960, 16, False),
    "SVTR 640": (32, 4, 1920, 16, False),
}



def poly_patch(period: int) -> list:
    """exp2 on the FMA pipe for the head_dim-16 score tiles n (8 keys
    each) of a chunk with n % period == period - 1: x clamped at -125 (the
    exponent stays normal), j = round(x) from the low mantissa bits of x +
    1.5 * 2^23, 2^f on [-0.5, 0.5] by a minimax cubic (relative error
    7.48e-5; bf16 P rounds at 2^-9), j added to the exponent bits."""
    return [
        ("""__device__ __forceinline__ float flash_exp2_sfu(float x) {""",
         """__device__ __forceinline__ float flash_exp2_poly(float x) {
  x = fmaxf(x, -125.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05517167f, f, 0.24261113f), f, 0.69326097f), f, 0.99992806f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

__device__ __forceinline__ float flash_exp2_sfu(float x) {"""),
        ("        p[e] = flash_exp2_sfu(s[n][e]);",
         f"        p[e] = D == 16 && n % {period} == {period - 1} ? flash_exp2_poly(s[n][e]) : flash_exp2_sfu(s[n][e]);"),
    ]


#: rewrites of flash_plan_bf16.cuh: [(text, replacement), ...]
PATCHES = {
    # no K/V copies: the ring's slots keep whatever they held (compute and
    # barriers alone)
    "noload": [("        cp_async_16(&sK[t % ST][j][d], k + off, live);\n"
                "        cp_async_16(&sV[t % ST][j][d], v + off, live);\n", "")],
    # no tile computed: the copies, waits and barriers alone
    "nocompute": [("    if (t * BK < kend_w)\n      flash_chunk<T, D, BK / 8>(",
                   "    if (false)\n      flash_chunk<T, D, BK / 8>(")],
    # K/V rows by 1-D cp.async.bulk into the padded slots (D * 2 bytes a
    # row, issued by warp 0), completing on one mbarrier a ring step; rows
    # past kend zero-filled by plain stores
    "bulk": [
        ("""  auto load_step = [&](int u) {
    for (int c = tid; c < SPLIT * BK * CH; c += THREADS) {
      const int t = u * SPLIT + c / (BK * CH), j = c / CH % BK, d = (c % CH) * 8;
      if (t < ntiles) {
        const int key = t * BK + j;
        const bool live = key < kend;
        const size_t off = live ? (size_t)key * D + d : 0;
        cp_async_16(&sK[t % ST][j][d], k + off, live);
        cp_async_16(&sV[t % ST][j][d], v + off, live);
      }
    }
    cp_async_commit();
  };
""", """  __shared__ __align__(8) uint64_t bulk_bar[STEPS];
  if (tid == 0) {
    for (int i = 0; i < STEPS; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bulk_bar[i])));
    asm volatile("fence.mbarrier_init.release.cluster;");
  }
  __syncthreads();
  auto load_step = [&](int u) {
    const int k0 = u * SPLIT * BK;
    for (int c = tid; c < SPLIT * BK * CH; c += THREADS) {
      const int t = u * SPLIT + c / (BK * CH), j = c / CH % BK, d = (c % CH) * 8;
      if (t < ntiles && t * BK + j >= kend) {
        *reinterpret_cast<uint4*>(&sK[t % ST][j][d]) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(&sV[t % ST][j][d]) = make_uint4(0, 0, 0, 0);
      }
    }
    if (warp == 0) {
      const uint32_t bar = smem_addr(&bulk_bar[u % STEPS]);
      const int nrows = max(0, min(kend, k0 + SPLIT * BK) - k0);
      if (lane == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(2 * nrows * D * 2)
                     : "memory");
      __syncwarp();
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int r = lane; r < 2 * nrows; r += 32) {
        const int key = k0 + (r >> 1), t = key / BK, j = key % BK;
        const T* src = ((r & 1) ? v : k) + (size_t)key * D;
        const void* dst = (r & 1) ? (const void*)&sV[t % ST][j][0] : (const void*)&sK[t % ST][j][0];
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                smem_addr(dst)),
            "l"(src), "r"(D * 2), "r"(bar)
            : "memory");
      }
    }
  };
  auto wait_step = [&](int u) {
    const uint32_t bar = smem_addr(&bulk_bar[u % STEPS]), parity = (u / STEPS) & 1;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n selp.u32 %0, 1, 0, p;\\n}"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
  };
"""),
        ("  cp_async_wait<STEPS - 1>();  // Q has landed", "  cp_async_wait<0>();  // Q has landed"),
        ("    cp_async_wait<STEPS - 2>();  // step u has landed; later ones may be in flight",
         "    wait_step(u);"),
    ],
    **{f"poly{n}": poly_patch(n) for n in (2, 4, 8)},
}
#: patches whose output is not the function's
DIAGNOSTIC = {"noload", "nocompute"}


def rewrite(text: str, setting: str) -> str:
    """``flash_plan_bf16.cuh`` with one setting applied."""
    name, value = setting.split("=")
    if name == "patch":
        for old, new in PATCHES[value]:
            n = text.count(old)
            if n != 1:
                break
            text = text.replace(old, new)
    elif m := re.fullmatch(r"long(\d+)", name):
        g, s, t, k, b = value.split("/")
        pattern = (rf"(struct FlashLong<{m[1]}> \{{\s*static constexpr int )"
                   r"kGroups = \d+, kSplit = \d+, kSteps = \d+, kKeys = \d+, kMinBlocks = \d+;")
        text, n = re.subn(pattern, rf"\g<1>kGroups = {g}, kSplit = {s}, kSteps = {t}, kKeys = {k}, kMinBlocks = {b};",
                          text)
    else:
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", text)
    if n != 1:
        raise RuntimeError(f"{setting}: not found in flash_plan_bf16.cuh")
    return text


def build_variants(variants: list[str]) -> tuple[dict, dict]:
    """({variant: bound lumen_flash_attention}, {variant: ptxas log}), built
    from rewritten copies of csrc/ under build/flash_plan_variants/."""
    from lumen_tpu_torch.ops import attention as A
    from lumen_tpu_torch.ops.cuda_build import CSRC, NVCC_FLAGS, _nvcc

    out = ROOT / "build" / "flash_plan_variants"
    procs = []
    for i, w in enumerate(variants):
        src = out / f"variant{i}"
        shutil.rmtree(src, ignore_errors=True)
        settings = [] if w == "base" else w.split("+")
        origin = CSRC
        for s in settings:
            if s.startswith("src="):
                origin = (ROOT / s[4:]).resolve()
        shutil.copytree(origin, src)
        header = src / "flash_plan_bf16.cuh"
        for s in settings:
            if not s.startswith("src="):
                header.write_text(rewrite(header.read_text(), s))
        lib = src / "flash_attention.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(src), "-o", str(lib), str(src / "flash_attention.cu")]
        procs.append((w, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns, logs = {}, {}
    for w, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {w}:\n{text}")
        logs[w] = text
        fn = getattr(ctypes.CDLL(str(lib)), A.FLASH.symbol)
        fn.argtypes, fn.restype = A.FLASH.argtypes, ctypes.c_int
        fns[w] = fn
    return fns, logs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", default=["base"])
    parser.add_argument("--shapes", nargs="+", default=list(SHAPES),
                        help=f"of {list(SHAPES)}, or b,h,s,head_dim,causal (e.g. 1,15,265,128,1)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_plan_variants.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from lumen_tpu_torch.ops import attention as A

    card = C.card_line()
    print(f"card: {card}", flush=True)
    fns, logs = build_variants(args.variants)
    for r in C.ptxas_report(logs):
        if "bf16" in r["func"]:
            print(f"  ptxas {r['lib']}: {r['func']}: {r['registers']} registers, "
                  f"{r['spill_stores']} / {r['spill_loads']} B spill stores / loads", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    calls = {}
    for name in args.shapes:
        b, h, s, d, causal = SHAPES[name] if name in SHAPES else (int(x) for x in name.split(","))
        causal = bool(causal)
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        calls[name] = (q, k, v, causal, 4 * q.numel() * 2 / C.HBM_BYTES_PER_S * 1e3)
    order = args.variants + args.variants[::-1]
    times: dict = {w: {s: [] for s in calls} for w in args.variants}
    sdpa = {}
    try:
        for w in args.variants:
            if any(f"patch={p}" in w for p in DIAGNOSTIC):
                continue
            A.FLASH._fn = fns[w]
            for q, k, v, causal, _ in calls.values():
                C.max_err(A.flash_attention(q, k, v, causal=causal),
                          A.attention_reference(q.float(), k.float(), v.float(), causal=causal))
        for name, (q, k, v, causal, floor_ms) in calls.items():
            sdpa[name] = C.device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 50,
                                     floor_ms=floor_ms)
            for w in order:
                A.FLASH._fn = fns[w]
                times[w][name].append(C.device_ms(lambda: A.flash_attention(q, k, v, causal=causal), 50,
                                                  floor_ms=floor_ms, launches=1))
    finally:
        A.FLASH._fn = None
    print(f"every variant but the diagnostic cuts agrees with the plain version (tol {C.ATOL}+{C.RTOL}|ref|)",
          flush=True)
    print("SDPA: " + "; ".join(f"{s} {t:.5f} ms" for s, t in sdpa.items()) + f" [{card}]", flush=True)
    for w in args.variants:
        print(f"{w}: " + "; ".join(
            f"{s} {sum(t) / len(t):.5f} ms ({' / '.join(f'{x:.5f}' for x in t)}, {sum(t) / len(t) / sdpa[s]:.2f}x SDPA)"
            for s, t in times[w].items()) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
