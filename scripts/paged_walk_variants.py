#!/usr/bin/env python3
"""Variants of the paged walk (``paged_attention`` and
``paged_attention_varq``), timed in turns on one NVIDIA GPU at the decode
path's shapes, warm and from device memory.

``csrc/paged_walk.cuh`` fixes the plan of a call from (group, head_dim,
window, dtype): ``PagedShape<T, D>``'s span, KV-head rows a slot, query
rows a block and warps a block. This script builds both paged libraries
once per variant from a rewritten copy of ``csrc/`` (the repository's own
build stays untouched), checks each variant against the plain versions at
every shape, and times each with ``chip_smoke.device_ms`` (device time per
call from ``torch.profiler``) in turns: A, B, ..., B, A -- once on one set
of inputs (warm: K/V stay in the 50 MB L2 from call to call) and once
cycled over ``chip_smoke.paged_sets`` (disjoint pages whose live K/V pass
the L2, read from device memory as a decode step's layers find them). A
variant is ``base`` (this checkout) or settings joined by ``+``:

- ``NAME=VALUE``: a ``constexpr int NAME`` of the header
  (``kPagedRowGroup=2``: two query rows a thread of the FMA path);
- ``bf16_64=S/H/R/W`` (also ``bf16_128``, ``fp16_64``, ``fp16_128``, ``fp32_64``,
  ``fp32_128``):
  ``PagedShape``'s span, KV-head rows, rows a block and warps a block;
- ``src=DIR``: build from ``DIR`` instead of this checkout's ``csrc/``
  (another checkout's, e.g. the parent commit's, unpacked with ``git
  archive`` into a directory ``.gitignore`` lists); the kernels are called
  through their C entry points with a workspace and counters large enough
  for either layout, so a parent with another workspace layout runs too;
- ``patch=NAME``: a rewrite of this checkout's header (``PATCHES``):
  ``pv2`` (two P.V chains a dimension on the FMA path), ``keys2`` (two
  keys a scores item on the FMA path) and ``merge8`` (merge items of 8
  dimensions), measured and not kept; the diagnostic
  cuts ``noload`` (no K/V copy), ``nocompute`` (no query row scored) and
  ``nomerge`` (partials stored, no merge) leave garbage, so they are
  timed but not checked.

A variant of this checkout (not ``src=``) is also held to the greedy
identity: every slot t of a verify call equals the decode kernel at
``kv_lens + t``, bit for bit.

Run from the repository root:

    python3 scripts/paged_walk_variants.py [--variants base src=build/parent/lumen_tpu_torch/csrc ...] \\
        [--shapes "hd64 decode" ...] [--seed 0]
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
#: (row lengths, window (0: the decode kernel), heads, kv_heads, head_dim, maxp):
#: chip_smoke.py phase 2's paged shapes and the engine's widest window
SHAPES = {
    "hd64 decode": ([1, 16, 17, 300, 333, 129, 64, 500], 0, 14, 2, 64, 32),
    "hd64 verify W=5": ([1, 16, 15, 300, 333, 129, 62, 500], 5, 14, 2, 64, 34),
    "hd64 verify W=16": ([1, 16, 15, 300, 333, 129, 62, 500], 16, 14, 2, 64, 34),
    "hd128 decode": ([1, 16, 17, 300, 333, 129, 64, 500], 0, 16, 16, 128, 32),
    "hd128 verify W=5": ([1, 16, 15, 300, 333, 129, 62, 500], 5, 16, 16, 128, 34),
}

#: rewrites of paged_walk.cuh: [(text, replacement), ...]
PATCHES = {
    "noload": [("        cp_async_16(kd + (size_t)kh * S * ROW, k_pages + o_kh, p >= 0);\n"
                "        cp_async_16(vd + (size_t)kh * S * ROW, v_pages + o_kh, p >= 0);\n", "")],
    "nocompute": [("    for (int mt = warp; mt * 16 < rows; mt += nwarps) {",
                   "    for (int mt = rows; mt * 16 < rows; mt += nwarps) {"),
                  ("    for (int it = tid; it < nkh * ngroups * S; it += nthreads) {",
                   "    for (int it = nkh * ngroups * S; it < nkh * ngroups * S; it += nthreads) {"),
                  ("    for (int r = warp; r < rows; r += nwarps) {", "    for (int r = rows; r < rows; r += nwarps) {"),
                  ("    for (int it = tid; it < nkh * ngroups * (D / 2); it += nthreads) {",
                   "    for (int it = nkh * ngroups * (D / 2); it < nkh * ngroups * (D / 2); it += nthreads) {")],
    "nomerge": [("  if (nlive_hi == 1) return;\n", "  return;\n")],
    # FMA path: two P.V chains a dimension (even and odd keys), added at the end
    "pv2": [
        ("      float acc[NR][2];\n#pragma unroll\n      for (int g4 = 0; g4 < NR; ++g4) acc[g4][0] = acc[g4][1] = 0.f;\n",
         "      float acc[NR][2], acc2[NR][2];\n#pragma unroll\n"
         "      for (int g4 = 0; g4 < NR; ++g4) acc[g4][0] = acc[g4][1] = acc2[g4][0] = acc2[g4][1] = 0.f;\n"),
        ("            for (int e = 0; e < 2; ++e) acc[g4][e] = fmaf(pj[u], vf[u][e], acc[g4][e]);\n",
         "            for (int e = 0; e < 2; ++e) (u % 2 ? acc2 : acc)[g4][e] = fmaf(pj[u], vf[u][e], (u % 2 ? acc2 : acc)[g4][e]);\n"),
        ("        const float m = sML[2 * r], l = sML[2 * r + 1];\n",
         "        acc[g4][0] = __fadd_rn(acc[g4][0], acc2[g4][0]);\n        acc[g4][1] = __fadd_rn(acc[g4][1], acc2[g4][1]);\n"
         "        const float m = sML[2 * r], l = sML[2 * r + 1];\n"),
    ],
    # merge items of 8 dimensions (two float4 loads a span), one a thread
    "merge8": [
        ("  for (int idx = tid; idx < rows * (D / 4); idx += nthreads) {\n    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;\n",
         "  for (int idx = tid; idx < rows * (D / 8); idx += nthreads) {\n    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;\n"),
        ("    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);\n    auto add = [&](float2 mls, float4 as) {\n",
         "    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), a2 = a;\n    auto add = [&](float2 mls, float4 as, float4 as2) {\n"),
        ("      a.w = fmaf(as.w, f, a.w);\n    };\n",
         "      a.w = fmaf(as.w, f, a.w);\n      a2.x = fmaf(as2.x, f, a2.x);\n      a2.y = fmaf(as2.y, f, a2.y);\n"
         "      a2.z = fmaf(as2.z, f, a2.z);\n      a2.w = fmaf(as2.w, f, a2.w);\n    };\n"),
        ("      float4 as[U];\n", "      float4 as[U], as2[U];\n"),
        ("          as[u] = __ldcg(reinterpret_cast<const float4*>(ac + (size_t)u * D));\n",
         "          as[u] = __ldcg(reinterpret_cast<const float4*>(ac + (size_t)u * D));\n"
         "          as2[u] = __ldcg(reinterpret_cast<const float4*>(ac + (size_t)u * D + 4));\n"),
        ("        if (u < nl) add(mls[u], as[u]);\n", "        if (u < nl) add(mls[u], as[u], as2[u]);\n"),
        ("            __ldcg(reinterpret_cast<const float4*>(ac + (size_t)s2 * D)));\n",
         "            __ldcg(reinterpret_cast<const float4*>(ac + (size_t)s2 * D)),\n"
         "            __ldcg(reinterpret_cast<const float4*>(ac + (size_t)s2 * D + 4)));\n"),
        ("    out[3] = from_f<T>(__fdiv_rn(a.w, lsum));\n",
         "    out[3] = from_f<T>(__fdiv_rn(a.w, lsum));\n    out[4] = from_f<T>(__fdiv_rn(a2.x, lsum));\n"
         "    out[5] = from_f<T>(__fdiv_rn(a2.y, lsum));\n    out[6] = from_f<T>(__fdiv_rn(a2.z, lsum));\n"
         "    out[7] = from_f<T>(__fdiv_rn(a2.w, lsum));\n"),
        ("  const int merge = (p.rows * (D / 4) + 31) / 32;", "  const int merge = (p.rows * (D / 8) + 31) / 32;"),
    ],
}
#: FMA path: two keys a scores item (j and j + S / 2), the query loads
#: serving both
_KEYS2_SCORES = """    // Scores: item (head, row group, KI keys: j, j + S / KI, ...); NR =
    // the group's rows. A query load serves the item's KI keys.
    constexpr int KI = 2;
    static_assert(S % (32 * KI) == 0, "keys an item");
    auto score = [&](auto nr_c, int r0, const T* kbase, int j0) {
      constexpr int NR = decltype(nr_c)::value;
      float c[KI][NR][4];
#pragma unroll
      for (int k = 0; k < KI; ++k)
#pragma unroll
        for (int g4 = 0; g4 < NR; ++g4)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[k][g4][e] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kf[KI][8];
#pragma unroll
        for (int k = 0; k < KI; ++k) load8(kbase + (size_t)(j0 + k * (S / KI)) * ROW + d0, kf[k]);
#pragma unroll
        for (int g4 = 0; g4 < NR; ++g4) {
          const float* qrow = sQ + (size_t)(r0 + g4) * D + d0;
          const float4 qa = *reinterpret_cast<const float4*>(qrow);
          const float4 qb = *reinterpret_cast<const float4*>(qrow + 4);
#pragma unroll
          for (int k = 0; k < KI; ++k) {
            c[k][g4][0] = fmaf(qa.x, kf[k][0], c[k][g4][0]);
            c[k][g4][1] = fmaf(qa.y, kf[k][1], c[k][g4][1]);
            c[k][g4][2] = fmaf(qa.z, kf[k][2], c[k][g4][2]);
            c[k][g4][3] = fmaf(qa.w, kf[k][3], c[k][g4][3]);
            c[k][g4][0] = fmaf(qb.x, kf[k][4], c[k][g4][0]);
            c[k][g4][1] = fmaf(qb.y, kf[k][5], c[k][g4][1]);
            c[k][g4][2] = fmaf(qb.z, kf[k][6], c[k][g4][2]);
            c[k][g4][3] = fmaf(qb.w, kf[k][7], c[k][g4][3]);
          }
        }
      }
#pragma unroll
      for (int g4 = 0; g4 < NR; ++g4) {
        const int n = live_keys(r0 + g4);
#pragma unroll
        for (int k = 0; k < KI; ++k) {
          const int j = j0 + k * (S / KI);
          const float dot = __fadd_rn(__fadd_rn(c[k][g4][0], c[k][g4][1]), __fadd_rn(c[k][g4][2], c[k][g4][3]));
          sS[(size_t)(r0 + g4) * S + j] = j < n ? __fmul_rn(dot, scale) : kNegInf;
        }
      }
    };
    for (int it = tid; it < nkh * ngroups * (S / KI); it += nthreads) {
      const int j0 = it % (S / KI), rg = it / (S / KI) % ngroups, kh = it / ((S / KI) * ngroups);
      int r0;
      const int nr = group_rows(kh, rg, &r0);
      const T* kbase = sK + (size_t)kh * S * ROW;
      if (nr == RG) score(PagedInt<RG>{}, r0, kbase, j0);
      else if (nr == 1) score(PagedInt<1>{}, r0, kbase, j0);
      else if (nr == 2) score(PagedInt<(RG > 2 ? 2 : 1)>{}, r0, kbase, j0);
      else score(PagedInt<(RG > 3 ? 3 : 1)>{}, r0, kbase, j0);
    }
"""


def _keys2(text: str) -> str:
    start = text.index("    // Scores: item (head, row group, key);")
    end = text.index("    __syncthreads();\n    // The span's max and sum: a warp a row")
    items = "  const int items = p.kv_heads * groups * (Shape::kSpan > D / 2 ? Shape::kSpan : D / 2);"
    if text.count(items) != 1:
        return text
    text = text[:start] + _KEYS2_SCORES + text[end:]
    return text.replace(items, "  const int items = p.kv_heads * groups * (Shape::kSpan / 2 > D / 2 ? Shape::kSpan / 2 : D / 2);")


PATCHES["keys2"] = _keys2
DIAGNOSTIC = {"noload", "nocompute", "nomerge"}
_TYPES = {"bf16": "__nv_bfloat16", "fp16": "__half", "fp32": "float"}


def rewrite(text: str, setting: str) -> str:
    """``paged_walk.cuh`` with one setting applied."""
    name, value = setting.split("=")
    if name == "patch" and callable(PATCHES[value]):
        new = PATCHES[value](text)
        n = int(new != text)
        text = new
    elif name == "patch":
        n = 1
        for old, new in PATCHES[value]:
            if (n := text.count(old)) != 1:
                break
            text = text.replace(old, new)
    elif m := re.fullmatch(r"(bf16|fp16|fp32)_(\d+)", name):
        s, h, r, w = value.split("/")
        pattern = (rf"(struct PagedShape<{_TYPES[m[1]]}, {m[2]}> \{{\s*static constexpr int )"
                   r"kSpan = \d+, kHeadRows = \d+, kRows = \d+, kWarps = \d+;")
        text, n = re.subn(pattern, rf"\g<1>kSpan = {s}, kHeadRows = {h}, kRows = {r}, kWarps = {w};", text)
    else:
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", text)
    if n != 1:
        raise RuntimeError(f"{setting}: not found in paged_walk.cuh")
    return text


def build_variants(variants: list[str]) -> tuple[dict, dict]:
    """({variant: {"decode": fn, "verify": fn}}, {library: ptxas log}),
    built from rewritten copies of csrc/ under build/paged_walk_variants/."""
    from lumen_tpu_torch.ops import attention as A
    from lumen_tpu_torch.ops.cuda_build import CSRC, NVCC_FLAGS, _nvcc

    out = ROOT / "build" / "paged_walk_variants"
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
        header = src / "paged_walk.cuh"
        for s in settings:
            if not s.startswith("src="):
                header.write_text(rewrite(header.read_text(), s))
        for role, k in (("decode", A.PAGED), ("verify", A.PAGED_VARQ)):
            lib = src / f"{k.source}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(src), "-o", str(lib), str(src / f"{k.source}.cu")]
            procs.append((w, role, k, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                            text=True)))
    fns: dict = {w: {} for w in variants}
    logs = {}
    for w, role, k, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {k.source} at {w}:\n{text}")
        logs[f"{w} {k.source}"] = text
        fn = getattr(ctypes.CDLL(str(lib)), k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        fns[w][role] = fn
    return fns, logs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", default=["base"])
    parser.add_argument("--shapes", nargs="+", default=list(SHAPES), help=f"of {list(SHAPES)}")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("paged_walk_variants.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from lumen_tpu_torch.ops import attention as A

    card = C.card_line()
    print(f"card: {card}", flush=True)
    fns, logs = build_variants(args.variants)
    for r in C.ptxas_report(logs):
        print(f"  ptxas {r['lib']}: {r['func']}: {r['registers']} registers, {r['smem']} B smem, "
              f"{r['spill_stores']} / {r['spill_loads']} B spill stores / loads", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    bf16 = torch.bfloat16
    page = 16
    # Workspace and counters large enough for any layout: a partial of
    # head_dim + 2 floats for each of 8 head slots a KV head (or each query
    # row), window slot and 16-key span of the table.
    counters = torch.zeros(1 << 16, dtype=torch.int32, device=dev)

    def launch(fn, window, q, kp, vp, bt, kl, ws):
        b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
        kvh, maxp = kp.shape[1], bt.shape[1]
        out = torch.empty_like(q)
        head = [q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(), kl.data_ptr(), out.data_ptr(),
                ws.data_ptr(), counters.data_ptr(), b]
        tail = [h, kvh, page, maxp, d, 1, 1.0 / d ** 0.5, torch.cuda.current_stream().cuda_stream]
        rc = fn(*head, *([window] if window else []), *tail)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out

    calls = {}
    for name in args.shapes:
        lens, window, h, kvh, d, maxp = SHAPES[name]
        w = max(window, 1)
        q_shape = (8, window, h, d) if window else (8, h, d)
        kl = torch.tensor(lens, device=dev, dtype=torch.int32)
        kp, vp, sets = C.paged_sets(gen, lens, q_shape, maxp, kvh, bf16)
        ws = torch.empty(8 * w * max(h, 8 * kvh) * -(-maxp * page // 16) * (d + 2), dtype=torch.float32, device=dev)
        live = sum(n + w - 1 for n in lens)
        seen = sum(n + t for n in lens for t in range(w))
        nb = 2 * sets[0][0].numel() * 2 + sets[0][1].numel() * 4 + kl.numel() * 4 + 2 * live * kvh * d * 2
        bms, _ = C.bound(nb, 4 * h * d * seen, "bfloat16")
        calls[name] = (window, kp, vp, sets, kl, ws, bms)
    order = args.variants + args.variants[::-1]
    times: dict = {w: {s: {"warm": [], "hbm": []} for s in calls} for w in args.variants}
    for w in args.variants:
        if any(f"patch={p}" in w for p in DIAGNOSTIC):
            continue
        for name, (window, kp, vp, sets, kl, ws, _) in calls.items():
            q, bt = sets[0]
            ref = (A.paged_attention_varq_reference if window else A.paged_attention_reference)(
                q.float(), kp.float(), vp.float(), bt, kl)
            out = launch(fns[w]["verify" if window else "decode"], window, q, kp, vp, bt, kl, ws)
            C.max_err(out, ref)
            del ref
            if window and not w.startswith("src="):  # slot t is the decode kernel at kv_lens + t, bitwise
                for t in range(window):
                    one = launch(fns[w]["decode"], 0, q[:, t].contiguous(), kp, vp, bt, kl + t, ws)
                    if not torch.equal(out[:, t], one):
                        raise AssertionError(f"{w} {name}: slot {t} differs from the decode kernel at kv_lens + {t}")
    if int(counters.abs().sum()):
        raise AssertionError("a variant left its merge counters non-zero")
    for name, (window, kp, vp, sets, kl, ws, bms) in calls.items():
        for w in order:
            fn = fns[w]["verify" if window else "decode"]
            q, bt = sets[0]
            times[w][name]["warm"].append(C.device_ms(
                lambda: launch(fn, window, q, kp, vp, bt, kl, ws), 100, floor_ms=bms, launches=1))
            times[w][name]["hbm"].append(C.device_ms(
                lambda q, bt: launch(fn, window, q, kp, vp, bt, kl, ws), 100, args=sets, floor_ms=bms, launches=1))
    print(f"every variant but the diagnostic cuts agrees with the plain versions (tol {C.ATOL}+{C.RTOL}|ref|); "
          "a verify slot t of this checkout's variants is the decode kernel at kv_lens + t bit for bit", flush=True)
    for name, (window, kp, vp, sets, kl, ws, bms) in calls.items():
        print(f"{name}: bound {bms:.5f} ms; {len(sets)} disjoint sets of pages cycled from device memory", flush=True)
    for w in args.variants:
        print(f"{w}: " + "; ".join(
            f"{s} warm {sum(t['warm']) / len(t['warm']):.5f} ms ({' / '.join(f'{x:.5f}' for x in t['warm'])}), "
            f"HBM {sum(t['hbm']) / len(t['hbm']):.5f} ms ({' / '.join(f'{x:.5f}' for x in t['hbm'])})"
            for s, t in times[w].items()) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
