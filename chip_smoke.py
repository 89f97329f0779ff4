#!/usr/bin/env python3
"""On-card smoke test of lumen_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every CUDA kernel of the serving path (one ``nvcc`` per
   source, all started together).
2. kernels vs plain: each kernel against its plain PyTorch version on the
   same seeded inputs, at the serving path's shapes plus ragged cases,
   with times for the kernel, the plain version, the card's bound and
   one PyTorch library call computing the same function (a yardstick
   only; the port never calls it).
3. reference: a small fp32 VLM served on the card (kernels) and on the
   CPU (plain versions) gives the same greedy tokens.
4. serving path at full width: ``VLMConfig()`` (Qwen2-0.5B decoder +
   1024/64 ViT, seeded random weights, bf16) behind ``VLMManager`` on the
   paged continuous engine; concurrent caption requests, streaming and
   late-arriving ones included. Launch counts are zeroed just before and
   read just after: every kernel must have run. Greedy determinism is
   checked by repeating a request.

The last two lines are the kernel table (JSON) and the device line the
harness reads; the card's name and power limit precede them.
"""

from __future__ import annotations

import argparse
import json
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
}


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


def check_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from lumen_tpu_torch.ops import attention as A

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf16 = torch.bfloat16

    def rnd(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def f32(*ts):
        return [t.float() for t in ts]

    rows = {}

    # flash_attention: the vision tower's [1, 12, 256, 64] bidirectional
    # call, then causal cases with lengths off the 64/32 tiles.
    errs = []
    for b, h, sq, sk, causal in ((1, 12, 256, 256, False), (2, 14, 77, 77, True), (1, 14, 50, 130, True)):
        q, k, v = rnd(b, h, sq, 64), rnd(b, h, sk, 64), rnd(b, h, sk, 64)
        out = A.flash_attention(q, k, v, causal=causal)
        ref = A.attention_reference(*f32(q, k, v), causal=causal)
        errs.append(max_err(out, ref))
    q, k, v = rnd(1, 12, 256, 64), rnd(1, 12, 256, 64), rnd(1, 12, 256, 64)
    nb = 4 * q.numel() * 2
    fl = 4 * 12 * 256 * 256 * 64
    bms, by = bound(nb, fl, "bfloat16")
    rows["flash_attention"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: A.flash_attention(q, k, v), 50),
        plain_ms=cuda_ms(lambda: A.attention_reference(q, k, v), 20),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50),
    )

    # flash_attention_cache: the chunk lane's two chunks of a caption
    # prompt (265 live tokens, bucket span 319) against its 832-slot
    # scratch, and a ragged two-row batch.
    errs = []
    cases = (
        (1, 256, [0], [256]),
        (1, 63, [256], [265]),
        (2, 256, [0, 256], [256, 300]),
    )
    for b, sq, offs, valid in cases:
        q, k, v = rnd(b, 14, sq, 64), rnd(b, 14, 832, 64), rnd(b, 14, 832, 64)
        qo = torch.tensor(offs, device=dev, dtype=torch.int32)
        kv = torch.tensor(valid, device=dev, dtype=torch.int32)
        out = A.flash_attention_cache(q, k, v, qo, kv)
        ref = A._decode_masked(*f32(q, k, v), qo, kv)
        errs.append(max_err(out, ref))
    q, k, v = rnd(1, 14, 256, 64), rnd(1, 14, 832, 64), rnd(1, 14, 832, 64)
    qo = torch.tensor([0], device=dev, dtype=torch.int32)
    kv = torch.tensor([256], device=dev, dtype=torch.int32)
    pairs = 256 * 257 // 2  # visible (query, key) pairs of the first chunk
    nb = 2 * q.numel() * 2 + 2 * 14 * 256 * 64 * 2  # q, out, live K/V slots
    bms, by = bound(nb, 4 * 14 * 64 * pairs, "bfloat16")
    slots = torch.arange(832, device=dev)
    mask = ((slots[None, :] < 256) & (slots[None, :] <= torch.arange(256, device=dev)[:, None]))[None, None]
    rows["flash_attention_cache"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: A.flash_attention_cache(q, k, v, qo, kv), 50),
        plain_ms=cuda_ms(lambda: A._decode_masked(q, k, v, qo, kv), 20),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 50),
    )

    # paged_attention: 8 decode rows over a 1025-page pool, ragged
    # lengths (one token, exactly one page, partial last pages, a long
    # row), tables padded with the dump page and stale page ids.
    pages = 1025
    kp, vp = rnd(pages, 2, 16, 64), rnd(pages, 2, 16, 64)
    lens = [1, 16, 17, 300, 333, 129, 64, 500]
    maxp = 32
    perm = torch.randperm(pages - 1, generator=gen, device=dev)[: 8 * maxp].reshape(8, maxp) + 1
    bt = perm.to(torch.int32)
    for r, n in enumerate(lens):
        live = -(-n // 16)
        if r % 2:
            bt[r, live:] = 0  # dump page
    kl = torch.tensor(lens, device=dev, dtype=torch.int32)
    q = rnd(8, 14, 64)
    out = A.paged_attention_kernel(q, kp, vp, bt, kl)
    ref = A.paged_attention_reference(*f32(q, kp, vp), bt, kl)
    err = max_err(out, ref)
    total = sum(lens)
    nb = 2 * q.numel() * 2 + bt.numel() * 4 + kl.numel() * 4 + 2 * total * 2 * 64 * 2
    bms, by = bound(nb, 4 * 14 * 64 * total, "bfloat16")
    rows["paged_attention"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: A.paged_attention_kernel(q, kp, vp, bt, kl), 100),
        plain_ms=cuda_ms(lambda: A.paged_attention_reference(q, kp, vp, bt, kl), 20),
        bound_ms=bms, bound_by=by, library_ms=None,
    )
    for name, row in rows.items():
        log(
            f"kernel {name}: max|diff| {row['max_abs_err']:.3e} (tol {ATOL}+{RTOL}|ref|), "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), library "
            + ("n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms")
        )
    return rows


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
    the card and on the CPU from the same weights: same greedy tokens."""
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
    outs = {}
    for device in ("cuda:0", "cpu"):
        mgr = VLMManager(
            cfg, model.state_dict(), tok, device=device, dtype="float32", max_seq=256,
            max_new_cap=24, prefill_buckets=(16, 32), pool_pages=33, prefill_chunk=32,
        )
        try:
            outs[device] = [mgr.generate(m, p, max_new_tokens=24).tokens for m, p in zip(msgs, pixels)]
        finally:
            mgr.close()
    if outs["cuda:0"] != outs["cpu"]:
        raise AssertionError(f"card and CPU disagree: {outs}")
    log(f"reference: small fp32 VLM, card == CPU greedy tokens ({[len(t) for t in outs['cpu']]} tokens)")


# -- phase 4: the serving path at full width --------------------------------


def drive_serving(seed: int, card: str, cfg=None, device: str = "cuda:0") -> dict:
    """Phase 4; returns each kernel's launch count during the drive.
    ``cfg``/``device`` let the CPU tests rehearse the drive at a small
    configuration (it then stops at the launch-count check)."""
    import numpy as np
    import torch

    from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, VLMModel, init_random_
    from lumen_tpu_torch.ops.attention import KERNELS

    cfg = cfg or VLMConfig()
    t0 = time.perf_counter()
    with torch.device(device):
        model = VLMModel(cfg)
    init_random_(model, seed)
    state = model.to(torch.bfloat16).state_dict()
    tok = WordTokenizer(cfg.decoder.vocab_size, {})
    mgr = VLMManager(
        cfg, state, tok, device=device, dtype="bfloat16", max_seq=2048,
        gen_slots=8, gen_block=8, page_size=16, pool_pages=8 * 2048 // 16 + 1, prefill_chunk=256,
    )
    log(f"serving: VLMConfig() built in {time.perf_counter() - t0:.1f} s, kv {mgr.kv_layout()}")
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def request(i: int):
        pixels = rng.integers(0, 256, (size, size, 3), np.uint8)
        return [ChatMessage("user", f"Describe image {i} in one detailed sentence.")], pixels, 32 + 4 * (i % 9)

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

        for k in KERNELS:
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
        while mgr.engine.blocks_run == 0 and time.perf_counter() < deadline and not errors:
            time.sleep(0.005)
        if mgr.engine.blocks_run == 0:
            raise AssertionError("decoding never started")
        late = [threading.Thread(target=run, args=(i, i in stream_ids)) for i in (8, 9)]
        for t in late:
            t.start()
        for t in threads + late:
            t.join(timeout=600)
        wall = time.perf_counter() - t_start
        launches = {k.name: k.launches for k in KERNELS}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if errors:
            raise errors[0]
        if len(results) != 10:
            raise AssertionError(f"only {len(results)} of 10 requests answered")
        for i, r in results.items():
            if not 1 <= r["n"] <= r["budget"]:
                raise AssertionError(f"request {i}: {r['n']} tokens for a budget of {r['budget']}")
            if r["tokens"] is not None and not all(0 <= t < cfg.decoder.vocab_size for t in r["tokens"]):
                raise AssertionError(f"request {i}: token id out of range")
        missing = [name for name, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"serving path never launched: {missing} (launches {launches})")
        total = sum(r["n"] for r in results.values())
        ttfts = sorted(r["ttft_ms"] for r in results.values() if r.get("ttft_ms") is not None)
        log(f"serving: 10 requests (8 at once, 2 after decoding started; {len(stream_ids)} streaming), "
            f"{total} tokens in {wall:.3f} s = {total / wall:.1f} tok/s aggregate [{card}]")
        log(f"serving: ttft_ms of streams {ttfts} [{card}]")
        log(f"serving: peak device memory {peak / 2**30:.3f} GiB [{card}]")
        log(f"serving: launches {json.dumps(launches)}; engine blocks {mgr.engine.blocks_run}, "
            f"chunks {mgr.engine.chunks_run}, preemptions {mgr.engine.preemptions}")
        # Greedy determinism: request 0 again, alone.
        m, p, n = reqs[0]
        again = mgr.generate(m, p, max_new_tokens=n).tokens
        if again != results[0]["tokens"]:
            raise AssertionError("greedy request repeated gave different tokens")
        log("serving: greedy repeat gives identical tokens")
        stats = mgr.engine.kv.stats()
        if stats.pages_live != 0:
            raise AssertionError(f"pages still live after drain: {stats}")
        return launches
    finally:
        mgr.close()


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
    from lumen_tpu_torch.ops.attention import KERNELS
    from lumen_tpu_torch.ops.cuda_build import build_all

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build_all(KERNELS)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    rows = check_kernels(args.seed)
    check_reference(args.seed)
    launches = drive_serving(args.seed, card)

    table = []
    for k in KERNELS:
        source, replaces = SOURCES[k.name]
        row = rows[k.name]
        table.append(dict(
            name=k.name, route="cuda", source=source, replaces=replaces,
            launches=launches[k.name], max_abs_err=row["max_abs_err"], ms=row["ms"],
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
