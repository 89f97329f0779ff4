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
   (the three bf16 flash kernels -- head_dim 64 and 16, and the cache
   kernel -- must have some).
2. kernels vs plain: each kernel against its plain PyTorch version on the
   same seeded inputs, at the serving path's shapes plus ragged cases
   (for the flash kernels: lengths and ``kv_valid`` on either side of the
   64-key tile, causal diagonals crossing a tile, two-row batches, the
   fp32 instance, phase 8's CLIP calls at the bulk batch of 64: the
   vision tower's [64, 12, 50, 64] and the causal text tower's
   [64, 8, 77, 64], and phase 10's native OCR recognizer at head_dim 16:
   [8, 4, 960, 16] and [32, 4, 1920, 16] in bf16, [2, 4, 240, 16] in fp32,
   causal cases, and head_dims 32/80/128 refused), with times for the
   kernel, the plain version, the
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
7. the JAX server's default serving path: phase 6's model directory
   behind one bf16 ``serve()`` with the spill tier at its default, the
   result cache, breaker and quarantine, the metrics sidecar and a 64 MiB
   prefix cache (``LUMEN_VLM_PREFIX_BYTES``), on a KV pool pinned small
   enough that rows must preempt. Over gRPC: (a) 6 greedy and 2 sampled
   streams, which must preempt, spill and resume with no stream failed,
   the greedy answers equal to themselves rerun alone and to phase 6's;
   (b) one photo asked three questions, cold and then in two waves: prefix
   hits, fewer prefill chunks, equal answers, ``prefix_hit`` in the
   metadata; (c) a ``vlm_generate`` sent twice: the second ``cached``,
   equal, with no kernel launch; (d) ``/metrics.json`` lists the ``vlm_*``
   counters, the ``vlm-continuous:*`` gauges and the ``vlm.ttft``
   histogram, and ``Health`` carries ``lumen-breaker-status``. Then a
   spill round trip at the full-width pool shapes: export a row, resume
   it into another grant, export again: byte-equal payloads. The path's
   three kernels must run in (a)-(b).
8. CLIP embeddings and zero-shot labels as users reach them: a
   ``CLIPConfig()`` model directory (OpenAI ViT-B/32 shapes, seeded bf16
   weights under the HF ``CLIPModel`` names, a 49,408-id WordLevel
   tokenizer whose EOT id is 49407, a dataset of 1,000 labels and no
   ``.npy``, so the server embeds them at start-up through the causal text
   tower) served by ``serve()`` with ``batch_size: 64`` and warm-up on.
   Over gRPC: (a) 128 distinct 1600x1200 JPEGs through ``clip_image_embed``,
   64 in flight, decoded by the decode pool in its default mode; (b) 32
   ``clip_text_embed``; (c) 8 ``clip_classify`` (top 5) and 4
   ``clip_scene_classify``; (d) photo 0 again (a result-cache answer, no
   launch) and as a ``tensor/raw`` payload of its pixels, alone; (e) a
   malformed image (``INVALID_ARGUMENT``); (f) a hub of ``clip`` + ``vlm``
   (phase 6's directory): 4 caption streams while 32 photos embed. Every
   embedding is finite and unit-norm and within ``CLIP_COSINE`` of a direct
   ``CLIPModel`` on the card run with the plain attention (same weights,
   same pixels); the hub's captions equal phase 6's; the flash kernel runs
   in every block of both towers; after the hub stops, its batcher and
   engine threads and the decode pool's workers are gone.

9. face and graph CLIP as users reach them (no hand-written kernel lies on
   the face path or the ONNX bridge; the checks run the convolutions in
   IEEE float32, and (a) times a detector batch with TF32 too): (a) the
   ``buffalo_l`` pack's stand-ins (``lumen_tpu_torch/testing/
   face_standins.py``: the det_10g contract at 640x640, IResNet-50 at
   112x112, seeded weights and BN statistics, score heads calibrated to a
   sparse set) exported to ONNX on the CPU and served by ``serve()`` at
   ``batch_size: 16``: 32 photos through ``face_detect`` at 16 in flight,
   ``face_detect_and_embed``, ``face_embed`` with and without landmarks,
   and ``tensor/raw`` photos, every detection matched one to one (IoU >=
   ``FACE_IOU``) and every embedding within ``FACE_COSINE`` of the
   stand-ins run directly on the card (same pixels, a numpy decode of the
   raw outputs), bridge params and outputs on the card; load time,
   photos/s, client p50/p95, batch fill, one detector and one embedder
   batch timed with CUDA events, NMS launches and host ms, device-to-host
   syncs per forward, peak memory; (b) native ``DetectorConfig()`` /
   ``IResNetConfig()`` checkpoints held against the port's own CPU run of
   the same manager; (c) phase 8's ViT-B/32 exported to ONNX and served
   from an export-only directory with ``quantize: int8`` (ignored, with
   the warning) against phase 8's answers (``CLIP_COSINE``); (d) a hub of
   clip (native) + face: faces as (a)'s, embeddings as phase 8's, the
   flash kernel launched; after stop the batcher threads and decode
   workers are gone.

10. OCR as users reach it, and the full tier: (a) the ``PP-OCRv5_mobile``
   pack's stand-ins (``lumen_tpu_torch/testing/ocr_standins.py``: det,
   rec and cls graphs at the published contracts, seeded, BN statistics
   fit to synthetic pages and heads calibrated) exported to ONNX on the
   CPU and served by ``serve()`` from the YAML block ``config_gen`` writes
   for ``ocr`` (``batch_size: 8``, ``batch_buckets: [320, 640, 960]``): 32
   distinct 1280x960 JPEG pages of text lines at 8 in flight, 8 of them
   with ``use_angle_cls`` (a share of each page's lines turned 180
   degrees), timed with TF32 convolutions and held to ``OcrReference``
   (the stand-ins run directly in IEEE float32, the host steps written
   from the reference's algorithm) up to ``OCR_TF32_*``, then held
   strictly in IEEE float32 (every box at IoU >= ``OCR_IOU``, texts
   equal), with ``tensor/raw`` pages and the classifier off; each page is
   asked at thresholds in gaps of its reference's values; load time,
   pages/s, client p50/p95, one detector call and one recognizer chunk
   (CUDA events), host postprocess ms, syncs per forward, peak memory;
   (b) native ``DBNetConfig()`` + ``SVTRConfig()`` + ``ClsConfig()``,
   seeded and calibrated, written as native safetensors: bf16 on the
   head_dim-16 flash kernel (4 launches a recognizer chunk, exactly)
   against the port's plain path (logits within ``OCR_BF16_LOGIT_SHARE``,
   texts equal wherever the margins allow), float32 against the port's
   own CPU run; (c) the full tier: ocr, clip, face and vlm from one YAML
   in ``generate_config``'s shape over phases 6, 8, 9 and 10 (a)'s
   directories, every service healthy, each family answering as in its
   own phase, the three bf16 path kernels launched, the threads and
   decode workers gone after stop.

11. bulk ingest and search as users reach them, on (c)'s tier plus
   ``search`` from one YAML: (a) 128 distinct seeded 1600x1200 JPEGs
   (text pages, photos with bright discs, plain photos) through ``python
   -m lumen_tpu_torch.pipeline.cli`` (called in process) with
   ``--families clip,face,ocr`` at ``--batch-size 64``, then 16 of them
   again with ``vlm`` at ``--caption-max-tokens 32``, both with IEEE float32
   convolutions: every row's CLIP embedding within ``INGEST_COSINE`` of
   the served ``clip_image_embed`` of the same pixels, faces and OCR items
   matched to the served answers of the same pixels (phase 9's
   ``FACE_IOU``/``FACE_COSINE`` and score tolerance, phase 10's
   ``OCR_TF32_IOU`` with equal texts), every caption equal to the served
   ``vlm_generate``'s, the caption images decoded by the decode pool's
   ``vlm_canvas`` spec, the three bf16 path kernels launched; a warm
   re-run on the server's managers answers every photo from the result
   cache with no launch while ``index=`` upserts each embedding into the
   search service over gRPC; images/s, the stage stats, device ms of each
   stage on one 64-image batch (CUDA events), syncs, peak memory. (b)
   200,000 seeded unit vectors at dim 512 upserted through
   ``search_upsert`` in 1,024-row chunks over the default 3 shards, then
   512 ``search_query`` at k = 10 with 16 in flight held to the numpy
   oracle (recall@10 = 1.0 but for counted near-ties, scores within
   ``SEARCH_SCORE_TOL``, each photo at rank 1 of its own embedding), and
   queries during a flood of bulk upserts into one shard (appends and
   in-place updates) that see only committed states; upserted rows/s,
   query p50/p95, one scoring pass over a full shard (CUDA events).

12. every VLM and CLIP serving option of the JAX managers: (a) a
   FastVLM-style directory (phase 6's decoder; the FastViTHD stand-in of
   ``lumen_tpu_torch/testing/fastvlm_standins.py`` with its projector
   exported as ``onnx/vision_encoder.onnx`` at 1024 px, 256 tokens; no
   native vision weights) served by ``serve()`` from a YAML in
   ``generate_config``'s shape: 8 greedy ``vlm_generate`` and 2 streams of
   1600x1200 JPEGs at once, each equal to the manager's rerun alone, the
   graph tower on the card (IEEE float32) within ``GRAPH_TOWER_TOL`` of the
   stand-in module, no device-to-host sync in ``_prepare``, the tower's
   time (CUDA events), TTFT and load time; (b) ``quantize: int8`` with
   ``LUMEN_VLM_Q8_ROUTE=auto`` and warm-up on phase 6's directory: the
   A/B's two decode rates, its verdict and the peak memory across it, then
   a second boot that reads the verdict file and times nothing, routes and
   ``vlm-quant`` gauges matching the verdict; (c) ``scheduler: coalesce``
   on phase 6's directory in bf16 and int8: 8 greedy requests over the 64
   and 128 prompt buckets and 2 streams at once, each equal to its rerun
   alone through the coalescer, device-to-host syncs a decode step (at
   most 1; also counted with the per-layer ladder read the repair
   removed); (d) phase 8's ViT-B/32 with ``quantize: int8`` (W8A8) at
   batch 64: the A/B under ``LUMEN_CLIP_Q8_ROUTE=auto``, then a pinned
   int8 boot whose embeddings are within ``Q8_CLIP_COSINE`` of phase 8's
   bf16 ones. (a) must launch ``flash_attention_cache`` and
   ``paged_attention``, (c) ``flash_attention_cache`` (and ``w8a16_matmul``
   in int8), (d) ``flash_attention``; their launch counts are printed
   beside each kernel's row.

13. a disaggregated fleet on the one card: a prefill host
   (``LUMEN_FED_ROLE=prefill``) and a front tier (no service,
   ``LUMEN_FED_PEERS`` naming both backends) in processes of their own
   (the server CLI under ``--serve-host``, which reports what each launched),
   the decode host (``LUMEN_FED_ROLE=decode``) ``serve()``
   in this process, all on phase 6's directory at full width. (a) 8 greedy
   ``vlm_generate`` and 2 streams of phase 6's JPEGs through the front, 8 in
   flight (the streams first), 32 new tokens: every row's KV pages migrate
   after prefill
   (``migrated_out`` = ``migrated_in`` = 10, no fallback, no rejection), each
   answer equals the same request on one colocated host, the decode host
   launches ``flash_attention_cache`` 0 times and ``paged_attention`` more
   than 0, both hosts end with no live page; the bytes a row ships, the
   decode host's time from a commit's frame to its row admitted and from
   there to the first token, one commit frame's loopback rate, TTFT and
   tok/s migrated and colocated. (b) the decode host stops while 2 streams
   decode on it: both finish on the prefill host's ladder, equal to their
   control, no token repeated. (c) SIGTERM to the prefill host with
   ``LUMEN_DRAIN_ANNOUNCE_S``: the front records one drain handoff and no
   ``fed_peer_down`` for it. (d) two ``search`` backends behind a front hold
   50,000 seeded unit vectors at dim 512 in 8 shards (each backend the rows
   of the shards the front's ring gives it); 128 queries at k = 10 equal
   the exact oracle outside near-ties. The front tier must launch nothing and
   never initialize CUDA, and every host must exit 0 with its report.

14. the control plane as users reach it: (a) ``hardware_report()`` in a
   fresh process reports the card (``cuda``, the ``nvidia-smi`` name, one
   card) and recommends the H100 preset without a CUDA context in that
   process, and ``environment_report`` passes its torch, nvcc, driver and
   device checks; (b) the app (``lumen_tpu_torch.app``, aiohttp in process
   on a loopback port, real HTTP): ``hardware/detect``, ``config/generate``
   with that preset and ``tier: full`` into a temporary cache holding
   phases 12 (a), 9 (c), 9 (a) and 10 (a)'s stand-ins under the catalog
   names the YAML asks for (``FastVLM-0.5B``, ``MobileCLIP2-S2``,
   ``buffalo_l``, ``PP-OCRv5_mobile``), ``config/save``; ``python -m
   lumen_tpu_torch.core.cli`` ``validate``, ``list`` and ``download`` on it
   (nothing to fetch); ``install/setup`` with a venv and the model check;
   (c) ``server/start`` of the full tier under the app's ``ServerManager``
   (this script's ``--serve-host``) with ``LUMEN_COMPILE_CACHE_DIR``
   empty: healthy, then a greedy caption over gRPC, whose kernels build at
   first use, and ``/stats``' ``compile`` block counting the libraries the
   child built; (d) ``python -m lumen_tpu_torch.client``'s ``caps``,
   ``health``, ``topology``, ``embed-text``, ``embed-image``, ``faces``,
   ``ocr``, ``caption``, ``caption --stream`` and ``stats`` exit 0 with
   answers valid against their result schemas, the client's caption equal
   to that gRPC one (the result cache off), ``/api/v1/metrics`` counting
   the tasks; then ``server/restart`` from the warm directory and the same
   caption again with 0 builds, both times from start to ready and both
   first captions printed; (e) ``server/stop``: both children exit 0 and
   their readouts, read back from ``/api/v1/server/logs``, show
   ``paged_attention`` and ``flash_attention_cache`` launched.

A run with no arguments drives all fourteen phases (``--phases 13``, a
developer's shortcut, drives the listed ones and those they read, and
prints neither of the last two lines), and prints each phase's seconds.
The kernel table's launch counts are
phase 6's (the bf16 server for the bf16 path's kernels, the int8 server
for the other two), and its head_dim-16 row's phase 10 (b)'s; phases 7-11
print their own, phase 8 beside the flash kernel's two CLIP rows and
phase 10 beside its two OCR rows (timed in phase 2), phases 13 and 14
beside every kernel's row (decode and prefill hosts; the supervised full
tier). The last two lines are the
kernel table (JSON) and the device line the harness reads; the card's
name and power limit precede them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
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
    session came back with none at all, and others with a few kernels of a
    hundred calls missing. So the time of a call is each kernel's mean
    duration over the events the session kept, times the launches of that
    kernel a call (its count over ``iters``, rounded); a lost event then
    biases nothing. A session counts only if it kept, of each kernel, at
    least 90% of the events the calls launched (and no more), exactly
    ``launches`` kernels per call when given, and the time per call is not
    below ``floor_ms``, the call's bound. Otherwise it is profiled again, up to five times; then the run
    fails, or, with ``strict=False``, the reading is None: not valid, and
    never printed as a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = args or [()]
    for i in range(warmup):
        fn(*args[i % len(args)])
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*args[i % len(args)])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        per_call = {e.key: max(1, round(e.count / iters)) for e in events}
        kept = sum(e.count for e in events)
        short = [e.count for e in events if not 0.9 * per_call[e.key] * iters <= e.count <= per_call[e.key] * iters]
        ms = sum(e.self_device_time_total / e.count * per_call[e.key] for e in events) / 1e3
        if not events:
            fault = "no device events"
        elif short:
            fault = f"kernel counts {sorted(short)} not within 90-100% of a multiple of {iters} calls"
        elif launches is not None and sum(per_call.values()) != launches:
            fault = f"{sum(per_call.values())} kernels a call, not {launches}"
        elif ms < floor_ms:
            fault = f"{ms:.5f} ms a call, below the {floor_ms:.5f} ms bound"
        else:
            if kept != iters * sum(per_call.values()):
                log(f"torch.profiler kept {kept} of {iters * sum(per_call.values())} kernel events; the time is "
                    f"each kernel's mean over the events kept")
            return ms
        log(f"torch.profiler session {attempt + 1} of 5 not valid: {fault}")
    if strict:
        raise AssertionError(f"torch.profiler gave no valid session in five: {fault}")
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


def flash_tile_shape(head_dim: int = 64) -> dict:
    """Block shape of the bf16 flash tile, from the constants of
    ``csrc/flash_tile_bf16.cuh``: query rows (16 per row group), threads
    (a warp per row group and key part) and dynamic shared memory (the
    K/V ring and the Q/O rows, rows of head_dim + 8 bf16)."""
    text = (ROOT / "lumen_tpu_torch" / "csrc" / "flash_tile_bf16.cuh").read_text()
    c = {n: int(re.search(rf"constexpr int {n} = (\d+);", text)[1])
         for n in ("kFlashWarps", "kFlashSplit", "kFlashStages")}
    rows = 16 * c["kFlashWarps"]
    return dict(rows=rows, threads=32 * c["kFlashWarps"] * c["kFlashSplit"],
                smem=(2 * c["kFlashStages"] * 64 + rows) * (head_dim + 8) * 2)


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
    # The CLIP towers' calls (phase 8) at the bulk batch: the ViT-B/32
    # vision tower's 50 tokens, bidirectional, and the text tower's 77,
    # causal. Bound: q, k, v and o once; SDPA on the same call.
    for label, (b, h, s, causal) in CLIP_FLASH_SHAPES.items():
        q, k, v = rnd(b, h, s, 64), rnd(b, h, s, 64), rnd(b, h, s, 64)
        err = max_err(A.flash_attention(q, k, v, causal=causal), A.attention_reference(*f32(q, k, v), causal=causal))
        pairs = s * (s + 1) // 2 if causal else s * s
        bms, by = bound(4 * q.numel() * 2, 4 * b * h * pairs * 64, "bfloat16")
        rows[f"flash_attention ({label})"] = dict(
            max_abs_err=err,
            ms=device_ms(lambda q=q, k=k, v=v, c=causal: A.flash_attention(q, k, v, causal=c), 50, floor_ms=bms,
                         launches=1),
            plain_ms=device_ms(lambda q=q, k=k, v=v, c=causal: A.attention_reference(q, k, v, causal=c), 20,
                               floor_ms=bms),
            bound_ms=bms, bound_by=by,
            library_ms=device_ms(lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(q, k, v, is_causal=c),
                                 50, floor_ms=bms),
            blocks=-(-s // tile["rows"]) * b * h, shape=[b, h, s, 64],
        )

    # The native OCR recognizer's calls at head_dim 16 (phase 10 (b)): the
    # 320 and 640 width buckets' chunks in bf16, the 80 bucket's 240 tokens
    # in fp32 (the FMA tile: a float32 recognizer), and causal cases (SVTR
    # is bidirectional; the kernel takes both). Bound: the largest of q, k,
    # v and o once at 3.35 TB/s, the FLOPs at 989 TFLOP/s, and one exp2 a
    # (query, key) pair at EXP_PER_S, which sets it at head_dim 16.
    errs = []
    for b, h, s, causal, dt in ((2, 4, 240, False, torch.float32), (2, 4, 240, True, bf16),
                                (1, 4, 100, True, torch.float32), (3, 4, 77, False, bf16)):
        q, k, v = rnd(b, h, s, 16, dtype=dt), rnd(b, h, s, 16, dtype=dt), rnd(b, h, s, 16, dtype=dt)
        errs.append(max_err(A.flash_attention(q, k, v, causal=causal),
                            A.attention_reference(*f32(q, k, v), causal=causal)))
        pairs = s * (s + 1) // 2 if causal else s * s
        dtn = str(dt).removeprefix("torch.")
        bms, by = bound(4 * q.numel() * q.element_size(), 4 * b * h * pairs * 16, dtn)
        if b * h * pairs / EXP_PER_S * 1e3 > bms:
            bms, by = b * h * pairs / EXP_PER_S * 1e3, "operations"
        kms = device_ms(lambda q=q, k=k, v=v, c=causal: A.flash_attention(q, k, v, causal=c), 50, floor_ms=bms,
                        launches=1)
        lms = device_ms(lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(q, k, v, is_causal=c), 50,
                        floor_ms=bms)
        log(f"kernel flash_attention [{b},{h},{s},16] {dtn}{' causal' if causal else ''}: max|diff| {errs[-1]:.3e}, "
            f"kernel {kms:.4f} ms on the device, bound {bms:.5f} ms ({by}), library (SDPA) {lms:.4f} ms")
    for d in (32, 80, 128):
        try:
            A.flash_attention(*(rnd(1, 2, 8, d) for _ in range(3)))
        except ValueError:
            continue
        raise AssertionError(f"flash_attention took head_dim {d} on the card; its kernel is built for 16 and 64")
    for label, (b, h, s) in OCR_FLASH_SHAPES.items():
        q, k, v = rnd(b, h, s, 16), rnd(b, h, s, 16), rnd(b, h, s, 16)
        err = max(max(errs), max_err(A.flash_attention(q, k, v), A.attention_reference(*f32(q, k, v))))
        bms, by = bound(4 * q.numel() * 2, 4 * b * h * s * s * 16, "bfloat16")
        exp_ms = b * h * s * s / EXP_PER_S * 1e3
        if exp_ms > bms:
            bms, by = exp_ms, "operations"
        rows[f"flash_attention ({label})"] = dict(
            max_abs_err=err,
            ms=device_ms(lambda q=q, k=k, v=v: A.flash_attention(q, k, v), 50, floor_ms=bms, launches=1),
            plain_ms=device_ms(lambda q=q, k=k, v=v: A.attention_reference(q, k, v), 10, floor_ms=bms),
            bound_ms=bms, bound_by=by, bound_terms=dict(
                bytes_ms=4 * q.numel() * 2 / HBM_BYTES_PER_S * 1e3,
                flops_ms=4 * b * h * s * s * 16 / PEAK_FLOPS["bfloat16"] * 1e3, exp_ms=exp_ms),
            library_ms=device_ms(lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v), 50, floor_ms=bms),
            blocks=-(-s // tile["rows"]) * b * h, shape=[b, h, s, 16], smem=flash_tile_shape(16)["smem"],
        )
        log(f"kernel flash_attention {label} [{b},{h},{s},16]: bound terms (ms) "
            f"{json.dumps({k: round(v, 5) for k, v in rows[f'flash_attention ({label})']['bound_terms'].items()})}; "
            f"head_dims 32/80/128 raise")

    # flash_attention_cache against the 832-slot scratch: the chunk lane's
    # two chunks of a caption prompt (265 live tokens, bucket span 319), a
    # ragged two-row batch, kv_valid on either side of the 64-key tile, a
    # causal diagonal crossing a tile mid-warp, two rows with different
    # offsets, and the fp32 instance (FMA tile) on chunk 2. Then the
    # coalescer's whole-prompt prefills (phase 12 (c)): up to 8 rows of the
    # 128 bucket's 383-token span against its 896-slot buffer and of the 64
    # bucket's 319 against 832, offsets 0, live lengths uneven, in bf16 and
    # fp32; a stream's prefill into a max_seq (2048) buffer; the int8
    # route A/B's 16-token prefills (the fused decode's 88-slot buffer,
    # the engine probe's 16-slot scratch).
    errs = []
    cases = (
        (1, 256, 832, [0], [256], bf16),
        (1, 63, 832, [256], [265], bf16),
        (2, 256, 832, [0, 256], [256, 300], bf16),
        (1, 48, 832, [15], [63], bf16),
        (1, 48, 832, [16], [64], bf16),
        (1, 48, 832, [17], [65], bf16),
        (1, 48, 832, [79], [127], bf16),
        (1, 64, 832, [100], [164], bf16),
        (2, 63, 832, [256, 37], [265, 100], bf16),
        (1, 63, 832, [256], [265], torch.float32),
        (8, 383, 896, [0] * 8, [383, 265, 300, 320, 266, 383, 290, 271], bf16),
        (8, 383, 896, [0] * 8, [383, 265, 300, 320, 266, 383, 290, 271], torch.float32),
        (4, 319, 832, [0] * 4, [319, 265, 270, 300], bf16),
        (4, 319, 832, [0] * 4, [319, 265, 270, 300], torch.float32),
        (1, 319, 2048, [0], [265], bf16),
        (1, 383, 2048, [0], [330], bf16),
        (4, 16, 88, [0] * 4, [16] * 4, bf16),
        (4, 16, 16, [0] * 4, [16] * 4, bf16),
    )
    for b, sq, sk, offs, valid, dt in cases:
        q, k, v = rnd(b, 14, sq, 64, dtype=dt), rnd(b, 14, sk, 64, dtype=dt), rnd(b, 14, sk, 64, dtype=dt)
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
                  f"{row.get('smem', tile['smem'])} B dynamic shared memory)") if "blocks" in row else ""
        log(
            f"kernel {name}: max|diff| {row['max_abs_err']:.3e} (tol {ATOL}+{RTOL}|ref|), "
            f"kernel {row['ms']:.4f} ms on the device{blocks}, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), library "
            + ("n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms")
        )
    return rows


def kernel_name(mangled: str) -> str:
    """The unqualified name in an Itanium-mangled symbol, with its integer
    template argument: ``_ZN5lumen27flash_attention_bf16_kernelILi64EE...``
    -> ``flash_attention_bf16_kernel<64>``."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[i:])) is not None:
        n = int(m[0])
        name = mangled[i + len(m[0]):i + len(m[0]) + n]
        i += len(m[0]) + n
    targ = re.match(r"ILi(\d+)E", mangled[i:])
    return f"{name}<{targ[1]}>" if targ else name


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
        # (budgets of 16-48 tokens: the drive's checks need decoding under
        # way when the late requests arrive, not long answers)
        return [ChatMessage("user", text)], pixels, 16 + 4 * (i % 9)

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


def deployment_yaml(path: Path, cache_dir: Path, model: str, quantize: str | None, extra: dict | None = None) -> Path:
    """A single-service deployment naming the service in its JAX form, which
    the port's loader maps onto its own class; ``extra`` adds backend
    settings (``warmup``, ``scheduler``)."""
    settings = {"dtype": "bfloat16", "batch_size": 8, **(extra or {})}
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


def grpc_call(stub, task: str, payload: bytes, meta: dict, timeout: float = 600, mime: str = "image/jpeg") -> dict:
    """One Infer stream: its deltas, the final body (or error code), the
    final's meta and the client-side time to the first delta."""
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb

    req = pb.InferRequest(correlation_id="c", task=task, payload=bytes(payload), payload_mime=mime,
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
               code=last.error.code if last.HasField("error") else 0, mime=last.result_mime, meta=dict(last.meta))
    if not out["code"]:
        out["body"] = json.loads(last.result)
    return out


def boot_server(yaml_path: Path, device: str, metrics_port: int | None = None):
    """``serve()`` in process on an OS-assigned port; returns the handle,
    a stub and the seconds from the call to the first ``Health`` that
    answers ok."""
    import grpc
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.core.config import load_config
    from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
    from lumen_tpu_torch.serving.server import serve

    t0 = time.perf_counter()
    handle = serve(load_config(str(yaml_path)), port_override=0, skip_download=True, device=device,
                   metrics_port=metrics_port)
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


def drive_grpc(seed: int, card: str, cfg=None, device: str = "cuda:0", root: Path | None = None) -> dict:
    """Phase 6: a full-width model directory served over real gRPC by the
    port's ``serve()``; bf16, then int8 with speculation. ``cfg``/``device``
    let the CPU tests rehearse it at a small configuration (it then stops at
    the launch-count check). The model directory goes under ``root`` (a
    temporary directory of its own when None), where phase 7 reads it
    again; the returned dict carries what phase 7 holds its answers to."""
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
    with contextlib.ExitStack() as stack:
        if root is None:
            root = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="lumen-chip-smoke-")))
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
                   peak_gib=peak / 2**30, launches=launches, model_dir=model_dir, photos=photos, prompt=prompt,
                   budgets=budgets, streams=[r["body"] for r in streams], unary=unary["body"])

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


# -- phase 7: the JAX server's default serving path -----------------------------

#: phase 7's prefix-cache budget (``LUMEN_VLM_PREFIX_BYTES``)
PHASE7_PREFIX_BYTES = 64 << 20
#: the questions phase 7 asks of one photo (prefix reuse)
QUESTIONS = ("describe this photo in one detailed sentence", "caption this image in one sentence",
             "describe a red car on a wet road")


def http_json(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.load(resp)


def check_spill_roundtrip(gen, n_pages: int, seed: int) -> dict:
    """A spill round trip at the pool shapes ``gen`` serves, on a pool of
    its own: export a row of ``n_pages`` random pages (one device-to-host
    copy), resume it into another slot through a disjoint page grant,
    export it from there, and require the two packed payloads to be
    byte-equal (the first one also equal to the source pages). Returns the
    payload size and the export and resume times (host clock, around a
    synchronize)."""
    import numpy as np
    import torch

    from lumen_tpu_torch.models.vlm import migration

    on_card = gen.device.type == "cuda"
    pages = 4 * n_pages + 1
    pool = gen.init_pool(8, pages=pages, page_size=16)
    g = torch.Generator(device=gen.device)
    g.manual_seed(seed)
    for layer in pool["caches"]:
        for name in ("k", "v"):
            layer[name].copy_(torch.randn(layer[name].shape, generator=g, device=gen.device))
    pool["seen"][3] = torch.rand(pool["seen"].shape[1], generator=g, device=gen.device) < 0.01
    pool["cur_tok"][3], pool["cur_len"][3], pool["n_gen"][3] = 1234, n_pages * 16 - 5, 40
    n_pad = 1 << (n_pages - 1).bit_length()
    perm = torch.randperm(pages - 1, generator=torch.Generator().manual_seed(seed)).numpy() + 1
    src, dst = np.zeros(n_pad, np.int32), np.zeros(n_pad, np.int32)
    src[:n_pages], dst[:n_pages] = perm[:n_pages], perm[n_pages : 2 * n_pages]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def leaves(host):
        return [layer[name] for layer in host["pages"] for name in ("k", "v")] + [host["seen"]]

    sync()
    t0 = time.perf_counter()
    first = gen.export_row(pool, 3, src)
    t1 = time.perf_counter()
    gen.resume(pool, 5, first["pages"], dst, first["seen"], first["cur_tok"], first["cur_len"],
               first["n_gen"], 68, 0.7, 1.0, True, 1.0)
    sync()
    t2 = time.perf_counter()
    second = gen.export_row(pool, 5, dst)
    blob_a, _ = migration.pack_payload(leaves(first))
    blob_b, _ = migration.pack_payload(leaves(second))
    scalars = lambda h: (h["cur_tok"], h["cur_len"], h["n_gen"])  # noqa: E731
    if blob_a != blob_b or scalars(first) != scalars(second):
        raise AssertionError("spill round trip: the second export differs from the first")
    ids = torch.as_tensor(src[:n_pages], dtype=torch.long, device=gen.device)
    k0 = pool["caches"][0]["k"].index_select(0, ids).cpu()
    if not torch.equal(k0.view(torch.int16), torch.from_numpy(first["pages"][0]["k"][:n_pages].view(np.int16))):
        raise AssertionError("spill round trip: the export differs from the pool's pages")
    if not (pool["sampling"][5] and bool(pool["do_sample"][5])):
        raise AssertionError("spill round trip: the resumed row lost its sampling state")
    return dict(nbytes=len(blob_a), export_ms=(t1 - t0) * 1e3, resume_ms=(t2 - t1) * 1e3, n_pad=n_pad)


def drive_defaults(seed: int, card: str, root: Path, phase6: dict, device: str = "cuda:0") -> dict:
    """Phase 7: phase 6's model directory behind one bf16 ``serve()`` with
    the JAX server's defaults (spill tier, result cache, breaker,
    quarantine) plus the metrics sidecar and a 64 MiB prefix cache, on a
    KV pool pinned small enough that 8 requests must preempt. Drives, over
    gRPC: (a) pressure: 6 of phase 6's greedy streams and 2 sampled ones;
    (b) prefix reuse: one photo, three questions, cold and then in two
    waves; (c) the result cache: one ``vlm_generate`` twice; (d) the
    sidecar's ``/metrics.json`` and ``/stats`` and ``Health``. Every check
    raises. Launch counts are zeroed before (a) and read after (b); (c)'s
    second answer must launch nothing."""
    from concurrent.futures import ThreadPoolExecutor

    import grpc
    import torch
    from google.protobuf import empty_pb2

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    all_k = all_kernels()
    photos, prompt = phase6["photos"], phase6["prompt"]
    # Live positions of phase 6's prompt: its text tokens, with the image
    # token expanded to the vision tokens.
    from lumen_tpu_torch.models.vlm import VLMConfig

    cfg = VLMConfig.from_hf(json.loads((phase6["model_dir"] / "config.json").read_text()))
    live = phase6["streams"][0]["input_tokens"] - 1 + cfg.vision.num_tokens
    per_row = -(-(live + 1) // 16)
    budgets = [96 + 8 * i for i in range(6)] + [128, 128]
    longest = -(-(live + max(budgets) + 1) // 16)
    # Room for two rows' prompts and half a third: the chunk lane admits
    # one prompt every two decode blocks and page gating admits a row only
    # onto free pages, so pressure comes from two or three admitted rows
    # outgrowing the pool (a row grows by 6-9 pages). One row alone fits.
    pin = max(2 * per_row + per_row // 2, longest + 2) + 1
    if on_card:
        torch.cuda.empty_cache()
    # A fresh process-wide result cache, as a new server process has: phase
    # 6's server answered (c)'s request in this process already.
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache

    reset_result_cache()
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_VLM_KV_PAGES=str(pin), LUMEN_VLM_PREFIX_BYTES=str(PHASE7_PREFIX_BYTES)):
        handle, channel, stub, load_s = boot_server(
            deployment_yaml(root / "defaults.yaml", root / "cache", "SmokeVLM", None), device, metrics_port=0)
    try:
        mgr = handle.services["vlm"].manager
        eng = mgr.engine
        mport = handle.metrics_server.port
        log(f"phase 7: server with the default serving path up in {load_s:.2f} s, kv {mgr.kv_layout()} "
            f"({live} live prompt positions = {per_row} pages a row; pool pinned at {pin}), spill budget "
            f"{eng._spill_budget >> 20} MiB, prefix budget {PHASE7_PREFIX_BYTES >> 20} MiB, sidecar port {mport}")
        if eng.prefix is None or eng._spill_budget <= 0:
            raise AssertionError("phase 7: the prefix cache or the spill tier is off")

        def drop_prefixes():
            """Empty the prefix cache with the engine idle, so the next
            request prefills cold."""
            while eng.load():
                time.sleep(0.01)
            with eng._cond:  # the idle loop waits on it
                eng.prefix.clear()

        def stream(photo: bytes, budget: int, extra: dict | None = None, messages: str = prompt) -> dict:
            return grpc_call(stub, "vlm_generate_stream", photo,
                             {"messages": messages, "max_new_tokens": budget, **(extra or {})})

        # -- (a) pressure: 6 greedy streams of phase 6 and 2 sampled ones --
        # Budgets past phase 6's: the chunk lane admits one prompt every two
        # turns, so rows must live long enough to meet in the pool.
        greedy = list(range(6))
        jobs = [(photos[i], budgets[i], None) for i in greedy]
        jobs += [(photos[i], budgets[i], {"do_sample": "true", "temperature": 0.7}) for i in (6, 7)]
        for k in all_k:
            k.launches = 0
        pre0, res0 = eng.preemptions, eng.spill_resumes
        t_start = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            streams = list(pool.map(lambda job: stream(*job), jobs))
        wall = time.perf_counter() - t_start
        failed = [(i, r["code"]) for i, r in enumerate(streams) if r["code"]]
        if failed:
            raise AssertionError(f"phase 7 (a): streams failed under pressure with the spill tier on: {failed}")
        for i, r in enumerate(streams):
            if b"".join(r["deltas"]).decode() != r["body"]["text"]:
                raise AssertionError(f"phase 7 (a): stream {i}'s deltas do not join to its final text")
        preempted, resumed = eng.preemptions - pre0, eng.spill_resumes - res0
        if preempted <= 0 or resumed <= 0:
            raise AssertionError(f"phase 7 (a): {preempted} preemptions, {resumed} spill resumes: no pressure")
        # Greedy answers under pressure: equal to the same request alone on
        # this server (cold, no pressure), and, over phase 6's shorter
        # budget, to phase 6's answer (each id decodes to one word).
        for i in greedy:
            drop_prefixes()
            alone = stream(*jobs[i])
            got = (streams[i]["body"]["text"], streams[i]["body"]["generated_tokens"])
            if alone["code"] or (alone["body"]["text"], alone["body"]["generated_tokens"]) != got:
                raise AssertionError(f"phase 7 (a): greedy stream {i} under pressure differs from it alone")
            ref = phase6["streams"][i]
            words, ref_words = got[0].split(), ref["text"].split()
            eos6 = ref["generated_tokens"] < phase6["budgets"][i]
            if words[: len(ref_words)] != ref_words or (eos6 and got[1] != ref["generated_tokens"]):
                raise AssertionError(f"phase 7 (a): greedy stream {i} differs from phase 6's unpressured answer")
        g = eng.gauges()
        path = ("shm arena" if g.get("spill_arena_segments") else "") + (
            f"{' and ' if g.get('spill_arena_segments') else ''}host arrays ({g['spill_fallbacks']} fallbacks)"
            if g["spill_fallbacks"] else "")
        tokens = sum(r["body"]["generated_tokens"] for r in streams)
        ttfts = [round(r["ttft_ms"], 2) for r in streams]
        log(f"phase 7 (a): 8 streams (6 greedy, 2 sampled at 0.7), {tokens} tokens in {wall:.3f} s = "
            f"{tokens / wall:.1f} tok/s; {preempted} preemptions, {g['spilled']} spills, {resumed} resumes, "
            f"{g['preempt_redone']} redone, {g['preempt_failed']} shed; spill path: {path}; the 6 greedy "
            f"streams equal themselves alone and phase 6's unpressured answers over its budgets [{card}]")

        # -- (b) prefix reuse: one photo, three questions --------------------
        def ask(q: str) -> dict:
            r = stream(photos[8], 24, messages=json.dumps([{"role": "user", "content": q}]))
            if r["code"]:
                raise AssertionError(f"phase 7 (b): {q!r} failed with code {r['code']}")
            return r["body"]

        chunks0 = eng.chunks_run
        cold = []
        for q in QUESTIONS:
            drop_prefixes()
            cold.append(ask(q))
        cold_chunks = eng.chunks_run - chunks0
        drop_prefixes()
        hits0, chunks0 = eng.prefix_hits, eng.chunks_run
        wave1 = [ask(QUESTIONS[0])]
        with ThreadPoolExecutor(max_workers=2) as pool:
            wave2 = list(pool.map(ask, QUESTIONS[1:]))
        warm_chunks, hits = eng.chunks_run - chunks0, eng.prefix_hits - hits0
        launches = {k.name: k.launches for k in all_k}
        warm = wave1 + wave2
        if hits <= 0 or warm_chunks >= cold_chunks:
            raise AssertionError(f"phase 7 (b): {hits} prefix hits, {warm_chunks} chunks warm vs {cold_chunks} cold")
        if any("prefix_hit" not in b["metadata"] for b in warm) or not all(
                b["metadata"]["prefix_hit"] > 0 for b in wave2):
            raise AssertionError(f"phase 7 (b): prefix_hit metadata {[b['metadata'].get('prefix_hit') for b in warm]}")
        if [(b["text"], b["generated_tokens"]) for b in warm] != [(b["text"], b["generated_tokens"]) for b in cold]:
            raise AssertionError("phase 7 (b): prefix-hit answers differ from the cold answers")
        log(f"phase 7 (b): one photo, {len(QUESTIONS)} questions: cold {cold_chunks} prefill chunks; two waves "
            f"{warm_chunks} chunks, {hits} prefix hits (prefix_hit "
            f"{[b['metadata']['prefix_hit'] for b in warm]}), answers equal to the cold ones")
        missing = [n for n in PHASE4_KERNELS if launches[n] == 0]
        if missing:
            raise AssertionError(f"phase 7 never launched: {missing} (launches {launches})")
        log(f"phase 7: launches over (a) and (b) {json.dumps(launches)}")

        # -- (c) the result cache: one vlm_generate twice ---------------------
        meta = {"messages": prompt, "max_new_tokens": 16}
        first = grpc_call(stub, "vlm_generate", photos[10], meta)
        for k in all_k:
            k.launches = 0
        second = grpc_call(stub, "vlm_generate", photos[10], meta)
        again = {k.name: k.launches for k in all_k}
        if first["code"] or second["code"] or "cached" in first["body"]["metadata"]:
            raise AssertionError(f"phase 7 (c): codes {first['code']}/{second['code']}")
        if second["body"]["metadata"].get("cached") is not True or any(again.values()):
            raise AssertionError(f"phase 7 (c): second answer not from the result cache (launches {again})")
        if (second["body"]["text"], first["body"]["text"]) != (first["body"]["text"], phase6["unary"]["text"]):
            raise AssertionError("phase 7 (c): the cached answer differs from the computed one or phase 6's")
        log(f"phase 7 (c): vlm_generate computed in {first['s'] * 1e3:.1f} ms, answered again from the result "
            f"cache in {second['s'] * 1e3:.2f} ms with no kernel launch (client side, over gRPC) [{card}]")

        # -- (d) operations: the sidecar and Health ----------------------------
        snap = http_json(mport, "/metrics.json")
        stats = http_json(mport, "/stats?window=900")
        need = {"vlm_paged_preemptions", "vlm_spills", "vlm_spill_resumes", "vlm_prefix_hits", "vlm_prefix_misses"}
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {}).get("vlm-continuous:SmokeVLM", {})
        if not need <= set(counters) or not gauges or "vlm.ttft" not in snap["tasks"]:
            raise AssertionError(f"phase 7 (d): /metrics.json lacks {sorted(need - set(counters))}, "
                                 f"gauges {bool(gauges)}, vlm.ttft {'vlm.ttft' in snap['tasks']}")
        _, call = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
        trailing = dict(call.trailing_metadata())
        if json.loads(trailing.get("lumen-breaker-status", "{}")) != {"vlm": "closed"}:
            raise AssertionError(f"phase 7 (d): Health trailer {trailing}")
        ttft = stats["tasks"]["vlm.ttft"]
        server = sorted(r["body"]["metadata"]["ttft_ms"] for r in streams)
        pct = lambda q: server[min(len(server) - 1, int(q * len(server)))]  # noqa: E731
        log(f"phase 7 (d): /metrics.json: {len([c for c in counters if c.startswith('vlm_')])} vlm_* counters "
            f"({', '.join(f'{c} {counters[c]}' for c in sorted(need))}), {len(gauges)} vlm-continuous:SmokeVLM "
            f"gauges; Health trailer lumen-breaker-status {trailing['lumen-breaker-status']}, "
            f"lumen-quarantine-size {trailing.get('lumen-quarantine-size')}")
        log(f"phase 7 (d): TTFT of (a)'s 8 streams, server p50 {pct(0.5):.1f} ms p95 {pct(0.95):.1f} ms (the "
            f"vlm.ttft observations, exact), client {sorted(ttfts)}; the sidecar's vlm.ttft histogram (every "
            f"stream of this process, phases 6-7: {ttft['count']}) p50 {ttft['p50_ms']} ms p95 "
            f"{ttft['p95_ms']} ms (bucket bounds) [{card}]")

        # -- spill round trip at the full-width pool shapes ---------------------
        rt = check_spill_roundtrip(eng.gen, per_row + 5, seed + 7)
        log(f"phase 7: spill round trip of a {per_row + 5}-page row (padded to {rt['n_pad']}): export, resume "
            f"into another grant, export again: payloads byte-equal ({rt['nbytes']} B); export "
            f"{rt['export_ms']:.2f} ms, resume {rt['resume_ms']:.2f} ms (host clock) [{card}]")
        while eng.load():
            time.sleep(0.01)
        stats_kv = eng.kv.stats()
        if stats_kv.pages_live != len(set(eng.prefix.held_pages())) or eng._spill_ledger:
            raise AssertionError(f"phase 7: pages or spill records left after drain: {stats_kv}, "
                                 f"{len(eng._spill_ledger)} spill records")
    finally:
        channel.close()
        handle.stop(grace=1.0)
    return dict(load_s=load_s, launches=launches, preempted=preempted, resumed=resumed, prefix_hits=hits,
                wall_s=wall, tokens=tokens, cached_ms=second["s"] * 1e3, phase_s=time.perf_counter() - t_phase)


# -- phase 8: CLIP embeddings and zero-shot labels over gRPC --------------------

#: phase 8's tolerance: the cosine between an embedding the server answers
#: (bf16, the flash kernel in every tower block) and the same input through
#: a direct ``CLIPModel`` on the card with the plain attention (same
#: weights, same decoded pixels or token ids), and between photo 0 alone
#: and inside a full batch.
CLIP_COSINE = 0.999
#: the kernels phase 8 must launch: both CLIP towers' unmasked attention
PHASE8_KERNELS = ("flash_attention",)
#: the flash kernel's CLIP calls at the bulk batch of 64 (phase 2):
#: ViT-B/32 vision tower q/k/v [64, 12, 50, 64], causal text tower [64, 8, 77, 64]
CLIP_FLASH_SHAPES = {"CLIP vision": (64, 12, 50, False), "CLIP text, causal": (64, 8, 77, True)}
#: words of the phase-8 vocabulary besides its label and filler tokens
CLIP_WORDS = ("a", "photo", "of", "person", "animal", "vehicle", "food", "building", "nature", "an",
              "object", "landscape", "cat", "dog", "red", "car", "on", "wet", "road", "in", "the", "snow")

#: port ``state_dict`` name -> HF ``CLIPModel`` name (the inverse of the
#: HF rules ``models/clip/convert.py`` reads)
_CLIP_HF_NAMES = (
    (r"vision\.patch_embed\.weight", "vision_model.embeddings.patch_embedding.weight"),
    (r"vision\.class_embedding", "vision_model.embeddings.class_embedding"),
    (r"vision\.position_embedding", "vision_model.embeddings.position_embedding.weight"),
    (r"vision\.pre_ln\.(weight|bias)", r"vision_model.pre_layrnorm.\1"),
    (r"vision\.post_ln\.(weight|bias)", r"vision_model.post_layernorm.\1"),
    (r"vision\.projection\.weight", "visual_projection.weight"),
    (r"text\.token_embedding\.weight", "text_model.embeddings.token_embedding.weight"),
    (r"text\.position_embedding", "text_model.embeddings.position_embedding.weight"),
    (r"text\.final_ln\.(weight|bias)", r"text_model.final_layer_norm.\1"),
    (r"text\.projection\.weight", "text_projection.weight"),
    (r"(vision|text)\.blocks\.(\d+)\.attn\.(\w+)\.(weight|bias)", r"\1_model.encoder.layers.\2.self_attn.\3.\4"),
    (r"(vision|text)\.blocks\.(\d+)\.ln([12])\.(weight|bias)", r"\1_model.encoder.layers.\2.layer_norm\3.\4"),
    (r"(vision|text)\.blocks\.(\d+)\.mlp\.(fc[12])\.(weight|bias)", r"\1_model.encoder.layers.\2.mlp.\3.\4"),
    (r"logit_scale", "logit_scale"),
)


def clip_hf_state(state) -> dict:
    """A port CLIP ``state_dict`` under the HF ``CLIPModel`` names; the
    patch embedding goes back to an OIHW conv weight."""
    out = {}
    for key, t in state.items():
        for pat, template in _CLIP_HF_NAMES:
            if m := re.fullmatch(pat, key):
                break
        else:
            raise KeyError(f"no HF name for {key!r}")
        if key == "vision.patch_embed.weight":  # [W, P*P*C] (row, column, channel) -> OIHW
            width, n = t.shape
            p = int(round((n // 3) ** 0.5))
            t = t.reshape(width, p, p, 3).permute(0, 3, 1, 2)
        out[m.expand(template)] = t.contiguous()
    return out


def clip_hf_config(cfg) -> dict:
    """``config.json`` that ``CLIPConfig.from_hf`` reads back as ``cfg``."""
    v, t = cfg.vision, cfg.text
    return {
        "model_type": "clip", "projection_dim": cfg.embed_dim,
        "vision_config": {
            "hidden_size": v.width, "num_hidden_layers": v.layers, "num_attention_heads": v.heads,
            "intermediate_size": 4 * v.width, "image_size": cfg.image_size, "patch_size": cfg.patch_size,
            "hidden_act": cfg.hidden_act, "layer_norm_eps": cfg.layer_norm_eps,
        },
        "text_config": {
            "hidden_size": t.width, "num_hidden_layers": t.layers, "num_attention_heads": t.heads,
            "intermediate_size": 4 * t.width, "vocab_size": cfg.vocab_size,
            "max_position_embeddings": cfg.context_length, "eos_token_id": cfg.eot_token_id,
            "hidden_act": cfg.hidden_act,
        },
    }


def clip_label(i: int) -> str:
    return f"c{i}"


def write_clip_tokenizer(path: Path, cfg, n_labels: int) -> None:
    """A ``tokenizers`` WordLevel vocabulary of all ``vocab_size`` ids:
    ``<|startoftext|>`` and ``<|endoftext|>`` (the EOT id, ``vocab_size - 1``)
    at the top as in OpenAI CLIP's, ``CLIP_WORDS`` and the dataset's label
    words below, ``w<id>`` for the rest; every text is wrapped in the two."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers
    from tokenizers.processors import TemplateProcessing

    bos, eot = cfg.vocab_size - 2, cfg.eot_token_id
    names = {0: "<unk>", bos: "<|startoftext|>", eot: "<|endoftext|>"}
    for k, word in enumerate(CLIP_WORDS + tuple(clip_label(i) for i in range(n_labels))):
        names[1 + k] = word
    vocab = {names.get(i, f"w{i}"): i for i in range(cfg.vocab_size)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens([AddedToken(names[bos], special=True), AddedToken(names[eot], special=True)])
    tok.post_processor = TemplateProcessing(
        single=f"{names[bos]} $A {names[eot]}", special_tokens=[(names[bos], bos), (names[eot], eot)])
    tok.save(str(path))


def write_clip_model_dir(root: Path, name: str, cfg, state, n_labels: int) -> Path:
    """A CLIP model directory as the loader reads one: ``model.safetensors``
    under the HF names, ``config.json``, ``tokenizer.json`` and
    ``model_info.json`` with a dataset of ``n_labels`` labels and no
    ``.npy``, so the server embeds the labels at start-up."""
    from safetensors.torch import save_file

    model_dir = root / "models" / name
    (model_dir / "datasets" / "smoke").mkdir(parents=True)
    save_file({k: v.cpu() for k, v in clip_hf_state(state).items()}, str(model_dir / "model.safetensors"))
    (model_dir / "config.json").write_text(json.dumps(clip_hf_config(cfg)))
    write_clip_tokenizer(model_dir / "tokenizer.json", cfg, n_labels)
    (model_dir / "datasets" / "smoke" / "labels.json").write_text(
        json.dumps([clip_label(i) for i in range(n_labels)]))
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": name, "version": "1.0.0", "description": "seeded random weights for chip_smoke.py",
        "model_type": "clip", "embedding_dim": cfg.embed_dim,
        "source": {"format": "huggingface", "repo_id": f"LumilioPhotos/{name}"},
        "runtimes": {"jax": {"available": True, "files": ["model.safetensors"]}},
        "datasets": {"Smoke1k": {"labels": "datasets/smoke/labels.json",
                                 "embeddings": "datasets/smoke/embeddings.npy"}},
    }))
    return model_dir


def hub_yaml(path: Path, cache_dir: Path, clip_model: str, batch_size: int, vlm_model: str | None = None) -> Path:
    """A hub deployment: ``clip`` (bf16, the bulk batch, warm-up on), and
    ``vlm`` beside it when ``vlm_model`` names one; services named in their
    JAX form."""
    import yaml

    services = {"clip": {
        "enabled": True, "package": "lumen_tpu.models.clip",
        "import_info": {"registry_class": "lumen_tpu.serving.services.clip_service.ClipService"},
        "backend_settings": {"dtype": "bfloat16", "batch_size": batch_size, "warmup": True},
        "models": {"clip": {"model": clip_model, "runtime": "jax", "dataset": "Smoke1k"}},
    }}
    if vlm_model:
        services["vlm"] = {
            "enabled": True, "package": "lumen_tpu.models.vlm",
            "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
            "backend_settings": {"dtype": "bfloat16", "batch_size": 8},
            "models": {"vlm": {"model": vlm_model, "runtime": "jax"}},
        }
    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": {"mode": "hub", "services": sorted(services)},
        "server": {"port": 50051, "host": "127.0.0.1"},
        "services": services,
    }))
    return path


@contextlib.contextmanager
def plain_attention(modeling=None):
    """Run a family's attention (the CLIP towers' unless ``modeling`` names
    another family's modeling module) through the plain version (on any
    device) while inside: the reference the kernel's answers are held to."""
    from lumen_tpu_torch.ops.attention import attention_reference

    if modeling is None:
        from lumen_tpu_torch.models.clip import modeling
    kernel = modeling.attention
    modeling.attention = lambda q, k, v, mask=None, causal=False, scale=None: attention_reference(
        q, k, v, mask=mask, causal=causal, scale=scale)
    try:
        yield
    finally:
        modeling.attention = kernel


def photo_batch(seed: int, n: int, width: int = 1600, height: int = 1200) -> list[bytes]:
    """``n`` distinct seeded photo-sized JPEGs (one gradient, a per-photo
    tint and a per-photo shift of one noise field), encoded in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([x / width, y / height, (x + y) / (width + height)], -1)
    noise = rng.normal(0, 12, (height, width, 3)).astype(np.float32)
    tints = rng.uniform(60, 220, (n, 3)).astype(np.float32)
    shifts = rng.integers(0, width, n)

    def one(i: int) -> bytes:
        img = np.clip(base * tints[i] + np.roll(noise, int(shifts[i]), axis=1), 0, 255).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        if not ok:
            raise AssertionError("JPEG encode failed")
        return buf.tobytes()

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(n)))


def cosines(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def drive_clip(seed: int, card: str, root: Path, phase6: dict, cfg=None, device: str = "cuda:0",
               n_photos: int = 128, in_flight: int = 64, batch_size: int = 64, n_labels: int = 1000) -> dict:
    """Phase 8: a full-width CLIP model directory (``CLIPConfig()``, the
    OpenAI ViT-B/32 shapes) served by ``serve()`` over real gRPC, then a
    hub of ``clip`` + ``vlm`` (phase 6's directory under ``root``).
    ``cfg``/``device`` and the counts let the CPU tests rehearse it small;
    the launch-count gate (``PHASE8_KERNELS``) then fails unless emptied."""
    import dataclasses
    import math
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from google.protobuf import empty_pb2

    from lumen_tpu_torch.models.clip import SCENE_LABELS, CLIPConfig, CLIPModel, convert_clip_checkpoint
    from lumen_tpu_torch.models.vlm.modeling import init_random_
    from lumen_tpu_torch.ops import attention as A
    from lumen_tpu_torch.runtime.decode_pool import get_decode_pool, shutdown_decode_pool
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
    from lumen_tpu_torch.utils.host_decode import _spec_clip_resize
    from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload

    t_phase = time.perf_counter()
    cfg = cfg or dataclasses.replace(CLIPConfig(), eot_token_id=CLIPConfig().vocab_size - 1)
    on_card = torch.device(device).type == "cuda"
    if CLIPConfig.from_hf(clip_hf_config(cfg)) != cfg:
        raise AssertionError("config.json does not read back as the served CLIP configuration")
    with torch.device(device):
        model = CLIPModel(cfg)
    init_random_(model, seed + 8)
    with torch.no_grad():
        model.logit_scale.fill_(math.log(1 / 0.07))
    state = model.to(torch.bfloat16).state_dict()
    del model
    model_dir = write_clip_model_dir(root / "cache", "SmokeCLIP", cfg, state, n_labels)
    if any(not torch.equal(v.cpu(), state[k].cpu()) for k, v in
           convert_clip_checkpoint({k: v.cpu() for k, v in clip_hf_state(state).items()}).items()):
        raise AssertionError("the HF-named checkpoint does not convert back to the seeded weights")
    mb = sum(f.stat().st_size for f in model_dir.rglob("*") if f.is_file()) / 2**20
    photos = photo_batch(seed * 100 + 8, n_photos + 12 + 16)
    extra, warm, photos = photos[n_photos:n_photos + 12], photos[n_photos + 12:], photos[:n_photos]
    v, t = cfg.vision, cfg.text
    log(f"phase 8: model directory of a CLIPConfig (vision {v.width}/{v.layers}/{v.heads} patch {cfg.patch_size} at "
        f"{cfg.image_size} px, text {t.width}/{t.layers}/{t.heads} at {cfg.context_length} tokens, seeded bf16 "
        f"weights, HF names, {cfg.vocab_size}-id tokenizer, {n_labels} labels, no .npy) written, {mb:.0f} MiB; "
        f"{n_photos + 28} distinct 1600x1200 JPEGs")
    size = cfg.image_size
    # The direct model: the seeded weights on the card, the plain attention.
    with torch.device(device):
        direct = CLIPModel(cfg)
    direct.load_state_dict(state, strict=True)
    direct = direct.to(torch.bfloat16).eval().requires_grad_(False)
    all_k = all_kernels()
    flash = next(k for k in all_k if k.name == "flash_attention")
    out: dict = {}

    reset_result_cache()  # a fresh process-wide result cache, as a new server process has
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if on_card else 0  # the direct model and the seeded state
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, load_s = boot_server(
            hub_yaml(root / "clip.yaml", root / "cache", "SmokeCLIP", batch_size), device)
    try:
        svc = handle.services["clip"]
        mgr = svc.managers["clip"]
        ib, tb = mgr._image_batcher, mgr._text_batcher
        pool = get_decode_pool()
        log(f"phase 8: clip server up in {load_s:.2f} s (serve() to the first Health ok, {len(mgr._fleet_models)} "
            f"replica(s), buckets {ib.buckets} warmed), label embeddings of {len(mgr.label_names)} labels at "
            f"start-up in {mgr.label_embed_s * 1e3:.1f} ms through the causal text tower; decode pool "
            f"{'process' if pool.process_mode else 'thread'} mode, {pool.procs} worker processes, "
            f"{pool.workers} threads [{card}]")

        def encode_plain(pixels=None, ids=None):
            with plain_attention():
                if pixels is not None:
                    return mgr._encode_images(direct, torch.from_numpy(np.stack(pixels)).to(device)).cpu().numpy()
                return mgr._encode_texts(direct, torch.from_numpy(ids).to(device)).cpu().numpy()

        def expect_unit(vec, what):
            vec = np.asarray(vec, np.float64)
            if vec.shape != (cfg.embed_dim,) or not np.isfinite(vec).all() or abs(np.linalg.norm(vec) - 1) > 1e-3:
                raise AssertionError(f"{what}: embedding of shape {vec.shape}, norm {np.linalg.norm(vec):.5f}")
            return vec

        # The first photos start the decode pool's workers (spawned at first
        # use) and the fetch path's side stream and pinned buffers: a cold
        # round of 16, timed apart from (a).
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as ex:
            cold = list(ex.map(lambda p: grpc_call(stub, "clip_image_embed", p, {}), warm))
        cold_s = time.perf_counter() - t0
        if any(r["code"] for r in cold):
            raise AssertionError(f"phase 8: the cold round answered codes {[r['code'] for r in cold]}")
        log(f"phase 8: cold round (decode workers starting): 16 photos, 16 in flight, in {cold_s:.3f} s")

        # -- (a) 128 photos over gRPC, 64 in flight ---------------------------
        before = dict(ib.stats)
        flash.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(in_flight) as ex:
            embeds = list(ex.map(lambda p: grpc_call(stub, "clip_image_embed", p, {}), photos))
        wall = time.perf_counter() - t0
        vision_launches = flash.launches
        batches = ib.stats["batches"] - before["batches"]
        items = ib.stats["items"] - before["items"]
        if any(r["code"] for r in embeds):
            raise AssertionError(f"phase 8 (a): codes {sorted({r['code'] for r in embeds})}")
        vecs = np.stack([expect_unit(r["body"]["vector"], f"photo {i}") for i, r in enumerate(embeds)])
        pixels = [_spec_clip_resize(p, {"size": size}) for p in photos]
        plain = np.concatenate([encode_plain(pixels[i:i + batch_size]) for i in range(0, n_photos, batch_size)])
        cos_a = cosines(vecs, plain)
        if cos_a.min() < CLIP_COSINE:
            raise AssertionError(f"phase 8 (a): cosine to the plain path {cos_a.min():.6f} < {CLIP_COSINE}")
        if on_card:
            # The path ran pinned staging and the side-stream fetch.
            staged = [b for ring in ib._arenas.values() for bufs in ring for b in bufs]
            if not staged or not all(isinstance(b, torch.Tensor) and b.is_pinned() for b in staged) \
                    or not ib._d2h_streams:
                raise AssertionError("phase 8 (a): the image batcher staged without pinned memory or fetched "
                                     "without its side stream")
            batch = torch.from_numpy(np.stack(pixels[:batch_size])).to(device)
            batch_ms = cuda_ms(lambda: mgr._encode_images(mgr.model, batch), 10)
        else:
            batch_ms = float("nan")
        lat = sorted(r["s"] * 1e3 for r in embeds)
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        fill = items / max(batches * ib.buckets[-1], 1)
        log(f"phase 8 (a): {n_photos} clip_image_embed over gRPC ({in_flight} in flight) in {wall:.3f} s = "
            f"{n_photos / wall:.1f} images/s; client latency p50 {pct(0.5):.1f} ms p95 {pct(0.95):.1f} ms; "
            f"{batches} image batches, mean fill {100 * fill:.1f}% of {ib.buckets[-1]}; cosine to a direct "
            f"CLIPModel with the plain attention (same weights, same pixels) min {cos_a.min():.6f} "
            f"(tol {CLIP_COSINE}); one batch of {batch_size} through the vision tower {batch_ms:.3f} ms on the "
            f"device (CUDA events, launch path included: {batch_size / batch_ms * 1e3:.0f} images/s) [{card}]")

        # -- (b) 32 texts -----------------------------------------------------
        texts = [f"a photo of a {CLIP_WORDS[3 + i % 19]} in the {CLIP_WORDS[12 + i % 10]} {clip_label(i)}"
                 for i in range(32)]
        before_t = dict(tb.stats)
        flash.launches = 0
        with ThreadPoolExecutor(16) as ex:
            tembeds = list(ex.map(lambda t: grpc_call(stub, "clip_text_embed", t.encode(), {}, mime="text/plain"),
                                  texts))
        text_launches = flash.launches
        text_batches = tb.stats["batches"] - before_t["batches"]
        if any(r["code"] for r in tembeds):
            raise AssertionError(f"phase 8 (b): codes {sorted({r['code'] for r in tembeds})}")
        tvecs = np.stack([expect_unit(r["body"]["vector"], f"text {i}") for i, r in enumerate(tembeds)])
        cos_b = cosines(tvecs, encode_plain(ids=mgr.tokenizer.encode_batch(texts)))
        if cos_b.min() < CLIP_COSINE:
            raise AssertionError(f"phase 8 (b): cosine to the plain path {cos_b.min():.6f} < {CLIP_COSINE}")
        log(f"phase 8 (b): 32 clip_text_embed in {text_batches} text batches; cosine to the plain path min "
            f"{cos_b.min():.6f}")

        # -- (c) 8 classify (top 5), 4 scene ------------------------------------
        flash.launches = 0
        before_c = dict(ib.stats)
        with ThreadPoolExecutor(12) as ex:
            labels = list(ex.map(lambda i: grpc_call(
                stub, "clip_classify" if i < 8 else "clip_scene_classify", extra[i], {"top_k": 5} if i < 8 else {}),
                range(12)))
        classify_launches = flash.launches
        if any(r["code"] for r in labels):
            raise AssertionError(f"phase 8 (c): codes {[r['code'] for r in labels]}")
        served = [np.asarray(grpc_call(stub, "clip_image_embed", p, {})["body"]["vector"]) for p in extra]
        plain_c = encode_plain([_spec_clip_resize(p, {"size": size}) for p in extra])
        exact = 0
        for i, r in enumerate(labels):
            got = [(x["label"], x["score"]) for x in r["body"]["labels"]]
            matrix, names, temp = ((mgr._label_matrix, mgr.label_names, mgr.temperature()) if i < 8
                                   else (mgr._scene_matrix, SCENE_LABELS, 1.0))
            if len(got) != (5 if i < 8 else 3):
                raise AssertionError(f"phase 8 (c): request {i} answered {len(got)} labels")
            # The served labels are the served embedding's softmax top-k.
            sims = matrix @ served[i].astype(np.float32)
            probs = np.exp(sims * temp - (sims * temp).max())
            probs /= probs.sum()
            order = np.argsort(-probs)[:len(got)]
            if [names[j] for j in order] != [g[0] for g in got] or not np.allclose(
                    probs[order], [g[1] for g in got], atol=1e-5):
                raise AssertionError(f"phase 8 (c): request {i}'s labels are not its embedding's top-k")
            # Top-1 against the plain path: equal, unless the plain path's
            # own top two lie within 2 * |served - plain| (the most the
            # embeddings' difference can move a cosine score).
            plain_sims = matrix @ plain_c[i]
            top = np.argsort(-plain_sims)[:2]
            delta = float(np.linalg.norm(served[i] - plain_c[i]))
            if names[top[0]] == got[0][0]:
                exact += 1
            elif plain_sims[top[0]] - plain_sims[top[1]] > 2 * delta or \
                    plain_sims[names.index(got[0][0])] < plain_sims[top[0]] - 2 * delta:
                raise AssertionError(f"phase 8 (c): request {i}'s top-1 {got[0][0]} vs the plain path's "
                                     f"{names[top[0]]}, margin {plain_sims[top[0]] - plain_sims[top[1]]:.5f}, "
                                     f"2|delta| {2 * delta:.5f}")
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        log(f"phase 8 (c): 8 clip_classify (top 5 of {len(mgr.label_names)}) and 4 clip_scene_classify answered; "
            f"labels are each embedding's softmax top-k; top-1 equal to the plain path's in {exact} of 12 (the "
            f"others tie within 2|served - plain|)")
        launches = {"vision (a)": vision_launches, "text (b)": text_launches, "classify (c)": classify_launches}
        layers_v, layers_t = cfg.vision.layers, cfg.text.layers
        need = {"vision (a)": layers_v * batches, "text (b)": layers_t * text_batches}
        for name in PHASE8_KERNELS:
            short = [k for k, n in need.items() if launches[k] < n or n == 0]
            if short:
                raise AssertionError(f"phase 8: {name} never launched enough in {short}: launches {launches}, "
                                     f"needed {need} ({layers_v}/{layers_t} layers x batches)")
        log(f"phase 8: flash_attention launches {json.dumps(launches)} (>= layers x batches: {json.dumps(need)}); "
            f"classify batches {ib.stats['batches'] - before_c['batches']}")

        # -- (d) photo 0 again, and as tensor/raw --------------------------------
        flash.launches = 0
        items0 = ib.stats["items"]
        again = grpc_call(stub, "clip_image_embed", photos[0], {})
        if again["code"] or again["meta"].get("cache_hit") != "1" or flash.launches or ib.stats["items"] != items0:
            raise AssertionError(f"phase 8 (d): the repeat was not a cached answer (meta {again['meta']}, "
                                 f"launches {flash.launches})")
        if again["body"]["vector"] != embeds[0]["body"]["vector"]:
            raise AssertionError("phase 8 (d): the cached answer differs from the computed one")
        payload, tmeta = tensor_payload(pixels[0])
        alone = grpc_call(stub, "clip_image_embed", payload, tmeta, mime=TENSOR_MIME)
        if alone["code"]:
            raise AssertionError(f"phase 8 (d): tensor/raw answered code {alone['code']}")
        cos_d = float(cosines(expect_unit(alone["body"]["vector"], "tensor/raw"), vecs[0]))
        if cos_d < CLIP_COSINE:
            raise AssertionError(f"phase 8 (d): photo 0 alone vs in a full batch, cosine {cos_d:.6f}")
        log(f"phase 8 (d): photo 0 again answered from the result cache in {again['s'] * 1e3:.2f} ms with no "
            f"launch; photo 0 as tensor/raw ({size}x{size}x3 uint8) alone vs in a batch of "
            f"{ib.buckets[-1]}: cosine {cos_d:.6f}")

        # -- (e) a malformed image ---------------------------------------------------
        bad = grpc_call(stub, "clip_image_embed", b"\xff\xd8 not a jpeg", {})
        if bad["code"] != pb.ERROR_CODE_INVALID_ARGUMENT:
            raise AssertionError(f"phase 8 (e): a malformed image answered code {bad['code']}")
        caps = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
        if caps.runtime != ("torch-cuda" if on_card else "torch-cpu") or {t.name for t in caps.tasks} != {
                "clip_image_embed", "clip_text_embed", "clip_classify", "clip_scene_classify"}:
            raise AssertionError(f"phase 8: capabilities {caps.runtime} {[t.name for t in caps.tasks]}")
        decode_ms = []
        for _ in range(5):
            t = time.perf_counter()
            _spec_clip_resize(photos[0], {"size": size})
            decode_ms.append((time.perf_counter() - t) * 1e3)
        log(f"phase 8 (e): malformed image INVALID_ARGUMENT; decode of one 1600x1200 JPEG to {size}x{size} "
            f"{sorted(decode_ms)[2]:.2f} ms (median of 5, scaled decode + resize, one thread), pool queue wait "
            f"p50 {pool.wait_ms_p50():.2f} ms; peak device memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
            f"held before the server booted: the direct model and the seeded state) [{card}]")
    finally:
        channel.close()
        handle.stop(grace=1.0)
    out.update(load_s=load_s, images_s=n_photos / wall, p50_ms=pct(0.5), p95_ms=pct(0.95), fill=fill, cold_s=cold_s,
               batch_ms=batch_ms,
               decode_ms=sorted(decode_ms)[2], peak_gib=peak / 2**30, label_s=mgr.label_embed_s,
               launches=launches, cos_min=float(min(cos_a.min(), cos_b.min(), cos_d)),
               # what phase 9 holds the exported towers and its hub to
               cfg=cfg, state=state, photos=photos[:16], vecs=vecs[:16], texts=texts[:8], tvecs=tvecs[:8],
               label_matrix=np.array(mgr._label_matrix))

    # -- (f) a hub of clip + vlm: 4 caption streams while 32 photos embed -----------
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, hub_s = boot_server(
            hub_yaml(root / "hub.yaml", root / "cache", "SmokeCLIP", batch_size, vlm_model="SmokeVLM"), device)
    try:
        caps = stub.GetCapabilities(empty_pb2.Empty(), timeout=30)
        tasks = {t.name for t in caps.tasks}
        if not {"clip_image_embed", "vlm_generate_stream"} <= tasks:
            raise AssertionError(f"phase 8 (f): the hub serves {sorted(tasks)}")
        n_vlm, n_img = 4, min(32, n_photos)

        def job(i):
            if i < n_vlm:
                return grpc_call(stub, "vlm_generate_stream", phase6["photos"][i],
                                 {"messages": phase6["prompt"], "max_new_tokens": phase6["budgets"][i]})
            return grpc_call(stub, "clip_image_embed", photos[i - n_vlm], {})

        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_vlm + n_img) as ex:
            res = list(ex.map(job, range(n_vlm + n_img)))
        hub_wall = time.perf_counter() - t0
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 8 (f): codes {[r['code'] for r in res]}")
        for i in range(n_vlm):
            want = phase6["streams"][i]
            if (res[i]["body"]["text"], res[i]["body"]["generated_tokens"]) != (want["text"], want["generated_tokens"]):
                raise AssertionError(f"phase 8 (f): caption stream {i} in the hub differs from phase 6's")
        cos_f = cosines(np.stack([r["body"]["vector"] for r in res[n_vlm:]]), vecs[:n_img])
        if cos_f.min() < CLIP_COSINE:
            raise AssertionError(f"phase 8 (f): hub embeddings vs (a)'s, cosine {cos_f.min():.6f}")
        threads = [t.name for t in threading.enumerate()]
    finally:
        channel.close()
        handle.stop(grace=1.0)
    live = [t.name for t in threading.enumerate()
            if t.name.startswith(("clip-image", "clip-text", "vlm-continuous"))]
    pool = get_decode_pool()
    procs = [w.proc for w in pool._workers_all]
    shutdown_decode_pool()
    alive = [p.pid for p in procs if p.poll() is None]
    if live or alive:
        raise AssertionError(f"phase 8 (f): after stop, threads {live} and decode workers {alive} still alive")
    log(f"phase 8 (f): hub of clip + vlm up in {hub_s:.2f} s; 4 vlm_generate_stream beside 32 clip_image_embed "
        f"in {hub_wall:.3f} s: captions equal to phase 6's, embeddings cosine min {cos_f.min():.6f} to (a)'s; "
        f"stop retired {len([t for t in threads if t.startswith(('clip-', 'vlm-continuous'))])} batcher/engine "
        f"threads and the decode pool's {len(procs)} worker processes [{card}]")
    out.update(hub_s=hub_s, phase_s=time.perf_counter() - t_phase)
    return out


#: phase 9's bounds: a served detection matches its reference at IoU >=
#: FACE_IOU, one to one; a served embedding has cosine >= FACE_COSINE to
#: the reference's
FACE_IOU, FACE_COSINE = 0.99, 0.999
#: the share of anchors a calibration photo puts above the pack's score
#: threshold once the stand-ins' score heads are calibrated, and the spread
#: of their logits (as sparse and as separated as a trained detector's;
#: seeded random heads score every anchor near 0.5)
FACE_TOP_SHARE, FACE_LOGIT_STD = 0.002, 2.0
#: the kernels phase 9's hub must launch (the native CLIP towers; the face
#: path and the bridge run no hand-written kernel)
PHASE9_KERNELS = ("flash_attention",)
#: how far a candidate's score may move when the convolutions run in TF32
#: (10 mantissa bits, relative rounding 2**-11 a product), as users run
#: them, against the IEEE float32 reference: 3x the largest difference
#: measured on a batch of 16 (6.55e-4, NVIDIA H100 80GB HBM3, 700.00 W)
TF32_SCORE_TOL = 2e-3


def face_photos(seed: int, n: int, width: int = 1280, height: int = 1280) -> list[bytes]:
    """``n`` distinct seeded photo-sized JPEGs: a tinted gradient, noise and
    three to five bright discs each."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([x / width, y / height, (x + y) / (width + height)], -1)
    out = []
    for _ in range(n):
        img = base * rng.uniform(40, 160, 3) + rng.normal(0, 10, (height, width, 3))
        for _ in range(int(rng.integers(3, 6))):
            cx, cy, r = int(rng.integers(0, width)), int(rng.integers(0, height)), int(rng.integers(30, 120))
            cv2.circle(img, (cx, cy), r, tuple(float(v) for v in rng.uniform(200, 255, 3)), -1)
        ok, buf = cv2.imencode(".jpg", np.clip(img, 0, 255).astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 90])
        if not ok:
            raise AssertionError("JPEG encode failed")
        out.append(buf.tobytes())
    return out


def calibrate_score_heads(model, convs, nhwc: bool, seed: int, logit_threshold: float) -> None:
    """Scale and shift the score convolutions so that their logits spread
    with standard deviation ``FACE_LOGIT_STD`` over the anchors of a
    seeded photo and ``FACE_TOP_SHARE`` of them score above the threshold.
    Seeded heads put every logit in a narrow band near 0: every anchor
    passes a 0.4 threshold, and the candidates at the top-k cut and the
    threshold lie a few ulps apart, where any two correct float32
    computations may order them differently. (The photos are square, as
    the calibration's: the seeded nets answer the letterbox's flat fill
    far outside their answers to photos, and a pad would outscore them.)"""
    import torch

    photo = torch.from_numpy(face_pixels(face_photos(seed, 1)[0])[0])[None].float()

    def logits_of(pixels):
        out = []
        hooks = [c.register_forward_hook(lambda m, i, o: out.append(o.detach().flatten())) for c in convs]
        try:
            x = (pixels - 127.5) / 128.0
            with torch.no_grad():
                model(x if nhwc else x.permute(0, 3, 1, 2))
        finally:
            for h in hooks:
                h.remove()
        return torch.cat(out).double()

    z = logits_of(photo)
    a = FACE_LOGIT_STD / float(z.std())
    q = float(torch.quantile(z * a, 1 - FACE_TOP_SHARE))
    with torch.no_grad():
        for c in convs:
            c.weight.mul_(a)
            c.bias.mul_(a).add_(logit_threshold - q)


def write_face_pack(root: Path, seed: int, det_width: int, rec_layers, rec_width: int):
    """The ``buffalo_l`` stand-in pack (``lumen_tpu_torch/testing/face_standins.py``):
    ``det_10g.onnx`` (640x640, the 9-output contract) and ``w600k_r50.onnx``
    (112x112 -> 512) exported on the CPU from seeded weights and BN
    statistics, score heads calibrated; returns the directory and the two
    modules (float32, CPU, eval)."""
    import torch

    from lumen_tpu_torch.testing.face_standins import iresnet_insightface, randomize_bn_stats, scrfd_det10g
    from lumen_tpu_torch.testing.onnx_export import export_onnx

    torch.manual_seed(seed)
    det, rec = scrfd_det10g(det_width), iresnet_insightface(rec_layers, rec_width)
    randomize_bn_stats(det, seed + 1)
    randomize_bn_stats(rec, seed + 2)
    det.eval()
    rec.eval()
    calibrate_score_heads(det, [h.score for h in det.heads], False, seed + 3, math.log(0.4 / 0.6))
    model_dir = root / "models" / "buffalo_l"
    model_dir.mkdir(parents=True)
    export_onnx(det, (torch.zeros(1, 3, 640, 640),), str(model_dir / "det_10g.onnx"), input_names=["input"],
                dynamic_axes={"input": {0: "b"}})
    export_onnx(rec, (torch.zeros(1, 3, 112, 112),), str(model_dir / "w600k_r50.onnx"), input_names=["input"],
                dynamic_axes={"input": {0: "b"}})
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": "buffalo_l", "version": "1.0.0", "description": "seeded stand-ins of the InsightFace pack",
        "model_type": "face", "embedding_dim": 512,
        "source": {"format": "custom", "repo_id": "LumilioPhotos/buffalo_l"},
        "runtimes": {"onnx": {"available": True, "files": ["det_10g.onnx", "w600k_r50.onnx"]}},
    }))
    return model_dir, det, rec


def write_native_face_dir(root: Path, seed: int, det_cfg, rec_cfg) -> Path:
    """A native face directory: ``DetectorConfig`` / ``IResNetConfig``
    modules with seeded weights and BN statistics (the detector's score
    head calibrated), written as the JAX package's native safetensors."""
    import torch
    from safetensors.torch import save_file

    from lumen_tpu_torch.models.face import FaceDetector, IResNet
    from lumen_tpu_torch.testing.face_standins import native_face_checkpoint, randomize_bn_stats

    torch.manual_seed(seed)
    det, rec = FaceDetector(det_cfg).eval(), IResNet(rec_cfg).eval()
    randomize_bn_stats(det, seed + 1)
    randomize_bn_stats(rec, seed + 2)
    with torch.no_grad():
        # positive box distances (2 strides a side), as a trained head
        # regresses them; seeded ones straddle 0 and most boxes collapse
        det.head.reg.bias.fill_(2.0)
    calibrate_score_heads(det, [det.head.cls], True, seed + 3, math.log(0.4 / 0.6))
    model_dir = root / "models" / "SmokeFace"
    model_dir.mkdir(parents=True)
    save_file(native_face_checkpoint(det), str(model_dir / "detection.safetensors"))
    save_file(native_face_checkpoint(rec), str(model_dir / "recognition.safetensors"))
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": "SmokeFace", "version": "1.0.0", "description": "seeded random weights for chip_smoke.py",
        "model_type": "face", "embedding_dim": rec_cfg.embed_dim,
        "source": {"format": "custom", "repo_id": "LumilioPhotos/SmokeFace"},
        "runtimes": {"jax": {"available": True, "files": ["detection.safetensors", "recognition.safetensors"]}},
        "extra_metadata": {
            "detector": {"input_size": det_cfg.input_size, "width": det_cfg.width, "fpn_width": det_cfg.fpn_width},
            "embedder": {"layers": list(rec_cfg.layers), "width": rec_cfg.width, "input_size": rec_cfg.input_size,
                         "embed_dim": rec_cfg.embed_dim},
        },
    }))
    return model_dir


def export_clip_towers(root: Path, name: str, cfg, state, src: Path) -> Path:
    """An export-only CLIP directory: phase 8's seeded weights in a
    float32 ``CLIPModel`` exported as ``vision.fp32.onnx`` ([B, 3, S, S]
    pixels) and ``text.fp32.onnx`` ([B, L] ids) with the plain attention
    (the causal mask a traced constant), beside phase 8's tokenizer and
    labels; no ``config.json``."""
    import numpy as np
    import torch

    from lumen_tpu_torch.models.clip import CLIPModel, modeling
    from lumen_tpu_torch.ops.attention import attention_reference
    from lumen_tpu_torch.testing.onnx_export import export_onnx

    model = CLIPModel(cfg)
    model.load_state_dict({k: v.float().cpu() for k, v in state.items()}, strict=True)
    model.eval()

    def export_attention(q, k, v, mask=None, causal=False, scale=None):
        if causal:
            sq, sk = q.shape[-2], k.shape[-2]
            keep = torch.from_numpy(np.tril(np.ones((sq, sk), bool), sk - sq))
            mask = keep if mask is None else mask & keep
        return attention_reference(q, k, v, mask=mask, scale=scale)

    class Vision(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, x):
            return self.m.encode_image(x.permute(0, 2, 3, 1))

    class Text(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, ids):
            return self.m.encode_text(ids)

    model_dir = root / "models" / name
    (model_dir / "datasets" / "smoke").mkdir(parents=True)
    kernel, modeling.attention = modeling.attention, export_attention
    try:
        export_onnx(Vision(), (torch.zeros(1, 3, cfg.image_size, cfg.image_size),), str(model_dir / "vision.fp32.onnx"),
                    input_names=["pixels"], dynamic_axes={"pixels": {0: "b"}})
        export_onnx(Text(), (torch.zeros(1, cfg.context_length, dtype=torch.int64),), str(model_dir / "text.fp32.onnx"),
                    input_names=["ids"], dynamic_axes={"ids": {0: "b"}})
    finally:
        modeling.attention = kernel
    shutil.copy(src / "tokenizer.json", model_dir / "tokenizer.json")
    shutil.copy(src / "datasets" / "smoke" / "labels.json", model_dir / "datasets" / "smoke" / "labels.json")
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": name, "version": "1.0.0", "description": "exported towers of chip_smoke.py's seeded CLIP",
        "model_type": "clip", "embedding_dim": cfg.embed_dim,
        "source": {"format": "custom", "repo_id": f"LumilioPhotos/{name}"},
        "runtimes": {"onnx": {"available": True, "files": ["vision.fp32.onnx", "text.fp32.onnx"]}},
        "datasets": {"Smoke1k": {"labels": "datasets/smoke/labels.json", "embeddings": "datasets/smoke/embeddings.npy"}},
    }))
    return model_dir


def face_yaml(path: Path, cache_dir: Path, services: dict) -> Path:
    """A deployment of ``services`` (name -> (model, backend settings)),
    named in their JAX form; one service is a single deployment, more a hub."""
    import yaml

    spec = {}
    for name, (model, settings) in services.items():
        family = "face" if name == "face" else "clip"
        models = {name: {"model": model, "runtime": "jax"}}
        if family == "clip":
            models[name]["dataset"] = "Smoke1k"
        spec[name] = {
            "enabled": True, "package": f"lumen_tpu.models.{family}",
            "import_info": {"registry_class": f"lumen_tpu.serving.services.{family}_service."
                                              f"{'FaceService' if family == 'face' else 'ClipService'}"},
            "backend_settings": settings, "models": models,
        }
    mode = ({"mode": "single", "service": next(iter(spec))} if len(spec) == 1
            else {"mode": "hub", "services": sorted(spec)})
    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": mode, "server": {"port": 50051, "host": "127.0.0.1"}, "services": spec,
    }))
    return path


def face_pixels(jpeg: bytes, max_edge: int | None = 640):
    """The server's scaled decode of a photo: (RGB pixels, decode scale,
    original (h, w))."""
    from lumen_tpu_torch.utils.host_decode import decode_image_bytes_scaled

    return decode_image_bytes_scaled(jpeg, color="rgb", max_edge=max_edge)


def reference_scrfd(outs, mgr, strides=(8, 16, 32)):
    """Decode of one image's raw SCRFD outputs in numpy, written from the
    reference's published algorithm (``onnxrt_backend.py:425-483,
    882-1154``), not from the port: anchor centers cell-major with 2
    anchors a cell, stride-scaled distances, the ``max_detections`` best
    by a stable descending sort, greedy IoU NMS in that order. Returns
    (boxes, kps, scores, keep) over those candidates."""
    import numpy as np

    spec, size, fmc = mgr.spec, mgr.det_cfg.input_size, len(strides)
    boxes, kps, scores = [], [], []
    for i, stride in enumerate(strides):
        s = np.asarray(outs[i], np.float32).reshape(-1)
        d = np.asarray(outs[fmc + i], np.float32).reshape(-1, 4) * stride
        k = np.asarray(outs[2 * fmc + i], np.float32).reshape(-1, 10) * stride
        n = size // stride
        gy, gx = np.mgrid[:n, :n]
        c = np.repeat(np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32) * stride, 2, axis=0)
        boxes.append(np.concatenate([c - d[:, :2], c + d[:, 2:]], 1))
        kps.append(k.reshape(-1, 5, 2) + c[:, None, :])
        scores.append(s)
    boxes, kps, scores = np.concatenate(boxes), np.concatenate(kps), np.concatenate(scores)
    top = np.argsort(-scores, kind="stable")[:spec.max_detections]
    boxes, kps, scores = boxes[top], kps[top], scores[top]
    area = (boxes[:, 2] - boxes[:, 0]).clip(0) * (boxes[:, 3] - boxes[:, 1]).clip(0)
    keep = np.isfinite(scores)
    for i in range(len(boxes)):
        if not keep[i]:
            continue
        xx1 = np.maximum(boxes[i, 0], boxes[i + 1:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[i + 1:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[i + 1:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[i + 1:, 3])
        inter = (xx2 - xx1).clip(0) * (yy2 - yy1).clip(0)
        keep[i + 1:] &= ~(inter / np.maximum(area[i] + area[i + 1:] - inter, 1e-9) > spec.nms_threshold)
    return boxes, kps, scores, keep


def gap_threshold(scores, keep, lo: int = 4, hi: int = 32) -> tuple[float, float]:
    """A confidence threshold for one photo: midway in the widest gap
    between consecutive scores of the kept (post-NMS) candidates ranked
    ``lo`` to ``hi``; returns (threshold, gap). The seeded detectors score
    on a continuum, so at a fixed threshold some photo has a candidate a
    few 1e-7 from it -- inside the difference between any two correct
    float32 computations of the same net -- and the served path and its
    reference may then keep different sets. Fewer candidates than ``lo``:
    half the lowest kept score."""
    import numpy as np

    scores = np.asarray(scores, np.float64)
    s = np.sort(scores[np.asarray(keep, bool) & np.isfinite(scores)])[::-1]
    if len(s) <= lo:
        return (float(s[-1]) / 2 if len(s) else 0.5), (float(s[-1]) / 2 if len(s) else 0.5)
    top = s[lo - 1:min(hi, len(s) - 1) + 1]
    k = int(np.argmax(top[:-1] - top[1:]))
    return float((top[k] + top[k + 1]) / 2), float(top[k] - top[k + 1])


def reference_faces(cand, spec, conf: float, max_faces: int | None = None) -> list[dict]:
    """The host half of detection in numpy, from the reference's published
    steps (``onnxrt_backend.py:1156-1210``), not from the port: kept
    candidates at or above ``conf`` by descending score, the letterbox
    undone (padding off, divided by the scale, clipped to the photo),
    degenerate boxes dropped, the longer side inside the pack's size
    gates, at most ``max_faces``. ``cand`` is one photo's reference
    candidates with its letterbox (``reference_candidates``)."""
    import numpy as np

    boxes, kps, scores, keep, scale, pad_top, pad_left, (h, w) = cand
    out = []
    for i in np.argsort(-scores, kind="stable"):
        if not keep[i] or not np.isfinite(scores[i]) or scores[i] < conf:
            continue
        box = np.clip((boxes[i].astype(np.float64) - [pad_left, pad_top, pad_left, pad_top]) / scale, 0, [w, h, w, h])
        bw, bh = box[2] - box[0], box[3] - box[1]
        if bw <= 0 or bh <= 0 or not spec.min_face <= max(bw, bh) <= spec.max_face:
            continue
        lm = (kps[i].astype(np.float64) - [pad_left, pad_top]) / scale
        out.append({"bbox": box, "confidence": float(scores[i]), "landmarks": lm})
        if max_faces is not None and len(out) >= max_faces:
            break
    return out


def box_iou(a, b) -> float:
    inter = max(0.0, min(a[2], b[2]) - max(a[0], b[0])) * max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-9)


def match_faces(served: list, ref: list, what: str) -> tuple[float, float]:
    """Served faces vs reference faces (both ``{"bbox", "confidence"}``):
    equal counts, a one-to-one match at IoU >= ``FACE_IOU``; returns (min
    IoU, max |confidence difference|)."""
    if len(served) != len(ref):
        raise AssertionError(f"{what}: {len(served)} faces served, {len(ref)} in the reference")
    left, worst, dconf = list(range(len(ref))), 1.0, 0.0
    for f in served:
        ious = [box_iou(f["bbox"], ref[j]["bbox"]) for j in left]
        j = left.pop(max(range(len(ious)), key=ious.__getitem__))
        if max(ious) < FACE_IOU:
            raise AssertionError(f"{what}: a served face matches the reference at IoU {max(ious):.5f} < {FACE_IOU}")
        worst = min(worst, max(ious))
        dconf = max(dconf, abs(f["confidence"] - ref[j]["confidence"]))
    return worst, dconf


def match_faces_tf32(served: list, cand, spec, conf: float, what: str) -> dict:
    """Served faces of the TF32 path vs the IEEE reference's candidates,
    up to score moves of ``TF32_SCORE_TOL``: each served face matches a
    distinct candidate scoring at least ``conf - TF32_SCORE_TOL`` at IoU >=
    ``FACE_IOU`` with its confidence within the tolerance; no two of those
    candidates overlap above the NMS threshold (so a candidate the
    reference suppressed is served only where its suppressor is not); each reference
    face scoring at least ``conf + TF32_SCORE_TOL`` (its longer side 1%
    inside the size gates) is served, or is covered by a served face that
    suppresses it (IoU above the NMS threshold, confidence within twice
    the tolerance: the two swapped places). Returns the min IoU, the max
    |confidence difference| and counts: faces served from below the
    threshold (``crossed``) or from a suppressed candidate
    (``unsuppressed``), reference faces not served from within the
    tolerance above it (``dropped``) or covered by a swap (``swaps``)."""
    import numpy as np

    boxes, _, scores, keep, scale, pad_top, pad_left, (h, w) = cand
    tol = TF32_SCORE_TOL
    unmapped = [np.clip((b.astype(np.float64) - [pad_left, pad_top, pad_left, pad_top]) / scale, 0, [w, h, w, h])
                for b in boxes]
    possible = [i for i in range(len(scores)) if np.isfinite(scores[i]) and scores[i] >= conf - tol]
    used = set()
    got = {"iou_min": 1.0, "dconf": 0.0, "crossed": 0, "unsuppressed": 0, "dropped": 0, "swaps": 0}
    for f in served:
        near = [i for i in possible if i not in used and abs(f["confidence"] - scores[i]) <= tol]
        ious = [box_iou(f["bbox"], unmapped[i]) for i in near]
        if not ious or max(ious) < FACE_IOU:
            raise AssertionError(f"{what}: a served face (confidence {f['confidence']:.6f}) matches no reference "
                                 f"candidate within {tol} at IoU >= {FACE_IOU} (best {max(ious, default=0.0):.5f})")
        i = near[int(np.argmax(ious))]
        used.add(i)
        got["iou_min"] = min(got["iou_min"], max(ious))
        got["dconf"] = max(got["dconf"], abs(f["confidence"] - float(scores[i])))
        got["crossed"] += int(scores[i] < conf)
        got["unsuppressed"] += int(not keep[i])
    # (on the candidates' unclipped boxes: within 0.01 of the served boxes in
    # Jaccard distance each, a metric, so served boxes that NMS kept overlap
    # at most 0.02 above its threshold there)
    matched = [boxes[i] for i in used]
    for j, a in enumerate(matched):
        for b in matched[j + 1:]:
            if box_iou(a, b) > spec.nms_threshold + 0.02:
                raise AssertionError(f"{what}: two served faces overlap at IoU {box_iou(a, b):.4f} > the NMS "
                                     f"threshold {spec.nms_threshold}")
    for r in reference_faces(cand, spec, conf):
        if any(box_iou(f["bbox"], r["bbox"]) >= FACE_IOU for f in served):
            continue
        side = max(r["bbox"][2] - r["bbox"][0], r["bbox"][3] - r["bbox"][1])
        if r["confidence"] < conf + tol or not 1.01 * spec.min_face <= side <= 0.99 * spec.max_face:
            got["dropped"] += 1
        elif any(box_iou(f["bbox"], r["bbox"]) > spec.nms_threshold
                 and abs(f["confidence"] - r["confidence"]) <= 2 * tol for f in served):
            got["swaps"] += 1
        else:
            raise AssertionError(f"{what}: a reference face (confidence {r['confidence']:.6f}, threshold "
                                 f"{conf:.6f}) is not served")
    return got


@contextlib.contextmanager
def convolutions_tf32(on: bool):
    """Run cuDNN's float32 convolutions in TF32 (``on``; PyTorch's default,
    as users run them) or in IEEE float32; restore the flag after."""
    import torch

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def drive_face(seed: int, card: str, root: Path, phase8: dict, device: str = "cuda:0", n_photos: int = 128,
               in_flight: int = 16, batch_size: int = 16, det_width: int = 40, rec_layers=(3, 4, 14, 3),
               rec_width: int = 64, native_det=None, native_rec=None) -> dict:
    """Phase 9: face and graph CLIP as users reach them. (a) the
    ``buffalo_l`` stand-in pack served over gRPC, timed and held against
    the stand-in modules run directly, once with TF32 convolutions as users
    run them (to ``TF32_SCORE_TOL``) and once in IEEE float32 (strictly);
    (b) native checkpoints of ``DetectorConfig()`` / ``IResNetConfig()``
    held against the port's own CPU run; (c) phase 8's CLIP exported to
    ONNX and served from an export-only directory, held against phase 8's
    answers; (d) a hub of clip (native) + face. The sizes and counts let
    the CPU tests rehearse it small."""
    import logging
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np
    import torch

    from lumen_tpu_torch.models.face import DetectorConfig, FaceManager, IResNetConfig
    from lumen_tpu_torch.ops.image import letterbox_numpy
    from lumen_tpu_torch.ops.nms import nms_torch
    from lumen_tpu_torch.runtime.decode_pool import get_decode_pool, shutdown_decode_pool
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.utils.host_decode import decode_image_bytes
    from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    dev = torch.device(device)
    native_det = native_det or DetectorConfig()
    native_rec = native_rec or IResNetConfig()
    out: dict = {}
    # The references run their convolutions in IEEE float32, and so does the
    # served path wherever it is held to them strictly: the seeded detectors
    # score anchors on a continuum, and TF32's rounding moves candidates
    # across the score threshold and the top-k cut. Users run the served path
    # in TF32 (PyTorch's default for cuDNN): (a) times it so and holds it to
    # the reference up to TF32_SCORE_TOL, and (c) serves graph CLIP so.
    t0 = time.perf_counter()
    _, det, rec = write_face_pack(root / "cache", seed * 100 + 9, det_width, rec_layers, rec_width)
    export_s = time.perf_counter() - t0
    n_det = sum(t.numel() for t in det.state_dict().values())
    n_rec = sum(t.numel() for t in rec.state_dict().values())
    photos = face_photos(seed * 100 + 90, n_photos + 16)
    warm, photos = photos[n_photos:], photos[:n_photos]
    log(f"phase 9: buffalo_l stand-in pack exported on the CPU in {export_s:.1f} s: det_10g.onnx "
        f"({n_det:,} params, 640x640, 9 outputs), w600k_r50.onnx ({n_rec:,} params, 112x112 -> 512); "
        f"{n_photos + 16} distinct 1280x1280 JPEGs with bright discs")
    det, rec = det.to(dev), rec.to(dev)

    def direct_embed(mgr, crops):
        x = torch.from_numpy(np.stack(crops)).to(dev).float()
        with convolutions_tf32(False), torch.no_grad():
            z = rec(((x - mgr.spec.rec_mean) / mgr.spec.rec_std).permute(0, 3, 1, 2)).float()
        return (z / z.norm(dim=-1, keepdim=True)).cpu().numpy()

    def reference_candidates(mgr, pixels_list):
        """Reference candidates of pre-decoded photos ((pixels, decode
        scale, original hw) each): the stand-in run directly on the
        letterboxed photos in IEEE float32, ``batch_size`` at a time,
        decoded by ``reference_scrfd``; with each photo's letterbox."""
        boxed = [letterbox_numpy(p, mgr.det_cfg.input_size) for p, _, _ in pixels_list]
        raw = []
        for lo in range(0, len(boxed), batch_size):
            x = torch.from_numpy(np.stack([b for b, _, _, _ in boxed[lo:lo + batch_size]])).to(dev).float()
            with convolutions_tf32(False), torch.no_grad():
                outs = [o.cpu().numpy() for o in det(((x - mgr.spec.det_mean) / mgr.spec.det_std).permute(0, 3, 1, 2))]
            raw += [[o[i] for o in outs] for i in range(len(x))]
        return [(*reference_scrfd(r, mgr), scale * dscale, pt, pl, hw)
                for r, (_, scale, pt, pl), (_, dscale, hw) in zip(raw, boxed, pixels_list)]

    def embed_reference(mgr, pixels, faces, dscale):
        crops = []
        for f in faces:
            crop = mgr.align_crop(pixels, np.asarray(f["landmarks"], np.float32) * dscale)
            crops.append(np.ascontiguousarray(crop[:, :, ::-1] if mgr.spec.rec_color == "bgr" else crop))
        return direct_embed(mgr, crops) if crops else np.zeros((0, 512))

    def drive(stub, task, payloads, metas, mime="image/jpeg"):
        """``payloads`` over gRPC at ``in_flight``; (answers, wall s)."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(in_flight) as ex:
            res = list(ex.map(lambda p, m: grpc_call(stub, task, p, m, mime=mime), payloads, metas))
        wall = time.perf_counter() - t0
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 9: {task} answered codes {sorted({r['code'] for r in res})}")
        return res, wall

    # -- (a) the pack over gRPC ------------------------------------------
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    settings = {"dtype": "bfloat16", "batch_size": batch_size, "warmup": True}
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, load_s = boot_server(
            face_yaml(root / "face.yaml", root / "cache", {"face": ("buffalo_l", settings)}), device)
    try:
        mgr = handle.services["face"].manager
        db, rb = mgr._det_batcher, mgr._rec_batcher
        placed = [t.device for v in (mgr.det_vars, mgr.rec_vars) for t in v.values()]
        if any(d != dev for d in placed):
            raise AssertionError(f"phase 9 (a): bridge params on {sorted({str(d) for d in placed})}, not {dev}")
        log(f"phase 9 (a): face server up in {load_s:.2f} s (serve() to the first Health ok, graphs loaded, "
            f"placed and warmed: det buckets {db.buckets}, rec buckets {rb.buckets}); spec det "
            f"{mgr.spec.det_size} score {mgr.spec.score_threshold} nms {mgr.spec.nms_threshold} faces "
            f"{mgr.spec.min_face}-{mgr.spec.max_face} px, rec {mgr.spec.rec_color} [{card}]")
        with convolutions_tf32(True):
            _, cold_s = drive(stub, "face_detect", warm, [{}] * len(warm))
        log(f"phase 9 (a): cold round (decode workers starting): {len(warm)} photos in {cold_s:.3f} s")

        # Each photo is asked at a confidence threshold midway in the
        # widest gap of its reference's kept scores (``gap_threshold``).
        decoded = [face_pixels(p) for p in photos]
        cands = reference_candidates(mgr, decoded)
        thr, gaps = zip(*(gap_threshold(c[2], c[3]) for c in cands))
        thr_meta = [{"conf_threshold": t} for t in thr]
        n_de = min(8, n_photos)
        crops, lms, crop_refs = [], [], []
        for i in range(n_de):
            px = decode_image_bytes(photos[i], color="rgb")
            y0, x0 = 200 + 40 * i, 300 + 50 * i
            ok, buf = cv2.imencode(".png", np.ascontiguousarray(px[y0:y0 + 240, x0:x0 + 200, ::-1]))
            crops.append(buf.tobytes())
            lm = None if i % 2 else [[70, 100], [130, 100], [100, 140], [75, 180], [125, 180]]
            lms.append({} if lm is None else {"landmarks": json.dumps(lm)})
            cpx = decode_image_bytes(crops[-1], color="rgb")
            crop = mgr.align_crop(cpx, np.asarray(lm, np.float32)) if lm else mgr._center_crop(cpx)
            crop_refs.append(direct_embed(mgr, [np.ascontiguousarray(crop[:, :, ::-1] if mgr.spec.rec_color == "bgr"
                                                                     else crop)])[0])
        crop_refs = np.stack(crop_refs)

        # As users run it: TF32 convolutions, timed; held to the reference
        # up to TF32_SCORE_TOL.
        before = dict(db.stats)
        with convolutions_tf32(True):
            detected, wall = drive(stub, "face_detect", photos, thr_meta)
            embedded, _ = drive(stub, "face_embed", crops, lms, mime="image/png")
        batches, items = db.stats["batches"] - before["batches"], db.stats["items"] - before["items"]
        fill = items / max(batches * db.buckets[-1], 1)
        lat = sorted(r["s"] * 1e3 for r in detected)
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        tf32 = {"iou_min": 1.0, "dconf": 0.0, "crossed": 0, "unsuppressed": 0, "dropped": 0, "swaps": 0}
        n_faces_t = 0
        for i, r in enumerate(detected):
            got = match_faces_tf32(r["body"]["faces"], cands[i], mgr.spec, thr[i], f"phase 9 (a) TF32 photo {i}")
            tf32 = {k: (min if k == "iou_min" else max if k == "dconf" else sum)((v, got[k])) for k, v in tf32.items()}
            n_faces_t += len(r["body"]["faces"])
        cos_tf32 = float(cosines(np.asarray([r["body"]["faces"][0]["embedding"] for r in embedded]), crop_refs).min())
        if n_faces_t == 0:
            raise AssertionError("phase 9 (a): no face detected in any photo")
        if cos_tf32 < FACE_COSINE:
            raise AssertionError(f"phase 9 (a): TF32 face_embed cosine to the stand-in {cos_tf32:.6f} < {FACE_COSINE}")
        log(f"phase 9 (a), TF32 convolutions as users run them: {n_photos} face_detect over gRPC ({in_flight} in "
            f"flight) in {wall:.3f} s = {n_photos / wall:.1f} photos/s; client p50 {pct(0.5):.1f} ms p95 "
            f"{pct(0.95):.1f} ms; {batches} detector batches, mean fill {100 * fill:.1f}% of {db.buckets[-1]}; "
            f"{n_faces_t} faces, each matched to a candidate of the IEEE stand-in run directly within "
            f"{TF32_SCORE_TOL} (IoU min {tf32['iou_min']:.5f}, tol {FACE_IOU}; |confidence| diff max "
            f"{tf32['dconf']:.2e}; {tf32['crossed']} served from below the threshold, {tf32['unsuppressed']} from a "
            f"candidate the reference suppressed, {tf32['dropped']} reference faces not served from within the "
            f"tolerance above it, {tf32['swaps']} covered by a swap); {n_de} face_embed (half with landmarks) "
            f"cosine min {cos_tf32:.6f} (tol {FACE_COSINE}) [{card}]")

        # IEEE float32: the same photos, held to the reference strictly.
        reset_result_cache()
        with convolutions_tf32(False):
            detected, wall_ieee = drive(stub, "face_detect", photos, thr_meta)
            both, _ = drive(stub, "face_detect_and_embed", photos[:n_de],
                            [{"max_faces": 4, **m} for m in thr_meta[:n_de]])
            embedded, _ = drive(stub, "face_embed", crops, lms, mime="image/png")
            worst, dconf, n_faces = 1.0, 0.0, 0
            for i, r in enumerate(detected):
                ref = reference_faces(cands[i], mgr.spec, thr[i])
                w, d = match_faces(r["body"]["faces"], ref, f"phase 9 (a) photo {i}")
                worst, dconf, n_faces = min(worst, w), max(dconf, d), n_faces + len(ref)
            log(f"phase 9 (a), IEEE float32: the {n_photos} face_detect in {wall_ieee:.3f} s = "
                f"{n_photos / wall_ieee:.1f} photos/s; {n_faces} faces, each matched one to one to the stand-in run "
                f"directly (IoU min {worst:.5f}, tol {FACE_IOU}; |confidence| diff max {dconf:.2e}; thresholds "
                f"{min(thr):.4f}-{max(thr):.4f} in score gaps >= {min(gaps):.2e}) [{card}]")

            # detect-and-embed (JPEG), embed (crops, with and without landmarks), tensor/raw
            cos_min, n_emb = float(cosines(np.asarray([r["body"]["faces"][0]["embedding"] for r in embedded]),
                                           crop_refs).min()), 0
            for i, r in enumerate(both):
                faces = r["body"]["faces"]
                match_faces(faces, reference_faces(cands[i], mgr.spec, thr[i], max_faces=4),
                            f"phase 9 (a) detect_and_embed photo {i}")
                if faces:
                    want = embed_reference(mgr, decoded[i][0], faces, decoded[i][1])
                    cos_min = min(cos_min, float(cosines(np.stack([f["embedding"] for f in faces]), want).min()))
                    n_emb += len(faces)
            for i in range(min(4, n_photos)):
                px = decode_image_bytes(photos[i], color="rgb")
                payload, tmeta = tensor_payload(px)
                cand = reference_candidates(mgr, [(px, 1.0, px.shape[:2])])[0]
                t = gap_threshold(cand[2], cand[3])[0]
                for task in ("face_detect", "face_detect_and_embed"):
                    r = grpc_call(stub, task, payload, {**tmeta, "max_faces": 4, "conf_threshold": t}, mime=TENSOR_MIME)
                    if r["code"]:
                        raise AssertionError(f"phase 9 (a): tensor/raw {task} code {r['code']}")
                    ref = reference_faces(cand, mgr.spec, t, max_faces=4)
                    match_faces(r["body"]["faces"], ref, f"phase 9 (a) tensor/raw {task} photo {i}")
                    if task == "face_detect_and_embed" and r["body"]["faces"]:
                        want = embed_reference(mgr, px, r["body"]["faces"], 1.0)
                        cos_min = min(cos_min, float(cosines(
                            np.stack([f["embedding"] for f in r["body"]["faces"]]), want).min()))
        if cos_min < FACE_COSINE:
            raise AssertionError(f"phase 9 (a): embedding cosine to the stand-in {cos_min:.6f} < {FACE_COSINE}")
        log(f"phase 9 (a), IEEE float32: {n_de} face_detect_and_embed ({n_emb} faces), {n_de} face_embed (half "
            f"with landmarks) and 4 photos as tensor/raw (face_detect, face_detect_and_embed): detections matched, "
            f"embedding cosine to the stand-in run directly min {cos_min:.6f} (tol {FACE_COSINE})")

        # device-side costs of one batch of 16, on the card
        if on_card:
            boxed = np.stack([letterbox_numpy(p, 640)[0] for p, _, _ in decoded[:batch_size]])
            batch = torch.from_numpy(boxed).to(dev)
            crops16 = torch.from_numpy(np.stack([np.ascontiguousarray(mgr._center_crop(p)) for p, _, _ in
                                                 decoded[:batch_size]])).to(dev)
            with convolutions_tf32(False):
                outs = [o.cpu() for o in mgr._run_detector(mgr.det_vars, batch)]
                if any(o.device != dev for o in mgr._run_detector(mgr.det_vars, batch)):
                    raise AssertionError("phase 9 (a): a detector output is not on the card")
                det_ms = cuda_ms(lambda: mgr._run_detector(mgr.det_vars, batch), 10)
                rec_ms = cuda_ms(lambda: mgr._run_embedder(mgr.rec_vars, crops16), 10)
                ieee_emb = mgr._run_embedder(mgr.rec_vars, crops16).cpu().numpy()
                boxes, _, scores, _ = mgr._run_detector(mgr.det_vars, batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nms_torch(boxes, scores, mgr.spec.nms_threshold)
                nms_host_ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    nms_torch(boxes, scores, mgr.spec.nms_threshold)
                    torch.cuda.synchronize()
                nms_launches = sum(e.count for e in prof.key_averages()
                                   if e.device_type == torch.autograd.DeviceType.CUDA)
                syncs = {"detector": count_syncs(lambda: mgr._run_detector(mgr.det_vars, batch)),
                         "embedder": count_syncs(lambda: mgr._run_embedder(mgr.rec_vars, crops16))}
            with convolutions_tf32(True):
                det_tf32_ms = cuda_ms(lambda: mgr._run_detector(mgr.det_vars, batch), 10)
                rec_tf32_ms = cuda_ms(lambda: mgr._run_embedder(mgr.rec_vars, crops16), 10)
                tf32_outs = [o.cpu() for o in mgr._run_detector(mgr.det_vars, batch)]
                tf32_emb = mgr._run_embedder(mgr.rec_vars, crops16).cpu().numpy()
            same = int((outs[3] == tf32_outs[3]).all(-1).sum())
            cos_batch = float(cosines(tf32_emb, ieee_emb).min())
            log(f"phase 9 (a): one detector batch of {batch_size} at 640x640 {det_ms:.3f} ms on the device "
                f"(CUDA events, launch path, decode and NMS included; IEEE float32), {det_tf32_ms:.3f} ms with "
                f"TF32 convolutions; one embedder batch of {batch_size} crops {rec_ms:.3f} ms ({rec_tf32_ms:.3f} ms "
                f"TF32); NMS over {boxes.shape[1]} candidates x {boxes.shape[0]} images: {nms_launches} launches, "
                f"{nms_host_ms:.2f} ms of host time; device-to-host syncs per forward {json.dumps(syncs)}; "
                f"TF32 vs IEEE on the same batch: candidate scores max |diff| "
                f"{float((outs[2] - tf32_outs[2]).abs().max()):.2e}, keep masks equal in {same} of {batch_size} "
                f"images, embeddings cosine min {cos_batch:.6f} (tol {FACE_COSINE}) [{card}]")
            if cos_batch < FACE_COSINE:
                raise AssertionError(f"phase 9 (a): TF32 embeddings vs IEEE cosine {cos_batch:.6f} < {FACE_COSINE}")
            out.update(det_ms=det_ms, det_tf32_ms=det_tf32_ms, rec_ms=rec_ms, rec_tf32_ms=rec_tf32_ms,
                       nms_launches=nms_launches, nms_host_ms=nms_host_ms, syncs=syncs)
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
        out.update(load_s=load_s, photos_s=n_photos / wall, photos_s_ieee=n_photos / wall_ieee, p50_ms=pct(0.5),
                   p95_ms=pct(0.95), fill=fill, faces=n_faces, iou_min=worst, cos_min=cos_min, tf32=tf32,
                   peak_gib=peak)
        face_answers = {i: r["body"]["faces"] for i, r in enumerate(detected[:8])}
        # what phase 10's hub holds its faces to
        out.update(face_photos=photos[:8], face_thr=list(thr[:8]), face_answers=face_answers)
    finally:
        channel.close()
        handle.stop(grace=1.0)

    # -- (b) native checkpoints: the card against the port's CPU run, IEEE --------
    reset_result_cache()
    native_dir = write_native_face_dir(root / "cache", seed * 100 + 19, native_det, native_rec)
    n_b = min(6, n_photos)
    t0 = time.perf_counter()
    cpu = FaceManager(str(native_dir), dtype="float32", batch_size=batch_size, device="cpu")
    cpu.initialize()
    try:
        # thresholds from the CPU run's candidates, as (a)'s from the reference's
        thr_b, gaps_b = [], []
        for p in photos[:n_b]:
            _, _, sc, keep = cpu._det_batcher(letterbox_numpy(face_pixels(p)[0], cpu.det_cfg.input_size)[0])
            t, g = gap_threshold(sc, keep)
            thr_b.append(t)
            gaps_b.append(g)
        as_dicts = lambda faces: [{"bbox": f.bbox, "confidence": f.confidence} for f in faces]  # noqa: E731
        refs_b = [as_dicts(cpu.detect_faces(p, conf_threshold=t)) for p, t in zip(photos[:n_b], thr_b)]
        refs_be = [cpu.detect_and_extract(p, max_faces=3, conf_threshold=t) for p, t in zip(photos[:n_b], thr_b)]
    finally:
        cpu.close()
    cpu_s = time.perf_counter() - t0
    reset_result_cache()
    settings = {"dtype": "float32", "batch_size": batch_size}
    handle, channel, stub, native_load_s = boot_server(
        face_yaml(root / "native.yaml", root / "cache", {"face": ("SmokeFace", settings)}), device)
    try:
        with convolutions_tf32(False):
            served_d, _ = drive(stub, "face_detect", photos[:n_b], [{"conf_threshold": t} for t in thr_b])
            served_de, _ = drive(stub, "face_detect_and_embed", photos[:n_b],
                                 [{"max_faces": 3, "conf_threshold": t} for t in thr_b])
    finally:
        channel.close()
        handle.stop(grace=1.0)
    worst_b, cos_b, n_b_faces = 1.0, 1.0, 0
    for i in range(n_b):
        worst_b = min(worst_b, match_faces(served_d[i]["body"]["faces"], refs_b[i], f"phase 9 (b) photo {i}")[0])
        n_b_faces += len(refs_b[i])
        got = served_de[i]["body"]["faces"]
        match_faces(got, as_dicts(refs_be[i]), f"phase 9 (b) detect_and_embed photo {i}")
        if got:
            cos_b = min(cos_b, float(cosines(np.stack([f["embedding"] for f in got]),
                                             np.stack([f.embedding for f in refs_be[i]])).min()))
    if n_b_faces == 0:
        raise AssertionError("phase 9 (b): no face detected in any photo")
    if cos_b < FACE_COSINE:
        raise AssertionError(f"phase 9 (b): embedding cosine card vs CPU {cos_b:.6f} < {FACE_COSINE}")
    log(f"phase 9 (b): native checkpoints (DetectorConfig {native_det.input_size}/{native_det.width}, "
        f"IResNetConfig {list(native_rec.layers)}/{native_rec.width} -> {native_rec.embed_dim}, seeded, float32) "
        f"served in {native_load_s:.2f} s; {n_b} face_detect + {n_b} face_detect_and_embed in IEEE float32 equal "
        f"to the port's own CPU run ({cpu_s:.1f} s): {n_b_faces} faces, IoU min {worst_b:.5f}, embeddings cosine "
        f"min {cos_b:.6f} (thresholds in score gaps >= {min(gaps_b):.2e}) [{card}]")

    # -- (c) CLIP from an export-only directory, as users run it (TF32) ----------
    reset_result_cache()
    cfg8 = phase8["cfg"]
    t0 = time.perf_counter()
    clip_dir = export_clip_towers(root / "cache", "SmokeMobileCLIP", cfg8, phase8["state"],
                                  root / "cache" / "models" / "SmokeCLIP")
    clip_export_s = time.perf_counter() - t0
    mb = sum(f.stat().st_size for f in clip_dir.glob("*.onnx")) / 2**20
    records: list[logging.LogRecord] = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    keeper = Keep(logging.WARNING)
    logging.getLogger("lumen_tpu_torch.models.clip.manager").addHandler(keeper)
    try:
        settings = {"dtype": "bfloat16", "batch_size": batch_size, "quantize": "int8"}
        with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
            handle, channel, stub, clip_load_s = boot_server(
                face_yaml(root / "clipgraph.yaml", root / "cache", {"clip": ("SmokeMobileCLIP", settings)}),
                device)
    finally:
        logging.getLogger("lumen_tpu_torch.models.clip.manager").removeHandler(keeper)
    try:
        cm = handle.services["clip"].managers["clip"]
        if cm._graphs is None or not any("quantize=int8 ignored" in r.getMessage() for r in records):
            raise AssertionError("phase 9 (c): not graph-served, or quantize=int8 accepted without the warning")
        if any(t.device != dev for part in cm.model.values() for t in part.values()):
            raise AssertionError("phase 9 (c): a tower param is not on the card")
        with convolutions_tf32(True):
            images, _ = drive(stub, "clip_image_embed", phase8["photos"], [{}] * len(phase8["photos"]))
            texts, _ = drive(stub, "clip_text_embed", [t.encode() for t in phase8["texts"]],
                             [{}] * len(phase8["texts"]), mime="text/plain")
            labels, _ = drive(stub, "clip_classify", phase8["photos"][:4], [{"top_k": 5}] * 4)
        cos_i = cosines(np.stack([r["body"]["vector"] for r in images]), phase8["vecs"])
        cos_t = cosines(np.stack([r["body"]["vector"] for r in texts]), phase8["tvecs"])
        cos_l = cosines(cm._label_matrix, phase8["label_matrix"])
        cos_c = float(min(cos_i.min(), cos_t.min(), cos_l.min()))
        if cos_c < CLIP_COSINE:
            raise AssertionError(f"phase 9 (c): cosine to phase 8's native answers {cos_c:.6f} < {CLIP_COSINE}")
        for r, v in zip(labels, images):
            sims = cm._label_matrix @ np.asarray(v["body"]["vector"], np.float32)
            top = [cm.label_names[j] for j in np.argsort(-sims)[:5]]
            if [x["label"] for x in r["body"]["labels"]] != top:
                raise AssertionError("phase 9 (c): classify labels are not the embedding's top 5")
        clip_syncs = None
        if on_card:
            pix = torch.from_numpy(np.stack([np.zeros((cm.cfg.image_size,) * 2 + (3,), np.uint8)] * batch_size)).to(dev)
            clip_syncs = count_syncs(lambda: cm._encode_images(cm.model, pix))
        log(f"phase 9 (c): phase 8's CLIP exported to ONNX on the CPU in {clip_export_s:.1f} s ({mb:.0f} MiB), "
            f"export-only directory served in {clip_load_s:.2f} s with quantize: int8 ignored (warned; "
            f"{len(cm.label_names)} label embeddings through the text graph in {cm.label_embed_s:.2f} s); "
            f"{len(images)} clip_image_embed, {len(texts)} clip_text_embed, 4 clip_classify with TF32 "
            f"convolutions: cosine to phase 8's native answers min {cos_c:.6f} (images {cos_i.min():.6f}, texts "
            f"{cos_t.min():.6f}, labels {cos_l.min():.6f}; tol {CLIP_COSINE}); device-to-host syncs per vision "
            f"forward {clip_syncs} [{card}]")
    finally:
        channel.close()
        handle.stop(grace=1.0)
    out.update(export_s=export_s, clip_export_s=clip_export_s, clip_load_s=clip_load_s, clip_cos=cos_c)

    # -- (d) a hub of clip (native) + face, IEEE (held to (a)'s answers) ----------
    reset_result_cache()
    flash = next(k for k in all_kernels() if k.name == "flash_attention")
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, hub_s = boot_server(face_yaml(root / "facehub.yaml", root / "cache", {
            "clip": ("SmokeCLIP", {"dtype": "bfloat16", "batch_size": batch_size}),
            "face": ("buffalo_l", {"dtype": "bfloat16", "batch_size": batch_size})}), device)
    try:
        cm = handle.services["clip"].managers["clip"]
        before = cm._image_batcher.stats["batches"]
        flash.launches = 0
        n_d = min(8, n_photos)

        def job(i):
            if i < n_d:
                return grpc_call(stub, "face_detect", photos[i], {"conf_threshold": thr[i]})
            return grpc_call(stub, "clip_image_embed", phase8["photos"][i - n_d], {})

        with convolutions_tf32(False), ThreadPoolExecutor(2 * n_d) as ex:
            res = list(ex.map(job, range(2 * n_d)))
        hub_launches = flash.launches
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 9 (d): codes {[r['code'] for r in res]}")
        for i in range(n_d):
            match_faces(res[i]["body"]["faces"], face_answers[i], f"phase 9 (d) photo {i} vs (a)")
        cos_d = cosines(np.stack([r["body"]["vector"] for r in res[n_d:]]), phase8["vecs"][:n_d])
        if cos_d.min() < CLIP_COSINE:
            raise AssertionError(f"phase 9 (d): hub embeddings vs phase 8's, cosine {cos_d.min():.6f}")
        need = cfg8.vision.layers * (cm._image_batcher.stats["batches"] - before)
        for name in PHASE9_KERNELS:
            if hub_launches < need or need == 0:
                raise AssertionError(f"phase 9 (d): {name} launched {hub_launches} times, need {need} "
                                     f"(vision layers x image batches)")
        threads = [t.name for t in threading.enumerate()]
    finally:
        channel.close()
        handle.stop(grace=1.0)
    live = [t.name for t in threading.enumerate() if t.name.startswith(("face-", "clip-"))]
    pool = get_decode_pool()
    procs = [w.proc for w in pool._workers_all]
    shutdown_decode_pool()
    alive = [p.pid for p in procs if p.poll() is None]
    if live or alive:
        raise AssertionError(f"phase 9 (d): after stop, threads {live} and decode workers {alive} still alive")
    log(f"phase 9 (d): hub of clip (native) + face up in {hub_s:.2f} s; {n_d} face_detect beside {n_d} "
        f"clip_image_embed: faces equal to (a)'s, embeddings cosine min {cos_d.min():.6f} to phase 8's; "
        f"flash_attention launches {hub_launches}; stop retired "
        f"{len([t for t in threads if t.startswith(('face-', 'clip-'))])} batcher threads and the decode "
        f"pool's {len(procs)} worker processes [{card}]")
    out.update(hub_s=hub_s, hub_launches=hub_launches, phase_s=time.perf_counter() - t_phase)
    return out

# -- phase 10: OCR over gRPC, and the full tier ----------------------------------------

#: the kernels phase 10 (b) must launch (the native recognizer's mixing
#: blocks, head_dim 16) and those of (c)'s full-tier hub
PHASE10_KERNELS = ("flash_attention",)
PHASE10_HUB_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention")
#: the flash kernel's head_dim-16 calls of the native SVTR (width 64, 4
#: heads): a chunk of 8 crops in the 320 bucket and 32 in the 640 bucket
OCR_FLASH_SHAPES = {"SVTR 320 bucket": (8, 4, 960), "SVTR 640 bucket": (32, 4, 1920)}
#: exponentials a second of the H100 SXM's special-function units: 16 a
#: clock on each of 132 SMs at the 1.98 GHz boost clock (NVIDIA H100 data
#: sheet and Hopper tuning guide); the third term of the head_dim-16 bound
EXP_PER_S = 16 * 132 * 1.98e9
#: (a)/(b) in IEEE float32: every box matches its reference at this IoU
OCR_IOU = 0.999
#: (a) with TF32 convolutions, as users run it: at least OCR_TF32_SHARE of
#: the IEEE reference's boxes are served at IoU >= OCR_TF32_IOU, and at
#: most 1 - OCR_TF32_SHARE of the served boxes match none. TF32 rounds
#: the detector's map by about 1e-3 (phase 9's TF32 scores moved up to
#: 6.55e-4), which moves pixels across the threshold at the lines' edges
#: and so the contours' corners by a pixel or two.
OCR_TF32_IOU, OCR_TF32_SHARE = 0.9, 0.95
#: (b) bf16: the kernel path's CTC logits within this share of the plain
#: path's largest |logit| (bf16 rounds each layer's output to 2**-9; the
#: kernel and the plain attention round in different places)
OCR_BF16_LOGIT_SHARE = 0.05


def ocr_pages(seed: int, n: int, width: int = 1280, height: int = 960, rotated_share: float = 0.25):
    """``n`` distinct seeded synthetic pages (dark text lines drawn with
    ``cv2.putText`` on a light ground, a share of them turned 180 degrees)
    as JPEG bytes, with their pixels as the server decodes them."""
    import cv2
    import numpy as np

    from lumen_tpu_torch.testing.ocr_standins import synthetic_page
    from lumen_tpu_torch.utils.host_decode import decode_image_bytes

    out = []
    for i in range(n):
        page, _ = synthetic_page(seed + i, width, height, rotated_share=rotated_share)
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(page[:, :, ::-1]), [cv2.IMWRITE_JPEG_QUALITY, 92])
        if not ok:
            raise AssertionError("JPEG encode failed")
        out.append((buf.tobytes(), decode_image_bytes(buf.tobytes(), color="rgb")))
    return out


def gap_between(values, center: float, half: float) -> tuple[float, float]:
    """A threshold midway in the widest gap between ``values`` within
    ``half`` of ``center`` (the interval's ends count as values), and the
    gap: no rounding of a value by less than half the gap moves it across.
    Phase 9's ``gap_threshold`` idea, for thresholds a request can set."""
    import numpy as np

    v = np.unique(np.asarray(values, np.float64).ravel())
    pts = np.concatenate([[center - half], v[(v > center - half) & (v < center + half)], [center + half]])
    k = int(np.argmax(np.diff(pts)))
    return float((pts[k] + pts[k + 1]) / 2), float(pts[k + 1] - pts[k])


def ref_quad_iou(a, b) -> float:
    """IoU of two convex quads; two quads of no area (a box clipped flat
    at the page's edge) count as equal when their corners are."""
    import cv2
    import numpy as np

    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    inter, _ = cv2.intersectConvexConvex(a, b)
    union = cv2.contourArea(a) + cv2.contourArea(b) - inter
    if union < 1e-9:
        return float(np.abs(a - b).max() < 1e-3)
    return float(inter / union)


class OcrReference:
    """The PP-OCR pipeline written from the reference's published steps
    (``lumen_ocr/backends/onnxrt_backend.py:338-632``, with the JAX
    package's letterbox buckets and rectangle unclip), not from the port:
    the stand-in modules run directly on the card in IEEE float32, the
    host steps in numpy and cv2. ``answer`` returns the items a request
    with the given thresholds must get."""

    def __init__(self, det, rec, cls, vocab, dev, det_buckets=(320, 640, 960), rec_buckets=(80, 160, 320, 640)):
        self.det, self.rec, self.cls, self.vocab, self.dev = det, rec, cls, vocab, dev
        self.det_buckets, self.rec_buckets = det_buckets, rec_buckets

    def _norm(self, pixels, mean, std):
        import numpy as np
        import torch

        x = torch.from_numpy(np.ascontiguousarray(pixels)).to(self.dev).float() / 255.0
        return ((x - torch.tensor(mean, device=self.dev)) / torch.tensor(std, device=self.dev)).permute(0, 3, 1, 2)

    def prob_map(self, pixels):
        """(map of the letterboxed page, scale, pad top, pad left)."""
        import torch

        from lumen_tpu_torch.ops.image import letterbox_numpy

        bucket = next((b for b in self.det_buckets if max(pixels.shape[:2]) <= b), self.det_buckets[-1])
        boxed, scale, top, left = letterbox_numpy(pixels, bucket)
        with convolutions_tf32(False), torch.no_grad():
            prob = self.det(self._norm(boxed[None], (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)))[0, 0]
        return prob.cpu().numpy(), scale, top, left

    @staticmethod
    def candidates(prob, det_thr, unclip=1.5, min_size=3.0):
        """(rect, quad, score) of each contour of the thresholded map: the
        min-area rectangle, its mean probability, the rectangle grown by
        ``area * unclip / perimeter`` on each side."""
        import cv2
        import numpy as np

        binary = (prob > det_thr).astype(np.uint8)
        contours, _ = cv2.findContours(binary, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
        h, w = prob.shape
        out = []
        for c in contours[:1000]:
            rect = cv2.minAreaRect(c)
            if min(rect[1]) < min_size:
                continue
            pts = cv2.boxPoints(rect)
            x0, x1 = int(np.clip(np.floor(pts[:, 0].min()), 0, w - 1)), int(np.clip(np.ceil(pts[:, 0].max()), 0, w - 1))
            y0, y1 = int(np.clip(np.floor(pts[:, 1].min()), 0, h - 1)), int(np.clip(np.ceil(pts[:, 1].max()), 0, h - 1))
            mask = np.zeros((y1 - y0 + 1, x1 - x0 + 1), np.uint8)
            cv2.fillPoly(mask, [np.round(pts - [x0, y0]).astype(np.int32)], 1)
            score = float(cv2.mean(prob[y0:y1 + 1, x0:x1 + 1], mask)[0]) if mask.any() else 0.0
            (cx, cy), (rw, rh), ang = rect
            d = rw * rh * unclip / max(2.0 * (rw + rh), 1e-9)
            grown = ((cx, cy), (rw + 2 * d, rh + 2 * d), ang)
            if min(grown[1]) < min_size + 2:
                continue
            out.append((grown, score))
        return out

    @staticmethod
    def quad(rect, scale, top, left, hw):
        """The grown rectangle's corners clockwise from the top-left, in
        the page's coordinates."""
        import cv2
        import numpy as np

        pts = cv2.boxPoints(rect)
        pts = pts[np.argsort(pts[:, 0], kind="stable")]
        lft, rgt = pts[:2][np.argsort(pts[:2, 1], kind="stable")], pts[2:][np.argsort(pts[2:, 1], kind="stable")]
        q = np.array([lft[0], rgt[0], rgt[1], lft[1]], np.float32)
        q[:, 0] = np.clip((q[:, 0] - left) / scale, 0, hw[1] - 1)
        q[:, 1] = np.clip((q[:, 1] - top) / scale, 0, hw[0] - 1)
        return q

    @staticmethod
    def reading_order(quads):
        order = sorted(range(len(quads)), key=lambda i: (quads[i][0][1], quads[i][0][0]))
        for j in range(len(order) - 1):
            for k in range(j, -1, -1):
                a, b = quads[order[k]], quads[order[k + 1]]
                if abs(b[0][1] - a[0][1]) < 10 and b[0][0] < a[0][0]:
                    order[k], order[k + 1] = order[k + 1], order[k]
                else:
                    break
        return order

    @staticmethod
    def crop(pixels, q):
        import cv2
        import numpy as np

        w = max(int(max(np.linalg.norm(q[0] - q[1]), np.linalg.norm(q[2] - q[3]))), 1)
        h = max(int(max(np.linalg.norm(q[0] - q[3]), np.linalg.norm(q[1] - q[2]))), 1)
        m = cv2.getPerspectiveTransform(q, np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32))
        c = cv2.warpPerspective(pixels, m, (w, h), borderMode=cv2.BORDER_REPLICATE, flags=cv2.INTER_CUBIC)
        return np.rot90(c) if h / w >= 1.5 else c

    def flips(self, crops, thresh=0.9):
        import cv2
        import numpy as np
        import torch

        batch = np.zeros((len(crops), 48, 192, 3), np.uint8)
        for i, c in enumerate(crops):
            nw = min(max(int(round(c.shape[1] * 48 / max(c.shape[0], 1))), 1), 192)
            batch[i, :, :nw] = cv2.resize(c, (nw, 48), interpolation=cv2.INTER_LINEAR)
        with convolutions_tf32(False), torch.no_grad():
            p = self.cls(self._norm(batch, (0.5,) * 3, (0.5,) * 3)).cpu().numpy()
        return [bool(r.argmax() == 1 and r[1] > thresh) for r in p], p[:, 1]

    def read(self, crops):
        """(text, confidence) of each crop: height 48, the width bucket,
        one batch a bucket, CTC greedy over the valid steps."""
        import cv2
        import numpy as np
        import torch

        out = [None] * len(crops)
        groups: dict = {}
        for i, c in enumerate(crops):
            nw = max(int(round(c.shape[1] * 48 / max(c.shape[0], 1))), 1)
            b = next((x for x in self.rec_buckets if nw <= x), self.rec_buckets[-1])
            groups.setdefault(b, []).append((i, cv2.resize(c, (min(nw, b), 48), interpolation=cv2.INTER_LINEAR)))
        for b, items in groups.items():
            batch = np.zeros((len(items), 48, b, 3), np.uint8)
            for row, (_, r) in enumerate(items):
                batch[row, :, :r.shape[1]] = r
            with convolutions_tf32(False), torch.no_grad():
                probs = self.rec(self._norm(batch, (0.5,) * 3, (0.5,) * 3)).float().cpu().numpy()
            t = probs.shape[1]
            for row, (i, r) in enumerate(items):
                ids, conf = probs[row].argmax(-1), probs[row].max(-1)
                valid = np.arange(t) * max(b // t, 1) < r.shape[1]
                prev, chars, confs = -1, [], []
                for k in range(t):
                    idx = int(ids[k]) if valid[k] else 0
                    if idx != 0 and idx != prev and idx < len(self.vocab):
                        chars.append(self.vocab[idx])
                        confs.append(float(conf[k]))
                    prev = idx
                out[i] = ("".join(chars), float(np.mean(confs)) if confs else 1.0)
        return out

    def answer(self, pixels, det_thr, box_thr, rec_thr, angle: bool, cand=None):
        """The items (quad, text, confidence) a request must get, with every
        box's confidence and classifier probability: (items, confidences,
        probabilities)."""
        import numpy as np

        prob, scale, top, left = cand or self.prob_map(pixels)
        quads = [self.quad(r, scale, top, left, pixels.shape[:2])
                 for r, s in self.candidates(prob, det_thr) if s >= box_thr]
        order = self.reading_order(quads)
        quads = [quads[i] for i in order]
        crops = [self.crop(pixels, q) for q in quads]
        p_cls = []
        if angle and crops:
            flips, p_cls = self.flips(crops)
            crops = [np.ascontiguousarray(c[::-1, ::-1]) if f else c for c, f in zip(crops, flips)]
        texts = self.read(crops) if crops else []
        items = [(q, t, c) for q, (t, c) in zip(quads, texts) if t and c >= rec_thr]
        return items, [c for _, c in texts], list(p_cls)


def match_ocr(served: list, ref: list, what: str, iou: float = OCR_IOU) -> tuple[float, float]:
    """Served items (``{"box", "text", "confidence"}``) against reference
    items ((quad, text, confidence)): equal counts, one to one at IoU >=
    ``iou`` with equal texts; returns (min IoU, max |confidence diff|)."""
    import numpy as np

    if len(served) != len(ref):
        raise AssertionError(f"{what}: {len(served)} items served, {len(ref)} in the reference")
    left, worst, dconf = list(range(len(ref))), 1.0, 0.0
    for item in served:
        ious = [ref_quad_iou(item["box"], ref[j][0]) for j in left]
        j = left.pop(int(np.argmax(ious)))
        if max(ious) < iou or item["text"] != ref[j][1]:
            raise AssertionError(f"{what}: a served item matches the reference at IoU {max(ious):.5f} (tol {iou}), "
                                 f"text {item['text']!r} vs {ref[j][1]!r}, box {np.asarray(item['box']).tolist()} vs "
                                 f"{np.asarray(ref[j][0]).tolist()}")
        worst = min(worst, max(ious))
        dconf = max(dconf, abs(item["confidence"] - ref[j][2]))
    return worst, dconf


def ocr_yaml(path: Path, cache_dir: Path, services: dict) -> Path:
    """A deployment in the shape ``generate_config`` writes (hub mode, each
    service's ``backend_settings`` with the preset's ``mesh`` and
    ``max_batch_latency_ms``), services named in their JAX form; ``services``
    maps a family to (model, settings)."""
    import yaml

    classes = {"ocr": "OcrService", "clip": "ClipService", "face": "FaceService", "vlm": "VlmService",
               "search": "SearchService"}
    spec = {}
    for family, (model, settings) in services.items():
        models = {family: {"model": model, "runtime": "jax"}}
        if family == "clip":
            models["clip"]["dataset"] = "Smoke1k"
        spec[family] = {
            "enabled": True, "package": f"lumen_tpu.serving.services.{family}_service",
            "import_info": {"registry_class": f"lumen_tpu.serving.services.{family}_service.{classes[family]}"},
            "backend_settings": {"mesh": {"axes": {"data": -1}}, "max_batch_latency_ms": 5.0, **settings},
            "models": models,
        }
    path.write_text(yaml.safe_dump({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache_dir)},
        "deployment": {"mode": "hub", "services": list(spec)},
        "server": {"port": 50051, "host": "127.0.0.1", "mdns": {"enabled": False, "service_name": "lumen-tpu"}},
        "services": spec,
    }, sort_keys=False))
    return path


def drive_ocr(seed: int, card: str, root: Path, phase6: dict, phase8: dict, phase9: dict, device: str = "cuda:0",
              n_pages: int = 32, in_flight: int = 8, page_hw=(960, 1280), pack_kw: dict | None = None,
              native=None, n_native: int = 3) -> dict:
    """Phase 10: OCR as users reach it, and the full tier. (a) the
    ``PP-OCRv5_mobile`` stand-in pack served from the YAML block
    ``config_gen`` writes for ``ocr``, timed with TF32 convolutions and held
    to ``OcrReference`` up to ``OCR_TF32_*``, then held strictly in IEEE
    float32, with ``tensor/raw`` pages and ``use_angle_cls``; (b) native
    ``DBNetConfig()`` + ``SVTRConfig()`` + ``ClsConfig()`` (``native``:
    their configs) served in bf16 on the head_dim-16 flash kernel against
    the port's plain path, and in float32 against the port's CPU run; (c)
    a full-tier hub (ocr, clip, face, vlm) from one YAML. The sizes let the
    CPU tests rehearse it small."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from lumen_tpu_torch.models.ocr import ClsConfig, DBNetConfig, OcrManager, SVTRConfig
    from lumen_tpu_torch.models.ocr import modeling as ocr_modeling
    from lumen_tpu_torch.ops.ctc import load_ctc_vocab
    from lumen_tpu_torch.ops.image import letterbox_numpy
    from lumen_tpu_torch.runtime.decode_pool import get_decode_pool, shutdown_decode_pool
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.testing.ocr_standins import write_native_ocr_dir, write_ppocr_pack
    from lumen_tpu_torch.utils.tensorwire import TENSOR_MIME, tensor_payload

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    det_bucket = next((b for b in (320, 640, 960) if max(page_hw) <= b), 960)
    out: dict = {}
    kernels = {k.name: k for k in all_kernels()}

    def drive(stub, jobs):
        """``jobs`` (payload, meta, mime) over gRPC at ``in_flight``:
        (answers, wall s)."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(in_flight) as ex:
            res = list(ex.map(lambda j: grpc_call(stub, "ocr", j[0], j[1], mime=j[2]), jobs))
        wall = time.perf_counter() - t0
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 10: ocr answered codes {sorted({r['code'] for r in res})}")
        return res, wall

    # -- (a) the stand-in pack over gRPC --------------------------------------------
    t0 = time.perf_counter()
    pack_dir = root / "cache" / "models" / "PP-OCRv5_mobile"
    mods = write_ppocr_pack(pack_dir, seed * 100 + 10, page_hw=page_hw, det_bucket=det_bucket, **(pack_kw or {}))
    export_s = time.perf_counter() - t0
    n_par = {k: sum(p.numel() for p in m.parameters()) for k, m in mods.items()}
    pages = ocr_pages(seed * 100 + 100, n_pages, width=page_hw[1], height=page_hw[0])
    vocab = load_ctc_vocab(str(pack_dir / "ppocr_keys_v1.txt"))
    log(f"phase 10: PP-OCRv5_mobile stand-in pack exported on the CPU in {export_s:.1f} s: det.onnx ({n_par['det']:,} "
        f"params), rec.onnx ({n_par['rec']:,} params, {len(vocab)} classes), cls.onnx ({n_par['cls']:,} params); "
        f"{n_pages} distinct {page_hw[1]}x{page_hw[0]} JPEG pages of text lines")
    ref = OcrReference(*(mods[k].to(dev).eval() for k in ("det", "rec", "cls")), vocab, dev)
    # Each page is asked at thresholds in the widest gaps of its reference's
    # values: the map's near 0.3, the box scores near 0.6, the confidences
    # near 0.5, so no rounding can tip an answer (as phase 9's gap_threshold).
    n_cls = min(8, n_pages)  # pages asked with use_angle_cls
    asks, gaps = [], []
    for i, (_, px) in enumerate(pages):
        cand = ref.prob_map(px)
        det_thr, g1 = gap_between(cand[0], 0.3, 0.1)
        box_thr, g2 = gap_between([sc for _, sc in ref.candidates(cand[0], det_thr)], 0.6, 0.1)
        items, confs, p_cls = ref.answer(px, det_thr, box_thr, 0.0, i < n_cls, cand=cand)
        rec_thr, g3 = gap_between(confs, 0.5, 0.1)
        items = [it for it in items if it[2] >= rec_thr]
        if p_cls and min(abs(np.asarray(p_cls) - 0.9)) < 1e-4:
            log(f"phase 10 (a): page {i}: a classifier probability within 1e-4 of cls_thresh 0.9")
        asks.append(dict(meta={"det_thresh": det_thr, "box_thresh": box_thr, "rec_thresh": rec_thr,
                               "use_angle_cls": "true" if i < n_cls else "false"}, items=items))
        gaps.append(min(g1, g2, g3))
    n_items = sum(len(a["items"]) for a in asks)
    if n_items == 0:
        raise AssertionError("phase 10 (a): the reference reads no text on any page")
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    settings = {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [320, 640, 960]}
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, load_s = boot_server(
            ocr_yaml(root / "ocr.yaml", root / "cache", {"ocr": ("PP-OCRv5_mobile", settings)}), device)
    try:
        mgr = handle.services["ocr"].manager
        placed = {t.device for v in (mgr.det_vars, mgr.rec_vars, mgr.cls_vars) for t in v.values()}
        if placed != {dev} or not mgr.has_angle_cls:
            raise AssertionError(f"phase 10 (a): bridge params on {placed}, cls {mgr.has_angle_cls}")
        jobs = [(jpeg, a["meta"], "image/jpeg") for (jpeg, _), a in zip(pages, asks)]
        with convolutions_tf32(True):
            drive(stub, jobs[:in_flight])  # cold round: decode workers start, cuDNN picks its algorithms
            reset_result_cache()
            served, wall = drive(stub, jobs)
        lat = sorted(r["s"] * 1e3 for r in served)
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        tf32 = {"ref": n_items, "served": 0, "matched": 0, "exact": 0, "moved": 0, "texts": 0}
        for r, a in zip(served, asks):
            items, left = r["body"]["items"], list(range(len(a["items"])))
            tf32["served"] += len(items)
            for it in items:
                ious = [ref_quad_iou(it["box"], a["items"][j][0]) for j in left]
                if not ious or max(ious) < OCR_TF32_IOU:
                    continue
                j = left.pop(int(np.argmax(ious)))
                tf32["matched"] += 1
                same = it["text"] == a["items"][j][1]
                tf32["exact"] += int(max(ious) >= OCR_IOU and same)
                tf32["moved"] += int(max(ious) < OCR_IOU)
                tf32["texts"] += int(not same)
        if tf32["matched"] < OCR_TF32_SHARE * n_items or tf32["served"] - tf32["matched"] > (1 - OCR_TF32_SHARE) * n_items:
            raise AssertionError(f"phase 10 (a): TF32 answers vs the IEEE reference {tf32} (tol {OCR_TF32_SHARE} "
                                 f"of the boxes at IoU >= {OCR_TF32_IOU})")
        log(f"phase 10 (a), TF32 convolutions as users run them: {n_pages} ocr over gRPC ({in_flight} in flight, "
            f"{n_cls} with use_angle_cls) in {wall:.3f} s = {n_pages / wall:.2f} pages/s; client p50 {pct(0.5):.1f} ms "
            f"p95 {pct(0.95):.1f} ms; {tf32['served']} items against the IEEE reference's {n_items}: {tf32['matched']} "
            f"at IoU >= {OCR_TF32_IOU} (tol {OCR_TF32_SHARE} of them), {tf32['exact']} equal (IoU >= {OCR_IOU}, same "
            f"text), {tf32['moved']} moved, {tf32['texts']} texts differ [{card}]")

        # IEEE float32: the same pages and more, held strictly.
        reset_result_cache()
        with convolutions_tf32(False):
            strict, wall_ieee = drive(stub, jobs)
            n_raw = min(4, n_pages)
            raw = [tensor_payload(px) for _, px in pages[:n_raw]]
            tensors, _ = drive(stub, [(p, {**m, **a["meta"]}, TENSOR_MIME) for (p, m), a in zip(raw, asks)])
            plain_jobs = [(jpeg, {**a["meta"], "use_angle_cls": "false"}, "image/jpeg")
                          for (jpeg, _), a in zip(pages[:n_cls], asks)]
            as_is, _ = drive(stub, plain_jobs)
        worst, dconf = 1.0, 0.0
        for i, r in enumerate(strict + tensors):
            w, d = match_ocr(r["body"]["items"], asks[i % n_pages]["items"], f"phase 10 (a) page {i % n_pages}")
            worst, dconf = min(worst, w), max(dconf, d)
        flipped = 0
        for i, r in enumerate(as_is):
            px = pages[i][1]
            meta = asks[i]["meta"]
            want = ref.answer(px, meta["det_thresh"], meta["box_thresh"], meta["rec_thresh"], False)[0]
            match_ocr(r["body"]["items"], want, f"phase 10 (a) page {i} without the classifier")
            flipped += sum(a[1] != b[1] for a, b in zip(want, asks[i]["items"]))
        log(f"phase 10 (a), IEEE float32: the {n_pages} pages in {wall_ieee:.3f} s = {n_pages / wall_ieee:.2f} pages/s, "
            f"{n_raw} as tensor/raw, {n_cls} again without use_angle_cls: {n_items} items each matched one to one to the "
            f"stand-ins run directly (IoU min {worst:.5f}, tol {OCR_IOU}; texts equal; |confidence| diff max "
            f"{dconf:.2e}; thresholds in gaps >= {min(gaps):.2e}); the classifier changed {flipped} texts [{card}]")

        # device-side costs, on the card
        if on_card:
            boxed = np.stack([letterbox_numpy(px, det_bucket)[0] for _, px in pages[:1]])
            x_det = torch.from_numpy(boxed).to(dev)
            chunk = torch.from_numpy(np.zeros((16, 48, 320, 3), np.uint8)).to(dev)
            widths = torch.full((16,), 320, dtype=torch.int32, device=dev)
            with convolutions_tf32(True):
                det_ms = cuda_ms(lambda: mgr._run_detector(mgr.det_vars, x_det), 10)
                rec_ms = cuda_ms(lambda: mgr._run_recognizer(mgr.rec_vars, chunk, widths), 10)
            with convolutions_tf32(False):
                det_ieee_ms = cuda_ms(lambda: mgr._run_detector(mgr.det_vars, x_det), 10)
                rec_ieee_ms = cuda_ms(lambda: mgr._run_recognizer(mgr.rec_vars, chunk, widths), 10)
                syncs = {"detector": count_syncs(lambda: mgr._run_detector(mgr.det_vars, x_det)),
                         "recognizer": count_syncs(lambda: mgr._run_recognizer(mgr.rec_vars, chunk, widths))}
                prob = mgr._run_detector(mgr.det_vars, x_det)[0].cpu().numpy()
            from lumen_tpu_torch.models.ocr import rotate_crop

            # the host's share of a page: contours, boxes and crops of the
            # first 8 pages' maps, after the one copy
            probs = []
            for _, px in pages[:8]:
                boxed1, sc, top, left = letterbox_numpy(px, det_bucket)
                with convolutions_tf32(False):
                    probs.append((mgr._run_detector(mgr.det_vars, torch.from_numpy(boxed1[None]).to(dev))[0].cpu()
                                  .numpy(), sc, top, left, px))
            t0 = time.perf_counter()
            n_crops = 0
            for (prob, sc, top, left, px), a in zip(probs, asks):
                found = mgr.boxes_from_det_output(prob, image_hw=px.shape[:2], scale=sc, pad_top=top, pad_left=left,
                                                  det_threshold=a["meta"]["det_thresh"],
                                                  box_threshold=a["meta"]["box_thresh"])
                n_crops += len([rotate_crop(px, q) for q, _ in found])
            post_ms = (time.perf_counter() - t0) * 1e3 / len(probs)
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"phase 10 (a): one detector call at {det_bucket}x{det_bucket} {det_ms:.3f} ms with TF32 convolutions ({det_ieee_ms:.3f} ms "
                f"IEEE), one recognizer chunk of 16 crops at 48x320 {rec_ms:.3f} ms ({rec_ieee_ms:.3f} ms IEEE; CUDA "
                f"events, launch path included); host postprocess {post_ms:.2f} ms a page (contours, boxes, "
                f"{n_crops / len(probs):.1f} crops; the first {len(probs)} pages); device-to-host syncs per forward {json.dumps(syncs)}; peak {peak:.3f} GiB [{card}]")
            out.update(det_ms=det_ms, det_ieee_ms=det_ieee_ms, rec_ms=rec_ms, rec_ieee_ms=rec_ieee_ms, post_ms=post_ms,
                       syncs=syncs, peak_gib=peak)
        out.update(load_s=load_s, export_s=export_s, pages_s=n_pages / wall, pages_s_ieee=n_pages / wall_ieee,
                   p50_ms=pct(0.5), p95_ms=pct(0.95), items=n_items, iou_min=worst, tf32=tf32,
                   ocr_answers={i: (pages[i][0], asks[i]["meta"], strict[i]["body"]["items"]) for i in range(n_cls)})
    finally:
        channel.close()
        handle.stop(grace=1.0)
    ref.det, ref.rec, ref.cls = (m.cpu() for m in (ref.det, ref.rec, ref.cls))
    out["a_s"] = time.perf_counter() - t_phase

    # -- (b) native checkpoints: bf16 on the head_dim-16 kernel, float32 vs the CPU --------
    det_cfg, rec_cfg, cls_cfg = native or (DBNetConfig(), SVTRConfig(), ClsConfig())
    t0 = time.perf_counter()
    native_dir = root / "cache" / "models" / "SmokeOCR"
    write_native_ocr_dir(native_dir, seed * 100 + 20, det_cfg, rec_cfg, cls_cfg, page_hw=page_hw,
                         det_bucket=det_bucket)
    write_s = time.perf_counter() - t0
    npages = pages[:n_native]
    flash = kernels["flash_attention"]
    reset_result_cache()
    settings = {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [320, 640, 960]}
    with env(LUMEN_GRPC_WORKERS=str(in_flight + 8)):
        handle, channel, stub, bf16_load_s = boot_server(
            ocr_yaml(root / "native.yaml", root / "cache", {"ocr": ("SmokeOCR", settings)}), device)
    try:
        mgr = handle.services["ocr"].manager
        chunks, captured = [], []
        run_rec = mgr._run_recognizer

        def counted(variables, crops, widths):
            chunks.append(tuple(crops.shape))
            captured.append((crops.clone(), widths.clone()))
            return run_rec(variables, crops, widths)

        mgr._run_recognizer = counted
        meta = {"det_thresh": 0.3, "box_thresh": 0.3, "rec_thresh": 0.0, "use_angle_cls": "true"}
        flash.launches = 0
        served_b, _ = drive(stub, [(jpeg, meta, "image/jpeg") for jpeg, _ in npages])
        launches = flash.launches
        mgr._run_recognizer = run_rec
        for name in PHASE10_KERNELS:  # once a mixing block, in every recognizer chunk
            if kernels[name].launches != rec_cfg.layers * len(chunks) or not chunks:
                raise AssertionError(f"phase 10 (b): {name} launched {kernels[name].launches} times for "
                                     f"{len(chunks)} recognizer chunks of {rec_cfg.layers} layers")
        # Each recognizer chunk the server ran, again through the kernel and
        # through the port's plain path (attention_reference in the mixing
        # blocks) on the same batch: the logits within OCR_BF16_LOGIT_SHARE
        # of the plain path's largest |logit|, and the same argmax at every
        # valid step whose plain top-two margin exceeds twice the row's
        # difference (where no rounding of that size can swap them).
        worst_d, n_rows, n_held = 0.0, 0, 0
        for crops, widths in captured:
            x = ((crops.float() / 255.0 - 0.5) / 0.5).to(mgr.policy.compute_dtype).permute(0, 3, 1, 2)
            with torch.no_grad():
                k_logits = mgr.rec_vars(x).float()
                with plain_attention(ocr_modeling):
                    p_logits = mgr.rec_vars(x).float()
            scale = float(p_logits.abs().max())
            diff = (k_logits - p_logits).abs().amax(dim=(1, 2))  # per row
            worst_d = max(worst_d, float(diff.max()) / scale)
            if float(diff.max()) > OCR_BF16_LOGIT_SHARE * scale:
                raise AssertionError(f"phase 10 (b): bf16 logits kernel vs plain {float(diff.max()):.3e} > "
                                     f"{OCR_BF16_LOGIT_SHARE} x {scale:.3e}")
            t = p_logits.shape[1]
            valid = torch.arange(t, device=dev)[None] * max(crops.shape[2] // t, 1) < widths[:, None]
            top2 = p_logits.topk(2, dim=-1).values
            held = (top2[..., 0] - top2[..., 1] > 2 * diff[:, None]) & valid
            if not bool((k_logits.argmax(-1) == p_logits.argmax(-1))[held].all()):
                raise AssertionError("phase 10 (b): a bf16 step's argmax differs from the plain path's where the "
                                     "margin exceeds twice the logit difference")
            live = widths > 0
            n_rows += int(live.sum())
            n_held += int((held | ~valid).all(1)[live].sum())
        # The same pages through the plain path end to end: equal boxes,
        # texts counted.
        reset_result_cache()  # (the served answers are in it, under the same options)
        with plain_attention(ocr_modeling):
            plain_b = [mgr.predict(jpeg, det_threshold=0.3, box_threshold=0.3, rec_threshold=0.0, use_angle_cls=True)
                       for jpeg, _ in npages]
        n_equal, n_b = 0, 0
        for r, want in zip(served_b, plain_b):
            items = r["body"]["items"]
            if len(items) != len(want) or any(ref_quad_iou(it["box"], w.box) < OCR_IOU for it, w in zip(items, want)):
                raise AssertionError("phase 10 (b): the bf16 boxes differ from the plain path's")
            n_b += len(items)
            n_equal += sum(it["text"] == w.text for it, w in zip(items, want))
        log(f"phase 10 (b): native DBNetConfig {det_cfg.width}/{det_cfg.fpn_width}/{det_cfg.head_width} + SVTRConfig "
            f"{rec_cfg.width}x{rec_cfg.layers} ({rec_cfg.heads} heads of {rec_cfg.width // rec_cfg.heads}, vocab "
            f"{rec_cfg.vocab_size}) + ClsConfig {list(cls_cfg.channels)} (seeded, calibrated) written in {write_s:.1f} "
            f"s, served in bf16 in {bf16_load_s:.2f} s: {len(npages)} pages, {n_b} items with boxes equal to the plain "
            f"path's; each recognizer chunk rerun on both paths: CTC logits within {worst_d:.2e} of the plain path's "
            f"largest |logit| (tol {OCR_BF16_LOGIT_SHARE}), every step's argmax equal where the margin allows ("
            f"{n_held} of {n_rows} crops held whole); texts equal to the plain path's in {n_equal} of {n_b}; "
            f"flash_attention (head_dim 16) launches {launches} = {rec_cfg.layers} x {len(chunks)} recognizer chunks "
            f"{sorted(set(chunks))} [{card}]")
    finally:
        channel.close()
        handle.stop(grace=1.0)

    # float32: the card (IEEE) against the port's own CPU run of the same manager
    t0 = time.perf_counter()
    cpu = OcrManager(str(native_dir), dtype="float32", device="cpu", det_buckets=(320, 640, 960))
    cpu.initialize()
    try:
        metas, refs = [], []
        for jpeg, px in npages:
            boxed, _, _, _ = letterbox_numpy(px, det_bucket)
            prob = cpu._run_detector(cpu.det_vars, torch.from_numpy(boxed[None]))[0].numpy()
            det_thr, _ = gap_between(prob, 0.3, 0.1)
            # (box scores of the seeded net's fragmented contours run lower than
            # a trained one's: the box threshold comes from 0.2-0.6)
            scores = [s for _, s in cpu.detect(px, det_threshold=det_thr, box_threshold=0.0)]
            box_thr, _ = gap_between(scores, 0.4, 0.2)
            confs = [r.confidence for r in cpu.predict_tensor(px, det_threshold=det_thr, box_threshold=box_thr,
                                                              rec_threshold=0.0, use_angle_cls=True)]
            rec_thr, _ = gap_between(confs, 0.5, 0.1)
            m = {"det_thresh": det_thr, "box_thresh": box_thr, "rec_thresh": rec_thr, "use_angle_cls": "true"}
            metas.append(m)
            refs.append([(r.box, r.text, r.confidence) for r in cpu.predict(
                jpeg, det_threshold=det_thr, box_threshold=box_thr, rec_threshold=rec_thr, use_angle_cls=True)])
    finally:
        cpu.close()
    cpu_s = time.perf_counter() - t0
    reset_result_cache()
    settings = {"dtype": "float32", "batch_size": 8, "batch_buckets": [320, 640, 960]}
    handle, channel, stub, f32_load_s = boot_server(
        ocr_yaml(root / "native32.yaml", root / "cache", {"ocr": ("SmokeOCR", settings)}), device)
    try:
        with convolutions_tf32(False):
            served_f, _ = drive(stub, [(jpeg, m, "image/jpeg") for (jpeg, _), m in zip(npages, metas)])
    finally:
        channel.close()
        handle.stop(grace=1.0)
    worst_f, n_f = 1.0, 0
    for i, (r, want) in enumerate(zip(served_f, refs)):
        worst_f = min(worst_f, match_ocr(r["body"]["items"], want, f"phase 10 (b) float32 page {i}")[0])
        n_f += len(want)
    if n_f == 0:
        raise AssertionError("phase 10 (b): the CPU run reads no text on any page")
    log(f"phase 10 (b): float32 served in {f32_load_s:.2f} s; {len(npages)} pages ({n_f} items) equal to the port's "
        f"own CPU run ({cpu_s:.1f} s): IoU min {worst_f:.5f}, texts equal [{card}]")
    out.update(native_launches=launches, native_chunks=len(chunks), bf16_logit_share=worst_d, native_items=n_f,
               b_s=time.perf_counter() - t_phase - out["a_s"])

    # -- (c) the full tier: ocr + clip + face + vlm from one YAML ------------------------
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
    tier = {
        "ocr": ("PP-OCRv5_mobile", {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [320, 640, 960]}),
        "clip": ("SmokeCLIP", {"dtype": "bfloat16", "batch_size": 64}),
        "face": ("buffalo_l", {"dtype": "bfloat16", "batch_size": 16}),
        "vlm": ("SmokeVLM", {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [64, 128, 256, 512, 1024]}),
    }
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_GRPC_WORKERS=str(4 * in_flight + 8)):
        handle, channel, stub, hub_s = boot_server(ocr_yaml(root / "full.yaml", root / "cache", tier), device)
    try:
        from google.protobuf import empty_pb2

        _, call_ = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
        status = json.loads(dict(call_.trailing_metadata())["lumen-service-status"])
        if status != {name: "healthy" for name in tier} or any(getattr(s, "error", None) for s in handle.services.values()):
            raise AssertionError(f"phase 10 (c): service status {status}")
        for k in kernels.values():
            k.launches = 0
        n_vlm, n_img = 4, min(8, len(phase8["photos"]))
        n_face, n_ocr = min(4, len(phase9["face_photos"])), len(out["ocr_answers"])
        jobs = ([("vlm_generate_stream", phase6["photos"][i], {"messages": phase6["prompt"],
                                                              "max_new_tokens": phase6["budgets"][i]}, "image/jpeg")
                 for i in range(n_vlm)]
                + [("clip_image_embed", phase8["photos"][i], {}, "image/jpeg") for i in range(n_img)]
                + [("face_detect", phase9["face_photos"][i], {"conf_threshold": phase9["face_thr"][i]}, "image/jpeg")
                   for i in range(n_face)]
                + [("ocr", jpeg, meta, "image/jpeg") for jpeg, meta, _ in out["ocr_answers"].values()])
        t0 = time.perf_counter()
        with convolutions_tf32(False), ThreadPoolExecutor(len(jobs)) as ex:
            res = list(ex.map(lambda j: grpc_call(stub, j[0], j[1], j[2], mime=j[3]), jobs))
        hub_wall = time.perf_counter() - t0
        hub_launches = {name: kernels[name].launches for name in PHASE10_HUB_KERNELS}
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 10 (c): codes {[r['code'] for r in res]}")
        for i in range(n_vlm):
            want = phase6["streams"][i]
            if (res[i]["body"]["text"], res[i]["body"]["generated_tokens"]) != (want["text"], want["generated_tokens"]):
                raise AssertionError(f"phase 10 (c): caption stream {i} differs from phase 6's")
        cos = cosines(np.stack([r["body"]["vector"] for r in res[n_vlm:n_vlm + n_img]]), phase8["vecs"][:n_img])
        if cos.min() < CLIP_COSINE:
            raise AssertionError(f"phase 10 (c): embeddings vs phase 8's, cosine {cos.min():.6f}")
        for i in range(n_face):
            match_faces(res[n_vlm + n_img + i]["body"]["faces"], phase9["face_answers"][i], f"phase 10 (c) face {i}")
        for i, (_, _, want) in enumerate(out["ocr_answers"].values()):
            got = res[n_vlm + n_img + n_face + i]["body"]["items"]
            match_ocr(got, [(w["box"], w["text"], w["confidence"]) for w in want], f"phase 10 (c) page {i}")
        missing = [k for k, n in hub_launches.items() if n == 0 and k in PHASE10_HUB_KERNELS]
        if missing:
            raise AssertionError(f"phase 10 (c): never launched: {missing} ({hub_launches})")
        threads = [t.name for t in threading.enumerate()]
    finally:
        channel.close()
        handle.stop(grace=1.0)
    prefixes = ("face-", "clip-", "vlm-continuous")
    live = [t.name for t in threading.enumerate() if t.name.startswith(prefixes)]
    pool = get_decode_pool()
    procs = [w.proc for w in pool._workers_all]
    shutdown_decode_pool()
    alive = [p.pid for p in procs if p.poll() is None]
    if live or alive:
        raise AssertionError(f"phase 10 (c): after stop, threads {live} and decode workers {alive} still alive")
    log(f"phase 10 (c): the full tier (ocr, clip, face, vlm; one YAML in generate_config's shape) up in {hub_s:.2f} s, "
        f"every service healthy; {n_vlm} caption streams, {n_img} clip_image_embed, {n_face} face_detect and {n_ocr} "
        f"ocr at once in {hub_wall:.3f} s: captions equal to phase 6's, embeddings cosine min {cos.min():.6f} to "
        f"phase 8's, faces as phase 9's, OCR items as (a)'s; launches {json.dumps(hub_launches)}; stop retired "
        f"{len([t for t in threads if t.startswith(prefixes)])} batcher/engine threads and the decode pool's "
        f"{len(procs)} worker processes [{card}]")
    out.update(hub_s=hub_s, hub_launches=hub_launches, tier=tier, phase_s=time.perf_counter() - t_phase)
    return out


# -- phase 11: bulk ingest through the CLI, and search over gRPC ------------------

#: the kernels phase 11 (a)'s ingest must launch: the CLIP vision tower in
#: the dense sweep, the VLM's prefill and decode in the captions
PHASE11_KERNELS = ("flash_attention", "flash_attention_cache", "paged_attention")
#: (a): an ingested CLIP embedding against the served one of the same
#: pixels (both IEEE float32 convolutions; bf16 towers batched differently)
INGEST_COSINE = 0.9999
#: (b): served scores against the numpy oracle's (float32 products summed
#: in other orders), and the gap between the oracle's 10th and 11th
#: scores below which a query counts as a near-tie
SEARCH_SCORE_TOL = 1e-5
#: the H100 SXM's float32 rate outside the tensor cores (the ANN products
#: run IEEE float32; NVIDIA data sheet, dense)
FP32_FLOPS = 67e12
#: the CLI's default caption prompt
CAPTION_PROMPT = "Describe this photo in one sentence."


def ingest_photos(seed: int, n: int, width: int = 1600, height: int = 1200) -> list[bytes]:
    """``n`` distinct seeded photo-sized JPEGs: every fourth a page of dark
    text lines on a light ground (the OCR stand-ins' input), the rest
    tinted gradients with a little noise and three to five discs, bright
    ones on every fourth (offset 1: the face stand-ins' input). (Noise of
    std 10 makes the OCR stand-in read about a hundred boxes of noise a
    photo; at std 4 it reads two or three.)"""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    from lumen_tpu_torch.testing.ocr_standins import synthetic_page

    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([x / width, y / height, (x + y) / (width + height)], -1)

    def one(i: int) -> bytes:
        rng = np.random.default_rng(seed * 1000 + i)
        if i % 4 == 0:
            img = synthetic_page(seed * 1000 + i, width, height, lines=12)[0][:, :, ::-1]
        else:
            img = base * rng.uniform(40, 200, 3) + rng.normal(0, 4, (height, width, 3))
            lo = 200 if i % 4 == 1 else 0
            for _ in range(int(rng.integers(3, 6))):
                cx, cy, r = int(rng.integers(0, width)), int(rng.integers(0, height)), int(rng.integers(40, 150))
                cv2.circle(img, (cx, cy), r, tuple(float(v) for v in rng.uniform(lo, 255, 3)), -1)
        ok, buf = cv2.imencode(".jpg", np.clip(img, 0, 255).astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 90])
        if not ok:
            raise AssertionError("JPEG encode failed")
        return buf.tobytes()

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(n)))


def oracle_topk(scores, ids: list, k: int) -> tuple[list, list, float]:
    """``exact_oracle``'s answer from one column of precomputed scores
    (every row scoring at least the k-th score, ordered by score
    descending, then id ascending), and the gap between the k-th and the
    (k+1)-th scores."""
    import numpy as np

    top = np.sort(np.partition(scores, -(k + 1))[-(k + 1):])[::-1]
    cand = np.nonzero(scores >= top[k - 1])[0]
    order = sorted(cand, key=lambda i: (-float(scores[i]), ids[i]))[:k]
    return [ids[i] for i in order], [float(scores[i]) for i in order], float(top[k - 1] - top[k])


def match_near(got: list, want: list, thr: float, tol: float, what: str, iou_min: float, iou, same) -> dict:
    """One-to-one match of two answers computed from the same pixels in
    different batches: every item of either side scoring at least ``thr +
    tol`` matches an item of the other at ``iou >= iou_min`` with its
    confidence within ``tol`` and ``same(got, want)``; items within ``tol``
    above the threshold may be missing from the other side (counted as
    ``near``). Returns the min IoU, the matched and near counts."""
    left, out = list(range(len(want))), {"iou_min": 1.0, "matched": 0, "near": 0}
    for g in got:
        ious = [iou(g, want[j]) for j in left]
        j = left[max(range(len(ious)), key=ious.__getitem__)] if ious else None
        if j is not None and max(ious) >= iou_min and abs(g["confidence"] - want[j]["confidence"]) <= tol:
            if not same(g, want[j]):
                raise AssertionError(f"{what}: a matched item differs: {g} vs {want[j]}")
            left.remove(j)
            out["matched"] += 1
            out["iou_min"] = min(out["iou_min"], float(max(ious)))
        elif g["confidence"] < thr + tol:
            out["near"] += 1
        else:
            raise AssertionError(f"{what}: an ingested item (confidence {g['confidence']:.5f}, threshold {thr}) "
                                 f"matches no served item (best IoU {max(ious, default=0.0):.4f})")
    for j in left:
        if want[j]["confidence"] >= thr + tol:
            raise AssertionError(f"{what}: a served item (confidence {want[j]['confidence']:.5f}) was not ingested")
        out["near"] += 1
    return out


def drive_ingest(seed: int, card: str, root: Path, phase8: dict, phase9: dict, phase10: dict, device: str = "cuda:0",
                 n_photos: int = 128, n_captions: int = 16, n_square: int = 32, batch_size: int = 64,
                 photo_hw=(1200, 1600),
                 caption_tokens: int = 32, n_vectors: int = 200_000, chunk: int = 1024, n_queries: int = 512,
                 in_flight: int = 16) -> dict:
    """Phase 11: bulk ingest and search as users reach them, on phase 10
    (c)'s full tier plus ``search`` from one YAML. (a) ``n_photos`` distinct
    seeded JPEGs through ``python -m lumen_tpu_torch.pipeline.cli`` (called
    in process) with ``--families clip,face,ocr``, then ``n_captions`` of
    them again with ``vlm``; every row held to the served per-request
    answers of the same pixels, IEEE float32 convolutions on both sides;
    then a warm re-run on the server's managers: all cache hits, no kernel
    launch, ``index=`` fired on every hit into the search service. (b)
    ``n_vectors`` seeded unit vectors upserted over gRPC, ``n_queries``
    ``search_query`` calls held to the numpy oracle, and queries during an
    upsert flood. The sizes let the CPU tests rehearse it small."""
    import base64
    import warnings
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np
    import torch

    import lumen_tpu_torch.pipeline.photo as photo_mod
    from lumen_tpu_torch.pipeline import cli
    from lumen_tpu_torch.runtime.ann import _score_topk, ann_tile, exact_oracle, normalize
    from lumen_tpu_torch.runtime.decode_pool import get_decode_pool, shutdown_decode_pool
    from lumen_tpu_torch.runtime.fleet import fleet_devices
    from lumen_tpu_torch.runtime.mesh import build_mesh
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.utils.host_decode import decode_image_bytes_scaled
    from lumen_tpu_torch.utils.tensorwire import BUNDLE_MIME, TENSOR_MIME, pack_bundle, tensor_payload

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    kernels = {k.name: k for k in all_kernels()}
    dim = len(phase8["vecs"][0])
    out: dict = {}
    work = root / "ingest"
    photos_dir, caps_dir = work / "photos", work / "captions"
    photos_dir.mkdir(parents=True)
    caps_dir.mkdir()
    photos = ingest_photos(seed * 100 + 11, n_photos, width=photo_hw[1], height=photo_hw[0])
    for i, jpeg in enumerate(photos):
        (photos_dir / f"p{i:03d}.jpg").write_bytes(jpeg)
        if i < n_captions:
            (caps_dir / f"p{i:03d}.jpg").write_bytes(jpeg)
    tier = {**phase10["tier"], "search": ("ann-exact", {"batch_size": in_flight, "max_batch_latency_ms": 2.0})}
    yaml_path = ocr_yaml(work / "tier.yaml", root / "cache", tier)
    platform = [] if on_card else ["--platform", "cpu"]
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def ask(job) -> dict:
        r = grpc_call(stub, job[0], job[1], job[2], mime=job[3])
        if r["code"]:
            raise AssertionError(f"phase 11: {job[0]} answered code {r['code']}")
        return r

    def raw(arr) -> tuple[bytes, dict]:
        payload, meta = tensor_payload(np.ascontiguousarray(arr))
        return bytes(payload), meta

    # (a run on the CPU keeps the second server to one intra-op thread)
    vlm_server = ServerProcess("the VLM server", ocr_yaml(work / "vlm.yaml", root / "cache", {"vlm": tier["vlm"]}),
                               free_port(), device, work / "vlm_server.log",
                               {"LUMEN_VLM_SPEC_K": "0", "LUMEN_GRPC_WORKERS": str(in_flight + 8), "LUMEN_DRAIN_S": "0",
                                **({} if on_card else {"OMP_NUM_THREADS": "1"})})
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_ANN_DIM=str(dim), LUMEN_GRPC_WORKERS=str(4 * in_flight + 8)):
        try:
            handle, channel, stub, boot_s = boot_server(yaml_path, device)
        except BaseException:
            vlm_server.stop()
            raise
        try:
            from google.protobuf import empty_pb2

            _, call_ = stub.Health.with_call(empty_pb2.Empty(), timeout=30)
            status = json.loads(dict(call_.trailing_metadata())["lumen-service-status"])
            if status != {name: "healthy" for name in tier}:
                raise AssertionError(f"phase 11: service status {status}")
            clip_mgr = handle.services["clip"].managers["clip"]
            face_mgr, ocr_mgr = handle.services["face"].manager, handle.services["ocr"].manager
            size = clip_mgr.cfg.image_size
            max_edge = max(size, face_mgr.det_cfg.input_size, max(ocr_mgr.spec.det_buckets))

            # -- (a) served answers (tenant "served": their cache entries never
            # answer the ingest's default-tenant lookups, nor the reverse) ------
            with ThreadPoolExecutor(8) as ex:
                decoded = list(ex.map(lambda j: decode_image_bytes_scaled(j, color="rgb", max_edge=max_edge), photos))
            served_meta = {"tenant": "served"}
            jobs = [("clip_image_embed", *raw(cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)),
                     TENSOR_MIME) for img, _, _ in decoded]
            disc_idx = [i for i in range(n_photos) if i % 4 == 1]
            page_idx = [i for i in range(n_photos) if i % 4 == 0]
            jobs += [("face_detect_and_embed", *raw(decoded[i][0]), TENSOR_MIME) for i in disc_idx]
            jobs += [("ocr", *raw(decoded[i][0]), TENSOR_MIME) for i in page_idx]
            square = phase9["face_photos"][:n_square]
            jobs += [("face_detect_and_embed", jpeg, {}, "image/jpeg") for jpeg in square]
            for job in jobs:
                job[2].update(served_meta)
            t0 = time.perf_counter()
            with convolutions_tf32(False), ThreadPoolExecutor(in_flight) as ex:
                served = list(ex.map(ask, jobs))
            served_s = time.perf_counter() - t0
            clip_raw = np.stack([r["body"]["vector"] for r in served[:n_photos]])
            faces_served = dict(zip(disc_idx, (r["body"]["faces"] for r in served[n_photos:])))
            ocr_served = dict(zip(page_idx, (r["body"]["items"] for r in served[n_photos + len(disc_idx):])))
            square_served = [r["body"]["faces"] for r in served[n_photos + len(disc_idx) + len(page_idx):]]
            log(f"phase 11 (a): tier + search up in {boot_s:.2f} s, every service healthy; served answers (tenant "
                f"'served') of the ingest's own pixels as tensor/raw ({n_photos} clip_image_embed, "
                f"{len(disc_idx)} face_detect_and_embed of the disc photos, {len(page_idx)} ocr of the text pages) "
                f"and {len(square)} face_detect_and_embed of phase 9's square photos in {served_s:.2f} s [{card}]")

            # -- (a) the CLI: a cold dense sweep, then captions ---------------------------
            pipes: list = []
            caught: list = []

            class Counted(photo_mod.PhotoIngestPipeline):
                """The CLI's pipeline, zeroing the launch counts once the
                services are built (so the counts are the ingest's own)."""

                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    for k in kernels.values():
                        k.launches = 0
                    pipes.append(self)
                    if on_card:
                        torch.cuda.set_sync_debug_mode("warn")

            real = photo_mod.PhotoIngestPipeline
            photo_mod.PhotoIngestPipeline = Counted
            launches = {}
            pool_before = get_decode_pool().gauges().get("decodes_vlm_canvas", 0)
            try:
                with convolutions_tf32(False), warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    rows_path = work / "index.jsonl"
                    t0 = time.perf_counter()
                    if cli.main(["--config", str(yaml_path), "--input", str(photos_dir), "--output", str(rows_path),
                                 "--families", "clip,face,ocr", "--batch-size", str(batch_size), *platform]):
                        raise AssertionError("phase 11 (a): the CLI's dense sweep exited non-zero")
                    cli_s = time.perf_counter() - t0
                    if on_card:
                        torch.cuda.set_sync_debug_mode("default")
                    syncs_flagged = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
                    launches["sweep"] = {name: kernels[name].launches for name in PHASE11_KERNELS}
                    # The served captions come from a second server process
                    # (VLM only, booted at the start of the phase), beside the
                    # caption run: its launches are not this process's counts.
                    caps_path = work / "captions.jsonl"
                    vlm_stub = vlm_server.wait()
                    msgs = json.dumps([{"role": "user", "content": CAPTION_PROMPT}])
                    t0 = time.perf_counter()
                    with ThreadPoolExecutor(in_flight) as vex:
                        vlm_futs = [vex.submit(grpc_call, vlm_stub, "vlm_generate", photos[i],
                                               {"messages": msgs, "max_new_tokens": caption_tokens})
                                    for i in range(n_captions)]
                        if cli.main(["--config", str(yaml_path), "--input", str(caps_dir), "--output", str(caps_path),
                                     "--families", "clip,face,ocr,vlm", "--batch-size", str(batch_size),
                                     "--caption-max-tokens", str(caption_tokens), *platform]):
                            raise AssertionError("phase 11 (a): the CLI's caption run exited non-zero")
                        caption_s = time.perf_counter() - t0
                        answers = [f.result() for f in vlm_futs]
                    served_caption_s = time.perf_counter() - t0
                    if any(a["code"] for a in answers):
                        raise AssertionError(f"phase 11 (a): vlm_generate codes {[a['code'] for a in answers]}")
                    captions_served = [a["body"]["text"] for a in answers]
                    if on_card:
                        torch.cuda.set_sync_debug_mode("default")
                    launches["captions"] = {name: kernels[name].launches for name in PHASE11_KERNELS}
            finally:
                photo_mod.PhotoIngestPipeline = real
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
            vlm_canvas = get_decode_pool().gauges().get("decodes_vlm_canvas", 0) - pool_before
            sweep = pipes[0]
            stats = sweep.stats.as_dict()
            if sweep.decode_max_edge != max_edge:
                raise AssertionError(f"phase 11 (a): the ingest decoded at {sweep.decode_max_edge}, not {max_edge}")
            rows = [json.loads(line) for line in open(rows_path)]
            caps = [json.loads(line) for line in open(caps_path)]
            if len(rows) != n_photos or len(caps) != n_captions or any("error" in r for r in rows + caps):
                raise AssertionError(f"phase 11 (a): {len(rows)} rows, {len(caps)} caption rows, errors "
                                     f"{[r['error'] for r in rows + caps if 'error' in r]}")
            emb = np.stack([np.frombuffer(base64.b64decode(r["clip_embedding"]), "<f4") for r in rows])
            cos_raw = cosines(emb, clip_raw)
            if cos_raw.min() < INGEST_COSINE:
                raise AssertionError(f"phase 11 (a): ingested embeddings vs served, cosine {cos_raw.min():.6f}")
            face_thr = face_mgr.spec.score_threshold
            face_tally = {"matched": 0, "near": 0, "iou_min": 1.0}

            def hold_faces(got: list, want: list, what: str) -> None:
                t = match_near(got, want, face_thr, TF32_SCORE_TOL, what, FACE_IOU,
                               lambda g, w: box_iou(g["bbox"], w["bbox"]),
                               lambda g, w: float(np.dot(g["embedding"], w["embedding"])) >= FACE_COSINE)
                face_tally["matched"] += t["matched"]
                face_tally["near"] += t["near"]
                face_tally["iou_min"] = min(face_tally["iou_min"], t["iou_min"])

            ocr_tally = {"served": 0, "ingested": 0, "matched": 0, "texts_equal": 0}
            counted = {"faces": 0, "ocr_items": 0}  # off the disc photos and the text pages: not held
            for i, (row, (_, dscale, _)) in enumerate(zip(rows, decoded)):
                if i in faces_served:
                    hold_faces([dict(f, bbox=[v * dscale for v in f["bbox"]],
                                     embedding=np.frombuffer(base64.b64decode(f["embedding"]), "<f4"))
                                for f in row.get("faces", [])], faces_served[i], f"phase 11 (a) photo {i} faces")
                else:
                    counted["faces"] += len(row.get("faces", []))
                if i not in ocr_served:
                    counted["ocr_items"] += len(row.get("ocr", []))
                    continue
                # OCR as phase 10 holds its TF32 pass (a contour moves where a
                # pixel near the threshold rounds the other way): one to one at
                # IoU >= OCR_TF32_IOU, counted over the text pages.
                left = list(range(len(ocr_served[i])))
                ocr_tally["served"] += len(left)
                for it in row.get("ocr", []):
                    box = [[x * dscale, y * dscale] for x, y in it["box"]]
                    ious = [ref_quad_iou(box, ocr_served[i][j]["box"]) for j in left]
                    ocr_tally["ingested"] += 1
                    if ious and max(ious) >= OCR_TF32_IOU:
                        j = left.pop(int(np.argmax(ious)))
                        ocr_tally["matched"] += 1
                        ocr_tally["texts_equal"] += int(it["text"] == ocr_served[i][j]["text"])
            sweep_faces = face_tally["matched"]
            # Faces through the pipeline on the server's face manager, on
            # phase 9's square photos (the stand-in's calibration is square:
            # on a 4:3 photo its anchors in the letterbox's flat fill outscore
            # the photo's, and those boxes fall outside the image): the same
            # JPEG bytes the served answers decoded, at the same decode scale.
            t0 = time.perf_counter()
            with convolutions_tf32(False):
                face_pipe = photo_mod.PhotoIngestPipeline(build_mesh(devices=fleet_devices(dev)), face=face_mgr,
                                                          batch_size=min(batch_size, 32))
                for i, rec in enumerate(face_pipe.run(square)):
                    hold_faces([{"bbox": list(f.bbox), "confidence": f.confidence, "embedding": f.embedding}
                                for f in rec.faces], square_served[i], f"phase 11 (a) square photo {i} faces")
            square_s = time.perf_counter() - t0
            share = OCR_TF32_SHARE * ocr_tally["served"]
            if (not face_tally["matched"] or not ocr_tally["served"] or ocr_tally["matched"] < share
                    or ocr_tally["ingested"] - ocr_tally["matched"] > ocr_tally["served"] - share):
                raise AssertionError(f"phase 11 (a): faces {face_tally}, OCR items of the text pages {ocr_tally} "
                                     f"(tol {OCR_TF32_SHARE} of the served items at IoU >= {OCR_TF32_IOU})")
            for i, (row, cap) in enumerate(zip(rows, caps)):
                if cap["caption"] != captions_served[i]:
                    raise AssertionError(f"phase 11 (a): caption {i} {cap['caption']!r} != served "
                                         f"{captions_served[i]!r}")
                if {k: v for k, v in cap.items() if k not in ("caption", "path")} != {
                        k: v for k, v in row.items() if k != "path"}:
                    raise AssertionError(f"phase 11 (a): caption row {i}'s dense part differs from the sweep's")
            if vlm_canvas < n_captions:
                raise AssertionError(f"phase 11 (a): the decode pool counted {vlm_canvas} vlm_canvas decodes")
            missing = [k for k in PHASE11_KERNELS
                       if launches["sweep"][k] + launches["captions"][k] == 0]
            if missing:
                raise AssertionError(f"phase 11 (a): the ingest never launched {missing} ({launches})")
            log(f"phase 11 (a): CLI sweep of {n_photos} {photo_hw[1]}x{photo_hw[0]} JPEGs (clip, face, ocr; "
                f"batch {batch_size}; IEEE convolutions) {stats['items_per_sec']:.2f} images/s ({cli_s:.2f} s with "
                f"the CLI's own boot); stage stats {json.dumps(stats)}; embeddings cosine >= {cos_raw.min():.6f} to "
                f"the served ones; OCR items of the {len(page_idx)} text pages {json.dumps(ocr_tally)} held to the "
                f"served answers; faces: {sweep_faces} matched on the {len(disc_idx)} disc photos, "
                f"{face_tally['matched'] - sweep_faces} on {len(square)} square photos through the pipeline on the "
                f"server's face manager ({square_s:.2f} s), {json.dumps(face_tally)}; counted, not held (the other "
                f"photos): {json.dumps(counted)}; caption run {caption_s:.2f} s (beside {n_captions} vlm_generate of "
                f"a VLM server process, all answered in {served_caption_s:.2f} s): captions equal to the served ones, "
                f"{vlm_canvas} vlm_canvas decodes in the pool; launches {json.dumps(launches)}; syncs "
                f"flagged by the sync debug mode during the sweep {syncs_flagged} "
                f"({syncs_flagged / max(stats['batches'], 1):.1f} a batch), the pipeline's own fetches "
                f"{stats['syncs']} ({stats['syncs'] / max(stats['batches'], 1):.1f} a batch) [{card}]")

            # -- (b) 200k vectors upserted over gRPC ------------------------------------
            rng = np.random.default_rng(seed * 100 + 12)
            vecs = np.empty((n_vectors, dim), np.float32)
            for lo in range(0, n_vectors, chunk):
                vecs[lo:lo + chunk] = normalize(rng.standard_normal((min(chunk, n_vectors - lo), dim), dtype=np.float32))
            ids = [f"vec{i:06d}" for i in range(n_vectors)]
            bundles = [pack_bundle([vecs[lo:lo + chunk], np.frombuffer(json.dumps(ids[lo:lo + chunk]).encode(), np.uint8)])
                       for lo in range(0, n_vectors, chunk)]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(4) as ex:
                ups = list(ex.map(ask, [("search_upsert", b, {"priority": "bulk"}, BUNDLE_MIME) for b in bundles]))
            upsert_s = time.perf_counter() - t0
            if sum(r["body"]["added"] for r in ups) != n_vectors:
                raise AssertionError(f"phase 11 (b): {sum(r['body']['added'] for r in ups)} rows added")
            svc = handle.services["search"]
            shards = svc.index.shards_for("default")

            # -- (a) warm re-run on the server's managers, index= into search ------------
            indexed: list = []

            def to_index(sha: str, clip_out: dict) -> str:
                vec = np.asarray(clip_out["embedding"], np.float32)
                ask(("search_upsert", pack_bundle([vec[None], np.frombuffer(json.dumps([sha]).encode(), np.uint8)]),
                     {"priority": "bulk"}, BUNDLE_MIME))
                indexed.append((sha, vec))
                return "indexed"

            warm = photo_mod.PhotoIngestPipeline(
                build_mesh(devices=fleet_devices(dev)), clip=clip_mgr, face=face_mgr, ocr=ocr_mgr,
                batch_size=batch_size, on_decode_error="record", index=to_index)
            for k in kernels.values():
                k.launches = 0
            warm_records = list(warm.run(photos))
            warm_launches = {name: k.launches for name, k in kernels.items()}
            if warm.stats.cache_hit_rate != 1.0 or any(warm_launches.values()) or len(indexed) != n_photos:
                raise AssertionError(f"phase 11 (a): warm re-run hit rate {warm.stats.cache_hit_rate}, launches "
                                     f"{warm_launches}, {len(indexed)} indexed")
            if any(not np.array_equal(r.clip_embedding, e) for r, e in zip(warm_records, emb)):
                raise AssertionError("phase 11 (a): a warm record's embedding differs from the cold row's")
            # Device time of each stage on one full batch (CUDA events), the
            # batch the sweep ran first.
            stage_ms = {}
            if on_card:
                from lumen_tpu_torch.runtime.batcher import stack_and_pad, tree_map

                items = [warm._decode(p) for p in photos[:batch_size]]
                with convolutions_tf32(False):
                    for stage in warm.engine._device_stages:
                        staged = stack_and_pad([stage.preprocess(d) for d in items], batch_size)
                        batch = tree_map(lambda a: torch.from_numpy(a).to(dev), staged)
                        stage_ms[stage.name] = cuda_ms(lambda s=stage, b=batch: s.device_fn(b), iters=5, warmup=2)
            log(f"phase 11 (a): warm re-run on the server's managers: {warm.stats.as_dict()['items']} items, hit rate "
                f"{warm.stats.cache_hit_rate:.4f}, launches {json.dumps(warm_launches)}, index= fired {len(indexed)} "
                f"times (search_upsert over gRPC); device ms a {batch_size}-image batch "
                f"{json.dumps({k: round(v, 3) for k, v in stage_ms.items()})} [{card}]")

            # -- (b) 512 queries against the numpy oracle ---------------------------------
            photo_ids = [sha for sha, _ in indexed]
            photo_vecs = normalize(np.stack([v for _, v in indexed]))
            corpus = np.concatenate([vecs, photo_vecs])
            corpus_ids = ids + photo_ids
            queries = np.concatenate([
                normalize(rng.standard_normal((n_queries - n_photos, dim), dtype=np.float32)),
                np.stack([v for _, v in indexed]),
            ])
            t0 = time.perf_counter()
            scores = normalize(queries) @ corpus.T  # a row a query
            for j in range(2):  # the column oracle is exact_oracle's answer
                sub = slice(0, min(20_000, len(corpus)))
                want = exact_oracle(corpus_ids[sub], corpus[sub], queries[j], 10)
                got = oracle_topk(corpus[sub] @ normalize(queries[j])[0], corpus_ids[sub], 10)
                if got[0] != want[0]:
                    raise AssertionError("phase 11 (b): the column oracle differs from exact_oracle")
            oracle_s = time.perf_counter() - t0
            qjobs = [("search_query", *raw(q), TENSOR_MIME) for q in queries]
            for job in qjobs:
                job[2]["k"] = "10"
            before = {key: dict(b.stats) for key, b in svc._batchers.items()}
            t0 = time.perf_counter()
            with ThreadPoolExecutor(in_flight) as ex:
                answers = list(ex.map(ask, qjobs))
            query_s = time.perf_counter() - t0
            passes = {stat: sum(b.stats[stat] - before.get(key, {}).get(stat, 0) for key, b in svc._batchers.items())
                      for stat in ("items", "batches")}
            solo = np.sort([ask(job)["s"] * 1e3 for job in qjobs[:32]])  # one in flight
            near, worst = 0, 0.0
            for j, r in enumerate(answers):
                want_ids, want_scores, gap = oracle_topk(scores[j], corpus_ids, 10)
                got_ids, got_scores = r["body"]["ids"], r["body"]["scores"]
                worst = max(worst, float(np.abs(np.asarray(got_scores) - want_scores).max()))
                if gap < SEARCH_SCORE_TOL:
                    near += 1
                elif set(got_ids) != set(want_ids):
                    raise AssertionError(f"phase 11 (b): query {j} recall@10 {len(set(got_ids) & set(want_ids)) / 10}")
                if worst > SEARCH_SCORE_TOL:
                    raise AssertionError(f"phase 11 (b): query {j}'s scores differ from the oracle's by {worst:.2e}")
            self_rank1 = [answers[n_queries - n_photos + i]["body"]["ids"][0] == photo_ids[i] for i in range(n_photos)]
            if not all(self_rank1):
                raise AssertionError(f"phase 11 (b): {self_rank1.count(False)} ingested photos not at rank 1 of their "
                                     "own embedding")
            margin = min(answers[n_queries - n_photos + i]["body"]["scores"][0]
                         - answers[n_queries - n_photos + i]["body"]["scores"][1] for i in range(n_photos))
            lat = np.sort([r["s"] * 1e3 for r in answers])
            pct = lambda p: float(lat[min(len(lat) - 1, int(p * len(lat)))])  # noqa: E731

            # -- (b) queries during a bulk-upsert flood (one pinned shard) -----------------
            frng = np.random.default_rng(seed * 100 + 13)
            base = normalize(frng.standard_normal((40, dim), dtype=np.float32))
            fids = [f"f{i:03d}" for i in range(40)]
            versions = {vid: [v] for vid, v in zip(fids, base)}
            flood = {"tenant": "flood", "shard": "0", "priority": "bulk"}
            ask(("search_upsert", pack_bundle([base, np.frombuffer(json.dumps(fids).encode(), np.uint8)]), flood,
                 BUNDLE_MIME))
            fq = normalize(frng.standard_normal(dim, dtype=np.float32))[0]
            lock, done = threading.Lock(), threading.Event()
            steps = 10

            def writer():
                try:
                    for step in range(steps):
                        new = [f"n{step:02d}-{j}" for j in range(8)]
                        upd = [fids[(step * 8 + j) % 40] for j in range(8)]
                        vs = normalize(frng.standard_normal((16, dim), dtype=np.float32))
                        with lock:  # recorded before the upsert is sent
                            for vid, v in zip(new + upd, vs):
                                versions.setdefault(vid, []).append(v)
                        ask(("search_upsert", pack_bundle([vs, np.frombuffer(json.dumps(new + upd).encode(), np.uint8)]),
                             flood, BUNDLE_MIME))
                        time.sleep(0.01)
                finally:
                    done.set()

            def reader(_):
                seen = []
                payload, meta = raw(fq)
                while not done.is_set():
                    seen.append(ask(("search_query", payload, {**meta, "tenant": "flood", "shard": "0", "k": "128"},
                                     TENSOR_MIME))["body"])
                return seen

            t0 = time.perf_counter()
            with ThreadPoolExecutor(in_flight + 1) as ex:
                wfut = ex.submit(writer)
                seen = [b for part in ex.map(reader, range(in_flight)) for b in part]
                wfut.result()
            flood_s = time.perf_counter() - t0
            counts = sorted({len(b["ids"]) for b in seen})
            if not set(counts) <= {40 + 8 * j for j in range(steps + 1)} or len(counts) < 2:
                raise AssertionError(f"phase 11 (b): answer counts during the flood {counts}")
            for b in seen:
                for vid, s in zip(b["ids"], b["scores"]):
                    if not any(abs(float(v @ fq) - s) <= SEARCH_SCORE_TOL for v in versions.get(vid, [])):
                        raise AssertionError(f"phase 11 (b): {vid} at {s:.6f} matches no committed version")

            # -- (b) one scoring pass over the fullest shard ------------------------------
            full = max(shards.values(), key=lambda s: s.count)
            with full._lock:
                buf, n = full._buf, full._n
            pass_ms = bound_ms = None
            if on_card:
                qd = torch.from_numpy(normalize(queries[:in_flight])).to(dev)
                pass_ms = cuda_ms(lambda: _score_topk(buf, qd, n, 128, ann_tile()), iters=20)
                bound_ms = max(n * dim * 4 / HBM_BYTES_PER_S, 2 * in_flight * n * dim / FP32_FLOPS) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
            log(f"phase 11 (b): {n_vectors:,} unit vectors at dim {dim} upserted over gRPC in {len(bundles)} "
                f"{chunk}-row search_upsert calls (4 at once) in {upsert_s:.2f} s = {n_vectors / upsert_s:,.0f} rows/s, "
                f"{len(shards)} shards of {sorted(s.count for s in shards.values())} rows (capacity "
                f"{sorted(s.capacity for s in shards.values())}); {n_queries} search_query at k = 10, {in_flight} in "
                f"flight, in {query_s:.2f} s: p50 {pct(0.5):.2f} ms, p95 {pct(0.95):.2f} ms ({passes['items']} shard "
                f"queries in {passes['batches']} scoring passes; alone, p50 {float(solo[len(solo) // 2]):.2f} ms); "
                f"recall@10 = 1.0 against "
                f"the oracle ({oracle_s:.1f} s on the host) on every query but {near} near-ties (10th and 11th "
                f"within {SEARCH_SCORE_TOL}), scores within {worst:.2e}; {n_photos} photos at rank 1 of their own "
                f"embedding (margin >= {margin:.6f}); during a flood of {steps} bulk upserts (8 appends + 8 updates "
                f"in place each) {len(seen)} queries saw counts {counts}, every id committed, every score one of its "
                f"row's versions ({flood_s:.2f} s); one scoring pass over a {n}-row shard at {in_flight} queries "
                f"{'not measured' if pass_ms is None else f'{pass_ms:.4f} ms'}"
                f"{'' if bound_ms is None else f' (bound {bound_ms:.4f} ms, bytes vs fp32 FLOPs)'}; peak memory "
                f"{peak:.3f} GiB [{card}]")
            out.update(boot_s=boot_s, images_s=stats["items_per_sec"], stats=stats, launches=launches,
                       warm_launches=warm_launches, cos_min=float(cos_raw.min()), faces=face_tally, ocr=ocr_tally,
                       stage_ms=stage_ms, syncs_flagged=syncs_flagged, upsert_rows_s=n_vectors / upsert_s,
                       p50_ms=pct(0.5), p95_ms=pct(0.95), solo_p50_ms=float(solo[len(solo) // 2]),
                       mean_pass=passes["items"] / max(passes["batches"], 1), near_ties=near, score_err=worst, pass_ms=pass_ms,
                       pass_bound_ms=bound_ms, flood_queries=len(seen), flood_counts=counts, peak_gib=peak)
        finally:
            channel.close()
            handle.stop(grace=1.0)
            vlm_server.stop()
    shutdown_decode_pool()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- phase 12: every VLM and CLIP serving option ------------------------------------

#: the kernels phase 12 requires: (a) the graph-tower captions on the
#: continuous engine, (c) the coalescer's prefill, and its int8 decode
PHASE12_GRAPH_KERNELS = ("flash_attention_cache", "paged_attention")
PHASE12_COALESCE_KERNELS = ("flash_attention_cache",)
PHASE12_COALESCE_INT8_KERNELS = ("flash_attention_cache", "w8a16_matmul")
#: (d): the W8A8 CLIP towers launch the flash kernel in every block
PHASE12_CLIP_KERNELS = ("flash_attention",)
#: (a): the graph tower on the card (IEEE float32) against the stand-in
#: module's float32 forward on the same pixels: |diff| <= this x max |want|
GRAPH_TOWER_TOL = 1e-4
#: (d): W8A8 CLIP embeddings against the bf16 ones (the JAX suite's int8
#: bound, ``tests/test_clip_quant.py``)
Q8_CLIP_COSINE = 0.98
#: (b): the A/B's device memory above its start may pass the bf16
#: decoder's bytes by this much (KV pool, activations, logits), which is
#: short of the int8 decoder's bytes: two decoder sets at once fail
AB_MEMORY_MARGIN = 256 * 2**20
#: (c): a prompt of the 128 bucket (the short one takes the 64 bucket)
LONG_PROMPT = ("describe this photo in one detailed sentence : " + "a red car on a wet road , " * 12).strip()


def write_fastvlm_dir(root: Path, src: Path, name: str, tower_cfg, seed: int) -> tuple[Path, float]:
    """A FastVLM-style model directory from phase 6's: the checkpoint
    without its vision tower (decoder only, HF names), phase 6's
    ``config.json``, tokenizer and chat template, and the FastViTHD
    stand-in exported as ``onnx/vision_encoder.onnx`` at the canvas size;
    returns it and the export's seconds."""
    import torch
    from safetensors.torch import load_file, save_file

    from lumen_tpu_torch.testing.fastvlm_standins import fastvithd_standin
    from lumen_tpu_torch.testing.onnx_export import export_onnx

    model_dir = root / "models" / name
    (model_dir / "onnx").mkdir(parents=True)
    state = load_file(str(src / "model.safetensors"))
    save_file({k: v for k, v in state.items() if not k.startswith(("vision_tower.", "multi_modal_projector."))},
              str(model_dir / "model.safetensors"))
    del state
    for f in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        shutil.copy(src / f, model_dir / f)
    (model_dir / "model_info.json").write_text(json.dumps({
        "name": name, "version": "1.0.0", "description": "FastVLM-shaped: decoder weights + an exported vision tower",
        "model_type": "vlm", "source": {"format": "custom", "repo_id": f"LumilioPhotos/{name}"},
        "runtimes": {"jax": {"available": True, "files": ["model.safetensors", "onnx/vision_encoder.onnx"]}},
    }))
    t0 = time.perf_counter()
    tower = fastvithd_standin(seed, tower_cfg)
    size = tower_cfg.image_size
    with torch.no_grad():
        export_onnx(tower, (torch.zeros(1, 3, size, size),), str(model_dir / "onnx" / "vision_encoder.onnx"),
                    input_names=["pixel_values"], dynamic_axes={"pixel_values": {0: "b"}})
    return model_dir, time.perf_counter() - t0


def drive_vlm_options(seed: int, card: str, root: Path, phase6: dict, phase8: dict, device: str = "cuda:0",
                      tower_cfg=None, n_captions: int = 8, n_streams: int = 2, tokens: int = 24,
                      clip_batch: int = 64) -> dict:
    """Phase 12: the VLM and CLIP options of the JAX managers. (a) a
    FastVLM-style directory (phase 6's decoder, the FastViTHD stand-in as
    ``onnx/vision_encoder.onnx``, no native tower) served by ``serve()``
    from a YAML in ``generate_config``'s shape; (b) the VLM int8 route's
    warm-up A/B and its verdict file; (c) ``scheduler: coalesce`` in bf16
    and int8 on phase 6's directory; (d) CLIP ``quantize: int8`` (W8A8) on
    phase 8's directory. ``tower_cfg``/``device`` and the counts let the
    CPU tests rehearse it small; its launch-count gates then fail unless
    emptied."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from lumen_tpu_torch.models.clip import CLIPManager
    from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
    from lumen_tpu_torch.models.vlm import modeling as vlm_modeling
    from lumen_tpu_torch.runtime.decode_pool import shutdown_decode_pool
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.testing.fastvlm_standins import FastViTHDConfig, fastvithd_standin
    from lumen_tpu_torch.utils.host_decode import vlm_canvas
    from lumen_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    kernels = {k.name: k for k in all_kernels()}
    cfg = vlm_config_of(phase6["model_dir"])
    tower_cfg = tower_cfg or FastViTHDConfig(hidden_size=cfg.decoder.hidden_size, image_size=cfg.vision.image_size)
    photos, prompt = phase6["photos"], phase6["prompt"]
    question = json.loads(prompt)[0]["content"]
    n = n_captions + n_streams
    out: dict = {"launches": {}}

    def reset_launches():
        for k in kernels.values():
            k.launches = 0

    def launched(names) -> dict:
        return {name: kernels[name].launches for name in names}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # -- (a) FastVLM-0.5B's shape: the exported vision tower on the bridge ----------
    fast_dir, export_s = write_fastvlm_dir(root / "cache", Path(phase6["model_dir"]), "SmokeFastVLM", tower_cfg, seed + 12)
    onnx_mb = (fast_dir / "onnx" / "vision_encoder.onnx").stat().st_size / 2**20
    log(f"phase 12 (a): FastViTHD stand-in (layers {list(tower_cfg.layers)}, widths {list(tower_cfg.embed_dims)}, "
        f"expansion {tower_cfg.out_width}, projector -> {tower_cfg.hidden_size}) exported at {tower_cfg.image_size} px in "
        f"{export_s:.1f} s ({onnx_mb:.0f} MiB); the directory holds no native vision weights")
    reset_result_cache()
    if on_card:
        torch.cuda.empty_cache()
    vlm_settings = {"dtype": "bfloat16", "batch_size": 8, "batch_buckets": [64, 128, 256, 512, 1024]}
    with env(LUMEN_VLM_SPEC_K="0", LUMEN_GRPC_WORKERS=str(n + 8)):
        handle, channel, stub, load_s = boot_server(
            ocr_yaml(root / "fastvlm.yaml", root / "cache", {"vlm": ("SmokeFastVLM", vlm_settings)}), device)
    try:
        mgr = handle.services["vlm"].manager
        if mgr._vision_graph is None or mgr.vision_tokens != tower_cfg.num_tokens:
            raise AssertionError(f"phase 12 (a): the vlm service serves no graph tower ({mgr.vision_tokens} tokens)")
        reset_launches()
        metas = [{"messages": prompt, "max_new_tokens": tokens}] * n
        tasks = ["vlm_generate"] * n_captions + ["vlm_generate_stream"] * n_streams
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n) as ex:
            res = list(ex.map(lambda i: grpc_call(stub, tasks[i], photos[i], metas[i]), range(n)))
        wall = time.perf_counter() - t0
        drive_peak_mib = (torch.cuda.max_memory_allocated() - mem0) / 2**20 if on_card else 0.0
        graph_launches = launched(kernels)
        if any(r["code"] for r in res):
            raise AssertionError(f"phase 12 (a): codes {[r['code'] for r in res]}")
        missing = [k for k in PHASE12_GRAPH_KERNELS if graph_launches[k] == 0]
        if missing:
            raise AssertionError(f"phase 12 (a): never launched {missing} ({graph_launches})")
        msgs = [ChatMessage("user", question)]
        for i, r in enumerate(res):
            if i < n_captions:
                alone = mgr._generate_uncached(msgs, None, tokens, 0.0, 1.0, False, 1.0, None, True, photos[i])
                same = (alone.text, len(alone.tokens)) == (r["body"]["text"], r["body"]["generated_tokens"])
            else:
                text = "".join(c.text for c in mgr.generate_stream(msgs, image_bytes=photos[i], max_new_tokens=tokens))
                same = text == b"".join(r["deltas"]).decode() == r["body"]["text"]
            if not same:
                raise AssertionError(f"phase 12 (a): request {i} ({tasks[i]}) differs from the manager's rerun alone")
        ttfts = sorted(r["ttft_ms"] for r in res[n_captions:])
        lat = sorted(r["s"] * 1e3 for r in res[:n_captions])
        # the graph tower against the stand-in module, IEEE float32 on both sides
        canvas = torch.from_numpy(vlm_canvas(photos[0], cfg.vision.image_size)).to(mgr.device)
        x = ((canvas[None].float() / 255.0 - mgr._mean) / mgr._std).permute(0, 3, 1, 2).contiguous()
        tower = fastvithd_standin(seed + 12, tower_cfg).to(mgr.device)
        with convolutions_tf32(False), torch.no_grad():
            got = mgr._vision_graph(mgr._vision_params, x).float()
            want = tower(x).float()
        del tower
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not torch.isfinite(got).all() or err > GRAPH_TOWER_TOL * scale:
            raise AssertionError(f"phase 12 (a): graph tower vs the stand-in module: max|diff| {err:.3e} "
                                 f"(scale {scale:.3e})")
        ids = torch.full((1, 64), cfg.pad_token_id, device=mgr.device)
        ids[0, 0] = cfg.image_token_id
        length = torch.tensor([20], device=mgr.device)
        prepare_syncs = count_syncs(lambda: mgr._prepare(canvas[None], ids, length)) if on_card else 0
        if prepare_syncs:
            raise AssertionError(f"phase 12 (a): _prepare made {prepare_syncs} device-to-host syncs")
        tower_ms = cuda_ms(lambda: mgr._vision_graph(mgr._vision_params, x), 5, warmup=1) if on_card else 0.0
        walls = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            mgr._vision_graph(mgr._vision_params, x)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        tower_wall_ms = min(walls)
        n_nodes = len(mgr._vision_graph.module.graph.nodes)
    finally:
        channel.close()
        handle.stop(grace=1.0)
    vision_tokens = mgr.vision_tokens
    del mgr, handle  # (b) measures device memory: (a)'s weights go first
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["launches"]["(a)"] = graph_launches
    log(f"phase 12 (a): vlm service up in {load_s:.2f} s with the graph tower ({n_nodes} nodes, "
        f"{vision_tokens} tokens); {n_captions} vlm_generate + {n_streams} streams of 1600x1200 JPEGs at once in "
        f"{wall:.3f} s, each equal to the manager's rerun alone; stream ttft_ms {[round(t, 1) for t in ttfts]} "
        f"(p50 {ttfts[len(ttfts) // 2]:.1f}), caption latency p50 {lat[len(lat) // 2]:.0f} ms; graph tower "
        f"{tower_ms:.2f} ms a 1-image forward (CUDA events, TF32 convolutions; {tower_wall_ms:.2f} ms of host wall, "
        f"synchronized, on an idle server) and IEEE max|diff| {err:.3e} vs the "
        f"stand-in module (scale {scale:.3e}); _prepare syncs {prepare_syncs}; device memory {mem0 / 2**30:.3f} GiB at the "
        f"drive's start, peak {drive_peak_mib:.1f} MiB above it; launches {json.dumps(graph_launches)} [{card}]")
    out.update(export_s=export_s, fast_load_s=load_s, tower_ms=tower_ms, tower_wall_ms=tower_wall_ms,
               ttft_p50_ms=ttfts[len(ttfts) // 2], drive_peak_mib=drive_peak_mib,
               prepare_syncs=prepare_syncs, tower_err=err, tower_nodes=n_nodes)

    # -- (b) the VLM int8 route: warm-up A/Bs, verdict file, a boot that reads it ------
    # Boots 1 and 2 each time the A/B (the verdict file is removed between
    # them: the spread of its ratio between boots); boot 3 reads the file.
    src_dir = Path(phase6["model_dir"])
    verdict_path = src_dir / ".lumen_q8_verdict.json"
    rates: list = []
    ab_mem: list = []
    real_time, real_ab = VLMManager._time_decode_route, VLMManager._q8_decode_ab

    def timed(self, route_cfg, state):
        rate = real_time(self, route_cfg, state)
        rates.append((route_cfg.decoder.weight_quant or "bf16", rate))
        return rate

    def measured_ab(self, base_cfg, q_cfg, cast, qstate):
        decoder_bytes = [sum(t.numel() * t.element_size() for k, t in st.items() if not k.startswith("vision."))
                         for st in (cast, qstate)]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        try:
            return real_ab(self, base_cfg, q_cfg, cast, qstate)
        finally:
            peak = torch.cuda.max_memory_allocated() - base if on_card else 0
            ab_mem.append(dict(peak=peak, bf16=decoder_bytes[0], int8=decoder_bytes[1]))

    VLMManager._time_decode_route, VLMManager._q8_decode_ab = timed, measured_ab
    boots = []
    try:
        for attempt in range(3):
            if attempt == 1:
                verdict_path.unlink()
            reset_result_cache()
            if on_card:
                torch.cuda.empty_cache()
            with env(LUMEN_VLM_SPEC_K="0", LUMEN_VLM_Q8_ROUTE="auto"):
                handle, channel, stub, boot_s = boot_server(deployment_yaml(
                    root / "q8auto.yaml", root / "cache", "SmokeVLM", "int8", extra={"warmup": True}), device)
            try:
                mgr = handle.services["vlm"].manager
                verdict = json.loads(verdict_path.read_text())
                gauges = metrics.snapshot()["gauges"].get(f"vlm-quant:{mgr.model_id}")
                cap_route = handle.services["vlm"].capability().extra["quant_route"]
                reset_launches()
                r = grpc_call(stub, "vlm_generate", photos[0], {"messages": prompt, "max_new_tokens": 8})
                boots.append(dict(boot_s=boot_s, route=mgr.quant_route, speedup=mgr.quant_speedup, verdict=verdict,
                                  gauges=gauges, cap_route=cap_route, code=r["code"],
                                  w8a16=kernels["w8a16_matmul"].launches))
            finally:
                channel.close()
                handle.stop(grace=1.0)
            del mgr, handle
    finally:
        VLMManager._time_decode_route, VLMManager._q8_decode_ab = real_time, real_ab
    first, again, reader = boots
    if [q for q, _ in rates] != ["bf16", "int8"] * 2:
        raise AssertionError(f"phase 12 (b): boots 1 and 2 timed {rates}; boot 3 must not")
    for b in boots:
        want_gauges = {"int8_active": int(b["verdict"]["route"] == "int8"),
                       "q8_speedup_pct": round(b["verdict"]["q8_speedup"] * 100, 1)}
        if b["route"] != b["verdict"]["route"] or b["cap_route"] != b["route"] or b["gauges"] != want_gauges \
                or b["code"] or (on_card and (b["route"] == "int8") != (b["w8a16"] > 0)):
            raise AssertionError(f"phase 12 (b): a boot's route, verdict and gauges disagree: {b}")
    if reader["verdict"] != again["verdict"]:
        raise AssertionError("phase 12 (b): boot 3 rewrote the verdict file")
    # The A/B holds one decoder set at a time: its peak above what the
    # device held before it stays under the bf16 decoder plus a working
    # margin, well short of both sets together.
    for m in ab_mem:
        if on_card and not m["peak"] <= m["bf16"] + AB_MEMORY_MARGIN < m["bf16"] + m["int8"]:
            raise AssertionError(f"phase 12 (b): the A/B's peak {m['peak']} B above its start exceeds the bf16 "
                                 f"decoder ({m['bf16']} B) + {AB_MEMORY_MARGIN} B (int8 decoder {m['int8']} B)")
    ratios = [rates[1][1] / rates[0][1], rates[3][1] / rates[2][1]]
    log(f"phase 12 (b): LUMEN_VLM_Q8_ROUTE=auto, warmup, scheduler continuous: A/B decode (the engine's step_block, "
        f"batch 4, 64 tokens a row; best of 2) {rates[0][1]:.1f} tok/s bf16 vs {rates[1][1]:.1f} int8 -> "
        f"{first['route']} ({ratios[0]:.3f}x); a second boot's A/B {rates[2][1]:.1f} vs {rates[3][1]:.1f} -> "
        f"{again['route']} ({ratios[1]:.3f}x); device memory above the A/B's start, peak "
        f"{[round(m['peak'] / 2**20, 1) for m in ab_mem]} MiB (bf16 decoder {ab_mem[0]['bf16'] / 2**20:.1f} MiB, "
        f"int8 {ab_mem[0]['int8'] / 2**20:.1f} MiB); verdict {json.dumps(again['verdict'])}; boots "
        f"{first['boot_s']:.2f} / {again['boot_s']:.2f} s (A/B) then {reader['boot_s']:.2f} s (verdict read, no "
        f"probe); served route {reader['route']}, gauges {json.dumps(reader['gauges'])}, w8a16 launches "
        f"{reader['w8a16']} [{card}]")
    out.update(ab_bf16_tps=[rates[0][1], rates[2][1]], ab_q8_tps=[rates[1][1], rates[3][1]], ab_ratios=ratios,
               ab_route=first["route"], ab_peak_mib=[m["peak"] / 2**20 for m in ab_mem],
               boot_ab_s=[first["boot_s"], again["boot_s"]], boot_verdict_s=reader["boot_s"])

    # -- (c) scheduler: coalesce, bf16 then int8 ------------------------------------
    questions = [question if i % 2 == 0 else LONG_PROMPT for i in range(n)]
    for quantize in (None, "int8"):
        tag = quantize or "bf16"
        reset_result_cache()
        if on_card:
            torch.cuda.empty_cache()
        with env(LUMEN_VLM_SPEC_K="0", LUMEN_VLM_Q8_ROUTE="int8", LUMEN_GRPC_WORKERS=str(n + 8)):
            handle, channel, stub, boot_s = boot_server(deployment_yaml(
                root / f"coalesce-{tag}.yaml", root / "cache", "SmokeVLM", quantize,
                extra={"scheduler": "coalesce"}), device)
        try:
            mgr = handle.services["vlm"].manager
            if mgr.scheduler != "coalesce" or mgr.quant_route != tag:
                raise AssertionError(f"phase 12 (c): serving {mgr.scheduler} / {mgr.quant_route}")
            reset_launches()
            batches0 = mgr._batcher.batches_run
            t0 = time.perf_counter()
            with ThreadPoolExecutor(n) as ex:
                res = list(ex.map(lambda i: grpc_call(
                    stub, tasks[i], photos[i], {"messages": json.dumps([{"role": "user", "content": questions[i]}]),
                                                "max_new_tokens": tokens}), range(n)))
            wall = time.perf_counter() - t0
            co_launches = launched(kernels)
            batches = mgr._batcher.batches_run - batches0
            if any(r["code"] for r in res):
                raise AssertionError(f"phase 12 (c) {tag}: codes {[r['code'] for r in res]}")
            need = PHASE12_COALESCE_INT8_KERNELS if quantize else PHASE12_COALESCE_KERNELS
            missing = [k for k in need if co_launches[k] == 0]
            if missing:
                raise AssertionError(f"phase 12 (c) {tag}: never launched {missing} ({co_launches})")
            differ = []
            for i, r in enumerate(res):
                msgs = [ChatMessage("user", questions[i])]
                if i < n_captions:
                    alone = mgr._generate_uncached(msgs, None, tokens, 0.0, 1.0, False, 1.0, None, True, photos[i])
                    if (alone.text, len(alone.tokens)) != (r["body"]["text"], r["body"]["generated_tokens"]):
                        differ.append(i)
                else:
                    text = "".join(c.text for c in mgr.generate_stream(msgs, image_bytes=photos[i],
                                                                       max_new_tokens=tokens))
                    if text != b"".join(r["deltas"]).decode():
                        differ.append(i)
            if differ:
                raise AssertionError(f"phase 12 (c) {tag}: requests {differ} differ from their rerun alone")
            # device-to-host syncs a decode step: two fused decodes of 8 and
            # 24 tokens over the same prompts, and the old per-layer ladder
            # read (the decode step without the host's bound) for comparison
            prepared = [mgr._make_gen_request([ChatMessage("user", question)], None, tokens, 0.0, 1.0, False,
                                              1.0, True, photos[i])[0] for i in range(min(4, n))]
            rows = dict(embeds=torch.cat([p.embeds for p in prepared]),
                        positions=torch.cat([p.positions for p in prepared]),
                        lengths=np.asarray([p.n_prompt for p in prepared]),
                        prompt_ids=torch.cat([p.prompt_ids for p in prepared]))
            gen = mgr.generator

            def decode(steps):
                o = gen.generate(rows["embeds"], rows["positions"], rows["lengths"], rows["prompt_ids"],
                                 torch.Generator(device=mgr.device), max_new_tokens=steps)
                return int(o.n_generated.max())

            def per_step() -> float:
                if not on_card:
                    decode(2)  # the path runs; the CPU counts no device syncs
                    return 0.0
                s8, s24 = count_syncs(lambda: decode(8)), count_syncs(lambda: decode(24))
                return (s24 - s8) / max(decode(24) - decode(8), 1)

            syncs = per_step()
            real_cached = vlm_modeling.attention_cached

            def ladder_read(*args, kv_bound=None, **kw):
                return real_cached(*args, **kw)

            vlm_modeling.attention_cached = ladder_read
            try:
                syncs_old = per_step()
            finally:
                vlm_modeling.attention_cached = real_cached
            if syncs > 1:
                raise AssertionError(f"phase 12 (c) {tag}: {syncs} device-to-host syncs a decode step")
            tok = sum(r["body"]["generated_tokens"] for r in res)
        finally:
            channel.close()
            handle.stop(grace=1.0)
        out["launches"][f"(c) {tag}"] = co_launches
        log(f"phase 12 (c) scheduler: coalesce, {tag}: up in {boot_s:.2f} s; {n_captions} vlm_generate + {n_streams} "
            f"streams over the 64 and 128 prompt buckets at once, {tok} tokens in {wall:.3f} s ({tok / wall:.1f} tok/s) in "
            f"{batches} batches, each answer equal to its rerun alone; device-to-host syncs a decode step {syncs:.2f} "
            f"(the per-layer ladder read: {syncs_old:.2f}); launches {json.dumps(co_launches)} [{card}]")
        out[f"coalesce_{tag}"] = dict(tok_s=tok / wall, syncs=syncs, syncs_old=syncs_old, batches=batches)

    # -- (d) CLIP ViT-B/32 quantize: int8 (W8A8) at batch 64 --------------------------
    clip_dir = str(root / "cache" / "models" / "SmokeCLIP")
    times: list = []
    real_clip_time = CLIPManager._time_image_encode

    def clip_timed(self, model):
        t = real_clip_time(self, model)
        times.append(t)
        return t

    CLIPManager._time_image_encode = clip_timed
    try:
        reset_result_cache()
        with env(LUMEN_CLIP_Q8_ROUTE="auto"):
            t0 = time.perf_counter()
            auto = CLIPManager(clip_dir, dataset="Smoke1k", dtype="bfloat16", batch_size=clip_batch, warmup=True,
                               quantize="int8", device=device)
            auto.initialize()
            auto_s = time.perf_counter() - t0
        try:
            auto_route, auto_speedup = auto.quant_route, auto.quant_speedup
            auto_gauges = metrics.snapshot()["gauges"][f"clip-quant:{auto.model_id}"]
        finally:
            auto.close()
    finally:
        CLIPManager._time_image_encode = real_clip_time
    if len(times) != 2 or auto_gauges != {"int8_active": int(auto_route == "int8"),
                                          "q8_speedup_pct": round(auto_speedup * 100, 1)}:
        raise AssertionError(f"phase 12 (d): the A/B timed {times}, gauges {auto_gauges}")
    n_ref = min(len(phase8["photos"]), clip_batch)
    ref_vecs = np.asarray(phase8["vecs"][:n_ref])
    clip_photos = list(phase8["photos"][:n_ref])
    if clip_batch > n_ref:
        clip_photos += photo_batch(seed * 100 + 12, clip_batch - n_ref)
    reset_result_cache()
    with env(LUMEN_CLIP_Q8_ROUTE="int8"):
        t0 = time.perf_counter()
        q8 = CLIPManager(clip_dir, dataset="Smoke1k", dtype="bfloat16", batch_size=clip_batch, quantize="int8",
                         device=device)
        q8.initialize()
        q8_s = time.perf_counter() - t0
    try:
        if q8.quant_route != "int8" or metrics.snapshot()["gauges"][f"clip-quant:{q8.model_id}"]["int8_active"] != 1:
            raise AssertionError("phase 12 (d): the pinned int8 boot does not serve int8")
        reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(clip_photos)) as ex:
            vecs = np.stack(list(ex.map(q8.encode_image, clip_photos)))
        clip_wall = time.perf_counter() - t0
        clip_launches = launched(PHASE12_CLIP_KERNELS)
    finally:
        q8.close()
    missing = [k for k, v in clip_launches.items() if v == 0]
    cos = cosines(vecs[: len(ref_vecs)], ref_vecs)
    if missing or not np.isfinite(vecs).all() or cos.min() < Q8_CLIP_COSINE:
        raise AssertionError(f"phase 12 (d): launches {clip_launches}, W8A8 vs bf16 cosine min {cos.min():.6f}")
    out["launches"]["(d)"] = clip_launches
    log(f"phase 12 (d): CLIP quantize: int8 (W8A8, torch._int_mm), LUMEN_CLIP_Q8_ROUTE=auto with warmup: a batch of "
        f"{clip_batch} in {times[0] * 1e3:.3f} ms bf16 vs {times[1] * 1e3:.3f} ms int8 ({clip_batch / times[0]:.0f} vs "
        f"{clip_batch / times[1]:.0f} images/s, best of 3) -> {auto_route} ({auto_speedup:.3f}x), boot {auto_s:.2f} s; "
        f"a pinned int8 boot ({q8_s:.2f} s) embeds {len(clip_photos)} photos in {clip_wall:.3f} s, W8A8 vs phase 8's "
        f"bf16 cosine min {cos.min():.6f} (bound {Q8_CLIP_COSINE}) over {len(ref_vecs)}; launches "
        f"{json.dumps(clip_launches)} [{card}]")
    shutdown_decode_pool()
    out.update(clip_bf16_ms=times[0] * 1e3, clip_q8_ms=times[1] * 1e3, clip_route=auto_route, clip_cos=float(cos.min()),
               phase_s=time.perf_counter() - t_phase)
    return out


# -- phase 13: a disaggregated fleet on one card ----------------------------------

#: the kernels the decode host must launch for migrated rows, and the one it
#: must never launch for them (it prefills nothing)
PHASE13_DECODE_KERNELS = ("paged_attention",)
PHASE13_NO_PREFILL = ("flash_attention_cache",)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def fleet_yaml(path: Path, cache_dir: Path, model: str, port: int, enabled: bool = True) -> Path:
    """Phase 6's bf16 deployment (8 slots, page size 16) on ``port``; with
    ``enabled`` false the same file boots a front tier (no service)."""
    import yaml

    deployment_yaml(path, cache_dir, model, None)
    spec = yaml.safe_load(path.read_text())
    spec["server"]["port"] = port
    spec["services"]["vlm"]["enabled"] = enabled
    path.write_text(yaml.safe_dump(spec))
    return path


def serve_host(argv: list[str]) -> int:
    """The port's server CLI with a readout (``chip_smoke.py --serve-host``
    and the CLI's own arguments): ``lumen_tpu_torch.serving.server.main``,
    whose hook zeroes every kernel's launch count and the peak-memory mark
    once the server answers and prints ``{"serving": port, "metrics_port":
    ...}``; after SIGTERM and the drain, the last line is ``{"launches":
    ..., "peak_gib": ..., "cuda_initialized": ...}``: what the host did
    while it served."""
    import torch

    from lumen_tpu_torch.serving import server

    kernels = all_kernels()

    def serving(handle) -> None:
        for k in kernels:
            k.launches = 0
        if torch.cuda.is_initialized():
            torch.cuda.reset_peak_memory_stats()
        sidecar = handle.metrics_server
        print(json.dumps({"serving": handle.port, "metrics_port": sidecar.port if sidecar else None}), flush=True)

    rc = server.main(argv, on_serving=serving)
    cuda = torch.cuda.is_initialized()
    print(json.dumps({"launches": {k.name: k.launches for k in kernels}, "cuda_initialized": cuda,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0}), flush=True)
    return rc


#: the keys of a ``--serve-host`` process's last line
READOUT_KEYS = frozenset({"launches", "cuda_initialized", "peak_gib"})


class ServerProcess:
    """The port's server CLI in a process of its own on ``port``, started at
    construction: ``python -m lumen_tpu_torch.serving.server``, or with
    ``readout`` the same CLI under ``chip_smoke.py --serve-host`` (with its
    metrics sidecar), which reports the launches and peak memory it had
    while it served. :meth:`wait` gives a stub once the server answers;
    :meth:`stop` sends SIGTERM (a graceful drain) and raises unless the
    process exits 0 within its time (and, with ``readout``, printed its
    readout); a process that does not end is killed first."""

    def __init__(self, name: str, yaml_path: Path, port: int, device: str, log_path: Path, extra_env: dict,
                 readout: bool = False):
        import queue

        self.name, self.port, self.log_path, self.readout = name, port, log_path, readout
        self.log = open(log_path, "w")
        cli = ["--config", str(yaml_path), "--skip-download", "--port", str(port), "--device", device]
        if readout:
            cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-host", *cli, "--metrics-port", "0"]
        else:
            cmd = [sys.executable, "-m", "lumen_tpu_torch.serving.server", *cli]
        self.proc = subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE if readout else self.log,
            stderr=self.log if readout else subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT), **extra_env},
        )
        self.lines: queue.Queue = queue.Queue()
        self.reader = None
        if readout:
            self.reader = threading.Thread(target=lambda: [self.lines.put(line) for line in self.proc.stdout],
                                           daemon=True)
            self.reader.start()
        self.channel = self.metrics_port = None

    def _serving_line(self, timeout: float) -> dict:
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                if self.proc.poll() is not None and self.lines.empty():
                    raise AssertionError(f"{self.name} exited with {self.proc.returncode}: {self.log_path}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"{self.name} was not serving within {timeout:.0f} s: {self.log_path}")
                continue
            if line.startswith("{"):
                return json.loads(line)

    def wait(self, timeout: float = 300.0):
        import grpc
        from google.protobuf import empty_pb2

        from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub

        self.channel = grpc.insecure_channel(f"127.0.0.1:{self.port}")
        stub = InferenceStub(self.channel)
        if self.readout:
            self.metrics_port = self._serving_line(timeout)["metrics_port"]
            grpc.channel_ready_future(self.channel).result(timeout=60)
            return stub
        t0 = time.perf_counter()
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.name} exited with {self.proc.returncode}: {self.log_path}")
            try:
                stub.Health(empty_pb2.Empty(), timeout=10)
                return stub
            except grpc.RpcError:
                if time.perf_counter() - t0 > timeout:
                    raise
                time.sleep(0.2)

    def stop(self, timeout: float = 60.0) -> dict:
        import queue

        if self.channel is not None:
            self.channel.close()
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
            raise AssertionError(f"{self.name} did not exit within {timeout:.0f} s of SIGTERM: {self.log_path}")
        finally:
            self.log.close()
        if rc != 0:
            raise AssertionError(f"{self.name} exited with {rc}: {self.log_path}")
        if not self.readout:
            return {}
        self.reader.join(timeout=30)
        last = {}
        with contextlib.suppress(queue.Empty):
            while True:
                line = self.lines.get_nowait()
                if line.startswith("{"):
                    last = json.loads(line)
        if not READOUT_KEYS <= set(last):
            raise AssertionError(f"{self.name} exited without its readout (last line {last}): {self.log_path}")
        return last


def engine_gauges(port: int) -> dict:
    """The ``vlm-continuous:*`` gauges of the one engine behind a sidecar."""
    gauges = http_json(port, "/metrics.json").get("gauges", {})
    (name,) = [k for k in gauges if k.startswith("vlm-continuous:")]
    return gauges[name]


def drive_fleet(seed: int, card: str, root: Path, phase6: dict, device: str = "cuda:0", n_captions: int = 8,
                n_streams: int = 2, max_new: int = 32, fallback_new: int = 96, drain: bool = True,
                search: bool = True, n_vectors: int = 50_000, n_queries: int = 128, dim: int = 512,
                timeout: float = 600.0) -> dict:
    """Phase 13: a disaggregated fleet of three hosts on one card, over
    loopback gRPC. A prefill host (``LUMEN_FED_ROLE=prefill``) and a front
    tier (no service, ``LUMEN_FED_PEERS`` naming both backends) run as
    processes of their own (:class:`ServerProcess`); the decode host
    (``LUMEN_FED_ROLE=decode``) is ``serve()`` in this process, so its
    launch counts are read here. All serve phase 6's directory on
    ``device``, with capacity gossip on, ``LUMEN_FED_KV_LANES`` at the
    concurrency and the result cache off (a control must compute, not find
    a peer's answer). (a) ``n_captions`` greedy ``vlm_generate`` and
    ``n_streams`` streams of phase 6's JPEGs through the front, all at once,
    ``max_new`` tokens each: every row migrates (``migrated_out`` and
    ``migrated_in`` equal the request count, no fallback, no rejection), the
    decode host launches no prefill kernel and the paged kernel, every
    answer equals the same request on one colocated host (the decode host,
    asked directly), both hosts end with no live page. (b) ``n_streams``
    streams whose decode host is stopped while they decode: they finish on
    the prefill host's ladder (``resubmit_spilled``), equal to their
    control, with no token repeated. (c) SIGTERM to the prefill host with
    ``LUMEN_DRAIN_ANNOUNCE_S``: the front records one drain handoff and no
    ``fed_peer_down`` for it. (d) two ``search`` backends behind a front
    tier hold ``n_vectors`` seeded unit vectors at ``dim``; ``n_queries``
    queries at k = 10 equal the exact oracle outside near-ties. ``drain``,
    ``search`` and the sizes let the CPU tests rehearse (a) and (b)
    small."""
    from concurrent.futures import ThreadPoolExecutor

    import grpc
    import numpy as np
    import torch

    from lumen_tpu_torch.core.config import load_config
    from lumen_tpu_torch.runtime.result_cache import reset_result_cache
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
    from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
    from lumen_tpu_torch.serving.server import serve

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    all_k = all_kernels()
    photos, prompt = phase6["photos"], phase6["prompt"]
    n_req = n_captions + n_streams
    ports = {h: free_port() for h in ("prefill", "decode", "front")}
    addr = {h: f"127.0.0.1:{p}" for h, p in ports.items()}
    peers = f"{addr['prefill']},{addr['decode']}"
    fleet = dict(LUMEN_FED_PEERS=peers, LUMEN_FED_CAPACITY="1", LUMEN_FED_KV_LANES=str(n_req),
                 LUMEN_FED_POLL_S="0.5", LUMEN_CACHE_BYTES="0", LUMEN_VLM_SPEC_K="0")
    out: dict = {}
    hosts: dict = {}
    stopped: list = []  # hosts that failed to stop cleanly
    decode = dchan = None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    try:
        with env(**fleet, LUMEN_FED_ROLE="decode", LUMEN_FED_SELF=addr["decode"]):
            reset_result_cache()  # this process's cache, off as the other hosts' are
            hosts["prefill"] = ServerProcess(
                "prefill host", fleet_yaml(root / "fleet-prefill.yaml", root / "cache", "SmokeVLM", ports["prefill"]),
                ports["prefill"], device, root / "fleet-prefill.log",
                {**fleet, "LUMEN_FED_ROLE": "prefill", "LUMEN_FED_SELF": addr["prefill"],
                 "LUMEN_DRAIN_S": "30", "LUMEN_DRAIN_ANNOUNCE_S": "10"}, readout=True)
            t0 = time.perf_counter()
            decode = serve(load_config(str(fleet_yaml(root / "fleet-decode.yaml", root / "cache", "SmokeVLM",
                                                      ports["decode"]))),
                           port_override=ports["decode"], skip_download=True, device=device)
            decode_s = time.perf_counter() - t0
            dchan = grpc.insecure_channel(addr["decode"])
            dstub = InferenceStub(dchan)
            hosts["prefill"].wait()
            # The front starts once both backends answer, so its record of
            # peers going down begins with a healthy fleet.
            hosts["front"] = ServerProcess(
                "front tier", fleet_yaml(root / "fleet-front.yaml", root / "cache", "SmokeVLM", ports["front"],
                                         enabled=False),
                ports["front"], device, root / "fleet-front.log", {**fleet, "LUMEN_DRAIN_S": "0"}, readout=True)
            fstub = hosts["front"].wait()
            boot_s = time.perf_counter() - t0
            if decode.router.kv_migration is None or decode.federation is None:
                raise AssertionError("phase 13: the decode host has no KV migration sink")
            eng = decode.services["vlm"].manager.engine
            front_port = hosts["front"].metrics_port
            deadline = time.monotonic() + 60
            while True:  # both lanes learned and live at the front, the decode host live at the prefill host
                view = http_json(front_port, "/peers")["peers"]
                roles = {n: p["fed_role"] for n, p in view.items()}
                states = {n: p["state"] for n, p in view.items()}
                at_prefill = http_json(hosts["prefill"].metrics_port, "/peers")["peers"][addr["decode"]]["state"]
                if roles == {addr["prefill"]: "prefill", addr["decode"]: "decode"} and set(
                        states.values()) == {"serving"} and at_prefill == "serving":
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 13: the fleet never settled: lanes {roles}, states {states}, "
                                         f"decode host at the prefill host {at_prefill}")
                time.sleep(0.1)
            log(f"phase 13: fleet up in {boot_s:.2f} s (decode host serve() {decode_s:.2f} s): prefill "
                f"{addr['prefill']} (process), decode {addr['decode']} (this process), front {addr['front']} "
                f"(process, no service); lanes {json.dumps(roles)}; kv {decode.services['vlm'].manager.kv_layout()}")

            # -- (a) migrated leg, then the same requests colocated ------------------
            class TimedSink:
                """The decode host's sink, timing each commit from the handler's
                start (its one frame received and parsed) to ``submit_migrated``
                returning (CRC, unpack, record build, admission), and from there
                to the first relayed token frame; it keeps the first commit's
                frame for the loopback rate."""

                def __init__(self, svc, eng):
                    self.svc, self.eng, self.unpack_ms, self.first_ms, self.frame = svc, eng, [], [], None
                    self.local = threading.local()
                    real = eng.submit_migrated

                    def submit(*a, **kw):
                        real(*a, **kw)
                        self.local.t = time.perf_counter()

                    eng.submit_migrated = submit

                def handle_kv_put(self, first, it, ctx):
                    if first.meta.get("op") != "commit":
                        yield from self.svc.handle_kv_put(first, it, ctx)
                        return
                    self.frame = self.frame or first
                    t, self.local.t = time.perf_counter(), None
                    for resp in self.svc.handle_kv_put(first, it, ctx):
                        if self.local.t is not None and resp.meta.get("fed_kv") == "tok":
                            self.unpack_ms.append((self.local.t - t) * 1e3)
                            self.first_ms.append((time.perf_counter() - self.local.t) * 1e3)
                            self.local.t = None
                        yield resp

                def close(self):
                    del self.eng.submit_migrated  # the class's own again

            sink = TimedSink(decode.router.kv_migration, eng)
            decode.router.kv_migration = sink
            # Streams first: in both legs they start at once, with 6 captions.
            kinds = ["vlm_generate_stream"] * n_streams + ["vlm_generate"] * n_captions
            jobs = [(kind, photos[i], {"messages": prompt, "max_new_tokens": max_new}) for i, kind in enumerate(kinds)]

            def run(stub, js):
                with ThreadPoolExecutor(max_workers=8) as pool:
                    t = time.perf_counter()
                    res = list(pool.map(lambda j: grpc_call(stub, *j, timeout=timeout), js))
                    return res, time.perf_counter() - t

            gauges0 = engine_gauges(hosts["prefill"].metrics_port)
            d0 = dict(eng.gauges())
            for k in all_k:
                k.launches = 0
            migrated, mig_wall = run(fstub, jobs)
            launches = {k.name: k.launches for k in all_k}
            peak = torch.cuda.max_memory_allocated() if on_card else 0
            pg = engine_gauges(hosts["prefill"].metrics_port)
            dg = eng.gauges()
            kv = http_json(hosts["prefill"].metrics_port, "/peers")["kv_migration"]
            decode.router.kv_migration = sink.svc
            sink.close()
            control, col_wall = run(dstub, jobs)
            for i, (m, c) in enumerate(zip(migrated, control)):
                if m["code"] or c["code"]:
                    raise AssertionError(f"phase 13 (a): request {i} codes {m['code']} (fleet) / {c['code']} (control)")
                if (m["body"]["generated_tokens"], m["body"]["text"]) != (c["body"]["generated_tokens"],
                                                                          c["body"]["text"]):
                    raise AssertionError(f"phase 13 (a): request {i} migrated differs from colocated: "
                                         f"{m['body']['text'][:60]!r} vs {c['body']['text'][:60]!r}")
                if m["deltas"] and b"".join(m["deltas"]).decode() != m["body"]["text"]:
                    raise AssertionError(f"phase 13 (a): stream {i}'s deltas do not join to its text")
            moved = {k: pg[k] - gauges0[k] for k in ("migrated_out", "migrate_out_failed")}
            moved_in = {k: dg[k] - d0[k] for k in ("migrated_in", "migrate_in_rejected")}
            if moved != {"migrated_out": n_req, "migrate_out_failed": 0} or moved_in != {
                    "migrated_in": n_req, "migrate_in_rejected": 0}:
                raise AssertionError(f"phase 13 (a): prefill {moved}, decode {moved_in} for {n_req} requests")
            if any(launches[n] for n in PHASE13_NO_PREFILL) or any(launches[n] == 0 for n in PHASE13_DECODE_KERNELS):
                raise AssertionError(f"phase 13 (a): decode-host launches {launches}")
            deadline = time.monotonic() + 30
            while (pg["pages_live"] or eng.gauges()["pages_live"]) and time.monotonic() < deadline:
                time.sleep(0.05)
                pg = engine_gauges(hosts["prefill"].metrics_port)
            if pg["pages_live"] or eng.gauges()["pages_live"]:
                raise AssertionError(f"phase 13 (a): pages live at the end: prefill {pg['pages_live']}, "
                                     f"decode {eng.gauges()['pages_live']}")
            row_bytes = kv["put_bytes"] / max(kv["puts"], 1)
            # The loopback rate: a real commit (one frame: 48 MB chunks) sent
            # again with op=offer, which the sink answers without unpacking.
            frame = pb.InferRequest.FromString(sink.frame.SerializeToString())
            frame.meta["op"] = "offer"
            frame_bytes = frame.ByteSize()
            offer = lambda: list(dstub.Infer(iter([frame]), timeout=60))  # noqa: E731
            offer()
            rate_s = []
            for _ in range(10):
                t = time.perf_counter()
                offer()
                rate_s.append(time.perf_counter() - t)
            tok = lambda rs: sum(r["body"]["generated_tokens"] for r in rs)  # noqa: E731
            ttft = lambda rs: sorted(r["ttft_ms"] for r in rs if r["ttft_ms"] is not None)  # noqa: E731
            answer = lambda rs: sorted(r["s"] * 1e3 for r in rs[n_streams:])  # noqa: E731
            pct = lambda xs, p: float(xs[min(len(xs) - 1, int(p * len(xs)))])  # noqa: E731
            out.update(
                requests=n_req, puts=kv["puts"], row_bytes=row_bytes, commit_unpack_ms=sorted(sink.unpack_ms),
                commit_first_ms=sorted(sink.first_ms), frame_bytes=frame_bytes,
                loopback_bytes_s=frame_bytes / float(np.median(rate_s)), launches=launches, peak_gib=peak / 2**30,
                ttft_migrated=ttft(migrated), ttft_colocated=ttft(control), answer_migrated=answer(migrated),
                answer_colocated=answer(control), tok_s_migrated=tok(migrated) / mig_wall,
                tok_s_colocated=tok(control) / col_wall)
            log(f"phase 13 (a): {n_req} requests through the front ({n_captions} vlm_generate + {n_streams} streams, "
                f"8 in flight, {max_new} new tokens, 1600x1200 JPEGs): every one migrated (prefill {json.dumps(moved)}, "
                f"decode {json.dumps(moved_in)}), all {n_req} equal to the colocated control; decode-host launches "
                f"{json.dumps(launches)}; pages live at the end 0 / 0 [{card}]")
            log(f"phase 13 (a): KV shipped {row_bytes / 1e6:.3f} MB a row ({kv['puts']} commits, "
                f"{kv['put_bytes']} B in all, {kv['ref_pages']} pages by reference); on the decode host, from a "
                f"commit's frame received to its row admitted (CRC, unpack, record, submit_migrated) p50 / max "
                f"{pct(out['commit_unpack_ms'], 0.5):.2f} / {out['commit_unpack_ms'][-1]:.2f} ms, admitted to the "
                f"first relayed token p50 / max {pct(out['commit_first_ms'], 0.5):.2f} / "
                f"{out['commit_first_ms'][-1]:.2f} ms (of {len(sink.first_ms)}); one commit frame "
                f"({frame_bytes} B, sent as an offer) round trip on loopback gRPC "
                f"{out['loopback_bytes_s'] / 1e9:.3f} GB/s (median of 10) [{card}]")
            log(f"phase 13 (a): stream TTFT p50 / p95 migrated {pct(out['ttft_migrated'], 0.5):.1f} / "
                f"{pct(out['ttft_migrated'], 0.95):.1f} ms, colocated {pct(out['ttft_colocated'], 0.5):.1f} / "
                f"{pct(out['ttft_colocated'], 0.95):.1f} ms; vlm_generate answer p50 / p95 migrated "
                f"{pct(out['answer_migrated'], 0.5):.1f} / {pct(out['answer_migrated'], 0.95):.1f} ms, colocated "
                f"{pct(out['answer_colocated'], 0.5):.1f} / {pct(out['answer_colocated'], 0.95):.1f} ms; aggregate "
                f"{out['tok_s_migrated']:.1f} tok/s migrated, {out['tok_s_colocated']:.1f} colocated; decode-host "
                f"peak {out['peak_gib']:.3f} GiB since the phase began [{card}]")

            # -- (b) the decode host stops while two streams decode on it ----------
            fb_jobs = [("vlm_generate_stream", photos[n_req + i], {"messages": prompt, "max_new_tokens": fallback_new})
                       for i in range(n_streams)]
            fb_control, _ = run(dstub, fb_jobs)
            in0 = eng.migrated_in
            box: dict = {}
            runner = threading.Thread(target=lambda: box.update(res=run(fstub, fb_jobs)[0]), daemon=True)
            runner.start()
            deadline = time.monotonic() + timeout
            while True:  # freeze the decode loop once both rows streamed a block
                eng._cond.acquire()
                rows = [s for s in eng._slots.values() if s.request.embeds is None]  # migrated in: no prompt here
                if eng.migrated_in - in0 == n_streams and len(rows) == n_streams and all(
                        len(s.tokens) >= eng.block for s in rows):
                    break
                eng._cond.release()
                if time.monotonic() > deadline or not runner.is_alive():
                    raise AssertionError("phase 13 (b): the streams never decoded on the decode host")
                time.sleep(0.0005)
            try:
                streamed = [len(s.tokens) for s in rows]
                decode.server.stop(0).wait(10)  # the wire dies mid-stream
            finally:
                eng._cond.release()
            decode.stop(grace=0.1)
            decode = None
            runner.join(timeout=timeout)
            if runner.is_alive():
                raise AssertionError("phase 13 (b): the streams never finished")
            fb = box["res"]
            for i, (m, c) in enumerate(zip(fb, fb_control)):
                if m["code"] or (m["body"]["generated_tokens"], m["body"]["text"]) != (
                        c["body"]["generated_tokens"], c["body"]["text"]):
                    raise AssertionError(f"phase 13 (b): stream {i} differs from its control (code {m['code']})")
                if b"".join(m["deltas"]).decode() != m["body"]["text"]:
                    raise AssertionError(f"phase 13 (b): stream {i} repeated or lost a token")
            pg2 = engine_gauges(hosts["prefill"].metrics_port)
            fallbacks = pg2["migrate_out_failed"] - pg["migrate_out_failed"]
            if fallbacks != n_streams:
                raise AssertionError(f"phase 13 (b): {fallbacks} fallbacks for {n_streams} streams")
            out.update(fallbacks=fallbacks)
            log(f"phase 13 (b): decode host stopped with {n_streams} streams on it ({streamed} tokens each already "
                f"out): {fallbacks} fallbacks through resubmit_spilled, both streams finished on the prefill host "
                f"equal to their control, no token repeated [{card}]")

            # -- (c) the prefill host drains --------------------------------------
            if drain:
                before = http_json(front_port, "/metrics.json").get("counters", {}).get("fed_drain_handoffs", 0)
                hosts["prefill"].proc.terminate()
                t0 = time.monotonic()
                while True:
                    peer = http_json(front_port, "/peers")["peers"][addr["prefill"]]
                    if peer.get("draining") and peer.get("weight") == 0.0:
                        break
                    if time.monotonic() - t0 > 30:
                        raise AssertionError(f"phase 13 (c): the front never saw the drain: {peer}")
                    time.sleep(0.05)
                seen_s = time.monotonic() - t0
                handoffs = http_json(front_port, "/metrics.json").get("counters", {}).get(
                    "fed_drain_handoffs", 0) - before
                events = http_json(front_port, "/events")["events"]
                down = [e for e in events if e["kind"] == "fed_peer_down" and e["component"] == addr["prefill"]]
                hand = [e for e in events if e["kind"] == "fed_drain_handoff" and e["component"] == addr["prefill"]]
                if handoffs != 1 or len(hand) != 1 or down:
                    raise AssertionError(f"phase 13 (c): {handoffs} handoffs, events {hand}, peer-down {down}")
                out["prefill_host"] = hosts.pop("prefill").stop()
                log(f"phase 13 (c): SIGTERM to the prefill host: the front saw draining and weight 0 after "
                    f"{seen_s:.2f} s, 1 drain handoff, no fed_peer_down for it; prefill host launches "
                    f"{json.dumps(out['prefill_host']['launches'])}, peak {out['prefill_host']['peak_gib']:.3f} GiB "
                    f"[{card}]")
    finally:
        if dchan is not None:
            dchan.close()
        if decode is not None:
            decode.stop(grace=0.1)
        for name in list(hosts):  # stop every host before raising for one
            try:
                out[f"{name}_host"] = hosts.pop(name).stop()
            except AssertionError as e:
                log(f"phase 13: {e}")
                stopped.append(e)
    if stopped:
        raise stopped[0]
    front = out["front_host"]
    if front["cuda_initialized"] or any(front["launches"].values()):
        raise AssertionError(f"phase 13: the front tier touched the device: {front}")
    log(f"phase 13: front tier launches {json.dumps(front['launches'])}, CUDA initialized "
        f"{front['cuda_initialized']} [{card}]")

    # -- (d) search fan-out over two backends ---------------------------------
    if search:
        out.update(drive_fleet_search(seed, card, root, device, n_vectors, n_queries, dim))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: phase 13 (d)'s shards: with 3 (the default) a ring of two peers puts
#: every shard on one peer a quarter of the time; with 8, 2 in 256
FLEET_SEARCH_SHARDS = 8


def drive_fleet_search(seed: int, card: str, root: Path, device: str, n_vectors: int, n_queries: int,
                       dim: int) -> dict:
    """Phase 13 (d): two ``search`` backends (``serve()`` in this process)
    behind a front tier, ``FLEET_SEARCH_SHARDS`` shards a tenant:
    ``n_vectors`` seeded unit vectors upserted through the front in
    1,024-row chunks (partitioned by shard: each backend holds exactly the
    rows of the shards the front's ring gives it), then ``n_queries``
    queries at k = 10 over every shard, each held to the numpy oracle
    outside near-ties (phase 11's rule)."""
    with env(LUMEN_ANN_SHARDS=str(FLEET_SEARCH_SHARDS)):
        return _drive_fleet_search(seed, card, root, device, n_vectors, n_queries, dim)


def _drive_fleet_search(seed: int, card: str, root: Path, device: str, n_vectors: int, n_queries: int,
                        dim: int) -> dict:
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from lumen_tpu_torch.runtime.ann import normalize, shard_of
    from lumen_tpu_torch.utils.tensorwire import BUNDLE_MIME, pack_bundle

    yaml_path = ocr_yaml(root / "fleet-search.yaml", root / "cache",
                         {"search": ("ann-exact", {"batch_size": 16, "max_batch_latency_ms": 2.0})})
    backends = []
    front = channel = None
    try:
        for _ in range(2):
            with env(LUMEN_ANN_DIM=str(dim)):
                handle, ch, _, _ = boot_server(yaml_path, device)
            ch.close()
            backends.append(handle)
        peers = ",".join(f"127.0.0.1:{h.port}" for h in backends)
        import yaml

        spec = yaml.safe_load(yaml_path.read_text())
        spec["services"]["search"]["enabled"] = False
        (root / "fleet-search-front.yaml").write_text(yaml.safe_dump(spec))
        with env(LUMEN_FED_PEERS=peers, LUMEN_FED_SELF=""):
            front, channel, stub, _ = boot_server(root / "fleet-search-front.yaml", device)
        rng = np.random.default_rng(seed * 100 + 13)
        vecs = normalize(rng.standard_normal((n_vectors, dim), dtype=np.float32))
        ids = [f"fv{i:06d}" for i in range(n_vectors)]
        chunk = 1024
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            ups = list(ex.map(lambda lo: grpc_call(stub, "search_upsert", pack_bundle([
                vecs[lo:lo + chunk], np.frombuffer(json.dumps(ids[lo:lo + chunk]).encode(), np.uint8)]),
                {}, mime=BUNDLE_MIME), range(0, n_vectors, chunk)))
        upsert_s = time.perf_counter() - t0
        if any(r["code"] for r in ups) or sum(r["body"]["added"] for r in ups) != n_vectors:
            raise AssertionError(f"phase 13 (d): upserts answered {[r['code'] for r in ups]}, "
                                 f"{sum(r.get('body', {}).get('added', 0) for r in ups)} rows added")
        held = [sum(s._n for s in h.services["search"].index.shards_for("default").values()) for h in backends]
        ring = front.federation.ring
        owner = {sh: ring.owner(hashlib.sha256(f"ann/default/{sh}".encode()).hexdigest())
                 for sh in range(FLEET_SEARCH_SHARDS)}
        placed = [sum(owner[shard_of(i, FLEET_SEARCH_SHARDS)] == f"127.0.0.1:{h.port}" for i in ids) for h in backends]
        if held != placed:
            raise AssertionError(f"phase 13 (d): the backends hold {held} rows, the ring places {placed}")
        queries = normalize(rng.standard_normal((n_queries, dim), dtype=np.float32))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as ex:
            answers = list(ex.map(lambda q: grpc_call(stub, "search_query", json.dumps(
                {"vector": q.tolist()}).encode(), {"k": "10"}, mime="application/json"), queries))
        query_s = time.perf_counter() - t0
        scores = queries @ vecs.T
        near, worst = 0, 0.0
        for j, r in enumerate(answers):
            if r["code"] or r["body"]["shards"] != FLEET_SEARCH_SHARDS:
                raise AssertionError(f"phase 13 (d): query {j}: {r['code']} {r.get('body')}")
            want_ids, want_scores, gap = oracle_topk(scores[j], ids, 10)
            worst = max(worst, float(np.abs(np.asarray(r["body"]["scores"]) - want_scores).max()))
            if gap < SEARCH_SCORE_TOL:
                near += 1
            elif r["body"]["ids"] != want_ids:
                raise AssertionError(f"phase 13 (d): query {j} differs from the oracle")
        if worst > SEARCH_SCORE_TOL:
            raise AssertionError(f"phase 13 (d): scores differ from the oracle's by {worst:.2e}")
        log(f"phase 13 (d): two search backends behind a front: {n_vectors:,} unit vectors at dim {dim} upserted "
            f"through the front in {upsert_s:.2f} s (held {held}, {FLEET_SEARCH_SHARDS} shards placed by the front's ring), {n_queries} queries at k = 10 in {query_s:.2f} s "
            f"(16 in flight), every answer the oracle's but {near} near-ties, scores within {worst:.2e} [{card}]")
        return {"search_held": held, "search_near_ties": near, "search_upsert_s": upsert_s,
                "search_query_s": query_s}
    finally:
        if channel is not None:
            channel.close()
        if front is not None:
            front.stop(grace=0.5)
        for h in backends:
            h.stop(grace=0.5)


# -- phase 14: the control plane as users reach it --------------------------------

#: the kernels the supervised full tier must launch (its vision tower, CLIP,
#: face and OCR all run on the ONNX bridge; phases 2-13 hold the others)
PHASE14_KERNELS = ("flash_attention_cache", "paged_attention")
#: the catalog names ``config_gen`` writes for the full tier, each served by
#: an earlier phase's stand-in: phase 12 (a)'s FastVLM-shaped directory,
#: phase 9 (c)'s export-only CLIP, phase 9 (a)'s pack, phase 10 (a)'s pack
CATALOG_SOURCES = {"FastVLM-0.5B": "SmokeFastVLM", "MobileCLIP2-S2": "SmokeMobileCLIP", "buffalo_l": "buffalo_l",
                   "PP-OCRv5_mobile": "PP-OCRv5_mobile"}
#: what each client subcommand's answer is held to
CLIENT_SCHEMAS = {"embed-text": "embedding_v1", "embed-image": "embedding_v1", "faces": "face_v1",
                  "ocr": "ocr_v1", "caption": "text_generation_v1", "caption --stream": "text_generation_v1"}
#: the tasks ``GET /api/v1/metrics`` must count after (d)
PHASE14_TASKS = ("clip_text_embed", "clip_image_embed", "face_detect", "ocr", "vlm_generate", "vlm_generate_stream")


def link_model_dir(src: Path, dst: Path, runtime: str) -> None:
    """``dst`` (a catalog name under the cache) holding links to each entry
    of ``src`` and its own ``model_info.json``: the catalog name, and the
    source's declared files under the ``runtime`` the YAML names too."""
    dst.mkdir(parents=True)
    for entry in src.iterdir():
        if entry.name != "model_info.json":
            (dst / entry.name).symlink_to(entry.resolve())
    info = json.loads((src / "model_info.json").read_text())
    files = next(r["files"] for r in info["runtimes"].values() if r.get("available"))
    info["name"] = dst.name
    info["runtimes"][runtime] = {"available": True, "files": files}
    (dst / "model_info.json").write_text(json.dumps(info))


def run_cli(args: list, timeout: float = 600, **kw) -> subprocess.CompletedProcess:
    """A ``python -m`` command of the port from the checkout's root; raises
    unless it exits 0."""
    out = subprocess.run([sys.executable, "-m", *map(str, args)], capture_output=True, text=True, cwd=ROOT,
                         timeout=timeout, env={**os.environ, "PYTHONPATH": str(ROOT)}, **kw)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(map(str, args[:3]))} exited with {out.returncode}:\n{out.stdout[-2000:]}\n"
                             f"{out.stderr[-4000:]}")
    return out


def split_stream(stdout: str) -> tuple[str, dict]:
    """``client caption --stream``'s output: the streamed text, then a
    newline and the final answer's JSON."""
    at = stdout.rindex("\n{\n")
    return stdout[:at], json.loads(stdout[at + 1:])


def drive_control_plane(card: str, root: Path, photos: list, sources: dict, device: str = "cuda:0",
                        preset: str | None = None, timeout: float = 900.0) -> dict:
    """Phase 14: the control plane as users reach it. (a) ``hardware_report()``
    in a fresh process: the card's name and count, the recommended preset,
    and no CUDA context in that process; ``environment_report`` there. (b)
    the app (``lumen_tpu_torch.app``, in process, aiohttp on a loopback port,
    real HTTP): ``hardware/detect``, ``config/generate`` (the recommended
    preset, or ``preset``; ``tier: full``) into a temporary cache holding the
    stand-ins under the catalog names (``sources``: catalog name -> model
    directory, linked), ``config/save``; the resources CLI's ``validate``,
    ``list`` and ``download`` on the saved YAML (nothing to fetch); and
    ``install/setup`` with a venv and the model check. (c) ``server/start``
    of the full tier under the app's ``ServerManager`` (``chip_smoke.py
    --serve-host``) with ``LUMEN_COMPILE_CACHE_DIR`` empty: healthy; a
    greedy caption over gRPC builds its kernels at first use, counted in
    ``/stats``' ``compile`` block. (d) ``python -m lumen_tpu_torch.client``:
    every subcommand exits 0 with a schema-valid answer on ``photos[0]``, the
    client's caption equal to that gRPC one, and ``/api/v1/metrics``
    counting the tasks; then ``server/restart`` from the warm directory, the
    same caption again with no build. (e) ``server/stop``: both children
    exit 0, and their readouts (``/api/v1/server/logs``) show the path's
    kernels launched. Off the card ``preset`` names the preset and the saved
    YAML is edited to ``device: cpu`` (the wizard's YAML editor)."""
    import asyncio

    import yaml

    from lumen_tpu_torch.core.config import load_config
    from lumen_tpu_torch.core.downloader import Downloader
    from lumen_tpu_torch.core.result_schemas import validate_result

    on_card = device != "cpu"
    t_phase = time.perf_counter()
    work = root / "control"
    cache = work / "cache"
    work.mkdir()
    out: dict = {}

    # -- (a) hardware detection in a fresh process -----------------------------------
    code = ("import json, sys\n"
            "from lumen_tpu_torch.app.env_check import environment_report\n"
            "from lumen_tpu_torch.app.hardware import hardware_report\n"
            "report = hardware_report()\n"
            "env = environment_report(sys.argv[1], 1.0)\n"
            "import torch\n"
            "print(json.dumps({'report': report, 'env': env, 'cuda_initialized': torch.cuda.is_initialized()}))\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code, str(work)], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    if res.returncode != 0:
        raise AssertionError(f"phase 14 (a): the probing process exited with {res.returncode}:\n{res.stderr[-3000:]}")
    seen = json.loads(res.stdout.strip().splitlines()[-1])
    report, hw = seen["report"], seen["report"]["hardware"]
    checks = {c["name"]: c for c in seen["env"]["checks"]}
    if seen["cuda_initialized"]:
        raise AssertionError("phase 14 (a): the process that called hardware_report() holds a CUDA context")
    if on_card:
        import torch

        name = card.split(",")[0].strip()
        if (hw["platform"], hw["device_kind"], hw["device_count"]) != ("cuda", name, torch.cuda.device_count()):
            raise AssertionError(f"phase 14 (a): detected {hw}, nvidia-smi says {card!r}")
        if report["recommended_preset"] != "cuda_h100_1":
            raise AssertionError(f"phase 14 (a): recommended {report['recommended_preset']}")
        bad = [n for n in ("torch", "torch_cuda", "nvcc", "nvidia_driver", "gpu_devices") if not checks[n]["ok"]]
        if bad:
            raise AssertionError(f"phase 14 (a): environment checks failed: {[checks[n] for n in bad]}")
    preset = preset or report["recommended_preset"]
    verdicts = ", ".join(f"{n} {c['ok']}" for n, c in checks.items())
    log(f"phase 14 (a): hardware_report() in a fresh process ({time.perf_counter() - t0:.1f} s): "
        f"{hw['platform']} '{hw['device_kind']}' x{hw['device_count']}, {hw['device_memory_gb']} GB, recommends "
        f"{report['recommended_preset']} (supported {report['supported_presets']}); CUDA initialized in that process: "
        f"{seen['cuda_initialized']}; env checks {verdicts}; nvcc: {checks['nvcc']['detail']} [{card}]")

    async def drive() -> None:
        import aiohttp
        from aiohttp import web

        from lumen_tpu_torch.app.api import MANAGER_KEY, build_app
        from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub

        app = build_app()
        manager = app[MANAGER_KEY]
        # The supervised server is the port's CLI under --serve-host, which
        # prints its launches and peak memory when it stops.
        manager.server_argv = (sys.executable, str(ROOT / "chip_smoke.py"), "--serve-host")
        runner = web.AppRunner(app)
        await runner.setup()
        app_port = free_port()
        await web.TCPSite(runner, "127.0.0.1", app_port).start()
        base = f"http://127.0.0.1:{app_port}/api/v1"
        http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=timeout))

        async def call(method: str, path: str, body: dict | None = None, status: int = 200):
            async with http.request(method, base + path, json=body) as r:
                data = await r.json(content_type=None)
                if r.status != status:
                    raise AssertionError(f"phase 14: {method} {path} answered {r.status}: {data}")
                return data

        async def cli(*args, **kw):
            return await asyncio.to_thread(run_cli, list(args), **kw)

        try:
            # -- (b) config, install and the resources CLI ---------------------------
            t0 = time.perf_counter()
            detect = await call("GET", "/hardware/detect")
            if detect["recommended_preset"] != report["recommended_preset"]:
                raise AssertionError(f"phase 14 (b): hardware/detect recommends {detect['recommended_preset']}")
            grpc_port = free_port()
            cfg = await call("POST", "/config/generate", {"preset": preset, "tier": "full", "cache_dir": str(cache),
                                                          "port": grpc_port, "mdns": False})
            models = {svc: next(iter(spec["models"].values())) for svc, spec in cfg["services"].items()}
            if sorted(m["model"] for m in models.values()) != sorted(sources):
                raise AssertionError(f"phase 14 (b): the full tier names {models}")
            for m in models.values():
                link_model_dir(Path(sources[m["model"]]), cache / "models" / m["model"], m["runtime"])
            yaml_path = work / "lumen.yaml"
            if on_card:
                await call("POST", "/config/save", {"path": str(yaml_path)})
            else:  # the wizard's YAML editor: serve the same tier on the CPU
                text = await (await http.get(base + "/config/yaml")).text()
                spec = yaml.safe_load(text)
                for svc in spec["services"].values():
                    svc["backend_settings"].update(device="cpu", dtype="float32")
                await call("POST", "/config/save", {"path": str(yaml_path), "yaml": yaml.safe_dump(spec)})
            devices = {s.backend_settings.device for s in load_config(str(yaml_path)).services.values()}
            check = Downloader(load_config(str(yaml_path))).check_all()  # offline: download must fetch nothing
            if not check.ok:
                raise AssertionError(f"phase 14 (b): models missing from the cache: {check.results}")
            await cli("lumen_tpu_torch.core.cli", "validate", "--config", yaml_path)
            listed = (await cli("lumen_tpu_torch.core.cli", "list", "--config", yaml_path)).stdout
            if sorted(line.split(": ")[1].split()[0] for line in listed.splitlines()) != sorted(sources):
                raise AssertionError(f"phase 14 (b): list printed {listed!r}")
            downloaded = (await cli("lumen_tpu_torch.core.cli", "download", "--config", yaml_path)).stdout
            task = await call("POST", "/install/setup", {"venv_path": str(work / "venv"), "config_path": str(yaml_path),
                                                         "download": True}, status=202)
            while task["status"] in ("pending", "running"):
                await asyncio.sleep(0.5)
                task = await call("GET", f"/install/status/{task['task_id']}")
            steps = [(s["name"], s["status"]) for s in task["steps"]]
            want = [(n, "completed") for n in ("check_python", "create_venv", "verify_imports", "download_models")]
            if task["status"] != "completed" or steps != want:
                logs = await call("GET", f"/install/logs/{task['task_id']}?limit=40")
                raise AssertionError(f"phase 14 (b): install {task['status']} {steps} {task['error']}: {logs['lines']}")
            out["setup_s"] = time.perf_counter() - t0
            log(f"phase 14 (b): config/generate {preset} tier full (devices {sorted(devices)}) over the catalog "
                f"names, saved; resources CLI validate, list ({len(listed.splitlines())} models) and download "
                f"({len(downloaded.splitlines())} ok, nothing fetched); install/setup with a venv: "
                f"{', '.join(f'{n} {s}' for n, s in steps)}; {out['setup_s']:.1f} s [{card}]")

            # -- (c) serve the full tier under the ServerManager ------------------------
            # Kernels build at first use, so the builds fall in the first
            # caption: timed on a cold directory, then on the warm one after
            # server/restart (the same greedy request both times).
            import grpc

            meta = {"messages": json.dumps([{"role": "user", "content": "Describe this photo in one sentence."}]),
                    "max_new_tokens": "64", "do_sample": "false"}

            async def first_caption(metrics_port: int) -> tuple[dict, float, dict]:
                t0 = time.perf_counter()
                with grpc.insecure_channel(f"127.0.0.1:{grpc_port}") as channel:
                    res = await asyncio.to_thread(grpc_call, InferenceStub(channel), "vlm_generate", photos[0], meta)
                took = time.perf_counter() - t0
                if res["code"]:
                    raise AssertionError(f"phase 14 (c): the first caption answered {res}")
                return res["body"], took, http_json(metrics_port, "/stats?window=3600")["compile"]

            extra = ["--skip-download", "--metrics-port", "0"]
            t0 = time.perf_counter()
            info = await call("POST", "/server/start", {"config_path": str(yaml_path), "extra_args": extra})
            cold_s = time.perf_counter() - t0
            status = await call("GET", "/server/status")
            if not status["healthy"] or info["port"] != grpc_port:
                raise AssertionError(f"phase 14 (c): status {status}")
            boot = http_json(info["metrics_port"], "/stats?window=3600")["compile"]
            direct, cold_first_s, cold = await first_caption(info["metrics_port"])
            if on_card and cold["compiles"] == 0:
                raise AssertionError(f"phase 14 (c): the cold server's first caption built nothing: {cold}")
            built = sorted(p.name for p in (work / "kernels").rglob("*.so"))
            out.update(cold_s=cold_s, cold_first_s=cold_first_s, boot_builds=boot["compiles"],
                       cold_builds=cold["compiles"], built=built, build_ms=(cold["ms"] or {}).get("mean_ms"))
            log(f"phase 14 (c): the full tier under the ServerManager, start to ready {cold_s:.2f} s on an empty "
                f"kernel directory ({boot['compiles']} builds at boot); the first caption {cold_first_s:.2f} s with "
                f"{cold['compiles']} builds ({out['build_ms']} ms a build on average: {', '.join(built)}) [{card}]")

            # -- (d) the client CLI -----------------------------------------------------
            t0 = time.perf_counter()
            photo = work / "photo.jpg"
            photo.write_bytes(photos[0])
            addr = ["lumen_tpu_torch.client", "--addr", f"127.0.0.1:{grpc_port}", "--timeout", "600", "--full"]
            jobs = {"caps": ["caps"], "health": ["health"], "topology": ["topology"],
                    "embed-text": ["embed-text", "a photo of a red car"], "embed-image": ["embed-image", photo],
                    "faces": ["faces", photo], "ocr": ["ocr", photo]}
            answers = dict(zip(jobs, await asyncio.gather(*(cli(*addr, *a) for a in jobs.values()))))
            answers["caption"] = await cli(*addr, "caption", photo)
            answers["caption --stream"] = await cli(*addr, "caption", photo, "--stream")
            for cmd, schema in CLIENT_SCHEMAS.items():
                text = answers[cmd].stdout
                if cmd == "caption --stream":
                    streamed, final = split_stream(text)
                    if streamed != final["text"]:
                        raise AssertionError(f"phase 14 (d): streamed {streamed!r}, final {final['text']!r}")
                    text = json.dumps(final)
                validate_result(schema, text.encode())
            caps = json.loads(answers["caps"].stdout)
            topo = json.loads(answers["topology"].stdout)
            if answers["health"].stdout != "ok\n" or not set(PHASE14_TASKS) <= set(caps["tasks"]) or len(topo) != 4:
                raise AssertionError(f"phase 14 (d): health {answers['health'].stdout!r}, caps {caps}, topology {topo}")
            caption = json.loads(answers["caption"].stdout)
            stream = split_stream(answers["caption --stream"].stdout)[1]
            if (direct["text"], direct["generated_tokens"]) != (caption["text"], caption["generated_tokens"]) or \
                    stream["text"] != caption["text"]:
                raise AssertionError(f"phase 14 (d): client caption {caption['text']!r}, stream {stream['text']!r}, "
                                     f"direct {direct['text']!r}")
            stats = json.loads((await cli("lumen_tpu_torch.client", "stats", "--metrics-addr",
                                          f"127.0.0.1:{info['metrics_port']}", "--window", "3600", "--json")).stdout)
            metrics = (await call("GET", "/metrics"))["inference"]
            counts = {t: metrics["tasks"].get(t, {}).get("count", 0) for t in PHASE14_TASKS}
            if not all(counts.values()) or not all(stats["tasks"].get(t, {}).get("count") for t in PHASE14_TASKS):
                raise AssertionError(f"phase 14 (d): /api/v1/metrics counts {counts}, stats {sorted(stats['tasks'])}")
            out.update(client_s=time.perf_counter() - t0, caption=caption["text"], counts=counts)
            log(f"phase 14 (d): the client's caps, health, topology, embed-text, embed-image, faces, ocr, caption, "
                f"caption --stream and stats exit 0, each answer valid against its schema; greedy caption "
                f"({caption['generated_tokens']} tokens) equal to the direct gRPC request and to the stream; "
                f"/api/v1/metrics counts {json.dumps(counts)}; {out['client_s']:.1f} s [{card}]")

            # -- (c, again) server/restart from the warm kernel directory ----------------
            t0 = time.perf_counter()
            info = await call("POST", "/server/restart")
            warm_s = time.perf_counter() - t0
            status = await call("GET", "/server/status")
            again, warm_first_s, warm = await first_caption(info["metrics_port"])
            if not status["healthy"] or warm["compiles"] != 0 or again["text"] != direct["text"]:
                raise AssertionError(f"phase 14 (c): warm builds {warm}, status {status}, caption {again['text']!r} "
                                     f"vs {direct['text']!r}")
            out.update(warm_s=warm_s, warm_first_s=warm_first_s)
            log(f"phase 14 (c): server/restart from the warm kernel directory, start to ready {warm_s:.2f} s; the "
                f"first caption {warm_first_s:.2f} s with {warm['compiles']} builds, equal to the cold one [{card}]")

            # -- (e) stop: each child's readout ------------------------------------------
            await call("POST", "/server/stop")
            info = await call("GET", "/server/status")
            messages = [line["message"] for line in (await call("GET", "/server/logs?limit=0"))["lines"]]
            readouts = [json.loads(m) for m in messages if m.startswith('{"launches"')]
            exits = [m for m in messages if m.startswith("server exited with code")]
            if info["exit_code"] != 0 or exits != ["server exited with code 0"] * 2 or len(readouts) != 2 or \
                    not all(READOUT_KEYS <= set(r) for r in readouts):
                raise AssertionError(f"phase 14 (e): exit code {info['exit_code']}, exits {exits}, readouts {readouts}")
            out.update(children=readouts, log_lines=len(messages))
        finally:
            await http.close()
            await runner.cleanup()  # stops a child still running

    with env(LUMEN_COMPILE_CACHE_DIR=str(work / "kernels"), LUMEN_CACHE_BYTES="0", HF_HUB_OFFLINE="1"):
        asyncio.run(drive())
    missing = [(child, k) for child, r in zip(("cold", "warm"), out["children"])
               for k in PHASE14_KERNELS if r["launches"][k] == 0]
    if on_card and missing:
        raise AssertionError(f"phase 14 (e): a supervised server never launched {missing}: {out['children']}")
    cold, warm = out["children"]
    out.update(launches={k: cold["launches"][k] + warm["launches"][k] for k in cold["launches"]},
               peak_gib=max(cold["peak_gib"], warm["peak_gib"]), phase_s=time.perf_counter() - t_phase)
    log(f"phase 14 (e): server/restart and server/stop, both children exited 0 ({out['log_lines']} lines read back "
        f"from the app's log buffer); launches while they served: cold "
        f"{json.dumps(cold['launches'])}, warm {json.dumps(warm['launches'])}; peaks {cold['peak_gib']:.3f} / "
        f"{warm['peak_gib']:.3f} GiB; phase 14 {out['phase_s']:.1f} s [{card}]")
    return out


def vlm_config_of(model_dir):
    """The ``VLMConfig`` a model directory's ``config.json`` describes."""
    from lumen_tpu_torch.models.vlm import VLMConfig

    return VLMConfig.from_hf(json.loads((Path(model_dir) / "config.json").read_text()))


def count_syncs(fn) -> int:
    """Device-to-host synchronizations one call of ``fn`` makes (warm), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    import torch

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # (set_sync_debug_mode's own "prototype feature" notice is no sync)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


#: the phases whose results each phase reads (``--phases`` runs them too)
PHASE_NEEDS = {7: (6,), 8: (6,), 9: (8,), 10: (6, 8, 9), 11: (8, 9, 10), 12: (6, 8), 13: (6,), 14: (6, 9, 10, 12)}
ALL_PHASES = frozenset(range(1, 15))


def phase_set(spec: "str | None") -> frozenset:
    """The phases a run drives: all, or those ``spec`` lists (``6,13``)
    with the phases they read, and phase 1 (the build) always."""
    want = set(ALL_PHASES) if spec is None else {int(p) for p in spec.split(",")}
    if not want <= ALL_PHASES:
        raise SystemExit(f"--phases: no phase {sorted(want - ALL_PHASES)}")
    todo = list(want)
    while todo:
        for need in PHASE_NEEDS.get(todo.pop(), ()):
            if need not in want:
                want.add(need)
                todo.append(need)
    return frozenset(want | {1})


def main() -> int:
    if not (ROOT / "lumen_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--serve-host"]:  # phase 13's hosts: the server CLI's own arguments follow
        sys.path.insert(0, str(ROOT))
        return serve_host(sys.argv[2:])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    # a developer's shortcut, e.g. ``--phases 13``: those phases and what they
    # read, without the kernel table and the device line
    parser.add_argument("--phases", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    run = phase_set(args.phases)
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
    laps, mark = {}, [time.perf_counter()]

    def lap(phase: int) -> None:  # each phase's seconds, printed at the end
        now = time.perf_counter()
        laps[phase], mark[0] = round(now - mark[0], 1), now

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
    bf16_funcs = [f for f in hmma if "bf16" in f]  # flash at head_dim 64 and 16, the cache kernel at 64
    if len(bf16_funcs) != 3 or any(hmma[f] == 0 for f in bf16_funcs):
        raise AssertionError(f"the bf16 flash kernels must run on the tensor cores: HMMA {hmma}")
    lap(1)

    if 2 in run:
        rows = check_kernels(args.seed)
        rows["paged_attention_varq"] = check_varq(args.seed)
        rows["w8a16_matmul"] = check_w8a16(args.seed)
        lap(2)
    if 3 in run:
        check_reference(args.seed)
        lap(3)
    drives = {}
    if 4 in run:
        drives[4] = drive_serving(args.seed, card)
        lap(4)
    if 5 in run:
        drives[5] = drive_serving(args.seed, card, quantize="int8", spec_k=4, kernels=PHASE5_KERNELS)
        lap(5)
    if {4, 5} <= run:
        a, b = drives[4], drives[5]
        log(f"phase 4 vs 5 [{card}]: tok/s {a['tok_s']:.1f} (bf16) vs {b['tok_s']:.1f} (int8 + spec K=4); "
            f"peak GiB {a['peak_gib']:.3f} vs {b['peak_gib']:.3f}; stream ttft_ms {a['ttft_ms']} vs "
            f"{b['ttft_ms']}; accept rate {b['spec_accepted'] / max(b['spec_proposed'], 1):.3f}")
    import tempfile

    from lumen_tpu_torch.runtime.decode_pool import shutdown_decode_pool

    # a phase that fails leaves no decode worker process behind
    with contextlib.ExitStack() as stack:
        stack.callback(shutdown_decode_pool)
        tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="lumen-chip-smoke-"))
        if 6 in run:
            grpc_drive = drive_grpc(args.seed, card, root=Path(tmp))
            log(f"phase 6 [{card}]: load {grpc_drive['load_s']:.2f} s (bf16), {grpc_drive['load8_s']:.2f} s (int8); "
                f"{grpc_drive['tok_s']:.1f} tok/s aggregate over gRPC; client ttft_ms {grpc_drive['ttft_ms']}; "
                f"peak GiB {grpc_drive['peak_gib']:.3f}")
            lap(6)
        if 7 in run:
            defaults = drive_defaults(args.seed, card, Path(tmp), grpc_drive)
            log(f"phase 7 [{card}]: {defaults['phase_s']:.1f} s in all; load {defaults['load_s']:.2f} s; "
                f"{defaults['preempted']} preemptions, "
                f"{defaults['resumed']} spill resumes, {defaults['prefix_hits']} prefix hits, a result-cache answer in "
                f"{defaults['cached_ms']:.2f} ms; launches {json.dumps(defaults['launches'])}")
            lap(7)
        if 8 in run:
            clip = drive_clip(args.seed, card, Path(tmp), grpc_drive)
            log(f"phase 8 [{card}]: {clip['phase_s']:.1f} s in all; load {clip['load_s']:.2f} s (labels "
                f"{clip['label_s']:.3f} s of it), hub {clip['hub_s']:.2f} s; cold round {clip['cold_s']:.2f} s; "
                f"{clip['images_s']:.1f} images/s over gRPC (one batch of 64 {clip['batch_ms']:.3f} ms on the device), "
                f"client p50 {clip['p50_ms']:.1f} ms p95 {clip['p95_ms']:.1f} ms, mean batch fill {100 * clip['fill']:.1f}%, "
                f"decode {clip['decode_ms']:.2f} ms a photo, peak GiB {clip['peak_gib']:.3f}; cosine to the plain path min "
                f"{clip['cos_min']:.6f}")
            lap(8)
        if 9 in run:
            face = drive_face(args.seed, card, Path(tmp), clip)
            log(f"phase 9 [{card}]: {face['phase_s']:.1f} s in all; stand-in pack exported in {face['export_s']:.1f} s, "
                f"face server up in {face['load_s']:.2f} s; {face['photos_s']:.1f} photos/s face_detect over gRPC with TF32 "
                f"convolutions ({face['photos_s_ieee']:.1f} in IEEE float32), client p50 {face['p50_ms']:.1f} ms p95 "
                f"{face['p95_ms']:.1f} ms, mean batch fill {100 * face['fill']:.1f}%; one detector batch of 16 "
                f"{face['det_ms']:.3f} ms (TF32 {face['det_tf32_ms']:.3f} ms), one embedder batch of 16 {face['rec_ms']:.3f} "
                f"ms (TF32 {face['rec_tf32_ms']:.3f} ms); NMS {face['nms_launches']} launches, {face['nms_host_ms']:.2f} host "
                f"ms a batch; syncs per forward {json.dumps(face['syncs'])}; peak GiB {face['peak_gib']:.3f}; IEEE: "
                f"{face['faces']} faces matched at IoU >= {face['iou_min']:.5f}, embeddings cosine >= {face['cos_min']:.6f}; "
                f"TF32: matched at IoU >= {face['tf32']['iou_min']:.5f}, {json.dumps(face['tf32'])}; graph CLIP exported in "
                f"{face['clip_export_s']:.1f} s, served in {face['clip_load_s']:.2f} s, cosine to phase 8 >= "
                f"{face['clip_cos']:.6f}; hub flash_attention launches {face['hub_launches']}")
            lap(9)
        if 10 in run:
            ocr = drive_ocr(args.seed, card, Path(tmp), grpc_drive, clip, face)
            log(f"phase 10 [{card}]: {ocr['phase_s']:.1f} s in all ((a) {ocr['a_s']:.1f} s, (b) {ocr['b_s']:.1f} s); stand-in pack exported in {ocr['export_s']:.1f} s, OCR "
                f"server up in {ocr['load_s']:.2f} s; {ocr['pages_s']:.2f} pages/s over gRPC with TF32 convolutions "
                f"({ocr['pages_s_ieee']:.2f} in IEEE float32), client p50 {ocr['p50_ms']:.1f} ms p95 {ocr['p95_ms']:.1f} ms; one "
                f"detector call {ocr['det_ms']:.3f} ms (IEEE {ocr['det_ieee_ms']:.3f}), one recognizer chunk of 16 "
                f"{ocr['rec_ms']:.3f} ms (IEEE {ocr['rec_ieee_ms']:.3f}); host postprocess {ocr['post_ms']:.2f} ms a page; "
                f"syncs per forward {json.dumps(ocr['syncs'])}; peak GiB {ocr['peak_gib']:.3f}; IEEE: {ocr['items']} items "
                f"matched at IoU >= {ocr['iou_min']:.5f}; TF32: {json.dumps(ocr['tf32'])}; native bf16: flash_attention "
                f"(head_dim 16) {ocr['native_launches']} launches over {ocr['native_chunks']} recognizer chunks, logits within "
                f"{ocr['bf16_logit_share']:.2e} of the plain path's scale; full tier up in {ocr['hub_s']:.2f} s, launches "
                f"{json.dumps(ocr['hub_launches'])}")
            lap(10)
        if 11 in run:
            ingest = drive_ingest(args.seed, card, Path(tmp), clip, face, ocr)
            log(f"phase 11 [{card}]: {ingest['phase_s']:.1f} s in all; tier + search up in {ingest['boot_s']:.2f} s; ingest "
                f"{ingest['images_s']:.2f} images/s (CLI, clip + face + ocr, batch 64), stage device ms a batch "
                f"{json.dumps({k: round(v, 3) for k, v in ingest['stage_ms'].items()})}, syncs flagged "
                f"{ingest['syncs_flagged']} in the sweep; launches {json.dumps(ingest['launches'])}, warm re-run none; "
                f"search: {ingest['upsert_rows_s']:,.0f} rows/s upserted, query p50 {ingest['p50_ms']:.2f} ms p95 "
                f"{ingest['p95_ms']:.2f} ms at 16 in flight ({ingest['mean_pass']:.1f} queries a shard pass; alone p50 "
                f"{ingest['solo_p50_ms']:.2f} ms), {ingest['near_ties']} near-ties, a full-shard scoring pass "
                f"{ingest['pass_ms']:.4f} ms (bound {ingest['pass_bound_ms']:.4f}); peak GiB {ingest['peak_gib']:.3f}")
            lap(11)
        if 12 in run:
            options = drive_vlm_options(args.seed, card, Path(tmp), grpc_drive, clip)
            co_bf16, co_int8 = options["coalesce_bf16"], options["coalesce_int8"]
            log(f"phase 12 [{card}]: {options['phase_s']:.1f} s in all; (a) graph tower exported in {options['export_s']:.1f} s, "
                f"served in {options['fast_load_s']:.2f} s, {options['tower_ms']:.2f} ms a forward ({options['tower_nodes']} "
                f"nodes), stream ttft p50 {options['ttft_p50_ms']:.1f} ms, _prepare syncs {options['prepare_syncs']}; (b) A/Bs "
                f"{' and '.join(f'{b:.1f} vs {q:.1f}' for b, q in zip(options['ab_bf16_tps'], options['ab_q8_tps']))} tok/s "
                f"(ratios {', '.join(f'{r:.3f}' for r in options['ab_ratios'])}) -> {options['ab_route']}, peak above the "
                f"start {', '.join(f'{m:.1f}' for m in options['ab_peak_mib'])} MiB, boots "
                f"{', '.join(f'{t:.2f}' for t in options['boot_ab_s'])} / {options['boot_verdict_s']:.2f} s; (c) "
                f"coalesce {co_bf16['tok_s']:.1f} (bf16) / {co_int8['tok_s']:.1f} (int8) tok/s, syncs a decode step "
                f"{co_bf16['syncs']:.2f} / {co_int8['syncs']:.2f} (before the repair {co_bf16['syncs_old']:.2f} / "
                f"{co_int8['syncs_old']:.2f}); (d) CLIP batch of 64 {options['clip_bf16_ms']:.3f} ms bf16 vs "
                f"{options['clip_q8_ms']:.3f} ms W8A8 -> {options['clip_route']}, cosine {options['clip_cos']:.6f}")
            lap(12)
        if 13 in run:
            fleet = drive_fleet(args.seed, card, Path(tmp), grpc_drive)
            log(f"phase 13 [{card}]: {fleet['phase_s']:.1f} s in all; {fleet['requests']} migrated rows equal to the "
                f"colocated control, {fleet['row_bytes'] / 1e6:.3f} MB a row, {fleet['fallbacks']} fallbacks in (b), "
                f"aggregate {fleet['tok_s_migrated']:.1f} tok/s migrated vs {fleet['tok_s_colocated']:.1f} colocated; "
                f"search {fleet['search_near_ties']} near-ties")
            lap(13)
        if 14 in run:
            models = Path(tmp) / "cache" / "models"
            torch.cuda.empty_cache()  # the supervised server shares the card with this process
            control = drive_control_plane(card, Path(tmp), grpc_drive["photos"],
                                          {name: models / src for name, src in CATALOG_SOURCES.items()})
            log(f"phase 14 [{card}]: {control['phase_s']:.1f} s in all; the full tier under the app's ServerManager "
                f"ready in {control['cold_s']:.2f} s cold and {control['warm_s']:.2f} s warm; the first caption "
                f"{control['cold_first_s']:.2f} s cold ({control['cold_builds']} kernel builds) and "
                f"{control['warm_first_s']:.2f} s warm (0 builds); launches {json.dumps(control['launches'])}, child "
                f"peak {control['peak_gib']:.3f} GiB")
            lap(14)
    log(f"seconds a phase: {json.dumps(laps)} [{card}]")
    if run != ALL_PHASES:
        log(f"phases {', '.join(map(str, sorted(run)))} passed [{card}]")
        return 0
    for k in kernels:
        counts = {part: c[k.name] for part, c in options["launches"].items() if k.name in c}
        log(f"kernel row {k.name}: phase-12 launches {json.dumps(counts)}; phase-13 launches decode host "
            f"{fleet['launches'][k.name]}, prefill host {fleet['prefill_host']['launches'][k.name]}; phase-14 "
            f"launches (the supervised full tier) {control['launches'][k.name]} [{card}]")
    for label in OCR_FLASH_SHAPES:
        row = rows[f"flash_attention ({label})"]
        log(f"kernel row flash_attention {label} {row['shape']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}: terms {json.dumps({k: round(v, 5) for k, v in row['bound_terms'].items()})}), plain "
            f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, max|diff| {row['max_abs_err']:.3e}, phase-10 (b) "
            f"launches {ocr['native_launches']} [{card}]")
    for label, key in (("CLIP vision", "vision (a)"), ("CLIP text, causal", "text (b)")):
        row = rows[f"flash_attention ({label})"]
        log(f"kernel row flash_attention {label} {row['shape']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, max|diff| "
            f"{row['max_abs_err']:.3e}, phase-8 launches {clip['launches'][key]} [{card}]")

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
    # The head_dim-16 instance of flash_attention (the native OCR recognizer,
    # phase 10 (b): its launches there) at its widest call.
    row = rows[f"flash_attention ({list(OCR_FLASH_SHAPES)[-1]})"]
    source, replaces = SOURCES["flash_attention"]
    table.append(dict(
        name="flash_attention [head_dim 16]", route="cuda", source=source, replaces=replaces,
        launches=ocr["native_launches"], max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
    ))
    log(f"{card}")
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
