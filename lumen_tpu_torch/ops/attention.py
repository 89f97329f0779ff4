"""Attention ops of the VLM path: plain PyTorch versions and the four
hand-written Hopper kernels that replace the JAX package's Pallas ones.

Layouts are the JAX package's (``lumen_tpu/ops/attention.py``): ``q/k/v``
``[batch, heads, seq, head_dim]``; paged KV ``[pages, kv_heads, page,
head_dim]`` addressed through ``[batch, max_pages]`` int32 block tables.

Each kernel wrapper (:func:`flash_attention`, :func:`flash_attention_cache`,
:func:`paged_attention_kernel`, :func:`paged_attention_varq_kernel`) runs
its plain version when handed CPU tensors and launches its CUDA kernel
(``lumen_tpu_torch/csrc``) when handed CUDA tensors -- there is no
fallback and no switch: a CUDA tensor the kernel does not take raises.
The plain versions twin the JAX references (``attention_reference``,
``_decode_masked``, ``paged_attention_reference``,
``paged_attention_varq_reference``); the CPU tests hold them against JAX,
and ``chip_smoke.py`` holds the kernels against them on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
import threading

import torch

from .cuda_build import CSRC, CudaKernel

NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: dtype codes of csrc/common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

FLASH = CudaKernel(
    "flash_attention", "flash_attention", "lumen_flash_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
)
FLASH_CACHE = CudaKernel(
    "flash_attention_cache", "flash_attention_cache", "lumen_flash_attention_cache",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
)
PAGED = CudaKernel(
    "paged_attention", "paged_attention", "lumen_paged_attention",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
)
PAGED_VARQ = CudaKernel(
    "paged_attention_varq", "paged_attention_varq", "lumen_paged_attention_varq",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
)
#: every kernel of this module, for builds and launch counts.
KERNELS = (FLASH, FLASH_CACHE, PAGED, PAGED_VARQ)


def _scale(scale: float | None, d: int) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _check_cuda(name: str, tensors: dict, dtype: torch.dtype) -> None:
    """Refuse what a kernel does not take: every operand on one CUDA
    device, contiguous, 16-byte aligned, and (for the float operands) of
    a dtype the kernel was built for."""
    device = None
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, the kernel needs CUDA tensors")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, others on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
        if t.is_floating_point() and t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported (bfloat16, float16 or float32)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- plain versions ----------------------------------------------------------


def attention_reference(q, k, v, mask=None, causal: bool = False, scale: float | None = None):
    """Plain attention (twin of the JAX ``attention_reference``).
    ``mask``: broadcastable to [B, H, Sq, Sk], True = keep. Causal with
    ``sq != sk`` lets query i attend keys ``<= i + sk - sq``."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(scale, d)
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = torch.where(keep, logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def _decode_masked(q, k, v, q_offsets, kv_valid, scale: float | None = None):
    """Masked plain attention for the cache path: key j is visible to
    query i of sample b iff ``j < kv_valid[b]`` and ``j <= q_offsets[b] + i``
    (twin of the JAX ``_decode_masked``). The plain version of
    :func:`flash_attention_cache`."""
    sq, sk = q.shape[2], k.shape[2]
    key_slots = torch.arange(sk, device=q.device)
    q_abs = q_offsets[:, None] + torch.arange(sq, device=q.device)[None, :]  # [B, Sq]
    live = key_slots[None, :] < kv_valid[:, None]  # [B, Sk]
    causal = key_slots[None, None, :] <= q_abs[:, :, None]  # [B, Sq, Sk]
    mask = (live[:, None, :] & causal)[:, None]  # [B, 1, Sq, Sk]
    return attention_reference(q, k, v, mask=mask, scale=scale)


def _q_group_pad(g: int) -> int:
    """Query-head group padded to a multiple of 8 (JAX ``_q_group_pad``),
    as the plain versions pad it; the CUDA kernel packs real query rows
    only, and takes groups of at most 8."""
    return max(8, -(-g // 8) * 8)


def paged_attention_reference(q, k_pages, v_pages, block_tables, kv_lens, scale=None):
    """Plain ragged paged decode attention (twin of the JAX
    ``paged_attention_reference``): gather each row's pages through its
    block table, mask slots past ``kv_lens``, one max/exp/sum/div softmax.
    ``q`` [B, H, dh]; returns [B, H, dh]. Contract: ``kv_lens >= 1``."""
    b, h, d = q.shape
    _, kv_heads, page, _ = k_pages.shape
    maxp = block_tables.shape[1]
    g = h // kv_heads
    gp = _q_group_pad(g)
    bt = block_tables.long()
    # [B, MAXP, kvh, page, dh] -> [B, kvh, MAXP*page, dh]
    k = k_pages[bt].permute(0, 2, 1, 3, 4).reshape(b, kv_heads, maxp * page, d).float()
    v = v_pages[bt].permute(0, 2, 1, 3, 4).reshape(b, kv_heads, maxp * page, d).float()
    qg = q.reshape(b, kv_heads, g, d).float()
    if gp != g:
        qg = torch.nn.functional.pad(qg, (0, 0, 0, gp - g))
    s = torch.matmul(qg, k.transpose(-1, -2)) * _scale(scale, d)  # [B, kvh, Gp, S]
    live = torch.arange(maxp * page, device=q.device)[None, :] < kv_lens[:, None]
    s = torch.where(live[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    w = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(w, v)
    return out[:, :, :g].reshape(b, h, d).to(q.dtype)


def paged_attention_varq_reference(q, k_pages, v_pages, block_tables, kv_lens, scale=None):
    """Plain paged attention over a W-token verify window per row (twin of
    the JAX ``paged_attention_varq_reference``): the same gather, the
    window folded into the query rows ([W * Gp, S] logits per row and KV
    head), window slot ``t`` sees ``kv_lens[b] + t`` keys, one
    max/exp/sum/div softmax. ``q`` [B, W, H, dh]; returns [B, W, H, dh]."""
    b, w, h, d = q.shape
    _, kv_heads, page, _ = k_pages.shape
    maxp = block_tables.shape[1]
    g = h // kv_heads
    gp = _q_group_pad(g)
    bt = block_tables.long()
    k = k_pages[bt].permute(0, 2, 1, 3, 4).reshape(b, kv_heads, maxp * page, d).float()
    v = v_pages[bt].permute(0, 2, 1, 3, 4).reshape(b, kv_heads, maxp * page, d).float()
    qg = q.reshape(b, w, kv_heads, g, d).float()
    if gp != g:
        qg = torch.nn.functional.pad(qg, (0, 0, 0, gp - g))
    qg = qg.permute(0, 2, 1, 3, 4).reshape(b, kv_heads, w * gp, d)
    s = torch.matmul(qg, k.transpose(-1, -2)) * _scale(scale, d)  # [B, kvh, W*Gp, S]
    t = torch.arange(w * gp, device=q.device) // gp  # window slot per folded row
    live = (
        torch.arange(maxp * page, device=q.device)[None, None, :]
        < kv_lens.long()[:, None, None] + t[None, :, None]
    )  # [B, W*Gp, S]
    s = torch.where(live[:, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    wgt = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(wgt, v).reshape(b, kv_heads, w, gp, d)[:, :, :, :g]
    return out.permute(0, 2, 1, 3, 4).reshape(b, w, h, d).to(q.dtype)


# -- kernel wrappers ---------------------------------------------------------


#: head dims the flash kernel is built for: the VLM and CLIP towers' 64,
#: the Qwen2-MoE decoder's 128, the native OCR recognizer's 16 (the JAX
#: kernel takes any up to 256).
FLASH_HEAD_DIMS = (16, 64, 128)
#: head dims the cache and paged kernels are built for: the dense Qwen2
#: decoder's 64 and the Qwen2-MoE decoder's 128.
DECODER_HEAD_DIMS = (64, 128)


#: the fields of ``lumen_flash_plan`` (``csrc/flash_attention.cu``), in
#: its order; :func:`flash_plan` gives all but the last, which needs the
#: card (the occupancy calculator's blocks an SM).
FLASH_PLAN_FIELDS = (
    "path", "rows", "split", "stages", "threads", "smem", "row_blocks", "heaviest_first", "keys", "resident",
)


@functools.cache
def flash_plan_constants() -> dict:
    """The bf16 flash kernels' compile-time constants, read from
    ``csrc/flash_plan_bf16.cuh``: the short path's key limit, row groups
    and keys a softmax step, the long path's (row groups, key split, ring
    steps, keys a tile) by head_dim."""
    text = (CSRC / "flash_plan_bf16.cuh").read_text()
    c = {n: int(re.search(rf"constexpr int {n} = (\d+);", text)[1])
         for n in ("kFlashShortKeys", "kFlashShortGroups", "kFlashShortChunk")}
    long = {
        int(d): tuple(int(x) for x in rest)
        for d, *rest in re.findall(
            r"struct FlashLong<(\d+)> \{\s*static constexpr int kGroups = (\d+), kSplit = (\d+), "
            r"kSteps = (\d+), kKeys = (\d+),", text)
    }
    return {"short_keys": c["kFlashShortKeys"], "short_groups": c["kFlashShortGroups"],
            "short_chunk": c["kFlashShortChunk"], "long": long}


def flash_plan(sq: int, sk: int, head_dim: int, causal: bool) -> dict:
    """The launch plan of a bf16 or float16 :func:`flash_attention` call
    (one plan for both 2-byte types), twin of ``flash_plan`` in
    ``csrc/flash_plan_bf16.cuh`` (``chip_smoke.py`` holds the two equal on
    the card): a function of the shape alone, never of batch * heads.
    ``path`` "short" (sk <= 128: whole sequences a block, K/V once in
    shared memory) or "long" (a ring of key tiles); ``keys``: keys a
    warp's online-softmax step takes (a tile of the long path's ring); the
    grid is ``(batch * heads, row_blocks)``."""
    c = flash_plan_constants()
    row_bytes = (head_dim + 8) * 2  # a padded row of a 2-byte type
    r16 = lambda x: -(-x // 16) * 16  # noqa: E731
    if sk <= c["short_keys"]:
        rows = min(r16(sq), 16 * c["short_groups"])
        plan = dict(path="short", rows=rows, split=1, stages=0, keys=c["short_chunk"],
                    smem=(2 * r16(sk) + rows) * row_bytes)
    else:
        groups, split, steps, keys = c["long"][head_dim]
        plan = dict(path="long", rows=16 * groups, split=split, stages=split * steps, keys=keys,
                    smem=(2 * split * steps * keys + 16 * groups) * row_bytes)
    plan["threads"] = 2 * plan["rows"] * plan["split"]
    plan["row_blocks"] = -(-sq // plan["rows"])
    plan["heaviest_first"] = int(bool(causal) and plan["row_blocks"] > 1)
    return plan


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None):
    """Online-softmax attention (JAX ``flash_attention``): the CUDA kernel
    on CUDA tensors, :func:`attention_reference` on CPU tensors.

    The kernel has no backward (the JAX package has none either: its
    trainer differentiates the XLA reference). So with grad mode on, a
    CUDA operand that requires grad raises rather than returning an
    output the autograd graph would skip; training passes
    ``attention_reference`` to its model (``training.clip_trainer``)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: an operand requires grad with grad mode on; "
            "run inference under torch.inference_mode() and train on attention_reference"
        )
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in FLASH_HEAD_DIMS or sq < 1 or sk < 1:
        raise ValueError(f"flash_attention: head_dim {d} (kernel takes {FLASH_HEAD_DIMS}), sq {sq}, sk {sk}")
    _check_cuda("flash_attention", {"q": q, "k": k, "v": v}, q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        FLASH.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, sq, sk, d,
            _DTYPE_CODES[q.dtype], int(causal), _scale(scale, d), _stream(q), instance=d, dtype=q.dtype,
        )
    return out


def flash_attention_cache(q, k, v, q_offsets, kv_valid, scale: float | None = None):
    """Prefill against a contiguous KV buffer with per-sample causal
    offsets and live-slot counts (JAX ``flash_attention_cache``): the
    CUDA kernel on CUDA tensors, :func:`_decode_masked` on CPU tensors.
    ``q_offsets`` / ``kv_valid`` are [B] integer tensors."""
    if q.device.type == "cpu":
        return _decode_masked(q, k, v, q_offsets, kv_valid, scale)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention_cache: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    if d not in DECODER_HEAD_DIMS or sq < 1 or sk < 1:
        raise ValueError(
            f"flash_attention_cache: head_dim {d} (kernel takes {DECODER_HEAD_DIMS}), sq {sq}, sk {sk}"
        )
    q_offsets = q_offsets.to(torch.int32).contiguous()
    kv_valid = kv_valid.to(torch.int32).contiguous()
    if q_offsets.shape != (b,) or kv_valid.shape != (b,):
        raise ValueError("flash_attention_cache: q_offsets and kv_valid must be [B]")
    _check_cuda(
        "flash_attention_cache",
        {"q": q, "k": k, "v": v, "q_offsets": q_offsets, "kv_valid": kv_valid},
        q.dtype,
    )
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        FLASH_CACHE.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offsets.data_ptr(),
            kv_valid.data_ptr(), out.data_ptr(), b, h, sq, sk, d,
            _DTYPE_CODES[q.dtype], _scale(scale, d), _stream(q), instance=d, dtype=q.dtype,
        )
    return out


#: the fields of ``lumen_paged_plan`` (``csrc/paged_attention.cu``), in
#: its order; :func:`paged_plan` gives all but the last, which needs the
#: card (the occupancy calculator's blocks an SM).
PAGED_PLAN_FIELDS = ("span", "kv_heads", "slots", "slot_groups", "rows", "threads", "smem", "mma", "resident")

#: the storage types of ``PagedShape`` in ``csrc/paged_walk.cuh``
_PAGED_TYPES = {"__nv_bfloat16": torch.bfloat16, "__half": torch.float16, "float": torch.float32}


@functools.cache
def paged_walk_shapes() -> dict:
    """The paged walk's compile-time block shapes, read from
    ``csrc/paged_walk.cuh``: ``PagedShape<T, D>``'s span, KV-head rows a
    slot, query rows a block and warps a block by (dtype, head_dim), and
    the query rows a thread of the FMA path scores at once."""
    text = (CSRC / "paged_walk.cuh").read_text()
    shapes = {
        (_PAGED_TYPES[t], int(d)): dict(zip(("span", "head_rows", "rows", "warps"), map(int, rest)))
        for t, d, *rest in re.findall(
            r"struct PagedShape<(__nv_bfloat16|__half|float), (\d+)> \{\s*static constexpr int kSpan = (\d+), "
            r"kHeadRows = (\d+), kRows = (\d+), kWarps = (\d+);", text)
    }
    row_group = int(re.search(r"constexpr int kPagedRowGroup = (\d+);", text)[1])
    return {"shapes": shapes, "row_group": row_group}


@functools.cache
def paged_plan(group: int, head_dim: int, window: int, dtype: torch.dtype) -> dict:
    """The launch plan of a paged call, twin of ``paged_plan`` in
    ``csrc/paged_walk.cuh`` (``chip_smoke.py`` holds the two equal on the
    card): a function of (group = heads / kv_heads, head_dim, window,
    dtype) alone, never of the batch, ``maxp`` or the lengths. ``mma``: 1
    for the tensor-core path (bf16 or float16 at a group of two or more,
    one KV head a block, 16-row tiles a warp), 0 for the FMA path (fp32,
    and a 2-byte type at a group of one: several KV heads a block, so no
    query row is padding);
    ``span`` key positions a block; ``kv_heads`` a block; ``slots`` of the
    window a block, in ``slot_groups`` groups; ``rows`` = kv_heads x slots
    x group query rows a block; ``threads``; ``smem`` bytes of dynamic
    shared memory. Cached: every paged launch sizes its scratch by it."""
    c = paged_walk_shapes()
    sh = c["shapes"][(dtype, head_dim)]
    mma = int(dtype in (torch.bfloat16, torch.float16) and group >= 2)
    kv_heads = 1 if mma else max(1, sh["head_rows"] // group)
    per_slot = kv_heads * group
    slots_max = max(1, sh["rows"] // per_slot)
    slot_groups = -(-window // slots_max)
    slots = -(-window // slot_groups)
    rows = per_slot * slots
    items = kv_heads * -(-slots * group // c["row_group"]) * max(sh["span"], head_dim // 2)  # FMA path
    work = -(-rows // 16) if mma else -(-items // 32)
    warps = min(sh["warps"], max(4, work, -(-rows * (head_dim // 4) // 32)))
    size = 4 if dtype == torch.float32 else 2
    row_bytes = (head_dim + 16 // size) * size  # a K/V row padded by 16 B
    if mma:
        smem = (2 * sh["span"] + -(-rows // 16) * 16) * row_bytes
    else:
        smem = 2 * kv_heads * sh["span"] * row_bytes + rows * (head_dim + sh["span"] + 2) * 4
    return dict(span=sh["span"], kv_heads=kv_heads, slots=slots, slot_groups=slot_groups, rows=rows,
                threads=32 * warps, smem=smem, mma=mma)


def paged_launch(plan: dict, batch: int, window: int, heads: int, kv_heads: int, maxp: int, page: int,
                 head_dim: int) -> dict:
    """The grid, counters and workspace of a paged call under ``plan``:
    blocks (row x KV-head set x slot group, spans of the ``maxp * page``
    key positions); one counter per (row, KV-head set, slot group); one
    fp32 partial (``head_dim`` + 2: acc, m, l) per query row ([B, W, H])
    and span."""
    units = batch * -(-kv_heads // plan["kv_heads"]) * plan["slot_groups"]
    spans = -(-maxp * page // plan["span"])
    return dict(grid=(units, spans), counters=units,
                workspace=batch * window * heads * spans * (head_dim + 2) * 4)


#: per (device, stream): the int32 counters of the spans' merge, one per
#: (row, KV-head set, slot group). Zeroed once when made; every launch leaves
#: them at zero, so a call costs one kernel and no memset. Launches on one
#: stream run in order, so they never share a counter at the same time.
_PAGED_COUNTERS: dict[tuple, torch.Tensor] = {}
_PAGED_COUNTERS_LOCK = threading.Lock()


def _paged_scratch(q, window: int, kv_heads: int, maxp: int, page: int):
    """The workspace (``torch.empty``) and the stream's counters for a
    paged launch of ``q`` ([B, (W,) H, D]), sized by its plan."""
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    plan = paged_plan(h // kv_heads, d, window, q.dtype)
    sizes = paged_launch(plan, b, window, h, kv_heads, maxp, page, d)
    ws = torch.empty(sizes["workspace"] // 4, dtype=torch.float32, device=q.device)
    key = (q.device.index, _stream(q))
    with _PAGED_COUNTERS_LOCK:
        counters = _PAGED_COUNTERS.get(key)
        if counters is None or counters.numel() < sizes["counters"]:
            counters = torch.zeros(max(sizes["counters"], 4096), dtype=torch.int32, device=q.device)
            _PAGED_COUNTERS[key] = counters
    return ws, counters


def paged_attention_kernel(q, k_pages, v_pages, block_tables, kv_lens, scale=None):
    """Ragged paged decode attention (JAX ``paged_attention_kernel``): the
    CUDA kernel on CUDA tensors, :func:`paged_attention_reference` on CPU
    tensors. ``q`` [B, H, dh], one decode token per row."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables, kv_lens, scale)
    b, h, d = q.shape
    block_tables, kv_lens = _paged_operands("paged_attention", q, k_pages, v_pages, block_tables, kv_lens)
    kv_heads, page, maxp = k_pages.shape[1], k_pages.shape[2], block_tables.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        ws, counters = _paged_scratch(q, 1, kv_heads, maxp, page)
        PAGED.launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, h,
            kv_heads, page, maxp, d, _DTYPE_CODES[q.dtype], _scale(scale, d), _stream(q),
            instance=d, dtype=q.dtype,
        )
    return out


def paged_attention_varq_kernel(q, k_pages, v_pages, block_tables, kv_lens, scale=None):
    """Paged attention over a W-token verify window per row (JAX
    ``paged_attention_varq_kernel``): the CUDA kernel on CUDA tensors,
    :func:`paged_attention_varq_reference` on CPU tensors. ``q`` [B, W, H,
    dh], position-ordered; ``kv_lens`` [B] is the t = 0 visibility."""
    if q.device.type == "cpu":
        return paged_attention_varq_reference(q, k_pages, v_pages, block_tables, kv_lens, scale)
    b, w, h, d = q.shape
    block_tables, kv_lens = _paged_operands(
        "paged_attention_varq", q, k_pages, v_pages, block_tables, kv_lens
    )
    kv_heads, page, maxp = k_pages.shape[1], k_pages.shape[2], block_tables.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        ws, counters = _paged_scratch(q, w, kv_heads, maxp, page)
        PAGED_VARQ.launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, w, h,
            kv_heads, page, maxp, d, _DTYPE_CODES[q.dtype], _scale(scale, d), _stream(q),
            instance=d, dtype=q.dtype,
        )
    return out


def _paged_operands(name: str, q, k_pages, v_pages, block_tables, kv_lens):
    """Checks shared by the two paged kernels (``q`` [B, (W,) H, dh]);
    returns the int32 block tables and lengths the kernels read."""
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    kv_heads = k_pages.shape[1]
    if v_pages.shape != k_pages.shape or k_pages.dim() != 4 or k_pages.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} pages {tuple(k_pages.shape)}")
    if h % kv_heads or h // kv_heads > 8 or d not in DECODER_HEAD_DIMS:
        raise ValueError(
            f"{name}: heads {h}/{kv_heads} (group <= 8), head_dim {d} (kernel takes {DECODER_HEAD_DIMS})"
        )
    block_tables = block_tables.to(torch.int32).contiguous()
    kv_lens = kv_lens.to(torch.int32).contiguous()
    if block_tables.dim() != 2 or block_tables.shape[0] != b or kv_lens.shape != (b,):
        raise ValueError(f"{name}: block_tables must be [B, MAXP] and kv_lens [B]")
    _check_cuda(
        name,
        {"q": q, "k_pages": k_pages, "v_pages": v_pages,
         "block_tables": block_tables, "kv_lens": kv_lens},
        q.dtype,
    )
    return block_tables, kv_lens


# -- dispatch used by the models ---------------------------------------------


def attention(q, k, v, mask=None, causal: bool = False, scale: float | None = None):
    """Bidirectional or causal attention (JAX ``attention``). Every
    unmasked call on CUDA tensors runs the flash kernel: the JAX min-seq
    gate existed for a degenerate TPU grid and has no counterpart here. A
    call with a ``mask`` (broadcastable to [B, H, Sq, Sk], True = keep;
    the BERT text tower's padding mask) runs :func:`attention_reference`
    on any device, as the JAX ``attention`` sends every masked call to its
    XLA reference and never to Pallas."""
    if mask is not None:
        return attention_reference(q, k, v, mask=mask, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)


#: single-token cache decode reads a doubling ladder of live-prefix
#: lengths from here up (JAX ``_RAGGED_DECODE_MIN``).
_RAGGED_DECODE_MIN = 256


def ragged_decode_length(bound: int, sk: int) -> int:
    """Keys a single-token cache decode reads of an ``sk``-slot buffer:
    the live prefix ``bound`` (the largest ``kv_valid`` of the batch)
    rounded up a doubling ladder from :data:`_RAGGED_DECODE_MIN`, at most
    ``sk`` (JAX ``attention_cached``)."""
    if sk <= _RAGGED_DECODE_MIN:
        return sk
    length = _RAGGED_DECODE_MIN
    while length < min(bound, sk):
        length *= 2
    return min(length, sk)


def attention_cached(q, k, v, q_offsets, kv_valid, scale: float | None = None, kv_bound: int | None = None):
    """Cache-path dispatch (JAX ``attention_cached``): multi-token queries
    (prefill chunks) go to :func:`flash_attention_cache`. A single-token
    query takes the plain ragged ladder -- the live prefix rounded up a
    doubling ladder of lengths (:func:`ragged_decode_length`) -- as it is
    plain XLA in JAX; the continuous engine never takes it (its decode is
    paged). ``kv_bound`` is ``kv_valid.max()`` as the caller's host loop
    knows it: the decode loops pass it, so a step reads no device value
    back; without it the ladder reads ``kv_valid`` (a device-to-host sync
    on the card)."""
    sq, sk = q.shape[2], k.shape[2]
    if sq > 1:
        return flash_attention_cache(q, k, v, q_offsets, kv_valid, scale)
    if sk > _RAGGED_DECODE_MIN:
        length = ragged_decode_length(int(kv_valid.max()) if kv_bound is None else kv_bound, sk)
        k, v = k[:, :, :length], v[:, :, :length]
    return _decode_masked(q, k, v, q_offsets, kv_valid, scale)


def repeat_kv(x, n_rep: int):
    """[B, kv_heads, S, D] -> [B, kv_heads * n_rep, S, D] for GQA, contiguous
    (from one KV head the reshape would be a stride-0 view, which the
    kernels refuse: a tensor-parallel rank may hold a single KV head)."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d).contiguous()


def paged_attention(q, k_pages, v_pages, block_tables, kv_lens, scale=None):
    """Paged decode dispatch (JAX ``paged_attention``): a 3-D ``q`` [B, H,
    dh] is one decode token per row; a 4-D ``q`` [B, W, H, dh] is the
    speculative verify window, where ``kv_lens`` stays the t = 0
    visibility and slot t sees ``kv_lens + t`` keys."""
    if q.dim() == 4:
        return paged_attention_varq_kernel(q, k_pages, v_pages, block_tables, kv_lens, scale)
    return paged_attention_kernel(q, k_pages, v_pages, block_tables, kv_lens, scale)
