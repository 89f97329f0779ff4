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
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

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
        raise ValueError(f"{name}: dtype {dtype} not supported (bfloat16 or float32)")


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
    """Query-head group padded to a multiple of 8 (JAX ``_q_group_pad``).
    The CUDA kernel holds at most one such group of 8 per KV head."""
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


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None):
    """Online-softmax attention (JAX ``flash_attention``): the CUDA kernel
    on CUDA tensors, :func:`attention_reference` on CPU tensors."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d != 64 or sq < 1 or sk < 1:
        raise ValueError(f"flash_attention: head_dim {d} (kernel takes 64), sq {sq}, sk {sk}")
    _check_cuda("flash_attention", {"q": q, "k": k, "v": v}, q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        FLASH.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, sq, sk, d,
            _DTYPE_CODES[q.dtype], int(causal), _scale(scale, d), _stream(q),
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
    if d != 64 or sq < 1 or sk < 1:
        raise ValueError(f"flash_attention_cache: head_dim {d} (kernel takes 64), sq {sq}, sk {sk}")
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
            _DTYPE_CODES[q.dtype], _scale(scale, d), _stream(q),
        )
    return out


@functools.cache
def paged_walk_constants() -> dict[str, int]:
    """The split walk's compile-time constants, read from
    ``csrc/paged_walk.cuh``: ``span`` key positions a block (aligned to
    absolute positions), ``group_max`` query heads a KV head."""
    text = (CSRC / "paged_walk.cuh").read_text()
    c = {n: int(re.search(rf"constexpr int {n} = (\d+);", text)[1]) for n in ("kPagedSpan", "kPagedGroupMax")}
    return {"span": c["kPagedSpan"], "group_max": c["kPagedGroupMax"]}


def paged_grid(slots: int, maxp: int, page: int) -> tuple[int, int]:
    """Blocks of a split-walk launch: (spans of the table, row x KV head x
    window slot) -- the span count covers ``maxp * page`` key positions."""
    span = paged_walk_constants()["span"]
    return -(-maxp * page // span), slots


def paged_workspace_bytes(slots: int, maxp: int, page: int, head_dim: int) -> int:
    """fp32 workspace of a launch: one partial (m and l of each head slot
    of the group, then its [head_dim] accumulator) per block of the grid."""
    spans, _ = paged_grid(slots, maxp, page)
    return slots * spans * paged_walk_constants()["group_max"] * (head_dim + 2) * 4


#: per (device, stream): the int32 counters of the spans' merge, one per
#: (row, KV head, window slot). Zeroed once when made; every launch leaves
#: them at zero, so a call costs one kernel and no memset. Launches on one
#: stream run in order, so they never share a counter at the same time.
_PAGED_COUNTERS: dict[tuple, torch.Tensor] = {}
_PAGED_COUNTERS_LOCK = threading.Lock()


def _paged_scratch(q, slots: int, maxp: int, page: int):
    """The workspace (``torch.empty``) and the stream's counters for a
    split-walk launch with ``slots`` (row, KV head, window slot) triples."""
    ws = torch.empty(
        paged_workspace_bytes(slots, maxp, page, q.shape[-1]) // 4, dtype=torch.float32, device=q.device
    )
    key = (q.device.index, _stream(q))
    with _PAGED_COUNTERS_LOCK:
        counters = _PAGED_COUNTERS.get(key)
        if counters is None or counters.numel() < slots:
            counters = torch.zeros(max(slots, 4096), dtype=torch.int32, device=q.device)
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
        ws, counters = _paged_scratch(q, b * kv_heads, maxp, page)
        PAGED.launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, h,
            kv_heads, page, maxp, d, _DTYPE_CODES[q.dtype], _scale(scale, d), _stream(q),
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
        ws, counters = _paged_scratch(q, b * kv_heads * w, maxp, page)
        PAGED_VARQ.launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, w, h,
            kv_heads, page, maxp, d, _DTYPE_CODES[q.dtype], _scale(scale, d), _stream(q),
        )
    return out


def _paged_operands(name: str, q, k_pages, v_pages, block_tables, kv_lens):
    """Checks shared by the two paged kernels (``q`` [B, (W,) H, dh]);
    returns the int32 block tables and lengths the kernels read."""
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    kv_heads = k_pages.shape[1]
    if v_pages.shape != k_pages.shape or k_pages.dim() != 4 or k_pages.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} pages {tuple(k_pages.shape)}")
    if h % kv_heads or h // kv_heads > 8 or d != 64:
        raise ValueError(f"{name}: heads {h}/{kv_heads} (group <= 8), head_dim {d} (kernel takes 64)")
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


def attention(q, k, v, causal: bool = False, scale: float | None = None):
    """Bidirectional or causal attention (JAX ``attention``). Every call on
    CUDA tensors runs the flash kernel: the JAX min-seq gate existed for a
    degenerate TPU grid and has no counterpart here."""
    return flash_attention(q, k, v, causal=causal, scale=scale)


#: single-token cache decode reads a doubling ladder of live-prefix
#: lengths from here up (JAX ``_RAGGED_DECODE_MIN``).
_RAGGED_DECODE_MIN = 256


def attention_cached(q, k, v, q_offsets, kv_valid, scale: float | None = None):
    """Cache-path dispatch (JAX ``attention_cached``): multi-token queries
    (prefill chunks) go to :func:`flash_attention_cache`. A single-token
    query takes the plain ragged ladder -- the live prefix rounded up a
    doubling ladder of lengths -- as it is plain XLA in JAX; the
    continuous engine never takes it (its decode is paged)."""
    sq, sk = q.shape[2], k.shape[2]
    if sq > 1:
        return flash_attention_cache(q, k, v, q_offsets, kv_valid, scale)
    if sk > _RAGGED_DECODE_MIN:
        bound = int(kv_valid.max())
        length = _RAGGED_DECODE_MIN
        while length < min(bound, sk):
            length *= 2
        length = min(length, sk)
        k, v = k[:, :, :length], v[:, :, :length]
    return _decode_masked(q, k, v, q_offsets, kv_valid, scale)


def repeat_kv(x, n_rep: int):
    """[B, kv_heads, S, D] -> [B, kv_heads * n_rep, S, D] for GQA."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def paged_attention(q, k_pages, v_pages, block_tables, kv_lens, scale=None):
    """Paged decode dispatch (JAX ``paged_attention``): a 3-D ``q`` [B, H,
    dh] is one decode token per row; a 4-D ``q`` [B, W, H, dh] is the
    speculative verify window, where ``kv_lens`` stays the t = 0
    visibility and slot t sees ``kv_lens + t`` keys."""
    if q.dim() == 4:
        return paged_attention_varq_kernel(q, k_pages, v_pages, block_tables, kv_lens, scale)
    return paged_attention_kernel(q, k_pages, v_pages, block_tables, kv_lens, scale)
