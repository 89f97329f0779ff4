"""w8a16 dequant-matmul for the int8 decoder's decode-sized projections
(twin of ``lumen_tpu/ops/quant_matmul.py``).

``y = (x @ bf16(q)) * scale``: ``x`` [..., K] bf16 activations, ``q``
[K, N] int8 weights, ``scale`` [N] fp32 per output channel; the dot
accumulates in fp32, the scale is applied in fp32 and ``y`` is rounded to
``x.dtype`` once. :func:`w8a16_matmul` launches the hand-written Hopper
kernel (``csrc/w8a16_matmul.cu``) on CUDA tensors and runs the plain
:func:`w8a16_reference` on CPU tensors; a CUDA call the kernel cannot take
raises. Which calls come here is ``QDense``'s routing (``ops/quant.py``):
rows <= :data:`MAX_KERNEL_ROWS` and bf16 activations, the JAX package's
own rules, and its tensor-parallel rule: once any serving mesh in the
process has had a ``model`` axis above 1 (:func:`note_mesh_model_axis`,
called by the managers on every rank), decode-sized calls take the dequant
dot (:func:`kernel_routable`). It is a routing rule, as the JAX package's,
not a fallback: under ``model`` > 1 the JAX package serves that dot too.
Its ``LUMEN_Q8_PALLAS`` knob is not ported (the port has no dispatch
knobs).
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from .cuda_build import CSRC, CudaKernel

#: Max rows routed to the kernel: decode and verify-window shapes (JAX
#: ``MAX_PALLAS_ROWS``). Larger row counts (prefill chunks) are a plain
#: matrix product.
MAX_KERNEL_ROWS = 64

#: Largest ``model``-axis size any serving mesh in this process has
#: reported (JAX ``_MESH_MODEL_AXIS``).
_MESH_MODEL_AXIS = 1


def note_mesh_model_axis(size: int) -> None:
    """Serving managers report their mesh's ``model``-axis size here at
    construction (JAX ``note_mesh_model_axis``). Sticky maximum: one
    tensor-parallel manager anywhere in the process routes every
    decode-sized bf16 int8 call to the dequant dot."""
    global _MESH_MODEL_AXIS
    _MESH_MODEL_AXIS = max(_MESH_MODEL_AXIS, int(size))


def kernel_routable() -> bool:
    """The tensor-parallel half of ``QDense``'s routing (JAX
    ``pallas_usable``'s ``_MESH_MODEL_AXIS > 1`` gate): False once a
    ``model`` axis above 1 was noted."""
    return _MESH_MODEL_AXIS == 1


#: the kernel's tiles: N in 64-column tiles, K in 16-byte (8-element) vectors.
_COL_TILE, _K_VEC = 64, 8

_P, _I = ctypes.c_void_p, ctypes.c_int

W8A16 = CudaKernel("w8a16_matmul", "w8a16_matmul", "lumen_w8a16_matmul", [_P, _P, _P, _P, _I, _I, _I, _P])
#: every kernel of this module, for builds and launch counts.
KERNELS = (W8A16,)


@functools.cache
def w8a16_constants() -> dict[str, int]:
    """The kernel's compile-time constants (``kQm*`` of
    ``csrc/w8a16_matmul.cu``): rows, max_row_tiles, cols, depth, stages
    (one row tile a block), stages_wide (more), max_parts, target_blocks,
    max_blocks."""
    text = (CSRC / "w8a16_matmul.cu").read_text()
    names = dict(rows="kQmRows", max_row_tiles="kQmMaxRowTiles", cols="kQmCols", depth="kQmDepth",
                 stages="kQmStages", stages_wide="kQmStagesWide", max_parts="kQmMaxParts",
                 target_blocks="kQmTargetBlocks", max_blocks="kQmMaxBlocks")
    return {key: int(re.search(rf"constexpr int {c} = (\d+);", text)[1]) for key, c in names.items()}


def w8a16_parts(k: int, n: int) -> int:
    """K parts the kernel cuts a [K, N] weight into (``qm_parts``): the
    largest power of two <= max_parts that is at most K's 64-deep chunks
    and brings the N / 64 column tiles to target_blocks. A function of K
    and N alone, so a row's bits never depend on the call's row count."""
    c = w8a16_constants()
    chunks = -(-k // c["depth"])
    want = -(-c["target_blocks"] // (n // c["cols"]))
    parts = 1
    while parts * 2 <= min(c["max_parts"], chunks, want):
        parts *= 2
    return parts


def w8a16_grid(m: int, k: int, n: int) -> tuple[int, int, int, int]:
    """A launch (``qm_block_row_tiles``): (column tiles, K parts = the
    cluster, blocks along the rows, row tiles a block). A block takes one
    16-row tile unless that makes more than max_blocks blocks; then every
    row tile of the call. Rows never share arithmetic, so this choice,
    unlike the K split, may follow M."""
    c = w8a16_constants()
    tiles, parts, row_tiles = n // c["cols"], w8a16_parts(k, n), -(-m // c["rows"])
    rt = 1 if tiles * parts * row_tiles <= c["max_blocks"] else row_tiles
    return tiles, parts, -(-row_tiles // rt), rt


def w8a16_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(x.float() @ q.float()) * scale`` in fp32, rounded
    to ``x.dtype`` once (the kernel's contract)."""
    return ((x.float() @ q.float()) * scale.float()).to(x.dtype)


def check_w8a16_operands(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    """Refuse what the kernel does not take: bf16 ``x`` [..., K], int8 ``q``
    [K, N] with ``K % 8 == 0`` and ``N % 64 == 0``, fp32 ``scale`` [N]."""
    if q.dim() != 2 or x.shape[-1] != q.shape[0] or scale.shape != (q.shape[1],):
        raise ValueError(
            f"w8a16_matmul: x {tuple(x.shape)}, q {tuple(q.shape)}, scale {tuple(scale.shape)}"
        )
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(
            f"w8a16_matmul: x {x.dtype} (bfloat16), q {q.dtype} (int8), scale {scale.dtype} (float32)"
        )
    k, n = q.shape
    if k % _K_VEC or n % _COL_TILE:
        raise ValueError(f"w8a16_matmul: K={k} must be a multiple of {_K_VEC}, N={n} of {_COL_TILE}")


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ bf16(q)) * scale`` (JAX ``w8a16_matmul``): the CUDA kernel on
    CUDA tensors, :func:`w8a16_reference` on CPU tensors. Leading dims of
    ``x`` flatten to rows."""
    if x.device.type == "cpu":
        return w8a16_reference(x, q, scale)
    check_w8a16_operands(x, q, scale)
    k, n = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    rows = x2.shape[0]
    if not 1 <= rows <= MAX_KERNEL_ROWS:
        raise ValueError(f"w8a16_matmul: {rows} rows (the kernel takes 1 to {MAX_KERNEL_ROWS})")
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    for arg, t in (("x", x2), ("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"w8a16_matmul: {arg} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w8a16_matmul: {arg} must be contiguous and 16-byte aligned")
    with torch.cuda.device(x.device):
        W8A16.launch(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, k, n,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return y.reshape(*lead, n)
