"""Int8 linear layers (twin of ``lumen_tpu/ops/quant.py``).

One byte per weight element: ``q`` [in, out] int8 with a
per-output-channel fp32 ``scale``, in two execution modes (``QDense``):

- ``dequant`` (the VLM decoder: decode at small batch streams the
  weights) computes on the caller's floats;
- ``dynamic`` (W8A8, the CLIP towers' default: batch embedding is bound
  by the products) quantizes the activations per token and multiplies
  int8 by int8 into int32.
"""

from __future__ import annotations

import os
import re
import weakref
from typing import Callable, Mapping

import torch
from torch import nn

from ..utils.env import env_choice
from ..utils.metrics import metrics
from .quant_matmul import MAX_KERNEL_ROWS, kernel_routable, w8a16_matmul


class QDense(nn.Module):
    """Int8 linear over per-output-channel quantized weights (JAX
    ``QDense``), ``y = (x @ q) * scale (+ bias)`` in one of two modes:

    - ``dequant``: decode-sized calls (at most :data:`MAX_KERNEL_ROWS`
      rows) with bf16 activations run the w8a16 kernel, which computes the
      dot on bf16 operands with fp32 accumulation and scale, unless a
      serving mesh of the process has had a ``model`` axis above 1
      (``quant_matmul.kernel_routable``, the JAX ``pallas_usable`` rule).
      Every other call -- prefill chunks, fp32 activations -- is the JAX XLA branch,
      ``(x @ q.to(x.dtype)) * scale.to(x.dtype)``, a plain matrix product:
      the kernel's bf16 contract would cost an fp32 caller mantissa.
    - ``dynamic`` (W8A8): each token's activations are quantized
      symmetrically, ``sx = max(|x|.max() / 127, 1e-8)``, ``qx =
      clip(round(x / sx), -127, 127)``, multiplied int8 by int8 into int32
      (:func:`int8_matmul`) and scaled by ``sx * scale`` in fp32.

    ``q`` and ``scale`` are buffers that keep their dtypes through
    ``Module.to``.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True, kernel_mode: str = "dequant"):
        super().__init__()
        if kernel_mode not in ("dequant", "dynamic"):
            raise ValueError(f"kernel_mode must be 'dequant' or 'dynamic', got {kernel_mode!r}")
        self.kernel_mode = kernel_mode
        self.in_features = in_features
        self.out_features = out_features
        self.register_buffer("q", torch.zeros((in_features, out_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones((out_features,), dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def _apply(self, fn, recurse=True):
        # ``Module.to(dtype)`` casts every floating buffer; the fp32 scale
        # must only follow the module's device (``q`` is int8, which a
        # dtype cast leaves alone).
        scale = self._buffers.pop("scale")
        try:
            super()._apply(fn, recurse)
        finally:
            self._buffers["scale"] = scale.to(self.q.device)
        return self

    def project(self, x: torch.Tensor, amax: torch.Tensor | None = None) -> torch.Tensor:
        """``(x @ q) * scale`` without the bias: the whole product, or on a
        tensor-parallel shard the partial a row-parallel projection sums
        (``parallel.tp.row_parallel``). ``q`` may be any rank's slice: the
        product takes its widths from it. ``amax`` is each token's
        ``|x|.max()`` over the WHOLE row when ``x`` holds a rank's columns
        of it (``dynamic`` quantizes every column with the row's scale)."""
        rows = x.numel() // x.shape[-1]
        out = self.q.shape[1]
        if self.kernel_mode == "dynamic":
            if amax is None:
                amax = x.abs().amax(dim=-1, keepdim=True).float()
            sx = torch.clamp_min(amax / 127.0, 1e-8)
            qx = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
            acc = int8_matmul(qx.reshape(rows, x.shape[-1]), self.q).reshape(*x.shape[:-1], out)
            return (acc.float() * sx * self.scale).to(x.dtype)
        if rows <= MAX_KERNEL_ROWS and x.dtype == torch.bfloat16 and kernel_routable():
            return w8a16_matmul(x, self.q, self.scale)
        return torch.matmul(x, self.q.to(x.dtype)) * self.scale.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(x)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


#: ``torch._int_mm``'s shape rules on the card: more than this many rows,
#: and K and N multiples of :data:`INT_MM_ALIGN`.
INT_MM_MIN_ROWS = 16
INT_MM_ALIGN = 8


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` [M, K] int8 @ ``b`` [K, N] int8 -> [M, N] int32, exactly
    (the JAX ``dot_general(..., preferred_element_type=int32)``). On the
    card it is the library's integer product ``torch._int_mm``: calls of
    at most :data:`INT_MM_MIN_ROWS` rows are padded with zero rows, and K
    or N that is not a multiple of :data:`INT_MM_ALIGN` raises (nothing is
    computed in floating point instead). The plain version, for CPU
    tensors, is an int32 matrix product."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: a {a.dtype} {tuple(a.shape)}, b {b.dtype} {tuple(b.shape)}")
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    m, k = a.shape
    n = b.shape[1]
    if k % INT_MM_ALIGN or n % INT_MM_ALIGN:
        raise ValueError(f"int8_matmul: K {k} and N {n} must be multiples of {INT_MM_ALIGN} on the card")
    if m <= INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((INT_MM_MIN_ROWS + 1 - m, k))])
    return torch._int_mm(a.contiguous(), b)[:m]


def resolve_q8_kernel(default: str) -> str:
    """The ``LUMEN_Q8_KERNEL`` knob, validated (JAX ``resolve_q8_kernel``).
    Defaults differ by family -- "dequant" for the VLM decoder, "dynamic"
    (W8A8) for the CLIP towers -- so the caller passes its own."""
    kernel = os.environ.get("LUMEN_Q8_KERNEL", default)
    if kernel not in ("dequant", "dynamic"):
        raise ValueError(f"LUMEN_Q8_KERNEL must be 'dequant' or 'dynamic', got {kernel!r}")
    return kernel


def resolve_q8_route(knob: str) -> str:
    """An int8 opt-in's route knob (``LUMEN_VLM_Q8_ROUTE``,
    ``LUMEN_CLIP_Q8_ROUTE``): ``auto``, ``int8`` or ``bf16``; unset means
    ``auto``, and so does a malformed value, with a warning."""
    return env_choice(knob, "auto", ("auto", "int8", "bf16"))


def register_route_gauges(owner, group: str) -> Callable[[], dict]:
    """Export ``group``'s route gauges from ``owner`` (held weakly):
    ``int8_active`` from ``owner.quant_route`` and, once an A/B or its
    verdict set it, ``q8_speedup_pct`` from ``owner.quant_speedup``.
    Returns the gauge function, for ``metrics.unregister_gauges``."""
    ref = weakref.ref(owner)

    def route_gauges() -> dict:
        m = ref()
        if m is None:
            return {}
        out = {"int8_active": 1 if m.quant_route == "int8" else 0}
        if m.quant_speedup is not None:
            out["q8_speedup_pct"] = round(m.quant_speedup * 100, 1)
        return out

    metrics.register_gauges(group, route_gauges)
    return route_gauges


def quantize_linear_int8(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``nn.Linear`` weight [out, in] -> (``q`` [in, out] int8, ``scale``
    [out] fp32): symmetric per output channel, the JAX grid
    ``scale = max(|w|.max(in) / 127, 1e-8)``, ``q = clip(round(w / scale),
    -127, 127)`` with ``w`` in fp32 (round half to even, as numpy)."""
    w = weight.detach().float().T
    scale = torch.clamp_min(w.abs().amax(dim=0) / 127.0, 1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8).contiguous()
    return q, scale


def quantize_state_int8(state: Mapping[str, torch.Tensor], weight_pattern: re.Pattern) -> dict[str, torch.Tensor]:
    """Replace each ``<prefix>.weight`` entry matching ``weight_pattern``
    with ``<prefix>.q`` + ``<prefix>.scale`` (JAX ``quantize_tree_int8``
    over a ``state_dict``). Apply AFTER the dtype-policy cast so the grid
    comes from the weights serving would otherwise use. The returned dict
    holds no reference to the replaced weights."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if weight_pattern.match(key):
            prefix = key[: -len("weight")]
            out[prefix + "q"], out[prefix + "scale"] = quantize_linear_int8(value)
        else:
            out[key] = value
    return out
