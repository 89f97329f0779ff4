"""Weight-only int8 linear layers (twin of ``lumen_tpu/ops/quant.py``).

Decode at small batch is bound by streaming the weights, so the int8
decoder stores one byte per weight element: ``q`` [in, out] int8 with a
per-output-channel fp32 ``scale``. Only the ``dequant`` execution mode is
ported; the W8A8 ``dynamic`` mode comes with the CLIP slice.
"""

from __future__ import annotations

import re
from typing import Mapping

import torch
from torch import nn

from .quant_matmul import MAX_KERNEL_ROWS, w8a16_matmul


class QDense(nn.Module):
    """Int8 linear over weight-only quantized params (JAX ``QDense``,
    ``dequant`` mode): ``y = (x @ q) * scale (+ bias)``.

    Decode-sized calls (at most :data:`MAX_KERNEL_ROWS` rows) with bf16
    activations run the w8a16 kernel, which computes the dot on bf16
    operands with fp32 accumulation and scale. Every other call -- prefill
    chunks, fp32 activations -- is the JAX XLA branch, ``(x @
    q.to(x.dtype)) * scale.to(x.dtype)``, a plain matrix product: the
    kernel's bf16 contract would cost an fp32 caller mantissa. ``q`` and
    ``scale`` are buffers that keep their dtypes through ``Module.to``.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True, kernel_mode: str = "dequant"):
        super().__init__()
        if kernel_mode == "dynamic":
            raise NotImplementedError(
                "QDense kernel_mode='dynamic' (W8A8) is not ported yet; it comes with the CLIP slice"
            )
        if kernel_mode != "dequant":
            raise ValueError(f"kernel_mode must be 'dequant' or 'dynamic', got {kernel_mode!r}")
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.numel() // x.shape[-1]
        if rows <= MAX_KERNEL_ROWS and x.dtype == torch.bfloat16:
            y = w8a16_matmul(x, self.q, self.scale)
        else:
            y = torch.matmul(x, self.q.to(x.dtype)) * self.scale.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


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
