"""The yardstick: the chip's peaks, and the operations and bytes that a
kernel call or a model token needs, counted from shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 989 TFLOP/s in bf16 and fp16 and 3.35 TB/s of HBM, as
``chip_smoke.py``'s ``bound`` has them, and 4.18e12 exp2 a second, the
special-function rate of the repository's kernel table. A call's least
time is the
largest of its bytes, FLOPs and exponentials over these rates; every input
byte is counted once and every output byte once, whatever a kernel reads
again, and only the work the live rows need (padding and finished rows
are the kernel's waste, not its work).
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 4.18e12


@dataclass
class Work:
    bytes: float = 0.0
    flops: float = 0.0
    exps: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops, self.exps + other.exps)

    def __mul__(self, n: float) -> "Work":
        return Work(self.bytes * n, self.flops * n, self.exps * n)

    def bound_s(self) -> float:
        return max(self.bytes / PEAK_BYTES, self.flops / PEAK_FLOPS, self.exps / PEAK_EXP)


def roofline_pct(work: Work, device_s: float) -> "float | None":
    """The least time over the time taken, in percent; None with no time."""
    if device_s <= 0:
        return None
    return 100.0 * work.bound_s() / device_s


def paged_decode(s, context: int, elem: int = 2) -> Work:
    """One row's single-token attention over ``context`` keys, one layer:
    q and the output at every head, K and V at the KV heads."""
    hd = s.head_dim
    return Work(
        bytes=elem * (2 * s.heads * hd + 2 * s.kv_heads * context * hd),
        flops=4.0 * s.heads * context * hd,
        exps=float(s.heads * context),
    )


def decoder_token_flops(s, context: int, logits: bool) -> float:
    """Model FLOPs of one decoder token at ``context`` keys: every
    projection it multiplies (a MoE layer's router, its top-k experts and
    shared expert only), attention's two products, and the output head
    when its logits are computed."""
    d, hd = s.hidden, s.head_dim
    attn_params = d * s.heads * hd * 2 + d * s.kv_heads * hd * 2
    total = 0.0
    for i in range(s.layers):
        if s.is_moe(i):
            ffn = d * s.experts + s.top_k * 3 * d * s.expert_width
            if s.shared_width:
                ffn += 3 * d * s.shared_width + d
        else:
            ffn = 3 * d * s.intermediate
        total += 2.0 * (attn_params + ffn) + 4.0 * s.heads * hd * context
    if logits:
        total += 2.0 * d * s.vocab
    return total


def vision_flops(s) -> float:
    """Model FLOPs of one image through the tower and the projector."""
    n, w = s.vision_tokens, s.v_width
    patch = 2.0 * n * (s.patch * s.patch * 3) * w
    per_layer = 2.0 * n * (4 * w * w + 8 * w * w) + 4.0 * n * n * w
    proj = 2.0 * n * (w * s.hidden + s.hidden * s.hidden)
    return patch + s.v_layers * per_layer + proj
