"""Model FLOPs the window's work needed, over the window's seconds at the
card's bf16 peak (989 TFLOP/s): every photo whose request was sent in the
window through the tower and projector, every prompt token prefilled for
requests whose first token came in it (one output head each), and every
output token streamed in it (with its output head), each at its context;
a MoE layer counts its router, top-k experts and shared expert only."""

from harness import window, work


def read(ctx):
    s = ctx.shape
    base = work.decoder_token_flops(s, 0, False)
    per_key = work.decoder_token_flops(s, 1, False) - base
    head = work.decoder_token_flops(s, 0, True) - base
    flops = 0.0
    for r in ctx.records:
        if r.sent is not None and ctx.t0 <= r.sent <= ctx.t1:
            flops += work.vision_flops(s)
        if r.first is not None and ctx.t0 <= r.first <= ctx.t1:
            n = window.live_length(ctx, r)
            flops += n * base + per_key * n * (n + 1) / 2 + head
    for r, j in window.streamed(ctx):
        flops += base + per_key * (window.live_length(ctx, r) + j + 1) + head
    return 100.0 * flops / (ctx.window_s * work.PEAK_FLOPS)
