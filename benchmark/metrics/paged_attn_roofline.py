"""The paged decode attention kernel's share of its roofline in the traced
window: the least time the window's decode attention needed (every output
token's step, one layer call each: q and the output at every head, K and
V of its context at the KV heads, read once) over the device time of the
kernel's calls in the trace (``paged_walk``)."""

from harness import window, work


def read(ctx):
    if ctx.trace is None:
        return None
    calls, seconds = ctx.trace.time_of(lambda name: "paged_walk" in name)
    if not calls:
        return None
    s = ctx.shape
    total = work.Work()
    live = {}
    for r, j in window.streamed(ctx):
        if r.index not in live:
            live[r.index] = window.live_length(ctx, r)
        total = total + work.paged_decode(s, live[r.index] + j + 1)
    return work.roofline_pct(total * s.layers, seconds)
