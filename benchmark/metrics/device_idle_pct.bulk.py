"""Share of the traced window in which nothing ran on the card: one minus
the union of the trace's device operations (overlaps count once) over the
window."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
