"""Process start to ready: weights made on the card, the manager built,
the kernels loaded (built on a checkout's first run) and the cell's shapes
warmed (host clock)."""


def read(ctx):
    return ctx.setup_s
