"""Kernel launches on the card in the traced window (every kernel the
profiler saw, the program's own and the libraries') over the output
tokens streamed in it."""

from harness import window


def read(ctx):
    n = window.tokens(ctx)
    if ctx.trace is None or not n:
        return None
    return len(ctx.trace.kernels()) / n
