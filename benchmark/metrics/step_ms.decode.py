"""Milliseconds of the window a decode step stands for: the window's
seconds over the decode steps the engine ran in it (``blocks_run`` times
the block); prefill chunks and the vision tower run between the steps and
are in it."""

from harness import window


def read(ctx):
    steps = window.decode_steps(ctx)
    return 1e3 * ctx.window_s / steps if steps else None
