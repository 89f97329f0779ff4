"""Rows a decode step served: output tokens streamed inside the window
over the decode steps the engine ran in it (its ``blocks_run`` counter
times the block). At most the preset's slots."""

from harness import window


def read(ctx):
    steps = window.decode_steps(ctx)
    return window.tokens(ctx) / steps if steps else None
