"""Output tokens streamed inside the window over the window's seconds,
those of requests still running at its close included (host clock)."""

from harness import window


def read(ctx):
    return window.tokens(ctx) / ctx.window_s
