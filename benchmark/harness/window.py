"""What a window's records say, for the metric readers."""

from __future__ import annotations

from .tokenizer import WordTokenizer, prompt_ids


def live_length(ctx, rec) -> int:
    """Tokens of a request's prompt after the image's tokens replace its
    image id."""
    tok = WordTokenizer(ctx.shape.vocab)
    return len(prompt_ids(tok, rec.text, ctx.shape.image_token_id)) - 1 + ctx.shape.vision_tokens


def streamed(ctx):
    """``(record, j)`` for every output token streamed inside the window,
    ``j`` its place in the request's output."""
    for r in ctx.records:
        j = 0
        for t, n in r.chunks:
            if ctx.t0 <= t <= ctx.t1:
                for k in range(n):
                    yield r, j + k
            j += n


def tokens(ctx) -> int:
    return sum(n for r in ctx.records for t, n in r.chunks if ctx.t0 <= t <= ctx.t1)


def decode_steps(ctx) -> int:
    """Decode steps the engine ran inside the window (blocks x block)."""
    return (ctx.gauges1["blocks_run"] - ctx.gauges0["blocks_run"]) * ctx.block

