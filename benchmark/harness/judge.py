"""Whether what the timed path served is correct.

Once the window has closed and the program is shut, a sample of the
requests it finished, drawn from the seed and always holding the longest,
is run through the plain float32 reference: each prompt (its photo made
again from its seed) followed by the tokens the program served. At each
served token the reference's logits give the gap by which the served
token's logit lies below the reference's best (0 where the program chose
what the reference would), and the reference's own margin, its best over
its runner-up. Decoding is greedy under the mix's repetition penalty,
which the reference applies to its own logits as the program does (the
prompt's ids as the program holds them, padded to their bucket, and the
tokens served so far), so a token differs from the reference's only where
error in the program's logits outweighed the margin there. The widest gap
and the mean gap are each held to the cell's limit; the count of tokens
that differ (``flips``) and the median margin are reported beside them.
Without the penalty, greedy captions of a seeded model fall into loops
whose margins no precision moves, and then no token differs under any.

The control (``control_readings``, run by ``control.py`` and never by a
benchmark run) is the reference computed with float8 operands in every
weight product, read on the same prompts and served tokens: the gap of
the token it puts first at each position.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import vlm as ref

from .serve import photo
from .tokenizer import prompt_ids


def sample(records: list, seed: int, min_tokens: int, max_requests: int) -> list:
    """Finished requests to check: the longest (lowest index on a tie),
    then others in an order drawn from the seed, until ``min_tokens``
    served tokens or ``max_requests`` requests."""
    done = sorted((r for r in records if r.finish is not None and r.tokens and r.error is None),
                  key=lambda r: r.index)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.index))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 17]).permutation(len(rest))
    picked, total = [longest], len(longest.tokens)
    for k in order:
        if total >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(rest[int(k)])
        total += len(rest[int(k)].tokens)
    return picked


def _inputs(w, shape, traffic, picked, cfg: dict, buckets) -> tuple:
    """Per request: the reference's input embeddings, the positions whose
    logits predict the served tokens, the served tokens, and the ids the
    repetition penalty covers before the first of them: the prompt's ids
    as the program holds them, padded to their bucket."""
    from .tokenizer import WordTokenizer

    text = cfg["text_config"]
    eos = text["eos_token_id"]
    pad = text.get("pad_token_id")
    pad = text.get("bos_token_id", eos) if pad is None else pad
    tok = WordTokenizer(shape.vocab)
    seqs, wanted, served, seen = [], [], [], []
    for r in picked:
        toks = list(r.tokens) + ([eos] if r.finish == "eos_token" else [])
        ids = prompt_ids(tok, r.text, shape.image_token_id)
        pixels = torch.from_numpy(photo(traffic.photo_seed(r.index), shape.image_size))
        x, at = ref.caption_inputs(w, shape, pixels, ids, toks)
        seqs.append(x)
        wanted.append(at)
        served.append(toks)
        bucket = next(b for b in buckets if len(ids) <= b)
        seen.append(sorted(set(ids) | ({pad} if bucket > len(ids) else set())))
    return seqs, wanted, served, seen


def penalized(lg: torch.Tensor, seen: list, served: list, penalty: float) -> torch.Tensor:
    """The logits ``[T, V]`` that pick served token ``j`` under the
    CTRL-style repetition penalty: at position ``j`` every id in ``seen``
    or among the served tokens before ``j`` has a positive logit divided by
    ``penalty`` and a negative one multiplied."""
    if penalty == 1.0:
        return lg
    mask = torch.zeros(lg.shape, dtype=torch.bool, device=lg.device)
    mask[:, torch.as_tensor(seen, device=lg.device)] = True
    for j, t in enumerate(served[:-1]):
        mask[j + 1:, t] = True
    p = torch.tensor(penalty, dtype=torch.float32)
    return torch.where(mask, torch.where(lg > 0, lg / p, lg * p), lg)


def _summary(gaps: list, margins: list, picked: list) -> dict:
    g, m = torch.cat(gaps).double(), torch.cat(margins).double()
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()), "flips": int((g > 0).sum()),
            "margin_median": float(m.median()), "tokens": int(g.numel()), "requests": len(picked)}


def _margin(lg: torch.Tensor) -> torch.Tensor:
    top = lg.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu()


@torch.no_grad()
def readings(cfg: dict, state: dict, traffic, picked: list, device, buckets) -> dict:
    """The gaps of the served tokens of ``picked`` against the reference."""
    ref.ieee()
    shape = ref.shape_of(cfg)
    w = ref.Weights(state, device)
    seqs, wanted, served, seen = _inputs(w, shape, traffic, picked, cfg, buckets)
    gaps, margins = [], []
    for r, lg, toks, ids in zip(picked, ref.decoder_logits(w, shape, seqs, wanted), served, seen):
        lg = penalized(lg, ids, toks, r.repetition_penalty)
        idx = torch.as_tensor(toks, device=lg.device)[:, None]
        gaps.append((lg.max(dim=-1).values - lg.gather(1, idx)[:, 0]).cpu())
        margins.append(_margin(lg))
    return _summary(gaps, margins, picked)


@torch.no_grad()
def control_readings(cfg: dict, state: dict, traffic, picked: list, device, buckets) -> dict:
    """The control: the reference in float8 put in the program's place. At
    each position of the same prompts and served tokens, the gap of the
    token the float8 reference puts first, read from the float32 one."""
    ref.ieee()
    shape = ref.shape_of(cfg)
    w32, w8 = ref.Weights(state, device), ref.Weights(state, device, fp8=True)
    seqs, wanted, served, seen = _inputs(w32, shape, traffic, picked, cfg, buckets)
    seqs8 = _inputs(w8, shape, traffic, picked, cfg, buckets)[0]
    gaps, margins = [], []
    logits = zip(picked, ref.decoder_logits(w32, shape, seqs, wanted), ref.decoder_logits(w8, shape, seqs8, wanted),
                 served, seen)
    for r, lg, lg8, toks, ids in logits:
        lg = penalized(lg, ids, toks, r.repetition_penalty)
        first = penalized(lg8, ids, toks, r.repetition_penalty).argmax(dim=-1)[:, None]
        gaps.append((lg.max(dim=-1).values - lg.gather(1, first)[:, 0]).cpu())
        margins.append(_margin(lg))
    return _summary(gaps, margins, picked)


def verdict(found: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number the cell compares (the keys of
    its ``limits``) within its limit. A limit not yet set fails."""
    checks = {}
    ok = bool(limits)
    for name in limits:
        limit = limits.get(name)
        value = found.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not value <= limit:
            ok = False
    return ok, checks
