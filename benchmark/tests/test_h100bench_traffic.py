"""The traffic generator and the window's request statistics (CPU)."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import window  # noqa: E402
from harness.serve import Record  # noqa: E402
from harness.traffic import Traffic  # noqa: E402

CLOSED = {"loop": "closed", "clients": 16, "prompt_words": [8, 64], "max_tokens": [128, 384], "mix": 16}
FIXED = {"loop": "closed", "clients": 16, "prompt": "Describe this photo in one sentence.", "max_tokens": [32, 32],
         "mix": 16}
BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("mix", [CLOSED, FIXED], ids=["closed", "fixed"])
def test_same_seed_same_requests(mix):
    a, b = Traffic(mix, BIG_SEED), Traffic(mix, BIG_SEED)
    # out of order on one side: request i depends on (seed, i) alone
    want = [a.request(i) for i in range(40)]
    got = [b.request(i) for i in reversed(range(40))][::-1]
    assert want == got
    assert [a.photo_seed(i) for i in range(40)] == [b.photo_seed(i) for i in range(40)]


@pytest.mark.parametrize("mix", [CLOSED], ids=["closed"])
def test_seeds_share_sizes_in_another_order(mix):
    a, b = Traffic(mix, 1), Traffic(mix, BIG_SEED)
    n = mix["mix"]
    for cycle in range(3):
        ra = [a.request(cycle * n + k) for k in range(n)]
        rb = [b.request(cycle * n + k) for k in range(n)]
        assert sorted((len(r.text.split()), r.max_tokens) for r in ra) == sorted(
            (len(r.text.split()), r.max_tokens) for r in rb)
        assert [r.text for r in ra] != [r.text for r in rb]


def test_sizes_cover_the_ranges():
    t = Traffic(CLOSED, 7)
    sizes = t.sizes()
    assert min(sizes["max_tokens"]) >= 128 and max(sizes["max_tokens"]) <= 384
    assert min(sizes["prompt_words"]) >= 8 and max(sizes["prompt_words"]) <= 64
    assert len(set(sizes["max_tokens"])) == 16
    assert Traffic(FIXED, 7).sizes()["max_tokens"] == [32] * 16
    with pytest.raises(ValueError):
        Traffic(dict(CLOSED, loop="open"), 7)


def _ctx(records, t0=0.0, t1=10.0, t_end=70.0):
    return SimpleNamespace(records=records, t0=t0, t1=t1, t_end=t_end, window_s=t1 - t0)


def test_window_rate_counts_unfinished_requests():
    from harness.cells import Bench

    bench = Bench()
    done = Record(index=0, text="", max_tokens=16, due=0.0, chunks=[(1.0, 8), (2.0, 8)], finish="length")
    running = Record(index=1, text="", max_tokens=300, due=0.0, chunks=[(3.0, 8), (9.0, 8), (12.0, 8)])
    ctx = _ctx([done, running])
    assert window.tokens(ctx) == 32
    assert bench.reader("tok_s")(ctx) == pytest.approx(3.2)
