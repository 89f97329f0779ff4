"""The one traffic generator: caption requests from a mix's parameters.

A mix file (``traffic/<name>.json``) holds:

- ``loop``: ``closed``, ``clients`` callers, each sending its next request
  when the last one ends (the only loop so far);
- ``prompt`` (a fixed user text) or ``prompt_words`` ``[lo, hi]`` (that many
  words, uniform);
- ``max_tokens`` ``[lo, hi]``: the output budget, uniform;
- ``repetition_penalty`` (1.0 when absent): the CTRL-style penalty each
  request asks for on the tokens of its prompt and of its output so far;
- ``mix``: how many sizes a cycle holds.

Every seed gets the same sizes: a cycle of ``mix`` requests takes the
``mix`` stratified quantiles of each uniform range (words and budgets
paired by a fixed shuffle), and the seed only orders them, anew each
cycle. The seed sets the words and the photo: every request carries a
unique uint8 photo, so no cache can answer it. Request ``i`` depends on
``(seed, i)`` alone, whatever thread builds it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: fixed pairing of the word and budget quantiles inside a cycle
_PAIRING_SEED = 20240917


@dataclass(frozen=True)
class Request:
    index: int
    text: str
    max_tokens: int
    repetition_penalty: float


def _quantiles(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.loop = mix["loop"]
        if self.loop != "closed":
            raise ValueError(f"loop must be closed, got {self.loop!r}")
        self.clients = int(mix["clients"])
        self.n = int(mix.get("mix", 16))
        self.repetition_penalty = float(mix.get("repetition_penalty", 1.0))
        pair = np.random.default_rng(_PAIRING_SEED).permutation(self.n)
        lo, hi = mix["max_tokens"]
        self._budgets = np.rint(_quantiles(lo, hi + 1, self.n) - 0.5).astype(int)
        if "prompt_words" in mix:
            wlo, whi = mix["prompt_words"]
            self._words = np.rint(_quantiles(wlo, whi + 1, self.n) - 0.5).astype(int)[pair]
        else:
            self._words = None
        self._orders: dict = {}

    def _order(self, cycle: int, salt: int) -> np.ndarray:
        key = (cycle, salt)
        if key not in self._orders:
            self._orders[key] = np.random.default_rng([self.seed, cycle, salt]).permutation(self.n)
        return self._orders[key]

    def request(self, i: int) -> Request:
        k = int(self._order(i // self.n, 7)[i % self.n])
        if self._words is None:
            text = self.mix["prompt"]
        else:
            rng = np.random.default_rng([self.seed, i, 3])
            text = " ".join(f"x{v}" for v in rng.integers(0, 1 << 30, int(self._words[k])))
        return Request(index=i, text=text, max_tokens=int(self._budgets[k]),
                       repetition_penalty=self.repetition_penalty)

    def photo_seed(self, i: int) -> int:
        """The seed of request ``i``'s photo."""
        return int(np.random.default_rng([self.seed, i, 5]).integers(0, 1 << 62))

    def sizes(self) -> dict:
        """What a cycle holds, for reports and tests."""
        out = {"max_tokens": sorted(int(b) for b in self._budgets)}
        if self._words is not None:
            out["prompt_words"] = sorted(int(w) for w in self._words)
        return out

