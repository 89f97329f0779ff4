"""A word-level tokenizer with the HF ``tokenizers`` interface.

Each whitespace word maps to a stable id in ``[1000, vocab - 1000)``;
decoding prints ids as words, so every served token is one stream chunk.
With no chat template the program renders a request as the plain
transcript ``<|user|>\\n{text}\\n<|assistant|>\\n`` and puts the image id in
front; :func:`prompt_ids` writes down those ids for the reference.
"""

from __future__ import annotations


class _Encoding:
    def __init__(self, ids):
        self.ids = ids


class WordTokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def word_id(self, word: str) -> int:
        h = 0
        for ch in word.encode():
            h = (h * 131 + ch) % 1_000_003
        return 1000 + h % (self.vocab_size - 2000)

    def encode(self, text: str, add_special_tokens: bool = False) -> _Encoding:
        return _Encoding([self.word_id(w) for w in text.split()])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"w{i}" for i in ids)


def prompt_ids(tok: WordTokenizer, text: str, image_token_id: int) -> list:
    """The ids of a one-photo caption request, as the program renders it."""
    return [image_token_id] + [tok.word_id(w) for w in f"<|user|>\n{text.strip()}\n<|assistant|>\n".split()]
