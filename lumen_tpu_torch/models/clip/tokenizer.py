"""Text tokenization for CLIP-family models (the port's copy of
``lumen_tpu/models/clip/tokenizer.py``).

Wraps an HF ``tokenizers`` fast tokenizer (``tokenizer.json`` in the model
dir — same artifact the reference loads, ``onnxrt_backend.py:307-376``) and
produces fixed-length right-padded id batches for the text tower.
"""

from __future__ import annotations

import os

import numpy as np


class ClipTokenizer:
    def __init__(self, tokenizer, context_length: int, pad_id: int = 0):
        self._tok = tokenizer
        self.context_length = context_length
        self.pad_id = pad_id

    @classmethod
    def from_model_dir(cls, model_dir: str, context_length: int) -> "ClipTokenizer":
        from tokenizers import Tokenizer

        path = os.path.join(model_dir, "tokenizer.json")
        vocab_txt = os.path.join(model_dir, "vocab.txt")
        if os.path.exists(path):
            tok = Tokenizer.from_file(path)
            pad_id = 0
            if tok.padding is not None and "pad_id" in tok.padding:
                pad_id = tok.padding["pad_id"]
        elif os.path.exists(vocab_txt):
            # BERT wordpiece repos (CN-CLIP) ship vocab.txt instead of a
            # fast-tokenizer JSON; same fallback chain as the reference
            # (``onnxrt_backend.py:307-376`` tries AutoTokenizer last).
            tok = cls._bert_from_vocab(model_dir, vocab_txt)
            # BERT pads with [PAD]'s actual id (validated present by
            # _bert_from_vocab), not an assumed 0.
            pad_id = tok.get_vocab()["[PAD]"]
        else:
            raise FileNotFoundError(f"no tokenizer.json or vocab.txt in {model_dir}")
        tok.no_padding()  # we pad ourselves to the static context length
        tok.enable_truncation(max_length=context_length)
        return cls(tok, context_length, pad_id)

    @staticmethod
    def _bert_from_vocab(model_dir: str, vocab_txt: str):
        """Assemble a BERT wordpiece tokenizer from vocab.txt via the
        public ``tokenizers`` components (the legacy BertWordPieceTokenizer
        wrapper only exposes the assembled ``Tokenizer`` through a private
        attribute). Casing honors the repo's ``tokenizer_config.json``
        ``do_lower_case`` (default True, the BERT/CN-CLIP norm)."""
        import json

        from tokenizers import Tokenizer, decoders, normalizers, pre_tokenizers
        from tokenizers.models import WordPiece
        from tokenizers.processors import TemplateProcessing

        lower = True
        tc_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(tc_path):
            try:
                with open(tc_path, "r", encoding="utf-8") as f:
                    lower = bool(json.load(f).get("do_lower_case", True))
            except (OSError, ValueError):
                pass
        tok = Tokenizer(WordPiece.from_file(vocab_txt, unk_token="[UNK]"))
        tok.normalizer = normalizers.BertNormalizer(
            lowercase=lower, strip_accents=lower
        )
        tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
        tok.decoder = decoders.WordPiece(prefix="##")
        vocab = tok.get_vocab()
        missing = [t for t in ("[CLS]", "[SEP]", "[UNK]", "[PAD]") if t not in vocab]
        if missing:
            raise ValueError(
                f"vocab.txt at {vocab_txt} lacks required special tokens "
                f"{missing}; refusing to guess bert-base ids for a "
                "nonstandard vocab"
            )
        cls_id, sep_id = vocab["[CLS]"], vocab["[SEP]"]
        tok.post_processor = TemplateProcessing(
            single="[CLS] $A [SEP]",
            pair="[CLS] $A [SEP] $B [SEP]",
            special_tokens=[("[CLS]", cls_id), ("[SEP]", sep_id)],
        )
        return tok

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        """-> [B, context_length] int32, right-padded."""
        out = np.full((len(texts), self.context_length), self.pad_id, np.int32)
        for i, enc in enumerate(self._tok.encode_batch(list(texts))):
            ids = enc.ids[: self.context_length]
            out[i, : len(ids)] = ids
        return out
