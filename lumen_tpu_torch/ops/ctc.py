"""CTC greedy decoding for the OCR recognizer (the port of
``lumen_tpu/ops/ctc.py``).

The dense part (argmax over the vocab at every timestep + per-step
confidence) runs batched on the device; the collapse/lookup to strings is
host-side. Semantics match the reference decoder
(``lumen_ocr/backends/onnxrt_backend.py:596-632``): blank index 0, collapse
repeats, mean probability of emitted (non-blank, non-repeat) steps.
"""

from __future__ import annotations

import numpy as np
import torch


def ctc_greedy_device(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, V] logits (or probabilities) -> ([B, T] argmax ids, [B, T] probs).
    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does, so a
    tie breaks to the lower id."""
    probs = torch.softmax(logits.float(), dim=-1)
    return probs.argmax(dim=-1), probs.amax(dim=-1)


def _emitted_to_text(
    emitted: list[tuple[int, float]], vocab: list[str]
) -> tuple[str, float]:
    """Shared tail of both collapse paths: out-of-vocab filter, char join,
    mean confidence over emitted steps (1.0 if nothing emitted)."""
    kept = [(vocab[i], c) for i, c in emitted if i < len(vocab)]
    text = "".join(ch for ch, _ in kept)
    return text, (float(np.mean([c for _, c in kept])) if kept else 1.0)


def ctc_collapse(
    ids: np.ndarray,
    confs: np.ndarray,
    vocab: list[str],
    blank: int = 0,
) -> tuple[str, float]:
    """Host collapse of one sequence: drop repeats-then-blanks, join chars,
    mean confidence over emitted steps (1.0 if nothing emitted)."""
    prev = -1
    emitted: list[tuple[int, float]] = []
    for t, idx in enumerate(ids):
        idx = int(idx)
        if idx != blank and idx != prev:
            emitted.append((idx, float(confs[t])))
        prev = idx
    return _emitted_to_text(emitted, vocab)


def ctc_collapse_rows(
    ids: np.ndarray,
    confs: np.ndarray,
    vocab: list[str],
    blank: int = 0,
) -> list[tuple[str, float]]:
    """Collapse a [B, T] batch; native C core when available (one GIL-free
    call for the whole batch), else the per-row python collapse above."""
    from .. import native

    ids = np.asarray(ids)
    confs = np.asarray(confs)
    if native.available() and ids.ndim == 2:
        out_ids, out_confs, counts = native.ctc_collapse_batch(ids, confs, blank)
        results = []
        for b in range(ids.shape[0]):
            n = int(counts[b])
            emitted = [(int(i), float(c)) for i, c in zip(out_ids[b, :n], out_confs[b, :n])]
            results.append(_emitted_to_text(emitted, vocab))
        return results
    return [ctc_collapse(ids[b], confs[b], vocab, blank) for b in range(ids.shape[0])]


def load_ctc_vocab(path: str, use_space_char: bool = True) -> list[str]:
    """Character list: blank placeholder at index 0, then dictionary lines,
    then optional trailing space (reference: ``onnxrt_backend.py:104-114``)."""
    with open(path, "r", encoding="utf-8") as f:
        chars = [line.rstrip("\n") for line in f if line.rstrip("\n")]
    vocab = ["<blank>"] + chars
    if use_space_char:
        vocab.append(" ")
    return vocab
