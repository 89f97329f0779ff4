"""Chat prompt construction for the VLM (the port's copy of
``lumen_tpu/models/vlm/chat.py``).

Prompts render as the plain ``<|role|>`` transcript, the JAX package's
fallback format; tokenization goes through an injected tokenizer object
with the HF ``tokenizers.Tokenizer`` interface (``encode(text,
add_special_tokens=...).ids`` and ``decode(ids, skip_special_tokens=...)``).
Not ported yet: rendering a checkpoint's Jinja2 ``chat_template`` and
``VlmTokenizer.from_model_dir`` (both wait for checkpoint loading).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ChatMessage:
    role: str
    content: str


def render_chat(messages: Sequence[ChatMessage], add_generation_prompt: bool = True) -> str:
    """The JAX package's fallback transcript (``render_chat`` with no
    template)."""
    if not messages:
        raise ValueError("chat messages cannot be empty")
    parts = [f"<|{m.role}|>\n{m.content.strip()}\n" for m in messages]
    if add_generation_prompt:
        parts.append("<|assistant|>\n")
    return "".join(parts)


class VlmTokenizer:
    """Thin wrapper over an HF-``tokenizers``-style tokenizer object."""

    def __init__(self, tokenizer):
        self._tok = tokenizer

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def render(self, messages: Sequence[ChatMessage], add_generation_prompt: bool = True) -> str:
        return render_chat(messages, add_generation_prompt)
