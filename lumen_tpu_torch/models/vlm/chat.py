"""Chat prompt construction + tokenizer loading for the VLM.

Mirrors the reference's prompt utilities (``packages/lumen-vlm/src/
lumen_vlm/backends/base.py:344-430``): render the checkpoint's Jinja2
``chat_template`` from ``tokenizer_config.json`` when present, fall back to
a plain ``<|role|>`` transcript otherwise; tokenize with the HF
``tokenizers`` runtime from ``tokenizer.json``.

The port's copy of ``lumen_tpu/models/vlm/chat.py``. The tokenizer object
may also be handed in (anything with the HF ``tokenizers.Tokenizer``
``encode``/``decode`` interface); without a template it renders the
plain transcript.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Sequence

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ChatMessage:
    role: str
    content: str

    def to_mapping(self) -> dict[str, str]:
        return {"role": self.role, "content": self.content}


def render_chat(
    messages: Sequence[ChatMessage],
    chat_template: str | None = None,
    add_generation_prompt: bool = True,
) -> str:
    """Template render with graceful fallback (reference semantics,
    ``base.py:344-378``)."""
    if not messages:
        raise ValueError("chat messages cannot be empty")
    if chat_template:
        try:
            import jinja2

            env = jinja2.Environment(
                trim_blocks=True, lstrip_blocks=True, undefined=jinja2.StrictUndefined
            )
            rendered = env.from_string(chat_template).render(
                messages=[m.to_mapping() for m in messages],
                add_generation_prompt=add_generation_prompt,
            )
            return rendered.strip()
        except ImportError:
            logger.warning("jinja2 unavailable; using fallback chat format")
        except Exception as e:  # noqa: BLE001 - bad template -> fallback
            logger.warning("chat template rendering failed (%s); using fallback", e)
    parts = [f"<|{m.role}|>\n{m.content.strip()}\n" for m in messages]
    if add_generation_prompt:
        parts.append("<|assistant|>\n")
    return "".join(parts)


class VlmTokenizer:
    """Thin wrapper over an HF ``tokenizers.Tokenizer`` plus the chat
    template pulled from ``tokenizer_config.json``."""

    def __init__(self, tokenizer, chat_template: str | None = None):
        self._tok = tokenizer
        self.chat_template = chat_template

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "VlmTokenizer":
        from tokenizers import Tokenizer

        path = os.path.join(model_dir, "tokenizer.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"tokenizer.json not found in {model_dir}")
        tok = Tokenizer.from_file(path)
        template = None
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, "r", encoding="utf-8") as f:
                raw = json.load(f)
            t = raw.get("chat_template")
            if isinstance(t, str) and t.strip():
                template = t
        return cls(tok, template)

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def render(self, messages: Sequence[ChatMessage], add_generation_prompt: bool = True) -> str:
        return render_chat(messages, self.chat_template, add_generation_prompt)
