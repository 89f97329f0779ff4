"""Decode-owner propagation for disaggregated prefill/decode serving.

When a federation front tier routes a generation request to a
prefill-lane host, it pins the request's DECODE to the decode-lane peer
the hash ring chose and says so in the ``lumen-decode-owner`` gRPC
request-metadata key. That name has to travel from the gRPC dispatch
layer down to the VLM manager's request construction without growing a
parameter on every signature in between — the same contextvar pattern
the request deadline and QoS identity use (:mod:`.deadline`,
:mod:`.qos`).

Off by default: :func:`enabled` stays False until the server boots with
a federation attached (:func:`enable`), so the single-host dispatch path
never even scans request metadata for the key — the unconfigured path
stays byte-identical.
"""

from __future__ import annotations

import contextvars

#: gRPC request-metadata key naming the decode-lane peer that owns this
#: request's decode phase (``host:port``, the peer's federation name).
#: Attached by the front tier only when it forwards to a DIFFERENT peer
#: than the owner; absent means "decode where you prefill".
DECODE_OWNER_META = "lumen-decode-owner"

_owner: contextvars.ContextVar["str | None"] = contextvars.ContextVar(
    "lumen_decode_owner", default=None
)

_enabled = False


def enable() -> None:
    """Turn on metadata scanning (server boot, federation attached)."""
    global _enabled
    _enabled = True


def enabled() -> bool:
    return _enabled


def activate(owner: "str | None") -> contextvars.Token:
    """Bind the request's decode owner for the current dispatch scope."""
    return _owner.set(owner or None)


def deactivate(token: contextvars.Token) -> None:
    _owner.reset(token)


def current() -> "str | None":
    """The decode-lane owner pinned to the current request, or None."""
    return _owner.get()
