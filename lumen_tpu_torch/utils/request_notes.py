"""Per-request annotation bridge between the serving and cache layers.

The gRPC layer surfaces a "served from cache" flag in response trailing
metadata, but the cache lookup happens layers below (inside a manager
method, before the decode pool). Same pattern as
:mod:`~lumen_tpu.utils.deadline`: a :mod:`contextvars` variable carries the
cross-layer fact so no signature in between grows a flag. The serving base
class opens a note scope around each task handler; the result cache marks
``hit`` / ``coalesced`` when it answers without a fresh computation; the
quarantine registry marks ``quarantined`` when it rejects a known-poison
payload up front; the service folds the marks into the response ``meta``
(including error responses — a quarantine rejection is an error that
carries its ``quarantined`` note).

Dependency-free on purpose — imported by ``serving.base_service``, which
must not drag in the jax-importing ``runtime`` package.
"""

from __future__ import annotations

import contextvars

_notes: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "lumen_request_notes", default=None
)


def begin_notes() -> contextvars.Token:
    """Open a fresh note scope for the current (request) context."""
    return _notes.set({})


def end_notes(token: contextvars.Token) -> dict:
    """Close the scope and return the collected marks (``hit`` /
    ``coalesced`` / ``quarantined`` keys, present when they happened)."""
    marks = _notes.get() or {}
    _notes.reset(token)
    return marks


def current() -> dict:
    """Copy of the current scope's marks (empty outside a scope)."""
    return dict(_notes.get() or {})


def mark(kind: str) -> None:
    """Record a fact about the current request; no-op outside a scope."""
    marks = _notes.get()
    if marks is not None:
        marks[kind] = True
