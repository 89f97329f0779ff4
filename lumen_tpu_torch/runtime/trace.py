"""Request-scoped tracing layer — runtime-facing entry point.

The implementation lives in :mod:`lumen_tpu.utils.trace` for the same
reason ``utils/deadline.py`` and ``utils/request_notes.py`` live in
``utils``: the jax-free serving base class (and the logger, and the
example client) must be able to import the tracing contextvar without
dragging in the jax-importing runtime package ``__init__``. This module
re-exports the small surface runtime components use — the hot-path
contextvar read for span stitching (batcher, decode pool, result cache,
quarantine) and the per-batch trace lifecycle (ingest pipeline) — so
runtime code has one local name for the layer; everything else (the
recorder, Perfetto export, knobs) is :mod:`lumen_tpu.utils.trace`'s.

See :mod:`lumen_tpu.utils.trace` for the full design notes: contextvar
propagation, cross-thread :class:`~lumen_tpu.utils.trace.SpanHandle`
stitching, tail-sampled ring retention, and the Perfetto /
``GET /traces`` export.
"""

from ..utils.trace import (  # noqa: F401 - re-exported runtime surface
    begin_request,
    current_trace,
    enabled,
    finish_request,
    get_recorder,
    reset_recorder,
    span,
)

__all__ = [
    "begin_request",
    "current_trace",
    "enabled",
    "finish_request",
    "get_recorder",
    "reset_recorder",
    "span",
]
