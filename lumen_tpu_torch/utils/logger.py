"""Shared logging setup.

One configuration point for every entry script (the reference duplicates a
colorlog setup in each package's ``server.py``; here it lives once). Colour
is ANSI-only (no colorlog dependency) and disabled on non-TTY outputs.

Log <-> trace correlation: a :class:`TraceContextFilter` stamps every
record emitted while a request trace is live (``LUMEN_TRACE_SAMPLE`` > 0)
with the trace id, and the formatter renders it as a ``[trace=...]``
suffix on the logger name — so a server log line greps straight to its
request in ``GET /traces`` output (and vice versa). Outside a trace the
attribute is an empty string and log lines are byte-identical to before.
"""

from __future__ import annotations

import logging
import sys

from .trace import current_trace

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[1;31m",
}
_RESET = "\x1b[0m"


class TraceContextFilter(logging.Filter):
    """Injects the active request-trace id into every record.

    Sets two attributes: ``trace_id`` (the bare id, or ``""``) for
    structured consumers, and ``trace_tag`` (`` [trace=<id>]`` or ``""``)
    for drop-in use inside a format string. Never rejects a record."""

    def filter(self, record: logging.LogRecord) -> bool:
        tr = current_trace()
        if tr is not None:
            record.trace_id = tr.trace_id
            record.trace_tag = f" [trace={tr.trace_id}]"
        else:
            record.trace_id = ""
            record.trace_tag = ""
        return True


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        # Records from foreign handlers/tests may not have passed through
        # TraceContextFilter; the formatter must not KeyError on them.
        if not hasattr(record, "trace_tag"):
            record.trace_tag = ""
        base = super().format(record)
        color = _COLORS.get(record.levelno)
        if color and sys.stderr.isatty():
            return f"{color}{base}{_RESET}"
        return base


def setup_logging(level: str = "INFO") -> None:
    root = logging.getLogger()
    root.setLevel(level.upper())
    # Idempotent: replace our handler if already installed.
    for h in list(root.handlers):
        if getattr(h, "_lumen_tpu", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    handler._lumen_tpu = True  # type: ignore[attr-defined]
    handler.addFilter(TraceContextFilter())
    handler.setFormatter(
        _ColorFormatter(
            "%(asctime)s %(levelname)-8s %(name)s%(trace_tag)s: %(message)s", "%H:%M:%S"
        )
    )
    root.addHandler(handler)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
