"""Shared env-knob parsing: numeric ``LUMEN_*`` reads with loud typos.

The port's own copy of ``lumen_tpu/utils/env.py`` (``env_int``,
``env_float`` and ``env_choice``, which the port reads); the port imports
nothing of the JAX package.

Every layer of the stack reads tuning knobs from the environment, and the
house policy is *degrade, don't crash*: a malformed value falls back to
the knob's default. The failure mode of that policy, hand-rolled per call
site, is **silence** — ``LUMEN_BATCH_QUEUE_DEPTH=64O`` (a letter O) used
to read as "unbounded queue" without a word, which is an operator trap:
the protective knob you set is simply not there. These helpers keep the
degrade-to-default contract but WARN, once per knob name, when the value
could not be parsed — so a typo shows up in the boot log instead of in an
incident review.

``None`` is a legal default (for knobs whose unset state means "derive it
elsewhere", e.g. ``LUMEN_BATCH_WINDOW_MS``). Clamping to ``minimum`` /
``maximum`` is applied to *parsed* values only — the default is returned
as given, since each call site already picked a safe one.

"""

from __future__ import annotations

import logging
import os
import threading

logger = logging.getLogger(__name__)

_warned: set[str] = set()
_warned_lock = threading.Lock()


def _warn_once(name: str, raw: str, default) -> None:
    with _warned_lock:
        if name in _warned:
            return
        _warned.add(name)
    logger.warning(
        "malformed env knob %s=%r; using default %r", name, raw, default
    )


def _reset_warnings() -> None:
    """Test hook: forget which knobs already warned."""
    with _warned_lock:
        _warned.clear()


def _clamp(value, minimum, maximum):
    if minimum is not None and value < minimum:
        value = minimum
    if maximum is not None and value > maximum:
        value = maximum
    return value


def env_int(
    name: str,
    default: int | None,
    minimum: int | None = None,
    maximum: int | None = None,
) -> int | None:
    """``int(os.environ[name])`` with the degrade-don't-crash contract:
    unset -> ``default`` (silently), malformed -> ``default`` with a
    one-shot warning naming the knob and the bad value."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return _clamp(int(raw), minimum, maximum)
    except ValueError:
        _warn_once(name, raw, default)
        return default


def env_float(
    name: str,
    default: float | None,
    minimum: float | None = None,
    maximum: float | None = None,
) -> float | None:
    """Float twin of :func:`env_int` (same unset/malformed semantics)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return _clamp(float(raw), minimum, maximum)
    except ValueError:
        _warn_once(name, raw, default)
        return default


def env_choice(
    name: str,
    default: str | None,
    choices: tuple[str, ...],
) -> str | None:
    """Enum twin of :func:`env_int`: the value must be one of ``choices``
    (matched case-insensitively, returned in the canonical spelling);
    unset -> ``default`` silently, anything else -> ``default`` with a
    one-shot warning naming the knob, the bad value and the legal set."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    lowered = raw.strip().lower()
    for choice in choices:
        if lowered == choice.lower():
            return choice
    with _warned_lock:
        first = name not in _warned
        _warned.add(name)
    if first:
        logger.warning(
            "malformed env knob %s=%r (expected one of %s); using default %r",
            name, raw, "|".join(choices), default,
        )
    return default
