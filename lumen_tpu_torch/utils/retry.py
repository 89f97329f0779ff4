"""Shared retry helper: exponential backoff + full jitter + retryable predicate.

Transient-failure policy for the whole stack (hub model downloads, client
stream setup, degraded-service recovery). One implementation so every call
site gets the same discipline — capped exponential backoff with *full*
jitter (delay drawn uniformly from ``[0, cap]``), the AWS-architecture-blog
shape that de-correlates retry storms from thousands of clients hitting the
same recovering backend at once. The reference has no retry layer at all:
one failed snapshot download aborts its server run.

Every retry is visible: attempts land on the process-global metrics
registry as ``retries`` (aggregate) and ``retries:{scope}`` counters, so an
operator can tell "the hub is quietly re-fetching flaky artifacts" from a
dashboard instead of log archaeology.

Server retry hints: when the failure itself says when to come back — a
QoS quota or queue shed carrying ``lumen-retry-after-ms`` trailing meta,
surfaced by callers as a ``retry_after_s`` attribute on the raised
exception — that hint becomes the backoff *floor*: the jittered delay is
taken as usual but never undershoots what the server asked for, so a
shed fleet converges on the server's drain estimate instead of
re-knocking at full-jitter random."""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Type

from .env import env_float
from .metrics import metrics

logger = logging.getLogger(__name__)

#: What callers may pass as the retryable spec: exception classes or a
#: predicate over the raised instance.
Retryable = "tuple[Type[BaseException], ...] | Type[BaseException] | Callable[[BaseException], bool]"


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule. ``attempts`` counts the first try too (1 = no
    retries); ``attempts=0`` means retry without bound (recovery loops cap
    themselves elsewhere)."""

    attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    jitter: bool = True

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        """Backoff before retry number ``attempt`` (0-based)."""
        cap = min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        if not self.jitter:
            return cap
        return (rng or random).uniform(0.0, cap)

    def delays(self, rng: random.Random | None = None) -> Iterator[float]:
        attempt = 0
        while True:
            yield self.delay(attempt, rng)
            attempt += 1


def policy_from_env(prefix: str, default: RetryPolicy) -> RetryPolicy:
    """Env-tunable policy: ``LUMEN_{PREFIX}_RETRIES`` (extra attempts past
    the first), ``LUMEN_{PREFIX}_BACKOFF_S``, ``LUMEN_{PREFIX}_BACKOFF_MAX_S``.
    Malformed values degrade to the default (same policy as every other
    env knob in the stack: a typo'd override must not crash serving)."""

    def _num(name: str, fallback: float) -> float:
        return env_float(name, fallback)

    retries = _num(f"LUMEN_{prefix}_RETRIES", default.attempts - 1)
    return RetryPolicy(
        attempts=max(1, int(retries) + 1),
        base_delay_s=max(0.0, _num(f"LUMEN_{prefix}_BACKOFF_S", default.base_delay_s)),
        max_delay_s=max(0.0, _num(f"LUMEN_{prefix}_BACKOFF_MAX_S", default.max_delay_s)),
        jitter=default.jitter,
    )


def retry_after_hint(exc: BaseException) -> float | None:
    """The server-provided retry-after hint riding ``exc`` (seconds), or
    None. The convention: any layer that learns when the server wants the
    caller back (the client parsing ``lumen-retry-after-ms`` response
    meta, the batcher stamping its drain estimate on a ``QueueFull``)
    sets ``retry_after_s`` on the exception it raises."""
    hint = getattr(exc, "retry_after_s", None)
    if hint is None:
        return None
    try:
        hint = float(hint)
    except (TypeError, ValueError):
        return None
    return hint if hint > 0 else None


def _is_retryable(exc: BaseException, spec) -> bool:
    if callable(spec) and not isinstance(spec, type):
        try:
            return bool(spec(exc))
        except Exception:  # noqa: BLE001 - a broken predicate must not mask the error
            return False
    return isinstance(exc, spec)


def retry_call(
    fn: Callable,
    *args,
    policy: RetryPolicy | None = None,
    retryable=Exception,
    scope: str = "",
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying on retryable failures.

    ``retryable`` is an exception class/tuple or a predicate; anything else
    propagates immediately (an auth failure or a missing manifest will not
    get better by waiting). ``sleep`` and ``rng`` are injectable so tests
    run deterministic and clock-free.
    """
    policy = policy or RetryPolicy()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - filtered by the predicate below
            last_try = policy.attempts > 0 and attempt >= policy.attempts - 1
            if last_try or not _is_retryable(e, retryable):
                raise
            delay = policy.delay(attempt, rng)
            hint = retry_after_hint(e)
            if hint is not None and delay < hint:
                # The server said when to come back: its hint floors the
                # backoff. A jittered overshoot (up to 25% past the hint)
                # de-correlates a fleet shed at the same instant with the
                # same hint — clamping everyone to exactly the hint would
                # resynchronize the stampede on the token-arrival time.
                delay = hint * (1.0 + 0.25 * (rng or random).random())
            metrics.count("retries")
            if scope:
                metrics.count(f"retries:{scope}")
            logger.warning(
                "%s failed (attempt %d/%s): %s; retrying in %.2fs",
                scope or getattr(fn, "__name__", "call"),
                attempt + 1,
                policy.attempts or "inf",
                e,
                delay,
            )
            if on_retry is not None:
                on_retry(attempt, e, delay)
            if delay > 0:
                sleep(delay)
            attempt += 1


def retrying(policy: RetryPolicy | None = None, retryable=Exception, scope: str = ""):
    """Decorator form of :func:`retry_call`."""

    def deco(fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            return retry_call(
                fn, *args, policy=policy, retryable=retryable, scope=scope, **kwargs
            )

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped

    return deco
