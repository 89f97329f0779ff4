"""Request-deadline propagation + admission-control error types.

The gRPC layer knows each request's deadline (``context.time_remaining()``)
but the device-batching layer — where the expensive work happens — did not:
a request whose client had already hung up would still burn a TPU batch
slot. This module is the thin, dependency-free bridge between the two:

- the serving layer stashes the absolute (monotonic-clock) deadline in a
  :mod:`contextvars` variable before invoking a task handler,
- :class:`~lumen_tpu.runtime.batcher.MicroBatcher` reads it at ``submit``
  time and drops expired entries *before* the device call.

It also owns the two overload exceptions (:class:`QueueFull`,
:class:`DeadlineExpired`) shared across layers. They live here — not in the
batcher — because ``runtime.batcher`` imports jax and the serving base
class must stay importable without it (the echo service serves jax-free).
"""

from __future__ import annotations

import contextvars
import time


class QueueFull(RuntimeError):
    """Admission control shed the request: the batcher queue is at its
    configured depth limit. Maps to a RESOURCE_EXHAUSTED-style wire error
    (retry with backoff); deliberately NOT a subclass of queue.Full so a
    stdlib except clause can't swallow it silently."""


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before (or while) it waited for a
    device slot; the batch executed without it."""


class PreemptionShed(QueueFull):
    """A live VLM decode row was evicted by KV-pool exhaustion and could
    not be spilled/resumed (spill tier disabled, ledger full, or the
    spill path itself failed on a sampled mid-stream row, where a
    restart would splice a fresh draw onto already-delivered tokens).
    Subclasses :class:`QueueFull` so the whole overload machinery applies
    unchanged: the serving layer maps it to RESOURCE_EXHAUSTED and
    surfaces ``retry_after_s`` — the engine's drain estimate — as the
    ``lumen-retry-after-ms`` hint, which floors client backoff
    (``utils/retry.py``)."""


class PoisonInput(RuntimeError):
    """The input was isolated as the cause of a batch failure (batch
    bisection), or its fingerprint is quarantined from a previous
    isolation. Maps to an INVALID_ARGUMENT-style wire error: the payload —
    not the server — is broken, and retrying it is pointless. Lives here
    (not in the batcher or the quarantine registry) for the same reason as
    :class:`QueueFull`: the jax-free serving base class must be able to
    catch it."""


class WatchdogTimeout(RuntimeError):
    """A dispatched batch exceeded the batch watchdog budget
    (``LUMEN_BATCH_WATCHDOG_S``): the device call (or its fetch) is
    presumed wedged. Pending futures are failed with this, and the batcher
    refuses new work — an operator (or the circuit breaker's recovery
    handoff) must reload the service."""


_deadline: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "lumen_request_deadline", default=None
)


def set_deadline(deadline: float | None) -> contextvars.Token:
    """Install an absolute ``time.monotonic()`` deadline for the current
    context (``None`` clears). Returns the token for :func:`reset`."""
    return _deadline.set(deadline)


def reset(token: contextvars.Token) -> None:
    _deadline.reset(token)


def get_deadline() -> float | None:
    return _deadline.get()


def remaining() -> float | None:
    """Seconds until the current context's deadline; ``None`` when no
    deadline is set. May be negative (already expired)."""
    d = _deadline.get()
    return None if d is None else d - time.monotonic()


def expired(deadline: float | None = None) -> bool:
    d = _deadline.get() if deadline is None else deadline
    return d is not None and time.monotonic() >= d
