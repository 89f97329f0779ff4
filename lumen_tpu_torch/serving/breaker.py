"""Per-service circuit breaker: fast-fail a repeatedly-failing backend.

Without this, a broken model path (wedged device stream, corrupt weights
after a partial hot-swap, a kernel that started faulting) keeps every
request paying the FULL failure cost — admission queue, decode pool,
batch slot, device dispatch, error — forever. Production posture is the
standard three-state breaker:

- **closed** (normal): requests flow; consecutive non-poison failures
  within ``LUMEN_BREAKER_WINDOW_S`` are counted. Poison-input isolations
  (:class:`~lumen_tpu.utils.deadline.PoisonInput`) do NOT count — one bad
  payload retried in a loop must not take a healthy service down. Neither
  do overload verdicts (shed / deadline): those describe the caller's
  budget, not the backend's health.
- **open** (tripped, after ``LUMEN_BREAKER_FAILURES`` consecutive
  failures): every request sheds instantly — same UNAVAILABLE-with-hint
  shape as a :class:`~lumen_tpu.serving.resilience.DegradedService`
  answer, plus a retry-after hint and a ``breaker_open`` trailing-metadata
  note so clients can tell shed-by-breaker from shed-by-queue. The
  ``on_open`` hook can hand the service to the
  :class:`~lumen_tpu.serving.resilience.RecoveryManager` for a full
  reload (``LUMEN_BREAKER_RELOAD=1`` wires this in the server).
- **half-open** (after ``LUMEN_BREAKER_RESET_S``): exactly one probe
  request is admitted; success closes the breaker, failure re-opens it
  for another full reset window.

The breaker observes at the gRPC dispatch layer
(:meth:`~lumen_tpu.serving.base_service.BaseService._dispatch`), so
"batch failure" is seen once per affected request — with bisection
upstream, innocent co-batched requests succeed and correctly count as
successes. State changes land on :mod:`~lumen_tpu.utils.metrics`
(``breaker_opens`` / ``breaker_closes`` / ``breaker_sheds`` counters and a
``breaker:{service}`` gauge set) and in ``Health`` /
``StreamCapabilities`` via the router.

``LUMEN_BREAKER_FAILURES=0`` disables the breaker (no gate, no counting).
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Callable

from ..utils import telemetry
from ..utils.env import env_float, env_int
from ..utils.metrics import metrics

logger = logging.getLogger(__name__)

BREAKER_FAILURES_ENV = "LUMEN_BREAKER_FAILURES"
BREAKER_WINDOW_ENV = "LUMEN_BREAKER_WINDOW_S"
BREAKER_RESET_ENV = "LUMEN_BREAKER_RESET_S"

DEFAULT_FAILURES = 6
DEFAULT_WINDOW_S = 30.0
DEFAULT_RESET_S = 10.0

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


def breaker_failures() -> int:
    """``LUMEN_BREAKER_FAILURES``: consecutive non-poison failures that
    trip the breaker (0 disables; unset/malformed -> 6)."""
    return env_int(BREAKER_FAILURES_ENV, DEFAULT_FAILURES, minimum=0)


def breaker_window_s() -> float:
    """``LUMEN_BREAKER_WINDOW_S``: the failure streak must fit in this
    window to trip (a streak older than the window restarts the count)."""
    return env_float(BREAKER_WINDOW_ENV, DEFAULT_WINDOW_S, minimum=0.1)


def breaker_reset_s() -> float:
    """``LUMEN_BREAKER_RESET_S``: how long an open breaker sheds before
    admitting one half-open probe."""
    return env_float(BREAKER_RESET_ENV, DEFAULT_RESET_S, minimum=0.05)


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker for one service."""

    def __init__(
        self,
        name: str,
        failures: int | None = None,
        window_s: float | None = None,
        reset_s: float | None = None,
        on_open: Callable[[], None] | None = None,
    ):
        self.name = name
        self.failures = breaker_failures() if failures is None else max(0, failures)
        self.window_s = breaker_window_s() if window_s is None else max(0.1, window_s)
        self.reset_s = breaker_reset_s() if reset_s is None else max(0.05, reset_s)
        self.on_open = on_open
        self._lock = threading.Lock()
        self._state = CLOSED
        self._streak = 0  # consecutive non-poison failures
        self._streak_started = 0.0
        self._opened_at = 0.0
        self._probe_out = False  # half-open: one probe in flight
        self._probe_started = 0.0
        self.stats = {"opens": 0, "closes": 0, "sheds": 0, "poison": 0, "failures": 0}
        ref = weakref.ref(self)

        def _gauges() -> dict:
            b = ref()
            if b is None:
                return {}
            with b._lock:
                return {
                    **b.stats,
                    "state": _STATE_CODES[b._state],
                    "streak": b._streak,
                }

        self._gauge_fn = _gauges
        metrics.register_gauges(f"breaker:{name}", _gauges)

    @property
    def enabled(self) -> bool:
        return self.failures > 0

    def state(self) -> str:
        with self._lock:
            return self._state

    # -- admission ---------------------------------------------------------

    def allow(self) -> tuple[bool, float]:
        """Gate one request. Returns ``(admitted, retry_after_s)``;
        ``retry_after_s`` is only meaningful when shed. Transitions
        open -> half-open when the reset window has elapsed (the caller
        that triggers the transition becomes the probe)."""
        if not self.enabled:
            return True, 0.0
        with self._lock:
            if self._state == CLOSED:
                return True, 0.0
            now = time.monotonic()
            if self._state == OPEN:
                elapsed = now - self._opened_at
                if elapsed >= self.reset_s:
                    self._state = HALF_OPEN
                    self._probe_out = True
                    self._probe_started = now
                    logger.info("breaker %r half-open: admitting one probe", self.name)
                    return True, 0.0
                self.stats["sheds"] += 1
                return False, max(0.0, self.reset_s - elapsed)
            # half-open: only one probe at a time; everyone else waits a
            # reset window (the probe's verdict arrives well before that).
            # A probe that never reported back (abandoned stream, handler
            # path that records no outcome) must not shed traffic forever:
            # after a reset window it is presumed lost and replaced.
            if not self._probe_out or now - self._probe_started > self.reset_s:
                self._probe_out = True
                self._probe_started = now
                return True, 0.0
            self.stats["sheds"] += 1
            return False, self.reset_s

    # -- outcomes ----------------------------------------------------------

    def record_success(self) -> None:
        closed = False
        with self._lock:
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self.stats["closes"] += 1
                closed = True
            self._streak = 0
            self._probe_out = False
        if closed:
            metrics.count("breaker_closes")
            telemetry.record_event(
                "breaker_close", self.name, "half-open probe succeeded"
            )
            logger.info("breaker %r closed: probe succeeded", self.name)

    def record_failure(self) -> None:
        """One non-poison backend failure (INTERNAL-class handler error,
        watchdog timeout, injected batch fault). Overload and client
        errors must NOT be recorded here."""
        if not self.enabled:
            return
        tripped = False
        with self._lock:
            self.stats["failures"] += 1
            now = time.monotonic()
            if self._state == HALF_OPEN:
                tripped = self._trip_locked(now, probe_failed=True)
            elif self._state == CLOSED:
                if self._streak == 0 or now - self._streak_started > self.window_s:
                    self._streak = 0
                    self._streak_started = now
                self._streak += 1
                if self._streak >= self.failures:
                    tripped = self._trip_locked(now)
            # open: in-flight stragglers admitted pre-trip; nothing to do.
        if tripped:
            # Flight recorder + incident bundle OUTSIDE the state lock:
            # the capture walks the metrics/trace surfaces, which must
            # not serialize behind (or deadlock with) breaker admission.
            telemetry.record_event(
                "breaker_open", self.name,
                f"circuit opened after repeated backend failures; "
                f"shedding for {self.reset_s:.1f}s",
            )
        if tripped and self.on_open is not None:
            try:
                self.on_open()
            except Exception:  # noqa: BLE001 - a broken hook must not break shedding
                logger.exception("breaker %r on_open hook failed", self.name)

    def record_poison(self) -> None:
        """A poison-input isolation: the payload, not the service, is
        broken — counted for telemetry, never toward tripping. Releases a
        half-open probe slot (a poison verdict says nothing about backend
        health, so the next request should get to probe)."""
        with self._lock:
            self.stats["poison"] += 1
            self._probe_out = False

    def record_neutral(self) -> None:
        """The request ended with no verdict on backend health — shed
        (:class:`~lumen_tpu.utils.deadline.QueueFull`), deadline expiry, a
        client-error ServiceError. Not counted anywhere, but it must
        release the half-open probe slot: a probe that was itself shed by
        admission control would otherwise pin the breaker half-open and
        shedding until the probe-expiry backstop."""
        with self._lock:
            self._probe_out = False

    def _trip_locked(self, now: float, probe_failed: bool = False) -> bool:
        self._state = OPEN
        self._opened_at = now
        self._streak = 0
        self._probe_out = False
        self.stats["opens"] += 1
        metrics.count("breaker_opens")
        logger.error(
            "breaker %r OPEN (%s); shedding for %.1fs",
            self.name,
            "half-open probe failed" if probe_failed else f"{self.failures} consecutive failures",
            self.reset_s,
        )
        return True

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        metrics.unregister_gauges(f"breaker:{self.name}", self._gauge_fn)
