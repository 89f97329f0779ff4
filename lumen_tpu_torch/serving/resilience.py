"""Graceful degradation: placeholder services + background recovery.

Before this layer, hub startup was all-or-nothing: one failed model
download (``ensure_models`` -> ``SystemExit``) or one ``from_config``
exception killed every healthy sibling service. Production posture is the
opposite — partial failure is a *state*, not a crash:

- a service that fails to load boots as a :class:`DegradedService`: its
  expected tasks answer ``ERROR_CODE_UNAVAILABLE`` with a recovery hint,
  ``Health``/``StreamCapabilities`` report the state, healthy siblings
  keep serving;
- a :class:`RecoveryManager` thread retries the failed load with capped
  exponential backoff (full jitter, shared :mod:`lumen_tpu.utils.retry`
  schedule) and hot-swaps the real service into the router on success.

Recovery knobs: ``LUMEN_RECOVERY_RETRIES`` (0 = unlimited, the default —
a hub should keep trying as long as it runs), ``LUMEN_RECOVERY_BACKOFF_S``
and ``LUMEN_RECOVERY_BACKOFF_MAX_S`` for the backoff shape.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING, Callable

from ..utils.env import env_int
from ..utils.metrics import metrics
from ..utils.retry import RetryPolicy, policy_from_env
from .base_service import BaseService, Unavailable
from .registry import TaskDefinition, TaskRegistry

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.config import ServiceConfig
    from .router import HubRouter

logger = logging.getLogger(__name__)


def expected_tasks_for(name: str, svc_cfg: "ServiceConfig") -> list[str]:
    """Best-effort task list for a service that failed to load, so its
    routes still exist and answer UNAVAILABLE instead of vanishing
    (a vanished route reads as a client bug — "unknown task" — when the
    truth is "known task, broken backend").

    Service classes advertise this via an ``expected_tasks(service_config)``
    classmethod; a service whose class cannot even be imported degrades to
    an empty list (the router then folds unknown tasks over to the
    degraded-service hint).
    """
    from .loader import ServiceLoadError, resolve

    try:
        cls = resolve(svc_cfg.import_info.registry_class)
    except ServiceLoadError as e:
        logger.warning("cannot resolve %r for degraded task list: %s", name, e)
        return []
    hook = getattr(cls, "expected_tasks", None)
    if hook is None:
        return []
    try:
        return list(hook(svc_cfg))
    except Exception as e:  # noqa: BLE001 - a broken hook must not block degraded boot
        logger.warning("expected_tasks hook of %r failed: %s", name, e)
        return []


class DegradedService(BaseService):
    """Stand-in for a service whose model download or construction failed.

    A real :class:`BaseService`: it routes, reports capabilities and
    health, and answers every expected task with a retryable
    ``ERROR_CODE_UNAVAILABLE`` + recovery hint. ``healthy()`` is False but
    ``status()`` is ``degraded`` — the hub's Health treats that as a
    reported condition, not a hub failure.
    """

    def __init__(self, name: str, error: str, tasks: list[str] | None = None):
        self.name = name
        self.error = error
        self.since = time.time()
        self.recovering = True
        registry = TaskRegistry(name)
        for task in tasks or []:
            registry.register(
                TaskDefinition(
                    name=task,
                    handler=self._unavailable,
                    description=f"degraded: {error}",
                )
            )
        super().__init__(registry)

    def _unavailable(self, payload: bytes, mime: str, meta: dict[str, str]):  # noqa: ARG002
        raise Unavailable(
            f"service {self.name!r} is degraded: {self.error}",
            detail=self._hint(),
        )

    def _hint(self) -> str:
        if self.recovering:
            return "recovery is retrying in the background; retry later"
        return "automatic recovery gave up; operator action required"

    def healthy(self) -> bool:
        return False

    def status(self) -> str:
        return "degraded" if self.recovering else "failed"

    def capability(self):
        return self.registry.build_capability(
            model_ids=[],
            runtime="none",
            extra={"status": self.status(), "error": self.error},
        )


def recovery_policy() -> RetryPolicy:
    """Backoff shape for load recovery. attempts=0 -> retry forever."""
    return policy_from_env(
        "RECOVERY", RetryPolicy(attempts=0, base_delay_s=1.0, max_delay_s=60.0)
    )


def recovery_max_attempts() -> int:
    """``LUMEN_RECOVERY_RETRIES``: cap on recovery attempts per service
    (0 / unset / malformed = unlimited)."""
    return env_int("LUMEN_RECOVERY_RETRIES", 0, minimum=0)


class RecoveryManager:
    """One background thread retrying every degraded service's load.

    ``rebuild(name)`` must do the *full* load for one service (artifact
    download + ``from_config``) and return the live service; on success the
    manager swaps it into the router (atomically rebuilding the route
    table) and bumps the ``recoveries`` counter.
    """

    def __init__(
        self,
        router: "HubRouter",
        rebuild: Callable[[str], BaseService],
        policy: RetryPolicy | None = None,
        max_attempts: int | None = None,
        poll_interval_s: float = 0.05,
    ):
        self.router = router
        self.rebuild = rebuild
        self.policy = policy or recovery_policy()
        self.max_attempts = recovery_max_attempts() if max_attempts is None else max_attempts
        self._poll = poll_interval_s
        # name -> [attempts, next_due (monotonic)]
        self._pending: dict[str, list[float]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._started = False
        self._idle = threading.Event()
        self._idle.set()

    # -- lifecycle --------------------------------------------------------

    def register(self, name: str) -> None:
        """Track a degraded service; first attempt after one backoff step.

        Safe to call at ANY point in the manager's life, not just before
        :meth:`start`: the circuit-breaker handoff registers a service for
        reload long after boot, when the original recovery thread (if any)
        has already drained its queue and exited — a dead thread is
        respawned here. Re-registering a service already pending resets
        its backoff (the breaker just proved it broken again)."""
        with self._lock:
            self._pending[name] = [0, time.monotonic() + self.policy.delay(0)]
            self._idle.clear()
            if self._started and not self._stop.is_set():
                self._spawn_locked()

    def _spawn_locked(self) -> None:
        """Caller holds ``self._lock``. (Re)start the worker thread when
        none is alive — the loop exits whenever pending drains, so late
        registrations need a fresh thread."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="svc-recovery", daemon=True
            )
            self._thread.start()

    def start(self) -> "RecoveryManager":
        with self._lock:
            self._started = True
            if self._pending:
                self._spawn_locked()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread  # _run may null the slot concurrently
        if thread:
            thread.join(timeout=10)

    def wait_idle(self, timeout: float) -> bool:
        """Block until no recoveries are pending (tests)."""
        return self._idle.wait(timeout)

    # -- loop -------------------------------------------------------------

    def _due(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [n for n, (_, due) in self._pending.items() if now >= due]

    def _run(self) -> None:
        while not self._stop.is_set():
            for name in self._due():
                if self._stop.is_set():
                    return
                self._attempt(name)
            with self._lock:
                if not self._pending:
                    # Retire under the lock, clearing the thread slot
                    # BEFORE returning: register() checks this slot under
                    # the same lock, so a breaker-reload registration can
                    # never race a thread that has decided to exit but
                    # still reports is_alive() — either it lands before
                    # this check (we keep looping) or after (the slot is
                    # None and _spawn_locked starts a fresh thread).
                    self._idle.set()
                    self._thread = None
                    return
            self._stop.wait(self._poll)

    def _attempt(self, name: str) -> None:
        with self._lock:
            state = self._pending.get(name)
            if state is None:
                return
            attempt = int(state[0])
        try:
            svc = self.rebuild(name)
        except Exception as e:  # noqa: BLE001 - recovery failure is the expected case
            attempt += 1
            metrics.count("recovery_attempts")
            if self.max_attempts and attempt >= self.max_attempts:
                logger.error(
                    "recovery of %r failed permanently after %d attempts: %s",
                    name, attempt, e,
                )
                metrics.count("recovery_gave_up")
                with self._lock:
                    self._pending.pop(name, None)
                cur = self.router.services.get(name)
                if isinstance(cur, DegradedService):
                    cur.recovering = False
                return
            delay = self.policy.delay(attempt)
            logger.warning(
                "recovery of %r failed (attempt %d): %s; next try in %.1fs",
                name, attempt, e, delay,
            )
            with self._lock:
                if name in self._pending:
                    self._pending[name] = [attempt, time.monotonic() + delay]
            return
        with self._lock:
            self._pending.pop(name, None)
        if self._stop.is_set():
            # Shutdown raced the rebuild: the server's close pass has run
            # (or is running) over router.services — swapping a live
            # service in now would leak its threads/device memory forever.
            logger.info("recovery of %r finished after stop(); discarding", name)
            close = getattr(svc, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    logger.exception("closing late-recovered service %r failed", name)
            return
        try:
            self.router.replace_service(name, svc)
        except Exception as e:  # noqa: BLE001 - a bad swap must not kill the thread
            # e.g. the rebuilt service registers a task a sibling now owns.
            # Retrying cannot fix a config-level conflict: mark the service
            # permanently failed (operator action) and keep the recovery
            # thread alive for the other pending services.
            logger.exception("recovered service %r failed to swap in: %s", name, e)
            metrics.count("recovery_gave_up")
            cur = self.router.services.get(name)
            if isinstance(cur, DegradedService):
                cur.recovering = False
            close = getattr(svc, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    logger.exception("closing unswappable service %r failed", name)
            return
        metrics.count("recoveries")
        from ..utils import telemetry

        telemetry.record_event(
            "recovery_swap", name,
            f"recovered service hot-swapped into the router after "
            f"{attempt} failed attempt(s)",
        )
        logger.info("service %r recovered after %d failed attempt(s)", name, attempt)
