"""Fault-injection harness for the serving stack's failure paths.

Every resilience claim in this repo — "the hub boots with a broken model
download", "an overloaded batcher sheds instead of queueing", "recovery
kicks in once the fault clears" — is only as good as the test that forces
the failure. Real downloads and device calls fail rarely and
nondeterministically, so the failure-handling code is exactly the code a
normal test run never executes. This module plants named *fault points* on
those paths (``download``, ``model_load``, ``batch_execute``,
``batch_poison``, ``batch_hang``) that are free when disarmed and
deterministic when armed.

Usage (tests):

    from lumen_tpu_torch.testing import faults
    faults.configure("download", times=2)       # fail the next 2 downloads
    ...
    faults.clear()                               # back to healthy

Usage (env, for a live server started by an integration harness):

    LUMEN_FAULTS="download:1:2,batch_execute:0.25" lumen-tpu --config ...

grammar ``point[:rate[:times]][@match]`` — ``rate`` is the per-check
probability (default 1.0, drawn from a seeded RNG: ``LUMEN_FAULTS_SEED``),
``times`` caps total injections (unset = unlimited), ``@match`` restricts
the rule to checks whose detail contains the substring.

The containment points (per-item match support):

- ``batch_poison`` — fails any dispatched batch CONTAINING a matching
  item. The batcher checks it once per item with detail
  ``{batcher}:{fingerprint}``, so ``@match`` on a payload fingerprint (the
  result-cache sha256 key) simulates ONE poison input: every sub-batch
  that still contains the item fails, every sub-batch without it
  succeeds — exactly the signal batch bisection isolates on. Arm it
  without ``times`` (bisection re-checks the point once per probe;
  a capped rule reads as a transient fault that bisection retries away).
  ``LUMEN_FAULTS="batch_poison@clip-image:<sha256-key>"``
- ``batch_hang`` — consulted via :meth:`FaultInjector.fires` (no raise):
  the batcher parks the dispatch where a wedged device call would block,
  until its watchdog (``LUMEN_BATCH_WATCHDOG_S``) fires or the batcher
  closes. ``LUMEN_FAULTS="batch_hang:1:1@vlm"`` hangs one VLM batch.
- ``tenant_flood`` — consulted via :meth:`FaultInjector.fires` by the
  per-tenant quota gate (:class:`~lumen_tpu.utils.qos.TenantQuota`) with
  the tenant id as detail: armed, the matched tenant's token bucket reads
  as exhausted, so every one of its requests sheds with the retry-after
  hint — a deterministic tenant flood with zero generated traffic.
  ``LUMEN_FAULTS="tenant_flood@team-a"`` floods tenant ``team-a`` only.
- ``kv_spill`` / ``kv_resume`` — the paged VLM engine's KV spill tier
  (``models/vlm/continuous.py``): ``kv_spill`` fails the page export of a
  preemption victim (detail ``{engine}:{slot}``), forcing the
  requeue-and-redo / typed-shed degradation ladder; ``kv_resume`` fails
  the page re-install of a parked spill record (detail
  ``{engine}:resume``) — a stand-in for a corrupt lease — which must
  degrade the same way, never hang or leak pages/leases.
  ``LUMEN_FAULTS="kv_spill:0.5"`` makes half of all spills fall back.

Production hooks call :meth:`FaultInjector.check`; its disarmed fast path
is one attribute read, so shipping the hooks costs nothing.
"""

from __future__ import annotations

import logging
import os
import random
import threading
from dataclasses import dataclass, field

from ..core.exceptions import ResourceError

logger = logging.getLogger(__name__)

FAULTS_ENV = "LUMEN_FAULTS"
SEED_ENV = "LUMEN_FAULTS_SEED"

#: Fault points wired into the production stack. ``check`` accepts any
#: string (new points need no registry edit), but tests should prefer these.
DOWNLOAD = "download"
MODEL_LOAD = "model_load"
BATCH_EXECUTE = "batch_execute"
BATCH_POISON = "batch_poison"
BATCH_HANG = "batch_hang"
TENANT_FLOOD = "tenant_flood"
KV_SPILL = "kv_spill"
KV_RESUME = "kv_resume"


class FaultInjected(ResourceError):
    """The error raised at an armed fault point.

    Subclasses :class:`ResourceError` so the downloader's existing
    "never raises, report per model" contract treats an injected download
    failure exactly like a real one — the whole point is exercising the
    real handling path, not a parallel test-only one.
    """

    def __init__(self, point: str, detail: str = ""):
        super().__init__(f"injected fault at {point!r}", detail=detail or None)
        self.point = point


@dataclass
class FaultRule:
    point: str
    rate: float = 1.0
    times: int | None = None  # max injections; None = unlimited
    match: str = ""           # substring filter on the check's detail
    fired: int = 0            # injections so far (telemetry + cap)
    checked: int = 0          # checks that consulted this rule

    def exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times


class FaultInjector:
    """Thread-safe registry of armed fault rules, keyed by fault point."""

    def __init__(self, seed: int | None = None):
        self._lock = threading.Lock()
        self._rules: dict[str, FaultRule] = {}
        self._rng = random.Random(seed)
        self._env_loaded = False

    # -- configuration ----------------------------------------------------

    def configure(
        self,
        point: str,
        rate: float = 1.0,
        times: int | None = None,
        match: str = "",
    ) -> FaultRule:
        """Arm ``point``; replaces any existing rule for it."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        rule = FaultRule(point=point, rate=rate, times=times, match=match)
        with self._lock:
            self._rules[point] = rule
        logger.info("fault armed: %s rate=%s times=%s match=%r", point, rate, times, match)
        return rule

    def clear(self, point: str | None = None) -> None:
        """Disarm one point, or everything (also forgets the env spec so a
        cleared injector stays cleared)."""
        with self._lock:
            if point is None:
                self._rules.clear()
                self._env_loaded = True  # don't resurrect rules from env
            else:
                self._rules.pop(point, None)

    def reset(self) -> None:
        """Full reset: disarm everything AND re-read the env on next check
        (test teardown helper)."""
        with self._lock:
            self._rules.clear()
            self._env_loaded = False

    def load_env(self, spec: str | None = None) -> None:
        """Parse ``LUMEN_FAULTS`` (or an explicit spec string). Malformed
        entries are logged and skipped — a typo'd fault spec must degrade
        the *harness*, never crash the server under test."""
        spec = os.environ.get(FAULTS_ENV, "") if spec is None else spec
        seed = os.environ.get(SEED_ENV)
        if seed is not None:
            try:
                self._rng = random.Random(int(seed))
            except ValueError:
                logger.warning("ignoring malformed %s=%r", SEED_ENV, seed)
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            body, _, match = entry.partition("@")
            parts = body.split(":")
            try:
                point = parts[0]
                rate = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
                times = int(parts[2]) if len(parts) > 2 and parts[2] else None
                if not point:
                    raise ValueError("empty fault point")
                self.configure(point, rate=rate, times=times, match=match)
            except (ValueError, IndexError) as e:
                logger.warning("ignoring malformed fault spec %r: %s", entry, e)

    # -- the production hook ----------------------------------------------

    def check(self, point: str, detail: str = "") -> None:
        """Raise :class:`FaultInjected` if ``point`` is armed for this call.

        Disarmed fast path: one dict read (after a one-time env parse), so
        the hooks are safe on hot paths.
        """
        if not self._env_loaded:
            with self._lock:
                pending = not self._env_loaded
                self._env_loaded = True
            if pending:
                self.load_env()
        if not self._rules:
            return
        with self._lock:
            rule = self._rules.get(point)
            if rule is None:
                return
            rule.checked += 1
            if rule.exhausted():
                return
            if rule.match and rule.match not in detail:
                return
            if rule.rate < 1.0 and self._rng.random() >= rule.rate:
                return
            rule.fired += 1
        logger.warning("injecting fault at %r (%s)", point, detail or "no detail")
        raise FaultInjected(point, detail)

    def fires(self, point: str, detail: str = "") -> bool:
        """Like :meth:`check` but reports instead of raising — for fault
        points whose production behavior is not an exception (e.g.
        ``batch_hang`` parks the thread). Same rule semantics: rate,
        times cap, ``@match`` on detail."""
        try:
            self.check(point, detail)
        except FaultInjected:
            return True
        return False

    # -- introspection ----------------------------------------------------

    def active(self) -> bool:
        with self._lock:
            return any(not r.exhausted() for r in self._rules.values())

    def rule(self, point: str) -> FaultRule | None:
        with self._lock:
            return self._rules.get(point)


#: Process-global injector consulted by the production hooks.
faults = FaultInjector()
