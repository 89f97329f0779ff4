"""Replica fleet: device-aware multi-replica serving (the port's twin of
the batcher side of ``lumen_tpu/runtime/fleet.py``).

Each model family serves as **N data-parallel replicas**, one per device
slice:

- :func:`plan_replicas` partitions the host's CUDA devices (or an explicit
  device list; the CPU tests pass one) into N slices
  (``LUMEN_REPLICAS`` / per-family ``LUMEN_REPLICAS_<FAMILY>`` override,
  ``max`` = one replica per slice) and builds one
  :class:`~lumen_tpu_torch.runtime.mesh.DeviceMesh` per slice, the JAX
  shapes: one replica over ``n`` cards is ``{"data": n}``, ``N`` replicas
  ``{"data": n / N}`` each. A replica count that does not divide the
  device count degrades to the largest one that does, with a one-shot
  warning — ``LUMEN_REPLICAS=8`` on a 4-card host serves 4 replicas
  instead of failing boot. On one H100 the plan is one replica, and
  :func:`build_fleet` hands back the plain batcher.
- :class:`ReplicaSet` is a drop-in for the single
  :class:`~lumen_tpu_torch.runtime.batcher.MicroBatcher` a manager owns:
  ``submit``/``__call__`` route each request to one replica through a
  pluggable dispatch policy (``round_robin`` | ``least_loaded``,
  ``LUMEN_REPLICA_POLICY``; :func:`register_policy` for custom ones).
  Every replica keeps its own MicroBatcher — own admission queue, own
  collector/fetch threads, own staging arenas, own
  ``batcher:{name}-r{i}`` / ``batch-occupancy:{name}-r{i}`` gauges — so a
  poisoned or wedged replica is contained while siblings keep serving.
- **Per-replica health**: backend failures (watchdog timeouts, device
  errors) count against the replica that served them; after
  ``LUMEN_REPLICA_FAILURES`` consecutive failures (or immediately on a
  wedged batcher) the replica is marked *down*, the dispatcher skips it,
  and a queue-full or wedge at submit time fails over to a sibling.
  A background revive swaps ONLY the dead replica's batcher for a fresh
  one after ``LUMEN_REPLICA_REVIVE_S`` — siblings never notice.

:class:`EngineFleet` is the scale-actuator adapter of the families that
dispatch without a MicroBatcher: OCR's direct lane and the VLM continuous
engine replicas (``models/vlm/manager.py`` builds one when
``LUMEN_REPLICAS_VLM`` asks for more than one). Each replica's mesh keeps
the rest of its slice on ``data``: its batches split over the slice's
cards (``runtime.batcher.mesh_sharded``). On an ``expert x model`` group
(``runtime.tp_group``) the slices are the group's data places: each
replica keeps the group's axes and a contiguous slice of its places, the
rest of which it absorbs on ``data``, as the JAX plan slices the host's
devices.
"""

from __future__ import annotations

import copy
import logging
import math
import os
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from ..utils.deadline import DeadlineExpired, PoisonInput, QueueFull, WatchdogTimeout
from ..utils.env import env_float, env_int
from ..utils.metrics import metrics
from . import telemetry
from .batcher import MicroBatcher, wait_for_batch

logger = logging.getLogger(__name__)

REPLICAS_ENV = "LUMEN_REPLICAS"
POLICY_ENV = "LUMEN_REPLICA_POLICY"
FAILURES_ENV = "LUMEN_REPLICA_FAILURES"
REVIVE_ENV = "LUMEN_REPLICA_REVIVE_S"

#: replica health states (surface in ``Health`` trailing metadata and the
#: ``replica:{name}`` gauge set as the numeric codes below). PARKED is
#: voluntary idleness — the autopilot's scale-down released the replica's
#: mesh slice (batcher closed, chips free for a hot sibling family);
#: unlike DOWN it is healthy, never auto-revived, and only a scale-up
#: (or an operator's :meth:`ReplicaSet.unpark`) brings it back.
SERVING = "serving"
REVIVING = "reviving"
DOWN = "down"
PARKED = "parked"
_STATE_CODES = {SERVING: 0, REVIVING: 1, DOWN: 2, PARKED: 3}


# -- knobs -------------------------------------------------------------------


def replicas_for(family: str) -> int:
    """Requested replica count for one model family:
    ``LUMEN_REPLICAS_<FAMILY>`` (e.g. ``LUMEN_REPLICAS_CLIP``) wins over
    the global ``LUMEN_REPLICAS``; unset/malformed = 1 (the single-batcher
    behavior every PR before the fleet shipped). ``max`` = -1, meaning one
    replica per available mesh slice (resolved by :func:`plan_replicas`
    against the device count and any TP axes)."""
    for key in (f"{REPLICAS_ENV}_{family.upper()}", REPLICAS_ENV):
        raw = os.environ.get(key)
        if raw is None or not raw.strip():
            continue
        if raw.strip().lower() == "max":
            return -1
        try:
            return max(1, int(raw))
        except ValueError:
            logger.warning("ignoring malformed %s=%r", key, raw)
    return 1


def replica_failures() -> int:
    """``LUMEN_REPLICA_FAILURES``: consecutive backend failures that mark
    one replica down (default 3; 0 = replicas are never marked down by
    outcome — a wedged batcher still fails over at submit time)."""
    return env_int(FAILURES_ENV, 3, minimum=0)


def replica_revive_s() -> float:
    """``LUMEN_REPLICA_REVIVE_S``: cooldown before a downed replica's
    batcher is rebuilt in the background (default 5s; 0 disables automatic
    revival — :meth:`ReplicaSet.revive` stays available to operators)."""
    return env_float(REVIVE_ENV, 5.0, minimum=0.0)


def largest_dividing(requested: int, n: int) -> int:
    """Largest replica count <= ``requested`` that divides ``n`` evenly
    (>= 1). The graceful-degrade rule for replica counts that do not fit
    the device count."""
    r = max(1, min(requested, n))
    while n % r:
        r -= 1
    return r


# -- dispatch policies -------------------------------------------------------


class RoundRobinPolicy:
    """Cycle through live replicas — fair and cache-friendly when request
    costs are uniform (the CLIP/face embed workloads)."""

    name = "round_robin"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._i = 0

    def pick(self, live: list["Replica"]) -> "Replica":
        with self._lock:
            self._i += 1
            return live[self._i % len(live)]


class LeastLoadedPolicy:
    """Pick the replica with the fewest queued + in-flight items — rides
    over stragglers (one replica stuck in a cold compile, a skewed batch)
    at the cost of one load probe per pick."""

    name = "least_loaded"

    def pick(self, live: list["Replica"]) -> "Replica":
        return min(live, key=lambda r: r.load())


#: pluggable policy registry: name -> zero-arg factory.
POLICIES: dict[str, Callable[[], Any]] = {
    "round_robin": RoundRobinPolicy,
    "least_loaded": LeastLoadedPolicy,
}


def register_policy(name: str, factory: Callable[[], Any]) -> None:
    """Register a custom dispatch policy (a zero-arg factory returning an
    object with ``name`` and ``pick(live_replicas)``)."""
    POLICIES[name] = factory


def dispatch_policy_name() -> str:
    """``LUMEN_REPLICA_POLICY`` resolved against the registry; unknown
    names degrade to ``round_robin`` with a warning, not a crash."""
    raw = (os.environ.get(POLICY_ENV) or "round_robin").strip().lower()
    if raw not in POLICIES:
        logger.warning(
            "unknown %s=%r (known: %s); using round_robin",
            POLICY_ENV, raw, sorted(POLICIES),
        )
        return "round_robin"
    return raw


def make_policy(name: str | None = None):
    return POLICIES[name or dispatch_policy_name()]()


# -- device planning ---------------------------------------------------------


@dataclass
class FleetPlan:
    """Resolved replica layout for one model family."""

    family: str
    replicas: int
    meshes: list  # one DeviceMesh per replica
    policy: str
    device_count: int
    devices_per_replica: int
    requested: int = 0


_clamp_warned: set[str] = set()


def plan_replicas(
    family: str,
    mesh_axes: dict[str, int] | None = None,
    devices: list | None = None,
) -> FleetPlan:
    """Partition the host's devices into the family's replica slices.

    With 1 replica (the default): one mesh over every local device (every
    CUDA device, or ``devices``), built from the service's configured
    axes. With N > 1, devices split into N contiguous slices; each
    replica's mesh keeps the configured non-``data`` axes and absorbs the
    rest of its slice on ``data``. Counts that don't fit degrade to the
    largest that does (one-shot warning per family). Axes that name an
    ``expert`` or ``model`` axis plan over the running group's data places
    (a slice a place at most) in place of ``devices``. ``seq`` and
    ``stage`` count inside a slice, as every non-``data`` axis does."""
    from .mesh import BLOCK_AXES, DATA_AXIS, build_mesh, group_shape, local_devices

    devices = list(devices if devices is not None else local_devices())
    n = len(devices)
    axes = dict(mesh_axes or {})
    requested = replicas_for(family)
    policy = dispatch_policy_name()
    grouped = any(s != 1 for s in group_shape(axes).values())
    group = None
    if grouped:
        from . import tp_group

        group = tp_group.current()
        if group is None:
            build_mesh(mesh_axes, devices=devices)  # raises: no group is running
        # The group's places' blocks (an expert x model copy a seq and
        # stage position), not this process's card list.
        n = group.data * group.block * group.size
    # Non-data axes (TP/EP/SP/...) live INSIDE each replica: a slice must
    # hold at least one full copy of them.
    fixed = math.prod(s for a, s in axes.items() if a != DATA_AXIS and s != -1)
    if group is not None:
        fixed = group.size * math.prod(s for a, s in axes.items() if a in BLOCK_AXES and s != -1)
    slots = max(1, n // max(1, fixed))
    want = slots if requested == -1 else requested
    replicas = largest_dividing(want, slots)
    if replicas != want and family not in _clamp_warned:
        _clamp_warned.add(family)
        logger.warning(
            "%s: %d replica(s) requested but %d device(s) hold %d slice(s) "
            "of %d device(s) each; degrading to %d replica(s)",
            family, want, n, slots, max(1, fixed), replicas,
        )
    if replicas <= 1:
        mesh = build_mesh(mesh_axes, devices=devices) if mesh_axes else build_mesh(devices=devices)
        return FleetPlan(family, 1, [mesh], policy, n, n, requested=want)
    per = n // replicas
    rep_axes = {a: s for a, s in axes.items() if a != DATA_AXIS}
    if not any(s == -1 for s in rep_axes.values()):
        # A wildcard non-data axis (e.g. {"model": -1}, TP over whatever
        # is available) already absorbs the whole slice — adding a second
        # -1 axis would make the mesh unresolvable.
        rep_axes[DATA_AXIS] = -1
    if group is not None:
        # A contiguous slice of the group's data places a replica.
        step = group.data // replicas
        meshes = [build_mesh(rep_axes, places=range(i * step, (i + 1) * step)) for i in range(replicas)]
    else:
        meshes = [
            build_mesh(rep_axes, devices=devices[i * per : (i + 1) * per])
            for i in range(replicas)
        ]
    logger.info(
        "%s: replica fleet of %d x %d-device slice(s) (policy=%s)",
        family, replicas, per, policy,
    )
    return FleetPlan(family, replicas, meshes, policy, n, per, requested=want)


def fleet_devices(device: torch.device) -> list[torch.device]:
    """The devices a manager's replica plan partitions: the CPU alone, or
    every local card starting at ``device``."""
    from .mesh import local_devices

    if device.type != "cuda":
        return [device]
    devs = local_devices()
    return devs[device.index:] + devs[: device.index]


def replicate_all(params: Any, plan: FleetPlan) -> list[list[Any]]:
    """The weights on every replica: for each replica mesh, one copy a
    data place in place order (``parallel.sharding.replicate``). ``params``
    is what ``replicate`` takes; a module goes to replica 0's first place
    itself, and every other replica starts from a deep copy of it, made
    before it moves."""
    from ..parallel.sharding import replicate

    rest = [replicate(copy.deepcopy(params) if isinstance(params, torch.nn.Module) else params, m)
            for m in plan.meshes[1:]]
    return [replicate(params, plan.meshes[0]), *rest]


def batcher_name(base: str, rid: int | None) -> str:
    """Per-replica batcher/gauge name; a singleton (rid None) keeps the
    plain pre-fleet name so existing dashboards don't move."""
    return base if rid is None else f"{base}-r{rid}"


def each_batcher(dispatcher) -> Iterator[MicroBatcher]:
    """Iterate the underlying MicroBatcher(s) of a dispatcher that is
    either a plain batcher or a :class:`ReplicaSet` (warmup and telemetry
    helpers stay agnostic)."""
    if isinstance(dispatcher, ReplicaSet):
        for r in dispatcher.replicas:
            if r.batcher is not None:
                yield r.batcher
    elif dispatcher is not None:
        yield dispatcher


def build_fleet(plan: FleetPlan, name: str, build: Callable[[int | None, Any], MicroBatcher]):
    """Build one dispatcher for ``plan``: the plain started MicroBatcher
    for a 1-replica plan (``build(None, mesh)`` — zero behavior change), a
    :class:`ReplicaSet` otherwise. ``build(rid, mesh)`` must return a
    STARTED batcher; it is also the revive hook, so it must be safe to
    call again for a single replica long after initialization."""
    if plan.replicas <= 1:
        return build(None, plan.meshes[0])
    return ReplicaSet(
        name, build, plan.meshes, policy=plan.policy,
        devices_per_replica=plan.devices_per_replica,
    )


# -- the replica set ---------------------------------------------------------

#: live ReplicaSets by name (weakrefs, last-writer-wins): the autopilot's
#: scale loop discovers the process's fleets here — same idiom as the WFQ
#: queue registry in ``utils/qos.py`` and the batcher registry.
_fleet_registry: dict[str, "weakref.ref[ReplicaSet]"] = {}
_fleet_reg_lock = threading.Lock()


def live_fleets() -> list["ReplicaSet"]:
    """Every live (not-yet-closed) ReplicaSet in the process."""
    with _fleet_reg_lock:
        items = list(_fleet_registry.items())
    out: list[ReplicaSet] = []
    for name, ref in items:
        fs = ref()
        if fs is None:
            with _fleet_reg_lock:
                if _fleet_registry.get(name) is ref:
                    del _fleet_registry[name]
        elif not fs._closed:
            out.append(fs)
    return out


@dataclass
class Replica:
    """One mesh slice + its batcher + health state."""

    rid: int
    mesh: Any
    batcher: MicroBatcher | None
    state: str = SERVING
    streak: int = 0  # consecutive backend failure EVENTS (not futures)
    down_since: float | None = None
    dispatches: int = 0
    error: str | None = None
    #: recently counted exception objects — a failed batch settles every
    #: one of its futures with the SAME exception instance, and each must
    #: count as ONE failure event or a single bad batch of N >= the
    #: threshold would down the replica instantly. A small ring (not one
    #: slot) so two failed batches whose callbacks interleave (dispatch-
    #: thread failure racing a fetch-thread failure) still dedup; holding
    #: references (not id()) keeps identities from being recycled.
    recent_errs: deque = field(default_factory=lambda: deque(maxlen=4))

    @property
    def tag(self) -> str:
        return f"r{self.rid}"

    def load(self) -> float:
        b = self.batcher
        return float(b.load()) if b is not None else float("inf")


class ReplicaSet:
    """N MicroBatcher replicas behind one ``submit()``/``__call__``.

    Drop-in for the single MicroBatcher a manager used to own: the same
    entry points, deadlines, fingerprint quarantine gate and error
    vocabulary — plus dispatch-policy routing, per-replica failure
    accounting, submit-time failover (a full queue or wedged batcher tries
    the next sibling once around the ring) and background single-replica
    revival. With every replica down, ``submit`` raises
    :class:`~lumen_tpu_torch.utils.deadline.WatchdogTimeout` — the serving layer
    maps it to a retryable UNAVAILABLE and the per-service circuit breaker
    counts it as the backend failure it is."""

    def __init__(
        self,
        name: str,
        build: Callable[[int | None, Any], MicroBatcher],
        meshes: list,
        policy: str | Any | None = None,
        failures: int | None = None,
        revive_s: float | None = None,
        clock: Callable[[], float] = time.monotonic,
        devices_per_replica: int = 1,
    ):
        if not meshes:
            raise ValueError("ReplicaSet needs at least one mesh/slot")
        self.name = name
        self.build = build
        self.policy = policy if policy is not None and not isinstance(policy, str) else make_policy(policy)
        self.failures = replica_failures() if failures is None else max(0, failures)
        self.revive_s = replica_revive_s() if revive_s is None else max(0.0, revive_s)
        #: chips one replica's mesh slice claims — the unit the autopilot's
        #: chip ledger accounts scale decisions in.
        self.devices_per_replica = max(1, devices_per_replica)
        self._clock = clock
        self._lock = threading.Lock()
        self._closed = False
        self._revive_thread: threading.Thread | None = None
        self._revive_wake = threading.Event()
        self.replicas = [Replica(i, mesh, build(i, mesh)) for i, mesh in enumerate(meshes)]
        ref = weakref.ref(self)

        def _gauges() -> dict:
            s = ref()
            if s is None:
                return {}
            with s._lock:
                out: dict = {
                    "replicas": len(s.replicas),
                    "down": sum(1 for r in s.replicas if r.state in (DOWN, REVIVING)),
                    "parked": sum(1 for r in s.replicas if r.state == PARKED),
                }
                snap = list(s.replicas)
            for r in snap:
                out[f"{r.tag}_state"] = _STATE_CODES[r.state]
                out[f"{r.tag}_dispatches"] = r.dispatches
                load = r.load()
                out[f"{r.tag}_load"] = -1 if load == float("inf") else int(load)
            return out

        self._gauge_fn = _gauges
        metrics.register_gauges(f"replica:{name}", _gauges)
        with _fleet_reg_lock:
            _fleet_registry[name] = ref

    # -- dispatch ---------------------------------------------------------

    def _pick(self, exclude: set[int]) -> Replica | None:
        with self._lock:
            live = [
                r
                for r in self.replicas
                if r.state == SERVING and r.rid not in exclude and r.batcher is not None
            ]
        if not live:
            return None
        return live[0] if len(live) == 1 else self.policy.pick(live)

    def submit(
        self, item: Any, deadline: float | None = None, fingerprint: str | None = None
    ) -> Future:
        """Route one item to a replica's batcher. Quarantine
        (:class:`PoisonInput`) and expired deadlines raise through
        unchanged — those are verdicts on the REQUEST, identical on every
        replica. A shed (:class:`QueueFull`) or wedge
        (:class:`WatchdogTimeout`) is a verdict on the REPLICA: the
        dispatcher fails over to the next sibling once around the ring
        before surfacing the last error."""
        last: BaseException | None = None
        tried: set[int] = set()
        for _ in range(len(self.replicas)):
            r = self._pick(tried)
            if r is None:
                break
            tried.add(r.rid)
            try:
                fut = r.batcher.submit(item, deadline=deadline, fingerprint=fingerprint)
            except (DeadlineExpired, PoisonInput):
                raise
            except WatchdogTimeout as e:
                # The batcher wedged since its watchdog fired: this replica
                # can never serve again without a revive — contain it now.
                self._mark_down(r, e)
                last = e
                continue
            except (QueueFull, RuntimeError) as e:
                # QueueFull: this replica is saturated, a sibling may not
                # be. RuntimeError("closed"): a revive is swapping the
                # batcher under us. Both: try the next replica.
                last = e
                continue
            if last is not None:
                # A prior replica failed and THIS one served: a request was
                # actually rerouted (counting at the failure site would
                # inflate the metric when no sibling exists to take over).
                metrics.count("replica_failovers")
                metrics.count(f"replica_failovers:{self.name}")
            with self._lock:
                r.dispatches += 1
            fut._lumen_replica_owner = r.batcher
            self._observe(r, fut)
            return fut
        if last is not None:
            raise last
        raise WatchdogTimeout(
            f"{self.name}: all {len(self.replicas)} replicas down; "
            "revival pending"
        )

    def __call__(
        self, item: Any, timeout: float | None = None, fingerprint: str | None = None
    ) -> Any:
        fut = self.submit(item, fingerprint=fingerprint)
        owner: MicroBatcher = fut._lumen_replica_owner
        return wait_for_batch(fut, owner.name, owner.stats, timeout)

    # -- health accounting ------------------------------------------------

    def _observe(self, r: Replica, fut: Future) -> None:
        def _done(f: Future, _r: Replica = r) -> None:
            if f.cancelled():
                return
            e = f.exception()
            if e is None:
                with self._lock:
                    _r.streak = 0
                return
            if isinstance(e, (DeadlineExpired, QueueFull, PoisonInput)):
                return  # caller-budget / payload verdicts: not the replica's fault
            self._record_failure(_r, e)

        fut.add_done_callback(_done)

    def _record_failure(self, r: Replica, err: BaseException) -> None:
        if isinstance(err, WatchdogTimeout):
            # A watchdog verdict wedges the batcher permanently: down now,
            # regardless of the streak threshold.
            self._mark_down(r, err)
            return
        with self._lock:
            if r.state != SERVING:
                return
            if any(err is e for e in r.recent_errs):
                return  # same failed batch: this event was already counted
            r.recent_errs.append(err)
            r.streak += 1
            trip = self.failures > 0 and r.streak >= self.failures
        if trip:
            self._mark_down(r, err)

    def _mark_down(self, r: Replica, err: BaseException) -> None:
        with self._lock:
            if self._closed or r.state != SERVING:
                return
            r.state = DOWN
            r.down_since = self._clock()
            r.error = f"{type(err).__name__}: {err}"
        metrics.count("replica_down")
        metrics.count(f"replica_down:{self.name}")
        telemetry.record_event(
            "replica_down", f"{self.name}/{r.tag}",
            f"replica marked down ({r.error}); siblings keep serving",
        )
        logger.error(
            "%s: replica %s DOWN (%s) — siblings keep serving%s",
            self.name, r.tag, r.error,
            f"; revive in {self.revive_s:.1f}s" if self.revive_s > 0 else "",
        )
        if self.revive_s > 0:
            self._ensure_revive_thread()

    # -- revival ----------------------------------------------------------

    def _ensure_revive_thread(self) -> None:
        with self._lock:
            if self._closed:
                return
            if self._revive_thread is None or not self._revive_thread.is_alive():
                self._revive_thread = threading.Thread(
                    target=self._revive_loop, name=f"{self.name}-revive", daemon=True
                )
                self._revive_thread.start()
        self._revive_wake.set()

    def _due(self) -> list[Replica]:
        now = self._clock()
        with self._lock:
            return [
                r
                for r in self.replicas
                if r.state == DOWN
                and r.down_since is not None
                and now - r.down_since >= self.revive_s
            ]

    def _revive_loop(self) -> None:
        while not self._closed:
            # Sleep until the earliest pending cooldown elapses (the wake
            # event covers newly-downed replicas) instead of polling at
            # 20 Hz for the whole down window; capped so a fake/skewed
            # clock can never park the thread past a real due time.
            with self._lock:
                downs = [
                    r.down_since
                    for r in self.replicas
                    if r.state == DOWN and r.down_since is not None
                ]
            if downs:
                delay = min(d + self.revive_s for d in downs) - self._clock()
                timeout = min(max(delay, 0.01), 0.5)
            else:
                timeout = 0.05
            self._revive_wake.wait(timeout=timeout)
            self._revive_wake.clear()
            for r in self._due():
                self.revive(r.rid)
            with self._lock:
                # Retire when nothing is DOWN (a PARKED replica is
                # voluntary idleness, never revived — it must not keep
                # this thread polling forever); clear the slot under the
                # lock BEFORE exiting so _ensure_revive_thread never races
                # a thread that decided to exit but still reports
                # is_alive().
                if self._closed or all(r.state != DOWN for r in self.replicas):
                    self._revive_thread = None
                    return

    def revive(self, rid: int) -> bool:
        """Rebuild ONE replica's batcher through the factory and swap it
        in — the replica-granular hot-swap. Siblings (their batchers,
        queues, compiled programs) are untouched. Returns True on success;
        a failed rebuild re-arms the cooldown and keeps the replica
        down."""
        r = self.replicas[rid]
        with self._lock:
            if self._closed or r.state != DOWN:
                # Only a DOWN replica gets rebuilt: reviving a SERVING one
                # would pull working capacity out of rotation (and a
                # failed rebuild would then down it for nothing).
                return False
            old, r.state = r.batcher, REVIVING
        logger.info("%s: reviving replica %s", self.name, r.tag)
        try:
            fresh = self.build(rid, r.mesh)
        except Exception as e:  # noqa: BLE001 - revive failure is the expected case
            with self._lock:
                r.state = DOWN
                r.down_since = self._clock()
                r.error = f"revive failed: {type(e).__name__}: {e}"
            metrics.count("replica_revive_failures")
            metrics.count(f"replica_revive_failures:{self.name}")
            logger.exception("%s: revive of %s failed", self.name, r.tag)
            return False
        closed_late = False
        with self._lock:
            if self._closed:
                closed_late = True
            else:
                r.batcher = fresh
                r.state = SERVING
                r.streak = 0
                r.down_since = None
                r.error = None
        if closed_late:
            fresh.close()
            return False
        metrics.count("replica_revivals")
        metrics.count(f"replica_revivals:{self.name}")
        telemetry.record_event(
            "replica_revive", f"{self.name}/{r.tag}",
            "dead replica's batcher rebuilt and swapped back in",
        )
        logger.info("%s: replica %s revived", self.name, r.tag)
        if old is not None:
            try:
                old.close()
            except Exception:  # noqa: BLE001 - best-effort teardown of the wedge
                logger.exception("%s: closing dead replica %s failed", self.name, r.tag)
        return True

    # -- scale actuation (park / unpark) ----------------------------------

    def active_count(self) -> int:
        """Replicas currently SERVING (the chip-claim unit count)."""
        with self._lock:
            return sum(1 for r in self.replicas if r.state == SERVING)

    def parked_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if r.state == PARKED)

    def park(self, rid: int | None = None) -> int | None:
        """Release one SERVING replica's mesh slice: close its batcher and
        mark it PARKED (skipped by dispatch, exempt from auto-revival).
        ``rid`` None parks the highest-rid serving replica — deterministic,
        and the inverse of :meth:`unpark`'s lowest-parked-first. Refuses to
        park the LAST serving replica (cold families keep a floor of 1 —
        an empty fleet would turn every request into a watchdog error).
        Returns the parked rid, or None when nothing was parked."""
        with self._lock:
            if self._closed:
                return None
            serving = [r for r in self.replicas if r.state == SERVING]
            if len(serving) <= 1:
                return None
            if rid is None:
                r = serving[-1]
            else:
                r = self.replicas[rid]
                if r.state != SERVING:
                    return None
            old, r.batcher = r.batcher, None
            r.state = PARKED
            r.streak = 0
            r.down_since = None
            r.error = None
        metrics.count("replica_parked")
        metrics.count(f"replica_parked:{self.name}")
        telemetry.record_event(
            "replica_park", f"{self.name}/{r.tag}",
            f"replica parked: {self.devices_per_replica} chip slice(s) "
            "released; siblings keep serving",
        )
        logger.info("%s: replica %s PARKED (scale-down)", self.name, r.tag)
        if old is not None:
            try:
                # close() drains the queue (queued entries settle loudly)
                # and retires the collector/fetch threads — the slice's
                # compiled programs go with it; an unpark recompiles or
                # hits the persistent compile cache.
                old.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                logger.exception("%s: closing parked replica %s failed", self.name, r.tag)
        return r.rid

    def unpark(self, rid: int | None = None) -> int | None:
        """Claim a slice back: rebuild one PARKED replica's batcher through
        the factory (the same ``build(rid, mesh)`` hook revival uses) and
        return it to dispatch. ``rid`` None unparks the lowest-rid parked
        replica. Returns the unparked rid, or None (nothing parked, closed,
        or the rebuild failed — the replica stays parked; unlike a DOWN
        replica there is no cooldown to re-arm, the next scale-up retries)."""
        with self._lock:
            if self._closed:
                return None
            parked = [r for r in self.replicas if r.state == PARKED]
            if not parked:
                return None
            if rid is None:
                r = parked[0]
            else:
                r = self.replicas[rid]
                if r.state != PARKED:
                    return None
            r.state = REVIVING
        try:
            fresh = self.build(r.rid, r.mesh)
        except Exception as e:  # noqa: BLE001 - rebuild failure keeps it parked
            with self._lock:
                r.state = PARKED
                r.error = f"unpark failed: {type(e).__name__}: {e}"
            metrics.count("replica_revive_failures")
            metrics.count(f"replica_revive_failures:{self.name}")
            logger.exception("%s: unpark of %s failed", self.name, r.tag)
            return None
        closed_late = False
        with self._lock:
            if self._closed:
                closed_late = True
            else:
                r.batcher = fresh
                r.state = SERVING
                r.streak = 0
                r.error = None
        if closed_late:
            fresh.close()
            return None
        metrics.count("replica_unparked")
        metrics.count(f"replica_unparked:{self.name}")
        telemetry.record_event(
            "replica_unpark", f"{self.name}/{r.tag}",
            f"parked replica rebuilt: {self.devices_per_replica} chip "
            "slice(s) claimed",
        )
        logger.info("%s: replica %s unparked (scale-up)", self.name, r.tag)
        return r.rid

    # -- telemetry / lifecycle --------------------------------------------

    def states(self) -> dict[str, str]:
        """``{"r0": "serving", ...}`` — surfaced in ``Health`` trailing
        metadata (``lumen-replica-status``) and capability extra."""
        with self._lock:
            return {r.tag: r.state for r in self.replicas}

    @property
    def stats(self) -> dict:
        """Aggregate of every live replica's batcher stats (capability /
        bench telemetry; per-replica detail lives on the gauges)."""
        agg: dict = {}
        for b in each_batcher(self):
            for k, v in b.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    @property
    def buckets(self) -> list[int]:
        for b in each_batcher(self):
            return b.buckets
        return []

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread = self._revive_thread
        self._revive_wake.set()
        if thread is not None:
            thread.join(timeout=5)
        for r in self.replicas:
            if r.batcher is not None:
                try:
                    r.batcher.close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    logger.exception("%s: closing replica %s failed", self.name, r.tag)
        metrics.unregister_gauges(f"replica:{self.name}", self._gauge_fn)
        with _fleet_reg_lock:
            ref = _fleet_registry.get(self.name)
            if ref is not None and ref() is self:
                del _fleet_registry[self.name]


# -- engine fleets (park/unpark for non-batcher families) --------------------


class EngineFleet:
    """Scale-actuator adapter for model families that dispatch WITHOUT a
    MicroBatcher — the continuous-batching VLM decode engines and the
    OCR direct dispatcher. Speaks exactly the duck type the autopilot's
    scale loop reads (``replicas`` with ``.rid``/``.state``/``.batcher``,
    ``park``/``unpark``, ``devices_per_replica``, ``_closed``) and joins
    the same fleet registry, so chip-ledger reallocation covers all four
    families instead of only the batcher-backed ones.

    The "batcher" slot of each :class:`Replica` holds the engine itself
    (anything with ``.name``/``.load()``/``.close()``). ``build(rid)``
    is the unpark hook rebuilding one engine on its original mesh slice;
    a fleet without one (OCR's single direct dispatcher) can still hold
    its chip claim in the ledger and report duty, but never grows.
    Health surfaces (``replica_states_of``, ``lumen-replica-status``)
    filter on :class:`ReplicaSet`, so an EngineFleet changes none of the
    existing Health payloads."""

    def __init__(
        self,
        name: str,
        engines: list,
        build: Callable[[int], Any] | None = None,
        devices_per_replica: int = 1,
    ):
        if not engines:
            raise ValueError("EngineFleet needs at least one engine")
        self.name = name
        self.build = build
        self.devices_per_replica = max(1, devices_per_replica)
        self._lock = threading.Lock()
        self._closed = False
        self.replicas = [Replica(i, None, eng) for i, eng in enumerate(engines)]
        ref = weakref.ref(self)

        def _gauges() -> dict:
            s = ref()
            if s is None:
                return {}
            with s._lock:
                snap = list(s.replicas)
                out: dict = {
                    "replicas": len(snap),
                    "parked": sum(1 for r in snap if r.state == PARKED),
                }
            for r in snap:
                out[f"{r.tag}_state"] = _STATE_CODES[r.state]
                load = r.load()
                out[f"{r.tag}_load"] = -1 if load == float("inf") else int(load)
            return out

        self._gauge_fn = _gauges
        metrics.register_gauges(f"replica:{name}", _gauges)
        with _fleet_reg_lock:
            _fleet_registry[name] = ref

    def serving_engines(self) -> list:
        """The engines dispatch may use right now (the manager's pick
        loop consults this instead of its boot-time engine list, so a
        parked engine stops receiving work the moment it parks)."""
        with self._lock:
            return [
                r.batcher
                for r in self.replicas
                if r.state == SERVING and r.batcher is not None
            ]

    def active_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if r.state == SERVING)

    def parked_count(self) -> int:
        with self._lock:
            return sum(1 for r in self.replicas if r.state == PARKED)

    def states(self) -> dict[str, str]:
        with self._lock:
            return {r.tag: r.state for r in self.replicas}

    def park(self, rid: int | None = None) -> int | None:
        """Close one SERVING engine and release its slice — the same
        contract (and event/counter vocabulary) as
        :meth:`ReplicaSet.park`, including the floor of 1: the last
        serving engine is never parked, so a 1-unit family (OCR today)
        holds its ledger claim but can never be scaled to zero."""
        with self._lock:
            if self._closed:
                return None
            serving = [r for r in self.replicas if r.state == SERVING]
            if len(serving) <= 1:
                return None
            if rid is None:
                r = serving[-1]
            else:
                r = self.replicas[rid]
                if r.state != SERVING:
                    return None
            old, r.batcher = r.batcher, None
            r.state = PARKED
            r.error = None
        metrics.count("replica_parked")
        metrics.count(f"replica_parked:{self.name}")
        telemetry.record_event(
            "replica_park", f"{self.name}/{r.tag}",
            f"engine parked: {self.devices_per_replica} chip slice(s) "
            "released; sibling engines keep serving",
        )
        logger.info("%s: engine %s PARKED (scale-down)", self.name, r.tag)
        if old is not None:
            try:
                old.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                logger.exception("%s: closing parked engine %s failed", self.name, r.tag)
        return r.rid

    def unpark(self, rid: int | None = None) -> int | None:
        """Rebuild one PARKED engine through the build hook and return it
        to dispatch. No hook = no growth (the fleet only ever shrinks to
        its floor and back by operator restart)."""
        if self.build is None:
            return None
        with self._lock:
            if self._closed:
                return None
            parked = [r for r in self.replicas if r.state == PARKED]
            if not parked:
                return None
            if rid is None:
                r = parked[0]
            else:
                r = self.replicas[rid]
                if r.state != PARKED:
                    return None
            r.state = REVIVING
        try:
            fresh = self.build(r.rid)
        except Exception as e:  # noqa: BLE001 - rebuild failure keeps it parked
            with self._lock:
                r.state = PARKED
                r.error = f"unpark failed: {type(e).__name__}: {e}"
            metrics.count("replica_revive_failures")
            metrics.count(f"replica_revive_failures:{self.name}")
            logger.exception("%s: unpark of %s failed", self.name, r.tag)
            return None
        closed_late = False
        with self._lock:
            if self._closed:
                closed_late = True
            else:
                r.batcher = fresh
                r.state = SERVING
                r.error = None
        if closed_late:
            try:
                fresh.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
            return None
        metrics.count("replica_unparked")
        metrics.count(f"replica_unparked:{self.name}")
        telemetry.record_event(
            "replica_unpark", f"{self.name}/{r.tag}",
            f"parked engine rebuilt: {self.devices_per_replica} chip "
            "slice(s) claimed",
        )
        logger.info("%s: engine %s unparked (scale-up)", self.name, r.tag)
        return r.rid

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            snap = list(self.replicas)
        for r in snap:
            if r.batcher is not None:
                try:
                    r.batcher.close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    logger.exception("%s: closing engine %s failed", self.name, r.tag)
        metrics.unregister_gauges(f"replica:{self.name}", self._gauge_fn)
        with _fleet_reg_lock:
            ref = _fleet_registry.get(self.name)
            if ref is not None and ref() is self:
                del _fleet_registry[self.name]


def replica_states_of(*dispatchers) -> dict:
    """Per-fleet replica states keyed by dispatcher name — the shared body
    of every service's ``replica_states()`` hook (plain batchers and None
    slots are skipped; names are manager-scoped so multi-manager services
    never collide)."""
    return {
        d.name: d.states() for d in dispatchers if isinstance(d, ReplicaSet)
    }


def topology_extra(primary_mesh=None, *dispatchers) -> dict[str, str]:
    """Device topology + replica layout for a service's capability
    ``extra`` — so fleet-internal clients can pick endpoints without
    probing. ``primary_mesh`` is replica 0's mesh (or the family's only
    mesh); ``dispatchers`` are the family's batchers/ReplicaSets.
    ``device_count``: the host's CUDA devices (the mesh's own devices when
    it serves on the CPU)."""
    if primary_mesh is not None and primary_mesh.device.type != "cuda":
        count = len(primary_mesh.devices)
    else:
        count = torch.cuda.device_count()
    out = {"device_count": str(count)}
    if primary_mesh is not None:
        out["mesh_axes"] = ",".join(
            f"{k}={v}" for k, v in dict(primary_mesh.shape).items()
        )
        out["devices_per_replica"] = str(math.prod(dict(primary_mesh.shape).values()))
    fleet = next((d for d in dispatchers if isinstance(d, ReplicaSet)), None)
    if fleet is None:
        out["replicas"] = "1"
        return out
    states = fleet.states()
    out["replicas"] = str(len(fleet.replicas))
    out["replica_policy"] = fleet.policy.name
    # states() preserves rid order (r0, r1, ..., r10, ...); position i in
    # the joined string IS replica i — a lexicographic sort would misorder
    # fleets of 10+ replicas.
    out["replica_states"] = ",".join(states.values())
    return out

