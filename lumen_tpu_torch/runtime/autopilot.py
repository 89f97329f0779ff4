"""Autopilot: closed-loop self-healing capacity control over the telemetry spine.

PRs 7-9 built every sensor (SLO burn rates, duty-cycle meters, queue-drain
and padding-waste estimates) and every actuator (replica count, brownout
rungs, batch-window caps) a capacity controller needs — but a human read
``/stats`` and edited env knobs. This module closes the loop: a background
controller (``LUMEN_AUTOPILOT=1``; default OFF, so tier-1 and unconfigured
deployments are byte-for-byte unchanged) ticks every
``LUMEN_AUTOPILOT_TICK_S`` seconds and runs three independent control
loops over the live registries:

- **scale** — per-family replica scaling with cross-family chip
  reallocation. Sensors: each fleet's mean ``device:{batcher}`` duty
  fraction and worst queue-drain estimate over the last
  ``LUMEN_AUTOPILOT_SENSE_S`` seconds. Actuators:
  :meth:`~lumen_tpu_torch.runtime.fleet.ReplicaSet.park` /
  :meth:`~lumen_tpu_torch.runtime.fleet.ReplicaSet.unpark` — the fleet's
  replica-granular build/revive machinery. A **chip ledger** makes the
  reallocation honest: its capacity latches to the boot-time claim total
  (so the controller can only *move* slices between families, never
  overcommit), an idle family's park frees ``devices_per_replica`` chips,
  and a hot family's unpark only proceeds when the ledger has that many
  free. Cold families keep a floor of 1 serving replica (``park`` refuses
  the last one).
- **brownout** — descend/ascend the QoS brownout ladder from SLO burn
  instead of raw occupancy. Sensor: the worst task ``burn_5m`` from the
  SLO engine. Actuator: :meth:`WFQAdmissionQueue.force_rung` on every live
  admission queue (a floor — occupancy can still push the effective rung
  higher). Hysteresis band: descend above ``LUMEN_AUTOPILOT_BURN_DESCEND``
  (default 1.0 — burning budget faster than sustainable), ascend only
  below ``LUMEN_AUTOPILOT_BURN_ASCEND`` (default 0.5), one rung per
  actuation.
- **window** — auto-tune each batcher's adaptive-window cap from windowed
  padding-waste telemetry (``batch_padded / (batch_items+batch_padded)``):
  waste above ``LUMEN_AUTOPILOT_WASTE_PCT`` grows the cap (wait longer,
  fill fuller batches), waste clearing below a quarter of that shrinks it
  back toward the configured base; the cap never leaves
  ``[base, 4 x base]``.

**Stability contract.** Every loop actuates through one gate: a
per-actuator cooldown (``LUMEN_AUTOPILOT_COOLDOWN_S``) keyed ``(loop,
component)``, plus a global actuation rate limit
(``LUMEN_AUTOPILOT_RATE_PER_MIN``). Thresholds come in hysteresis
pairs (scale 0.75/0.20 duty, brownout 1.0/0.5 burn, window 30%/7.5%
waste), so an oscillating sensor crosses ONE threshold, not two — tier-1
proves no-flap under oscillation with a fake clock
(``tests/test_autopilot.py``). A loop with no sensor reading performs no
actuation (telemetry off = autopilot blind = autopilot inert), and each
loop has a manual-override knob (``LUMEN_AUTOPILOT_SCALE`` /
``_BROWNOUT`` / ``_WINDOW`` = ``0``) that disables its actuations while
the others keep running.

**Observability.** Every actuation lands in the flight recorder as a typed
event (``autopilot_scale`` / ``autopilot_brownout`` / ``autopilot_window``)
carrying the sensor readings that justified it, is counted on
``autopilot_actions(:loop)``, and is retained in a bounded decision ring
served by ``GET /autopilot`` on the observability sidecar (policy state,
per-loop enable flags, chip ledger, last N decisions). A compact summary
rides ``Health`` trailing metadata as ``lumen-autopilot-status``.

Deliberately duck-typed over the live registries
(:func:`~lumen_tpu_torch.runtime.fleet.live_fleets`,
:func:`~lumen_tpu_torch.runtime.batcher.live_batchers`,
:func:`~lumen_tpu_torch.utils.qos.live_queues`) and injectable for tests: a
fake-clock Autopilot with fake fleets ticks deterministically, no threads,
no device.

The port's copy of ``lumen_tpu/runtime/autopilot.py``: host code only; it
drives the port's fleet registries, the batcher's window retarget and the
QoS brownout rung.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable

from ..utils import telemetry
from ..utils.env import env_float, env_int
from ..utils.metrics import metrics

logger = logging.getLogger(__name__)

AUTOPILOT_ENV = "LUMEN_AUTOPILOT"
TICK_ENV = "LUMEN_AUTOPILOT_TICK_S"
COOLDOWN_ENV = "LUMEN_AUTOPILOT_COOLDOWN_S"
SENSE_ENV = "LUMEN_AUTOPILOT_SENSE_S"
RATE_ENV = "LUMEN_AUTOPILOT_RATE_PER_MIN"
DECISIONS_ENV = "LUMEN_AUTOPILOT_DECISIONS"
SCALE_UP_ENV = "LUMEN_AUTOPILOT_SCALE_UP"
SCALE_DOWN_ENV = "LUMEN_AUTOPILOT_SCALE_DOWN"
BURN_DESCEND_ENV = "LUMEN_AUTOPILOT_BURN_DESCEND"
BURN_ASCEND_ENV = "LUMEN_AUTOPILOT_BURN_ASCEND"
WASTE_ENV = "LUMEN_AUTOPILOT_WASTE_PCT"
PREDICT_ENV = "LUMEN_AUTOPILOT_PREDICT"
HORIZON_ENV = "LUMEN_AUTOPILOT_HORIZON_S"

#: per-loop manual-override knobs: ``0`` keeps that loop observing but
#: never actuating (the operator holds that actuator by hand).
LOOP_ENVS = {
    "scale": "LUMEN_AUTOPILOT_SCALE",
    "brownout": "LUMEN_AUTOPILOT_BROWNOUT",
    "window": "LUMEN_AUTOPILOT_WINDOW",
}

#: gRPC Health trailing-metadata key carrying the compact autopilot state.
AUTOPILOT_META_KEY = "lumen-autopilot-status"

#: replica-state strings shared with runtime/fleet.py — string literals so
#: this module (and its fakes) never import the fleet module (torch) at
#: import time.
_SERVING = "serving"
_PARKED = "parked"

#: minimum batch slots observed in the sense window before the window loop
#: trusts a padding-waste reading — two padded singletons are noise, not a
#: trend.
MIN_WINDOW_SLOTS = 16


def autopilot_enabled() -> bool:
    """``LUMEN_AUTOPILOT`` (default OFF): the master switch. Tier-1 runs
    with it unset — zero actuations and zero per-request overhead (the
    controller is a background tick, never on the request path)."""
    return os.environ.get(AUTOPILOT_ENV) == "1"


def autopilot_tick_s() -> float:
    """``LUMEN_AUTOPILOT_TICK_S``: controller tick period (default 5s)."""
    return env_float(TICK_ENV, 5.0, minimum=0.05)


def autopilot_cooldown_s() -> float:
    """``LUMEN_AUTOPILOT_COOLDOWN_S``: minimum seconds between two
    actuations of the SAME actuator (default 30) — the anti-flap floor."""
    return env_float(COOLDOWN_ENV, 30.0, minimum=0.0)


def autopilot_sense_s() -> float:
    """``LUMEN_AUTOPILOT_SENSE_S``: sensor window the duty/waste readings
    aggregate over (default 30s; longer = calmer, shorter = twitchier)."""
    return env_float(SENSE_ENV, 30.0, minimum=1.0)


def autopilot_rate_per_min() -> int:
    """``LUMEN_AUTOPILOT_RATE_PER_MIN``: global cap on actuations per
    rolling minute across ALL loops (default 12) — a runaway controller
    can only misconfigure the fleet this fast."""
    return env_int(RATE_ENV, 12, minimum=1)


def autopilot_decisions() -> int:
    """``LUMEN_AUTOPILOT_DECISIONS``: decision-ring capacity on
    ``GET /autopilot`` (default 64)."""
    return env_int(DECISIONS_ENV, 64, minimum=1)


def autopilot_predict() -> bool:
    """``LUMEN_AUTOPILOT_PREDICT`` (default OFF): arms short-horizon
    arrival-rate forecasting in the scale loop. The trend is fit over the
    per-bucket ``batch_items`` rates already in the telemetry rings and
    extrapolated ``LUMEN_AUTOPILOT_HORIZON_S`` ahead; the park/unpark
    gates then act on the WORSE of current and projected duty, so a
    rising family unparks before the reactive threshold trips. Off keeps
    the reactive thresholds (and the sensor readings) byte-identical."""
    return os.environ.get(PREDICT_ENV) == "1"


def autopilot_horizon_s() -> float:
    """``LUMEN_AUTOPILOT_HORIZON_S``: how far ahead the arrival-rate
    trend is extrapolated (default 60s — about one replica unpark's
    build+warmup cost, so the forecast leads by what acting costs)."""
    return env_float(HORIZON_ENV, 60.0, minimum=1.0)


def loop_enabled(loop: str) -> bool:
    """Per-loop manual override (:data:`LOOP_ENVS`): setting the loop's
    knob to ``0`` disables its actuations while the other loops keep
    running (default on when the autopilot itself is)."""
    return os.environ.get(LOOP_ENVS[loop], "1") != "0"


class Autopilot:
    """The three-loop capacity controller.

    ``tick()`` is the whole control step and is side-effect-deterministic
    under an injected clock — tests drive it directly; production wraps it
    in a daemon thread (:meth:`start`). Sources are injectable callables
    returning the live fleets / batchers / admission queues; the defaults
    read the process registries lazily (so building an Autopilot never
    imports the torch-bound modules)."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        tick_s: float | None = None,
        cooldown_s: float | None = None,
        sense_s: float | None = None,
        rate_per_min: int | None = None,
        chip_capacity: int | None = None,
        fleets: Callable[[], list] | None = None,
        batchers: Callable[[], list] | None = None,
        queues: Callable[[], list] | None = None,
        predict: bool | None = None,
        horizon_s: float | None = None,
    ):
        self._clock = clock
        self.predict = autopilot_predict() if predict is None else bool(predict)
        self.horizon_s = (
            autopilot_horizon_s() if horizon_s is None else max(1.0, horizon_s)
        )
        self.tick_s = autopilot_tick_s() if tick_s is None else max(0.05, tick_s)
        self.cooldown_s = autopilot_cooldown_s() if cooldown_s is None else max(0.0, cooldown_s)
        self.sense_s = autopilot_sense_s() if sense_s is None else max(1.0, sense_s)
        self.rate_per_min = (
            autopilot_rate_per_min() if rate_per_min is None else max(1, rate_per_min)
        )
        # Ledger capacity: explicit, or latched from the first observed
        # claim total (see _tick_scale) — conservation-only reallocation.
        self.chip_capacity = chip_capacity
        self._fleets = fleets if fleets is not None else _default_fleets
        self._batchers = batchers if batchers is not None else _default_batchers
        self._queues = queues if queues is not None else _default_queues
        # Loop enables are latched at build (env is deploy-time config;
        # reset_autopilot()/a restart re-reads).
        self.loops = {name: loop_enabled(name) for name in LOOP_ENVS}
        self.scale_up_duty = env_float(SCALE_UP_ENV, 0.75, minimum=0.0, maximum=1.0)
        self.scale_down_duty = env_float(SCALE_DOWN_ENV, 0.20, minimum=0.0, maximum=1.0)
        if self.scale_down_duty >= self.scale_up_duty:
            # A collapsed/inverted hysteresis band would flap by
            # construction; restore the default band loudly.
            logger.warning(
                "%s=%.2f >= %s=%.2f collapses the scale hysteresis band; "
                "using defaults 0.20/0.75",
                SCALE_DOWN_ENV, self.scale_down_duty, SCALE_UP_ENV, self.scale_up_duty,
            )
            self.scale_up_duty, self.scale_down_duty = 0.75, 0.20
        self.burn_descend = env_float(BURN_DESCEND_ENV, 1.0, minimum=0.0)
        self.burn_ascend = env_float(BURN_ASCEND_ENV, 0.5, minimum=0.0)
        if self.burn_ascend >= self.burn_descend:
            logger.warning(
                "%s=%.2f >= %s=%.2f collapses the brownout hysteresis band; "
                "using defaults 0.5/1.0",
                BURN_ASCEND_ENV, self.burn_ascend, BURN_DESCEND_ENV, self.burn_descend,
            )
            self.burn_descend, self.burn_ascend = 1.0, 0.5
        self.waste_grow_pct = env_float(WASTE_ENV, 30.0, minimum=0.1, maximum=99.0)

        self._lock = threading.Lock()
        self.decisions: deque[dict] = deque(maxlen=autopilot_decisions())
        self._last_act: dict[tuple[str, str], float] = {}
        self._act_times: deque[float] = deque()
        self._rung = 0  # the ladder floor this controller currently holds
        self._last_sensors: dict[str, Any] = {}
        self.ticks = 0
        self.actuations = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- stability gate ----------------------------------------------------

    def _may_act(self, loop: str, component: str, now: float) -> bool:
        """Cooldown (per actuator) + global rate limit, both against the
        injected clock. Pure check — :meth:`_record` commits."""
        last = self._last_act.get((loop, component))
        if last is not None and now - last < self.cooldown_s:
            return False
        while self._act_times and now - self._act_times[0] > 60.0:
            self._act_times.popleft()
        return len(self._act_times) < self.rate_per_min

    def _record(
        self, loop: str, component: str, action: str, reason: str,
        sensors: dict, now: float,
    ) -> dict:
        self._last_act[(loop, component)] = now
        self._act_times.append(now)
        decision = {
            "unix_ms": round(time.time() * 1e3, 1),
            "loop": loop,
            "component": component,
            "action": action,
            "reason": reason,
            "sensors": sensors,
        }
        with self._lock:
            self.actuations += 1
            self.decisions.append(decision)
        metrics.count("autopilot_actions")
        metrics.count(f"autopilot_actions:{loop}")
        telemetry.record_event(
            f"autopilot_{loop}", component, f"{action}: {reason}",
            sensors=sensors, action=action,
        )
        return decision

    # -- the control step --------------------------------------------------

    def tick(self) -> list[dict]:
        """One control evaluation across all enabled loops; returns the
        actuations made (possibly empty). Exceptions never escape — a
        controller that can crash its serving process is worse than no
        controller."""
        now = self._clock()
        made: list[dict] = []
        with self._lock:
            self.ticks += 1
        for name, fn in (
            ("scale", self._tick_scale),
            ("brownout", self._tick_brownout),
            ("window", self._tick_window),
        ):
            if not self.loops[name]:
                continue
            try:
                fn(now, made)
            except Exception:  # noqa: BLE001 - the loop must outlive a bad tick
                logger.exception("autopilot %s loop failed this tick", name)
        return made

    # -- loop 1: replica scaling + chip reallocation -----------------------

    def _fleet_readings(self, fleets: list, now: float) -> dict[str, dict]:
        readings: dict[str, dict] = {}
        for fs in fleets:
            duties: list[float] = []
            drain = 0.0
            queued = 0
            rate = forecast = 0.0
            saw_forecast = False
            for r in fs.replicas:
                b = r.batcher
                if r.state != _SERVING or b is None:
                    continue
                d = telemetry.duty_fraction(f"device:{b.name}", self.sense_s)
                if d is not None:
                    duties.append(d)
                # Engine fleets dispatch without a MicroBatcher queue, so
                # there is no drain estimator to read — treat as no
                # backlog rather than requiring the method.
                est_fn = getattr(b, "drain_estimate_s", None)
                est = est_fn() if est_fn is not None else None
                if est is not None:
                    drain = max(drain, est)
                queued += b.load()
                if self.predict:
                    cur = telemetry.window_total(
                        f"batch_items:{b.name}", self.sense_s
                    ) / self.sense_s
                    f = telemetry.forecast_rate(
                        f"batch_items:{b.name}", self.sense_s, self.horizon_s
                    )
                    rate += cur
                    if f is not None:
                        forecast += f
                        saw_forecast = True
            active = sum(1 for r in fs.replicas if r.state == _SERVING)
            parked = sum(1 for r in fs.replicas if r.state == _PARKED)
            readings[fs.name] = {
                "duty": round(sum(duties) / len(duties), 4) if duties else None,
                "drain_s": round(drain, 3),
                "queued": queued,
                "active": active,
                "parked": parked,
                # Chip-holding replicas: everything NOT parked. A DOWN or
                # REVIVING replica never released its mesh slice (only
                # park() frees chips), so it must keep its claim in the
                # ledger — or an unpark during an outage would
                # double-allocate the slice the revive is about to reuse.
                "holding": len(fs.replicas) - parked,
                "chips_per_replica": fs.devices_per_replica,
            }
            if self.predict:
                # Predictive keys exist ONLY with the knob on — the
                # unconfigured sensor dict (and every event built from it)
                # stays byte-identical. projected_duty scales the measured
                # duty by the forecast/current arrival ratio, clamped so a
                # noisy fit can neither zero the signal nor 100x it.
                duty = readings[fs.name]["duty"]
                proj = None
                if saw_forecast and rate > 0 and duty is not None:
                    ratio = max(0.25, min(4.0, forecast / rate))
                    proj = round(min(1.0, duty * ratio), 4)
                readings[fs.name]["rate_rps"] = round(rate, 3)
                readings[fs.name]["forecast_rps"] = (
                    round(forecast, 3) if saw_forecast else None
                )
                readings[fs.name]["projected_duty"] = proj
        return readings

    def _tick_scale(self, now: float, made: list[dict]) -> None:
        fleets = self._fleets()
        readings = self._fleet_readings(fleets, now)
        claimed = sum(
            r["holding"] * r["chips_per_replica"] for r in readings.values()
        )
        if self.chip_capacity is None and fleets:
            # Latch the ledger to the boot-time claim total: from here the
            # controller can only REALLOCATE slices between families —
            # never grow the fleet past what boot placed on the chips.
            self.chip_capacity = claimed
            logger.info(
                "autopilot chip ledger latched at %d slice-chip(s) across "
                "%d fleet(s)", claimed, len(fleets),
            )
        with self._lock:
            self._last_sensors["scale"] = readings
            if self.chip_capacity is not None:
                self._last_sensors["chips"] = {
                    "capacity": self.chip_capacity, "claimed": claimed,
                }
        if not fleets or self.chip_capacity is None:
            return
        free = self.chip_capacity - claimed
        # Scale DOWN first — an idle family releases the slice a hot
        # sibling claims in the SAME tick, so reallocation converges in
        # one controller window instead of two.
        for fs in fleets:
            r = readings[fs.name]
            duty = r["duty"]
            if duty is None:  # no sensor -> no actuation
                continue
            # Predictive gate: act on the WORSE of measured and projected
            # duty. A rising trend blocks the park (the chips are about to
            # be needed) and trips the unpark early; a falling trend never
            # parks ahead of the measurement — scale-down stays reactive,
            # so a forecast can cost capacity margin only upward.
            eff = duty
            proj = r.get("projected_duty")
            if proj is not None:
                eff = max(duty, proj)
            if eff >= self.scale_down_duty or r["drain_s"] > self.tick_s:
                continue
            if r["active"] <= 1 or not self._may_act("scale", fs.name, now):
                continue
            rid = fs.park()
            if rid is None:
                continue
            free += fs.devices_per_replica
            made.append(self._record(
                "scale", fs.name, f"park r{rid}",
                f"duty {duty:.2f} < {self.scale_down_duty:.2f} and no "
                f"backlog: released {fs.devices_per_replica} chip(s)",
                {**r, "free_chips": free}, now,
            ))
        # Scale UP, hottest first, gated by the ledger.
        hot = sorted(
            (fs for fs in fleets if readings[fs.name]["duty"] is not None),
            key=lambda fs: readings[fs.name]["duty"],
            reverse=True,
        )
        for fs in hot:
            r = readings[fs.name]
            eff = r["duty"]
            proj = r.get("projected_duty")
            if proj is not None:
                eff = max(eff, proj)
            pressured = (
                eff > self.scale_up_duty
                or r["drain_s"] > 2.0 * self.tick_s
            )
            if not pressured or r["parked"] <= 0:
                continue
            if free < fs.devices_per_replica:
                continue  # ledger empty: no sibling has released a slice
            if not self._may_act("scale", fs.name, now):
                continue
            rid = fs.unpark()
            if rid is None:
                continue
            free -= fs.devices_per_replica
            made.append(self._record(
                "scale", fs.name, f"unpark r{rid}",
                f"duty {r['duty']:.2f} / drain {r['drain_s']:.2f}s over "
                f"threshold: claimed {fs.devices_per_replica} free chip(s)",
                {**r, "free_chips": free}, now,
            ))

    # -- loop 2: SLO-burn-driven brownout ----------------------------------

    def _tick_brownout(self, now: float, made: list[dict]) -> None:
        slo = telemetry.slo_status()
        burn5 = burn1h = None
        worst = None
        for task, rec in slo.items():
            b5 = rec.get("burn_5m", 0.0)
            if burn5 is None or b5 > burn5:
                burn5, worst = b5, task
                burn1h = rec.get("burn_1h", 0.0)
        with self._lock:
            self._last_sensors["brownout"] = {
                "burn_5m": burn5, "burn_1h": burn1h, "task": worst,
                "rung": self._rung,
            }
        if burn5 is None:
            if self._rung > 0:
                # Objectives went away mid-hold (env reset): still keep
                # newly-built queues on the held floor until it releases.
                self._apply_rung()
            return  # no SLO objectives (or no traffic): nothing to steer by
        sensors = {
            "burn_5m": burn5, "burn_1h": burn1h, "task": worst,
            "rung": self._rung,
        }
        if (
            burn5 > self.burn_descend and self._rung < 2
            and self._may_act("brownout", "ladder", now)
        ):
            self._rung += 1
            made.append(self._record(
                "brownout", "ladder", f"descend to rung {self._rung}",
                f"{worst} burn_5m {burn5:.2f} > {self.burn_descend:.2f}: "
                "error budget burning faster than sustainable",
                sensors, now,
            ))
        elif (
            burn5 <= self.burn_ascend and self._rung > 0
            and self._may_act("brownout", "ladder", now)
        ):
            self._rung -= 1
            made.append(self._record(
                "brownout", "ladder", f"ascend to rung {self._rung}",
                f"burn_5m {burn5:.2f} <= {self.burn_ascend:.2f}: budget "
                "recovered",
                sensors, now,
            ))
        # Re-assert the (possibly just-changed) floor EVERY tick —
        # including ticks where cooldown/rate-limit blocked a transition —
        # so queues built since the last tick (a revive or unpark builds a
        # fresh batcher+queue) inherit the held rung within one tick.
        self._apply_rung()

    def _apply_rung(self) -> None:
        rung = self._rung
        for q in self._queues():
            try:
                q.force_rung(rung if rung > 0 else None)
            except Exception:  # noqa: BLE001 - one bad queue must not stop the rest
                logger.exception("autopilot: force_rung failed on %s", getattr(q, "name", q))

    # -- loop 3: batch-window auto-tune ------------------------------------

    def _tick_window(self, now: float, made: list[dict]) -> None:
        waste_view: dict[str, dict] = {}
        for b in self._batchers():
            base = getattr(b, "base_window_cap_s", 0.0)
            if base <= 0:
                continue  # nothing to tune: the window is pinned at 0
            if getattr(b, "adaptive", True) is False:
                # A fixed-window batcher (LUMEN_BATCH_ADAPTIVE=0) never
                # reads window_cap_s: actuating it would burn rate-limit
                # budget on recorded no-ops.
                continue
            items = telemetry.window_total(f"batch_items:{b.name}", self.sense_s)
            padded = telemetry.window_total(f"batch_padded:{b.name}", self.sense_s)
            slots = items + padded
            if slots < MIN_WINDOW_SLOTS:
                continue  # too little traffic for the reading to mean anything
            waste = 100.0 * padded / slots
            cap = b.window_cap_s
            waste_view[b.name] = {
                "waste_pct": round(waste, 1),
                "cap_ms": round(cap * 1e3, 2),
                "base_ms": round(base * 1e3, 2),
            }
            sensors = {
                **waste_view[b.name],
                "items": int(items), "padded": int(padded),
            }
            if waste > self.waste_grow_pct and cap < base * 4:
                if not self._may_act("window", b.name, now):
                    continue
                new = b.set_window_cap_s(min(base * 4, max(cap, base) * 1.5))
                made.append(self._record(
                    "window", b.name,
                    f"grow cap {cap * 1e3:.1f} -> {new * 1e3:.1f}ms",
                    f"padding waste {waste:.1f}% > {self.waste_grow_pct:.0f}%: "
                    "wait longer to fill fuller batches",
                    sensors, now,
                ))
            elif waste < self.waste_grow_pct / 4 and cap > base:
                if not self._may_act("window", b.name, now):
                    continue
                new = b.set_window_cap_s(max(base, cap / 1.5))
                made.append(self._record(
                    "window", b.name,
                    f"shrink cap {cap * 1e3:.1f} -> {new * 1e3:.1f}ms",
                    f"padding waste {waste:.1f}% cleared: give the latency "
                    "back",
                    sensors, now,
                ))
        with self._lock:
            self._last_sensors["window"] = waste_view

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Autopilot":
        """Run ``tick()`` on a daemon thread every ``tick_s`` seconds."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="autopilot", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - belt over tick()'s own braces
                logger.exception("autopilot tick failed")

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        # Return the ladder to occupancy control: a stopped controller
        # must not leave a forced brownout floor behind.
        if self._rung != 0:
            self._rung = 0
            self._apply_rung()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- export ------------------------------------------------------------

    def status(self) -> dict:
        """The ``GET /autopilot`` body: policy/knob state, per-loop enable
        flags + latest sensor readings, the chip ledger, and the decision
        ring (newest last)."""
        with self._lock:
            decisions = list(self.decisions)
            sensors = dict(self._last_sensors)
            ticks, acts = self.ticks, self.actuations
        scale_loop: dict[str, Any] = {
            "enabled": self.loops["scale"],
            "up_duty": self.scale_up_duty,
            "down_duty": self.scale_down_duty,
            "families": sensors.get("scale", {}),
        }
        if self.predict:
            # Predictive keys only when armed — the unconfigured body
            # stays byte-identical.
            scale_loop["predict"] = True
            scale_loop["horizon_s"] = self.horizon_s
        return {
            "enabled": True,
            "running": self.running,
            "tick_s": self.tick_s,
            "cooldown_s": self.cooldown_s,
            "sense_window_s": self.sense_s,
            "rate_limit_per_min": self.rate_per_min,
            "ticks": ticks,
            "actuations": acts,
            "chips": sensors.get("chips", {"capacity": self.chip_capacity}),
            "loops": {
                "scale": scale_loop,
                "brownout": {
                    "enabled": self.loops["brownout"],
                    "rung": self._rung,
                    "burn_descend": self.burn_descend,
                    "burn_ascend": self.burn_ascend,
                    "sensors": sensors.get("brownout", {}),
                },
                "window": {
                    "enabled": self.loops["window"],
                    "waste_grow_pct": self.waste_grow_pct,
                    "batchers": sensors.get("window", {}),
                },
            },
            "decisions": decisions,
        }

    def health_summary(self) -> dict:
        """Compact state for the ``lumen-autopilot-status`` Health key."""
        with self._lock:
            last = self.decisions[-1] if self.decisions else None
            acts = self.actuations
        out: dict[str, Any] = {
            "running": self.running,
            "loops": {k: ("on" if v else "off") for k, v in self.loops.items()},
            "rung": self._rung,
            "actuations": acts,
        }
        if last is not None:
            out["last"] = {
                "loop": last["loop"], "component": last["component"],
                "action": last["action"],
            }
        return out


# -- default registry sources (lazy: never imported at module import) ---------


def _default_fleets() -> list:
    from .fleet import live_fleets

    return live_fleets()


def _default_batchers() -> list:
    from .batcher import live_batchers

    return live_batchers()


def _default_queues() -> list:
    from ..utils.qos import live_queues

    return live_queues()


# -- process-wide instance ----------------------------------------------------

_autopilot: Autopilot | None = None
_autopilot_lock = threading.Lock()
_boot_logged = False


def get_autopilot() -> Autopilot | None:
    return _autopilot


def install_autopilot(ap: Autopilot | None) -> Autopilot | None:
    """Swap the process autopilot (tests); returns the previous one."""
    global _autopilot
    with _autopilot_lock:
        old, _autopilot = _autopilot, ap
    return old


def reset_autopilot() -> None:
    """Stop and drop the shared controller (tests / re-boot)."""
    global _boot_logged
    old = install_autopilot(None)
    _boot_logged = False
    if old is not None:
        old.stop()


def maybe_start_autopilot() -> Autopilot | None:
    """Server-boot hook: build+start the controller when
    ``LUMEN_AUTOPILOT=1``, else log the off state once and do nothing.
    Either way exactly one boot-log line says whether the fleet is
    self-driving — a deploy-time fact an operator should not probe for."""
    global _boot_logged
    if not autopilot_enabled():
        if not _boot_logged:
            _boot_logged = True
            logger.info(
                "autopilot off (set LUMEN_AUTOPILOT=1 for closed-loop "
                "scaling/brownout/window control)"
            )
        return None
    ap = Autopilot()
    install_autopilot(ap)
    ap.start()
    if not _boot_logged:
        _boot_logged = True
        logger.info(
            "autopilot ON (tick=%.1fs cooldown=%.0fs sense=%.0fs "
            "rate<=%d/min; loops: %s%s)",
            ap.tick_s, ap.cooldown_s, ap.sense_s, ap.rate_per_min,
            ",".join(k for k, v in ap.loops.items() if v) or "none",
            f"; predictive horizon={ap.horizon_s:.0f}s" if ap.predict else "",
        )
    return ap


def export_status() -> dict:
    """The ``GET /autopilot`` body regardless of state — an off autopilot
    still answers (enabled flag + empty ring), so probes need no 404
    handling."""
    ap = _autopilot
    if ap is None:
        return {
            "enabled": autopilot_enabled(),
            "running": False,
            "loops": {},
            "decisions": [],
        }
    return ap.status()


def health_status() -> dict:
    """Body of the ``lumen-autopilot-status`` Health trailing-metadata key
    (``{}`` when no controller is installed — the key is then omitted, the
    same contract as the qos/slo keys)."""
    ap = _autopilot
    if ap is None:
        return {}
    return ap.health_summary()
