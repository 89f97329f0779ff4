"""The port's autopilot (``runtime/autopilot.py``) held against the JAX
package's, on fake clocks and fakes of the port's fleet and batcher.

Each case of ``tests/test_autopilot.py`` copied here runs on both
packages (each with its own telemetry hub, admission queues and metrics)
with the same fakes and sensors, and must make the same decisions: the
scale loop's reallocation, floor, ledger and cooldown; the brownout
ladder's hysteresis on real admission queues; the window loop's growth
and return; the per-loop override; the disabled path; ``/autopilot`` and
the ``Health`` summary. The port's real ``MicroBatcher`` and
``ReplicaSet`` expose every method the controller calls, and the window
loop retargets a real port batcher.
"""

from __future__ import annotations

import json
import urllib.request
from types import SimpleNamespace

import pytest

from lumen_tpu.runtime import autopilot as jap
from lumen_tpu.serving import observability as jobs
from lumen_tpu.serving import router as jrouter
from lumen_tpu.utils import qos as jqos
from lumen_tpu.utils import telemetry as jtele
from lumen_tpu.utils.metrics import metrics as jmetrics
from lumen_tpu_torch.runtime import autopilot as pap
from lumen_tpu_torch.serving import observability as pobs
from lumen_tpu_torch.serving import router as prouter
from lumen_tpu_torch.utils import qos as pqos
from lumen_tpu_torch.utils import telemetry as ptele
from lumen_tpu_torch.utils.metrics import metrics as pmetrics
from test_autopilot import FakeBatcher, FakeClock, FakeFleet

PKGS = {
    "jax": SimpleNamespace(ap=jap, tele=jtele, qos=jqos, metrics=jmetrics, router=jrouter, obs=jobs),
    "port": SimpleNamespace(ap=pap, tele=ptele, qos=pqos, metrics=pmetrics, router=prouter, obs=pobs),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def clock():
    return FakeClock()


@pytest.fixture()
def hub(pkg, clock):
    h = pkg.tele.TelemetryHub(clock=clock)
    pkg.tele.install_hub(h)
    yield h
    pkg.tele.reset_hub()


def make_ap(pkg, clock, **kw):
    kw.setdefault("tick_s", 1.0)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("sense_s", 30.0)
    kw.setdefault("fleets", lambda: [])
    kw.setdefault("batchers", lambda: [])
    kw.setdefault("queues", lambda: [])
    return pkg.ap.Autopilot(clock=clock, **kw)


def busy_for(hub, clock, name: str, frac: float, span: float = 30.0):
    hub.set_capacity(name, 1.0, union=True)
    if frac > 0:
        hub.busy(name, clock.t - span * frac, clock.t)


def burn(monkeypatch, pkg, values):
    """``slo_status()`` yielding successive ``burn_5m`` readings (the last
    one repeats)."""
    it = iter(values)
    state = {"cur": values[0]}

    def fake_slo():
        state["cur"] = next(it, state["cur"])
        return {"ap_task": {"burn_5m": state["cur"], "burn_1h": 0.2, "state": "ok"}}

    monkeypatch.setattr(pkg.tele, "slo_status", fake_slo)


def test_traffic_shift_reallocates_chips_in_one_tick(pkg, hub, clock):
    a = FakeFleet("fam-a", active=2)
    b = FakeFleet("fam-b", active=1, parked=1)
    ap = make_ap(pkg, clock, fleets=lambda: [a, b])
    busy_for(hub, clock, "device:fam-a-r0", 0.0)
    busy_for(hub, clock, "device:fam-a-r1", 0.0)
    busy_for(hub, clock, "device:fam-b-r0", 0.95)
    acts = [(d["loop"], d["component"], d["action"]) for d in ap.tick()]
    assert ("scale", "fam-a", "park r1") in acts and ("scale", "fam-b", "unpark r1") in acts
    assert a._count("serving") == 1 and b._count("serving") == 2 and ap.chip_capacity == 3


def test_floor_ledger_and_cooldown(pkg, hub, clock):
    lone = FakeFleet("fam-l", active=1)
    ap = make_ap(pkg, clock, cooldown_s=0.0, fleets=lambda: [lone])
    busy_for(hub, clock, "device:fam-l-r0", 0.0)
    for _ in range(3):
        ap.tick()
        clock.advance(5)
    assert lone.parks == []  # the floor of one is never parked
    a = FakeFleet("fam-a", active=3)
    other = FakeFleet("fam-z", active=1)
    ap = make_ap(pkg, clock, cooldown_s=10.0, fleets=lambda: [a, other])
    for i in range(3):
        busy_for(hub, clock, f"device:fam-a-r{i}", 0.0)
    busy_for(hub, clock, "device:fam-z-r0", 0.0)
    ap.tick()
    clock.advance(5)
    ap.tick()
    assert a.parks == [2]  # inside the cooldown
    clock.advance(6)
    ap.tick()
    assert a.parks == [2, 1]


def test_brownout_descends_and_ascends_with_hysteresis(pkg, monkeypatch, hub, clock):
    q = pkg.qos.WFQAdmissionQueue(name="ap-q", max_queue=100)
    burn(monkeypatch, pkg, [2.0, 2.0, 0.3, 0.3])
    ap = make_ap(pkg, clock, cooldown_s=1.0, queues=lambda: [q])
    rungs = []
    for _ in range(4):
        ap.tick()
        rungs.append(q.effective_rung())
        clock.advance(2)
    assert rungs == [1, 2, 1, 0]
    with pkg.qos.qos_context("t", "bulk"):
        q.put(("x", None, None, None))  # bulk admits again


def test_brownout_never_flaps_inside_the_band(pkg, monkeypatch, hub, clock):
    burn(monkeypatch, pkg, [1.1, 0.9] * 40)
    ap = make_ap(pkg, clock, cooldown_s=1.0)
    actions = []
    for _ in range(80):
        actions.extend(d["action"] for d in ap.tick())
        clock.advance(2)
    assert all(a.startswith("descend") for a in actions) and len(actions) <= 2


def test_window_grows_on_waste_then_returns(pkg, hub, clock):
    b = FakeBatcher("wb", base_cap_s=0.010)
    ap = make_ap(pkg, clock, cooldown_s=1.0, batchers=lambda: [b])
    hub.count("batch_items:wb", 40)
    hub.count("batch_padded:wb", 40)
    made = ap.tick()
    assert len(made) == 1 and made[0]["loop"] == "window" and b.window_cap_s == pytest.approx(0.015)
    for _ in range(8):
        clock.advance(2)
        hub.count("batch_items:wb", 40)
        hub.count("batch_padded:wb", 40)
        ap.tick()
    assert b.window_cap_s <= 0.040 + 1e-9
    for _ in range(8):
        clock.advance(40)
        hub.count("batch_items:wb", 200)
        ap.tick()
    assert b.window_cap_s == pytest.approx(b.base_window_cap_s)


def test_override_holds_one_loop(pkg, monkeypatch, hub, clock):
    monkeypatch.setenv("LUMEN_AUTOPILOT_SCALE", "0")
    a = FakeFleet("fam-a", active=3)
    busy_for(hub, clock, "device:fam-a-r0", 0.0)
    b = FakeBatcher("wb3", base_cap_s=0.010)
    hub.count("batch_items:wb3", 40)
    hub.count("batch_padded:wb3", 40)
    made = make_ap(pkg, clock, cooldown_s=0.0, fleets=lambda: [a], batchers=lambda: [b]).tick()
    assert a.parks == [] and {d["loop"] for d in made} == {"window"}


def test_disabled_autopilot_is_never_built(pkg, monkeypatch):
    monkeypatch.delenv("LUMEN_AUTOPILOT", raising=False)
    pkg.ap.reset_autopilot()
    assert pkg.ap.maybe_start_autopilot() is None and pkg.ap.get_autopilot() is None
    assert pkg.ap.export_status() == {"enabled": False, "running": False, "loops": {}, "decisions": []}
    assert pkg.ap.health_status() == {}


def test_start_and_stop_release_a_held_rung(pkg, monkeypatch, hub, clock):
    monkeypatch.setenv("LUMEN_AUTOPILOT", "1")
    monkeypatch.setenv("LUMEN_AUTOPILOT_TICK_S", "30")
    pkg.ap.reset_autopilot()
    ap = pkg.ap.maybe_start_autopilot()
    try:
        assert ap is not None and ap.running and pkg.ap.get_autopilot() is ap
        q = pkg.qos.WFQAdmissionQueue(name="ap-stop-q", max_queue=10)
        ap._queues = lambda: [q]
        ap._rung = 2
        ap._apply_rung()
        assert q.effective_rung() == 2
    finally:
        pkg.ap.reset_autopilot()
    assert not ap.running and q.effective_rung() == 0


def test_endpoint_health_and_router_summary(pkg, hub, clock):
    a = FakeFleet("fam-http", active=2)
    busy_for(hub, clock, "device:fam-http-r0", 0.0)
    busy_for(hub, clock, "device:fam-http-r1", 0.0)
    ap = make_ap(pkg, clock, cooldown_s=0.0, fleets=lambda: [a])
    ap.tick()
    old = pkg.ap.install_autopilot(ap)
    server = pkg.obs.MetricsServer(port=0)
    port = server.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/autopilot", timeout=10) as r:
            out = json.loads(r.read().decode())
        assert out["enabled"] and out["ticks"] == 1 and out["chips"]["capacity"] == 2
        assert pkg.ap.health_status()["last"]["loop"] == "scale"
        assert pkg.router.HubRouter._autopilot_state()["loops"] == {"scale": "on", "brownout": "on", "window": "on"}
    finally:
        server.stop()
        pkg.ap.install_autopilot(old)


def test_port_fleet_and_batcher_expose_what_the_controller_calls():
    """Duck-typing contract: the port's real ``ReplicaSet`` and
    ``MicroBatcher`` carry every attribute and method the autopilot
    reads or actuates, and the window loop retargets a real port batcher
    (the same call ``runtime/batcher.py``'s retarget serves)."""
    from lumen_tpu_torch.runtime.batcher import MicroBatcher, live_batchers
    from lumen_tpu_torch.runtime.fleet import ReplicaSet

    for attr in ("park", "unpark", "replicas", "name", "devices_per_replica"):
        assert hasattr(ReplicaSet, attr) or attr in ReplicaSet.__init__.__code__.co_names
    clock = FakeClock()
    hub = ptele.TelemetryHub(clock=clock)
    ptele.install_hub(hub)
    b = MicroBatcher(lambda batch, n: batch, max_batch=8, max_latency_ms=10.0, name="ap-real")
    b.start()
    try:
        for attr in ("base_window_cap_s", "window_cap_s", "set_window_cap_s", "drain_estimate_s", "load"):
            assert hasattr(b, attr)
        assert b in live_batchers()
        ap = make_ap(PKGS["port"], clock, cooldown_s=1.0, batchers=lambda: [b])
        hub.count("batch_items:ap-real", 40)
        hub.count("batch_padded:ap-real", 40)
        (made,) = ap.tick()
        assert made["loop"] == "window" and b.window_cap_s == pytest.approx(1.5 * b.base_window_cap_s)
    finally:
        b.close()
        ptele.reset_hub()
