"""The VLM int8 route of the port held against the JAX package's (the
twin of ``tests/test_vlm_quant.py::TestQ8RouteGate``).

On the JAX suite's tiny VLM directory in float32 on the CPU, with the
timing of the warm-up A/B monkeypatched where a verdict must be
deterministic:

- ``LUMEN_VLM_Q8_ROUTE=bf16`` skips quantization, ``int8`` serves int8
  without timing, ``auto`` without ``warmup`` honours the opt-in, a
  malformed value warns and means ``auto``;
- under ``auto`` + ``warmup`` a forced slower q8 falls back to bf16 on
  both packages (``vlm_q8_fallbacks`` counted, the ``vlm-quant:<model>``
  gauges equal), a faster one serves int8;
- the verdict file one package writes, the other reads without a probe;
  a stale or corrupt file measures again; a pin ignores the file;
- the served int8 route answers greedy requests as the JAX int8 route
  does, on either ``LUMEN_Q8_KERNEL``;
- the real A/B times the decode program the scheduler serves with (the
  engine's ``step_block``, the coalescer's fused ``generate``) and frees
  its placements.
"""

from __future__ import annotations

import json
import logging
import os

import pytest

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu.utils.metrics import metrics as jax_metrics
from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
from lumen_tpu_torch.models.vlm.generate import Generator
from lumen_tpu_torch.ops.quant import QDense
from lumen_tpu_torch.serving.services.vlm_service import VlmService
from lumen_tpu_torch.utils.env import _reset_warnings
from lumen_tpu_torch.utils.metrics import metrics as port_metrics
from test_vlm import make_vlm_model_dir

KW = dict(dtype="float32", max_seq=128, max_new_cap=8, prefill_buckets=(16, 32))
VERDICT = ".lumen_q8_verdict.json"


@pytest.fixture
def model_dir(tmp_path):
    return make_vlm_model_dir(tmp_path)


def jax_boot(model_dir, **kw):
    mgr = JVLMManager(model_dir, quantize="int8", **KW, **kw)
    mgr.initialize()
    return mgr


def port_boot(model_dir, **kw):
    return VLMManager.from_model_dir(model_dir, device="cpu", quantize="int8", **KW, **kw)


def fake_timing(monkeypatch, q8_tps: float, probes: list):
    """bf16 decodes at 100 tokens/s, q8 at ``q8_tps``, on both packages."""

    def jax_time(self, model, cfg, params, quantized):
        probes.append(("jax", quantized))
        return q8_tps if quantized else 100.0

    def port_time(self, cfg, decoder_state):
        quantized = cfg.decoder.weight_quant == "int8"
        probes.append(("port", quantized))
        return q8_tps if quantized else 100.0

    monkeypatch.setattr(JVLMManager, "_time_decode_route", jax_time)
    monkeypatch.setattr(VLMManager, "_time_decode_route", port_time)


def decoder_is_int8(mgr: VLMManager) -> bool:
    return isinstance(mgr.model.decoder.layers[0].attn.q_proj, QDense)


@pytest.mark.parametrize("route", ["bf16", "int8", None, "fastest"])
def test_pins_and_auto_without_warmup(model_dir, monkeypatch, caplog, route):
    if route is None:
        monkeypatch.delenv("LUMEN_VLM_Q8_ROUTE", raising=False)
    else:
        monkeypatch.setenv("LUMEN_VLM_Q8_ROUTE", route)
    probes: list = []
    fake_timing(monkeypatch, 50.0, probes)
    want = "bf16" if route == "bf16" else "int8"
    _reset_warnings()  # a malformed knob warns once a process
    jmgr = jax_boot(model_dir)
    with caplog.at_level(logging.WARNING):
        tmgr = port_boot(model_dir)
    try:
        assert jmgr.quant_route == tmgr.quant_route == want and not probes
        assert decoder_is_int8(tmgr) == (want == "int8")
        if route == "fastest":
            assert any("LUMEN_VLM_Q8_ROUTE" in r.getMessage() for r in caplog.records)
        j = jmgr.generate([JChatMessage(role="user", content="describe the image")], max_new_tokens=8)
        t = tmgr.generate([ChatMessage(role="user", content="describe the image")], max_new_tokens=8)
        assert t.tokens == j.tokens
        assert VlmService(tmgr).capability().extra["quant_route"] == want
    finally:
        tmgr.close()
        jmgr.close()


@pytest.mark.parametrize("q8_tps, want", [(50.0, "bf16"), (400.0, "int8")])
def test_warmup_ab_picks_the_same_winner(model_dir, monkeypatch, q8_tps, want):
    monkeypatch.setenv("LUMEN_VLM_Q8_ROUTE", "auto")
    probes: list = []
    fake_timing(monkeypatch, q8_tps, probes)
    fallbacks = (jax_metrics.snapshot().get("counters", {}).get("vlm_q8_fallbacks", 0),
                 port_metrics.snapshot().get("counters", {}).get("vlm_q8_fallbacks", 0))
    jmgr = jax_boot(model_dir, warmup=True)
    os.unlink(os.path.join(model_dir, VERDICT))  # the port measures too
    tmgr = port_boot(model_dir, warmup=True)
    try:
        assert jmgr.quant_route == tmgr.quant_route == want
        assert tmgr.quant_speedup == pytest.approx(jmgr.quant_speedup) == pytest.approx(q8_tps / 100.0)
        assert sorted(probes) == [("jax", False), ("jax", True), ("port", False), ("port", True)]
        assert decoder_is_int8(tmgr) == (want == "int8")
        jg = jax_metrics.snapshot()["gauges"][f"vlm-quant:{jmgr.model_id}"]
        tg = port_metrics.snapshot()["gauges"][f"vlm-quant:{tmgr.model_id}"]
        assert tg == jg and tg["int8_active"] == (want == "int8")
        counted = (jax_metrics.snapshot().get("counters", {}).get("vlm_q8_fallbacks", 0) - fallbacks[0],
                   port_metrics.snapshot().get("counters", {}).get("vlm_q8_fallbacks", 0) - fallbacks[1])
        assert counted == ((1, 1) if want == "bf16" else (0, 0))
        cap = VlmService(tmgr).capability()
        assert ("int8" in list(cap.precisions)) == (want == "int8")
    finally:
        tmgr.close()
        jmgr.close()
    assert f"vlm-quant:{tmgr.model_id}" not in port_metrics.snapshot().get("gauges", {})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_verdict(model_dir, monkeypatch, writer):
    monkeypatch.setenv("LUMEN_VLM_Q8_ROUTE", "auto")
    probes: list = []
    fake_timing(monkeypatch, 50.0, probes)  # q8 loses
    boot_w, boot_r = (jax_boot, port_boot) if writer == "jax" else (port_boot, jax_boot)
    first = boot_w(model_dir, warmup=True)
    first.close()
    saved = json.loads(open(os.path.join(model_dir, VERDICT)).read())
    assert saved["model"] == "TinyVLM@1.0.0" and saved["route"] == "bf16" and saved["q8_speedup"] == 0.5
    assert set(saved) == {"model", "route", "q8_speedup", "measured_at"}
    n = len(probes)
    second = boot_r(model_dir, warmup=True)
    try:
        assert second.quant_route == "bf16" and second.quant_speedup == pytest.approx(0.5)
        assert len(probes) == n  # no probe
    finally:
        second.close()


def test_stale_or_corrupt_verdict_measures_again_and_a_pin_ignores_it(model_dir, monkeypatch):
    monkeypatch.setenv("LUMEN_VLM_Q8_ROUTE", "auto")
    probes: list = []
    fake_timing(monkeypatch, 400.0, probes)  # q8 wins
    path = os.path.join(model_dir, VERDICT)
    for content in ("{not json", json.dumps({"model": "TinyVLM@0.9.0", "route": "bf16"}),
                    json.dumps({"model": "TinyVLM@1.0.0", "route": "fp4"})):
        open(path, "w").write(content)
        n = len(probes)
        mgr = port_boot(model_dir, warmup=True)
        try:
            assert mgr.quant_route == "int8" and len(probes) == n + 2
        finally:
            mgr.close()
    open(path, "w").write(json.dumps({"model": "TinyVLM@1.0.0", "route": "bf16"}))
    monkeypatch.setenv("LUMEN_VLM_Q8_ROUTE", "int8")
    n = len(probes)
    mgr = port_boot(model_dir, warmup=True)
    try:
        assert mgr.quant_route == "int8" and len(probes) == n
    finally:
        mgr.close()


@pytest.mark.parametrize("kernel", ["dequant", "dynamic"])
def test_int8_route_answers_as_jax(model_dir, monkeypatch, kernel):
    monkeypatch.setenv("LUMEN_VLM_Q8_ROUTE", "int8")
    monkeypatch.setenv("LUMEN_Q8_KERNEL", kernel)
    jmgr = jax_boot(model_dir)
    tmgr = port_boot(model_dir)
    try:
        assert tmgr.model.decoder.layers[0].mlp.down_proj.kernel_mode == kernel
        for prompt in ("describe the image", "a cat on a mat"):
            j = jmgr.generate([JChatMessage(role="user", content=prompt)], max_new_tokens=8)
            t = tmgr.generate([ChatMessage(role="user", content=prompt)], max_new_tokens=8)
            assert t.tokens == j.tokens
    finally:
        tmgr.close()
        jmgr.close()


@pytest.mark.parametrize("scheduler, program", [("continuous", "step_block"), ("coalesce", "generate")])
def test_real_ab_times_the_served_decode(model_dir, monkeypatch, scheduler, program):
    """No timing patched: both routes are placed, timed and freed one
    after the other, on the decode program the scheduler serves with (the
    engine's ``step_block``, the coalescer's fused ``generate``); the
    verdict is recorded."""
    monkeypatch.setenv("LUMEN_VLM_Q8_ROUTE", "auto")
    calls, programs = [], []
    real = VLMManager._time_decode_route

    def spy(self, cfg, decoder_state):
        assert not any(k.startswith("vision.") for k in decoder_state)
        n = len(programs)
        rate = real(self, cfg, decoder_state)
        calls.append((cfg.decoder.weight_quant, rate, set(programs[n:])))
        return rate

    for name in ("step_block", "generate"):
        real_program = getattr(Generator, name)

        def counted(self, *args, _name=name, _real=real_program, **kw):
            programs.append(_name)
            return _real(self, *args, **kw)

        monkeypatch.setattr(Generator, name, counted)
    monkeypatch.setattr(VLMManager, "_time_decode_route", spy)
    mgr = port_boot(model_dir, warmup=True, gen_batch_size=2, gen_slots=2, scheduler=scheduler)
    try:
        assert [q for q, _, _ in calls] == [None, "int8"] and all(rate > 0 for _, rate, _ in calls)
        assert all(ran == {program} for _, _, ran in calls)
        assert mgr.quant_speedup == pytest.approx(calls[1][1] / calls[0][1])
        assert mgr.quant_route == ("int8" if mgr.quant_speedup >= 1.0 else "bf16")
        saved = json.loads(open(os.path.join(model_dir, VERDICT)).read())
        assert saved["route"] == mgr.quant_route
    finally:
        mgr.close()
