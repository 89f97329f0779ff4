"""The trace's busy union, idle gaps, and the roofline and MFU counting
(CPU: synthetic traces and records)."""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import window, work  # noqa: E402
from harness.cells import Bench  # noqa: E402
from harness.serve import Record  # noqa: E402
from harness.trace import DeviceTrace, short  # noqa: E402
from reference import vlm as ref  # noqa: E402

sys.path.insert(0, str(BENCH / "tests"))
import h100bench_tiny as tiny  # noqa: E402

MOE = json.loads((BENCH / "configs" / "qwen1.5-moe-a2.7b-vlm.json").read_text())
DENSE = tiny.tiny_config(moe=False)


def test_busy_is_the_union_of_intervals():
    ops = [("a", 0, 10), ("b", 5, 12), ("Memcpy HtoD", 20, 25), ("c", 21, 22), ("d", 30, 40)]
    t = DeviceTrace(ops=ops, window_s=50e-9)
    assert t.busy_s() == pytest.approx(27e-9)
    assert len(t.kernels()) == 4
    assert t.time_of(lambda n: n in "abc") == (3, pytest.approx(18e-9))
    gaps = dict((k, v) for k, v in t.idle_gaps())
    assert gaps == {"after b": pytest.approx(8e-9), "after Memcpy HtoD": pytest.approx(5e-9)}
    assert 100 * (1 - t.busy_s() / t.window_s) == pytest.approx(46.0)


def test_the_window_is_cut_at_its_marks():
    from harness.trace import window_of

    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    ops = [("before", 0, 10), (spin, 20, 30), ("a", 25, 40), ("b", 50, 70), (spin, 80, 85), ("c", 75, 95),
           ("after", 90, 99)]
    t = window_of(ops)
    # a starts before the first mark has ended; c is cut at the second
    assert [o[0] for o in t.ops] == ["b", "c"]
    assert t.window_s == pytest.approx(50e-9)
    assert t.busy_s() == pytest.approx(25e-9)
    with pytest.raises(RuntimeError):
        window_of(ops[:2])


def test_short_names_drop_templates_and_arguments():
    assert short("void lumen::paged_walk_mma_kernel<__nv_bfloat16, 64>(T1 const*, int)") == \
        "lumen::paged_walk_mma_kernel"


def test_a_share_reaches_100_only_at_the_bound():
    w = work.Work(bytes=3.35e9, flops=1e9, exps=0)
    assert work.roofline_pct(w, w.bound_s()) == pytest.approx(100.0)
    assert work.roofline_pct(w, 2 * w.bound_s()) == pytest.approx(50.0)
    assert work.roofline_pct(w, 0) is None


def test_paged_counts():
    s = ref.shape_of(MOE)
    w = work.paged_decode(s, 100)
    assert w.bytes == 2 * (2 * 16 * 128 + 2 * 16 * 100 * 128)
    assert w.flops == 4 * 16 * 100 * 128
    assert w.exps == 16 * 100
    # GQA reads K and V once at the KV heads, whatever the kernel repeats
    g = work.paged_decode(ref.shape_of(DENSE), 100)
    assert g.bytes == 2 * (2 * 4 * 16 + 2 * 2 * 100 * 16)


def test_token_flops_are_twice_the_active_parameters():
    s = ref.shape_of(DENSE)
    per_layer = 64 * 64 * 2 + 64 * 32 * 2 + 3 * 64 * 128
    assert work.decoder_token_flops(s, 0, False) == pytest.approx(2 * 2 * per_layer)
    assert work.decoder_token_flops(s, 0, True) - work.decoder_token_flops(s, 0, False) == 2 * 64 * 4096
    m = ref.shape_of(MOE)
    active = 2048 * 2048 * 4 + 2048 * 60 + 4 * 3 * 2048 * 1408 + 3 * 2048 * 5632 + 2048
    assert work.decoder_token_flops(m, 0, False) == pytest.approx(2 * 24 * active)
    # about 2.7B active parameters of 14.3B (the model's name)
    assert 2.0e9 < 24 * active + 2048 * 151936 < 2.8e9


def _ctx(cfg, records, trace=None, t0=0.0, t1=10.0):
    return SimpleNamespace(
        shape=ref.shape_of(cfg), records=records, t0=t0, t1=t1, t_end=t1, window_s=t1 - t0, trace=trace,
        buckets=[64, 128, 256, 512, 1024], chunk=256, block=8, slots=8,
        gauges0={"blocks_run": 10}, gauges1={"blocks_run": 15}, device="cpu", seed=1,
    )


def _rec(i, text, n_tokens, t=1.0):
    return Record(index=i, text=text, max_tokens=n_tokens, due=0.5, sent=0.5, first=t,
                  chunks=[(t, n_tokens)], tokens=[5] * n_tokens, finish="length")


def test_paged_roofline_from_the_streamed_tokens():
    bench = Bench()
    rec = _rec(0, "a b c", 8)
    ctx = _ctx(MOE, [rec])
    n = window.live_length(ctx, rec)
    assert n == 6 - 1 + 256
    need = sum((work.paged_decode(ctx.shape, n + j + 1) for j in range(8)), work.Work()) * 24
    ctx.trace = DeviceTrace(ops=[("lumen::paged_walk_kernel<x>", 0, int(2e9 * need.bound_s()))], window_s=10.0)
    assert bench.reader("paged_attn_roofline")(ctx) == pytest.approx(50.0, rel=1e-4)
    ctx.trace = DeviceTrace(ops=[("other", 0, 10)], window_s=10.0)
    assert bench.reader("paged_attn_roofline")(ctx) is None


def test_grouped_product_time_a_token_from_the_trace():
    bench = Bench()
    ctx = _ctx(MOE, [_rec(0, "a", 8), _rec(1, "b", 8, t=2.0), _rec(2, "c", 8, t=11.0)])
    ops = [("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm", 0, 3000),
           ("void at::cuda::detail::prepare_grouped_gemm_data<float>(int*)", 5000, 5500),
           ("lumen::grouped_mm_kernel<__half>", 6000, 7000), ("nvjet_tst_64x8_TNT", 8000, 9000)]
    ctx.trace = DeviceTrace(ops=ops, window_s=10.0)
    assert bench.reader("grouped_mm_us_per_token")(ctx) == pytest.approx(1e6 * 4500e-9 / 16)
    ctx.trace = DeviceTrace(ops=ops[3:], window_s=10.0)
    assert bench.reader("grouped_mm_us_per_token")(ctx) is None
    # a dense model has no grouped product
    ctx = _ctx(DENSE, ctx.records, trace=DeviceTrace(ops=ops, window_s=10.0))
    assert bench.reader("grouped_mm_us_per_token")(ctx) is None


def test_mfu_counts_images_prompts_and_outputs():
    bench = Bench()
    rec = _rec(0, "a b c", 8)
    ctx = _ctx(MOE, [rec])
    s = ctx.shape
    n = window.live_length(ctx, rec)
    want = work.vision_flops(s)
    want += sum(work.decoder_token_flops(s, p + 1, False) for p in range(n)) + 2 * 2048 * 151936
    want += sum(work.decoder_token_flops(s, n + j + 1, True) for j in range(8))
    assert bench.reader("step_mfu")(ctx) == pytest.approx(100 * want / (10.0 * 989e12), rel=1e-9)


def test_counters_give_rows_and_step_time():
    bench = Bench()
    ctx = _ctx(DENSE, [_rec(0, "a", 8), _rec(1, "b", 8, t=2.0), _rec(2, "c", 8, t=11.0)])
    assert bench.reader("decode_rows_mean")(ctx) == pytest.approx(16 / 40)
    assert bench.reader("step_ms.decode")(ctx) == pytest.approx(1e3 * 10 / 40)
    ctx.trace = DeviceTrace(ops=[("k", 0, 1)] * 4 + [("Memset", 0, 1)], window_s=10.0)
    assert bench.reader("launches_per_token")(ctx) == pytest.approx(4 / 16)
