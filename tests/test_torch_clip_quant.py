"""``QDense``'s W8A8 ``dynamic`` mode and the CLIP int8 route of the port,
held against the JAX package (the twin of ``tests/test_clip_quant.py``).

- ``QDense(kernel_mode="dynamic")``: the int32 accumulators equal the JAX
  ``dot_general`` ones exactly wherever the quantized activations are
  equal (both packages quantize the same floats), and the outputs agree
  within ``DYNAMIC_RTOL`` of the output scale; the integer product is
  exact, and its padding of short calls on the card leaves rows alone;
- ``quantize_clip_int8`` gives the JAX converter's q/scale leaves, bit
  for bit, with the vision-only pattern leaving the text tower alone;
- int8 towers (both kernels) on the same weights embed within
  ``Q8_COSINE`` of the JAX int8 towers (in fact within float rounding);
- ``CLIPManager(quantize="int8")`` serves int8 without warm-up, pins
  ``LUMEN_CLIP_Q8_ROUTE=bf16``, times the A/B under warm-up (a forced
  slower q8 falls back on both packages) and exports the
  ``clip-quant:<model>`` gauges.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.models.clip import CLIPManager as JCLIPManager
from lumen_tpu.models.clip.convert import quantize_clip_int8 as jax_quantize
from lumen_tpu.models.clip.modeling import CLIPConfig as JaxConfig
from lumen_tpu.models.clip.modeling import CLIPModel as JaxModel
from lumen_tpu.ops.quant import QDense as JQDense
from lumen_tpu.utils.metrics import metrics as jax_metrics
from lumen_tpu_torch.models.clip import CLIPConfig, CLIPManager, CLIPModel
from lumen_tpu_torch.models.clip.convert import clip_params_from_jax, quantize_clip_int8
from lumen_tpu_torch.ops.quant import INT_MM_MIN_ROWS, QDense, int8_matmul
from lumen_tpu_torch.utils.metrics import metrics as port_metrics
from tests.clip_fixtures import make_clip_model_dir, png_bytes

#: the JAX and port dynamic outputs: float32 arithmetic on equal int32
#: accumulators, one rounding apart (relative to the output's scale)
DYNAMIC_RTOL = 1e-6
#: port int8 embeddings vs the JAX int8 embeddings (unit vectors)
Q8_COSINE = 0.99999
#: int8 vs float embeddings (the JAX suite's bound)
FP_COSINE = 0.98


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-30)


def _qdense_pair(seed: int, d_in: int, d_out: int):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (d_in, d_out)).astype(np.int8)
    scale = (rng.random(d_out).astype(np.float32) + 0.5) / 127
    bias = rng.standard_normal(d_out).astype(np.float32)
    jparams = {"params": {"q": q, "scale": scale, "bias": bias}}
    layer = QDense(d_in, d_out, kernel_mode="dynamic")
    layer.load_state_dict({"q": torch.from_numpy(q), "scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    return jparams, layer


@pytest.mark.parametrize("shape", [(5, 64), (2, 7, 48), (33, 16)])
def test_dynamic_qdense_matches_jax(shape):
    d_in, d_out = shape[-1], 24
    jparams, layer = _qdense_pair(len(shape) + d_in, d_in, d_out)
    x = np.random.default_rng(d_in).standard_normal(shape).astype(np.float32) * 3
    want = np.asarray(JQDense(d_out, kernel_mode="dynamic").apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DYNAMIC_RTOL * np.abs(want).max())
    # the accumulators: the same quantized activations give equal int32 sums
    sx = np.maximum(np.abs(x).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-8))
    qx = np.clip(np.round(x / sx), -127, 127).astype(np.int8)
    jacc = np.asarray(jax.lax.dot_general(jnp.asarray(qx), jnp.asarray(jparams["params"]["q"]),
                                          (((qx.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    tacc = int8_matmul(torch.from_numpy(qx.reshape(-1, d_in)), layer.q).reshape(jacc.shape).numpy()
    assert tacc.dtype == np.int32 and np.array_equal(tacc, jacc)


def test_int8_matmul_is_exact_and_checks_its_operands():
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (3, 40)).astype(np.int8)
    b = rng.integers(-127, 128, (40, 16)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, a.astype(np.int64) @ b.astype(np.int64))
    assert INT_MM_MIN_ROWS == 16
    with pytest.raises(ValueError):
        int8_matmul(torch.from_numpy(a).float(), torch.from_numpy(b))
    with pytest.raises(ValueError):
        int8_matmul(torch.from_numpy(a), torch.from_numpy(b[:8]))


def test_quantize_clip_int8_is_the_jax_grid():
    jcfg = JaxConfig.tiny()
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                 jnp.zeros((1, jcfg.context_length), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    for include_text in (True, False):
        want = clip_params_from_jax(jax_quantize(params, include_text=include_text))
        got = quantize_clip_int8(clip_params_from_jax(params), include_text=include_text)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        assert ("text.blocks.0.attn.q_proj.q" in got) == include_text
        assert "vision.blocks.1.mlp.fc2.q" in got and "vision.projection.weight" in got


@pytest.mark.parametrize("kernel", ["dynamic", "dequant"])
def test_int8_towers_embed_as_jax(kernel):
    jcfg = JaxConfig.tiny()
    jmodel = JaxModel(jcfg)
    rng = np.random.default_rng(1)
    px = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, jcfg.vocab_size - 1, (3, jcfg.context_length)).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(px[:1]), jnp.asarray(ids[:1]))["params"]
    qparams = jax_quantize(jax.tree_util.tree_map(np.asarray, params))
    qjcfg = dataclasses.replace(jcfg, weight_quant="int8", weight_quant_kernel=kernel)
    jq = JaxModel(qjcfg)
    want_img = np.asarray(jq.apply({"params": qparams}, jnp.asarray(px), method=lambda m, x: m.encode_image(x)))
    want_txt = np.asarray(jq.apply({"params": qparams}, jnp.asarray(ids), method=lambda m, x: m.encode_text(x)))
    fp_img = np.asarray(jmodel.apply({"params": params}, jnp.asarray(px), method=lambda m, x: m.encode_image(x)))
    model = CLIPModel(dataclasses.replace(CLIPConfig.tiny(), weight_quant="int8", weight_quant_kernel=kernel)).eval()
    model.load_state_dict(clip_params_from_jax(qparams), strict=True)
    assert isinstance(model.vision.blocks[0].attn.q_proj, QDense)
    with torch.no_grad():
        got_img = model.encode_image(torch.from_numpy(px)).numpy()
        got_txt = model.encode_text(torch.from_numpy(ids).long()).numpy()
    assert _cos_rows(got_img, want_img).min() > Q8_COSINE
    assert _cos_rows(got_txt, want_txt).min() > Q8_COSINE
    assert _cos_rows(got_img, fp_img).min() > FP_COSINE


def _managers(model_dir, **kw):
    j = JCLIPManager(model_dir, dtype="float32", quantize="int8", **kw)
    j.initialize()
    t = CLIPManager(model_dir, dtype="float32", quantize="int8", device="cpu", **kw)
    t.initialize()
    return j, t


def test_manager_serves_int8_as_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("LUMEN_CLIP_Q8_ROUTE", raising=False)
    j, t = _managers(make_clip_model_dir(tmp_path))
    fp = CLIPManager(str(tmp_path / "models" / "TinyCLIP"), dtype="float32", device="cpu")
    fp.initialize()
    try:
        assert j.quant_route == t.quant_route == "int8" and t.quant_speedup is None
        assert isinstance(t.model.vision.blocks[0].mlp.fc1, QDense) and t.model.vision.blocks[0].mlp.fc1.kernel_mode == "dynamic"
        for seed in (0, 1):
            img = png_bytes(seed)
            assert _cos_rows(t.encode_image(img)[None], j.encode_image(img)[None]).min() > Q8_COSINE
            assert _cos_rows(t.encode_image(img)[None], fp.encode_image(img)[None]).min() > FP_COSINE
        assert _cos_rows(t.encode_text("a photo")[None], j.encode_text("a photo")[None]).min() > Q8_COSINE
        assert port_metrics.snapshot()["gauges"][f"clip-quant:{t.model_id}"] == {"int8_active": 1}
    finally:
        fp.close()
        t.close()
        j.close()
    assert f"clip-quant:{t.model_id}" not in port_metrics.snapshot().get("gauges", {})


def test_bf16_pin_skips_quantization(tmp_path, monkeypatch):
    monkeypatch.setenv("LUMEN_CLIP_Q8_ROUTE", "bf16")
    j, t = _managers(make_clip_model_dir(tmp_path))
    try:
        assert j.quant_route == t.quant_route == "bf16"
        assert isinstance(t.model.vision.blocks[0].attn.q_proj, torch.nn.Linear)
        img = png_bytes(0)
        assert _cos_rows(t.encode_image(img)[None], j.encode_image(img)[None]).min() > Q8_COSINE
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("q8_ratio, want", [(2.0, "bf16"), (0.5, "int8")])
def test_warmup_ab_picks_the_same_route(tmp_path, monkeypatch, q8_ratio, want):
    """The A/B at the top bucket, timing forced (q8 takes ``q8_ratio`` the
    bf16 time): the same verdict, fallback and gauges on both packages."""
    monkeypatch.setenv("LUMEN_CLIP_Q8_ROUTE", "auto")
    seen = []

    def jax_time(self, encode, placed):
        quantized = any("q" in blk["attn"]["q_proj"] for blk in [placed["vision"]["blocks_0"]])
        seen.append(("jax", quantized))
        return q8_ratio if quantized else 1.0

    def port_time(self, models):  # one copy a data place
        quantized = isinstance(models[0].vision.blocks[0].attn.q_proj, QDense)
        seen.append(("port", quantized))
        return q8_ratio if quantized else 1.0

    monkeypatch.setattr(JCLIPManager, "_time_image_encode", jax_time)
    monkeypatch.setattr(CLIPManager, "_time_image_encode", port_time)
    before = (jax_metrics.snapshot().get("counters", {}).get("clip_q8_fallbacks", 0),
              port_metrics.snapshot().get("counters", {}).get("clip_q8_fallbacks", 0))
    j, t = _managers(make_clip_model_dir(tmp_path), warmup=True, batch_size=2)
    try:
        assert j.quant_route == t.quant_route == want
        assert t.quant_speedup == pytest.approx(j.quant_speedup) == pytest.approx(1.0 / q8_ratio)
        assert sorted(seen) == [("jax", False), ("jax", True), ("port", False), ("port", True)]
        assert isinstance(t.model.vision.blocks[0].attn.q_proj, QDense) == (want == "int8")
        assert (port_metrics.snapshot()["gauges"][f"clip-quant:{t.model_id}"]
                == jax_metrics.snapshot()["gauges"][f"clip-quant:{j.model_id}"])
        after = (jax_metrics.snapshot().get("counters", {}).get("clip_q8_fallbacks", 0),
                 port_metrics.snapshot().get("counters", {}).get("clip_q8_fallbacks", 0))
        assert (after[0] - before[0], after[1] - before[1]) == ((1, 1) if want == "bf16" else (0, 0))
        img = png_bytes(2)
        assert _cos_rows(t.encode_image(img)[None], j.encode_image(img)[None]).min() > Q8_COSINE
    finally:
        t.close()
        j.close()


def test_real_ab_times_both_routes(tmp_path, monkeypatch):
    monkeypatch.setenv("LUMEN_CLIP_Q8_ROUTE", "auto")
    t = CLIPManager(make_clip_model_dir(tmp_path), dtype="float32", quantize="int8", device="cpu", warmup=True,
                    batch_size=2)
    t.initialize()
    try:
        assert t.quant_route in ("int8", "bf16") and t.quant_speedup > 0
        gauges = port_metrics.snapshot()["gauges"][f"clip-quant:{t.model_id}"]
        assert gauges == {"int8_active": int(t.quant_route == "int8"), "q8_speedup_pct": round(t.quant_speedup * 100, 1)}
        assert np.isfinite(t.encode_image(png_bytes(0))).all()
    finally:
        t.close()
