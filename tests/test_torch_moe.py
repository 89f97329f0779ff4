"""The port's Qwen2-MoE decoder against the JAX package's, on the CPU.

Inputs come from numpy seeds (or the JAX Flax init, carried over by
``params_from_jax``) and go through both packages:

- ``moe_ffn``'s exact path against the JAX ``_moe_exact_local`` (T in {1,
  8, 37}, E = 8, k in {1, 2, 4}, ``norm_topk`` both ways) and its
  capacity path against ``_moe_local`` (the same assignments dropped),
  fp32 within 1e-5; the grouped product against a loop over experts,
  bitwise, empty groups included;
- ``MoEFFN`` with a shared expert against the JAX ``MoEFFN``, 1e-5;
- the tiny MoE VLM (``tests/test_vlm_moe.py``'s sizes) and a config that
  mixes dense and sparse layers: logits within 1e-4;
- an HF ``Qwen2MoeForCausalLM`` through ``convert_vlm_checkpoint``: logits
  within HF's own parity bar (atol 2e-4, rtol 2e-3, as
  ``tests/test_vlm_moe.py``);
- conversion and configuration: stacked banks equal the JAX
  ``_stack_experts``, ``from_hf`` gives the JAX MoE fields, the int8
  pass turns exactly the JAX ``_QUANT_KERNEL`` set into ``QDense``.

The managers (paged engine, coalescer, speculation, int8) are held to the
JAX managers in ``tests/test_torch_moe_serving.py``.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.models.vlm import modeling as jm
from lumen_tpu.models.vlm.convert import _stack_experts as jax_stack_experts
from lumen_tpu.models.vlm.convert import quantize_decoder_int8 as jax_quantize
from lumen_tpu_torch.models.vlm import modeling as tm
from lumen_tpu_torch.models.vlm.convert import (
    convert_vlm_checkpoint,
    export_hf_checkpoint,
    params_from_jax,
    quantize_decoder_int8,
)
from lumen_tpu_torch.ops.quant import QDense
from lumen_tpu_torch.parallel import moe as tmoe
from lumen_tpu_torch.runtime.mesh import DeviceMesh

jmoe = importlib.import_module("lumen_tpu.parallel.moe")

TOL = dict(atol=1e-5, rtol=1e-5)
D, F, E = 32, 48, 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _moe_case(t, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    banks = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32) for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, router, banks


def _params(pkg, router, banks, conv):
    return pkg.MoEParams(conv(router), *(conv(b) for b in banks))


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("t", [1, 8, 37])
def test_exact_path_matches_jax(t, k, norm):
    x, router, banks = _moe_case(t, seed=t * 10 + k)
    want = jmoe._moe_exact_local(_params(jmoe, router, banks, jnp.asarray), jnp.asarray(x), n_experts=E, k=k,
                                 norm_topk=norm)
    tp = _params(tmoe, router, banks, _t)
    got = tmoe.moe_ffn(tp, _t(x), k=k, capacity_factor=None, norm_topk=norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same with the grouped product's plain twin
    plain = tmoe._moe_exact_local(tp, _t(x), n_experts=E, k=k, norm_topk=norm, mm=tmoe.grouped_mm_reference)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_mm_equals_a_loop_over_experts(dtype):
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((13, 16)).astype(np.float32)).to(dtype)
    w = _t(rng.standard_normal((5, 16, 24)).astype(np.float32)).to(dtype)
    ends = torch.tensor([0, 4, 4, 13, 13], dtype=torch.int32)  # groups 0, 2 and 4 empty
    got = tmoe.grouped_mm(x, w, ends)
    assert got.dtype == dtype and torch.equal(got, tmoe.grouped_mm_reference(x, w, ends))
    with pytest.raises(ValueError, match="multiples"):
        tmoe.grouped_mm(x[:, :6], w[:, :6], ends)


@pytest.mark.parametrize("t,k,factor", [(37, 2, 0.5), (37, 4, 1.25), (8, 1, 1.0)])
def test_capacity_path_matches_jax(t, k, factor):
    x, router, banks = _moe_case(t, seed=100 + t + k)
    capacity = max(1, int(factor * k * t / E))
    jd, _ = jmoe._route(jnp.asarray(x), jnp.asarray(router), E, k, capacity, True)
    td, _ = tmoe._route(_t(x), _t(router), E, k, capacity, True)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))  # the same assignments dropped
    if factor < 1:
        assert td.sum() < t * k  # some did drop
    want = jmoe.moe_ffn(_params(jmoe, router, banks, jnp.asarray), jnp.asarray(x), k=k, capacity_factor=factor)
    got = tmoe.moe_ffn(_params(tmoe, router, banks, _t), _t(x), k=k, capacity_factor=factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_and_expert_mesh():
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(gen, D, F, E, dtype=torch.bfloat16)
    assert p.router.dtype == torch.float32 and p.w_gate.shape == (E, D, F) and p.w_down.dtype == torch.bfloat16
    x = torch.randn(4, D)
    # A serving mesh with an expert axis serves on a running group: a mesh
    # made without one says what to pass.
    with pytest.raises(RuntimeError, match="build_mesh while a group runs.*ExpertParallel"):
        tmoe.moe_ffn(p, x, DeviceMesh([torch.device("cpu")] * 2, {"data": 1, "expert": 2}))
    assert tmoe.moe_ffn(p, x.bfloat16(), DeviceMesh([torch.device("cpu")], {"data": 1}),
                        capacity_factor=None).shape == (4, D)


def _moe_decoder(dec, **kw):
    base = dict(moe_experts=4, moe_top_k=2, moe_intermediate_size=48, moe_shared_intermediate=40,
                moe_norm_topk=False)
    return dataclasses.replace(dec, **{**base, **kw})


def test_moeffn_with_shared_expert_matches_jax():
    jdec = _moe_decoder(jm.VLMConfig.tiny().decoder)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    params = jm.MoEFFN(jdec).init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = jm.MoEFFN(jdec).apply({"params": params}, jnp.asarray(x))
    mod = tm.MoEFFN(_moe_decoder(tm.VLMConfig.tiny().decoder))
    mod.load_state_dict(params_from_jax(params), strict=True)
    assert mod.router.shape == (32, 4) and mod.w_down.shape == (4, 48, 32)
    assert mod.shared_gate.weight.shape == (1, 32)
    with torch.no_grad():
        got = mod(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _vlm_pair(**kw):
    jcfg = jm.VLMConfig.tiny()
    jcfg = dataclasses.replace(jcfg, decoder=_moe_decoder(jcfg.decoder, **kw))
    tcfg = tm.VLMConfig.tiny()
    tcfg = dataclasses.replace(tcfg, decoder=_moe_decoder(tcfg.decoder, **kw))
    jmodel = jm.VLMModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 32, 32, 3)))["params"]
    tmodel = tm.VLMModel(tcfg)
    tmodel.load_state_dict(params_from_jax(params), strict=True)
    return jcfg, jmodel, params, tcfg, tmodel.eval()


@pytest.mark.parametrize("layout", ["all sparse", "mixed"])
def test_vlm_logits_match_jax(layout):
    kw = {} if layout == "all sparse" else dict(layers=4, moe_every=2, moe_dense_layers=(3,))
    jcfg, jmodel, params, tcfg, tmodel = _vlm_pair(**kw)
    kinds = [type(layer.mlp).__name__ for layer in tmodel.decoder.layers]
    assert kinds == (["MoEFFN", "MoEFFN"] if layout == "all sparse" else ["SwiGLU", "MoEFFN", "SwiGLU", "SwiGLU"])
    assert [jcfg.decoder.is_moe_layer(i) for i in range(len(kinds))] == [k == "MoEFFN" for k in kinds]
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 200, (2, 9)).astype(np.int32)
    ids[:, 2] = jcfg.image_token_id
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(pixels))
    with torch.no_grad():
        got = tmodel(_t(ids).long(), _t(pixels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_hf_round_trip_and_jax_stacking():
    """The port's HF export of a MoE model converts back to the same
    ``state_dict``, and its stacked banks are the JAX ``_stack_experts``
    of the same per-expert leaves."""
    _, _, params, tcfg, tmodel = _vlm_pair()
    state = tmodel.state_dict()
    hf = export_hf_checkpoint(state)
    assert "model.layers.1.mlp.experts.3.down_proj.weight" in hf and "model.layers.0.mlp.gate.weight" in hf
    assert hf["model.layers.0.mlp.shared_expert_gate.weight"].shape == (1, 32)
    back = convert_vlm_checkpoint(hf)
    assert set(back) == set(state) and all(torch.equal(back[k], state[k]) for k in state)
    per_expert = {f"decoder/layers_0/mlp/__expert_up__/{i}": np.asarray(params["decoder"]["layers_0"]["mlp"]["w_up"][i])
                  for i in range(4)}
    want = jax_stack_experts(per_expert)["decoder/layers_0/mlp/w_up"]
    np.testing.assert_array_equal(back["decoder.layers.0.mlp.w_up"].numpy(), want)
    with pytest.raises(ValueError, match="non-contiguous"):
        convert_vlm_checkpoint({k: v for k, v in hf.items() if ".experts.2." not in k})


def test_from_hf_qwen15_moe_fields_match_jax():
    """A Qwen1.5-MoE-A2.7B-shaped ``config.json`` and its defaults: the
    port's ``from_hf`` gives the JAX ``DecoderConfig``'s MoE fields."""
    from lumen_tpu_torch.testing.vlm_standins import hf_config, qwen15_moe_a27b

    cfg = qwen15_moe_a27b()
    hf = hf_config(cfg)
    t, j = tm.VLMConfig.from_hf(hf).decoder, jm.VLMConfig.from_hf(hf).decoder
    assert tm.VLMConfig.from_hf(hf) == cfg and t.dim_per_head == 128
    fields = [f.name for f in dataclasses.fields(t)]
    assert {f for f in fields if f.startswith("moe_")} == {f.name for f in dataclasses.fields(j) if f.name.startswith("moe_")}
    assert all(getattr(t, f) == getattr(j, f) for f in fields if f in {g.name for g in dataclasses.fields(j)})
    bare = {"num_experts": 4, "mlp_only_layers": [1], "num_hidden_layers": 3}  # HF defaults: top-4, no renorm
    t, j = tm.VLMConfig.from_hf(bare).decoder, jm.VLMConfig.from_hf(bare).decoder
    assert (t.moe_top_k, t.moe_norm_topk, t.moe_dense_layers) == (j.moe_top_k, j.moe_norm_topk, j.moe_dense_layers)
    assert [t.is_moe_layer(i) for i in range(3)] == [j.is_moe_layer(i) for i in range(3)] == [True, False, True]


def test_int8_quantizes_exactly_the_jax_set():
    """QDense replaces the attention projections, the shared expert's three
    and the untied lm_head; the router, ``shared_gate``, norms, embeddings
    and expert banks stay float -- the JAX ``_QUANT_KERNEL`` set, bitwise
    the JAX grid."""
    _, _, params, tcfg, _ = _vlm_pair()
    cfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, tie_word_embeddings=False,
                                                                 weight_quant="int8"))
    rng = np.random.default_rng(2)
    params = jax.tree.map(np.asarray, params)
    params["decoder"]["lm_head"] = {"kernel": rng.standard_normal((32, 256)).astype(np.float32)}
    want = params_from_jax(jax_quantize(params))
    got = quantize_decoder_int8(params_from_jax(params))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    model = tm.VLMModel(cfg)
    model.load_state_dict(got, strict=True)
    qd = sorted(n for n, m in model.decoder.named_modules() if isinstance(m, QDense))
    per_layer = [f"layers.{i}.{p}" for i in range(2) for p in (
        "attn.k_proj", "attn.o_proj", "attn.q_proj", "attn.v_proj",
        "mlp.shared.down_proj", "mlp.shared.gate_proj", "mlp.shared.up_proj")]
    assert qd == sorted(per_layer + ["lm_head"])
    mlp = model.decoder.layers[0].mlp
    assert isinstance(mlp.shared_gate, torch.nn.Linear) and mlp.router.dtype == torch.float32
    assert {k for k in got if k.endswith(".q")} == {f"decoder.{n}.q" for n in qd}


def test_hf_qwen2_moe_logits_match():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hcfg = transformers.Qwen2MoeConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=128, rope_theta=10_000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=True, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
        shared_expert_intermediate_size=40, decoder_sparse_step=1, norm_topk_prob=False, mlp_only_layers=[],
        output_router_logits=False, bos_token_id=1, eos_token_id=2, pad_token_id=0, attention_dropout=0.0,
    )
    hf = transformers.Qwen2MoeForCausalLM(hcfg).eval()
    cfg = tm.VLMConfig.from_hf({
        "text_config": {k: getattr(hcfg, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "max_position_embeddings", "rope_theta", "rms_norm_eps", "tie_word_embeddings",
            "num_experts", "num_experts_per_tok", "moe_intermediate_size", "shared_expert_intermediate_size",
            "decoder_sparse_step", "norm_topk_prob", "bos_token_id", "eos_token_id", "pad_token_id")},
        "vision_config": {"image_size": 32, "patch_size": 16, "hidden_size": 48, "num_hidden_layers": 1,
                          "num_attention_heads": 4},
        "image_token_index": 127,
    })
    model = tm.init_random_(tm.VLMModel(cfg), 0)  # the vision tower: seeded, unused without pixels
    state = convert_vlm_checkpoint(hf.state_dict(), tie_word_embeddings=True)
    vision = {k: v for k, v in model.state_dict().items() if k.startswith("vision.")}
    model.load_state_dict({**state, **vision}, strict=True)
    ids = np.random.RandomState(7).randint(3, 126, size=(1, 9))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits
        got = model.eval()(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-3)
