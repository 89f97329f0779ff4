"""The port's SPMD functions against the JAX package's on the 8-device CPU
mesh: ring and Ulysses attention (seq = 2 and 4, causal and not, outputs
and input gradients), the pipeline (stage = 2, outputs and parameter
gradients), expert-parallel MoE (expert = 2, outputs, gradients and
capacity drops), the tensor-parallel shard shapes (model = 2) and
``sanitize_spec``'s degrades, and ``distributed.initialize``.

The JAX side runs here; the port runs in gloo ranks spawned by
``torch_spmd_ranks.run_ranks`` (torch only), fed the same numpy inputs.
Tolerance: float32 throughout; the ring's blockwise softmax and the
all-to-all exchanges reorder sums, so outputs and gradients agree within
``TOL`` (2e-5 absolute and relative), which is 100x float32's epsilon at
these magnitudes (|x| <= ~10)."""

from __future__ import annotations

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from lumen_tpu.models.clip.modeling import CLIPConfig as JaxCLIPConfig, CLIPModel as JaxCLIPModel
from lumen_tpu.models.clip.modeling import TowerConfig as JaxTower
from lumen_tpu.parallel import moe as jmoe
from lumen_tpu.parallel import pipeline as jpipe
from lumen_tpu.parallel import sharding as jsharding
from lumen_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from lumen_tpu.parallel.ulysses import ulysses_attention as jax_ulysses_attention
from lumen_tpu.runtime.mesh import build_mesh
from lumen_tpu_torch.models.clip.modeling import CLIPConfig, CLIPModel, TowerConfig
from lumen_tpu_torch.models.vlm.convert import tree_paths
from lumen_tpu_torch.parallel import distributed, sharding
from lumen_tpu_torch.runtime.mesh import DeviceMesh
from torch_spmd_ranks import run_ranks

TOL = dict(atol=2e-5, rtol=2e-5)
B, H, S, D = 1, 4, 16, 8
CLIP_KW = dict(embed_dim=16, image_size=32, patch_size=16, vocab_size=64, context_length=8)


def _attention_inputs(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {n: rng.randn(B, H, S, D).astype(np.float32) for n in ("q", "k", "v", "g")}


def _jax_attention(inp: dict, n: int) -> dict:
    """JAX ring and Ulysses at seq = n: outputs and the vjp of ``g`` (one
    jitted program for the four variants)."""
    mesh = build_mesh({"seq": n})

    def everything(q, k, v, g):
        want = {}
        for name, fn in (("ring", jax_ring_attention), ("ulysses", jax_ulysses_attention)):
            for causal in (False, True):
                out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, mesh, causal=causal), q, k, v)
                tag = f"{name}_{int(causal)}"
                want[f"{tag}_out"] = out
                for x, gr in zip("qkv", vjp(g)):
                    want[f"{tag}_d{x}"] = gr
        return want

    got = jax.jit(everything)(*(jnp.asarray(inp[x]) for x in ("q", "k", "v", "g")))
    return {k: np.asarray(v) for k, v in got.items()}


def _check_attention(outs: list[dict], want: dict) -> None:
    for key, ref in want.items():
        got = np.concatenate([o[key] for o in outs], axis=2)  # the ranks' sequence blocks
        np.testing.assert_allclose(got, ref, err_msg=key, **TOL)


def _pipeline_inputs() -> dict:
    rng = np.random.RandomState(3)
    return {
        "pipe_w": (rng.randn(2, 16, 16) * 0.3).astype(np.float32),
        "pipe_b": np.full((2, 16), 0.01, np.float32),
        "pipe_x": rng.randn(8, 16).astype(np.float32),
        "pipe_g": rng.randn(8, 16).astype(np.float32),
    }


def _moe_inputs() -> dict:
    rng = np.random.RandomState(4)
    d, f, e, t = 8, 16, 4, 16
    return {
        "moe_router": (rng.randn(d, e) / np.sqrt(d)).astype(np.float32),
        "moe_w_gate": (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
        "moe_w_up": (rng.randn(e, d, f) / np.sqrt(d)).astype(np.float32),
        "moe_w_down": (rng.randn(e, f, d) / np.sqrt(f)).astype(np.float32),
        "moe_x": rng.randn(t, d).astype(np.float32),
        "moe_g": rng.randn(t, d).astype(np.float32),
    }


def _tiny_clip():
    return JaxCLIPConfig(vision=JaxTower(32, 1, 4), text=JaxTower(32, 1, 4), **CLIP_KW)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One run of two gloo ranks: attention at seq = 2, the pipeline, MoE
    and the TP shard shapes, with the JAX side of each."""
    attn = _attention_inputs(seed=1)
    pipe, moe = _pipeline_inputs(), _moe_inputs()
    jparams = JaxCLIPModel(_tiny_clip()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    clip = {f"clip/{p}": np.asarray(a) for p, a in _flat(jax.tree.map(np.asarray, jparams))}
    meta = {"n_micro": 4, "moe_k": 2, "moe_drop_factor": 0.5}
    outs = run_ranks("misc", 2, {**attn, **pipe, **moe, **clip, "meta": meta}, tmp_path_factory.mktemp("misc"))
    return {"outs": outs, "attn": attn, "pipe": pipe, "moe": moe, "jparams": jparams, "meta": meta}


def test_ring_and_ulysses_match_jax_at_seq_2(two_ranks):
    _check_attention(two_ranks["outs"], _jax_attention(two_ranks["attn"], 2))


def test_ring_and_ulysses_match_jax_at_seq_4(tmp_path):
    inp = _attention_inputs(seed=2)
    outs = run_ranks("attention", 4, dict(inp), tmp_path)
    _check_attention(outs, _jax_attention(inp, 4))


def test_pipeline_matches_jax_forward_and_parameter_gradients(two_ranks):
    inp, outs = two_ranks["pipe"], two_ranks["outs"]
    mesh = build_mesh({"stage": 2})

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    stacked = {"w": jnp.asarray(inp["pipe_w"]), "b": jnp.asarray(inp["pipe_b"])}
    x, g = jnp.asarray(inp["pipe_x"]), jnp.asarray(inp["pipe_g"])
    out, vjp = jax.vjp(lambda p: jpipe.pipeline_apply(stage_fn, p, x, mesh, n_microbatches=4), stacked)
    (grads,) = vjp(g)
    for o in outs:  # every rank holds the whole result
        np.testing.assert_allclose(o["pipe_out"], np.asarray(out), **TOL)
    # rank s holds stage s's gradients
    np.testing.assert_allclose(np.concatenate([o["pipe_dw"] for o in outs]), np.asarray(grads["w"]), **TOL)
    np.testing.assert_allclose(np.concatenate([o["pipe_db"] for o in outs]), np.asarray(grads["b"]), **TOL)


def test_expert_parallel_moe_matches_jax_with_and_without_drops(two_ranks):
    inp, outs, meta = two_ranks["moe"], two_ranks["outs"], two_ranks["meta"]
    mesh = build_mesh({"expert": 2})
    params = jmoe.MoEParams(*(jnp.asarray(inp[f"moe_{n}"]) for n in ("router", "w_gate", "w_up", "w_down")))
    x, g = jnp.asarray(inp["moe_x"]), jnp.asarray(inp["moe_g"])

    @jax.jit
    def both(x, params, g):
        got = {}
        for tag, factor in (("drop", meta["moe_drop_factor"]), ("exact", None)):
            out, vjp = jax.vjp(
                lambda xx, pp: jmoe.moe_ffn(pp, xx, mesh, k=meta["moe_k"], capacity_factor=factor), x, params
            )
            got[tag] = (out, *vjp(g))
        return got

    want = both(x, params, g)
    for tag in ("drop", "exact"):
        out, dx, dp = want[tag]
        np.testing.assert_allclose(np.concatenate([o[f"moe_{tag}_out"] for o in outs]), np.asarray(out),
                                   err_msg=tag, **TOL)
        np.testing.assert_allclose(np.concatenate([o[f"moe_{tag}_dx"] for o in outs]), np.asarray(dx), **TOL)
        for o in outs:  # the replicated router's gradient, whole on every rank
            np.testing.assert_allclose(o[f"moe_{tag}_drouter"], np.asarray(dp.router), **TOL)
        for n in ("w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(np.concatenate([o[f"moe_{tag}_d{n}"] for o in outs]),
                                       np.asarray(getattr(dp, n)), err_msg=f"{tag} {n}", **TOL)
    # the drop factor drops: fewer (token, choice) pairs routed than asked
    t_local = inp["moe_x"].shape[0] // 2
    assert all(float(o["moe_routed"]) < t_local * meta["moe_k"] for o in outs)


def test_tp_shard_shapes_match_jax_addressable_shards(two_ranks):
    """Each port parameter's local shard at model = 2 against the JAX
    shard of its Flax leaf, transposed where the layout is (a Dense
    ``kernel`` [in, out] is the port's [out, in]; the patch kernel [P, P,
    C, W] is [W, P*P*C])."""
    mesh = build_mesh({"data": 1, "model": 2})
    placed = jsharding.shard_params(two_ranks["jparams"], mesh, jsharding.TRANSFORMER_TP_RULES)
    jax_shapes = {p: {s.data.shape for s in a.addressable_shards} for p, a in _flat(placed)}
    paths = tree_paths(CLIPModel(CLIPConfig(vision=TowerConfig(32, 1, 4), text=TowerConfig(32, 1, 4), **CLIP_KW)))
    for rank_out in two_ranks["outs"]:
        got = json.loads(str(rank_out["shard_shapes"]))
        assert set(got) == set(paths)
        for name, shape in got.items():
            (want,) = jax_shapes[paths[name]]
            if paths[name].endswith("/kernel"):
                want = (want[-1], int(np.prod(want[:-1])))
            assert tuple(shape) == tuple(want), name
    assert got["vision.blocks.0.attn.q_proj.weight"] == [16, 32]  # output rows split over model = 2


@pytest.mark.parametrize("spec, shape", [
    (("model",), (32,)),                       # fits
    (("model",), (31,)),                       # indivisible: replicate that dim
    (("nope", None), (32, 32)),                # unknown axis
    ((None, "model", None), (32, 32)),         # longer than the rank
    ((("data", "model"), None), (32, 32)),     # one dim over two axes
    ((("data", "nope"),), (32,)),              # a tuple with an unknown axis
    ((None, None), (8, 8)),                    # trailing Nones dropped
])
def test_sanitize_spec_degrades_as_jax(spec, shape, caplog):
    jmesh = build_mesh({"data": 2, "model": 2})
    port_mesh = DeviceMesh(["cpu"], {"data": 2, "model": 2})  # sizes are all sanitize_spec reads
    with caplog.at_level(logging.WARNING):
        want = jsharding.sanitize_spec(jax.sharding.PartitionSpec(*spec), shape, jmesh, path="x")
        got = sharding.sanitize_spec(sharding.P(*spec), shape, port_mesh, path="x")
    assert tuple(got) == tuple(want)
    warned = [[r.getMessage() for r in caplog.records if r.name == f"{pkg}.parallel.sharding"]
              for pkg in ("lumen_tpu", "lumen_tpu_torch")]
    assert warned[0] == warned[1]  # the same warnings


def test_initialize_single_host_opens_no_group(monkeypatch):
    for var in ("LUMEN_COORDINATOR", "LUMEN_NUM_PROCESSES", "LUMEN_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not dist.is_initialized() and distributed.is_primary()
    monkeypatch.setenv("LUMEN_COORDINATOR", "localhost:1")
    monkeypatch.setenv("LUMEN_NUM_PROCESSES", "1")
    assert distributed.initialize(device="cpu") is False and not dist.is_initialized()


def test_initialize_on_cuda_takes_nccl_or_raises():
    """A CUDA caller (the default) gets NCCL on its card; without a card it
    raises rather than opening a gloo group."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("checked without a card: the card's run is chip_smoke.py phase 16")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.initialize("localhost:1", 2, 0)
    assert not dist.is_initialized()


def test_initialize_two_processes(tmp_path):
    outs = run_ranks("init", 2, {"meta": {}}, tmp_path)
    assert [bool(o["live"]) for o in outs] == [True, True]
    assert [bool(o["primary"]) for o in outs] == [True, False]
    assert all(str(o["backend"]) == "gloo" and float(o["total"][0]) == 3.0 and bool(o["again"]) for o in outs)


def _normalized(spec, rank: int) -> tuple:
    return tuple(spec) + (None,) * (rank - len(spec))


def _vlm_models():
    import dataclasses

    from lumen_tpu_torch.models.vlm.modeling import VLMConfig, VLMModel

    base = VLMConfig()
    dec = dataclasses.replace(base.decoder, hidden_size=64, layers=1, heads=4, kv_heads=2, intermediate_size=96,
                              vocab_size=256, tie_word_embeddings=False, moe_experts=4, moe_top_k=2,
                              moe_intermediate_size=32, moe_shared_intermediate=48)
    cfg = dataclasses.replace(base, decoder=dec, vision=dataclasses.replace(base.vision, width=32, layers=1, heads=2))
    q8 = dataclasses.replace(cfg, decoder=dataclasses.replace(dec, weight_quant="int8"))
    return VLMModel(cfg), VLMModel(q8)


@pytest.mark.parametrize("rules", ["tp", "moe_ep+tp", "int8+tp"])
def test_port_rules_are_the_jax_rules_on_each_parameters_jax_path(rules):
    """Every parameter (and ``QDense`` buffer) of a CLIP and a Qwen2-MoE VLM,
    int8 or not: the port rule on its port name gives the JAX rule's spec
    on its Flax path (``tree_paths``), transposed for a Dense kernel."""
    pick = {"tp": ([], []), "moe_ep+tp": (sharding.MOE_EP_RULES, jsharding.MOE_EP_RULES),
            "int8+tp": (sharding.INT8_TP_RULES, jsharding.INT8_TP_RULES)}[rules]
    port_rules = [*pick[0], *sharding.TRANSFORMER_TP_RULES]
    jax_rules = [*pick[1], *jsharding.TRANSFORMER_TP_RULES]
    clip = CLIPModel(CLIPConfig(vision=TowerConfig(32, 1, 4), text=TowerConfig(32, 1, 4), **CLIP_KW))
    matched = 0
    for model in (clip, *_vlm_models()):
        shapes = {n: t.shape for n, t in [*model.named_parameters(), *model.named_buffers()]}
        for name, path in tree_paths(model).items():
            want = jsharding.spec_for(path, jax_rules)
            got = sharding.spec_for(name, port_rules)
            rank = max(len(want), len(got), 2)
            want = _normalized(want, rank)
            if path.endswith("/kernel") and len(shapes[name]) == 2:
                want = (want[1], want[0]) + want[2:]
            assert _normalized(got, rank) == want, (name, path)
            matched += any(want)
    assert matched > 20  # the rules do shard something
