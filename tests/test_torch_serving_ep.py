"""The port serving the Qwen2-MoE decoder over an ``expert`` axis and a
``model`` axis against the JAX package's mesh runs (the counterparts of
``tests/test_serving_tp.py::TestVlmExpertParallel``).

The JAX side runs in the pytest process on the simulated 8-device CPU
mesh. The port runs in gloo ranks of a serving group
(``tests/torch_spmd_ranks.py``'s ``ep_*`` and ``tp_moe`` cases): rank 0
drives the managers, the others run the worker loop, and the ``data``
axis degrades to 1 (one replica on the group's ranks). Both read the same
tiny model directories in float32: ``make_moe_model_dir`` (4 experts,
top-2, no shared expert) and ``tests/test_torch_moe_serving.py``'s shared-
expert MoE (a shared expert of 40), each with its chat template removed,
so both packages render the plain transcript. Tolerances:

- greedy tokens (and text) identical to the JAX ``VLMManager``'s at
  ``{data: 4, expert: 2}`` for the continuous engine, the coalescer and
  int8; at ``{data: 2, expert: 2, model: 2}`` on four ranks; and for the
  shared-expert MoE at ``{data: 4, model: 2}``, as the JAX test demands;
- each rank's local slices carry the JAX specs: the banks ``[E/2, ...]``
  over ``expert``, the router whole, ``attn.q_proj`` over ``model``
  (no ranks needed);
- ``moe_ffn`` on each rank of the expert axis: its exact path within 1e-6
  of the mesh-less one (the same groups, rows and order, and an exact
  sum; what is left is the grouped product's rounding of a row, which on
  the CPU depends on where the rows sit in memory), the same bits on every
  rank, and within 1e-5 of the JAX exact and capacity paths;
- a row spilled at ``{expert: 2}`` resumes with no mesh to the same
  tokens; ``serve()`` with ``mesh: {expert: 2}`` starts its worker itself;
- the rank layout: rank ``e * model + m``, the ``model`` sums over the
  ranks that share ``e`` and the expert sums over those that share ``m``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu.models.vlm import modeling as jm
from lumen_tpu_torch.models.vlm import VLMConfig, params_from_jax
from lumen_tpu_torch.models.vlm.convert import convert_vlm_checkpoint, tree_paths
from lumen_tpu_torch.models.vlm.manager import build_config, placement_rules, vlm_heads
from lumen_tpu_torch.models.vlm.modeling import VLMModel
from lumen_tpu_torch.parallel.sharding import tp_split
from lumen_tpu_torch.parallel.tp import ExpertParallel, TensorParallel
from lumen_tpu_torch.runtime.tp_group import rank_place
from lumen_tpu_torch.testing.vlm_standins import write_model_dir
from tests.test_serving_tp import _leaf_sharding_specs, make_moe_model_dir
from tests.torch_spmd_ranks import run_ranks

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs the simulated 8-device mesh")

PROMPT = "describe the image"
MAX_NEW = 12
EP = {"data": 4, "expert": 2}
EP_TP = {"data": 2, "expert": 2, "model": 2}
TP = {"data": 4, "model": 2}
#: the JAX manager options of each port run at ``EP``
EP_RUNS = {
    "continuous": {"scheduler": "continuous", "gen_slots": 2, "gen_block": 4},
    "coalesce": {"scheduler": "coalesce"},
    "int8": {"quantize": "int8"},
}
#: ``tests/test_torch_moe_serving.py``'s shared-expert MoE decoder
SHARED = dict(moe_experts=4, moe_top_k=2, moe_intermediate_size=48, moe_shared_intermediate=40, moe_norm_topk=False)
#: ``moe_ffn`` at the function level: tokens, experts, top-k, the capacity factor
MOE_T, MOE_E, MOE_K, MOE_FACTOR = 13, 8, 2, 0.75
_POOL = ThreadPoolExecutor(max_workers=4)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ep")
    moe = make_moe_model_dir(root / "moe")
    os.remove(os.path.join(moe, "tokenizer_config.json"))
    jcfg = jm.VLMConfig.tiny()
    jcfg = dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder, **SHARED))
    params = jm.VLMModel(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                                    jnp.zeros((1, 32, 32, 3)))["params"]
    tcfg = VLMConfig.tiny()
    tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, **SHARED))
    shared = write_model_dir(root / "shared", "TinySharedMoE", tcfg, params_from_jax(params))
    os.remove(shared / "tokenizer_config.json")
    return {"moe": moe, "shared": str(shared), "root": root}


def _jax_tokens(model_dir, **kw):
    """The JAX manager's greedy tokens, text and leaf specs."""
    mgr = JVLMManager(model_dir, dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32),
                      gen_batch_size=2, gen_batch_latency_ms=1.0, **kw)
    mgr.initialize()
    try:
        r = mgr.generate([JChatMessage(role="user", content=PROMPT)], max_new_tokens=MAX_NEW)
        return list(r.tokens), r.text, _leaf_sharding_specs(mgr.params)
    finally:
        mgr.close()


def _moe_inputs() -> dict:
    rng = np.random.default_rng(19)
    d, f = 16, 24
    return {"moe_x": rng.standard_normal((MOE_T, d)).astype(np.float32),
            "moe_router": (rng.standard_normal((d, MOE_E)) * 0.5).astype(np.float32),
            "moe_w_gate": (rng.standard_normal((MOE_E, d, f)) / 4).astype(np.float32),
            "moe_w_up": (rng.standard_normal((MOE_E, d, f)) / 4).astype(np.float32),
            "moe_w_down": (rng.standard_normal((MOE_E, f, d)) / 5).astype(np.float32),
            "moe_k": np.asarray(MOE_K), "moe_factor": np.asarray(MOE_FACTOR)}


@pytest.fixture(scope="module")
def runs(dirs, tmp_path_factory):
    """The JAX managers' answers and leaf specs, while the port's rank
    cases run beside them."""
    meta = dict(moe_dir=dirs["moe"], shared_dir=dirs["shared"], prompt=PROMPT, max_new=MAX_NEW)
    moe_in = _moe_inputs()
    pending = {
        "ep": _POOL.submit(run_ranks, "ep_vlm", 2, {"meta": {**meta, "expert": 2}, **moe_in},
                           tmp_path_factory.mktemp("ep_vlm"), timeout=180),
        "ep_tp": _POOL.submit(run_ranks, "ep_tp_vlm", 4, {"meta": {**meta, "expert": 2}},
                              tmp_path_factory.mktemp("ep_tp_vlm"), timeout=180),
        "tp_moe": _POOL.submit(run_ranks, "tp_moe", 2, {"meta": meta}, tmp_path_factory.mktemp("tp_moe"),
                               timeout=180),
    }
    want = {tag: _jax_tokens(dirs["moe"], mesh_axes=EP, **kw) for tag, kw in EP_RUNS.items()}
    want["ep_tp"] = _jax_tokens(dirs["moe"], mesh_axes=EP_TP, **EP_RUNS["continuous"])
    want["tp_moe"] = _jax_tokens(dirs["shared"], mesh_axes=TP, **EP_RUNS["continuous"])
    want["moe_in"] = moe_in
    return want, {k: f.result() for k, f in pending.items()}


def test_rank_layout():
    """Rank ``e * model + m`` sits at ``(e, m)``; on four ranks at ``{expert:
    2, model: 2}`` each rank's ``model`` sum adds the ranks that share its
    ``e`` and its expert sum those that share its ``m``."""
    assert [rank_place(r, 2) for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [rank_place(r, 1) for r in range(2)] == [(0, 0), (1, 0)]
    assert [rank_place(r, 3) for r in range(6)] == [(e, m) for e in range(2) for m in range(3)]


def test_rank_layout_on_four_ranks(runs):
    places = json.loads(str(runs[1]["ep_tp"][0]["places"]))
    assert [p["rank"] for p in places] == [0, 1, 2, 3]
    for r, p in enumerate(places):
        e, m = rank_place(r, 2)
        assert p["tp"] == [m, 2] and p["ep"] == [e, 2], p
        assert p["tp_sum"] == sum(10.0 ** (e * 2 + j) for j in range(2)), p
        assert p["ep_sum"] == sum(10.0 ** (i * 2 + m) for i in range(2)), p


def _check_specs(dirs, specs: dict, mesh: dict) -> dict:
    """Every rank's local slice of every parameter at ``mesh`` is the JAX
    shard of the same leaf (transposed where the layout is), and its spec
    the JAX spec; returns the JAX specs by path."""
    import torch

    from lumen_tpu_torch.core.model_info import load_model_info
    from lumen_tpu_torch.runtime.weights import load_state_dict

    cfg = build_config(dirs["moe"], load_model_info(dirs["moe"]))
    state = convert_vlm_checkpoint(load_state_dict(dirs["moe"]), tie_word_embeddings=cfg.decoder.tie_word_embeddings)
    with torch.device("meta"):
        paths = tree_paths(VLMModel(cfg))
    assert set(paths) == set(state)
    n_e, n_m = mesh.get("expert", 1), mesh.get("model", 1)
    for e in range(n_e):
        for m in range(n_m):
            group = types.SimpleNamespace(tp=TensorParallel(n_m, m), ep=ExpertParallel(n_e, e) if n_e > 1 else None)
            rules = placement_rules(group, False)
            for name, t in state.items():
                path = paths[name]
                kernel = path.endswith("/kernel")
                full = tuple(t.shape)
                jspec = specs[path]
                want = tuple(n // mesh[jspec[d]] if d < len(jspec) and jspec[d] else n
                             for d, n in enumerate(full[::-1] if kernel else full))
                spec, dim, rows = tp_split(name, full, rules, group.tp, vlm_heads(cfg), group.ep)
                local = list(full)
                if dim is not None:
                    local[dim] = rows.stop - rows.start
                    if spec[dim] == "expert":
                        assert rows == slice(e * full[dim] // n_e, (e + 1) * full[dim] // n_e), name
                got = tuple(local[::-1] if kernel else local)
                port = tuple(spec) + (None,) * (len(full) - len(spec))
                port = port[::-1] if kernel else port
                while port and port[-1] is None:
                    port = port[:-1]
                assert got == want, (name, path, got, want)
                assert port == jspec, (name, path, port, jspec)
    return specs


def test_local_slices_carry_the_jax_specs(dirs, runs):
    """At ``{data: 4, expert: 2}`` (needs no ranks): the banks split
    ``[E/2, ...]`` over ``expert``, the router stays whole, and nothing
    else splits; the JAX test's paths are checked by name too."""
    specs = _check_specs(dirs, runs[0]["continuous"][2], EP)
    for i in range(2):
        for bank in ("w_gate", "w_up", "w_down"):
            assert specs[f"decoder/layers_{i}/mlp/{bank}"] == ("expert",)
        assert specs[f"decoder/layers_{i}/mlp/router"] == ()
    assert specs["decoder/layers_0/attn/q_proj/kernel"] == ()


def test_ep_plus_tp_specs_compose(dirs, runs):
    """At ``{data: 2, expert: 2, model: 2}``: the EP rules win on the banks
    (first match), the TP rules split the dense projections over
    ``model``."""
    specs = _check_specs(dirs, runs[0]["ep_tp"][2], EP_TP)
    assert specs["decoder/layers_0/mlp/w_gate"] == ("expert",)
    assert specs["decoder/layers_0/mlp/router"] == ()
    assert specs["decoder/layers_0/attn/q_proj/kernel"] == (None, "model")
    assert specs["decoder/layers_0/attn/o_proj/kernel"] == ("model",)


@pytest.mark.parametrize("tag", list(EP_RUNS))
def test_decode_at_expert_2_matches_jax(runs, tag):
    want, outs = runs
    tokens, text, _ = want[tag]
    out = outs["ep"][0]
    assert json.loads(str(out[f"{tag}_shape"])) == {"data": 1, "expert": 2}
    assert out[f"{tag}_tokens"].tolist() == tokens
    assert str(out[f"{tag}_text"]) == text
    assert str(out[f"{tag}_stream"]) == text  # the streaming path of the same scheduler
    banks = json.loads(str(out[f"{tag}_banks"]))
    assert banks["decoder.layers.0.mlp.w_gate"][0] == 2 and banks["decoder.layers.0.mlp.router"] == [32, 4]
    assert int(outs["ep"][1]["programs"]) > 0  # the worker ran the programs


def test_decode_at_expert_2_model_2_matches_jax(runs):
    want, outs = runs
    tokens, text, _ = want["ep_tp"]
    out = outs["ep_tp"][0]
    assert json.loads(str(out["continuous_shape"])) == {"data": 1, "expert": 2, "model": 2}
    assert out["continuous_tokens"].tolist() == tokens
    assert str(out["continuous_text"]) == text == str(out["continuous_stream"])
    banks = json.loads(str(out["continuous_banks"]))
    assert banks["decoder.layers.0.mlp.w_gate"][0] == 2
    assert all(int(o["programs"]) > 0 for o in outs["ep_tp"][1:])


def test_shared_expert_moe_at_model_2_matches_jax(runs):
    """The shared expert splits over ``model`` and sums after
    ``down_proj``; the banks stay whole and the routed output is added
    once."""
    want, outs = runs
    tokens, text, specs = want["tp_moe"]
    out = outs["tp_moe"][0]
    assert json.loads(str(out["continuous_shape"])) == {"data": 1, "model": 2}
    assert out["continuous_tokens"].tolist() == tokens
    assert str(out["continuous_text"]) == text
    banks = json.loads(str(out["continuous_banks"]))
    assert banks["decoder.layers.0.mlp.w_gate"] == [4, 32, 48]
    assert banks["decoder.layers.0.mlp.shared.gate_proj.weight"] == [20, 32]
    assert specs["decoder/layers_0/mlp/shared/gate_proj/kernel"] == (None, "model")
    assert specs["decoder/layers_0/mlp/w_gate"] == ()


def test_moe_ffn_on_the_expert_axis(runs):
    """Each rank of the axis, with half of the experts: the exact path is
    the mesh-less one up to the grouped product's rounding (1e-6), the
    same bits on both ranks, and the exact path (also on the plain grouped
    product) and the capacity path are within 1e-5 of the JAX ones."""
    import importlib

    jmoe = importlib.import_module("lumen_tpu.parallel.moe")
    want, outs = runs
    inp = want["moe_in"]
    params = jmoe.MoEParams(*(jnp.asarray(inp[f"moe_{n}"]) for n in ("router", "w_gate", "w_up", "w_down")))
    x = jnp.asarray(inp["moe_x"])
    exact = np.asarray(jmoe._moe_exact_local(params, x, n_experts=MOE_E, k=MOE_K, norm_topk=True))
    drop = np.asarray(jmoe.moe_ffn(params, x, k=MOE_K, capacity_factor=MOE_FACTOR))
    out = outs["ep"][0]
    for r in range(2):
        np.testing.assert_allclose(out[f"moe_exact_{r}"], out[f"moe_plain_{r}"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out[f"moe_plain_ep_{r}"], exact, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out[f"moe_exact_{r}"], exact, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out[f"moe_drop_{r}"], drop, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out["moe_exact_0"], out["moe_exact_1"])


def test_spill_at_expert_2_resumes_with_no_mesh(runs):
    """A row exported from the ``{expert: 2}`` pool (every KV head on each
    rank: the format of a mesh-less host) resumes with no mesh and goes on
    to the uninterrupted run's tokens."""
    out = runs[1]["ep"][0]
    np.testing.assert_array_equal(out["spill_tokens"], out["spill_whole"])
    assert out["spill_pages_shape"][1] == 2  # both KV heads


def test_serve_with_an_expert_axis(dirs, runs, tmp_path_factory):
    """``serve()`` on a config whose VLM service carries ``mesh: {expert:
    2}``: it starts the worker rank itself, answers as the JAX manager at
    ``{data: 4, expert: 2}`` (the continuous engine's greedy prefix), is
    healthy, and ``stop`` ends the worker rank."""
    want = runs[0]["continuous"][0][:8]
    cache = tmp_path_factory.mktemp("ep_serve_cache")
    os.makedirs(cache / "models")
    os.symlink(dirs["moe"], cache / "models" / "TinyMoE")
    config = {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache)},
        "deployment": {"mode": "hub", "services": ["vlm"]},
        "server": {"port": 50997, "host": "127.0.0.1"},
        "services": {"vlm": {
            "enabled": True, "package": "lumen_tpu.models.vlm",
            "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
            "backend_settings": {"dtype": "float32", "batch_size": 2, "mesh": {"axes": {"expert": 2}},
                                 "batch_buckets": [16, 32]},
            "models": {"vlm": {"model": "TinyMoE", "runtime": "jax"}},
        }},
    }
    out = run_ranks("ep_serve", 1, {"meta": {"config": config, "prompt": PROMPT, "max_new": 8}},
                    tmp_path_factory.mktemp("ep_serve"), timeout=150)[0]
    assert json.loads(str(out["vlm_shape"])) == {"expert": 2}
    assert json.loads(str(out["group_shape"])) == {"data": 1, "expert": 2, "model": 1}
    assert out["vlm_tokens"].tolist() == want
    assert bool(out["healthy"])
    assert out["worker_codes"].tolist() == [0]
