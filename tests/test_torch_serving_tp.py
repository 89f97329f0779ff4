"""The port serving over a ``model`` axis against the JAX package's mesh
runs (the counterparts of ``tests/test_serving_tp.py``).

The JAX side runs in the pytest process on the simulated 8-device CPU
mesh at ``{data: 4, model: 2}``. The port runs in 2 gloo ranks of a
tensor-parallel serving group (``tests/torch_spmd_ranks.py``'s ``tp_*``
cases): rank 0 drives the managers, rank 1 runs the worker loop, and the
``data`` axis degrades to 1 (one replica on the group's two ranks). Both
read the same tiny model directories (``tests/test_vlm.py``'s VLM with its
chat template removed, so both render the plain transcript;
``tests/clip_fixtures.py``'s CLIP) in float32:

- each rank's local slices carry the JAX specs (no ranks needed);
- VLM greedy tokens and text equal the JAX ``VLMManager``'s for the
  continuous engine, the coalescer and int8 ``dequant`` and ``dynamic``;
- CLIP embeddings are within the JAX test's own ``rtol = atol = 2e-5`` in
  f32 and in int8 (both kernels);
- a config with ``mesh: {model: 2}`` serves through ``serve()``, which
  starts the worker rank itself;
- a row spilled from the TP pool resumes at TP = 1 to the same tokens;
- a view of a rank-local tensor passed to a program is refused;
- a killed worker fails rank 0's next call within the group timeout;
- a model axis the group cannot fill raises, replicas beyond the group's
  one data place degrade to one, and the MoE decoder serves on a model
  axis.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu_torch.models.vlm.convert import convert_vlm_checkpoint, quantize_decoder_int8, tree_paths
from lumen_tpu_torch.models.vlm.manager import build_config, vlm_heads
from lumen_tpu_torch.models.vlm.modeling import VLMModel
from lumen_tpu_torch.parallel.sharding import INT8_TP_RULES, TRANSFORMER_TP_RULES, tp_split
from lumen_tpu_torch.parallel.tp import TensorParallel
from tests.clip_fixtures import make_clip_model_dir, png_bytes
from tests.test_serving_tp import _leaf_sharding_specs, make_moe_model_dir
from tests.test_vlm import make_vlm_model_dir
from tests.torch_spmd_ranks import run_ranks

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs the simulated 8-device mesh")

PROMPT = "describe the image"
MAX_NEW = 12
TEXT = "a photo of a cat"
MESH = {"data": 4, "model": 2}
#: the port's VLM runs (rank case ``tp_vlm``) and their JAX manager options
VLM_RUNS = {
    "continuous": ({"scheduler": "continuous", "gen_slots": 2, "gen_block": 4}, None),
    "coalesce": ({"scheduler": "coalesce"}, None),
    "int8_dequant": ({"quantize": "int8"}, "dequant"),
    "int8_dynamic": ({"quantize": "int8"}, "dynamic"),
}
CLIP_RUNS = {"f32": (None, None), "int8_dynamic": ("int8", "dynamic"), "int8_dequant": ("int8", "dequant")}
#: the group timeout of the killed-worker case, and the margin the call may take past it
DEATH_TIMEOUT_S, DEATH_MARGIN_S = 10.0, 20.0
#: the port's rank spawns run beside the JAX managers of the same fixture
_POOL = ThreadPoolExecutor(max_workers=2)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tp")
    vlm = make_vlm_model_dir(root / "vlm")
    os.remove(os.path.join(vlm, "tokenizer_config.json"))
    return {"vlm": vlm, "moe": make_moe_model_dir(root / "moe"), "clip": make_clip_model_dir(root / "clip"),
            "root": root}


def _jax_vlm(model_dir, kernel=None, **kw):
    with pytest.MonkeyPatch.context() as mp:
        if kernel:
            mp.setenv("LUMEN_Q8_KERNEL", kernel)
        mgr = JVLMManager(model_dir, dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32),
                          gen_batch_size=2, gen_batch_latency_ms=1.0, **kw)
        mgr.initialize()
    return mgr


def _gap_note(mgr, want: list[int], got: list[int]) -> str:
    """Where two greedy runs part, the JAX model's top-2 logit gap there
    (a near tie explains a flip; a wide gap is a fault)."""
    i = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), min(len(want), len(got)))
    try:
        ids = mgr._encode_prompt([JChatMessage(role="user", content=PROMPT)], False) + list(want[:i])
        logits = np.asarray(mgr.model.apply({"params": mgr.params}, np.asarray([ids], np.int32)))[0, -1]
        top = np.sort(logits)[-2:]
        return f"first difference at token {i}: JAX top-2 logit gap {float(top[1] - top[0]):.3e}"
    except Exception as e:  # noqa: BLE001 - the note is best effort
        return f"first difference at token {i} (logit gap not computed: {e})"


@pytest.fixture(scope="module")
def vlm_runs(dirs, tmp_path_factory):
    """The JAX managers' answers (and the leaf specs of the plain and the
    int8 ``dequant`` placements), while the port's ``tp_vlm`` ranks run."""
    meta = dict(vlm_dir=dirs["vlm"], moe_dir=dirs["moe"], prompt=PROMPT, max_new=MAX_NEW)
    ranks = _POOL.submit(run_ranks, "tp_vlm", 2, {"meta": meta}, tmp_path_factory.mktemp("tp_vlm"), timeout=150)
    want = {}
    for tag, (kw, kernel) in VLM_RUNS.items():
        mgr = _jax_vlm(dirs["vlm"], kernel=kernel, mesh_axes=MESH, **kw)
        try:
            r = mgr.generate([JChatMessage(role="user", content=PROMPT)], max_new_tokens=MAX_NEW)
            want[tag] = (list(r.tokens), r.text, mgr)
            if tag in ("continuous", "int8_dequant"):
                want[f"{tag}_specs"] = _leaf_sharding_specs(mgr.params)
        finally:
            mgr.close()
    return want, ranks.result()


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_local_slices_carry_the_jax_specs(dirs, vlm_runs, quant):
    """Every rank's local slice of every parameter is the JAX shard of the
    same leaf at ``{data: 4, model: 2}`` (transposed where the layout is),
    and its spec the JAX spec; the paths the JAX tests name are checked by
    name too."""
    specs = vlm_runs[0]["int8_dequant_specs" if quant == "int8" else "continuous_specs"]
    from lumen_tpu_torch.core.model_info import load_model_info
    from lumen_tpu_torch.runtime.weights import load_state_dict

    cfg = build_config(dirs["vlm"], load_model_info(dirs["vlm"]))
    state = convert_vlm_checkpoint(load_state_dict(dirs["vlm"]), tie_word_embeddings=cfg.decoder.tie_word_embeddings)
    rules = TRANSFORMER_TP_RULES
    if quant == "int8":
        import dataclasses

        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, weight_quant="int8"))
        state = quantize_decoder_int8(state)
        rules = INT8_TP_RULES + TRANSFORMER_TP_RULES
    import torch

    with torch.device("meta"):
        paths = tree_paths(VLMModel(cfg))
    assert set(paths) == set(state)
    seen = {}
    for name, t in state.items():
        path = paths[name]
        kernel = path.endswith("/kernel")
        full = tuple(t.shape)
        jspec = specs[path]
        want = tuple(n // 2 if d < len(jspec) and jspec[d] == "model" else n
                     for d, n in enumerate(full[::-1] if kernel else full))
        for rank in (0, 1):
            spec, dim, rows = tp_split(name, full, rules, TensorParallel(2, rank), vlm_heads(cfg))
            local = list(full)
            if dim is not None:
                local[dim] = rows.stop - rows.start
            got = tuple(local[::-1] if kernel else local)
            port = tuple(spec) + (None,) * (len(full) - len(spec))
            port = port[::-1] if kernel else port
            while port and port[-1] is None:
                port = port[:-1]
            assert got == want, (name, path, got, want)
            assert port == jspec, (name, path, port, jspec)
        seen[path] = jspec
    named = {
        "bf16": {
            "decoder/layers_0/attn/q_proj/kernel": (None, "model"),
            "decoder/layers_0/attn/o_proj/kernel": ("model",),
            "decoder/layers_0/mlp/gate_proj/kernel": (None, "model"),
            "decoder/layers_0/mlp/down_proj/kernel": ("model",),
            "decoder/final_norm/scale": (),
        },
        "int8": {
            "decoder/layers_0/attn/q_proj/q": (None, "model"),
            "decoder/layers_0/attn/q_proj/scale": ("model",),
            "decoder/layers_0/attn/o_proj/q": ("model",),
            "decoder/layers_0/attn/o_proj/scale": (),
            "decoder/layers_0/mlp/gate_proj/q": (None, "model"),
            "decoder/layers_0/mlp/down_proj/q": ("model",),
            "decoder/embed_tokens/embedding": (None, "model"),
            "decoder/final_norm/scale": (),
        },
    }[quant]
    for path, spec in named.items():
        assert seen[path] == spec, path


def test_kv_heads_below_the_axis_keep_whole_heads():
    """Qwen2-0.5B's 14 query and 2 KV heads at model = 2 and 14: whole
    heads only; at model 4 the query heads do not divide and the block
    replicates (JAX would cut a KV head in half)."""
    two = [TensorParallel(2, r).attn_plan(14, 2) for r in range(2)]
    assert [(p.q_lo, p.q_heads, p.kv_lo, p.kv_heads, p.kv_owner) for p in two] == [(0, 7, 0, 1, True),
                                                                                 (7, 7, 1, 1, True)]
    fourteen = [TensorParallel(14, r).attn_plan(14, 2) for r in range(14)]
    assert all(p.split and p.q_heads == 1 and p.kv_heads == 1 and p.kv_lo == r // 7 for r, p in enumerate(fourteen))
    assert [r for r, p in enumerate(fourteen) if p.kv_owner] == [0, 7]
    assert not TensorParallel(4, 1).attn_plan(14, 2).split
    _, dim, rows = tp_split("decoder.layers.0.attn.k_proj.weight", (128, 896), TRANSFORMER_TP_RULES,
                            TensorParallel(14, 9), lambda n: (14, 2, 64))
    assert (dim, rows) == (0, slice(64, 128))


@pytest.mark.parametrize("tag", list(VLM_RUNS))
def test_vlm_decode_at_model_2_matches_jax(vlm_runs, tag):
    want, outs = vlm_runs
    tokens, text, jmgr = want[tag]
    got = outs[0][f"{tag}_tokens"].tolist()
    assert json.loads(str(outs[0][f"{tag}_shape"])) == {"data": 1, "model": 2}
    assert got == tokens, _gap_note(jmgr, tokens, got)
    assert str(outs[0][f"{tag}_text"]) == text
    assert str(outs[0][f"{tag}_stream"]) == text  # the streaming path of the same scheduler
    assert int(outs[1]["programs"]) > 0  # the worker ran the programs


def test_int8_route_ab_runs_on_the_group(vlm_runs):
    """``quantize: int8`` with ``warmup`` and ``LUMEN_VLM_Q8_ROUTE=auto``:
    the A/B's probes (a throwaway pool, prefill, admission, decode blocks)
    run as programs of the group, and the route it picks serves the tokens
    of that route's JAX run."""
    want, outs = vlm_runs
    out = outs[0]
    route = str(out["ab_route"])
    assert route in ("int8", "bf16") and float(out["ab_speedup"]) > 0
    assert out["ab_tokens"].tolist() == want["int8_dequant" if route == "int8" else "continuous"][0]


def test_spill_from_tp_resumes_at_tp_1(vlm_runs):
    """A row exported from the TP = 2 pool (each rank's KV head gathered
    to rank 0: the TP = 1 format) resumes on a TP = 1 generator and
    goes on to the uninterrupted TP = 1 run's tokens."""
    _, outs = vlm_runs
    out = outs[0]
    np.testing.assert_array_equal(out["spill_tokens"], out["spill_whole"])
    assert out["spill_pages_shape"][1] == 2  # both KV heads
    assert float(out["spill_pages_err"]) < 1e-5


def test_views_of_rank_local_tensors_are_refused(vlm_runs):
    """A program argument that views a rank-local tensor -- a slice of a KV
    cache, a cache's tensor, a parameter's row, a tensor nested in a list a
    program returned -- would reach each worker as rank 0's values: it is
    refused before the header goes out, so no program is sent and the group
    serves on; a host tensor still goes by value, also after a program
    returned a view of it (every rank holds the same values there)."""
    out = vlm_runs[1][0]
    refused = json.loads(str(out["refused"]))
    for tag in ("cache_slice", "cache_tensor", "parameter_row", "nested"):
        assert "view of a rank-local tensor" in refused[tag], (tag, refused[tag])
        assert refused[f"{tag}_sent"] == 0, tag
    np.testing.assert_array_equal(out["by_value"], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(out["head"], [0.0, 1.0])
    assert bool(out["after_refusals"])


def test_hard_limits_raise(vlm_runs):
    """A model axis the group cannot fill raises; ``LUMEN_REPLICAS=2`` on
    a group of one data place degrades to one replica, as the JAX plan
    degrades a count its devices cannot hold (replicas of a group, which
    raised here until they were ported: ``tests/test_torch_dp_tp.py``); the
    MoE decoder, which raised here until its expert and tensor parallelism
    was ported, serves on the model axis (its tokens against the JAX
    manager's: ``tests/test_torch_serving_ep.py``)."""
    limits = json.loads(str(vlm_runs[1][0]["limits"]))
    assert limits["axis"].startswith("ValueError") and "needs 4 devices" in limits["axis"]
    assert limits["replicas"] == '1 replica(s) served 4 tokens on {"data": 1, "model": 2}', limits["replicas"]
    assert limits["moe"] == '1 replica(s) served 4 tokens on {"data": 1, "model": 2}', limits["moe"]


@pytest.fixture(scope="module")
def clip_runs(dirs, tmp_path_factory):
    from lumen_tpu.models.clip.manager import CLIPManager as JCLIPManager

    inputs = {"meta": {"clip_dir": dirs["clip"], "text": TEXT, "tp_timeout": DEATH_TIMEOUT_S},
              "image": np.frombuffer(png_bytes(0), np.uint8), "image2": np.frombuffer(png_bytes(1), np.uint8)}
    ranks = _POOL.submit(run_ranks, "tp_clip", 2, inputs, tmp_path_factory.mktemp("tp_clip"), timeout=150,
                         killed=(1,))
    want = {}
    for tag, (quant, kernel) in CLIP_RUNS.items():
        with pytest.MonkeyPatch.context() as mp:
            if kernel:
                mp.setenv("LUMEN_Q8_KERNEL", kernel)
            mgr = JCLIPManager(dirs["clip"], dtype="float32", batch_size=2, mesh_axes=MESH, quantize=quant)
            mgr.initialize()
        try:
            want[tag] = (mgr.encode_image(png_bytes(0)), mgr.encode_text(TEXT))
        finally:
            mgr.close()
    return want, ranks.result()[0]


@pytest.mark.parametrize("tag", list(CLIP_RUNS))
def test_clip_at_model_2_matches_jax(clip_runs, tag):
    want, out = clip_runs
    assert json.loads(str(out[f"{tag}_shape"])) == {"data": 1, "model": 2}
    np.testing.assert_allclose(out[f"{tag}_image"], want[tag][0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out[f"{tag}_text"], want[tag][1], rtol=2e-5, atol=2e-5)


def test_killed_worker_fails_the_call_within_the_timeout(clip_runs):
    _, out = clip_runs
    assert bool(out["alive_before"])
    assert str(out["death_error"]), "the call after the kill did not fail"
    assert float(out["death_s"]) < DEATH_TIMEOUT_S + DEATH_MARGIN_S
    assert not bool(out["alive_after"])


def test_serve_with_a_model_axis(dirs, vlm_runs, clip_runs, tmp_path_factory):
    """``serve()`` on a config whose services carry ``mesh: {model: 2}``
    (with a data axis, as ``TestServiceMeshConfig``): the VLM service
    keeps the mesh, both services answer as the JAX managers at ``{data:
    4, model: 2}`` (the greedy prefix of the continuous engine's run; the
    f32 CLIP embedding), Health is ok, and ``stop`` ends the worker rank."""
    want = vlm_runs[0]["continuous"][0][:8]
    want_image = clip_runs[0]["f32"][0]
    mesh = {"axes": MESH}

    def service(registry, package, models, **bs):
        return {"enabled": True, "package": package, "import_info": {"registry_class": registry},
                "backend_settings": {"dtype": "float32", "batch_size": 2, "mesh": mesh, **bs}, "models": models}

    cache = tmp_path_factory.mktemp("tp_serve_cache")
    os.makedirs(cache / "models")
    os.symlink(dirs["vlm"], cache / "models" / "TinyVLM")
    os.symlink(dirs["clip"], cache / "models" / "TinyCLIP")
    config = {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(cache)},
        "deployment": {"mode": "hub", "services": ["vlm", "clip"]},
        "server": {"port": 50998, "host": "127.0.0.1"},
        "services": {
            "vlm": service("lumen_tpu.serving.services.vlm_service.VlmService", "lumen_tpu.models.vlm",
                           {"vlm": {"model": "TinyVLM", "runtime": "jax"}}, batch_buckets=[16, 32]),
            "clip": service("lumen_tpu.serving.services.clip_service.ClipService", "lumen_tpu.models.clip",
                            {"clip": {"model": "TinyCLIP", "runtime": "jax"}}),
        },
    }
    inputs = {"meta": {"config": config, "prompt": PROMPT, "max_new": 8},
              "image": np.frombuffer(png_bytes(0), np.uint8)}
    out = run_ranks("tp_serve", 1, inputs, tmp_path_factory.mktemp("tp_serve"), timeout=150)[0]
    assert json.loads(str(out["vlm_shape"])) == {"data": 1, "model": 2}
    assert out["vlm_tokens"].tolist() == want
    np.testing.assert_allclose(out["clip_image"], want_image, rtol=2e-5, atol=2e-5)
    assert out["healthy"].tolist() == [True, True]
    assert out["worker_codes"].tolist() == [0]
