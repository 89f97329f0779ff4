"""A Qwen2-MoE VLM served by the port's managers against the JAX
package's, on the CPU in f32.

One model directory, written by the port's stand-in writer
(``lumen_tpu_torch/testing/vlm_standins.py``: HF ``Qwen2MoeForCausalLM``
names, ``config.json`` with the MoE keys) from the JAX Flax init of the
tiny MoE VLM (``tests/test_vlm_moe.py``'s sizes: 2 layers, hidden 32, 4
experts, top-2, a shared expert of 40), with its ``tokenizer_config.json``
removed (the plain ``<|role|>`` transcript both packages render alike).
Each package loads it with its own converter. Greedy tokens must be
identical: the port's paged continuous engine, its coalescer and its
engine with ``LUMEN_VLM_SPEC_K=4`` against the JAX continuous engine and
coalescer; the port's int8 route against the JAX int8 manager.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import pytest

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu.models.vlm import modeling as jm
from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, params_from_jax
from lumen_tpu_torch.ops.quant import QDense
from lumen_tpu_torch.testing.vlm_standins import write_model_dir
from test_vlm import png_bytes

KW = dict(dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32))
LONG = " ".join(f"w{i}" for i in range(16, 36))  # the 32 bucket
#: (prompt, image seed or None, max_new_tokens)
REQUESTS = [
    ("describe the image", 1, 8),
    ("a cat", None, 5),
    (LONG, None, 9),
    ("the dog a cat", 2, 12),
]
MOE = dict(moe_experts=4, moe_top_k=2, moe_intermediate_size=48, moe_shared_intermediate=40, moe_norm_topk=False)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    jcfg = jm.VLMConfig.tiny()
    jcfg = dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder, **MOE))
    params = jm.VLMModel(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                                    jnp.zeros((1, 32, 32, 3)))["params"]
    tcfg = VLMConfig.tiny()
    tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, **MOE))
    path = write_model_dir(tmp_path_factory.mktemp("tvlm_moe"), "TinyMoE", tcfg, params_from_jax(params))
    os.remove(path / "tokenizer_config.json")
    return str(path)


def _ask(mgr, cls, prompt, seed, n):
    return mgr.generate([cls(role="user", content=prompt)], image_bytes=None if seed is None else png_bytes(seed=seed),
                        max_new_tokens=n)


@pytest.fixture(scope="module")
def jax_answers(model_dir):
    """Greedy tokens of the JAX continuous engine and its coalescer."""
    out = {}
    for sched in ("continuous", "coalesce"):
        mgr = JVLMManager(model_dir, scheduler=sched, **KW)
        mgr.initialize()
        try:
            out[sched] = [_ask(mgr, JChatMessage, *r).tokens for r in REQUESTS]
        finally:
            mgr.close()
    assert out["continuous"] == out["coalesce"]
    return out["continuous"]


def test_config_and_layers(model_dir):
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", **KW)
    try:
        dec = mgr.cfg.decoder
        assert (dec.moe_experts, dec.moe_top_k, dec.moe_shared_intermediate, dec.moe_norm_topk) == (4, 2, 40, False)
        assert all(type(layer.mlp).__name__ == "MoEFFN" for layer in mgr.model.decoder.layers)
    finally:
        mgr.close()


def test_paged_engine_matches_jax(model_dir, jax_answers):
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", gen_slots=4, gen_block=4, **KW)
    try:
        got: dict[int, list] = {}

        def run(i):
            got[i] = _ask(mgr, ChatMessage, *REQUESTS[i]).tokens

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(REQUESTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [got[i] for i in range(len(REQUESTS))] == jax_answers
    finally:
        mgr.close()


def test_coalescer_matches_jax(model_dir, jax_answers):
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", scheduler="coalesce", gen_batch_size=4,
                                    gen_batch_latency_ms=30.0, **KW)
    try:
        assert [_ask(mgr, ChatMessage, *r).tokens for r in REQUESTS] == jax_answers
    finally:
        mgr.close()


def test_speculation_matches_jax(model_dir, jax_answers, monkeypatch):
    monkeypatch.setenv("LUMEN_VLM_SPEC_K", "4")
    monkeypatch.setenv("LUMEN_VLM_SPEC_MIN_RATE", "0")
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", gen_block=2, **KW)
    try:
        assert [_ask(mgr, ChatMessage, *r).tokens for r in REQUESTS] == jax_answers
        assert mgr.engine.spec_turns > 0
    finally:
        mgr.close()


def test_int8_route_matches_jax(model_dir):
    jq = JVLMManager(model_dir, quantize="int8", **KW)
    jq.initialize()
    try:
        want = [_ask(jq, JChatMessage, *r).tokens for r in REQUESTS]
    finally:
        jq.close()
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", quantize="int8", **KW)
    try:
        assert mgr.quant_route == "int8"
        dec = mgr.model.decoder
        qd = {n for n, m in dec.named_modules() if isinstance(m, QDense)}
        assert qd == {f"layers.{i}.{p}" for i in range(2) for p in (
            "attn.q_proj", "attn.k_proj", "attn.v_proj", "attn.o_proj",
            "mlp.shared.gate_proj", "mlp.shared.up_proj", "mlp.shared.down_proj")}  # lm_head is tied here
        assert all(layer.mlp.w_gate.dtype.is_floating_point for layer in dec.layers)
        assert [_ask(mgr, ChatMessage, *r).tokens for r in REQUESTS] == want
    finally:
        mgr.close()
