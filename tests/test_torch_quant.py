"""The port's weight-only int8 path against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages. The JAX side
runs its own CPU route: ``QDense``'s XLA dequant branch (its Pallas w8a16
kernel is TPU-only), never interpret-mode Pallas. On CPU tensors the
port's ``w8a16_matmul`` runs its plain version, so these tests hold the
plain twin of the CUDA kernel against the JAX math. Tolerances: atol
1e-5 in f32 for single ops, atol 1e-4 for whole-model logits; the
quantization itself must be bitwise equal.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu.models.vlm import modeling as jm
from lumen_tpu.models.vlm.convert import quantize_decoder_int8 as jquantize
from lumen_tpu.ops.quant import QDense as JQDense
from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager
from lumen_tpu_torch.models.vlm import modeling as tm
from lumen_tpu_torch.models.vlm.convert import params_from_jax, quantize_decoder_int8
from lumen_tpu_torch.ops import quant_matmul as tqm
from lumen_tpu_torch.ops.quant import QDense, quantize_linear_int8
from test_vlm import make_vlm_model_dir

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _qparams(rng, k, n):
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.random(n) * 1e-2 + 1e-3).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return q, scale, bias


@pytest.fixture(scope="module")
def jparams():
    cfg = jm.VLMConfig.tiny()
    params = jm.VLMModel(cfg).init(
        jax.random.PRNGKey(2),
        jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3), jnp.float32),
    )["params"]
    return jax.tree.map(np.asarray, params)


class TestW8A16:
    @pytest.mark.parametrize(
        "shape,k,n",
        [
            ((8, 64), 64, 128),  # aligned decode rows
            ((5, 32), 32, 64),  # rows off the 8-row sublane (the JAX wrapper pads them)
            ((2, 5, 64), 64, 192),  # leading dims flatten to rows (a verify window)
            ((1, 1, 896), 896, 128),  # one token at the Qwen2-0.5B k_proj shape
        ],
    )
    def test_reference_matches_jax_qdense(self, shape, k, n):
        rng = np.random.default_rng(k + n + len(shape))
        x = rng.standard_normal(shape).astype(np.float32)
        q, scale, bias = _qparams(rng, k, n)
        want = JQDense(n, use_bias=False).apply(
            {"params": {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}}, jnp.asarray(x)
        )
        got = tqm.w8a16_reference(_t(x), _t(q), _t(scale))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # On CPU tensors the kernel wrapper is exactly the plain version.
        assert torch.equal(tqm.w8a16_matmul(_t(x), _t(q), _t(scale)), got)

    def test_reference_rounds_once_to_the_activation_dtype(self):
        rng = np.random.default_rng(0)
        x = _t(rng.standard_normal((3, 64)).astype(np.float32)).to(torch.bfloat16)
        q, scale, _ = _qparams(rng, 64, 64)
        got = tqm.w8a16_reference(x, _t(q), _t(scale))
        exact = (x.float() @ _t(q).float()) * _t(scale)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, exact.to(torch.bfloat16))

    @pytest.mark.parametrize(
        "k,n,xdtype,qdtype,match",
        [
            (60, 64, torch.bfloat16, torch.int8, "K=60"),
            (64, 96, torch.bfloat16, torch.int8, "N=96"),
            (64, 64, torch.float32, torch.int8, "bfloat16"),
            (64, 64, torch.bfloat16, torch.uint8, "int8"),
        ],
    )
    def test_kernel_refuses_what_it_cannot_take(self, k, n, xdtype, qdtype, match):
        x = torch.zeros((8, k), dtype=xdtype)
        q = torch.zeros((k, n), dtype=qdtype)
        with pytest.raises(ValueError, match=match):
            tqm.check_w8a16_operands(x, q, torch.ones(n))

    def test_kernel_source_names_the_tpu_kernel(self):
        (kernel,) = tqm.KERNELS
        text = kernel.source_path.read_text()
        assert f'extern "C" int {kernel.symbol}(' in text
        assert "lumen_tpu/ops/quant_matmul.py:76" in text
        assert kernel.launches == 0  # nothing on the CPU launches it


#: (K, N) of the decoder's projections (Qwen2-0.5B), as chip_smoke.Q8_SHAPES.
QWEN_PROJECTIONS = {"q_proj/o_proj": (896, 896), "k_proj/v_proj": (896, 128),
                    "gate_proj/up_proj": (896, 4864), "down_proj": (4864, 896)}


def split_k_emulation(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic (``csrc/w8a16_matmul.cu``) on the CPU: rows
    in zero-padded 16-row tiles; K cut into ``w8a16_parts(K, N)`` parts of
    whole 64-deep chunks, each part an fp32 sum of 16-deep products in K
    order (one ``mma.sync`` k-step each); the parts added in part order;
    scale in fp32; one rounding to bf16. ``x`` holds bf16 values."""
    m, k = x.shape
    n = q.shape[1]
    c = tqm.w8a16_constants()
    parts = tqm.w8a16_parts(k, n)
    chunks = -(-k // c["depth"])
    qf = q.float()
    out = torch.empty(m, n, dtype=torch.bfloat16)
    for m0 in range(0, m, c["rows"]):
        xt = torch.zeros(c["rows"], k)
        xt[: min(c["rows"], m - m0)] = x[m0:m0 + c["rows"]].float()
        total = None
        for p in range(parts):
            k0, k1 = p * chunks // parts * c["depth"], min((p + 1) * chunks // parts * c["depth"], k)
            acc = torch.zeros(c["rows"], n)
            for kb in range(k0, k1, 16):
                acc = acc + xt[:, kb:kb + 16] @ qf[kb:kb + 16]
            total = acc if total is None else total + acc
        out[m0:m0 + c["rows"]] = (total * scale)[: min(c["rows"], m - m0)].bfloat16()
    return out


class TestW8A16Split:
    def test_split_is_a_function_of_k_and_n(self):
        """The K split of each projection shape, and its blocks: enough to
        fill the H100's 132 SMs where the shape allows it, at most 528."""
        want = {"q_proj/o_proj": 8, "k_proj/v_proj": 8, "gate_proj/up_proj": 4, "down_proj": 8}
        for name, (k, n) in QWEN_PROJECTIONS.items():
            assert tqm.w8a16_parts(k, n) == want[name], name
            assert tqm.w8a16_grid(8, k, n) == (n // 64, want[name], 1, 1)
            for rows in (1, 40, 64):
                tiles, parts, z, rt = tqm.w8a16_grid(rows, k, n)
                assert (tiles, parts) == (n // 64, want[name])  # the split never follows M
                assert z * rt * 16 >= rows and tiles * parts * z <= 528
        # gate/up at 40 rows: every row tile in one block (304 blocks, not 912)
        assert tqm.w8a16_grid(40, 896, 4864) == (76, 4, 1, 3)
        assert tqm.w8a16_grid(40, 4864, 896) == (14, 8, 3, 1)

    @pytest.mark.parametrize("name", list(QWEN_PROJECTIONS))
    def test_emulation_against_jax(self, name):
        """The split-K emulation against the JAX package's dequant product
        (``QDense``'s XLA branch, fp32) within chip_smoke.py's 1e-2 +
        1e-2|ref|, and row r's bits the same in calls of 1, 8, 40 and 64
        rows."""
        k, n = QWEN_PROJECTIONS[name]
        rng = np.random.default_rng(k + n)
        x = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32)).bfloat16().float()
        q = rng.integers(-127, 128, (k, n)).astype(np.int8)
        scale = (rng.random(n) * 1e-3 + 1e-4).astype(np.float32)
        got = split_k_emulation(x, _t(q), _t(scale))
        want = np.asarray(JQDense(n, use_bias=False).apply(
            {"params": {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}}, jnp.asarray(x.numpy())))
        diff = np.abs(got.float().numpy() - want)
        assert np.isfinite(got.float().numpy()).all()
        assert (diff <= 1e-2 + 1e-2 * np.abs(want)).all(), f"max |diff| {diff.max():.3e}"
        for rows in (1, 8, 40):
            assert torch.equal(split_k_emulation(x[:rows], _t(q), _t(scale)), got[:rows]), rows


class TestQDense:
    @pytest.mark.parametrize("bias", [True, False])
    def test_matches_jax_qdense(self, bias):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 3, 32)).astype(np.float32)
        q, scale, b = _qparams(rng, 32, 48)
        jp = {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}
        if bias:
            jp["bias"] = jnp.asarray(b)
        want = JQDense(48, use_bias=bias).apply({"params": jp}, jnp.asarray(x))
        layer = QDense(32, 48, bias=bias)
        layer.load_state_dict({"q": _t(q), "scale": _t(scale), **({"bias": _t(b)} if bias else {})})
        with torch.no_grad():
            got = layer(_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_routes_decode_rows_to_the_kernel_wrapper(self, monkeypatch):
        """bf16 calls of <= 64 rows take w8a16_matmul; more rows, or f32
        activations, take the matrix-product branch (JAX's routing)."""
        from lumen_tpu_torch.ops import quant

        calls = []
        def spy(x, q, s):
            calls.append(x.shape)
            return tqm.w8a16_reference(x, q, s)

        monkeypatch.setattr(quant, "w8a16_matmul", spy)
        layer = QDense(64, 64, bias=False).to(torch.bfloat16)
        layer(torch.zeros((8, 5, 64), dtype=torch.bfloat16))  # 40 rows: a verify window
        layer(torch.zeros((1, 65, 64), dtype=torch.bfloat16))  # a prefill chunk
        layer(torch.zeros((8, 64)))  # f32
        assert calls == [(8, 5, 64)]

    def test_scale_and_q_keep_their_dtypes(self):
        layer = QDense(8, 16).to(dtype=torch.bfloat16)
        assert layer.q.dtype == torch.int8 and layer.scale.dtype == torch.float32
        assert layer.bias.dtype == torch.bfloat16
        assert set(layer.state_dict()) == {"q", "scale", "bias"}

    def test_dynamic_mode_waits_for_the_clip_slice(self):
        with pytest.raises(NotImplementedError, match="CLIP"):
            QDense(8, 8, kernel_mode="dynamic")
        with pytest.raises(ValueError):
            QDense(8, 8, kernel_mode="int4")


class TestQuantizeState:
    def test_decoder_quantization_is_bitwise_the_jax_one(self, jparams):
        want = jquantize(jparams)
        got = quantize_decoder_int8(params_from_jax(jparams))
        converted = params_from_jax(want)
        assert set(got) == set(converted)
        n_q = 0
        for key, value in converted.items():
            assert got[key].dtype == value.dtype, key
            assert torch.equal(got[key], value), key
            n_q += key.endswith(".q")
        cfg = VLMConfig.tiny().decoder
        assert n_q == 7 * cfg.layers  # tied lm_head stays float
        assert "vision.proj_fc1.weight" in got  # the vision tower is never quantized

    def test_untied_lm_head_is_quantized(self):
        w = torch.randn(40, 16)
        state = quantize_decoder_int8({"decoder.lm_head.weight": w, "decoder.embed_tokens.weight": w})
        assert set(state) == {"decoder.lm_head.q", "decoder.lm_head.scale", "decoder.embed_tokens.weight"}
        q, scale = quantize_linear_int8(w)
        assert q.shape == (16, 40) and torch.equal(state["decoder.lm_head.q"], q)
        # Reconstruction error is at most half a quantization step.
        assert torch.all((q.float() * scale - w.T).abs() <= scale * 0.5 + 1e-8)

    def test_params_from_jax_keeps_int8_leaves(self, jparams):
        sd = params_from_jax(jquantize(jparams))
        q = sd["decoder.layers.0.attn.q_proj.q"]
        j = jquantize(jparams)["decoder"]["layers_0"]["attn"]["q_proj"]
        assert q.dtype == torch.int8 and q.shape == j["q"].shape  # [in, out], untransposed
        np.testing.assert_array_equal(q.numpy(), j["q"])
        assert sd["decoder.layers.0.attn.q_proj.scale"].dtype == torch.float32
        assert sd["decoder.final_norm.weight"].dtype == torch.float32  # norm scale renamed as before


def test_int8_model_logits_match_jax(jparams):
    """The tiny int8 VLM (every decoder projection a QDense) against the
    JAX int8 model on the same quantized weights, with an image."""
    jcfg = jm.VLMConfig.tiny()
    jq = dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder, weight_quant="int8"))
    qparams = jquantize(jparams)
    tcfg = VLMConfig.tiny()
    tq = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, weight_quant="int8"))
    tmodel = tm.VLMModel(tq)
    tmodel.load_state_dict(params_from_jax(qparams), strict=True)
    assert sum(isinstance(m, QDense) for m in tmodel.modules()) == 7 * tcfg.decoder.layers
    rng = np.random.default_rng(9)
    ids = rng.integers(3, 200, (2, 9)).astype(np.int32)
    ids[:, 1] = jcfg.image_token_id
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jm.VLMModel(jq).apply({"params": qparams}, jnp.asarray(ids), jnp.asarray(pixels))
    with torch.no_grad():
        got = tmodel.eval()(_t(ids).long(), _t(pixels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def int8_managers(tmp_path_factory):
    """The JAX manager with ``quantize="int8"`` on the tiny model dir (as
    ``tests/test_vlm_quant.py`` builds it) and the port's on the same
    float weights (the JAX manager of the same dir, unquantized)."""
    model_dir = make_vlm_model_dir(tmp_path_factory.mktemp("torch_vlmq"))
    os.remove(os.path.join(model_dir, "tokenizer_config.json"))
    kw = dict(dtype="float32", max_seq=128, max_new_cap=8, prefill_buckets=(16, 32))
    jq = JVLMManager(model_dir, quantize="int8", **kw)
    jq.initialize()
    jf = JVLMManager(model_dir, **kw)
    jf.initialize()
    state = params_from_jax(jax.tree.map(np.asarray, jf.params))
    jf.close()
    from tokenizers import Tokenizer

    tok = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    tq = VLMManager(VLMConfig.tiny(), state, tok, device="cpu", quantize="int8", name="q8", **kw)
    yield jq, tq, state, tok
    tq.close()
    jq.close()


def test_int8_manager_greedy_tokens_match_jax(int8_managers):
    jq, tq, _, _ = int8_managers
    assert jq.quant_route == "int8"
    dec = tq.model.decoder
    mlps = [getattr(layer.mlp, n) for layer in dec.layers for n in ("gate_proj", "up_proj", "down_proj")]
    assert all(isinstance(m, QDense) for m in mlps)
    for prompt in ("describe the image", "a cat and a dog"):
        want = jq.generate([JChatMessage(role="user", content=prompt)], max_new_tokens=8)
        got = tq.generate([ChatMessage(role="user", content=prompt)], max_new_tokens=8)
        assert got.tokens == want.tokens, prompt
        assert got.text == want.text


def test_int8_manager_refuses_other_quantizations(int8_managers):
    _, _, state, tok = int8_managers
    with pytest.raises(ValueError, match="int8"):
        VLMManager(VLMConfig.tiny(), state, tok, device="cpu", dtype="float32", quantize="int4")


def test_int8_with_speculation_matches_int8_alone(int8_managers, monkeypatch):
    """The two settings compose: the int8 engine with LUMEN_VLM_SPEC_K=4
    takes verify turns and answers the tokens the int8 engine answers
    without them (and the JAX int8 manager answers)."""
    jq, tq, state, tok = int8_managers
    monkeypatch.setenv("LUMEN_VLM_SPEC_K", "4")
    monkeypatch.setenv("LUMEN_VLM_SPEC_MIN_RATE", "0")
    # Blocks of 2 leave room for verify turns inside an 8-token budget.
    spec = VLMManager(
        VLMConfig.tiny(), state, tok, device="cpu", dtype="float32", max_seq=128, max_new_cap=8,
        prefill_buckets=(16, 32), gen_block=2, quantize="int8", name="q8-spec",
    )
    try:
        prompt = "the quick brown fox jumps over the lazy dog again and again and again"
        got = spec.generate([ChatMessage(role="user", content=prompt)], max_new_tokens=8)
        assert got.tokens == tq.generate([ChatMessage(role="user", content=prompt)], max_new_tokens=8).tokens
        assert got.tokens == jq.generate([JChatMessage(role="user", content=prompt)], max_new_tokens=8).tokens
        assert spec.engine.spec_turns > 0 and spec.engine.spec_proposed > 0
    finally:
        spec.close()
