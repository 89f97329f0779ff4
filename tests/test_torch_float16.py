"""``dtype: float16`` in the port against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages in float16 (the
JAX Pallas kernels in interpret mode, as the JAX package's own tests run
them, and its ``*_reference`` functions):

- the plain versions of the four attention kernels -- what each wrapper
  runs on CPU tensors, and what ``chip_smoke.py`` holds the float16 CUDA
  instances to -- at head_dim 16/64/128 (flash) and 64/128 (the others),
  GQA groups 1 and 7, causal and not, uneven lengths: float16 outputs
  within 4e-3 of the interpret-mode kernels and 2e-3 of the references
  (a few float16 ulps at |out| <= 1: the two round P and the output at
  other places);
- the MoE grouped product's plain routes in float16 and float32 against
  ``lax.ragged_dot``, empty groups included, and ``moe_ffn``'s exact path
  against the JAX ``moe`` module (float32 1e-5; float16 1e-2 of values of
  order 1: each product rounds to float16 in both packages, in other
  orders);
- the tiny VLM manager at ``dtype: float16`` with speculation
  (``LUMEN_VLM_SPEC_K=4``): greedy tokens equal the JAX manager's, and the
  first step's logits within cosine 0.9999; CLIP embeddings (cosine
  0.9999) and OCR answers (boxes, texts) at float16 as the JAX managers';
- a spill at float16: the payload unpacks with the JAX ``migration``
  module into float16 leaves of the JAX record's shapes and byte count,
  and the row resumes to the tokens it gives unpressured;
- the dispatch that needs no card: the dtype codes of ``csrc/common.cuh``,
  the paged walk's float16 shapes and plans equal bf16's (and the bf16
  and fp32 plans as they were), launch counts by type.
"""

from __future__ import annotations

import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu.models.vlm import migration as jmigration
from lumen_tpu.models.vlm import modeling as jm
from lumen_tpu.models.vlm.continuous import ContinuousScheduler as JScheduler
from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager, params_from_jax
from lumen_tpu_torch.models.vlm import modeling as tm
from lumen_tpu_torch.ops import attention as tatt
from lumen_tpu_torch.ops.cuda_build import CSRC, CudaKernel
from lumen_tpu_torch.parallel import moe as tmoe
from test_torch_spill import assert_balanced, capture_records, one_torch_thread  # noqa: F401 - an autouse fixture
from test_vlm import make_vlm_model_dir

jatt = importlib.import_module("lumen_tpu.ops.attention")
jmoe = importlib.import_module("lumen_tpu.parallel.moe")

F16 = np.float16
#: float16 outputs: against the interpret-mode kernels, against the references
KERNEL_TOL = dict(atol=4e-3, rtol=4e-3)
REF_TOL = dict(atol=2e-3, rtol=2e-3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


# -- the attention kernels' plain versions ----------------------------------------


@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (1, 2, 100, 100, 64, False), (2, 2, 77, 77, 64, True), (1, 2, 50, 130, 64, True),
    (2, 4, 96, 96, 16, False), (1, 4, 70, 70, 16, True), (1, 2, 65, 65, 128, True), (1, 2, 40, 90, 128, False),
])
def test_flash_float16_matches_jax(b, h, sq, sk, d, causal):
    rng = np.random.default_rng(sq * 3 + sk + d)
    q, k, v = (rng.standard_normal(s).astype(F16) for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    got = tatt.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float16
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kern = jatt.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    ref = jatt.attention_reference(jq, jk, jv, causal=causal)
    assert kern.dtype == jnp.float16 and ref.dtype == jnp.float16
    np.testing.assert_allclose(_np(got), _np(kern), **KERNEL_TOL)
    np.testing.assert_allclose(_np(got), _np(ref), **REF_TOL)


@pytest.mark.parametrize("b,sq,sk,offs,valid,d", [
    (1, 64, 160, [0], [64], 64), (2, 17, 160, [64, 37], [81, 60], 64), (1, 48, 96, [15], [63], 128),
    (2, 9, 96, [40, 0], [49, 9], 128),
])
def test_cache_float16_matches_jax(b, sq, sk, offs, valid, d):
    rng = np.random.default_rng(sq + d)
    h = 2
    q = rng.standard_normal((b, h, sq, d)).astype(F16)
    k, v = (rng.standard_normal((b, h, sk, d)).astype(F16) for _ in range(2))
    qo, kv = np.array(offs, np.int32), np.array(valid, np.int32)
    got = tatt.flash_attention_cache(_t(q), _t(k), _t(v), _t(qo), _t(kv))
    assert got.dtype == torch.float16
    args = [jnp.asarray(x) for x in (q, k, v, qo, kv)]
    kern = jatt.flash_attention_cache(*args, interpret=True)
    ref = jatt._decode_masked(*args, None)
    np.testing.assert_allclose(_np(got), _np(kern), **KERNEL_TOL)
    np.testing.assert_allclose(_np(got), _np(ref), **REF_TOL)


def _paged_case(b, w, h, kvh, d, page, maxp, seed):
    rng = np.random.default_rng(seed)
    n_pages = maxp * b + 1
    q = rng.standard_normal((b, w, h, d) if w else (b, h, d)).astype(F16)
    kp = rng.standard_normal((n_pages, kvh, page, d)).astype(F16)
    vp = rng.standard_normal((n_pages, kvh, page, d)).astype(F16)
    bt = rng.integers(1, n_pages, size=(b, maxp)).astype(np.int32)
    kl = rng.integers(1, maxp * page - max(w, 1) + 2, size=(b,)).astype(np.int32)
    for r in range(b):
        bt[r, -(-(kl[r] + max(w, 1) - 1) // page):] = 0
    return q, kp, vp, bt, kl


#: (heads, KV heads): GQA group 7 (the dense Qwen2 decoder's 14/2) and 1
#: (the Qwen2-MoE decoder's 16/16)
GROUPS = [(7, 1), (2, 2)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kvh", GROUPS)
def test_paged_float16_matches_jax(h, kvh, d):
    q, kp, vp, bt, kl = _paged_case(3, 0, h, kvh, d, 16, 6, seed=h + d)
    got = tatt.paged_attention_kernel(*(_t(x) for x in (q, kp, vp, bt, kl)))
    assert got.dtype == torch.float16
    args = [jnp.asarray(x) for x in (q, kp, vp, bt, kl)]
    np.testing.assert_allclose(_np(got), _np(jatt.paged_attention_kernel(*args, interpret=True)), **KERNEL_TOL)
    np.testing.assert_allclose(_np(got), _np(jatt.paged_attention_reference(*args)), **REF_TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kvh", GROUPS)
def test_varq_float16_matches_jax(h, kvh, d):
    q, kp, vp, bt, kl = _paged_case(2, 5, h, kvh, d, 16, 6, seed=h * d)
    got = tatt.paged_attention_varq_kernel(*(_t(x) for x in (q, kp, vp, bt, kl)))
    assert got.dtype == torch.float16
    args = [jnp.asarray(x) for x in (q, kp, vp, bt, kl)]
    np.testing.assert_allclose(_np(got), _np(jatt.paged_attention_varq_kernel(*args, interpret=True)),
                               **KERNEL_TOL)
    np.testing.assert_allclose(_np(got), _np(jatt.paged_attention_varq_reference(*args)), **REF_TOL)


# -- the MoE grouped product and moe_ffn ------------------------------------------

#: float32: summation order alone; float16: each product rounds to
#: float16 in both packages
MOE_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.float16: dict(atol=1e-2, rtol=1e-2)}
D, F, E = 32, 48, 8


@pytest.mark.parametrize("ends", [[0, 4, 4, 13, 13], [3, 3, 9, 10, 13], [13, 13, 13, 13, 13]])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_grouped_mm_float_types_match_ragged_dot(dtype, ends):
    rng = np.random.default_rng(len(ends) + ends[0])
    x = rng.standard_normal((13, 16)).astype(np.float32)
    w = (rng.standard_normal((5, 16, 24)) / 4).astype(np.float32)
    jdt = jnp.float16 if dtype == torch.float16 else jnp.float32
    sizes = np.diff([0] + ends).astype(np.int32)  # empty groups included
    want = _np(lax.ragged_dot(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(sizes)))
    xt, wt, et = _t(x).to(dtype), _t(w).to(dtype), torch.tensor(ends, dtype=torch.int32)
    for route in (tmoe.grouped_mm, tmoe.grouped_mm_kernel, tmoe.grouped_mm_reference):
        got = route(xt, wt, et)
        assert got.dtype == dtype
        np.testing.assert_allclose(_np(got.float()), want, **MOE_TOL[dtype])


@pytest.mark.parametrize("t,k", [(1, 2), (8, 4), (37, 2)])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_moe_ffn_float_types_match_jax(dtype, t, k):
    rng = np.random.default_rng(t * 10 + k)
    x = rng.standard_normal((t, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    banks = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32) for s in ((E, D, F), (E, D, F), (E, F, D))]
    jdt = jnp.float16 if dtype == torch.float16 else jnp.float32
    want = jmoe._moe_exact_local(jmoe.MoEParams(jnp.asarray(router), *(jnp.asarray(b, jdt) for b in banks)),
                                 jnp.asarray(x, jdt), n_experts=E, k=k, norm_topk=False)
    params = tmoe.MoEParams(_t(router), *(_t(b).to(dtype) for b in banks))
    got = tmoe.moe_ffn(params, _t(x).to(dtype), k=k, capacity_factor=None, norm_topk=False)
    assert got.dtype == dtype and want.dtype == jdt
    np.testing.assert_allclose(_np(got.float()), _np(want), **MOE_TOL[dtype])


# -- the managers at dtype: float16 ------------------------------------------------

KW = dict(dtype="float16", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32), gen_slots=4, gen_block=4)
PROMPTS = ("the quick brown fox jumps over the lazy dog again and again and again",
           "describe the picture in one sentence please", "a red car a red car a red car")


@pytest.fixture(scope="module")
def fp16_managers(tmp_path_factory):
    """The JAX and the port's VLM managers at float16 with
    ``LUMEN_VLM_SPEC_K=4``, on the same weights and tokenizer file."""
    from tokenizers import Tokenizer

    model_dir = make_vlm_model_dir(tmp_path_factory.mktemp("torch_float16"))
    os.remove(os.path.join(model_dir, "tokenizer_config.json"))
    tok = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_VLM_SPEC_K", "4")
        mp.setenv("LUMEN_VLM_SPEC_MIN_RATE", "0")
        jmgr = JVLMManager(model_dir, scheduler="continuous", **KW)
        jmgr.initialize()
        tmgr = VLMManager(VLMConfig.tiny(), params_from_jax(jmgr.params), tok, device="cpu", name="fp16", **KW)
    yield jmgr, tmgr
    tmgr.close()
    jmgr.close()


def test_vlm_manager_float16_with_speculation_matches_jax(fp16_managers):
    """Greedy tokens of text and photo requests equal the JAX manager's at
    float16, with verify turns taken on both sides; the engine's KV pool
    is float16."""
    import cv2

    jmgr, tmgr = fp16_managers
    assert tmgr.engine.spec_k == 4 and tmgr.compute_dtype == torch.float16
    assert all(c["k"].dtype == torch.float16 for c in tmgr.engine.pool["caches"])
    for p in PROMPTS:
        want = jmgr.generate([JChatMessage(role="user", content=p)], max_new_tokens=14)
        got = tmgr.generate([ChatMessage(role="user", content=p)], max_new_tokens=14)
        assert got.tokens == want.tokens, (p, got.tokens, want.tokens)
        assert got.metadata.get("spec_accept_rate") == want.metadata.get("spec_accept_rate")
    img = np.random.default_rng(0).integers(0, 255, (48, 64, 3), np.uint8)
    png = cv2.imencode(".png", img)[1].tobytes()
    want = jmgr.generate([JChatMessage(role="user", content="what is in this photo")], image_bytes=png,
                         max_new_tokens=10)
    got = tmgr.generate([ChatMessage(role="user", content="what is in this photo")], image_bytes=png,
                        max_new_tokens=10)
    assert got.tokens == want.tokens
    assert tmgr.engine.spec_turns > 0 and tmgr.engine.spec_proposed > 0


def test_vlm_first_step_logits_float16_match_jax():
    """The models' cacheless forward with float16 weights and inputs (the
    first step's logits of a photo prompt): cosine >= 0.9999 to the JAX
    model's, every logit finite on both sides."""
    cfg = jm.VLMConfig.tiny()
    jmodel = jm.VLMModel(cfg)
    params = jmodel.init(jax.random.PRNGKey(5), jnp.zeros((1, 4), jnp.int32),
                         jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3), jnp.float32))["params"]
    tmodel = tm.VLMModel(tm.VLMConfig.tiny())
    tmodel.load_state_dict(params_from_jax(params), strict=True)
    tmodel = tmodel.to(torch.float16).eval()
    rng = np.random.default_rng(7)
    ids = rng.integers(3, 200, (2, 9)).astype(np.int32)
    ids[:, 2] = cfg.image_token_id
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(F16)
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float16), params)
    want = _np(jmodel.apply({"params": p16}, jnp.asarray(ids), jnp.asarray(pixels)))
    with torch.no_grad():
        got = _np(tmodel(_t(ids).long(), _t(pixels)).float())
    assert got.shape == want.shape and np.isfinite(got).all() and np.isfinite(want).all()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


def test_clip_managers_float16_embed_alike(tmp_path):
    from lumen_tpu.models.clip import CLIPManager as JCLIPManager
    from lumen_tpu_torch.models.clip import CLIPManager
    from tests.clip_fixtures import make_clip_model_dir

    model_dir = make_clip_model_dir(tmp_path)
    j = JCLIPManager(model_dir, dtype="float16")
    t = CLIPManager(model_dir, dtype="float16", device="cpu")
    j.initialize()
    t.initialize()
    try:
        assert t.policy.compute_dtype == torch.float16
        rng = np.random.default_rng(1)
        for px in rng.integers(0, 255, (3, t.cfg.image_size, t.cfg.image_size, 3), np.uint8):
            a, b = np.asarray(j.encode_image_tensor(px)), np.asarray(t.encode_image_tensor(px))
            assert np.isfinite(b).all() and (a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b) >= 0.9999
        for text in ("a photo of a cat", "two dogs on a beach"):
            a, b = np.asarray(j.encode_text(text)), np.asarray(t.encode_text(text))
            assert (a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b) >= 0.9999
    finally:
        j.close()
        t.close()


def test_ocr_managers_float16_read_alike(tmp_path):
    """The native OCR pack at float16 (SVTR's mixing on ``flash_attention``
    at head_dim 16): the same items, boxes within a pixel, texts equal,
    confidences within 1e-3."""
    from lumen_tpu.models import ocr as jocr
    from lumen_tpu_torch.models import ocr as tocr
    from tests.test_ocr import encode_png, make_ocr_model_dir, text_image

    model_dir = make_ocr_model_dir(tmp_path)
    j = jocr.OcrManager(model_dir, dtype="float16")
    t = tocr.OcrManager(model_dir, dtype="float16", device="cpu")
    j.initialize()
    t.initialize()
    try:
        png = encode_png(text_image())
        kw = dict(det_threshold=0.3, box_threshold=0.0, rec_threshold=0.0)
        want, got = j.predict(png, **kw), t.predict(png, **kw)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a.box, np.float32), np.asarray(b.box, np.float32), atol=1.0)
            assert a.text == b.text and abs(a.confidence - b.confidence) <= 1e-3
    finally:
        j.close()
        t.close()


def test_spill_payload_float16_matches_jax(tmp_path):
    """A float16 pair under a 6-page pool: the newer row spills in both
    engines at the same step; the port's payload unpacks with the JAX
    ``migration.unpack_payload`` into float16 leaves of the JAX record's
    shapes, byte count for byte count (the ``seen`` mask equal, live KV
    within 1e-2: float16 forwards in another order), and the spilled row
    resumes to the tokens it gives unpressured."""
    from test_torch_spill import PAIR, jax_submit_pair, submit_pair, tokens_of

    model_dir = make_vlm_model_dir(tmp_path)
    small = dict(dtype="float16", max_seq=128, max_new_cap=64, prefill_buckets=(16,), gen_slots=2, gen_block=4)
    jmgr = JVLMManager(model_dir, scheduler="continuous", **small)
    jmgr.initialize()
    jmgr._continuous.close()
    jeng = JScheduler(jmgr.generator, jmgr.params, slots=2, block=4, name=jmgr.info.name, page_size=16, pages=6)
    jmgr._continuous, jmgr._engines = jeng, [jeng]
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", page_size=16, pool_pages=6, **small)
    roomy = VLMManager.from_model_dir(model_dir, device="cpu", **small)
    try:
        want, got = capture_records(jeng), capture_records(mgr.engine)
        jreqs, reqs = jax_submit_pair(jmgr, jeng), submit_pair(mgr)
        for j in jreqs:
            j.future.result(timeout=120)
        pressured = [tokens_of(r) for r in reqs]
        assert want and got and mgr.engine.spill_resumes >= 1
        (jrec, jblob), (rec, blob) = want[0], got[0]
        jleaves = jmigration.unpack_payload(jblob, jrec.crc)
        leaves = jmigration.unpack_payload(blob, rec.crc)
        assert [(a.shape, a.dtype) for a in leaves] == [(a.shape, a.dtype) for a in jleaves]
        assert leaves[0].dtype == np.float16 and rec.nbytes == jrec.nbytes and len(blob) == len(jblob)
        np.testing.assert_array_equal(leaves[-1], jleaves[-1])  # seen
        for a, b in zip(leaves[:-1], jleaves[:-1]):
            live = slice(0, rec.n_pages)  # pad pages hold dump-page garbage
            np.testing.assert_allclose(_np(a[live]), _np(b[live]), atol=1e-2, rtol=0)
        alone = [roomy.generate([ChatMessage("user", p)], max_new_tokens=40).tokens for p in PAIR]
        assert pressured == alone
        assert_balanced(mgr.engine)
    finally:
        roomy.close()
        mgr.close()
        jmgr.close()


# -- the dispatch that needs no card -----------------------------------------------


def test_dtype_codes_match_common_cuh():
    text = (CSRC / "common.cuh").read_text()
    codes = {name: int(v) for name, v in re.findall(r"constexpr int k(Float32|BFloat16|Float16) = (\d+);", text)}
    assert codes == {"Float32": 0, "BFloat16": 1, "Float16": 2}
    assert tatt._DTYPE_CODES == {torch.float32: codes["Float32"], torch.bfloat16: codes["BFloat16"],
                                 torch.float16: codes["Float16"]}
    with pytest.raises(ValueError, match=r"bfloat16, float16 or float32"):
        tatt._check_cuda("flash_attention", {}, torch.float64)


def test_paged_walk_float16_shapes_equal_bf16():
    shapes = tatt.paged_walk_shapes()["shapes"]
    for d in (64, 128):
        assert shapes[(torch.float16, d)] == shapes[(torch.bfloat16, d)]
    assert {dt for dt, _ in shapes} == {torch.bfloat16, torch.float16, torch.float32}


@pytest.mark.parametrize("window", [1, 5, 16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 7, 8])
def test_paged_plan_float16_equals_bf16(group, d, window):
    plan = tatt.paged_plan(group, d, window, torch.float16)
    assert plan == tatt.paged_plan(group, d, window, torch.bfloat16)
    assert plan["mma"] == int(group >= 2)


#: the plans the main path's calls launched before float16 was added (the
#: card's lumen_paged_plan agrees with them in chip_smoke.py phase 2)
PLANS = {
    (torch.bfloat16, 7, 64, 1): (1, 1, 1, 7, 128, 20736, 1),
    (torch.bfloat16, 7, 64, 5): (1, 5, 1, 35, 256, 25344, 1),
    (torch.bfloat16, 7, 64, 16): (1, 4, 4, 28, 256, 23040, 1),
    (torch.bfloat16, 1, 128, 1): (2, 1, 1, 2, 128, 71184, 0),
    (torch.bfloat16, 1, 128, 5): (2, 5, 1, 10, 256, 77392, 0),
    (torch.float32, 7, 64, 1): (1, 1, 1, 7, 128, 38456, 0),
    (torch.float32, 7, 64, 5): (1, 5, 1, 35, 256, 53016, 0),
    (torch.float32, 1, 128, 5): (1, 5, 1, 5, 160, 71464, 0),
    (torch.float32, 2, 128, 5): (1, 5, 1, 10, 256, 75344, 0),
}


@pytest.mark.parametrize("key", list(PLANS), ids=lambda k: f"{str(k[0])[6:]}-g{k[1]}-d{k[2]}-w{k[3]}")
def test_bf16_and_fp32_plans_unchanged(key):
    dtype, group, d, window = key
    p = tatt.paged_plan(group, d, window, dtype)
    fields = ("kv_heads", "slots", "slot_groups", "rows", "threads", "smem", "mma")
    assert tuple(p[f] for f in fields) == PLANS[key] and p["span"] == 64


def test_launches_counted_by_type_and_instance():
    k = CudaKernel("probe", "flash_attention", "lumen_flash_attention", [])
    k._fn = lambda *args: 0  # a stand-in for the loaded C entry point
    k.launch(instance=64, dtype=torch.float16)
    k.launch(instance=64, dtype=torch.float16)
    k.launch(instance=16, dtype=torch.bfloat16)
    k.launch(dtype="float32")
    assert k.launches == 4 and k.instance_launches == {64: 2, 16: 1}
    assert k.dtype_launches == {"float16": {64: 2}, "bfloat16": {16: 1}, "float32": {None: 1}}
    k.zero_counts()
    assert (k.launches, k.instance_launches, k.dtype_launches) == (0, {}, {})


def test_grouped_mm_kernel_is_the_float_types_route():
    """The dtype picks the route: float16 and float32 CUDA tensors go to
    ``csrc/grouped_mm.cu`` (which names the JAX call it stands for), bf16
    keeps ``torch._grouped_mm``; on CPU tensors the kernel's wrapper runs
    its plain version."""
    assert tmoe.KERNELS == (tmoe.GROUPED_MM,) and tmoe.GROUPED_MM_DTYPES == (torch.float16, torch.float32)
    text = tmoe.GROUPED_MM.source_path.read_text()
    assert 'extern "C" int lumen_grouped_mm(' in text and "lumen_tpu/parallel/moe.py:105" in text
    rng = np.random.default_rng(3)
    x, w = _t(rng.standard_normal((9, 8)).astype(np.float32)), _t(rng.standard_normal((3, 8, 4)).astype(np.float32))
    ends = torch.tensor([2, 2, 7], dtype=torch.int32)  # rows 7-8 past the last end
    got = tmoe.grouped_mm_kernel(x, w, ends)
    assert torch.equal(got, tmoe.grouped_mm_reference(x, w, ends)) and not got[7:].any()
