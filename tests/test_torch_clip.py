"""The port's CLIP towers, checkpoint conversion, tokenizer and masked
attention route, held against the JAX package on the same seeded inputs.

- tiny ``CLIPConfig`` towers (the causal CLIP text tower and the BERT one)
  in float32, the JAX package's Flax parameters carried across by
  ``clip_params_from_jax``: ``encode_image`` / ``encode_text`` within
  atol 1e-5;
- ``convert_clip_checkpoint`` on ``tests/clip_fixtures.make_clip_model_dir``
  (HF names) and on a tiny HF ``ChineseCLIPModel`` (``tests/test_clip_cn.py``'s
  configuration): the port's ``state_dict`` equals the JAX converter's
  tree carried across, and the towers agree on padded text rows;
- tokenizer ids equal, for ``tokenizer.json`` and the BERT ``vocab.txt``;
- ``attention(..., mask=...)`` runs the plain version, never the kernel.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.models.clip.convert import convert_clip_checkpoint as jax_convert
from lumen_tpu.models.clip.modeling import CLIPConfig as JaxConfig, CLIPModel as JaxModel
from lumen_tpu.models.clip.tokenizer import ClipTokenizer as JaxTokenizer
from lumen_tpu.ops.attention import attention as jax_attention
from lumen_tpu.runtime.weights import load_state_dict as jax_load_state_dict
from lumen_tpu_torch.models.clip import (
    CLIPConfig,
    CLIPModel,
    ClipTokenizer,
    clip_params_from_jax,
    convert_clip_checkpoint,
)
from lumen_tpu_torch.ops import attention as port_attention
from lumen_tpu_torch.runtime.weights import load_state_dict
from tests.clip_fixtures import make_clip_model_dir

ATOL = 1e-5

BERT = dict(text_arch="bert", text_hidden_act="gelu", text_layer_norm_eps=1e-12)


def _inputs(seed: int, cfg, batch: int = 3):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size - 1, (batch, cfg.context_length)).astype(np.int32)
    ids[1, 9:] = 0  # right padding (the BERT tower masks it)
    ids[2, 4:] = 0
    return px, ids


def _jax_encode(model, params, px, ids, normalize=True):
    img = model.apply({"params": params}, jnp.asarray(px), method=lambda m, x: m.encode_image(x, normalize))
    txt = model.apply({"params": params}, jnp.asarray(ids), method=lambda m, i: m.encode_text(i, normalize))
    return np.asarray(img, np.float32), np.asarray(txt, np.float32)


def _port_encode(model, px, ids, normalize=True):
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(px), normalize)
        txt = model.encode_text(torch.from_numpy(ids).long(), normalize)
    return img.numpy(), txt.numpy()


@pytest.mark.parametrize("arch", ["clip", "bert"])
def test_tiny_towers_match_jax(arch):
    extra = BERT if arch == "bert" else {}
    jcfg = dataclasses.replace(JaxConfig.tiny(), **extra)
    cfg = dataclasses.replace(CLIPConfig.tiny(), **extra)
    px, ids = _inputs(7, cfg)
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(px[:1]), jnp.asarray(ids[:1]))["params"]
    model = CLIPModel(cfg).eval()
    model.load_state_dict(clip_params_from_jax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    want_img, want_txt = _jax_encode(jmodel, params, px, ids)
    got_img, got_txt = _port_encode(model, px, ids)
    np.testing.assert_allclose(got_img, want_img, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_txt, want_txt, atol=ATOL, rtol=0)
    assert np.allclose(np.linalg.norm(got_img, axis=-1), 1.0, atol=1e-6)
    assert float(model.logit_scale.detach()) == pytest.approx(float(params["logit_scale"]), abs=1e-7)


def _jax_init_tree(jmodel, jcfg):
    return jax.eval_shape(
        lambda: jmodel.init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3), jnp.float32),
            jnp.zeros((1, 8), jnp.int32),
        )["params"]
    )


def _assert_state_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].float(), want[k]), k


def test_hf_checkpoint_converts_like_jax(tmp_path):
    """The fixture directory's HF ``CLIPModel`` checkpoint: the port's
    conversion is the JAX converter's tree, leaf for leaf, and both towers
    then agree."""
    import json
    import os

    model_dir = make_clip_model_dir(tmp_path)
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    jcfg, cfg = JaxConfig.from_hf(raw), CLIPConfig.from_hf(raw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = JaxModel(jcfg)
    params = jax_convert(jax_load_state_dict(model_dir), _jax_init_tree(jmodel, jcfg))
    state = convert_clip_checkpoint(load_state_dict(model_dir))
    _assert_state_equal(state, clip_params_from_jax(params))
    model = CLIPModel(cfg).eval()
    model.load_state_dict(state, strict=True)
    px, ids = _inputs(11, cfg)
    ids[:, -1] = 127  # the fixture's EOT id, which pools
    for got, want in zip(_port_encode(model, px, ids), _jax_encode(jmodel, params, px, ids)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cnclip_bert_tower_with_padding_matches_jax():
    """CN-CLIP: a tiny HF ``ChineseCLIPModel`` (``tests/test_clip_cn.py``'s
    configuration), converted by both packages; padded text rows go
    through the BERT tower's padding mask."""
    from transformers import ChineseCLIPConfig, ChineseCLIPModel, ChineseCLIPTextConfig, ChineseCLIPVisionConfig

    torch.manual_seed(0)
    text = ChineseCLIPTextConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=32, type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0, hidden_act="gelu",
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
    )
    vision = ChineseCLIPVisionConfig(
        hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=192, image_size=32,
        patch_size=16, projection_dim=16, layer_norm_eps=1e-5, hidden_act="quick_gelu",
    )
    hf_cfg = ChineseCLIPConfig(text_config=text.to_dict(), vision_config=vision.to_dict(), projection_dim=16)
    hf = ChineseCLIPModel(hf_cfg).eval()
    raw = hf_cfg.to_dict()
    jcfg, cfg = JaxConfig.from_hf(raw), CLIPConfig.from_hf(raw)
    assert cfg.text_arch == "bert" and cfg.text_serving_length == 52
    jmodel = JaxModel(jcfg)
    params = jax_convert({k: v.detach().numpy() for k, v in hf.state_dict().items()}, _jax_init_tree(jmodel, jcfg))
    state = convert_clip_checkpoint({k: v.detach() for k, v in hf.state_dict().items()})
    _assert_state_equal(state, clip_params_from_jax(params))
    model = CLIPModel(cfg).eval()
    model.load_state_dict(state, strict=True)
    rng = np.random.RandomState(3)
    ids = rng.randint(2, 64, size=(3, 10)).astype(np.int32)
    ids[:, 0] = 1
    ids[1, 6:] = 0
    ids[2, 3:] = 0
    px = rng.rand(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got_txt = model.encode_text(torch.from_numpy(ids).long()).numpy()
        got_img = model.encode_image(torch.from_numpy(px)).numpy()
    want_txt = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), method=lambda m, i: m.encode_text(i)))
    want_img = np.asarray(jmodel.apply({"params": params}, jnp.asarray(px), method=lambda m, x: m.encode_image(x)))
    np.testing.assert_allclose(got_txt, want_txt, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_img, want_img, atol=ATOL, rtol=0)


def test_tokenizer_ids_equal(tmp_path):
    model_dir = make_clip_model_dir(tmp_path, with_dataset=False)
    texts = ["a photo of a cat", "dog car", "", "a photo of a a a a a a a a a a a a a a a a a"]
    want = JaxTokenizer.from_model_dir(model_dir, 16).encode_batch(texts)
    got = ClipTokenizer.from_model_dir(model_dir, 16).encode_batch(texts)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # The BERT wordpiece path (CN-CLIP directories ship vocab.txt).
    bert_dir = tmp_path / "bert"
    bert_dir.mkdir()
    (bert_dir / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "photo", "of", "##s", "cat"]))
    texts = ["A photo of cats", "cat", "dog"]
    want = JaxTokenizer.from_model_dir(str(bert_dir), 8).encode_batch(texts)
    got = ClipTokenizer.from_model_dir(str(bert_dir), 8).encode_batch(texts)
    np.testing.assert_array_equal(got, want)


def test_masked_attention_runs_the_plain_version(monkeypatch):
    """``attention(..., mask=...)``: the JAX ``attention``'s masked route
    (its XLA reference) is the port's plain version on any device; an
    unmasked call still goes to the kernel wrapper."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 4, 10, 16)).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 1, 1, 10), bool)
    mask[1, ..., 6:] = False
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))

    def no_kernel(*a, **kw):
        raise AssertionError("a masked call reached flash_attention")

    with monkeypatch.context() as mp:
        mp.setattr(port_attention, "flash_attention", no_kernel)
        got = port_attention.attention(tq, tk, tv, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    calls = []
    monkeypatch.setattr(port_attention, "flash_attention", lambda *a, **kw: calls.append(kw) or a[0])
    port_attention.attention(tq, tk, tv, causal=True)
    assert calls == [{"causal": True, "scale": None}]


def _openclip_state(state: dict) -> dict:
    """An OpenCLIP checkpoint (fused qkv ``in_proj``, ``c_fc``/``c_proj``,
    ``[width, embed]`` projections, a conv patch embedding, an attention
    mask buffer) holding the weights of a port ``state_dict``."""
    out = {"logit_scale": state["logit_scale"], "attn_mask": torch.zeros(4, 4)}
    for tower, prefix in (("vision", "visual.transformer"), ("text", "transformer")):
        n = 1 + max(int(k.split(".")[2]) for k in state if k.startswith(f"{tower}.blocks."))
        for i in range(n):
            src, dst = f"{tower}.blocks.{i}", f"{prefix}.resblocks.{i}"
            for kind in ("weight", "bias"):
                out[f"{dst}.attn.in_proj_{kind}"] = torch.cat([state[f"{src}.attn.{p}_proj.{kind}"] for p in "qkv"])
                out[f"{dst}.attn.out_proj.{kind}"] = state[f"{src}.attn.out_proj.{kind}"]
                out[f"{dst}.ln_1.{kind}"] = state[f"{src}.ln1.{kind}"]
                out[f"{dst}.ln_2.{kind}"] = state[f"{src}.ln2.{kind}"]
                out[f"{dst}.mlp.c_fc.{kind}"] = state[f"{src}.mlp.fc1.{kind}"]
                out[f"{dst}.mlp.c_proj.{kind}"] = state[f"{src}.mlp.fc2.{kind}"]
    width, n = state["vision.patch_embed.weight"].shape
    p = int(round((n // 3) ** 0.5))
    out["visual.conv1.weight"] = state["vision.patch_embed.weight"].reshape(width, p, p, 3).permute(0, 3, 1, 2)
    out["visual.class_embedding"] = state["vision.class_embedding"]
    out["visual.positional_embedding"] = state["vision.position_embedding"]
    out["visual.proj"] = state["vision.projection.weight"].t()
    out["token_embedding.weight"] = state["text.token_embedding.weight"]
    out["positional_embedding"] = state["text.position_embedding"]
    out["text_projection"] = state["text.projection.weight"].t()
    for kind in ("weight", "bias"):
        out[f"visual.ln_pre.{kind}"] = state[f"vision.pre_ln.{kind}"]
        out[f"visual.ln_post.{kind}"] = state[f"vision.post_ln.{kind}"]
        out[f"ln_final.{kind}"] = state[f"text.final_ln.{kind}"]
    return {k: v.contiguous() for k, v in out.items()}


def test_openclip_checkpoint_converts_like_jax():
    """OpenCLIP names (fused qkv split by ``_split_fused_qkv``): the port's
    conversion gives back the weights it was written from, and equals the
    JAX converter's tree carried across."""
    jcfg = JaxConfig.tiny()
    jmodel = JaxModel(jcfg)
    px, ids = _inputs(13, CLIPConfig.tiny())
    params = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(px[:1]), jnp.asarray(ids[:1]))["params"]
    state = clip_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    openclip = _openclip_state(state)
    _assert_state_equal(convert_clip_checkpoint(openclip), state)
    jparams = jax_convert({k: v.numpy() for k, v in openclip.items()}, _jax_init_tree(jmodel, jcfg))
    _assert_state_equal(convert_clip_checkpoint(openclip), clip_params_from_jax(jparams))
