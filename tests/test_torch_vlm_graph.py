"""The port's ONNX vision-graph backend for the VLM, held against the JAX
package's (the twin of ``tests/test_vlm_vision_graph.py``).

Both packages serve the same directories on the CPU in float32: the JAX
suite's tiny VLM with the JAX suite's exported FastViT-style tower
(``vision.onnx``, 16 tokens where the native tower has 4), and a
FastVLM-style directory whose checkpoint holds only the decoder and whose
tower exists only as ``onnx/vision_encoder.onnx`` (the port's FastViTHD
stand-in at tiny widths). Greedy captions are equal between the packages;
``auto``, ``graph`` and ``native`` pick the same tower; ``graph`` without
a file and a projector-less export fail alike; the spliced embeddings
equal the torch tower's forward; and the port's ``vlm`` service boots
whole from the FastVLM-style directory.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu_torch.core.config import validate_config_dict
from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
from lumen_tpu_torch.models.vlm.graph import VisionGraph, find_vision_onnx
from lumen_tpu_torch.serving.resilience import DegradedService
from lumen_tpu_torch.serving.server import build_services
from lumen_tpu_torch.testing.fastvlm_standins import FastViTHDConfig, fastvithd_standin
from lumen_tpu_torch.testing.onnx_export import export_onnx
from test_vlm import make_vlm_model_dir, png_bytes
from test_vlm_vision_graph import FastVitStyleTower, make_fastvlm_style_dir

KW = dict(dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32))
IMG = 32  # the tiny VLM's canvas
FAST_IMG = 128  # the FastVLM-style directory's canvas: a 2x2 grid at stride 64
PROMPT = "describe <image>"


def set_backend(model_dir: str, backend: str | None) -> None:
    path = os.path.join(model_dir, "model_info.json")
    info = json.loads(open(path).read())
    meta = dict(info.get("extra_metadata") or {})
    meta.pop("vision_backend", None)
    if backend is not None:
        meta["vision_backend"] = backend
    info["extra_metadata"] = meta
    open(path, "w").write(json.dumps(info))


FAST_CFG = FastViTHDConfig.tiny(hidden_size=32, image_size=FAST_IMG)


def make_fastvlm_dir(tmp_path) -> str:
    """The JAX suite's tiny VLM with its vision weights dropped from the
    checkpoint, a 128-px canvas in ``config.json``, and the port's
    FastViTHD stand-in at tiny widths (4 tokens) exported as
    ``onnx/vision_encoder.onnx``; the manifest names no backend
    (``auto``)."""
    model_dir = make_vlm_model_dir(tmp_path)
    ckpt = os.path.join(model_dir, "model.safetensors")
    state = {k: v for k, v in load_file(ckpt).items() if "/vision/" not in k}
    save_file(state, ckpt)
    cfg_path = os.path.join(model_dir, "config.json")
    cfg = json.loads(open(cfg_path).read())
    cfg["vision_config"]["image_size"] = FAST_IMG
    open(cfg_path, "w").write(json.dumps(cfg))
    os.makedirs(os.path.join(model_dir, "onnx"))
    export_onnx(fastvithd_standin(4, FAST_CFG), (torch.randn(1, 3, FAST_IMG, FAST_IMG),),
                os.path.join(model_dir, "onnx", "vision_encoder.onnx"),
                input_names=["pixel_values"], dynamic_axes={"pixel_values": {0: "b"}})
    return model_dir


def both(model_dir: str, **kw):
    jmgr = JVLMManager(model_dir, **KW, **kw)
    jmgr.initialize()
    tmgr = VLMManager.from_model_dir(model_dir, device="cpu", **KW, **kw)
    return jmgr, tmgr


def greedy_pair(jmgr, tmgr, seed: int, n: int = 8, size: int = IMG):
    image = png_bytes(size, seed=seed)
    j = jmgr.generate([JChatMessage(role="user", content=PROMPT)], image_bytes=image, max_new_tokens=n)
    t = tmgr.generate([ChatMessage(role="user", content=PROMPT)], image_bytes=image, max_new_tokens=n)
    return j, t


@pytest.fixture(scope="module")
def graph_pair(tmp_path_factory):
    model_dir = make_fastvlm_style_dir(tmp_path_factory.mktemp("tvlm_graph"))
    jmgr, tmgr = both(model_dir)
    yield jmgr, tmgr
    tmgr.close()
    jmgr.close()


def test_graph_captions_equal_the_jax_package(graph_pair):
    jmgr, tmgr = graph_pair
    assert jmgr.vision_tokens == tmgr.vision_tokens == 16
    for seed in (1, 2):
        j, t = greedy_pair(jmgr, tmgr, seed)
        assert t.tokens == j.tokens and t.text == j.text and len(t.tokens) == 8
    streamed = list(tmgr.generate_stream([ChatMessage(role="user", content=PROMPT)],
                                         image_bytes=png_bytes(IMG, seed=2), max_new_tokens=8))
    assert streamed[-1].is_final and "".join(c.text for c in streamed).strip() == j.text
    text_only = tmgr.generate([ChatMessage(role="user", content="describe")], max_new_tokens=6)
    with_img = tmgr.generate([ChatMessage(role="user", content="describe")], image_bytes=png_bytes(IMG, seed=1),
                             max_new_tokens=6)
    assert text_only.tokens != with_img.tokens  # the graph's tokens condition the decode


def test_spliced_embeddings_equal_the_torch_tower(graph_pair):
    """The port's graph splice == the exported module's fp32 forward (the
    JAX test's tolerance)."""
    _, tmgr = graph_pair
    img = np.random.RandomState(5).randint(0, 256, (IMG, IMG, 3)).astype(np.uint8)
    msgs = [ChatMessage(role="user", content="hi <image>")]
    ids = tmgr._encode_prompt(msgs, has_image=True)
    pos = ids.index(tmgr.cfg.image_token_id)
    embeds = tmgr._prepare_inputs(msgs, img)[0]
    got = embeds[0, pos : pos + 16].float().numpy()
    tower = FastVitStyleTower()
    tower.load_state_dict(torch.load(os.path.join(tmgr.model_dir, "vision_state.pt")))
    mean = np.asarray(tmgr.cfg.vision.mean, np.float32)
    std = np.asarray(tmgr.cfg.vision.std, np.float32)
    x = (img.astype(np.float32) / 255.0 - mean) / std
    with torch.no_grad():
        want = tower.eval()(torch.from_numpy(x.transpose(2, 0, 1)[None])).numpy()[0]
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("backend, tokens", [(None, 4), ("auto", 4), ("native", 4), ("graph", 16)])
def test_backend_picks_the_same_tower(tmp_path, backend, tokens):
    """With a complete native tower AND a vision.onnx, ``auto`` and
    ``native`` serve the native tower (4 tokens), ``graph`` the export
    (16), on both packages, with equal captions."""
    model_dir = make_fastvlm_style_dir(tmp_path, backend=None)
    set_backend(model_dir, backend)
    jmgr, tmgr = both(model_dir)
    try:
        assert jmgr.vision_tokens == tmgr.vision_tokens == tokens
        assert (tmgr._vision_graph is not None) == (tokens == 16)
        j, t = greedy_pair(jmgr, tmgr, seed=3, n=6)
        assert t.tokens == j.tokens
    finally:
        tmgr.close()
        jmgr.close()


def test_fastvlm_style_directory_serves_its_onnx_tower(tmp_path):
    """A decoder-only checkpoint and ``onnx/vision_encoder.onnx``: ``auto``
    finds the export under ``onnx/`` on both packages, captions equal; the
    spliced tokens equal the stand-in's fp32 forward; ``native`` cannot
    load (the checkpoint has no native tower)."""
    model_dir = make_fastvlm_dir(tmp_path)
    assert find_vision_onnx(model_dir).endswith(os.path.join("onnx", "vision_encoder.onnx"))
    jmgr, tmgr = both(model_dir)
    try:
        assert tmgr._vision_graph is not None and jmgr.vision_tokens == tmgr.vision_tokens == FAST_CFG.num_tokens
        for seed in (1, 2):
            j, t = greedy_pair(jmgr, tmgr, seed, n=6, size=FAST_IMG)
            assert t.tokens == j.tokens and t.text == j.text
        img = np.random.RandomState(7).randint(0, 256, (FAST_IMG, FAST_IMG, 3)).astype(np.uint8)
        msgs = [ChatMessage(role="user", content="hi <image>")]
        pos = tmgr._encode_prompt(msgs, has_image=True).index(tmgr.cfg.image_token_id)
        got = tmgr._prepare_inputs(msgs, img)[0][0, pos : pos + tmgr.vision_tokens].numpy()
        tower = fastvithd_standin(4, FAST_CFG)
        x = (img.astype(np.float32) / 255.0 - np.asarray(tmgr.cfg.vision.mean, np.float32)) / np.asarray(
            tmgr.cfg.vision.std, np.float32)
        with torch.no_grad():
            want = tower(torch.from_numpy(x.transpose(2, 0, 1)[None].copy())).numpy()[0]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    finally:
        tmgr.close()
        jmgr.close()
    set_backend(model_dir, "native")
    with pytest.raises(RuntimeError, match="vision"):
        VLMManager.from_model_dir(model_dir, device="cpu", **KW)


def test_graph_without_a_file_raises_on_both(tmp_path):
    model_dir = make_vlm_model_dir(tmp_path)
    set_backend(model_dir, "graph")
    with pytest.raises(FileNotFoundError, match="vision"):
        JVLMManager(model_dir, **KW).initialize()
    with pytest.raises(FileNotFoundError, match="vision"):
        VLMManager.from_model_dir(model_dir, device="cpu", **KW)


def test_projectorless_export_raises_the_width_error_on_both(tmp_path):
    class NoProjector(torch.nn.Module):
        def forward(self, x):
            return x.flatten(2).transpose(1, 2)[:, :4, :24]

    model_dir = make_vlm_model_dir(tmp_path)
    export_onnx(NoProjector(), (torch.randn(1, 3, IMG, IMG),), os.path.join(model_dir, "vision.onnx"))
    set_backend(model_dir, "graph")
    with pytest.raises(ValueError, match="projector"):
        JVLMManager(model_dir, dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16,)).initialize()
    with pytest.raises(ValueError, match="projector"):
        VLMManager.from_model_dir(model_dir, device="cpu", dtype="float32", max_seq=128, max_new_cap=16,
                                  prefill_buckets=(16,))


def test_probe_runs_on_the_placed_weights(tmp_path):
    model_dir = make_fastvlm_dir(tmp_path)
    graph = VisionGraph.from_path(find_vision_onnx(model_dir))
    params = graph.place("cpu")
    assert graph.probe(FAST_IMG, 32, params) == graph.probe(FAST_IMG, 32) == FAST_CFG.num_tokens
    fn, placed = graph.bind(device="cpu")
    assert tuple(fn(placed, np.zeros((2, 3, FAST_IMG, FAST_IMG), np.float32))[0].shape) == (2, 4, 32)
    graph.release_weights()
    assert not graph.module.params and graph.probe(FAST_IMG, 32, params) == 4


def test_vlm_service_boots_whole_from_a_fastvlm_directory(tmp_path):
    model_dir = make_fastvlm_dir(tmp_path)
    config = validate_config_dict({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(tmp_path)},
        "deployment": {"mode": "single", "service": "vlm"},
        "server": {"port": 50997, "host": "127.0.0.1"},
        "services": {"vlm": {
            "enabled": True, "package": "lumen_tpu.models.vlm",
            "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
            "backend_settings": {"dtype": "float32", "batch_size": 2, "batch_buckets": [16, 32]},
            "models": {"vlm": {"model": os.path.basename(model_dir), "runtime": "jax"}},
        }},
    })
    services = build_services(config, torch.device("cpu"))
    svc = services["vlm"]
    try:
        assert not isinstance(svc, DegradedService), getattr(svc, "error", None)
        assert svc.manager._vision_graph is not None
        assert svc.capability().extra["vision_tokens"] == str(svc.manager.vision_tokens)
    finally:
        svc.close()


def test_prefix_identity_counts_the_graph_tokens(graph_pair, monkeypatch):
    """The prefix KV cache's content identity of an image prompt spans the
    merged sequence: the probed 16 graph tokens, not the configuration's 4
    (the JAX ``_prefix_content`` expands to ``cfg.vision.num_tokens``, a
    fault fixed in the port only: ROADMAP C)."""
    jmgr, _ = graph_pair
    monkeypatch.setenv("LUMEN_VLM_PREFIX_BYTES", str(1 << 20))
    tmgr = VLMManager.from_model_dir(jmgr.model_dir, device="cpu", **KW)
    try:
        msgs = [ChatMessage(role="user", content=PROMPT)]
        ids = tmgr._encode_prompt(msgs, has_image=True)
        host = np.asarray([ids], np.int64)
        image = png_bytes(IMG, seed=1)
        got = tmgr._prefix_content(host, len(ids), image)
        assert len(got) == len(ids) - 1 + tmgr.vision_tokens == len(ids) + 15
        assert jmgr._encode_prompt([JChatMessage(role="user", content=PROMPT)], True) == ids
        want = jmgr._prefix_content(host, len(ids), image)  # the JAX fault: 4 positions
        assert len(want) == len(ids) - 1 + jmgr.cfg.vision.num_tokens == len(ids) + 3
    finally:
        tmgr.close()


def test_jax_graph_params_carry_across(graph_pair):
    """The JAX manager's graph-path tree (decoder only: its native vision
    subtree was dropped) converts with ``params_from_jax`` and serves
    beside the same export, with the JAX captions."""
    import jax

    from lumen_tpu_torch.models.vlm import VLMConfig, params_from_jax
    from lumen_tpu_torch.models.vlm.chat import VlmTokenizer

    jmgr, tmgr = graph_pair
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jmgr.params))
    assert not any(k.startswith("vision.") for k in state)
    mgr = VLMManager(VLMConfig.tiny(), state, VlmTokenizer.from_model_dir(jmgr.model_dir), device="cpu",
                     vision_graph=VisionGraph.from_path(find_vision_onnx(jmgr.model_dir)), **KW)
    try:
        assert mgr.vision_tokens == 16
        image = png_bytes(IMG, seed=6)
        j = jmgr.generate([JChatMessage(role="user", content=PROMPT)], image_bytes=image, max_new_tokens=6)
        t = mgr.generate([ChatMessage(role="user", content=PROMPT)], image_bytes=image, max_new_tokens=6)
        assert t.tokens == j.tokens
    finally:
        mgr.close()
