"""Graph-served CLIP on the port held against the JAX package's on the CPU.

``tests/test_clip_graph.py::make_export_dir`` (exported ``vision.fp32.onnx``
+ ``text.fp32.onnx`` towers, no ``config.json``) served by both
``CLIPManager``s: serving shapes derived alike from the graphs, image and
text embeddings within max |diff| 1e-4 and cosine >= 0.99999, the same
fallback temperature. Then ``clip_backend: graph`` on a directory that
also holds a native checkpoint serves the towers on both, ``quantize:
int8`` on graph towers is ignored with the JAX warning, and the two
missing-file cases raise alike.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path

import numpy as np
import pytest

from lumen_tpu.models.clip import CLIPManager as JaxManager
from lumen_tpu_torch.models.clip import CLIPManager as PortManager
from tests.clip_fixtures import make_clip_model_dir, png_bytes
from tests.test_clip_graph import CTX, EMBED, IMG, make_export_dir
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture

ATOL, COSINE = 1e-4, 0.99999
TEXTS = ("a photo", "a photo of a cat", "dog")


def managers(model_dir: str, **kw):
    jm = JaxManager(model_dir, dtype="float32", batch_size=2, **kw)
    tm = PortManager(model_dir, dtype="float32", batch_size=2, device="cpu", **kw)
    jm.initialize()
    tm.initialize()
    return jm, tm


def assert_same_vectors(t, j) -> None:
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= ATOL
    assert float(np.dot(t, j) / (np.linalg.norm(t) * np.linalg.norm(j))) >= COSINE


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    d, _, _ = make_export_dir(tmp_path_factory.mktemp("torch_clipgraph"))
    return d


@pytest.fixture(scope="module")
def served(export_dir):
    jm, tm = managers(export_dir)
    yield jm, tm
    tm.close()
    jm.close()


def test_config_derived_from_graphs_alike(served):
    jm, tm = served
    assert (tm.cfg.image_size, tm.cfg.context_length, tm.cfg.embed_dim) == (IMG, CTX, EMBED)
    for field in ("embed_dim", "image_size", "patch_size", "vocab_size", "context_length", "text_serving_length"):
        assert getattr(tm.cfg, field) == getattr(jm.cfg, field), field
    assert tm.cfg.serving_text_length == jm.cfg.serving_text_length == CTX
    assert tm.temperature() == jm.temperature() == 100.0


def test_embeddings_match(served):
    jm, tm = served
    for seed in range(3):
        img = png_bytes(seed=seed, size=40 + 8 * seed)
        assert_same_vectors(tm.encode_image(img), jm.encode_image(img))
    for text in TEXTS:
        assert_same_vectors(tm.encode_text(text), jm.encode_text(text))
    np.testing.assert_array_equal(tm.tokenizer.encode_batch(list(TEXTS)), jm.tokenizer.encode_batch(list(TEXTS)))


def test_tensor_path_matches_the_photo(served):
    from lumen_tpu_torch.utils.host_decode import _spec_clip_resize

    jm, tm = served
    img = png_bytes(seed=5, size=48)
    pixels = _spec_clip_resize(img, {"size": IMG})
    assert_same_vectors(tm.encode_image_tensor(pixels), jm.encode_image(img))


def test_weights_live_on_the_device_only(served):
    _, tm = served
    vision, text = tm._graphs
    assert vision.module.params == {} and text.module.params == {}
    assert set(tm.model) == {"vision", "text"}
    assert all(t.device.type == "cpu" and t.dtype.is_floating_point for t in tm.model["vision"].values())


def test_graph_backend_serves_the_towers_beside_a_checkpoint(tmp_path, export_dir):
    """``clip_backend: graph`` on a directory with a native checkpoint and
    towers: both serve the towers (the export directory's embeddings)."""
    d = Path(make_clip_model_dir(tmp_path / "both"))
    for f in Path(export_dir).glob("*.onnx"):
        shutil.copy(f, d / f.name)
    info = json.loads((d / "model_info.json").read_text())
    (d / "model_info.json").write_text(json.dumps({**info, "extra_metadata": {"clip_backend": "graph"}}))
    jm, tm = managers(str(d))
    ref_j, ref_t = managers(export_dir)
    try:
        img = png_bytes(seed=7, size=40)
        assert tm.cfg.embed_dim == jm.cfg.embed_dim == EMBED
        assert_same_vectors(tm.encode_image(img), jm.encode_image(img))
        assert_same_vectors(tm.encode_image(img), ref_t.encode_image(img))
        assert_same_vectors(tm.encode_text("a photo"), ref_j.encode_text("a photo"))
    finally:
        for m in (tm, jm, ref_t, ref_j):
            m.close()


def test_quantize_is_ignored_on_graphs_with_the_warning(export_dir, caplog):
    with caplog.at_level(logging.WARNING):
        jm, tm = managers(export_dir, quantize="int8")
    try:
        warned = [r.name for r in caplog.records if "quantize=int8 ignored" in r.getMessage()]
        assert sorted(warned) == ["lumen_tpu.models.clip.manager", "lumen_tpu_torch.models.clip.manager"]
        assert tm.quant_route == "bf16"
        assert_same_vectors(tm.encode_text("a photo"), jm.encode_text("a photo"))
    finally:
        tm.close()
        jm.close()


def test_missing_files_raise_alike(tmp_path):
    from tests.clip_fixtures import make_tiny_hf_clip

    d = tmp_path / "models" / "Empty"
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(make_tiny_hf_clip().config.to_dict()))
    manifest = {"name": "Empty", "version": "1.0.0", "description": "x", "model_type": "clip",
                "source": {"format": "custom", "repo_id": "LumilioPhotos/Empty"},
                "runtimes": {"jax": {"available": True, "files": []}}}
    (d / "model_info.json").write_text(json.dumps({**manifest, "extra_metadata": {"clip_backend": "graph"}}))
    for cls, kw in ((JaxManager, {}), (PortManager, {"device": "cpu"})):
        mgr = cls(str(d), dtype="float32", **kw)
        with pytest.raises(FileNotFoundError, match="clip_backend=graph"):
            mgr.initialize()
    bare = tmp_path / "models" / "Bare"
    bare.mkdir(parents=True)
    (bare / "model_info.json").write_text(json.dumps({**manifest, "name": "Bare"}))
    for cls, kw in ((JaxManager, {}), (PortManager, {"device": "cpu"})):
        with pytest.raises(FileNotFoundError):
            cls(str(bare), dtype="float32", **kw)
