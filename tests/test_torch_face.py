"""The port's face family held against the JAX package's on the CPU.

Same seeded inputs through both packages:

- the native modules (``FaceDetector``, ``IResNet``) with the Flax
  variables carried across by ``face_params_from_jax``: raw head outputs
  and embeddings within |port - jax| <= 1e-4 + 1e-4 |jax| (f32);
- both converters give equal Flax trees, for native checkpoints and the
  InsightFace IResNet layout (which then embeds like the torch module it
  came from);
- ``decode_detections`` + ``nms_torch`` give the JAX decode's candidates
  and the same keep masks, including candidates with tied scores (a
  stable order: lower index first);
- both ``FaceManager``s on ``tests/test_face.py::make_face_model_dir``
  (native checkpoints) and ``tests/test_face_graph.py::
  make_graph_face_model_dir`` (an InsightFace-style ONNX pack on the
  bridges): equal detection counts, boxes and landmarks within 0.05 px,
  scores within 1e-4, embedding cosine >= 0.99999.
"""

from __future__ import annotations

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.models import face as jface
from lumen_tpu.models.face import convert as jconvert
from lumen_tpu.ops.nms import nms_jax
from lumen_tpu_torch.models import face as tface
from lumen_tpu_torch.models.face import convert as tconvert
from lumen_tpu_torch.ops.nms import nms_torch
from tests.clip_fixtures import png_bytes
from tests.test_face import make_face_model_dir
from tests.test_face_graph import _two_blob_image, make_graph_face_model_dir
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture

ATOL, RTOL = 1e-4, 1e-4
PX, SCORE, COSINE = 0.05, 1e-4, 0.99999


def seeded_variables(init_fn, seed: int) -> dict:
    """Flax variables of the module's shapes, filled from a seed: weights
    N(0, 0.1), BatchNorm statistics and affine params far from their
    init (so every normalisation does real work), PReLU slopes in [0.1, 0.3]."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "mean":
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        if leaf == "scale":
            return rng.normal(1.0, 0.1, a.shape).astype(np.float32)
        if leaf == "alpha":
            return rng.uniform(0.1, 0.3, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn))
    return jax.tree.map(np.asarray, dict(tree))


def close(port, jax_value, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(jax_value, np.float32), atol=atol, rtol=rtol)


# -- native modules -------------------------------------------------------------


@pytest.mark.parametrize("size", [64, 72])
def test_detector_head_outputs_match_flax(size):
    """72 px makes the FPN resize a non-integer ratio (9 -> 5 -> 3 cells)."""
    jcfg = jface.DetectorConfig(input_size=size, width=8, fpn_width=8)
    variables = seeded_variables(
        lambda: jface.FaceDetector(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))), seed=1)
    x = np.random.default_rng(2).standard_normal((2, size, size, 3)).astype(np.float32)
    want = jface.FaceDetector(jcfg).apply(variables, jnp.asarray(x))
    model = tface.FaceDetector(tface.DetectorConfig(input_size=size, width=8, fpn_width=8)).eval()
    model.load_state_dict(tconvert.face_params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for stride in want:
        for key in ("scores", "bbox", "kps"):
            assert tuple(got[stride][key].shape) == want[stride][key].shape
            close(got[stride][key], want[stride][key])


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), (2, 1, 2, 1)])
def test_iresnet_embeddings_match_flax(layers):
    jcfg = jface.IResNetConfig(layers=layers, width=8, input_size=32, embed_dim=64)
    variables = seeded_variables(
        lambda: jface.IResNet(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))), seed=3)
    x = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = jface.IResNet(jcfg).apply(variables, jnp.asarray(x))
    model = tface.IResNet(tface.IResNetConfig(layers=layers, width=8, input_size=32, embed_dim=64)).eval()
    model.load_state_dict(tconvert.face_params_from_jax(variables), strict=True)
    with torch.no_grad():
        close(model(torch.from_numpy(x)), want)


# -- converters --------------------------------------------------------------------


def flat_np(tree: dict) -> dict:
    out = {}
    for coll, sub in tree.items():
        for k, v in jconvert.flatten_variables({coll: sub}).items():
            out[k] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


def assert_same_tree(port_tree: dict, jax_tree: dict) -> None:
    p, j = flat_np(port_tree), flat_np(jax_tree)
    assert sorted(p) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def test_native_checkpoint_converts_alike():
    jcfg = jface.DetectorConfig.tiny()
    variables = seeded_variables(
        lambda: jface.FaceDetector(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), seed=5)
    flat = jconvert.flatten_variables(variables)
    jtree = jconvert.convert_face_checkpoint(flat, "detection")
    ttree = tconvert.convert_face_checkpoint({k: torch.from_numpy(v) for k, v in flat.items()}, "detection")
    assert_same_tree(ttree, jtree)
    assert sorted(tconvert.flatten_variables(ttree)) == sorted(flat)


def test_insightface_iresnet_layout_converts_alike():
    """A torch IResNet in the InsightFace ``iresnet.py`` layout (the
    w600k_r50 stand-in's, at a tiny width): both converters give the same
    tree, and the port's IResNet then embeds what the torch module does."""
    from lumen_tpu_torch.testing.face_standins import iresnet_insightface, randomize_bn_stats

    torch.manual_seed(6)
    net = iresnet_insightface(layers=(1, 2, 1, 1), width=8, embed=64, input_size=32)
    randomize_bn_stats(net, 7)
    net.eval()
    state = net.state_dict()
    jtree = jconvert.convert_face_checkpoint({k: v.numpy() for k, v in state.items()}, "recognition",
                                             final_c=64, final_hw=2)
    ttree = tconvert.convert_face_checkpoint(dict(state), "recognition", final_c=64, final_hw=2)
    assert_same_tree(ttree, jtree)
    port = tface.IResNet(tface.IResNetConfig(layers=(1, 2, 1, 1), width=8, input_size=32, embed_dim=64)).eval()
    port.load_state_dict(tconvert.face_params_from_jax(ttree), strict=True)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        close(port(x), net(x.permute(0, 3, 1, 2)))


# -- decode + NMS -------------------------------------------------------------------


def random_outputs(rng, batch: int, size: int, tied: bool) -> dict:
    out = {}
    for stride in (8, 16, 32):
        m = (size // stride) ** 2 * 2
        scores = rng.standard_normal((batch, m)).astype(np.float32)
        if tied:
            scores = np.round(scores)  # a handful of values: many exact ties
        out[stride] = {
            "scores": scores,
            "bbox": (np.abs(rng.standard_normal((batch, m, 4))) + (0.0 if tied else 0.5)).astype(np.float32),
            "kps": rng.standard_normal((batch, m, 10)).astype(np.float32),
        }
    return out


@pytest.mark.parametrize("tied", [False, True])
def test_decode_and_nms_keep_the_jax_candidates(tied):
    rng = np.random.default_rng(9 + tied)
    outs = random_outputs(rng, batch=3, size=64, tied=tied)
    jb, jk, js = jface.decode_detections({s: {k: jnp.asarray(v) for k, v in o.items()} for s, o in outs.items()},
                                         64, 2, max_detections=64)
    jkeep = jax.vmap(lambda b, s: nms_jax(b, s, 0.4))(jb, js)
    tb, tk, ts = tface.decode_detections(
        {s: {k: torch.from_numpy(v) for k, v in o.items()} for s, o in outs.items()}, 64, 2, max_detections=64)
    tkeep = nms_torch(tb, ts, 0.4)
    # the sigmoids may differ in the last place; the order and the
    # candidates must not
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if tied:
        # ties inside the kept set and at the top-64 cut, resolved alike
        assert len(np.unique(np.asarray(js)[0])) < 8
        assert 0 < tkeep.numpy().sum() < tkeep.numel()


def test_nms_ties_and_invalid_boxes():
    """Equal scores: the lower index wins the tie and suppresses the other;
    -inf scores are never kept; the mask is the JAX one, per image."""
    boxes = np.array([[[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, 10, 10], [50, 50, 60, 60], [51, 51, 61, 61]]],
                     np.float32).repeat(2, 0)
    scores = np.array([[0.5, 0.9, 0.9, 0.7, -np.inf], [0.9, 0.9, 0.9, 0.9, 0.9]], np.float32)
    got = nms_torch(torch.from_numpy(boxes), torch.from_numpy(scores), 0.4).numpy()
    want = np.asarray(jax.vmap(lambda b, s: nms_jax(b, s, 0.4))(jnp.asarray(boxes), jnp.asarray(scores)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [False, True, False, True, False])
    np.testing.assert_array_equal(got[1], [True, False, False, True, False])


# -- both managers --------------------------------------------------------------------


def port_configs(det_cfg, rec_cfg):
    return (tface.DetectorConfig(**{f: getattr(det_cfg, f) for f in det_cfg.__dataclass_fields__}),
            tface.IResNetConfig(**{f: getattr(rec_cfg, f) for f in rec_cfg.__dataclass_fields__}))


@pytest.fixture(scope="module")
def native_pair(tmp_path_factory):
    model_dir, det_cfg, rec_cfg = make_face_model_dir(tmp_path_factory.mktemp("torch_face"))
    jm = jface.FaceManager(model_dir, dtype="float32", batch_size=4, detector_cfg=det_cfg, embedder_cfg=rec_cfg)
    tdet, trec = port_configs(det_cfg, rec_cfg)
    tm = tface.FaceManager(model_dir, dtype="float32", batch_size=4, detector_cfg=tdet, embedder_cfg=trec,
                           device="cpu")
    jm.initialize()
    tm.initialize()
    yield jm, tm
    tm.close()
    jm.close()


@pytest.fixture(scope="module")
def graph_pair(tmp_path_factory):
    model_dir = make_graph_face_model_dir(tmp_path_factory.mktemp("torch_gface"))
    jm = jface.FaceManager(model_dir, dtype="float32", batch_size=2)
    tm = tface.FaceManager(model_dir, dtype="float32", batch_size=2, device="cpu")
    jm.initialize()
    tm.initialize()
    yield jm, tm
    tm.close()
    jm.close()


def assert_same_faces(tfaces, jfaces, embeddings: bool = False) -> None:
    assert len(tfaces) == len(jfaces)
    for t, j in zip(tfaces, jfaces):
        np.testing.assert_allclose(t.bbox, j.bbox, atol=PX)
        np.testing.assert_allclose(t.landmarks, j.landmarks, atol=PX)
        assert abs(t.confidence - j.confidence) <= SCORE
        if embeddings:
            assert float(np.dot(t.embedding, j.embedding)) >= COSINE


def test_native_managers_detect_alike(native_pair):
    jm, tm = native_pair
    assert isinstance(tm.det_vars, tface.FaceDetector)
    n = 0
    for seed, size in ((0, 100), (1, 64), (2, 150)):
        img = png_bytes(seed, size=size)
        jf = jm.detect_faces(img, conf_threshold=0.0, max_faces=8)
        tf = tm.detect_faces(img, conf_threshold=0.0, max_faces=8)
        assert_same_faces(tf, jf)
        n += len(tf)
    assert n > 0


def test_native_managers_embed_alike(native_pair):
    jm, tm = native_pair
    lm = np.array([[15, 20], [35, 20], [25, 30], [18, 40], [32, 40]], np.float32)
    for landmarks in (None, lm):
        e_j = jm.extract_embedding(png_bytes(3, size=50), landmarks)
        e_t = tm.extract_embedding(png_bytes(3, size=50), landmarks)
        assert e_t.shape == e_j.shape == (64,)
        assert abs(np.linalg.norm(e_t) - 1) < 1e-5
        assert float(np.dot(e_t, e_j)) >= COSINE
    jf = jm.detect_and_extract(png_bytes(4, size=96), max_faces=3, conf_threshold=0.0)
    tf = tm.detect_and_extract(png_bytes(4, size=96), max_faces=3, conf_threshold=0.0)
    assert tf and all(f.embedding is not None for f in tf)
    assert_same_faces(tf, jf, embeddings=True)


def test_graph_managers_detect_and_embed_alike(graph_pair):
    jm, tm = graph_pair
    assert all(isinstance(v, torch.Tensor) for v in tm.det_vars.values())
    img = _two_blob_image()
    assert_same_faces(tm.detect_faces(img), jm.detect_faces(img))
    ok, enc = cv2.imencode(".png", img[..., ::-1])
    jf = jm.detect_and_extract(enc.tobytes(), max_faces=2)
    tf = tm.detect_and_extract(enc.tobytes(), max_faces=2)
    assert len(tf) == 2
    assert_same_faces(tf, jf, embeddings=True)
    crop = np.random.RandomState(0).randint(0, 256, (112, 112, 3)).astype(np.uint8)
    assert float(np.dot(tm.extract_embedding(crop), jm.extract_embedding(crop))) >= COSINE


def test_graph_managers_tensor_path_and_nms_override_alike(graph_pair):
    jm, tm = graph_pair
    img = _two_blob_image()
    assert_same_faces(tm.detect_faces_tensor(img), jm.detect_faces_tensor(img))
    assert_same_faces(tm.detect_faces(img, nms_threshold=0.9), jm.detect_faces(img, nms_threshold=0.9))
    assert_same_faces(tm.detect_and_extract_tensor(img, max_faces=2), jm.detect_and_extract_tensor(img, max_faces=2),
                      embeddings=True)


def test_missing_weights_hard_fail_on_both(tmp_path):
    import os

    model_dir, det_cfg, rec_cfg = make_face_model_dir(tmp_path)
    os.remove(os.path.join(model_dir, "recognition.safetensors"))
    tdet, trec = port_configs(det_cfg, rec_cfg)
    for mgr in (jface.FaceManager(model_dir, dtype="float32", detector_cfg=det_cfg, embedder_cfg=rec_cfg),
                tface.FaceManager(model_dir, dtype="float32", detector_cfg=tdet, embedder_cfg=trec, device="cpu")):
        with pytest.raises(FileNotFoundError, match="recognition"):
            mgr.initialize()
        mgr.close()
