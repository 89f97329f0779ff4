"""The port's OCR family held against the JAX package's on the CPU.

Same seeded inputs through both packages, float32:

- the native modules (``DBNet``, ``SVTRRecognizer``, ``TextlineClassifier``)
  with the Flax variables carried across by ``ocr_params_from_jax``:
  probability maps within 1e-5, CTC logits within 1e-4, orientation
  logits within 1e-5; the FPN's nearest resizes and the DB head's
  transposed conv (a non-symmetric 2x2 kernel, so a missing flip shows)
  within 1e-6; ``native_ocr_checkpoint`` is the converter's inverse;
- CTC: the device argmax/max equal to the JAX one (a tie breaks to the
  lower id), the native and the numpy collapse giving equal ids and
  confidences within 1e-6, and the native NMS equal to the numpy body;
- the plain attention at head_dim 16 within 1e-6 of the JAX reference;
- both ``OcrManager``s on ``tests/test_ocr.py::make_ocr_model_dir``
  (native checkpoints), ``tests/test_ocr_graph.py::make_graph_ocr_model_dir``
  and ``make_cls_ocr_model_dir`` (PP-OCR-style ONNX packs on the bridges):
  detector maps within 1e-5, recognizer ids equal and confidences within
  1e-5, boxes within 1e-4 px, texts equal, orientation flips equal.
"""

from __future__ import annotations

import importlib
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.models import ocr as jocr
from lumen_tpu.ops import ctc as jctc
from lumen_tpu.ops import nms as jnms
from lumen_tpu.runtime.weights import WeightLoadError as JaxWeightLoadError
from lumen_tpu_torch import native
from lumen_tpu_torch.models import ocr as tocr
from lumen_tpu_torch.models.ocr import convert as tconvert
from lumen_tpu_torch.ops import attention as tatt
from lumen_tpu_torch.ops import ctc as tctc
from lumen_tpu_torch.ops import nms as tnms
from lumen_tpu_torch.ops.image import letterbox_numpy
from lumen_tpu_torch.runtime.weights import WeightLoadError
from lumen_tpu_torch.testing.ocr_standins import native_ocr_checkpoint
from tests.test_ocr import encode_png, make_ocr_model_dir, text_image
from tests.test_ocr_graph import _upright_crop, make_cls_ocr_model_dir, make_graph_ocr_model_dir
from test_torch_face import seeded_variables
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture

jatt = importlib.import_module("lumen_tpu.ops.attention")
PX, CONF = 1e-4, 1e-5


def close(port, jax_value, atol):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(jax_value, np.float32), atol=atol, rtol=0)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def port_module(module, variables):
    module.load_state_dict(tconvert.ocr_params_from_jax(variables, module), strict=True)
    return module.eval()


# -- native modules -------------------------------------------------------------


@pytest.mark.parametrize("cfg", [jocr.DBNetConfig.tiny(), jocr.DBNetConfig(width=16, fpn_width=32, head_width=16)],
                         ids=["tiny", "wider"])
def test_dbnet_maps_match_flax(cfg):
    x = np.random.default_rng(0).standard_normal((2, 64, 96, 3)).astype(np.float32)
    variables = seeded_variables(lambda: jocr.DBNet(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3))), 1)
    want = jocr.DBNet(cfg).apply(variables, x)
    model = port_module(tocr.DBNet(tocr.DBNetConfig(**vars(cfg))), variables)
    with torch.no_grad():
        got = model(nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 96)
    close(got, want, 1e-5)


@pytest.mark.parametrize("cfg", [jocr.SVTRConfig.tiny(vocab_size=40),
                                 jocr.SVTRConfig(vocab_size=50, height=48, max_width=80, width=64, heads=4, layers=1)],
                         ids=["tiny", "head_dim16"])
def test_svtr_logits_match_flax(cfg):
    width = cfg.max_width // 2  # a bucket narrower than the widest: pos_embed is sliced
    x = np.random.default_rng(1).standard_normal((3, cfg.height, width, 3)).astype(np.float32)
    variables = seeded_variables(
        lambda: jocr.SVTRRecognizer(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.height, width, 3))), 2)
    want = jocr.SVTRRecognizer(cfg).apply(variables, x)
    model = port_module(tocr.SVTRRecognizer(tocr.SVTRConfig(**vars(cfg))), variables)
    with torch.no_grad():
        got = model(nchw(x))
    assert got.shape == (3, width // 4, cfg.vocab_size)
    close(got, want, 1e-4)


def test_textline_classifier_logits_match_flax():
    cfg = jocr.ClsConfig.tiny()
    x = np.random.default_rng(2).standard_normal((4, cfg.height, cfg.width, 3)).astype(np.float32)
    variables = seeded_variables(
        lambda: jocr.TextlineClassifier(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.height, cfg.width, 3))), 3)
    want = jocr.TextlineClassifier(cfg).apply(variables, x)
    model = port_module(tocr.TextlineClassifier(tocr.ClsConfig(**vars(cfg))), variables)
    with torch.no_grad():
        close(model(nchw(x)), want, 1e-5)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_fpn_nearest_resize_matches_jax(factor):
    x = np.random.default_rng(factor).standard_normal((2, 3, 5, 4)).astype(np.float32)  # NHWC
    want = jax.image.resize(x, (2, 3 * factor, 5 * factor, 4), method="nearest")
    got = torch.nn.functional.interpolate(nchw(x), size=(3 * factor, 5 * factor), mode="nearest")
    close(got.permute(0, 2, 3, 1), want, 1e-6)


def test_db_head_transposed_conv_matches_flax():
    """Flax ``ConvTranspose`` (un-flipped kernel, SAME) at kernel 2, stride
    2 carried into ``nn.ConvTranspose2d`` by the converter; the kernel is
    not symmetric, so the spatial flip is what makes them equal."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    kernel = rng.standard_normal((2, 2, 3, 4)).astype(np.float32)
    bias = rng.standard_normal((4,)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (2, 2), strides=(2, 2))
    want = layer.apply({"params": {"kernel": kernel, "bias": bias}}, x)
    holder = torch.nn.Module()
    holder.up = torch.nn.ConvTranspose2d(3, 4, 2, 2)
    holder.load_state_dict(tconvert.ocr_params_from_jax({"params": {"up": {"kernel": kernel, "bias": bias}}}, holder))
    with torch.no_grad():
        got = holder.up(nchw(x)).permute(0, 2, 3, 1)
    close(got, want, 1e-6)
    unflipped = torch.nn.functional.conv_transpose2d(
        nchw(x), torch.from_numpy(kernel).permute(2, 3, 0, 1), torch.from_numpy(bias), stride=2)
    assert np.abs(unflipped.permute(0, 2, 3, 1).numpy() - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("kind", ["det", "rec", "cls"])
def test_native_checkpoint_is_the_converters_inverse(kind):
    """A port module written with ``native_ocr_checkpoint`` loads into the
    JAX module (through the JAX checkpoint converter) and answers what the
    port module answers; read back by the port's converter it is the same
    state."""
    torch.manual_seed(0)
    if kind == "det":
        cfg, x = jocr.DBNetConfig.tiny(), np.random.default_rng(0).standard_normal((1, 64, 64, 3))
        model, jmod = tocr.DBNet(tocr.DBNetConfig(**vars(cfg))), jocr.DBNet(cfg)
    elif kind == "rec":
        cfg, x = jocr.SVTRConfig.tiny(vocab_size=30), np.random.default_rng(0).standard_normal((1, 32, 64, 3))
        model, jmod = tocr.SVTRRecognizer(tocr.SVTRConfig(**vars(cfg))), jocr.SVTRRecognizer(cfg)
    else:
        cfg, x = jocr.ClsConfig.tiny(), np.random.default_rng(0).standard_normal((2, 32, 64, 3))
        model, jmod = tocr.TextlineClassifier(tocr.ClsConfig(**vars(cfg))), jocr.TextlineClassifier(cfg)
    model.eval()
    x = x.astype(np.float32)
    flat = {k: v.numpy() for k, v in native_ocr_checkpoint(model).items()}
    want = jmod.apply(jocr.convert_ocr_checkpoint(flat), x)
    with torch.no_grad():
        close(model(nchw(x)), want, 1e-5)
    again = tconvert.ocr_params_from_jax(tconvert.convert_ocr_checkpoint(native_ocr_checkpoint(model)), model)
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_non_native_checkpoint_raises_the_jax_wording():
    state = {"backbone.conv1.weight": np.zeros((2, 2), np.float32)}
    with pytest.raises(JaxWeightLoadError) as jerr:
        jocr.convert_ocr_checkpoint(state)
    with pytest.raises(WeightLoadError) as terr:
        tocr.convert_ocr_checkpoint({k: torch.from_numpy(v) for k, v in state.items()})
    assert str(terr.value) == str(jerr.value)


# -- CTC, NMS, attention -------------------------------------------------------------


def test_ctc_greedy_matches_jax_and_ties_break_low():
    logits = np.random.default_rng(0).standard_normal((3, 9, 11)).astype(np.float32)
    logits[1, 4, [2, 7]] = 5.0  # a tie: the lower id wins on both
    logits[2, 0, [0, 3, 4]] = 4.0
    jids, jconf = jctc.ctc_greedy_device(jnp.asarray(logits))
    tids, tconf = tctc.ctc_greedy_device(torch.from_numpy(logits))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(tconf, jconf, 1e-6)
    assert int(tids[1, 4]) == 2 and int(tids[2, 0]) == 0


@pytest.fixture
def collapse_rows():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 6, (5, 17)).astype(np.int32)
    ids[0] = 0  # nothing emitted
    ids[1, :4] = [3, 3, 0, 3]  # a repeat across a blank is emitted twice
    confs = rng.uniform(0.1, 1.0, (5, 17)).astype(np.float32)
    return ids, confs, ["<blank>", "a", "b", "c", "d"]  # id 5 is out of vocab


def test_ctc_collapse_native_and_numpy_agree(collapse_rows, monkeypatch):
    ids, confs, vocab = collapse_rows
    assert native.available()  # the card's machine and this one have g++
    rows = tctc.ctc_collapse_rows(ids, confs, vocab)
    out_ids, out_confs, counts = native.ctc_collapse_batch(ids, confs)
    for b in range(len(ids)):
        emitted = [(i, c) for t, (i, c) in enumerate(zip(ids[b], confs[b]))
                   if i != 0 and (t == 0 or ids[b, t - 1] != i)]
        assert [int(i) for i in out_ids[b, :counts[b]]] == [i for i, _ in emitted]
        close(out_confs[b, :counts[b]], [c for _, c in emitted], 1e-6)
    monkeypatch.setattr(native, "available", lambda: False)
    plain = tctc.ctc_collapse_rows(ids, confs, vocab)
    jax_rows = jctc.ctc_collapse_rows(ids, confs, vocab)
    assert [t for t, _ in plain] == [t for t, _ in rows] == [t for t, _ in jax_rows]
    close([c for _, c in plain], [c for _, c in rows], 1e-6)
    close([c for _, c in jax_rows], [c for _, c in rows], 1e-6)
    assert rows[0] == ("", 1.0) and rows[1][0].startswith("cc")


def test_nms_numpy_native_and_numpy_agree(monkeypatch):
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 80, (60, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (60, 2)).astype(np.float32)], 1)
    scores = rng.uniform(0, 1, 60).astype(np.float32)
    scores[10:14] = 0.5  # ties
    fast = tnms.nms_numpy(boxes, scores, 0.4)
    monkeypatch.setattr(native, "available", lambda: False)
    plain = tnms.nms_numpy(boxes, scores, 0.4)
    np.testing.assert_array_equal(fast, plain)
    np.testing.assert_array_equal(plain, jnms.nms_numpy(boxes, scores, 0.4))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_head_dim_16_matches_jax(causal):
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 4, 60, 16)).astype(np.float32) for _ in range(3))
    want = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tatt.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    close(got, want, 1e-6)


# -- managers -------------------------------------------------------------------


def gap_threshold(prob: np.ndarray, center: float = 0.3, half: float = 0.1) -> float:
    """A detection threshold midway in the widest gap between the map's
    values within ``half`` of ``center`` (the interval's ends count as
    values), so rounding cannot move a pixel across it."""
    v = np.unique(prob.astype(np.float64))
    pts = np.concatenate([[center - half], v[(v > center - half) & (v < center + half)], [center + half]])
    k = int(np.argmax(np.diff(pts)))
    return float((pts[k] + pts[k + 1]) / 2)


def manager_pair(model_dir: str):
    j = jocr.OcrManager(model_dir, dtype="float32")
    t = tocr.OcrManager(model_dir, dtype="float32", device="cpu")
    j.initialize()
    t.initialize()
    return j, t


@pytest.fixture(scope="module")
def native_pair(tmp_path_factory):
    j, t = manager_pair(make_ocr_model_dir(tmp_path_factory.mktemp("torch_ocr_native")))
    yield j, t
    j.close()
    t.close()


@pytest.fixture(scope="module")
def graph_pair(tmp_path_factory):
    j, t = manager_pair(make_graph_ocr_model_dir(tmp_path_factory.mktemp("torch_ocr_graph")))
    yield j, t
    j.close()
    t.close()


@pytest.fixture(scope="module")
def cls_pair(tmp_path_factory):
    j, t = manager_pair(make_cls_ocr_model_dir(tmp_path_factory.mktemp("torch_ocr_cls")))
    yield j, t
    j.close()
    t.close()


def assert_same_results(tres, jres) -> None:
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        close(t.box, j.box, PX)
        assert t.text == j.text
        assert abs(t.confidence - j.confidence) <= CONF


def run_both(pair, fn):
    j, t = pair
    return fn(j), fn(t)


def test_native_managers_detect_alike(native_pair):
    j, t = native_pair
    img = np.random.default_rng(0).integers(0, 255, (1, 128, 128, 3), np.uint8)
    jp = np.asarray(j._run_detector(j.det_vars, img))
    tp = t._run_detector(t.det_vars, torch.from_numpy(img)).numpy()
    close(tp, jp, 1e-5)
    page = text_image()
    thr = gap_threshold(np.asarray(j._run_detector(j.det_vars, letterbox_numpy(page, 128)[0][None]))[0])
    jres, tres = run_both(native_pair, lambda m: m.detect(page, det_threshold=thr, box_threshold=0.0))
    assert len(tres) == len(jres) > 0
    for (tq, ts), (jq, js) in zip(tres, jres):
        close(tq, jq, PX)
        assert abs(ts - js) <= CONF


def test_native_managers_recognize_alike(native_pair):
    j, t = native_pair
    rng = np.random.default_rng(1)
    crops = [rng.integers(0, 255, (40, 20 * (i + 1), 3), np.uint8) for i in range(5)]
    jres, tres = run_both(native_pair, lambda m: m.recognize_crops(crops))
    assert [x for x, _ in tres] == [x for x, _ in jres]
    close([c for _, c in tres], [c for _, c in jres], CONF)
    # padding steps are blank: a narrow crop in a wide bucket
    batch = np.zeros((1, t.rec_cfg.height, 64, 3), np.uint8)
    batch[0, :, :8] = 200
    ids, conf = t._run_recognizer(t.rec_vars, torch.from_numpy(batch), torch.tensor([8], dtype=torch.int32))
    jids, jconf = j._run_recognizer(j.rec_vars, jnp.asarray(batch), jnp.asarray([8], jnp.int32))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(conf, jconf, CONF)
    assert (ids[0, 8 // 4:] == 0).all()


def test_native_managers_predict_alike(native_pair):
    j, t = native_pair
    boxed = np.zeros((1, 128, 128, 3), np.uint8)
    page = text_image()
    boxed[0] = letterbox_numpy(page, 128)[0]
    thr = gap_threshold(np.asarray(j._run_detector(j.det_vars, boxed))[0])
    png = encode_png(page)
    kw = dict(det_threshold=thr, box_threshold=0.0, rec_threshold=0.0)
    jres, tres = run_both(native_pair, lambda m: m.predict(png, **kw))
    assert len(tres) > 0
    assert_same_results(tres, jres)
    jres, tres = run_both(native_pair, lambda m: m.predict_tensor(page, **kw))
    assert_same_results(tres, jres)


def test_graph_managers_answer_alike(graph_pair):
    img = np.zeros((240, 320, 3), np.uint8)
    img[100:140, 40:280] = 255
    jres, tres = run_both(graph_pair, lambda m: m.predict(encode_png(img[..., ::-1])))
    assert len(tres) == 1 and "a" in tres[0].text
    assert_same_results(tres, jres)
    crops = [np.full((48, 160, 3), 255, np.uint8), np.zeros((48, 160, 3), np.uint8)]
    jrec, trec = run_both(graph_pair, lambda m: m.recognize_crops(crops))
    assert [x for x, _ in trec] == [x for x, _ in jrec] == ["a", ""]
    close([c for _, c in trec], [c for _, c in jrec], CONF)


def test_cls_managers_flip_alike(cls_pair):
    up = _upright_crop()
    down = np.ascontiguousarray(up[::-1, ::-1])
    jflip, tflip = run_both(cls_pair, lambda m: m.classify_angles([up, down, up]))
    assert tflip == jflip == [False, True, False]
    page = np.ascontiguousarray(_upright_crop(160)[::-1, ::-1])
    quad = np.array([[0, 0], [159, 0], [159, 47], [0, 47]], np.float32)
    for angle in (False, True):
        jres, tres = run_both(cls_pair, lambda m: m.recognize_boxes(page, [(quad, 1.0)], use_angle_cls=angle))
        assert_same_results(tres, jres)
        assert tres[0].text == ("a" if angle else "b")


def test_native_cls_checkpoint_route(tmp_path):
    """A ``classification.safetensors`` beside native det/rec: discovered
    and classifying alike on both."""
    from safetensors.numpy import save_file

    model_dir = make_ocr_model_dir(tmp_path)
    cfg = jocr.ClsConfig.tiny()
    variables = seeded_variables(
        lambda: jocr.TextlineClassifier(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.height, cfg.width, 3))), 4)
    save_file(jocr.flatten_variables(variables), os.path.join(model_dir, "classification.safetensors"))
    info_path = os.path.join(model_dir, "model_info.json")
    info = json.loads(open(info_path).read())
    info["extra_metadata"]["classifier"] = {"height": cfg.height, "width": cfg.width, "channels": list(cfg.channels)}
    open(info_path, "w").write(json.dumps(info))
    j, t = manager_pair(model_dir)
    try:
        assert t.has_angle_cls and j.has_angle_cls
        rng = np.random.default_rng(7)
        crops = [rng.integers(0, 255, (20, 60, 3), np.uint8) for _ in range(5)]
        j.spec.cls_thresh = t.spec.cls_thresh = 0.5
        assert t.classify_angles(crops) == j.classify_angles(crops)
    finally:
        j.close()
        t.close()


def test_missing_weights_hard_fail_and_entry_point_defaults_to_the_card(tmp_path):
    model_dir = make_ocr_model_dir(tmp_path)
    os.remove(os.path.join(model_dir, "detection.safetensors"))
    for mgr in (jocr.OcrManager(model_dir, dtype="float32"), tocr.OcrManager(model_dir, dtype="float32", device="cpu")):
        with pytest.raises(FileNotFoundError, match="no detection weights"):
            mgr.initialize()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tocr.OcrManager(model_dir, dtype="float32")


def test_result_cache_namespace_names_the_dtype_as_jax_does(native_pair):
    j, t = native_pair
    assert t._cache_ns("predict") == j._cache_ns("predict")
    assert "float32" in t._cache_ns("predict") and "torch." not in t._cache_ns("predict")
