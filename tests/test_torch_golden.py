"""The committed golden fixtures (``tests/golden/*.npz``) replayed through
the port's counterparts of the four math layers they pin, with the
parameters of ``tests/golden_params.py`` and the tolerances of
``tests/test_golden.py`` (which replays them through the JAX package):

- face decode and NMS: ``models/face/modeling.decode_detections`` and
  ``ops/nms.nms_torch``;
- OCR: DB boxes (``models/ocr/postprocess.boxes_from_prob_map``) and the
  CTC collapse (``ops/ctc.ctc_collapse_rows``);
- CLIP scoring: ``CLIPManager._classify_vector`` (cosine, temperature
  softmax, top-k);
- the VLM splice: ``models/vlm/modeling.merge_image_embeddings``.

A fixture that does not replay is a fault of the port, never of the
fixture: the JAX package recorded them.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from tests.golden_params import CLIP_TOP_K, CTC_VOCAB, DB_POSTPROCESS, FACE_MAX_DETECTIONS, FACE_NMS_THRESHOLD
from tests.test_golden import load


def test_face_decode_and_nms_replay():
    from lumen_tpu_torch.models.face.modeling import decode_detections
    from lumen_tpu_torch.ops.nms import nms_torch

    fx = load("face_decode.npz")
    outputs = {s: {k: torch.from_numpy(fx[f"{k}_{s}"]) for k in ("scores", "bbox", "kps")} for s in (8, 16, 32)}
    boxes, kps, scores = decode_detections(outputs, int(fx["input_size"]), int(fx["num_anchors"]),
                                           max_detections=FACE_MAX_DETECTIONS, scores_are_logits=False)
    keep = nms_torch(boxes, scores, FACE_NMS_THRESHOLD)
    np.testing.assert_allclose(boxes.numpy(), fx["boxes"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(kps.numpy(), fx["kps"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(scores.numpy(), fx["scores"], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(keep.numpy(), fx["keep"])


def test_db_boxes_replay():
    from lumen_tpu_torch.models.ocr.postprocess import boxes_from_prob_map

    fx = load("ocr_postprocess.npz")
    found = boxes_from_prob_map(fx["prob"], **DB_POSTPROCESS)
    quads = np.stack([q for q, _ in found]).astype(np.float32)
    scores = np.asarray([s for _, s in found], np.float32)
    assert quads.shape == fx["quads"].shape
    np.testing.assert_allclose(quads, fx["quads"], atol=1e-3)
    np.testing.assert_allclose(scores, fx["quad_scores"], atol=1e-5)


def test_ctc_collapse_replay():
    from lumen_tpu_torch.ops.ctc import ctc_collapse_rows

    fx = load("ocr_postprocess.npz")
    collapsed = ctc_collapse_rows(fx["ctc_ids"], fx["ctc_confs"], CTC_VOCAB)
    assert [t for t, _ in collapsed] == list(fx["ctc_texts"])
    np.testing.assert_allclose([c for _, c in collapsed], fx["ctc_text_confs"], atol=1e-6)


def test_clip_scoring_replay():
    from lumen_tpu_torch.models.clip.manager import CLIPManager

    fx = load("clip_classify.npz")
    names = [f"label{i}" for i in range(fx["matrix"].shape[0])]
    mgr = types.SimpleNamespace(classify_mode="softmax")
    res = CLIPManager._classify_vector(mgr, fx["vec"], names, fx["matrix"], top_k=CLIP_TOP_K,
                                       temperature=float(fx["temperature"]))
    np.testing.assert_array_equal([names.index(label) for label, _ in res.labels], fx["top_idx"])
    np.testing.assert_allclose([s for _, s in res.labels], fx["top_probs"], atol=1e-5)


def test_vlm_splice_replay():
    from lumen_tpu_torch.models.vlm.modeling import merge_image_embeddings

    fx = load("vlm_splice.npz")
    merged, positions, out_len = merge_image_embeddings(
        torch.from_numpy(fx["text"]), torch.from_numpy(fx["vis"]), torch.from_numpy(fx["ids"]).long(),
        int(fx["image_token"]), torch.from_numpy(fx["lengths"]))
    np.testing.assert_allclose(merged.numpy(), fx["merged"], atol=1e-6)
    np.testing.assert_array_equal(positions.numpy(), fx["positions"])
    np.testing.assert_array_equal(out_len.numpy(), fx["out_lengths"])
