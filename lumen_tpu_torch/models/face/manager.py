"""Face pipeline manager: detect -> align -> embed on a torch device (the
port of ``lumen_tpu/models/face/manager.py``).

Business logic of the reference's ``FaceModelManager``
(``packages/lumen-face/src/lumen_face/general_face/face_model.py:45-515``)
with the hot math on the device:

- detection (the net, anchors, distance2bbox/kps, top-k, NMS) is one
  batched device call per image batch behind the port's micro-batcher
  (the reference does the decode in numpy per image,
  ``onnxrt_backend.py:882-1290``); the net is an InsightFace SCRFD graph
  on the ONNX bridge, or the native ``FaceDetector``;
- recognition embeds N aligned crops as ONE batched call (the reference
  loops faces sequentially, SURVEY.md §3.4 note);
- over a ``data`` axis (the replica's cards; ``devices=`` names them) the
  detector and embedder are copied onto each data place and each batch
  splits into one part a place, run there, its decode and NMS included,
  the rows gathered back in batch order (``runtime.batcher.mesh_sharded``);
  on a mesh with a ``model`` axis (a serving group's places) the weights
  stay whole, as the JAX manager replicates them over the mesh: a copy on
  rank 0's device of each data place, no program of the group; a
  ``seq`` or ``stage`` axis above 1 keeps that one copy a data place, at
  the first position of its block (``runtime.mesh``), where the JAX
  manager replicates over every device of the block: placement is not a
  result, the detections are the same;
- host side keeps the CV parts: JPEG decode (on the decode pool),
  letterbox, coordinate unmap, similarity-transform alignment
  (``_align_face_5points``, ``onnxrt_backend.py:1382-1416``).

Graphs run in their exported float32 whatever the dtype policy (as in the
JAX package); the native modules follow the policy.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ...core.model_info import dataclass_from_extra, load_model_info
from ...ops.image import letterbox_numpy
from ...ops.nms import nms_torch
from ...runtime.batcher import (
    MicroBatcher,
    batch_wait_timeout,
    mesh_buckets,
    mesh_sharded,
    warmup_batcher,
)
from ...runtime.decode_pool import get_decode_pool
from ...runtime.fleet import (
    batcher_name,
    build_fleet,
    each_batcher,
    fleet_devices,
    plan_replicas,
    replicate_all,
    topology_extra,
)
from ...runtime.policy import get_policy, resolve_device
from ...runtime.quarantine import guarded_key
from ...runtime.result_cache import get_result_cache, make_namespace
from ...runtime.weights import load_safetensors
from .convert import convert_face_checkpoint, face_params_from_jax
from .modeling import (
    ARCFACE_TEMPLATE,
    DetectorConfig,
    FaceDetector,
    IResNet,
    IResNetConfig,
    decode_detections,
)

logger = logging.getLogger(__name__)


@dataclass
class FaceSpec:
    """Pack spec: preprocessing + thresholds. Defaults match the InsightFace
    pack constants (reference ``insightface_specs.py:11-159``); overridable
    via model_info ``extra_metadata.insightface``."""

    det_size: int = 640
    det_mean: float = 127.5
    det_std: float = 128.0
    score_threshold: float = 0.4
    nms_threshold: float = 0.4
    rec_size: int = 112
    rec_mean: float = 127.5
    rec_std: float = 127.5
    rec_color: str = "rgb"  # some packs want bgr crops
    max_detections: int = 128
    # Default detection size gate (max(face w, h) in px); stock packs set
    # 32/1000 (reference insightface_specs min_face/max_face).
    min_face: float = 0.0
    max_face: float = float("inf")

    @classmethod
    def from_extra(cls, extra: dict | None) -> "FaceSpec":
        spec = cls()
        for key, value in (extra or {}).items():
            if hasattr(spec, key):
                setattr(spec, key, value)
        return spec


@dataclass
class FaceDetection:
    bbox: np.ndarray  # [4] x1 y1 x2 y2 (original image coords)
    confidence: float
    landmarks: np.ndarray | None = None  # [5, 2]
    embedding: np.ndarray | None = None  # [512] unit-norm


class FaceManager:
    def __init__(
        self,
        model_dir: str,
        dtype: str = "bfloat16",
        batch_size: int = 8,
        max_batch_latency_ms: float = 5.0,
        detector_cfg: DetectorConfig | None = None,
        embedder_cfg: IResNetConfig | None = None,
        mesh_axes: dict[str, int] | None = None,
        warmup: bool = False,
        allow_random_init: bool = False,
        device: "str | torch.device | None" = None,
        devices: "Sequence[torch.device] | None" = None,
    ):
        self.model_dir = model_dir
        self.info = load_model_info(model_dir)
        self.model_id = self.info.name
        # Spec precedence matches the reference (``_apply_pack_overrides``,
        # onnxrt_backend.py:266-285): known-pack overrides are applied ON TOP
        # of the manifest's extras — for a stock pack name the pack constants
        # win, so the same model dir behaves identically on both stacks.
        from .packs import pack_overrides

        merged_extra = {**(self.info.extra("insightface") or {}), **pack_overrides(self.info.name)}
        self.spec = FaceSpec.from_extra(merged_extra)
        self.policy = get_policy(dtype)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.max_batch_latency_ms = max_batch_latency_ms
        # Replica fleet (LUMEN_REPLICAS / LUMEN_REPLICAS_FACE): one device
        # slice per replica (every card from ``device`` on, or ``devices``),
        # each a data axis over its slice; the single slice when N=1.
        self.fleet_plan = plan_replicas("face", mesh_axes, devices=list(devices or fleet_devices(self.device)))
        self.mesh = self.fleet_plan.meshes[0]
        self.warmup = warmup
        # Architecture comes from the model dir's manifest
        # (extra_metadata.detector / .embedder), explicit args win (tests).
        self.det_cfg = detector_cfg or self._detector_cfg_from_info()
        self.rec_cfg = embedder_cfg or self._embedder_cfg_from_info()
        self.allow_random_init = allow_random_init
        self._initialized = False

    def _detector_cfg_from_info(self) -> DetectorConfig:
        return dataclass_from_extra(
            DetectorConfig,
            self.info.extra("detector"),
            defaults={"input_size": self.spec.det_size},
            tuple_keys=("strides",),
        )

    def _embedder_cfg_from_info(self) -> IResNetConfig:
        defaults = {"input_size": self.spec.rec_size}
        if self.info.embedding_dim:
            defaults["embed_dim"] = self.info.embedding_dim
        return dataclass_from_extra(
            IResNetConfig, self.info.extra("embedder"), defaults=defaults, tuple_keys=("layers",)
        )

    # -- init -------------------------------------------------------------

    def _load_module(self, filename: str, module: torch.nn.Module, kind: str) -> list[list[torch.nn.Module]]:
        """The native module with its checkpoint, one copy per replica and
        data place."""
        path = os.path.join(self.model_dir, filename)
        if os.path.exists(path):
            state = load_safetensors(path)
            kw = {}
            if kind == "recognition":
                final_hw = self.rec_cfg.input_size // 16
                kw = {"final_c": self.rec_cfg.width * 8, "final_hw": final_hw}
            module.load_state_dict(face_params_from_jax(convert_face_checkpoint(state, kind, **kw)), strict=True)
        elif self.allow_random_init:
            logger.warning("%s missing in %s; RANDOM INIT (allow_random_init=True, tests only)", filename, self.model_dir)
        else:
            # A missing checkpoint must hard-fail: serving random weights
            # returns confident garbage with HTTP 200s (round-1 verdict).
            raise FileNotFoundError(
                f"no {kind} weights in {self.model_dir}: expected {filename} "
                f"or a {kind} .onnx graph; pass allow_random_init=True only in tests"
            )
        module = module.to(dtype=self.policy.param_dtype).eval().requires_grad_(False)
        return replicate_all(module, self.fleet_plan)

    def _place_graph(self, module) -> list[list[dict[str, torch.Tensor]]]:
        """The graph's float32 weights, one copy per replica and data place
        (the bridge then drops its host copy)."""
        fleet = replicate_all(module.place, self.fleet_plan)
        module.release_weights()  # the devices hold the weights now
        return fleet

    def initialize(self) -> None:
        if self._initialized:
            return
        s = self.spec
        compute = self.policy.compute_dtype
        det_cfg = self.det_cfg
        from .graph import ArcFaceGraph, ScrfdGraph, find_onnx_models

        onnx_models = find_onnx_models(self.model_dir)

        if "detection" in onnx_models:
            # Real InsightFace pack: run the actual SCRFD graph via the
            # ONNX bridge (the reference runs the same file through
            # onnxruntime, ``onnxrt_backend.py:485-745``).
            graph_det = ScrfdGraph.from_path(onnx_models["detection"], num_anchors=det_cfg.num_anchors)
            mb = graph_det.module.param_bytes() >> 20
            self._det_vars_fleet = self._place_graph(graph_det.module)
            logger.info("face detector: SCRFD graph %s (%d MB params)", onnx_models["detection"], mb)

            @torch.inference_mode()
            def run_detector(variables, images_u8):
                x = (images_u8.float() - s.det_mean) / s.det_std
                outs = graph_det(variables, x.permute(0, 3, 1, 2))
                boxes, kps, scores = decode_detections(
                    outs,
                    det_cfg.input_size,
                    det_cfg.num_anchors,
                    max_detections=s.max_detections,
                    scores_are_logits=False,  # SCRFD graphs end in Sigmoid
                )
                return boxes, kps, scores, nms_torch(boxes, scores, s.nms_threshold)

        else:
            self._det_vars_fleet = self._load_module(
                "detection.safetensors", FaceDetector(det_cfg), "detection")

            @torch.inference_mode()
            def run_detector(detector, images_u8):
                x = (images_u8.float() - s.det_mean) / s.det_std
                outs = detector(x.to(compute))
                boxes, kps, scores = decode_detections(
                    outs, det_cfg.input_size, det_cfg.num_anchors, max_detections=s.max_detections
                )
                # NMS over the full top-k candidate set; the confidence cut
                # happens host-side so a per-request conf_threshold below the
                # pack default still widens the result (NMS processes in score
                # order, so low-score candidates never suppress higher ones).
                return boxes, kps, scores, nms_torch(boxes, scores, s.nms_threshold)

        if "recognition" in onnx_models:
            graph_rec = ArcFaceGraph.from_path(onnx_models["recognition"])
            self._rec_vars_fleet = self._place_graph(graph_rec.module)
            logger.info("face embedder: ArcFace graph %s", onnx_models["recognition"])

            @torch.inference_mode()
            def run_embedder(variables, crops_u8):
                x = (crops_u8.float() - s.rec_mean) / s.rec_std
                emb = graph_rec(variables, x.permute(0, 3, 1, 2)).float()
                return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)

        else:
            self._rec_vars_fleet = self._load_module(
                "recognition.safetensors", IResNet(self.rec_cfg), "recognition")

            @torch.inference_mode()
            def run_embedder(embedder, crops_u8):
                x = (crops_u8.float() - s.rec_mean) / s.rec_std
                emb = embedder(x.to(compute)).float()
                return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)

        #: replica 0's detector and embedder on each data place, and place 0's
        self.det_places, self.rec_places = self._det_vars_fleet[0], self._rec_vars_fleet[0]
        self.det_vars, self.rec_vars = self.det_places[0], self.rec_places[0]
        self._run_detector = run_detector
        self._run_embedder = run_embedder
        dp = self.mesh.shape.get("data", 1)
        det_buckets = mesh_buckets(self.batch_size, dp)
        rec_buckets = mesh_buckets(max(self.batch_size, 16), dp)
        pin = self.device.type == "cuda"

        # Batcher fns receive their part of the stacked batch already on
        # their data place's device, DISPATCH, and return the un-fetched
        # device tensors: decode, top-k and NMS run there, on the card that
        # produced the part, and the MicroBatcher's fetch worker copies each
        # part to the host (batch k+1 stacks while k runs).
        def build_det(rid, mesh):
            places = self._det_vars_fleet[rid or 0]
            return MicroBatcher(
                mesh_sharded([lambda imgs, n, _v=v: self._run_detector(_v, imgs) for v in places], mesh),
                max_batch=det_buckets[-1],
                max_latency_ms=self.max_batch_latency_ms,
                buckets=det_buckets,
                name=batcher_name("face-det", rid),
                replica=None if rid is None else f"r{rid}",
                pin_memory=pin,
            ).start()

        def build_rec(rid, mesh):
            places = self._rec_vars_fleet[rid or 0]
            return MicroBatcher(
                mesh_sharded([lambda crops, n, _v=v: self._run_embedder(_v, crops) for v in places], mesh),
                max_batch=rec_buckets[-1],
                max_latency_ms=self.max_batch_latency_ms,
                buckets=rec_buckets,
                name=batcher_name("face-rec", rid),
                replica=None if rid is None else f"r{rid}",
                pin_memory=pin,
            ).start()

        self._det_batcher = build_fleet(self.fleet_plan, "face-det", build_det)
        self._rec_batcher = build_fleet(self.fleet_plan, "face-rec", build_rec)
        if self.warmup:
            t0 = time.perf_counter()
            ds, rs = self.det_cfg.input_size, self.rec_cfg.input_size
            for b in each_batcher(self._det_batcher):
                warmup_batcher(b, lambda n: np.zeros((n, ds, ds, 3), np.uint8))
            for b in each_batcher(self._rec_batcher):
                warmup_batcher(b, lambda n: np.zeros((n, rs, rs, 3), np.uint8))
            logger.info(
                "face warmup: %d+%d buckets in %.1fs",
                len(det_buckets), len(rec_buckets), time.perf_counter() - t0,
            )
        self._initialized = True
        logger.info(
            "face manager ready: %s (det %d, rec %d) on %s",
            self.model_id, self.det_cfg.input_size, self.rec_cfg.input_size, self.mesh,
        )

    def close(self) -> None:
        if self._initialized:
            self._det_batcher.close()
            self._rec_batcher.close()
            self._initialized = False

    def topology(self) -> dict[str, str]:
        """Device topology + replica layout for the capability ``extra``."""
        return topology_extra(
            self.mesh,
            getattr(self, "_det_batcher", None),
            getattr(self, "_rec_batcher", None),
        )

    # -- caching ----------------------------------------------------------

    def _cache_ns(self, task: str) -> str:
        """Result-cache namespace, qualified by the compute dtype (the JAX
        package's names, ``bfloat16`` / ``float32``) plus the decode-policy
        qualifier: every face task consumes decoded pixels, and scaled
        decode shifts thresholded detections at the margin — a disk-tier
        entry from another decode generation must miss."""
        from ...ops.image import DECODE_POLICY

        return make_namespace(
            "face", task, self.model_id, self.info.version,
            str(self.policy.compute_dtype).removeprefix("torch."), DECODE_POLICY,
        )

    # -- detection --------------------------------------------------------

    def detect_faces(
        self,
        image: bytes | np.ndarray,
        conf_threshold: float | None = None,
        size_min: float | None = None,
        size_max: float | None = None,
        max_faces: int | None = None,
        nms_threshold: float | None = None,
    ) -> list[FaceDetection]:
        """Detect faces in raw image bytes (or a pre-decoded array).

        Byte inputs route through the content-addressed result cache
        keyed on the raw payload + the detection options, BEFORE the
        decode pool — a repeated image skips decode and the device batch
        entirely. Array inputs (callers that already decoded, e.g.
        :meth:`detect_and_extract`) are never cached here; the byte-level
        caller owns the cache entry. Cached detections are deep-copied on
        every hit so callers may mutate their results freely."""
        self._ensure_ready()
        if isinstance(image, (bytes, bytearray)):
            options = {
                "conf_threshold": conf_threshold,
                "size_min": size_min,
                "size_max": size_max,
                "max_faces": max_faces,
                "nms_threshold": nms_threshold,
            }
            payload = bytes(image)
            ns = self._cache_ns("detect")
            key = guarded_key(ns, options, payload)
            return get_result_cache().get_or_compute(
                ns,
                options,
                payload,
                lambda: self._detect_faces_scaled(
                    image, conf_threshold, size_min, size_max, max_faces,
                    nms_threshold, fingerprint=key,
                ),
                clone=copy.deepcopy,
                key=key,
            )
        return self._detect_faces_impl(
            np.asarray(image), conf_threshold, size_min, size_max,
            max_faces, nms_threshold,
        )

    @staticmethod
    def _check_tensor(pixels: np.ndarray) -> np.ndarray:
        if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] != 3:
            raise ValueError(
                "tensor input must be a uint8 HWC RGB image (H, W, 3); "
                f"got {pixels.dtype} {tuple(pixels.shape)}"
            )
        return np.ascontiguousarray(pixels)

    def detect_faces_tensor(
        self, pixels: np.ndarray, raw: bytes | None = None, **det_kw
    ) -> list[FaceDetection]:
        """Pre-decoded RGB tensor (the ``tensor/raw`` wire path): zero
        decode-pool hops — the letterbox runs on the caller's thread and
        the pixels go straight to the detector batcher. Cached on the RAW
        pixel buffer (one sha256, same single-hash guarantee as the JPEG
        path) under a tensor-qualified namespace; coordinates come back
        in the tensor's own frame (decode_scale is 1 by definition —
        whoever decoded chose the resolution)."""
        self._ensure_ready()
        pixels = self._check_tensor(pixels)
        options = {
            "conf_threshold": None, "size_min": None, "size_max": None,
            "max_faces": None, "nms_threshold": None, **det_kw,
        }
        payload = raw if raw is not None else pixels.tobytes()
        ns = self._cache_ns("detect_tensor")
        key = guarded_key(ns, options, payload)
        return get_result_cache().get_or_compute(
            ns,
            options,
            payload,
            lambda: self._detect_faces_impl(
                pixels, options["conf_threshold"], options["size_min"],
                options["size_max"], options["max_faces"],
                options["nms_threshold"], fingerprint=key,
            ),
            clone=copy.deepcopy,
            key=key,
        )

    def detect_and_extract_tensor(
        self, pixels: np.ndarray, raw: bytes | None = None,
        max_faces: int | None = None, **det_kw
    ) -> list[FaceDetection]:
        """Tensor twin of :meth:`detect_and_extract`: detections WITH
        embeddings from a pre-decoded RGB tensor, no decode pool."""
        self._ensure_ready()
        pixels = self._check_tensor(pixels)
        options = {
            "conf_threshold": None, "size_min": None, "size_max": None,
            "nms_threshold": None, **det_kw, "max_faces": max_faces,
        }
        payload = raw if raw is not None else pixels.tobytes()
        ns = self._cache_ns("detect_and_embed_tensor")
        key = guarded_key(ns, options, payload)

        def _compute() -> list[FaceDetection]:
            faces = self._detect_faces_impl(
                pixels, options["conf_threshold"], options["size_min"],
                options["size_max"], max_faces, options["nms_threshold"],
                fingerprint=key,
            )
            if faces:
                self.embed_detections(pixels, faces)
            return faces

        return get_result_cache().get_or_compute(
            ns, options, payload, _compute, clone=copy.deepcopy, key=key
        )

    def _detect_faces_scaled(
        self, image_bytes: bytes, conf_threshold, size_min, size_max,
        max_faces, nms_threshold, fingerprint: str | None = None,
    ) -> list[FaceDetection]:
        """Bytes path with SCALED decode: an oversized photo decodes at
        reduced scale (never below the detector's input size), the decode
        factor is folded into the letterbox unmap, and results come back
        in ORIGINAL image coordinates — identical contract, ~4x less
        decode work."""
        decoded = get_decode_pool().run_decode(
            "decode_scaled", image_bytes,
            {"color": "rgb", "max_edge": self.det_cfg.input_size},
        )
        try:
            dscale, oh, ow = decoded.extras
            return self._detect_faces_impl(
                decoded.array, conf_threshold, size_min, size_max, max_faces,
                nms_threshold, fingerprint=fingerprint,
                decode_scale=dscale, orig_hw=(oh, ow),
            )
        finally:
            decoded.release()

    def _detect_faces_impl(
        self,
        img: np.ndarray,
        conf_threshold: float | None,
        size_min: float | None,
        size_max: float | None,
        max_faces: int | None,
        nms_threshold: float | None,
        fingerprint: str | None = None,
        decode_scale: float = 1.0,
        orig_hw: tuple[int, int] | None = None,
    ) -> list[FaceDetection]:
        """``decode_scale``/``orig_hw`` carry scaled-decode provenance: the
        letterbox unmap divides by ``letterbox_scale * decode_scale`` so
        boxes/landmarks (and the size gates) are in ORIGINAL coordinates
        no matter what resolution the host actually decoded."""
        h, w = orig_hw if orig_hw is not None else img.shape[:2]
        boxed, scale, pad_top, pad_left = letterbox_numpy(img, self.det_cfg.input_size)
        boxes, kps, scores, keep = self._det_batcher(boxed, fingerprint=fingerprint)
        return self.detections_from_outputs(
            boxes, kps, scores, keep,
            scale=scale * decode_scale, pad_top=pad_top, pad_left=pad_left,
            image_hw=(h, w),
            conf_threshold=conf_threshold, size_min=size_min, size_max=size_max,
            max_faces=max_faces, nms_threshold=nms_threshold,
        )

    def detections_from_outputs(
        self,
        boxes: np.ndarray,
        kps: np.ndarray,
        scores: np.ndarray,
        keep: np.ndarray,
        *,
        scale: float,
        pad_top: int,
        pad_left: int,
        image_hw: tuple[int, int],
        conf_threshold: float | None = None,
        size_min: float | None = None,
        size_max: float | None = None,
        max_faces: int | None = None,
        nms_threshold: float | None = None,
    ) -> list[FaceDetection]:
        """Host half of detection: score/keep filtering + letterbox unmap."""
        h, w = image_hw
        if nms_threshold is not None and nms_threshold != self.spec.nms_threshold:
            # The device call bakes the pack's NMS threshold into its
            # keep-mask; a per-request override (reference meta
            # ``nms_threshold``, ``face_service.py:441``) re-suppresses the
            # full decoded candidate set host-side.
            from ...ops.nms import nms_numpy

            finite = np.where(np.isfinite(scores))[0]
            keep = np.zeros(np.shape(scores), bool)
            if finite.size:
                kept = finite[
                    np.asarray(
                        nms_numpy(
                            np.asarray(boxes)[finite].astype(np.float32),
                            np.asarray(scores)[finite].astype(np.float32),
                            float(nms_threshold),
                        )
                    )
                ]
                keep[kept] = True
        conf = self.spec.score_threshold if conf_threshold is None else conf_threshold
        # Size gate defaults come from the pack spec (min_face/max_face);
        # explicit request values still win.
        size_min = self.spec.min_face if size_min is None else size_min
        size_max = self.spec.max_face if size_max is None else size_max
        results: list[FaceDetection] = []
        for i in np.argsort(-scores):
            if not keep[i] or not np.isfinite(scores[i]) or scores[i] < conf:
                continue
            # Undo letterbox: subtract padding, divide by scale, clip.
            box = boxes[i].astype(np.float64)
            box[[0, 2]] = (box[[0, 2]] - pad_left) / scale
            box[[1, 3]] = (box[[1, 3]] - pad_top) / scale
            box = np.clip(box, [0, 0, 0, 0], [w, h, w, h])
            bw, bh = box[2] - box[0], box[3] - box[1]
            if bw <= 0 or bh <= 0:  # degenerate prediction
                continue
            side = max(bw, bh)
            if not (size_min <= side <= size_max):
                continue
            lm = kps[i].astype(np.float64)
            lm[:, 0] = (lm[:, 0] - pad_left) / scale
            lm[:, 1] = (lm[:, 1] - pad_top) / scale
            results.append(
                FaceDetection(bbox=box.astype(np.float32), confidence=float(scores[i]), landmarks=lm.astype(np.float32))
            )
            if max_faces is not None and len(results) >= max_faces:
                break
        return results

    # -- recognition ------------------------------------------------------

    def align_crop(self, img: np.ndarray, landmarks: np.ndarray) -> np.ndarray:
        """5-point similarity-transform alignment to the canonical ArcFace
        112x112 template (reference ``_align_face_5points``). 68-point
        (iBUG) landmark sets reduce to the canonical 5 first — the
        reference contract accepts 68 but silently skips alignment for
        them (``onnxrt_backend.py:1327-1332``); deriving the 5 keeps the
        embedding aligned either way."""
        import cv2

        landmarks = np.asarray(landmarks, np.float32)
        if landmarks.shape == (68, 2):
            landmarks = np.stack(
                [
                    landmarks[36:42].mean(0),  # left eye center
                    landmarks[42:48].mean(0),  # right eye center
                    landmarks[30],  # nose tip
                    landmarks[48],  # left mouth corner
                    landmarks[54],  # right mouth corner
                ]
            )
        template = np.asarray(ARCFACE_TEMPLATE, np.float32) * (self.rec_cfg.input_size / 112.0)
        matrix, _ = cv2.estimateAffinePartial2D(landmarks, template, method=cv2.LMEDS)
        if matrix is None:
            return self._center_crop(img)
        return cv2.warpAffine(img, matrix, (self.rec_cfg.input_size, self.rec_cfg.input_size))

    def _center_crop(self, img: np.ndarray) -> np.ndarray:
        import cv2

        return cv2.resize(img, (self.rec_cfg.input_size, self.rec_cfg.input_size))

    def extract_embedding(
        self, face_image: bytes | np.ndarray, landmarks: np.ndarray | None = None
    ) -> np.ndarray:
        self._ensure_ready()
        if isinstance(face_image, (bytes, bytearray)):
            # Cache on the raw crop bytes + landmarks, before the decode
            # pool; hits return private copies (in-place caller mutation
            # must not poison the store).
            options = {
                "landmarks": None if landmarks is None
                else np.asarray(landmarks, np.float32).tolist()
            }
            payload = bytes(face_image)
            ns = self._cache_ns("embed")
            key = guarded_key(ns, options, payload)

            def _decode_and_embed():
                decoded = get_decode_pool().run_decode(
                    "decode", face_image, {"color": "rgb"}
                )
                try:
                    return self._extract_embedding_impl(
                        decoded.array, landmarks, fingerprint=key
                    )
                finally:
                    decoded.release()

            return get_result_cache().get_or_compute(
                ns,
                options,
                payload,
                _decode_and_embed,
                clone=np.copy,
                key=key,
            )
        return self._extract_embedding_impl(np.asarray(face_image), landmarks)

    def _extract_embedding_impl(
        self, img: np.ndarray, landmarks: np.ndarray | None, fingerprint: str | None = None
    ) -> np.ndarray:
        crop = self.align_crop(img, landmarks) if landmarks is not None else self._center_crop(img)
        if self.spec.rec_color == "bgr":
            crop = crop[:, :, ::-1]
        return self._rec_batcher(np.ascontiguousarray(crop), fingerprint=fingerprint)

    def detect_and_extract(
        self, image_bytes: bytes, max_faces: int | None = None, **det_kw
    ) -> list[FaceDetection]:
        # Whole-pipeline cache entry (detections WITH embeddings), keyed on
        # the raw payload + every detection knob. Knobs are normalized to
        # the full explicit set (same shape detect_faces keys with) so an
        # omitted kwarg and an explicit None — identical semantics — hash
        # to ONE entry instead of two.
        self._ensure_ready()
        options = {
            "conf_threshold": None,
            "size_min": None,
            "size_max": None,
            "nms_threshold": None,
            **det_kw,
            "max_faces": max_faces,
        }
        payload = bytes(image_bytes)
        ns = self._cache_ns("detect_and_embed")
        key = guarded_key(ns, options, payload)
        return get_result_cache().get_or_compute(
            ns,
            options,
            payload,
            lambda: self._detect_and_extract_impl(image_bytes, max_faces, det_kw),
            clone=copy.deepcopy,
            key=key,
        )

    def _detect_and_extract_impl(
        self, image_bytes: bytes, max_faces: int | None, det_kw: dict
    ) -> list[FaceDetection]:
        # Decode once (on the shared pool — never on the gRPC handler
        # thread), SCALED: the detector never needs more than its input
        # size, and embedding crops are resized to the recognizer's input
        # anyway. Detection results stay in original coordinates; the
        # decode factor maps them back onto the decoded array for crops.
        decoded = get_decode_pool().run_decode(
            "decode_scaled", image_bytes,
            {"color": "rgb", "max_edge": self.det_cfg.input_size},
        )
        try:
            dscale, oh, ow = decoded.extras
            img = decoded.array
            faces = self._detect_faces_impl(
                img, det_kw.get("conf_threshold"), det_kw.get("size_min"),
                det_kw.get("size_max"), max_faces, det_kw.get("nms_threshold"),
                decode_scale=dscale, orig_hw=(oh, ow),
            )
            if not faces:
                return faces
            self.embed_detections(img, faces, coord_scale=dscale)
            return faces
        finally:
            decoded.release()

    def embed_detections(
        self, img: np.ndarray, faces: list[FaceDetection], coord_scale: float = 1.0
    ) -> None:
        """Fill ``embedding`` on each detection: align-crop (or bbox-crop
        fallback), per-spec color order, ONE coalesced embedder call.
        ``coord_scale`` maps detections in ORIGINAL coordinates onto a
        scaled-decoded ``img`` (decoded/original edge ratio; 1.0 = full
        decode)."""
        crops = []
        for f in faces:
            lm = (
                np.asarray(f.landmarks, np.float32) * coord_scale
                if f.landmarks is not None
                else None
            )
            crop = self.align_crop(img, lm) if lm is not None else None
            if crop is None:
                x1, y1, x2, y2 = [int(round(v * coord_scale)) for v in f.bbox]
                crop = self._center_crop(img[max(y1, 0) : y2, max(x1, 0) : x2])
            if self.spec.rec_color == "bgr":
                crop = crop[:, :, ::-1]
            crops.append(np.ascontiguousarray(crop))
        # Concurrent submits coalesce into one batched device call.
        futures = [self._rec_batcher.submit(c) for c in crops]
        wait = batch_wait_timeout()
        for f, fut in zip(faces, futures):
            f.embedding = fut.result(timeout=wait)

    # -- comparisons (reference face_model.py:371-429) --------------------

    @staticmethod
    def compare_faces(emb1: np.ndarray, emb2: np.ndarray) -> float:
        return float(np.dot(emb1, emb2))

    @staticmethod
    def find_best_match(
        query: np.ndarray, gallery: np.ndarray, threshold: float = 0.35
    ) -> tuple[int, float] | None:
        if len(gallery) == 0:
            return None
        sims = gallery @ query
        idx = int(np.argmax(sims))
        if sims[idx] < threshold:
            return None
        return idx, float(sims[idx])

    @staticmethod
    def crop_face(image_bytes: bytes, bbox: np.ndarray, margin: float = 0.0) -> np.ndarray:
        decoded = get_decode_pool().run_decode("decode", image_bytes, {"color": "rgb"})
        try:
            img = decoded.array
            h, w = img.shape[:2]
            x1, y1, x2, y2 = bbox
            mw, mh = (x2 - x1) * margin, (y2 - y1) * margin
            x1, y1 = max(int(x1 - mw), 0), max(int(y1 - mh), 0)
            x2, y2 = min(int(x2 + mw), w), min(int(y2 + mh), h)
            # Copy out unconditionally: the decoded array may be a
            # shared-memory arena view whose slot is recycled on release.
            return np.array(img[y1:y2, x1:x2], copy=True)
        finally:
            decoded.release()

    def _ensure_ready(self) -> None:
        if not self._initialized:
            raise RuntimeError("FaceManager.initialize() not called")
