"""OCR pipeline manager: detect text regions -> crop -> recognize on a torch
device (the port of ``lumen_tpu/models/ocr/manager.py``).

Business logic of the reference's ``OcrModelManager`` + ONNX backend
(``packages/lumen-ocr/src/lumen_ocr/general_ocr/ocr_model.py:27-214``,
``backends/onnxrt_backend.py:43-633``), with the JAX package's shapes:

- detection letterboxes into a small set of square **buckets** (default
  320/640/960) where the reference resizes each image to its own x32
  multiple;
- recognition crops are height-``rec_h``, padded into **width buckets** and
  run as one batched device call per bucket, the batch padded to a batch
  bucket (padded rows have width 0 and come out all blank);
- CTC argmax + per-step confidence run on the device (``ops.ctc``), the
  collapse-to-string on the host;
- contours/unclip/warps stay host-side cv2.

The buckets are kept for the answers, not for compiles (the port compiles
nothing): the native recognizer's attention mixes over the whole padded
width, so a crop's text depends on its width bucket, and the detector's
box coordinates depend on the letterbox bucket. Graphs run in their
exported float32 whatever the dtype policy (as in the JAX package); the
native modules follow the policy.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ...core.model_info import dataclass_from_extra, load_model_info
from ...ops.ctc import ctc_collapse_rows, ctc_greedy_device, load_ctc_vocab
from ...ops.image import letterbox_numpy
from ...runtime import telemetry
from ...runtime.batcher import bucket_for
from ...runtime.decode_pool import get_decode_pool
from ...runtime.policy import get_policy, resolve_device
from ...runtime.quarantine import guarded_key
from ...runtime.result_cache import get_result_cache, make_namespace
from ...runtime.weights import load_safetensors
from .convert import convert_ocr_checkpoint, ocr_params_from_jax
from .modeling import (
    ClsConfig,
    DBNet,
    DBNetConfig,
    SVTRConfig,
    SVTRRecognizer,
    TextlineClassifier,
)
from .postprocess import boxes_from_prob_map, rotate_crop, sorted_boxes

logger = logging.getLogger(__name__)

# PaddleOCR preprocessing conventions (reference defaults at
# ``onnxrt_backend.py:242-268``): detection uses ImageNet stats, the
# recognizer uses symmetric (x/255 - 0.5) / 0.5.
DET_MEAN = (0.485, 0.456, 0.406)
DET_STD = (0.229, 0.224, 0.225)
REC_MEAN = (0.5, 0.5, 0.5)
REC_STD = (0.5, 0.5, 0.5)


class _DirectLane:
    """Minimal dispatch unit standing in for a batcher/engine in the OCR
    family's :class:`~lumen_tpu_torch.runtime.fleet.EngineFleet`. OCR
    dispatches ragged det/rec shapes directly (no queue to measure, nothing
    to close), so the unit exists to give the family a chip claim in the
    ledger and a ``device:{name}`` duty meter. A 1-unit fleet can never be
    parked (the floor of 1)."""

    def __init__(self, name: str):
        self.name = name

    def load(self) -> int:
        return 0

    def close(self) -> None:
        return None


@dataclass
class OcrResult:
    box: np.ndarray  # [4, 2] quad, original-image coords
    text: str
    confidence: float


@dataclass
class OcrSpec:
    """Pipeline knobs; defaults match the reference's det/rec configs.
    Overridable via model_info ``extra_metadata.ocr``."""

    det_buckets: tuple[int, ...] = (320, 640, 960)
    det_threshold: float = 0.3
    box_threshold: float = 0.6
    unclip_ratio: float = 1.5
    max_candidates: int = 1000
    min_size: float = 3.0
    rec_height: int = 48
    rec_width_buckets: tuple[int, ...] = (80, 160, 320, 640)
    rec_batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    det_mean: tuple[float, ...] = DET_MEAN
    det_std: tuple[float, ...] = DET_STD
    rec_mean: tuple[float, ...] = REC_MEAN
    rec_std: tuple[float, ...] = REC_STD
    rec_threshold: float = 0.5
    drop_rec_below_threshold: bool = True
    charset_file: str = "ppocr_keys_v1.txt"
    use_space_char: bool = True
    # Textline-orientation classifier (PP-OCR ``cls``): flip a crop 180deg
    # only above this confidence (PaddleOCR's cls_thresh default).
    cls_thresh: float = 0.9
    cls_height: int = 48
    cls_width: int = 192

    @classmethod
    def from_extra(cls, extra: dict | None) -> "OcrSpec":
        return dataclass_from_extra(
            cls,
            extra,
            tuple_keys=(
                "det_buckets",
                "rec_width_buckets",
                "rec_batch_buckets",
                "det_mean",
                "det_std",
                "rec_mean",
                "rec_std",
            ),
        )


def _fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Same-shape device results -> host numpy arrays in ONE device-to-host
    copy (stacked as float32; ids below 2**24 stay exact)."""
    packed = torch.stack([t.float() for t in tensors]).cpu().numpy()
    return list(packed)


class OcrManager:
    def __init__(
        self,
        model_dir: str,
        dtype: str = "bfloat16",
        batch_size: int = 8,
        det_cfg: DBNetConfig | None = None,
        rec_cfg: SVTRConfig | None = None,
        warmup: bool = False,
        allow_random_init: bool = False,
        det_buckets: tuple[int, ...] | None = None,
        device: "str | torch.device | None" = None,
    ):
        self.model_dir = model_dir
        self.info = load_model_info(model_dir)
        self.model_id = self.info.name
        self.spec = OcrSpec.from_extra(self.info.extra("ocr"))
        if det_buckets:  # deployment preset overrides the manifest default
            self.spec.det_buckets = tuple(sorted(det_buckets))
        self.policy = get_policy(dtype)
        self.device = resolve_device(device)
        self.warmup = warmup
        self.batch_size = batch_size
        self.vocab = self._load_vocab()
        self.det_cfg = det_cfg or self._det_cfg_from_info()
        self.rec_cfg = rec_cfg or self._rec_cfg_from_info()
        self.allow_random_init = allow_random_init
        self._initialized = False

    def _load_vocab(self) -> list[str]:
        path = os.path.join(self.model_dir, self.spec.charset_file)
        if os.path.exists(path):
            return load_ctc_vocab(path, self.spec.use_space_char)
        # Printable-ASCII fallback so tests and charset-less dirs still run.
        logger.warning("charset file %s missing; using ASCII fallback vocab", path)
        chars = [chr(c) for c in range(33, 127)]
        return ["<blank>"] + chars + ([" "] if self.spec.use_space_char else [])

    def _det_cfg_from_info(self) -> DBNetConfig:
        return dataclass_from_extra(DBNetConfig, self.info.extra("detector"))

    def _rec_cfg_from_info(self) -> SVTRConfig:
        return dataclass_from_extra(
            SVTRConfig,
            self.info.extra("recognizer"),
            defaults={
                "vocab_size": len(self.vocab),
                "height": self.spec.rec_height,
                "max_width": max(self.spec.rec_width_buckets),
            },
        )

    # -- init -------------------------------------------------------------

    def _load_module(self, filename: str, module: torch.nn.Module, kind: str) -> torch.nn.Module:
        """The native module with its checkpoint, cast by the policy, on the
        device, in eval mode."""
        path = os.path.join(self.model_dir, filename)
        if os.path.exists(path):
            variables = convert_ocr_checkpoint(load_safetensors(path))
            module.load_state_dict(ocr_params_from_jax(variables, module), strict=True)
        elif self.allow_random_init:
            # torch's initialisers, not Flax's: a random module here never
            # equals the JAX package's random init.
            logger.warning("%s missing in %s; RANDOM INIT from torch.manual_seed(0) (allow_random_init=True, "
                           "tests only; not Flax's initialiser)", filename, self.model_dir)
        else:
            # A missing checkpoint must hard-fail: serving random weights
            # returns confident garbage with HTTP 200s (round-1 verdict).
            raise FileNotFoundError(
                f"no {kind} weights in {self.model_dir}: expected {filename} "
                f"or a {kind} .onnx graph; pass allow_random_init=True only in tests"
            )
        return module.to(device=self.device, dtype=self.policy.param_dtype).eval().requires_grad_(False)

    def _new_module(self, build):
        if self.allow_random_init:
            torch.manual_seed(0)
        return build()

    def _place_graph(self, module) -> dict[str, torch.Tensor]:
        """The graph's float32 weights on the device (the bridge then drops
        its host copy)."""
        params = module.place(self.device)
        module.release_weights()  # the device holds the weights now
        return params

    def initialize(self) -> None:
        if self._initialized:
            return
        s = self.spec
        compute = self.policy.compute_dtype
        dev = self.device
        det_mean = torch.tensor(s.det_mean, dtype=torch.float32, device=dev)
        det_std = torch.tensor(s.det_std, dtype=torch.float32, device=dev)
        rec_mean = torch.tensor(s.rec_mean, dtype=torch.float32, device=dev)
        rec_std = torch.tensor(s.rec_std, dtype=torch.float32, device=dev)

        from .graph import DBNetGraph, RecGraph, find_onnx_models

        onnx_models = find_onnx_models(self.model_dir)

        if "detection" in onnx_models:
            # Real PP-OCR det export: run the actual DBNet graph via the
            # ONNX bridge (reference runs the same file through
            # onnxruntime, ``onnxrt_backend.py:122-126``).
            graph_det = DBNetGraph.from_path(onnx_models["detection"])
            mb = graph_det.module.param_bytes() >> 20
            self.det_vars = self._place_graph(graph_det.module)
            logger.info("ocr detector: DBNet graph %s (%d MB params)", onnx_models["detection"], mb)

            @torch.inference_mode()
            def run_detector(variables, images_u8):
                x = (images_u8.float() / 255.0 - det_mean) / det_std
                return graph_det(variables, x.permute(0, 3, 1, 2))

        else:
            self.det_vars = self._load_module(
                "detection.safetensors", self._new_module(lambda: DBNet(self.det_cfg)), "detection")

            @torch.inference_mode()
            def run_detector(detector, images_u8):
                x = (images_u8.float() / 255.0 - det_mean) / det_std
                return detector(x.to(compute).permute(0, 3, 1, 2))

        def _mask_padding(ids, conf, crop_w: int, t: int, widths):
            # Mask timesteps past each crop's true width (padding region):
            # force blank id 0 / confidence 1 so collapse ignores them.
            downsample = max(crop_w // t, 1)
            steps = torch.arange(t, device=ids.device)[None, :] * downsample
            valid = steps < widths[:, None]
            return torch.where(valid, ids, 0), torch.where(valid, conf, 1.0)

        if "recognition" in onnx_models:
            graph_rec = RecGraph.from_path(onnx_models["recognition"])
            self.rec_vars = self._place_graph(graph_rec.module)
            logger.info("ocr recognizer: graph %s (softmax output: %s)",
                        onnx_models["recognition"], graph_rec.outputs_probs)

            @torch.inference_mode()
            def run_recognizer(variables, crops_u8, widths):
                x = (crops_u8.float() / 255.0 - rec_mean) / rec_std
                frames = graph_rec(variables, x.permute(0, 3, 1, 2))
                if graph_rec.outputs_probs:
                    # Graph already ends in Softmax — re-softmaxing would
                    # flatten confidences (argmax unchanged, conf wrong).
                    probs = frames.float()
                    ids, conf = probs.argmax(-1), probs.amax(-1)
                else:
                    ids, conf = ctc_greedy_device(frames)
                return _mask_padding(ids, conf, crops_u8.shape[2], frames.shape[1], widths)

        else:
            self.rec_vars = self._load_module(
                "recognition.safetensors", self._new_module(lambda: SVTRRecognizer(self.rec_cfg)), "recognition")

            @torch.inference_mode()
            def run_recognizer(recognizer, crops_u8, widths):
                x = (crops_u8.float() / 255.0 - rec_mean) / rec_std
                logits = recognizer(x.to(compute).permute(0, 3, 1, 2))
                ids, conf = ctc_greedy_device(logits)
                return _mask_padding(ids, conf, crops_u8.shape[2], logits.shape[1], widths)

        # Optional textline-orientation classifier. Unlike det/rec, a
        # missing cls is NOT an error: the backend contract marks it
        # optional ("if available", reference ``lumen_ocr/backends/
        # base.py:63-136``). Precedence mirrors det/rec: real ONNX export
        # first, then a native checkpoint.
        run_cls = None
        if "classification" in onnx_models:
            from .graph import ClsGraph

            graph_cls = ClsGraph.from_path(onnx_models["classification"])
            self.cls_vars = self._place_graph(graph_cls.module)
            self._cls_hw = (s.cls_height, s.cls_width)
            logger.info("ocr cls: graph %s", onnx_models["classification"])

            @torch.inference_mode()
            def run_cls(variables, crops_u8):
                x = (crops_u8.float() / 255.0 - rec_mean) / rec_std
                return graph_cls(variables, x.permute(0, 3, 1, 2))

        elif os.path.exists(os.path.join(self.model_dir, "classification.safetensors")):
            self.cls_cfg = dataclass_from_extra(ClsConfig, self.info.extra("classifier"))
            self.cls_vars = self._load_module(
                "classification.safetensors", TextlineClassifier(self.cls_cfg), "classification")
            self._cls_hw = (self.cls_cfg.height, self.cls_cfg.width)

            @torch.inference_mode()
            def run_cls(classifier, crops_u8):
                x = (crops_u8.float() / 255.0 - rec_mean) / rec_std
                logits = classifier(x.to(compute).permute(0, 3, 1, 2))
                return torch.softmax(logits.float(), dim=-1)

        self._run_detector = run_detector
        self._run_recognizer = run_recognizer
        self._run_cls = run_cls
        if self.warmup:
            t0 = time.perf_counter()
            # Every det bucket, plus the smallest rec width x batch bucket
            # (cuDNN picks its algorithms and the kernels load on the
            # first call of a shape).
            for b in s.det_buckets:
                self._run_detector(self.det_vars, torch.zeros((1, b, b, 3), dtype=torch.uint8, device=dev)).cpu()
            rw, rb = min(s.rec_width_buckets), min(s.rec_batch_buckets)
            _fetch(*self._run_recognizer(
                self.rec_vars,
                torch.zeros((rb, self.rec_cfg.height, rw, 3), dtype=torch.uint8, device=dev),
                torch.zeros((rb,), dtype=torch.int32, device=dev),
            ))
            logger.info("ocr warmup in %.1fs", time.perf_counter() - t0)
        # Chip-ledger + duty coverage: a 1-unit engine fleet so the
        # family's device claim and duty are counted like every other
        # family's (it can never park the last unit).
        from ...runtime.fleet import EngineFleet

        self._lane = _DirectLane(self.info.name)
        telemetry.set_capacity(f"device:{self._lane.name}", 1.0, union=True)
        self._fleet = EngineFleet(self.info.name, [self._lane], devices_per_replica=1)
        self._initialized = True
        logger.info(
            "ocr manager ready: %s (det buckets %s, rec h=%d, vocab %d) on %s",
            self.model_id, s.det_buckets, self.rec_cfg.height, len(self.vocab), self.device,
        )

    def close(self) -> None:
        fleet = getattr(self, "_fleet", None)
        if fleet is not None:
            fleet.close()
            self._fleet = None
        self._initialized = False

    def topology(self) -> dict[str, str]:
        """Device topology for the capability ``extra``. OCR dispatches
        ragged det/rec shapes directly (no MicroBatcher, no mesh), so it
        reports a single replica."""
        from ...runtime.fleet import topology_extra

        return topology_extra(None)

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- detection --------------------------------------------------------

    def detect(
        self,
        img: np.ndarray,
        det_threshold: float | None = None,
        box_threshold: float | None = None,
        unclip_ratio: float | None = None,
    ) -> list[tuple[np.ndarray, float]]:
        """[H, W, 3] RGB -> list of (quad [4, 2], det score), reading order."""
        self._ensure_ready()
        s = self.spec
        h, w = img.shape[:2]
        bucket = bucket_for(max(h, w), list(s.det_buckets))
        boxed, scale, pad_top, pad_left = letterbox_numpy(img, bucket)
        # One device-to-host copy per detector call, for the cv2 postprocess.
        t0 = time.monotonic()
        prob = _fetch(self._run_detector(self.det_vars, self._on_device(boxed[None])))[0][0]
        telemetry.busy(f"device:{self.info.name}", t0, time.monotonic())
        return self.boxes_from_det_output(
            prob,
            image_hw=(h, w),
            scale=scale,
            pad_top=pad_top,
            pad_left=pad_left,
            det_threshold=det_threshold,
            box_threshold=box_threshold,
            unclip_ratio=unclip_ratio,
        )

    def boxes_from_det_output(
        self,
        prob: np.ndarray,
        *,
        image_hw: tuple[int, int],
        scale: float,
        pad_top: int,
        pad_left: int,
        det_threshold: float | None = None,
        box_threshold: float | None = None,
        unclip_ratio: float | None = None,
    ) -> list[tuple[np.ndarray, float]]:
        """Host half of detection: prob map -> ordered (quad, score) list.
        Shared by the per-request path above and the batch-ingest pipeline."""
        s = self.spec
        found = boxes_from_prob_map(
            prob,
            det_threshold=s.det_threshold if det_threshold is None else det_threshold,
            box_threshold=s.box_threshold if box_threshold is None else box_threshold,
            unclip_ratio=s.unclip_ratio if unclip_ratio is None else unclip_ratio,
            max_candidates=s.max_candidates,
            min_size=s.min_size,
            dest_hw=image_hw,
            scale=scale,
            pad_top=pad_top,
            pad_left=pad_left,
        )
        if not found:
            return []
        order = sorted_boxes([b for b, _ in found])
        return [found[i] for i in order]

    # -- recognition ------------------------------------------------------

    def recognize_crops(self, crops: list[np.ndarray]) -> list[tuple[str, float]]:
        """Height-``rec_h`` resize, width-bucket pad, one device call per
        bucket group, device CTC argmax, host collapse."""
        self._ensure_ready()
        import cv2

        rec_h = self.rec_cfg.height
        prepared: list[tuple[int, np.ndarray, int]] = []  # (bucket, padded, width)
        for crop in crops:
            ch, cw = crop.shape[:2]
            new_w = max(int(round(cw * rec_h / max(ch, 1))), 1)
            bucket = bucket_for(new_w, list(self.spec.rec_width_buckets))
            new_w = min(new_w, bucket)
            resized = cv2.resize(crop, (new_w, rec_h), interpolation=cv2.INTER_LINEAR)
            padded = np.zeros((rec_h, bucket, 3), np.uint8)
            padded[:, :new_w] = resized
            prepared.append((bucket, padded, new_w))
        results: list[tuple[str, float] | None] = [None] * len(crops)
        by_bucket: dict[int, list[int]] = {}
        for i, (bucket, _, _) in enumerate(prepared):
            by_bucket.setdefault(bucket, []).append(i)
        max_bb = max(self.spec.rec_batch_buckets)
        for bucket, idxs in by_bucket.items():
            # The batch dim is padded to a batch bucket too; padding rows
            # carry width 0, so every timestep masks to blank.
            for start in range(0, len(idxs), max_bb):
                chunk = idxs[start : start + max_bb]
                bb = bucket_for(len(chunk), list(self.spec.rec_batch_buckets))
                batch = np.zeros((bb, self.rec_cfg.height, bucket, 3), np.uint8)
                widths = np.zeros((bb,), np.int32)
                for row, i in enumerate(chunk):
                    batch[row] = prepared[i][1]
                    widths[row] = prepared[i][2]
                # ONE device-to-host copy for the chunk's (ids, conf).
                t0 = time.monotonic()
                ids, conf = _fetch(*self._run_recognizer(
                    self.rec_vars, self._on_device(batch), self._on_device(widths)))
                telemetry.busy(f"device:{self.info.name}", t0, time.monotonic())
                # Slice off batch-bucket padding rows before the host collapse.
                ids = ids[: len(chunk)].astype(np.int32)
                conf = conf[: len(chunk)]
                collapsed = ctc_collapse_rows(ids, conf, self.vocab)
                for row, i in enumerate(chunk):
                    results[i] = collapsed[row]
        return results  # type: ignore[return-value]

    # -- textline orientation ---------------------------------------------

    @property
    def has_angle_cls(self) -> bool:
        return getattr(self, "_run_cls", None) is not None

    def classify_angles(self, crops: list[np.ndarray]) -> list[bool]:
        """True where a crop is upside-down (class 180 above ``cls_thresh``).
        One batched device call on letterboxed ``cls_height x cls_width``
        crops — the PP-OCR cls contract the reference declares but never
        executes (``onnxrt_backend.py:73``)."""
        self._ensure_ready()
        if not self.has_angle_cls or not crops:
            return [False] * len(crops)
        import cv2

        h, w = self._cls_hw
        prepared = np.zeros((len(crops), h, w, 3), np.uint8)
        for i, crop in enumerate(crops):
            ch, cw = crop.shape[:2]
            new_w = min(max(int(round(cw * h / max(ch, 1))), 1), w)
            prepared[i, :, :new_w] = cv2.resize(crop, (new_w, h), interpolation=cv2.INTER_LINEAR)
        # Batch-bucket like recognize_crops. Padding rows are all-zero
        # crops; their predictions are discarded.
        probs = np.zeros((len(crops), 2), np.float32)
        max_bb = max(self.spec.rec_batch_buckets)
        for start in range(0, len(crops), max_bb):
            chunk = prepared[start : start + max_bb]
            bb = bucket_for(len(chunk), list(self.spec.rec_batch_buckets))
            batch = np.zeros((bb, h, w, 3), np.uint8)
            batch[: len(chunk)] = chunk
            out = _fetch(self._run_cls(self.cls_vars, self._on_device(batch)))[0]
            probs[start : start + len(chunk)] = out[: len(chunk)]
        # PaddleOCR semantics: rotate only when 180 wins the argmax AND
        # clears cls_thresh — below it, leaving the crop alone is safer.
        return [bool(p.argmax() == 1 and p[1] > self.spec.cls_thresh) for p in probs]

    # -- end-to-end -------------------------------------------------------

    def _cache_ns(self, task: str) -> str:
        """Result-cache namespace, qualified by the compute dtype (the JAX
        package's names, ``bfloat16`` / ``float32``)."""
        return make_namespace(
            "ocr", task, self.model_id, self.info.version,
            str(self.policy.compute_dtype).removeprefix("torch."),
        )

    def predict(
        self,
        image_bytes: bytes,
        det_threshold: float | None = None,
        rec_threshold: float | None = None,
        box_threshold: float | None = None,
        unclip_ratio: float | None = None,
        use_angle_cls: bool = False,
    ) -> list[OcrResult]:
        """Full pipeline on raw image bytes (reference ``predict`` contract,
        ``lumen_ocr/backends/base.py:63-136``, including ``use_angle_cls``).
        Content-addressed result cache first (a repeated page skips decode,
        both device calls and the contour/warp work; concurrent identical
        requests coalesce onto one flight); on a miss, decode runs on the
        shared pool."""
        self._ensure_ready()
        options = {
            "det_threshold": det_threshold,
            "rec_threshold": rec_threshold,
            "box_threshold": box_threshold,
            "unclip_ratio": unclip_ratio,
            "use_angle_cls": use_angle_cls,
        }
        payload = bytes(image_bytes)
        ns = self._cache_ns("predict")
        # Quarantine gate on the same content address the cache uses.
        key = guarded_key(ns, options, payload)
        return get_result_cache().get_or_compute(
            ns,
            options,
            payload,
            lambda: self._predict_uncached(
                image_bytes, det_threshold, rec_threshold, box_threshold,
                unclip_ratio, use_angle_cls,
            ),
            clone=copy.deepcopy,
            key=key,
        )

    def _predict_uncached(
        self,
        image_bytes: bytes,
        det_threshold: float | None,
        rec_threshold: float | None,
        box_threshold: float | None,
        unclip_ratio: float | None,
        use_angle_cls: bool,
    ) -> list[OcrResult]:
        decoded = get_decode_pool().run_decode("decode", image_bytes, {"color": "rgb"})
        try:
            img = decoded.array
            boxes = self.detect(
                img,
                det_threshold=det_threshold,
                box_threshold=box_threshold,
                unclip_ratio=unclip_ratio,
            )
            if not boxes:
                return []
            return self.recognize_boxes(
                img, boxes, rec_threshold=rec_threshold, use_angle_cls=use_angle_cls
            )
        finally:
            decoded.release()

    def predict_tensor(
        self,
        pixels: np.ndarray,
        raw: bytes | None = None,
        det_threshold: float | None = None,
        rec_threshold: float | None = None,
        box_threshold: float | None = None,
        unclip_ratio: float | None = None,
        use_angle_cls: bool = False,
    ) -> list[OcrResult]:
        """Pre-decoded RGB tensor (the ``tensor/raw`` wire path): the full
        OCR pipeline with no decode-pool hop. Cached on the raw pixel buffer
        under a tensor-qualified namespace — raw pixels and encoded bytes of
        one page never answer for each other."""
        self._ensure_ready()
        if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] != 3:
            raise ValueError(
                "tensor input must be a uint8 HWC RGB image (H, W, 3); "
                f"got {pixels.dtype} {tuple(pixels.shape)}"
            )
        pixels = np.ascontiguousarray(pixels)
        options = {
            "det_threshold": det_threshold,
            "rec_threshold": rec_threshold,
            "box_threshold": box_threshold,
            "unclip_ratio": unclip_ratio,
            "use_angle_cls": use_angle_cls,
        }
        payload = raw if raw is not None else pixels.tobytes()
        ns = self._cache_ns("predict_tensor")
        key = guarded_key(ns, options, payload)

        def _compute() -> list[OcrResult]:
            boxes = self.detect(
                pixels,
                det_threshold=det_threshold,
                box_threshold=box_threshold,
                unclip_ratio=unclip_ratio,
            )
            if not boxes:
                return []
            return self.recognize_boxes(
                pixels, boxes, rec_threshold=rec_threshold, use_angle_cls=use_angle_cls,
            )

        return get_result_cache().get_or_compute(
            ns, options, payload, _compute, clone=copy.deepcopy, key=key
        )

    def recognize_boxes(
        self,
        img: np.ndarray,
        boxes: list[tuple[np.ndarray, float]],
        rec_threshold: float | None = None,
        use_angle_cls: bool = False,
    ) -> list[OcrResult]:
        """Crop each detected quad, recognize, and apply the rec-confidence
        drop policy. Shared with the batch-ingest pipeline."""
        crops = [rotate_crop(img, quad) for quad, _ in boxes]
        if use_angle_cls:
            if self.has_angle_cls:
                flips = self.classify_angles(crops)
                crops = [np.ascontiguousarray(c[::-1, ::-1]) if f else c for c, f in zip(crops, flips)]
            else:
                # Contract says "if available" — an absent model degrades
                # to a no-op (the reference's permanent behavior).
                logger.debug("use_angle_cls requested but no cls model in %s", self.model_dir)
        texts = self.recognize_crops(crops)
        thr = self.spec.rec_threshold if rec_threshold is None else rec_threshold
        out: list[OcrResult] = []
        for (quad, _), (text, conf) in zip(boxes, texts):
            if self.spec.drop_rec_below_threshold and (not text or conf < thr):
                continue
            out.append(OcrResult(box=quad, text=text, confidence=conf))
        return out

    def _ensure_ready(self) -> None:
        if not self._initialized:
            raise RuntimeError("OcrManager.initialize() not called")
