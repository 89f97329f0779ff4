"""The concrete photo-indexing ingest pipeline: CLIP + face + OCR (+ VLM).

The port of ``lumen_tpu/pipeline/photo.py``: the per-family managers of
the port composed into :class:`~.ingest.IngestPipeline` stages. Each
stage's dense forward (CLIP vision tower, face detector, OCR detector)
runs as ONE device call per batch on each data place of the mesh, through
the managers' own hooks (``_encode_images``, ``_run_detector``) and each
place's copy of the weights; the irregular tails (face-crop embedding,
OCR crop recognition, VLM captions) run through the managers' own
batchers and engine (``embed_detections``, ``recognize_boxes``,
``generate``). A manager without a mesh (OCR; a VLM without one) runs on
its own device, which must be place 0's: the OCR stage's parts go there.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

import numpy as np

from ..ops.image import decode_image_bytes, decode_image_bytes_scaled, letterbox_numpy
from ..runtime.batcher import bucket_for
from .ingest import IngestPipeline, Stage

logger = logging.getLogger(__name__)


@dataclass
class PhotoRecord:
    index: int
    clip_embedding: np.ndarray | None = None
    labels: list[tuple[str, float]] = field(default_factory=list)
    faces: list = field(default_factory=list)  # models.face.FaceDetection
    ocr: list = field(default_factory=list)  # models.ocr.OcrResult
    caption: str | None = None
    error: str | None = None  # decode failure (on_decode_error="record")
    # Content fingerprint of the RAW input bytes (None for non-bytes
    # items): stable across decode policy and model versions — the dedupe
    # primitive, and the natural vector id for the search index.
    sha256: str | None = None


def _data_places(mesh) -> list[str]:
    """A mesh's data places as the pipeline's check compares them: each
    place's device, and on a serving group the place's index in it."""
    places = getattr(mesh, "places", None)
    if not places:
        return [str(d) for d in mesh.data_devices]
    return [f"{d} (group place {p.index})" for d, p in zip(mesh.data_devices, places)]


class PhotoIngestPipeline:
    """Bulk photo indexing on a device mesh.

    Pass any subset of initialized managers; stages are built only for the
    families provided. ``items`` fed to :meth:`run` are raw image bytes (or
    anything ``decode_image_bytes`` accepts).
    """

    def __init__(
        self,
        mesh,
        clip=None,
        face=None,
        ocr=None,
        vlm=None,
        batch_size: int = 64,
        classify_top_k: int = 0,
        ocr_det_size: int | None = None,
        ocr_use_angle_cls: bool = False,
        caption: bool = False,
        caption_prompt: str = "Describe this photo in one sentence.",
        caption_max_tokens: int = 32,
        caption_workers: int = 4,
        prefetch: int = 2,
        inflight: int = 2,
        workers: int | None = None,
        on_decode_error: str = "raise",
        decode_max_edge: int | None = None,
        index: Any | None = None,
    ):
        if on_decode_error not in ("raise", "record"):
            raise ValueError("on_decode_error must be 'raise' or 'record'")
        # "record": a corrupt/undecodable image yields a PhotoRecord with
        # .error set instead of aborting the whole bulk run.
        self.on_decode_error = on_decode_error
        if clip is None and face is None and ocr is None:
            raise ValueError("need at least one of clip/face/ocr managers")
        if caption and vlm is None:
            raise ValueError("caption=True requires a vlm manager")
        for mgr in (clip, face, ocr, vlm):
            if mgr is not None:
                mgr._ensure_ready()  # stages reach into post-initialize state
        self.clip, self.face, self.ocr, self.vlm = clip, face, ocr, vlm
        self.ocr_det_size = ocr_det_size
        self.ocr_use_angle_cls = ocr_use_angle_cls
        # The per-request and ingest paths share ONE copy of each family's
        # weights a data place, and the managers' batchers keep placing
        # inputs on their OWN mesh, so the pipeline mesh must have the
        # identical data places, in order: the same devices, and on a
        # serving group the same places of the group. A manager without a
        # mesh (OCR; a VLM without one) runs its stage on its own device,
        # which must be place 0's; a stand-in with neither is not checked.
        places = _data_places(mesh)
        for name, mgr in (("clip", clip), ("face", face), ("ocr", ocr), ("vlm", vlm)):
            own = getattr(mgr, "mesh", None)
            if own is not None:
                mgr_devs, pipeline_devs = _data_places(own), places
            elif getattr(mgr, "device", None) is not None:
                mgr_devs, pipeline_devs = [str(mgr.device)], [str(d) for d in mesh.data_devices[:1]]
            else:
                continue
            if mgr_devs != pipeline_devs:
                raise ValueError(
                    f"{name} manager mesh devices {tuple(mgr_devs)} "
                    f"differ from pipeline mesh devices {tuple(pipeline_devs)}; "
                    "build the pipeline with the managers' mesh (or managers with the "
                    "pipeline's) so both paths share one device placement"
                )
        self.classify_top_k = classify_top_k
        self.caption = caption
        self.caption_prompt = caption_prompt
        self.caption_max_tokens = caption_max_tokens
        self.caption_workers = max(1, caption_workers)

        # Scaled decode target: the producer decodes oversized JPEGs at
        # reduced scale, never below the LARGEST consumer's input edge, so
        # every stage's resize/letterbox still only downscales. ``None`` =
        # auto (max over the configured stages); ``0`` disables (full
        # decode). Stage coordinates are mapped back to the ORIGINAL frame
        # via the per-item decode scale.
        if decode_max_edge is None:
            targets = []
            if clip is not None:
                targets.append(clip.cfg.image_size)
            if face is not None:
                targets.append(face.det_cfg.input_size)
            if ocr is not None:
                buckets = sorted(ocr.spec.det_buckets)
                targets.append(bucket_for(ocr_det_size or buckets[-1], buckets))
            decode_max_edge = max(targets)
        self.decode_max_edge = decode_max_edge

        stages = []
        if clip is not None:
            stages.append(self._clip_stage())
        if face is not None:
            stages.append(self._face_stage())
        if ocr is not None:
            stages.append(self._ocr_stage())
        # embed -> index as a CONFIGURED task-graph edge: a derived node
        # fed by the clip stage's record value plus the item's content
        # fingerprint. ``cache_output=False`` keeps the sink's verdict out
        # of the result cache AND re-fires it on cache hits, so a warm
        # re-ingest still (re)indexes every photo without touching the
        # decode pool or the device.
        if index is not None:
            if clip is None:
                raise ValueError("index= requires a clip manager (the embedding source)")
            if not callable(index):
                raise ValueError("index= must be a callable(sha256, clip_out)")

            def index_post(decoded, deps):
                clip_out = deps["clip"]
                if clip_out is None or clip_out.get("embedding") is None:
                    return None  # undecodable item: nothing to index
                return index(deps.get("_sha256"), clip_out)

            stages.append(Stage("index", postprocess=index_post, inputs=("clip", "_sha256"), cache_output=False))

        # Content-addressed re-ingest cache: the namespace pins every model
        # id@revision and its compute precision (the JAX package's dtype
        # names) in the stage set; the options pin every knob that changes
        # a record.
        def _sig(mgr) -> str:
            parts = [str(mgr.policy.compute_dtype).removeprefix("torch.")]
            route = getattr(mgr, "quant_route", None)
            if route:
                parts.append(route)
            return ":".join(parts)

        models = ",".join(
            f"{fam}={mgr.model_id}@{mgr.info.version}:{_sig(mgr)}"
            for fam, mgr in (("clip", clip), ("face", face), ("ocr", ocr))
            if mgr is not None
        )
        self.engine = IngestPipeline(
            mesh,
            stages,
            decode=self._decode,
            batch_size=batch_size,
            prefetch=prefetch,
            inflight=inflight,
            workers=workers,
            annotate=lambda d: {"_error": d["error"]} if "error" in d else {},
            cache_namespace=f"ingest/photo/{models}",
            cache_options={
                "classify_top_k": classify_top_k,
                "ocr_det_size": ocr_det_size,
                "ocr_use_angle_cls": ocr_use_angle_cls,
                # Decode resolution changes record numerics (resampling).
                "decode_max_edge": self.decode_max_edge,
            },
            # Process-parallel decode: the "photo" spec is _decode's
            # byte-path twin (utils.host_decode) — in process mode the
            # producer's JPEG decode runs in worker processes and pixels
            # land in shared-memory arena slots the batches stack from.
            decode_spec=("photo", {"max_edge": self.decode_max_edge or 0, "on_error": self.on_decode_error}),
            decode_adapter=self._adapt_decoded,
        )

    # -- decode -----------------------------------------------------------

    @staticmethod
    def _adapt_decoded(result) -> dict:
        """DecodedTensor from the "photo" spec -> the dict `_decode`
        produces (same keys, same error policy)."""
        dscale, oh, ow, err = result.extras
        if err is not None:
            return {"img": result.array, "meta": {}, "error": err}
        return {"img": result.array, "meta": {}, "decode_scale": dscale, "orig_hw": (oh, ow)}

    def _decode(self, item) -> dict:
        try:
            dscale, orig_hw = 1.0, None
            if isinstance(item, (bytes, bytearray)):
                if self.decode_max_edge:
                    img, dscale, orig_hw = decode_image_bytes_scaled(item, color="rgb", max_edge=self.decode_max_edge)
                else:
                    img = decode_image_bytes(item, color="rgb")
            else:
                img = np.asarray(item)
            if img.ndim != 3 or img.shape[2] != 3:
                raise ValueError(f"expected HWC RGB image, got shape {img.shape}")
        except ValueError as e:
            if self.on_decode_error == "raise":
                raise
            # Placeholder keeps batch shapes static; stages skip real work.
            return {"img": np.zeros((8, 8, 3), np.uint8), "meta": {}, "error": str(e)}
        return {
            "img": img,
            "meta": {},
            "decode_scale": dscale,
            "orig_hw": orig_hw if orig_hw is not None else img.shape[:2],
        }

    # -- stages -----------------------------------------------------------

    def _clip_stage(self) -> Stage:
        mgr = self.clip
        size = mgr.cfg.image_size

        def preprocess(decoded: dict) -> np.ndarray:
            import cv2

            return cv2.resize(decoded["img"], (size, size), interpolation=cv2.INTER_LINEAR)

        device_fns = [lambda pixels, _m=m: mgr._encode_images(_m, pixels) for m in mgr.place_models]

        def postprocess(decoded: dict, vec: np.ndarray):
            if "error" in decoded:
                return {"embedding": None}
            vec = mgr._check_vector(vec)
            out = {"embedding": vec}
            if self.classify_top_k > 0 and mgr._label_matrix is not None:
                res = mgr._classify_vector(vec, mgr.label_names, mgr._label_matrix, self.classify_top_k)
                out["labels"] = res.labels
            return out

        return Stage("clip", preprocess, device_fns, postprocess)

    def _face_stage(self) -> Stage:
        mgr = self.face
        det_size = mgr.det_cfg.input_size

        def preprocess(decoded: dict) -> np.ndarray:
            boxed, scale, pad_top, pad_left = letterbox_numpy(decoded["img"], det_size)
            # Fold the scaled-decode factor into the unmap scale so boxes
            # and landmarks come out in ORIGINAL image coordinates.
            dscale = decoded.get("decode_scale", 1.0)
            h, w = decoded.get("orig_hw", decoded["img"].shape[:2])
            decoded["meta"]["face"] = (scale * dscale, pad_top, pad_left, h, w)
            return boxed

        device_fns = [lambda images, _v=v: mgr._run_detector(_v, images) for v in mgr.det_places]

        def postprocess(decoded: dict, row):
            if "error" in decoded:
                return []
            boxes, kps, scores, keep = row
            scale, pad_top, pad_left, h, w = decoded["meta"]["face"]
            faces = mgr.detections_from_outputs(
                boxes, kps, scores, keep, scale=scale, pad_top=pad_top, pad_left=pad_left, image_hw=(h, w),
            )
            if faces:
                mgr.embed_detections(decoded["img"], faces, coord_scale=decoded.get("decode_scale", 1.0))
            return faces

        return Stage("face", preprocess, device_fns, postprocess)

    def _ocr_stage(self) -> Stage:
        mgr = self.ocr
        # One static det bucket for the whole ingest run (per-image bucket
        # choice would fragment the batch into ragged shapes). Defaults to
        # the LARGEST bucket so bulk ingest matches the per-request path's
        # quality on big photos.
        buckets = sorted(mgr.spec.det_buckets)
        det_size = bucket_for(self.ocr_det_size or buckets[-1], buckets)

        def preprocess(decoded: dict) -> np.ndarray:
            boxed, scale, pad_top, pad_left = letterbox_numpy(decoded["img"], det_size)
            decoded["meta"]["ocr"] = (scale, pad_top, pad_left)
            return boxed

        def device_fn(images):
            # every place's part, on the OCR manager's device (place 0's)
            return mgr._run_detector(mgr.det_vars, images.to(mgr.device, non_blocking=True))

        def postprocess(decoded: dict, prob):
            if "error" in decoded:
                return []
            scale, pad_top, pad_left = decoded["meta"]["ocr"]
            img = decoded["img"]
            found = mgr.boxes_from_det_output(
                np.asarray(prob), image_hw=img.shape[:2], scale=scale, pad_top=pad_top, pad_left=pad_left,
            )
            if not found:
                return []
            results = mgr.recognize_boxes(img, found, use_angle_cls=self.ocr_use_angle_cls)
            # Crops come from the (possibly scaled-)decoded frame; the
            # reported quads go back to ORIGINAL coordinates.
            dscale = decoded.get("decode_scale", 1.0)
            if dscale != 1.0:
                for r in results:
                    r.box = np.asarray(r.box, np.float32) / dscale
            return results

        return Stage("ocr", preprocess, device_fn, postprocess)

    # -- run --------------------------------------------------------------

    def run(self, items: Iterable[Any]) -> Iterator[PhotoRecord]:
        for raw in self.engine.run(items):
            rec = PhotoRecord(index=raw["_index"], error=raw.get("_error"), sha256=raw.get("_sha256"))
            if "clip" in raw and raw["clip"] is not None:
                rec.clip_embedding = raw["clip"]["embedding"]
                rec.labels = raw["clip"].get("labels", [])
            if "face" in raw:
                rec.faces = raw["face"]
            if "ocr" in raw:
                rec.ocr = raw["ocr"]
            yield rec

    def run_with_captions(self, items: list[bytes]) -> list[PhotoRecord]:
        """Caption path: generation is autoregressive and dominates cost,
        so it runs after the dense sweep."""
        records = list(self.run(items))
        return self.caption_records(records, items)

    def caption_records(self, records: list[PhotoRecord], items: list[bytes]) -> list[PhotoRecord]:
        """Caption already-swept records in place. One VLM failure records
        an error on that row instead of aborting a bulk run.

        The continuous engine multiplexes decode slots, so items fan out
        over ``caption_workers`` submitter threads (the engine's admission
        queue is the real backpressure), each tagged onto the BULK QoS
        lane so a captioning sweep browns out before interactive VLM
        traffic, never displacing it."""
        if not self.caption or self.vlm is None:
            return records
        from concurrent.futures import ThreadPoolExecutor

        from ..models.vlm.chat import ChatMessage
        from ..utils.qos import LANE_BULK, qos_context

        def caption_one(rec: PhotoRecord, payload: bytes) -> None:
            # contextvars don't cross thread starts: re-tag per task.
            with qos_context(None, LANE_BULK):
                try:
                    result = self.vlm.generate(
                        [ChatMessage(role="user", content=self.caption_prompt)],
                        image_bytes=payload,
                        max_new_tokens=self.caption_max_tokens,
                    )
                    rec.caption = result.text
                except Exception as e:  # noqa: BLE001 - record, don't abort
                    logger.warning("caption failed for item %d: %s", rec.index, e)
                    rec.error = f"caption failed: {e}"

        todo = [(rec, payload) for rec, payload in zip(records, items) if not rec.error]
        if not todo:
            return records
        if len(todo) == 1 or self.caption_workers == 1:
            for rec, payload in todo:
                caption_one(rec, payload)
            return records
        with ThreadPoolExecutor(
            max_workers=min(self.caption_workers, len(todo)), thread_name_prefix="caption"
        ) as pool:
            # Each record is touched by exactly ONE task; caption_one
            # contains every failure as a record error.
            list(pool.map(lambda rp: caption_one(*rp), todo))
        return records

    @property
    def stats(self):
        return self.engine.stats
