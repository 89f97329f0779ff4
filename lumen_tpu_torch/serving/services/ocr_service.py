"""OCR gRPC service: single ``ocr`` task.

Task surface and meta knobs mirror the reference ``GeneralOcrService``
(``packages/lumen-ocr/src/lumen_ocr/general_ocr/ocr_service.py:239-276``):
meta ``det_thresh``, ``rec_thresh``, ``box_thresh``, ``unclip_ratio``,
``use_angle_cls``.

The port of ``lumen_tpu/serving/services/ocr_service.py``: the same task,
meta aliases, ``tensor/raw`` input spec, capability ``extra`` keys and
error codes, over the port's ``OcrManager`` on the device the server
hands ``from_config``.
"""

from __future__ import annotations

import logging
import os

from ...core.config import ServiceConfig
from ...core.result_schemas import OcrItem, OCRV1
from ...models.ocr import OcrManager
from ...runtime.rknn import require_executable_runtime
from ...utils.qos import service_extra as qos_service_extra
from ...utils.tensorwire import TENSOR_MIME, TensorSpec, tensor_from_payload
from ..base_service import BaseService, InvalidArgument, first_meta_key
from ..registry import TaskDefinition, TaskRegistry

logger = logging.getLogger(__name__)

IMAGE_MIMES = ("image/jpeg", "image/png", "image/webp", "application/octet-stream")


class OcrService(BaseService):
    def __init__(self, manager: OcrManager, service_name: str = "ocr"):
        self.manager = manager
        registry = TaskRegistry(service_name)
        registry.register(
            TaskDefinition(
                name="ocr",
                handler=self._ocr,
                description="detect and recognize text: boxes + strings + confidences",
                input_mimes=IMAGE_MIMES,
                output_mime=OCRV1.mime(),
                # tensor/raw wire path: any pre-decoded uint8 HWC RGB page.
                tensor_spec=TensorSpec("uint8", (None, None, 3)),
            )
        )
        super().__init__(registry)

    @classmethod
    def expected_tasks(cls, service_config: ServiceConfig) -> list[str]:  # noqa: ARG003
        """Tasks this service would register (degraded-placeholder routes)."""
        return ["ocr"]

    @classmethod
    def from_config(cls, service_config: ServiceConfig, cache_dir: str, device=None) -> "OcrService":
        bs = service_config.backend_settings
        alias, mc = next(iter(service_config.models.items()))
        require_executable_runtime(mc)
        model_dir = os.path.join(cache_dir, "models", mc.model.split("/")[-1])
        manager = OcrManager(
            model_dir,
            dtype=bs.dtype,
            batch_size=bs.batch_size,
            warmup=bs.warmup,
            det_buckets=tuple(bs.batch_buckets) if bs.batch_buckets else None,
            device=device,
        )
        manager.initialize()
        return cls(manager)

    def capability(self):
        return self.registry.build_capability(
            model_ids=[self.manager.model_id],
            runtime="torch-cuda" if self.manager.device.type == "cuda" else "torch-cpu",
            max_concurrency=self.manager.batch_size,
            precisions=["bf16", "fp32"],
            extra={
                "det_buckets": ",".join(str(b) for b in self.manager.spec.det_buckets),
                "rec_height": str(self.manager.rec_cfg.height),
                "vocab_size": str(len(self.manager.vocab)),
                "bulk_stream": "1",  # many-items-per-stream Infer lane
                # Multi-tenant QoS: OCR has no MicroBatcher (ragged
                # det/rec shapes), so this reports the quota/lane config
                # only — no per-queue brownout entry.
                "qos": qos_service_extra("ocr"),
                **self.manager.topology(),
            },
        )

    def healthy(self) -> bool:
        return self.manager._initialized

    def close(self) -> None:
        self.manager.close()

    # -- handler ----------------------------------------------------------

    def _ocr(self, payload: bytes, mime: str, meta: dict[str, str]):
        kw = {}
        # First alias per arg is ours; the rest are the reference client's
        # exact key names (``general_ocr/ocr_service.py:244-250``) so a
        # drop-in client's knobs aren't silently ignored.
        for arg, aliases in (
            ("det_threshold", ("det_thresh", "detection_threshold")),
            ("rec_threshold", ("rec_thresh", "recognition_threshold")),
            ("box_threshold", ("box_thresh", "ocr.box_thresh")),
            ("unclip_ratio", ("unclip_ratio", "ocr.unclip_ratio")),
        ):
            meta_key = first_meta_key(meta, *aliases)
            if meta_key is not None:
                try:
                    kw[arg] = float(meta[meta_key])
                except ValueError as e:
                    raise InvalidArgument(f"meta {meta_key!r} must be a number") from e
        # Textline-orientation knob from the reference's wire contract
        # (``lumen_ocr/backends/base.py:63-136``): boolean meta flag.
        cls_key = first_meta_key(meta, "use_angle_cls", "ocr.use_angle_cls")
        if cls_key is not None:
            val = meta[cls_key].strip().lower()
            if val in ("1", "true", "yes", "on"):
                kw["use_angle_cls"] = True
            elif val in ("0", "false", "no", "off", ""):
                kw["use_angle_cls"] = False
            else:
                # Same loud-failure policy as the numeric knobs above: a
                # typo'd flag must not silently serve reversed text.
                raise InvalidArgument(
                    f"meta {cls_key!r} must be a boolean (got {meta[cls_key]!r})"
                )
        try:
            if mime == TENSOR_MIME:
                # Pre-validated tensor payload: full pipeline with zero
                # decode-pool hops.
                results = self.manager.predict_tensor(
                    tensor_from_payload(payload, meta), raw=payload, **kw
                )
            else:
                results = self.manager.predict(payload, **kw)
        except ValueError as e:
            raise InvalidArgument(f"cannot process image: {e}") from e
        items = [
            OcrItem(
                box=[[float(x), float(y)] for x, y in r.box],
                text=r.text,
                confidence=min(max(r.confidence, 0.0), 1.0),
            )
            for r in results
        ]
        body = OCRV1(items=items, count=len(items), model_id=self.manager.model_id)
        return body.to_json_bytes(), OCRV1.mime(), {}
