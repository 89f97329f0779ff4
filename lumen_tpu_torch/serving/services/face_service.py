"""Face gRPC service: detect / embed / detect-and-embed tasks.

Task surface and meta knobs mirror the reference ``GeneralFaceService``
(``packages/lumen-face/src/lumen_face/general_face/face_service.py:214-590``):
``face_detect`` (conf_threshold, size_min/max, max_faces; the NMS
threshold is a pack-spec constant baked into the compiled program),
``face_embed`` (optional ``landmarks`` JSON in meta), and
``face_detect_and_embed``.

The port of ``lumen_tpu/serving/services/face_service.py``: the same task
surface, ``tensor/raw`` input spec, capability ``extra`` keys and error
codes, over the port's ``FaceManager`` on the device the server hands
``from_config``.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from ...core.config import ServiceConfig
from ...core.result_schemas import FaceItem, FaceV1
from ...models.face import FaceManager
from ...runtime.rknn import require_executable_runtime
from ...utils.qos import service_extra as qos_service_extra
from ...utils.tensorwire import TENSOR_MIME, TensorSpec, tensor_from_payload
from ..base_service import BaseService, InvalidArgument, first_meta_key
from ..registry import TaskDefinition, TaskRegistry

logger = logging.getLogger(__name__)

IMAGE_MIMES = ("image/jpeg", "image/png", "image/webp", "application/octet-stream")

#: tensor/raw input for the detection tasks: any pre-decoded uint8 HWC RGB
#: image (coordinates come back in the tensor's own frame).
FACE_TENSOR_SPEC = TensorSpec("uint8", (None, None, 3))


class FaceService(BaseService):
    def __init__(self, manager: FaceManager, service_name: str = "face"):
        self.manager = manager
        registry = TaskRegistry(service_name)
        registry.register(
            TaskDefinition(
                name="face_detect",
                handler=self._detect,
                description="detect faces: bboxes + landmarks + confidences",
                input_mimes=IMAGE_MIMES,
                output_mime=FaceV1.mime(),
                tensor_spec=FACE_TENSOR_SPEC,
            )
        )
        registry.register(
            TaskDefinition(
                name="face_embed",
                handler=self._embed,
                description="embed one face crop (optional landmarks meta)",
                input_mimes=IMAGE_MIMES,
                output_mime=FaceV1.mime(),
            )
        )
        registry.register(
            TaskDefinition(
                name="face_detect_and_embed",
                handler=self._detect_and_embed,
                description="detect all faces and embed each",
                input_mimes=IMAGE_MIMES,
                output_mime=FaceV1.mime(),
                tensor_spec=FACE_TENSOR_SPEC,
            )
        )
        super().__init__(registry)

    @classmethod
    def expected_tasks(cls, service_config: ServiceConfig) -> list[str]:  # noqa: ARG003
        """Tasks this service would register — used by the hub to build a
        degraded placeholder when the real load fails, so the routes answer
        UNAVAILABLE instead of vanishing."""
        return ["face_detect", "face_embed", "face_detect_and_embed"]

    @classmethod
    def from_config(cls, service_config: ServiceConfig, cache_dir: str, device=None) -> "FaceService":
        bs = service_config.backend_settings
        alias, mc = next(iter(service_config.models.items()))
        require_executable_runtime(mc)
        model_dir = os.path.join(cache_dir, "models", mc.model.split("/")[-1])
        manager = FaceManager(
            model_dir,
            dtype=bs.dtype,
            batch_size=bs.batch_size,
            max_batch_latency_ms=bs.max_batch_latency_ms,
            mesh_axes=bs.mesh.axes if bs.mesh else None,
            warmup=bs.warmup,
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
                "det_size": str(self.manager.det_cfg.input_size),
                "embedding_dim": str(self.manager.rec_cfg.embed_dim),
                "bulk_stream": "1",  # many-items-per-stream Infer lane
                # Multi-tenant QoS: WFQ admission state + brownout level
                # of the face-det/face-rec admission queues.
                "qos": qos_service_extra("face"),
                # device topology + replica layout (fleet-internal clients
                # pick endpoints from these instead of probing)
                **self.manager.topology(),
            },
        )

    def healthy(self) -> bool:
        return self.manager._initialized

    def replica_states(self) -> dict:
        from ...runtime.fleet import replica_states_of

        # getattr: the batchers only exist after manager.initialize(), and
        # Health may probe the construct-before-initialize window.
        return replica_states_of(
            getattr(self.manager, "_det_batcher", None),
            getattr(self.manager, "_rec_batcher", None),
        )

    def close(self) -> None:
        self.manager.close()

    # -- handlers ---------------------------------------------------------

    def _det_kwargs(self, meta: dict[str, str]) -> dict:
        kw = {}
        # First alias per arg is ours; the rest are the reference client's
        # exact key names (``general_face/face_service.py:439-443``) so a
        # drop-in client's knobs aren't silently ignored.
        for arg, aliases in (
            ("conf_threshold", ("conf_threshold", "detection_confidence_threshold")),
            ("size_min", ("size_min", "face_size_min")),
            ("size_max", ("size_max", "face_size_max")),
            ("nms_threshold", ("nms_threshold",)),
        ):
            meta_key = first_meta_key(meta, *aliases)
            if meta_key is not None:
                kw[arg] = _float_meta(meta, meta_key)
        if "max_faces" in meta:
            try:
                kw["max_faces"] = int(meta["max_faces"])
            except ValueError as e:
                raise InvalidArgument("meta max_faces must be an integer") from e
        return kw

    def _detect(self, payload: bytes, mime: str, meta: dict[str, str]):
        if mime == TENSOR_MIME:
            # Base class already validated against FACE_TENSOR_SPEC:
            # materialize and go straight to letterbox + detector — no
            # decode pool on this path.
            pixels = tensor_from_payload(payload, meta)
            faces = self._call(
                lambda: self.manager.detect_faces_tensor(
                    pixels, raw=payload, **self._det_kwargs(meta)
                )
            )
            return self._result(faces)
        faces = self._call(lambda: self.manager.detect_faces(payload, **self._det_kwargs(meta)))
        return self._result(faces)

    def _embed(self, payload: bytes, mime: str, meta: dict[str, str]):
        landmarks = None
        if "landmarks" in meta:
            try:
                landmarks = np.asarray(json.loads(meta["landmarks"]), np.float32)
                # Contract allows 5-point OR 68-point landmarks (reference
                # ``backends/base.py:91-103``); 68-point sets reduce to the
                # canonical 5 in the manager.
                if landmarks.shape not in ((5, 2), (68, 2)):
                    raise ValueError(f"expected [5,2] or [68,2], got {landmarks.shape}")
            except (ValueError, json.JSONDecodeError) as e:
                raise InvalidArgument(f"invalid landmarks meta: {e}") from e
        emb = self._call(lambda: self.manager.extract_embedding(payload, landmarks))
        face = FaceItem(
            bbox=[0.0, 0.0, 0.0, 0.0],
            confidence=1.0,
            landmarks=landmarks.tolist() if landmarks is not None else None,
            embedding=[float(x) for x in emb],
        )
        return self._result_items([face])

    def _detect_and_embed(self, payload: bytes, mime: str, meta: dict[str, str]):
        if mime == TENSOR_MIME:
            pixels = tensor_from_payload(payload, meta)
            faces = self._call(
                lambda: self.manager.detect_and_extract_tensor(
                    pixels, raw=payload, **self._det_kwargs(meta)
                )
            )
            return self._result(faces)
        faces = self._call(
            lambda: self.manager.detect_and_extract(payload, **self._det_kwargs(meta))
        )
        return self._result(faces)

    def _call(self, fn):
        try:
            return fn()
        except ValueError as e:
            raise InvalidArgument(f"cannot process image: {e}") from e

    def _result(self, faces):
        items = [
            FaceItem(
                bbox=[float(v) for v in f.bbox],
                confidence=min(max(f.confidence, 0.0), 1.0),
                landmarks=f.landmarks.tolist() if f.landmarks is not None else None,
                embedding=[float(x) for x in f.embedding] if f.embedding is not None else None,
            )
            for f in faces
        ]
        return self._result_items(items)

    def _result_items(self, items):
        body = FaceV1(faces=items, count=len(items), model_id=self.manager.model_id)
        return body.to_json_bytes(), FaceV1.mime(), {}


def _float_meta(meta: dict[str, str], key: str) -> float:
    try:
        return float(meta[key])
    except ValueError as e:
        raise InvalidArgument(f"meta {key!r} must be a number") from e
