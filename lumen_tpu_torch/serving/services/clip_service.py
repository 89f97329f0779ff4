"""CLIP gRPC service: embeddings + zero-shot classification tasks.

Covers all three reference service variants in one class, selected by which
model aliases the config carries (the reference picks the variant the same
way in its single-mode server, ``packages/lumen-clip/src/lumen_clip/server.py:240-287``):

- alias ``clip``    -> tasks ``clip_text_embed``, ``clip_image_embed``, and
  ``clip_classify`` / ``clip_scene_classify`` when a dataset is loaded
  (reference ``GeneralCLIPService``, ``clip_service.py:140-183``);
- alias ``bioclip`` -> ``bioclip_{text_embed,image_embed,classify}`` with
  raw-cosine scoring (reference ``BioCLIPService``);
- both aliases      -> additionally ``smartclip_{text_embed,image_embed,
  classify,scene_classify,bioclassify}`` (reference ``SmartCLIPService``,
  including the ``namespace=bioatlas`` meta check at
  ``smartclip_service.py:450-455``).

The port of ``lumen_tpu/serving/services/clip_service.py``: the same task
surface, ``tensor/raw`` input spec, capability ``extra`` keys and error
codes, over the port's ``CLIPManager`` on the device the server hands
``from_config``.
"""

from __future__ import annotations

import logging
import os

from ...core.config import ServiceConfig
from ...core.result_schemas import EmbeddingV1, LabelsV1, LabelItem
from ...models.clip import CLIPManager
from ...runtime.rknn import require_executable_runtime
from ...utils.qos import service_extra as qos_service_extra
from ...utils.tensorwire import TENSOR_MIME, TensorSpec, tensor_from_payload
from ..base_service import BaseService, InvalidArgument, Unavailable, first_meta_key
from ..registry import TaskDefinition, TaskRegistry

logger = logging.getLogger(__name__)

IMAGE_MIMES = ("image/jpeg", "image/png", "image/webp", "application/octet-stream")


class ClipService(BaseService):
    def __init__(self, managers: dict[str, CLIPManager], service_name: str = "clip"):
        self.managers = managers
        registry = TaskRegistry(service_name)
        clip = managers.get("clip")
        bioclip = managers.get("bioclip")
        if clip is not None:
            self._register_tasks(registry, "clip", clip, scene=True)
        if bioclip is not None:
            self._register_tasks(registry, "bioclip", bioclip, scene=False)
        if clip is not None and bioclip is not None:
            self._register_tasks(registry, "smartclip", clip, scene=True)
            registry.register(
                TaskDefinition(
                    name="smartclip_bioclassify",
                    handler=self._smart_bioclassify,
                    description="species classification (bioatlas namespace)",
                    input_mimes=IMAGE_MIMES,
                    output_mime=LabelsV1.mime(),
                )
            )
        super().__init__(registry)

    def _register_tasks(self, registry: TaskRegistry, prefix: str, mgr: CLIPManager, scene: bool):
        registry.register(
            TaskDefinition(
                name=f"{prefix}_text_embed",
                handler=lambda p, m, meta, _mgr=mgr: self._text_embed(_mgr, p),
                description="text -> unit-norm embedding",
                input_mimes=("text/plain",),
                output_mime=EmbeddingV1.mime(),
            )
        )
        registry.register(
            TaskDefinition(
                name=f"{prefix}_image_embed",
                handler=lambda p, m, meta, _mgr=mgr: self._image_embed(_mgr, p, m, meta),
                description="image -> unit-norm embedding",
                input_mimes=IMAGE_MIMES,
                output_mime=EmbeddingV1.mime(),
                # tensor/raw wire path: accept the exact pre-decoded
                # tensor the clip_resize decode spec produces — callers
                # holding decoded pixels skip JPEG AND the decode pool.
                tensor_spec=TensorSpec("uint8", mgr.tensor_input_shape()),
            )
        )
        if mgr.dataset_name:
            registry.register(
                TaskDefinition(
                    name=f"{prefix}_classify",
                    handler=lambda p, m, meta, _mgr=mgr: self._classify(_mgr, p, meta),
                    description="zero-shot classification against the configured dataset",
                    input_mimes=IMAGE_MIMES,
                    output_mime=LabelsV1.mime(),
                )
            )
        if scene:
            registry.register(
                TaskDefinition(
                    name=f"{prefix}_scene_classify",
                    handler=lambda p, m, meta, _mgr=mgr: self._scene(_mgr, p, meta),
                    description="coarse scene bucket classification",
                    input_mimes=IMAGE_MIMES,
                    output_mime=LabelsV1.mime(),
                )
            )

    # -- factory ----------------------------------------------------------

    @classmethod
    def expected_tasks(cls, service_config: ServiceConfig) -> list[str]:
        """Tasks this service would register for the given config — mirrors
        the alias/dataset selection in ``__init__`` so a degraded
        placeholder exposes the same routes the live service would."""
        by_key = {}
        for alias, mc in service_config.models.items():
            by_key["bioclip" if "bioclip" in alias.lower() else "clip"] = mc

        def tasks(prefix: str, mc, scene: bool) -> list[str]:
            out = [f"{prefix}_text_embed", f"{prefix}_image_embed"]
            if mc.dataset:
                out.append(f"{prefix}_classify")
            if scene:
                out.append(f"{prefix}_scene_classify")
            return out

        expected: list[str] = []
        if "clip" in by_key:
            expected += tasks("clip", by_key["clip"], scene=True)
        if "bioclip" in by_key:
            expected += tasks("bioclip", by_key["bioclip"], scene=False)
        if "clip" in by_key and "bioclip" in by_key:
            expected += tasks("smartclip", by_key["clip"], scene=True)
            expected.append("smartclip_bioclassify")
        return expected

    @classmethod
    def from_config(cls, service_config: ServiceConfig, cache_dir: str, device=None) -> "ClipService":
        bs = service_config.backend_settings
        managers: dict[str, CLIPManager] = {}
        for alias, mc in service_config.models.items():
            require_executable_runtime(mc)
            key = "bioclip" if "bioclip" in alias.lower() else "clip"
            model_dir = os.path.join(cache_dir, "models", mc.model.split("/")[-1])
            managers[key] = CLIPManager(
                model_dir,
                dataset=mc.dataset,
                dtype=bs.dtype,
                batch_size=bs.batch_size,
                max_batch_latency_ms=bs.max_batch_latency_ms,
                mesh_axes=bs.mesh.axes if bs.mesh else None,
                classify_mode="cosine" if key == "bioclip" else "softmax",
                warmup=bs.warmup,
                quantize=bs.quantize,
                # Scope batcher/gauge names per manager so a clip+bioclip
                # hub never collides on "clip-image" gauges or fleet keys.
                name_prefix=key,
                device=device,
            )
        svc = cls(managers)
        for mgr in managers.values():
            mgr.initialize()
        return svc

    def capability(self):
        ids = [m.model_id for m in self.managers.values()]
        # Routes reflect what initialize() actually chose — a manager that
        # opted into int8 but fell back to bf16 (warmup A/B showed a
        # regression) must not advertise int8.
        routes = sorted({getattr(m, "quant_route", "bf16") for m in self.managers.values()})
        precisions = ["bf16", "fp32"] + (["int8"] if "int8" in routes else [])
        # Device topology + replica layout (the primary manager's view):
        # fleet-internal clients pick endpoints from these keys instead of
        # probing — device_count, mesh_axes, replicas, replica_policy and
        # live replica_states.
        primary = next(iter(self.managers.values()))
        return self.registry.build_capability(
            model_ids=ids,
            runtime="torch-cuda" if primary.device.type == "cuda" else "torch-cpu",
            max_concurrency=max(m.batch_size for m in self.managers.values()),
            precisions=precisions,
            extra={
                "embed_dims": ",".join(str(m.cfg.embed_dim) for m in self.managers.values()),
                "quant_routes": ",".join(routes),
                "bulk_stream": "1",  # many-items-per-stream Infer lane
                # Multi-tenant QoS: WFQ admission state + brownout level
                # of this family's batchers (clip-image/clip-text, plus
                # bioclip-* when both aliases are loaded).
                "qos": qos_service_extra(*self.managers.keys()),
                **primary.topology(),
            },
        )

    def healthy(self) -> bool:
        return all(m.alive() for m in self.managers.values())

    def replica_states(self) -> dict:
        from ...runtime.fleet import replica_states_of

        return replica_states_of(
            *(b for m in self.managers.values()
              for b in (m._image_batcher, m._text_batcher))
        )

    def close(self) -> None:
        for m in self.managers.values():
            m.close()

    # -- handlers ---------------------------------------------------------

    def _text_embed(self, mgr: CLIPManager, payload: bytes):
        try:
            text = payload.decode("utf-8").strip()
        except UnicodeDecodeError as e:
            raise InvalidArgument("payload is not valid UTF-8 text") from e
        if not text:
            raise InvalidArgument("empty text payload")
        vec = mgr.encode_text(text)
        return self._embedding_result(mgr, vec)

    def _image_embed(
        self, mgr: CLIPManager, payload: bytes, mime: str = "",
        meta: dict[str, str] | None = None,
    ):
        if mime == TENSOR_MIME:
            # Pre-validated by the base class against this task's
            # tensor_spec: materialize with one np.frombuffer and go
            # straight to the batcher — the decode pool is never entered.
            try:
                vec = mgr.encode_image_tensor(
                    tensor_from_payload(payload, meta or {}), raw=payload
                )
            except ValueError as e:
                raise InvalidArgument(f"cannot process tensor: {e}") from e
            return self._embedding_result(mgr, vec)
        vec = self._encode_image(mgr, payload)
        return self._embedding_result(mgr, vec)

    def _classify(self, mgr: CLIPManager, payload: bytes, meta: dict[str, str]):
        top_k = _top_k(meta, 5)
        try:
            result = mgr.classify_image(payload, top_k=top_k)
        except RuntimeError as e:
            raise Unavailable(str(e)) from e
        except ValueError as e:
            raise InvalidArgument(f"cannot process image: {e}") from e
        return self._labels_result(mgr, result)

    def _scene(self, mgr: CLIPManager, payload: bytes, meta: dict[str, str]):
        try:
            result = mgr.classify_scene(payload, top_k=_top_k(meta, 3))
        except ValueError as e:
            raise InvalidArgument(f"cannot process image: {e}") from e
        return self._labels_result(mgr, result)

    def _smart_bioclassify(self, payload: bytes, mime: str, meta: dict[str, str]):
        ns = meta.get("namespace", "bioatlas")
        if ns != "bioatlas":
            raise InvalidArgument(f"unsupported namespace {ns!r} (expected 'bioatlas')")
        mgr = self.managers["bioclip"]
        top_k = _top_k(meta, 5)
        try:
            result = mgr.classify_image(payload, top_k=top_k)
        except ValueError as e:
            raise InvalidArgument(f"cannot process image: {e}") from e
        return self._labels_result(mgr, result)

    def _encode_image(self, mgr: CLIPManager, payload: bytes):
        if not payload:
            raise InvalidArgument("empty image payload")
        try:
            return mgr.encode_image(payload)
        except ValueError as e:
            raise InvalidArgument(f"cannot process image: {e}") from e

    @staticmethod
    def _embedding_result(mgr: CLIPManager, vec):
        body = EmbeddingV1(vector=[float(x) for x in vec], dim=int(vec.shape[0]), model_id=mgr.model_id)
        return body.to_json_bytes(), EmbeddingV1.mime(), {}

    @staticmethod
    def _labels_result(mgr: CLIPManager, result):
        body = LabelsV1(
            labels=[LabelItem(label=l, score=s) for l, s in result.labels],
            model_id=mgr.model_id,
        )
        return body.to_json_bytes(), LabelsV1.mime(), {}


def _int_meta(meta: dict[str, str], key: str, default: int) -> int:
    try:
        return int(meta.get(key, default))
    except ValueError as e:
        raise InvalidArgument(f"meta {key!r} must be an integer") from e


def _top_k(meta: dict[str, str], default: int) -> int:
    """Accept our ``top_k`` and the reference client's ``topk``
    (``clip_service.py:317``) so drop-in clients keep their knob."""
    key = first_meta_key(meta, "top_k", "topk")
    return _int_meta(meta, key, default) if key else default

