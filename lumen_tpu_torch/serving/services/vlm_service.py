"""VLM gRPC service: ``vlm_generate`` + ``vlm_generate_stream``.

The port of ``lumen_tpu/serving/services/vlm_service.py`` (task surface of
the reference ``GeneralFastVLMService``,
``packages/lumen-vlm/src/lumen_vlm/fastvlm/fastvlm_service.py:47-621``):
chat messages ride as JSON in request ``meta``, the image is the payload,
generation knobs are meta fields, and ``vlm_generate_stream`` emits true
incremental ``InferResponse`` chunks through ``BaseService``'s streaming
path. The manager is the port's ``VLMManager`` (the paged continuous
engine, or the coalescing scheduler with ``scheduler: coalesce``), on the
device the server hands ``from_config``. Not ported yet:
the disaggregated-decode sink (``handle_kv_put`` and its ``_kv_*``
helpers).
"""

from __future__ import annotations

import json
import logging
import os

from ...core.config import ServiceConfig
from ...core.result_schemas import TextGenerationV1
from ...models.vlm import ChatMessage, VLMManager
from ...runtime.rknn import require_executable_runtime
from ...utils.qos import service_extra as qos_service_extra
from ..base_service import BaseService, InvalidArgument
from ..registry import TaskDefinition, TaskRegistry
from ..router import advertised_fed_role

logger = logging.getLogger(__name__)

IMAGE_MIMES = ("image/jpeg", "image/png", "image/webp", "application/octet-stream")


class VlmService(BaseService):
    def __init__(self, manager: VLMManager, service_name: str = "vlm"):
        self.manager = manager
        registry = TaskRegistry(service_name)
        registry.register(
            TaskDefinition(
                name="vlm_generate",
                handler=self._generate,
                description="multimodal caption/chat generation (single response)",
                input_mimes=IMAGE_MIMES,
                output_mime=TextGenerationV1.mime(),
            )
        )
        registry.register(
            TaskDefinition(
                name="vlm_generate_stream",
                handler=self._generate_stream,
                description="multimodal generation with incremental streaming chunks",
                input_mimes=IMAGE_MIMES,
                output_mime=TextGenerationV1.mime(),
            )
        )
        super().__init__(registry)

    @classmethod
    def expected_tasks(cls, service_config: ServiceConfig) -> list[str]:  # noqa: ARG003
        """Tasks this service would register (degraded-placeholder routes)."""
        return ["vlm_generate", "vlm_generate_stream"]

    @classmethod
    def from_config(cls, service_config: ServiceConfig, cache_dir: str, device=None) -> "VlmService":
        bs = service_config.backend_settings
        alias, mc = next(iter(service_config.models.items()))
        require_executable_runtime(mc)
        model_dir = os.path.join(cache_dir, "models", mc.model.split("/")[-1])
        kw = {}
        if bs.batch_buckets:
            kw["prefill_buckets"] = tuple(bs.batch_buckets)
        # batch_size is the decode batch: the continuous engine's slot
        # count, the coalescer's batch and stream bound. Configs sized for a
        # CLIP-style image batch (e.g. 256) are clamped to a sane decode
        # width instead of allocating hundreds of slots.
        gen_batch = max(1, min(bs.batch_size, 16))
        if gen_batch != bs.batch_size:
            logger.warning(
                "vlm batch_size %d clamped to %d (decode batch)", bs.batch_size, gen_batch
            )
        manager = VLMManager.from_model_dir(
            model_dir,
            device=device,
            dtype=bs.dtype,
            warmup=bs.warmup,
            gen_batch_size=gen_batch,
            gen_batch_latency_ms=bs.max_batch_latency_ms,
            scheduler=bs.scheduler,
            gen_slots=gen_batch,  # pool width = configured decode batch
            gen_block=bs.decode_block,
            quantize=bs.quantize,
            **kw,
        )
        return cls(manager)

    def capability(self):
        runtime = "torch-cuda" if self.manager.device.type == "cuda" else "torch-cpu"
        return self.registry.build_capability(
            model_ids=[self.manager.model_id],
            runtime=runtime,
            max_concurrency=self.manager.max_concurrency,
            precisions=["bf16", "fp32"]
            + (["int8"] if self.manager.quant_route == "int8" else []),
            extra={
                "max_new_cap": str(self.manager.max_new_cap),
                "max_seq": str(self.manager.max_seq),
                "vision_tokens": str(self.manager.vision_tokens),
                "vocab_size": str(self.manager.cfg.decoder.vocab_size),
                "bulk_stream": "1",  # many-items-per-stream Infer lane
                "qos": qos_service_extra("vlm"),
                "quant_route": self.manager.quant_route,
                "scheduler": self.manager.scheduler,
                "kv_layout": self.manager.kv_layout(),
                **self.manager.topology(),
                # Disaggregation lane only when configured.
                **({"fed_role": r} if (r := advertised_fed_role()) else {}),
            },
        )

    def healthy(self) -> bool:
        return self.manager._initialized

    def close(self) -> None:
        self.manager.close()

    # -- request parsing ---------------------------------------------------

    def _parse_request(self, payload: bytes, meta: dict[str, str]):
        raw = meta.get("messages")
        if not raw:
            raise InvalidArgument("meta 'messages' (JSON list of {role, content}) is required")
        try:
            entries = json.loads(raw)
        except json.JSONDecodeError as e:
            raise InvalidArgument(f"meta 'messages' is not valid JSON: {e}") from e
        if not isinstance(entries, list) or not entries:
            raise InvalidArgument("meta 'messages' must be a non-empty JSON list")
        messages = []
        for entry in entries:
            if not isinstance(entry, dict) or "role" not in entry or "content" not in entry:
                raise InvalidArgument("each message needs 'role' and 'content'")
            messages.append(ChatMessage(role=str(entry["role"]), content=str(entry["content"])))

        kw = {}
        for key, cast in (
            ("max_new_tokens", int),
            ("temperature", float),
            ("top_p", float),
            ("repetition_penalty", float),
        ):
            if key in meta:
                try:
                    kw[key] = cast(meta[key])
                except ValueError as e:
                    raise InvalidArgument(f"meta {key!r} must be a {cast.__name__}") from e
        if "do_sample" in meta:
            kw["do_sample"] = meta["do_sample"].lower() in ("1", "true", "yes")
        if "add_generation_prompt" in meta:
            # Reference knob (``fastvlm_service.py:398``): render the chat
            # template without the trailing assistant turn when false.
            kw["add_generation_prompt"] = meta["add_generation_prompt"].lower() in ("1", "true", "yes")
        if "stop_sequences" in meta:
            try:
                stops = json.loads(meta["stop_sequences"])
            except json.JSONDecodeError:
                stops = [meta["stop_sequences"]]
            if not isinstance(stops, list):
                stops = [str(stops)]
            kw["stop_sequences"] = [str(s) for s in stops]
        return messages, payload or None, kw

    # -- handlers ----------------------------------------------------------

    def _generate(self, payload: bytes, mime: str, meta: dict[str, str]):
        messages, image, kw = self._parse_request(payload, meta)
        try:
            result = self.manager.generate(messages, image_bytes=image, **kw)
        except ValueError as e:
            # bad image bytes / over-long prompt -> client error, not INTERNAL
            raise InvalidArgument(f"cannot process request: {e}") from e
        body = TextGenerationV1(
            text=result.text,
            finish_reason=result.finish_reason,
            generated_tokens=len(result.tokens),
            input_tokens=result.input_tokens,
            model_id=self.manager.model_id,
            metadata=result.metadata,
        )
        return body.to_json_bytes(), TextGenerationV1.mime(), {}

    def _generate_stream(self, payload: bytes, mime: str, meta: dict[str, str]):
        messages, image, kw = self._parse_request(payload, meta)

        def chunks():
            pieces: list[str] = []
            n_chunks = 0
            stream = _reraise_value_errors(
                self.manager.generate_stream(messages, image_bytes=image, **kw)
            )
            for chunk in stream:
                if chunk.is_final:
                    body = TextGenerationV1(
                        text="".join(pieces),
                        finish_reason=str(chunk.metadata.get("finish_reason", "stop")),
                        generated_tokens=int(chunk.metadata.get("generated_tokens", 0)),
                        input_tokens=int(chunk.metadata.get("input_tokens", 0)),
                        model_id=self.manager.model_id,
                        metadata={**chunk.metadata, "streaming_chunks": n_chunks},
                    )
                    yield body.to_json_bytes(), TextGenerationV1.mime(), {}
                else:
                    pieces.append(chunk.text)
                    n_chunks += 1
                    yield (
                        chunk.text.encode("utf-8"),
                        "text/plain; charset=utf-8",
                        {"chunk": "delta"},
                    )

        return chunks()


def _reraise_value_errors(it):
    """Map manager ValueErrors (bad image, over-long prompt) to the wire
    INVALID_ARGUMENT code; ``BaseService._stream_out`` handles the rest."""
    try:
        yield from it
    except ValueError as e:
        raise InvalidArgument(f"cannot process request: {e}") from e
