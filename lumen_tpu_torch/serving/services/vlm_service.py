"""VLM gRPC service: ``vlm_generate`` + ``vlm_generate_stream``.

The port of ``lumen_tpu/serving/services/vlm_service.py`` (task surface of
the reference ``GeneralFastVLMService``,
``packages/lumen-vlm/src/lumen_vlm/fastvlm/fastvlm_service.py:47-621``):
chat messages ride as JSON in request ``meta``, the image is the payload,
generation knobs are meta fields, and ``vlm_generate_stream`` emits true
incremental ``InferResponse`` chunks through ``BaseService``'s streaming
path. The manager is the port's ``VLMManager`` (the paged continuous
engine, or the coalescing scheduler with ``scheduler: coalesce``), on the
device the server hands ``from_config``. ``handle_kv_put`` is the
disaggregated-decode sink the server attaches on peer-aware boots: it
admits a row a prefill host migrated, in the JAX package's wire format,
whichever package sent it.
"""

from __future__ import annotations

import json
import logging
import os

from ...core.config import ServiceConfig
from ...core.result_schemas import TextGenerationV1
from ...models.vlm import ChatMessage, VLMManager
from ...runtime.rknn import require_executable_runtime
from ...utils.metrics import metrics
from ...utils.qos import service_extra as qos_service_extra
from ..base_service import BaseService, InvalidArgument, _Assembly
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
            mesh_axes=bs.mesh.axes if bs.mesh else None,
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
        return self.manager.alive()

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

    # -- disaggregated decode: the fed_kv_put sink --------------------------

    def handle_kv_put(self, first, request_iterator, context):  # noqa: ARG002
        """Server half of the KV page-migration protocol, attached as
        ``HubRouter.kv_migration`` on decode-capable boots.

        Two ops share the reserved ``fed_kv_put`` task:

        - ``offer``: the prefill host ships the prompt's chain-key
          manifest; we answer how many LEADING pages our prefix cache
          already holds (advisory peek — the commit re-resolves
          authoritatively on the loop thread). Those pages migrate as
          references; only the missed suffix rides the commit.
        - ``commit``: chunked ``tensor/bundle`` frames carrying the
          sliced page payload + exact decode state. We rebuild the spill
          record, admit it via ``submit_migrated`` (zero re-prefill),
          relay the engine's token stream back as ``fed_kv: tok`` frames,
          and finish with a ``done`` frame. Every refusal is typed and
          in-band — the prefill host resumes from its own snapshot, so
          nothing here can lose a row.
        """
        from ...models.vlm import migration
        from ...runtime.federation import note_migration
        from ..proto import ml_service_pb2 as pb

        cid = first.correlation_id

        def refuse(code, message, detail="", marker="refused"):
            note_migration(in_rejected=1)
            metrics.count("fed_kv_in_rejected")
            return pb.InferResponse(
                correlation_id=cid,
                is_final=True,
                meta={"fed_kv": marker},
                error=pb.Error(code=code, message=message, detail=detail),
            )

        mgr = self.manager
        eng = mgr._pick_engine() if mgr._engines else None
        if eng is None:
            yield refuse(
                pb.ERROR_CODE_UNAVAILABLE,
                "this host runs no continuous-batching engine",
                "fed_kv_put needs the paged continuous scheduler "
                "(scheduler=continuous); the prefill host decodes locally",
            )
            return
        op = first.meta.get("op", "")
        if op == "offer":
            yield self._kv_offer_answer(eng, first, pb)
            return
        if op != "commit":
            yield refuse(
                pb.ERROR_CODE_INVALID_ARGUMENT,
                f"fed_kv_put op {op!r} unknown",
                "expected meta op=offer|commit",
            )
            return

        # Reassemble the chunked commit payload (same seq/total protocol
        # as any chunked upload).
        it = iter(request_iterator)
        asm = _Assembly()
        asm.add(first)
        while not asm.complete:
            nxt = next(it, None)
            if nxt is None:
                yield refuse(
                    pb.ERROR_CODE_INVALID_ARGUMENT,
                    f"fed_kv_put commit stream ended after "
                    f"{len(asm.chunks)} of {asm.total} chunk(s)",
                )
                return
            asm.add(nxt)
        blob = asm.payload()
        try:
            m = migration.parse_commit_meta(asm.meta)
            leaves = migration.unpack_payload(blob, m["crc"])
        except ValueError as e:
            yield refuse(pb.ERROR_CODE_INVALID_ARGUMENT, str(e))
            return
        try:
            req, rec = self._kv_build_row(eng, m, leaves, len(blob))
        except ValueError as e:
            yield refuse(pb.ERROR_CODE_INVALID_ARGUMENT, str(e))
            return
        try:
            eng.submit_migrated(
                req, rec, manifest=m["manifest"], n_shared=m["n_shared"]
            )
        except (ValueError, RuntimeError) as e:
            yield refuse(
                pb.ERROR_CODE_UNAVAILABLE,
                f"cannot admit migrated row: {e}",
                "the prefill host decodes locally",
            )
            return
        note_migration(in_commits=1, in_bytes=len(blob))
        metrics.count("fed_kv_in_commits")
        yield from self._kv_stream_tokens(req, cid, pb, refuse)

    @staticmethod
    def _kv_offer_answer(eng, first, pb):
        from ...models.vlm import migration

        try:
            keys = migration.manifest_from_csv(first.meta.get("manifest", ""))
        except ValueError:
            keys = []
        hit = 0
        if keys and eng.prefix is not None:
            try:
                # Advisory read off the loop thread (PrefixCache.peek is
                # mutation-free); any exception answers 0 — the prefill
                # host then ships full contents, which is always correct.
                hit = eng.prefix.peek(keys)
            except Exception:  # noqa: BLE001 - advisory only
                hit = 0
        return pb.InferResponse(
            correlation_id=first.correlation_id,
            is_final=True,
            meta={"fed_kv": "ok", "hit": str(hit)},
        )

    @staticmethod
    def _kv_build_row(eng, m: dict, leaves: list, nbytes: int):
        """Rebuild the engine-side request + spill record from validated
        commit meta and unpacked wire leaves. Raises ValueError (mapped to
        INVALID_ARGUMENT) on any layout mismatch with THIS host's model --
        a heterogeneous fleet must refuse loudly, not scatter garbage into
        the pool.

        The JAX sink rebuilds its record's tree structure from its pool;
        this one checks the same things against the port's pool: the page
        leaves (K and V of every layer, ``2 x layers``), the page size, the
        tensor count (page leaves + ``seen``, ``rng``, ``prompt_ids``) and
        the fresh page count of every page leaf. The wire's ``rng`` leaf
        (the JAX PRNG key, ``uint32[2]``) is not used: this engine draws
        every row's decode from its one ``torch.Generator``
        (``ContinuousScheduler._rng``), so a sampled row that migrates
        here goes on with this engine's draws, not the JAX key's. Greedy
        rows are token-identical."""
        import queue

        import numpy as np

        from ...models.vlm import migration
        from ...models.vlm.continuous import _Request, _SpillRecord

        n_page_leaves = 2 * len(eng.pool["caches"])
        if m["n_page_leaves"] != n_page_leaves:
            raise ValueError(
                f"page layout mismatch: peer ships {m['n_page_leaves']} "
                f"page leaves, this model has {n_page_leaves}"
            )
        if m["page_size"] != eng.page_size:
            raise ValueError(
                f"page size mismatch: peer uses {m['page_size']}, "
                f"this host uses {eng.page_size}"
            )
        if len(leaves) != n_page_leaves + 3:
            raise ValueError(
                f"commit payload carries {len(leaves)} tensors; expected "
                f"{n_page_leaves + 3} (page stacks..., seen, rng, prompt_ids)"
            )
        n_fresh = m["n_pages"] - m["n_shared"]
        for i in range(n_page_leaves):
            if int(leaves[i].shape[0]) != n_fresh:
                raise ValueError(
                    f"page leaf #{i} carries {int(leaves[i].shape[0])} "
                    f"page(s); commit declared {n_fresh}"
                )
        n_pad = 1
        while n_pad < max(1, n_fresh):
            n_pad *= 2
        padded = migration.pad_pages(leaves[: n_page_leaves + 1], n_page_leaves, n_pad)
        prompt_ids = np.asarray(leaves[-1])
        if prompt_ids.ndim != 2 or prompt_ids.shape[0] != 1:
            raise ValueError(f"prompt_ids must be [1, S]; got shape {prompt_ids.shape}")
        req = _Request(
            embeds=None,
            positions=None,
            length=None,
            prompt_ids=prompt_ids,
            n_prompt=m["prompt_len"],
            max_new=m["max_new"],
            temperature=m["temperature"],
            top_p=m["top_p"],
            do_sample=m["do_sample"],
            repetition_penalty=m["repetition_penalty"],
            stream_q=queue.SimpleQueue(),
        )
        rec = _SpillRecord(
            n_pages=n_fresh,
            n_pad=n_pad,
            nbytes=nbytes,
            crc=0,
            cur_tok=m["cur_tok"],
            cur_len=m["cur_len"],
            n_gen=m["n_gen"],
            prompt_len=m["prompt_len"],
            arrays=padded,
        )
        return req, rec

    @staticmethod
    def _kv_stream_tokens(req, cid: str, pb, refuse):
        """Relay the migrated row's token stream back to the prefill host
        as batched ``fed_kv: tok`` frames, finishing with ``done``
        (retired) or a typed refusal (admission lost a race / failed)."""
        import queue

        from ...models.vlm import migration
        from ...models.vlm.continuous import _STREAM_END

        seq = 0
        try:
            ended = False
            while not ended:
                tok = req.stream_q.get()
                if tok is _STREAM_END:
                    break
                batch = [int(tok)]
                while True:
                    try:
                        nxt = req.stream_q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _STREAM_END:
                        ended = True
                        break
                    batch.append(int(nxt))
                yield pb.InferResponse(
                    correlation_id=cid,
                    is_final=False,
                    seq=seq,
                    meta={"fed_kv": "tok", "toks": ",".join(map(str, batch))},
                )
                seq += 1
            try:
                _, n_gen, eos = req.future.result(timeout=30.0)
            except migration.ChunksMissing as e:
                # Offer/commit race (promised prefix pages evicted):
                # retryable — the prefill host re-commits full contents.
                yield refuse(
                    pb.ERROR_CODE_UNAVAILABLE, str(e),
                    "re-commit with full page contents",
                    marker="chunks_missing",
                )
                return
            except Exception as e:  # noqa: BLE001 - typed in-band, never a 500
                yield refuse(
                    pb.ERROR_CODE_UNAVAILABLE,
                    f"migrated row failed on this host: "
                    f"{type(e).__name__}: {e}",
                    "the prefill host resumes from its own snapshot",
                )
                return
            yield pb.InferResponse(
                correlation_id=cid,
                is_final=True,
                total=seq + 1,
                meta={
                    "fed_kv": "done",
                    "n_gen": str(int(n_gen)),
                    "eos": "1" if eos else "0",
                },
            )
        finally:
            # Prefill host gone mid-stream (client cancelled the RPC):
            # stop decoding a row nobody reads. Harmless after retirement.
            req.cancelled = True


def _reraise_value_errors(it):
    """Map manager ValueErrors (bad image, over-long prompt) to the wire
    INVALID_ARGUMENT code; ``BaseService._stream_out`` handles the rest."""
    try:
        yield from it
    except ValueError as e:
        raise InvalidArgument(f"cannot process request: {e}") from e
