"""VLM manager: caption/chat generation (the Model Manager layer of
``lumen_tpu/models/vlm/manager.py``).

``VLMManager.from_model_dir`` loads a model directory as the JAX manager
does (``model_info.json``, ``config.json`` or the manifest's
``extra_metadata`` fallback, safetensors or torch checkpoints under
HF/FastVLM or native names, ``tokenizer.json`` and the chat template of
``tokenizer_config.json``, a ``vision*.onnx`` tower); the constructor
takes a configuration, a ``state_dict`` and a tokenizer object directly.
A request carries its image as encoded bytes (``image_bytes=``, decoded
and letterboxed by the decode pool's ``vlm_canvas`` spec) or as decoded
pixels (``pixels``). The manager renders and tokenizes the prompt, runs
the prepare step on the device (normalize -> vision tower -> token embed
-> image-token splice), and hands the request to its scheduler. Prompt
lengths are padded to buckets, as in the JAX package.

Two schedulers, as in the JAX manager (``scheduler=``, overridden by
``LUMEN_VLM_SCHEDULER``): ``continuous`` (the default) is one paged
continuous engine per replica slice (``plan_replicas("vlm")``, least
loaded first; more than one replica forms an ``EngineFleet``);
``coalesce`` batches concurrent same-shape requests into one fused decode
(``Generator.generate``) and streams through ``Generator.stream``.

The vision tower is the native ViT, or an exported graph on the ONNX
bridge (``graph.py``; ``vision_backend`` in ``model_info.json``'s
``extra_metadata``: ``auto``, ``graph`` or ``native``). ``quantize="int8"``
serves the decoder's projections int8 unless ``LUMEN_VLM_Q8_ROUTE``
(``auto``, ``int8``, ``bf16``) says otherwise: under ``auto`` with
``warmup`` a decode A/B, timed on the program the scheduler serves with
(the engine's ``step_block``, or the coalescer's fused decode), picks the
faster route and records its verdict next to the weights
(``.lumen_q8_verdict.json``, the JAX file, keyed by model revision alone).

Greedy ``generate`` calls go through the process's content-addressed
result cache (``runtime/result_cache.py``, ``LUMEN_CACHE_BYTES``, default
256 MiB) behind the quarantine gate, as in the JAX manager: a repeated
request is answered without the vision tower, prefill or decode, marked
``cached``. A manager built from a ``state_dict`` has no model revision
to key the cache on and computes every request; ``from_model_dir`` gives
it one. With ``LUMEN_VLM_PREFIX_BYTES`` set, each request carries its
prompt's content identity for the engine's prefix KV cache.

``mesh_axes`` with an ``expert`` or ``model`` axis above 1 serves the
model expert- and tensor-parallel on the process's rank-0/worker group of
``expert x model`` ranks (``runtime.tp_group``, started by ``serve()``):
:meth:`VLMManager._place_params` takes each rank's shards by the JAX
placement (``MOE_EP_RULES`` first on an expert axis, then the int8 TP
rules when quantized, then the TP rules), and every device program -- the
prepare step, the ``Generator``'s programs, the int8 route's A/B -- runs
on every rank. The host state (scheduler, page allocator, prefix cache,
spill tier) stays on rank 0. ``LUMEN_REPLICAS_VLM`` serves replicas of
such a group, one continuous engine a replica, each with its own copy of
the rank's shards on the first data place of its slice of the group's
places (``plan_replicas``); the least-loaded engine takes a request, and a
request prepared on place 0 crosses to its engine's place by value.
An exported vision tower (``graph.py``) runs on rank 0 alone, on the
device where requests are prepared (``device``, replica 0's place 0): its
float32 weights live there once and the workers hold none. Its output
goes by value into the splice program of every rank
(:func:`prepare_graph`: the token embed, with its width gather, and the
image-token splice). The JAX manager replicates the tower's weights over
every device of the mesh instead; the tokens are the same.

A ``data`` axis (the default mesh over every card, or ``mesh_axes``; or
a group's data places) has no batch axis to split here: the continuous
engine's slots live in one page pool. The JAX manager serves it with one
replicated copy and gets the same tokens; the port serves the one engine
on place 0 and places no copy on the other places, which would compute
nothing. ``LUMEN_REPLICAS_VLM=max`` serves one engine a place. A ``seq``
or ``stage`` axis above 1 adds positions to each place's block that hold
nothing (``runtime.mesh``): the JAX manager replicates the model over
them and computes the same tokens on every copy. Placement is not a
result.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
import weakref
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

from ...core.model_info import ModelInfo, load_model_info
from ...ops.quant import register_route_gauges, resolve_q8_kernel, resolve_q8_route
from ...ops.quant_matmul import note_mesh_model_axis
from ...parallel.sharding import INT8_TP_RULES, MOE_EP_RULES, TRANSFORMER_TP_RULES, local_state_dict
from ...runtime.decode_pool import get_decode_pool
from ...runtime.fleet import EngineFleet, batcher_name, fleet_devices, plan_replicas, replicas_for
from ...runtime.mesh import GROUP_AXES, build_mesh
from ...runtime.policy import get_policy, resolve_device
from ...runtime.quarantine import guarded_key
from ...runtime.tp_group import place_of, run_on
from ...runtime.result_cache import get_result_cache, make_namespace
from ...runtime.weights import load_state_dict
from ...utils import disagg
from ...utils.env import env_choice, env_int
from ...utils.host_decode import DECODE_POLICY
from ...utils.metrics import metrics
from .chat import ChatMessage, VlmTokenizer
from .continuous import ContinuousScheduler, _Request
from .convert import convert_vlm_checkpoint, quantize_decoder_int8
from .generate import Generator
from .graph import VisionGraph, find_vision_onnx
from .modeling import VLMConfig, VLMModel, merge_image_embeddings
from .paged_kv import DEFAULT_PAGE_SIZE, resolve_pool_pages

logger = logging.getLogger(__name__)

DEFAULT_PREFILL_BUCKETS = (64, 128, 256, 512, 1024)


@dataclass
class GenerationResult:
    text: str
    tokens: list[int]
    finish_reason: str  # length | eos_token | stop_sequence
    input_tokens: int
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class GenerationChunk:
    text: str
    tokens: list[int]
    is_final: bool = False
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class _PendingGen:
    """One request queued in the coalescing batcher (JAX ``_PendingGen``)."""

    embeds: Any  # [1, L, H]
    positions: Any  # [1, L]
    prompt_ids: Any  # [1, S]
    n_prompt: int  # live tokens (host)
    max_new: int
    temperature: float
    top_p: float
    do_sample: bool
    repetition_penalty: float
    future: Any = None

    @property
    def key(self) -> tuple:
        # Only identically-shaped requests share one batch.
        return (self.embeds.shape[1], self.prompt_ids.shape[1])


class _GenBatcher:
    """The coalescing scheduler (JAX ``_GenBatcher``): collects concurrent
    ``generate`` requests of one prompt-bucket shape and decodes them as
    one batch on its own thread. ``close`` fails whatever is queued."""

    def __init__(self, runner, max_batch: int = 4, max_latency_ms: float = 6.0, name: str = "vlm"):
        self._runner = runner
        self.name = name
        self.max_batch = max_batch
        self.max_latency_s = max_latency_ms / 1e3
        self.batches_run = 0
        self.rows_run = 0
        self._queue: list[_PendingGen] = []
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name="vlm-gen-batcher", daemon=True)
        self._thread.start()
        ref = weakref.ref(self)  # the registry must not pin the runner

        def _gauges() -> dict:
            b = ref()
            if b is None:
                return {}
            return {"batches_run": b.batches_run, "rows_run": b.rows_run, "queue_depth": len(b._queue)}

        self._gauge_fn = _gauges
        metrics.register_gauges(f"vlm-coalesce:{self.name}", _gauges)

    def submit(self, item: _PendingGen) -> Future:
        item.future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("generation batcher is closed")
            self._queue.append(item)
            self._cond.notify()
        return item.future

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=5)
        with self._cond:
            pending, self._queue = self._queue, []
        for item in pending:
            item.future.set_exception(RuntimeError("generation batcher closed"))
        metrics.unregister_gauges(f"vlm-coalesce:{self.name}", self._gauge_fn)

    def _take_batch(self) -> list[_PendingGen]:
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if not self._queue:
                return []
            head = self._queue.pop(0)
        batch = [head]
        deadline = time.perf_counter() + self.max_latency_s
        while len(batch) < self.max_batch:
            with self._cond:
                take = [i for i, it in enumerate(self._queue) if it.key == head.key]
                for offset, i in enumerate(take[: self.max_batch - len(batch)]):
                    batch.append(self._queue.pop(i - offset))
            if len(batch) >= self.max_batch:
                break
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            with self._cond:
                self._cond.wait(timeout=remaining)
                if self._closed:
                    break
        return batch

    def _loop(self) -> None:
        try:
            while True:
                batch = self._take_batch()
                if not batch:
                    if self._closed:
                        return
                    continue
                # Counted before the futures resolve, so a caller that
                # joins its threads sees this batch.
                self.batches_run += 1
                self.rows_run += len(batch)
                try:
                    self._runner(batch)
                except Exception as e:  # noqa: BLE001 - fan the failure out
                    for item in batch:
                        if not item.future.done():
                            item.future.set_exception(e)
        finally:
            # A worker that dies for any reason must not strand callers
            # blocked on futures.
            with self._cond:
                self._closed = True
                pending, self._queue = self._queue, []
            err = RuntimeError("generation batcher worker exited")
            for item in pending:
                if item.future is not None and not item.future.done():
                    item.future.set_exception(err)


class VLMManager:
    """Serving entry point for one VLM.

    ``device`` defaults to the card (``cuda:0``) and raises without one;
    the tests pass ``device="cpu"``. ``pool_pages`` caps each paged KV
    pool explicitly; None sizes it from the device's free memory (the
    whole slot-era footprint on the CPU). ``page_size`` / ``prefill_chunk``
    default to ``LUMEN_VLM_PAGE_SIZE`` / ``LUMEN_VLM_PREFILL_CHUNK`` (16 /
    256), the JAX engine's knobs. ``scheduler`` is ``continuous`` or
    ``coalesce`` (``LUMEN_VLM_SCHEDULER`` overrides it); the coalescer
    batches up to ``gen_batch_size`` requests a ``gen_batch_latency_ms``
    window and bounds concurrent streams to as many. ``quantize="int8"``
    casts the ``state_dict`` with the policy, then quantizes the decoder's
    projections (``convert.quantize_decoder_int8``) and serves them as
    ``QDense`` (``LUMEN_Q8_KERNEL``, default ``dequant``) on the route
    ``LUMEN_VLM_Q8_ROUTE`` resolves; the vision tower is cast, never
    quantized. ``vision_graph`` serves an exported vision tower in place
    of the native one (whose weights the ``state_dict`` then need not
    hold). ``warmup`` runs the int8 route's A/B and one short generation
    at start-up. Speculative decoding is the engine's, set by
    ``LUMEN_VLM_SPEC_K``. ``name`` is the model id the service reports;
    ``info`` / ``model_dir`` are the model directory's manifest and path
    (the result cache's revision, the route verdict's file).
    ``mesh_axes`` is the service's mesh request (JAX axis names): an
    ``expert`` or ``model`` axis above 1 serves on the running group
    (module docstring); a ``data`` axis serves on its place 0. ``devices``
    are the cards the mesh and the replica plan span (default every card
    from ``device`` on).
    """

    def __init__(
        self,
        cfg: VLMConfig,
        state_dict: Mapping[str, torch.Tensor],
        tokenizer,
        device: "str | torch.device | None" = None,
        dtype: str = "bfloat16",
        max_seq: int = 2048,
        max_new_cap: int = 512,
        prefill_buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS,
        gen_slots: int = 8,
        gen_block: int = 8,
        page_size: int | None = None,
        pool_pages: int | None = None,
        prefill_chunk: int | None = None,
        name: str = "vlm",
        quantize: str | None = None,
        scheduler: str = "continuous",
        gen_batch_size: int = 4,
        gen_batch_latency_ms: float = 6.0,
        warmup: bool = False,
        vision_graph: VisionGraph | None = None,
        info: ModelInfo | None = None,
        model_dir: str | None = None,
        mesh_axes: dict[str, int] | None = None,
        devices: Sequence[torch.device] | None = None,
    ):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        env_sched = env_choice("LUMEN_VLM_SCHEDULER", None, ("coalesce", "continuous"))
        if env_sched is not None and env_sched != scheduler:
            logger.info("VLM scheduler %r overridden to %r by LUMEN_VLM_SCHEDULER", scheduler, env_sched)
            scheduler = env_sched
        if scheduler not in ("coalesce", "continuous"):
            raise ValueError(f"scheduler must be 'coalesce' or 'continuous', got {scheduler!r}")
        self.scheduler = scheduler
        self.device = resolve_device(device)
        cards = list(devices or fleet_devices(self.device))
        self.mesh = None
        #: the serving group of an ``expert`` or ``model`` axis above 1, else None
        self.tp_group = None
        group_plan = None
        if mesh_axes and any(mesh_axes.get(a, 1) != 1 for a in GROUP_AXES):
            # The continuous engines plan their replicas over the group's
            # places (JAX: the mesh is replica 0's); the coalescer is one
            # batcher over the whole mesh.
            if scheduler == "continuous":
                group_plan = plan_replicas("vlm", mesh_axes)
                self.mesh = group_plan.meshes[0]
            else:
                self.mesh = build_mesh(mesh_axes)
            self.tp_group = self.mesh.group
            if self.mesh.device != self.device:
                raise ValueError(f"the tensor-parallel group's rank 0 is on {self.mesh.device}, not {self.device}")
            # TP x int8 (JAX manager.py:268-272): a model axis anywhere in
            # the process routes int8 decode to the dequant dot (the expert
            # axis does not).
            note_mesh_model_axis(self.tp_group.tp.size)
        elif mesh_axes:
            self.mesh = build_mesh(mesh_axes, devices=cards)
        self.policy = get_policy(dtype)
        self.quantize = quantize
        #: decode route in use ("bf16" | "int8"), resolved at construction
        self.quant_route = "int8" if quantize else "bf16"
        #: measured q8 / bf16 decode rate of the warm-up A/B (or its verdict file)
        self.quant_speedup: float | None = None
        self.model_id = name
        #: ``model_info.json`` of a model directory: its version keys the
        #: result cache and the route verdict.
        self.info = info
        self.model_dir = model_dir
        self.warmup = warmup
        self.gen_slots = gen_slots
        self.gen_block = gen_block
        self.page_size = page_size or env_int("LUMEN_VLM_PAGE_SIZE", DEFAULT_PAGE_SIZE, minimum=8, maximum=256)
        self.gen_batch_size = gen_batch_size
        self.gen_batch_latency_ms = gen_batch_latency_ms
        self.max_seq = max_seq
        self.max_new_cap = max_new_cap
        self.tokenizer = tokenizer if isinstance(tokenizer, VlmTokenizer) else VlmTokenizer(tokenizer)
        self.compute_dtype = self.policy.compute_dtype
        if scheduler == "continuous":
            # One continuous engine (page pool + block tables) per replica
            # slice; the coalescer stays one batcher on the manager's device.
            self.fleet_plan = group_plan or plan_replicas("vlm", None, devices=cards)
        else:
            self.fleet_plan = None
            if replicas_for("vlm") != 1:
                logger.warning(
                    "LUMEN_REPLICAS(_VLM) > 1 requested but the coalescing VLM scheduler is not "
                    "replica-fleeted; serving 1 replica (use scheduler=continuous to fleet)"
                )
        state = dict(state_dict)
        if vision_graph is not None:
            # The native tower never runs on this path: it is neither loaded
            # nor checked, and the graph's probe sets the token count.
            state = {k: v for k, v in state.items() if not k.startswith("vision.")}
        if quantize:
            cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
                cfg.decoder, weight_quant="int8", weight_quant_kernel=resolve_q8_kernel("dequant")))
            cfg, state = self._resolve_q8_route(cfg, state)
        self.cfg = cfg
        self.model = self._place_params(cfg, state, native_vision=vision_graph is None)
        del state
        self._vision_graph = vision_graph
        if vision_graph is not None:
            # The tower runs in its exported float32 on the serving device
            # (on a group, rank 0's alone); the host copy goes once the
            # device holds one.
            self._vision_params = vision_graph.place(self.device)
            v = vision_graph.probe(cfg.vision.image_size, cfg.decoder.hidden_size, self._vision_params)
            vision_graph.release_weights()
            logger.info("vlm vision tower: graph (%d tokens)", v)
        else:
            v = cfg.vision.num_tokens
        self.vision_tokens = v
        # A prompt bucket is usable only if prompt + vision tokens + the
        # decode budget fit a row.
        self.prefill_buckets = [b for b in sorted(prefill_buckets) if b - 1 + v + max_new_cap + 1 <= max_seq]
        if not self.prefill_buckets:
            raise ValueError(
                f"max_seq={max_seq} too small for any prompt bucket "
                f"(+{v} vision tokens, +{max_new_cap} decode budget)"
            )
        # One KV size per prompt bucket (the merged length plus the decode
        # budget, rounded up to 64): the coalescer's buffer and the engine's
        # prefill scratch are the smallest that cover a request.
        self._seq_buckets = tuple(
            min(max_seq, -((b - 1 + v + max_new_cap + 1) // -64) * 64) for b in self.prefill_buckets
        )
        self.generator = self._make_generator(self.model)
        self._mean = torch.tensor(cfg.vision.mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(cfg.vision.std, dtype=torch.float32, device=self.device)
        self._seed_lock = threading.Lock()
        self._seed = 0
        self._batcher: _GenBatcher | None = None
        self._engines: list[ContinuousScheduler] = []
        self._engine_fleet: EngineFleet | None = None
        self.engine: ContinuousScheduler | None = None
        if scheduler == "continuous":
            self._engine_kw = dict(
                page_size=self.page_size, pool_pages=pool_pages, prefill_chunk=prefill_chunk, block=gen_block,
            )
            plan = self.fleet_plan
            self._engines = [self._build_engine(None if plan.replicas == 1 else 0)]
            self._engines += [self._build_engine(rid) for rid in range(1, plan.replicas)]
            self.engine = self._engines[0]
            if plan.replicas > 1:
                self._engine_fleet = EngineFleet(
                    name, list(self._engines), build=self._build_engine,
                    devices_per_replica=plan.devices_per_replica,
                )
                logger.info("VLM continuous engine fleet: %d replicas x %d slots", plan.replicas, gen_slots)
            elif (self.mesh or plan.meshes[0]).shape.get("data", 1) > 1:
                logger.info(
                    "VLM continuous engine on %s, place 0 of the data axis %s: its slots share one page pool, which "
                    "has no batch axis to split, so the other places hold no copy (LUMEN_REPLICAS_VLM=max serves "
                    "one engine a card)", plan.meshes[0].device, self.mesh or plan.meshes[0],
                )
        else:
            self._batcher = _GenBatcher(
                self._run_gen_batch, max_batch=gen_batch_size, max_latency_ms=gen_batch_latency_ms, name=name
            )
            # Each live stream holds a max_seq KV buffer: bound how many.
            self._stream_slots = threading.Semaphore(max(1, gen_batch_size))
        self._initialized = True
        if warmup:
            t0 = time.perf_counter()
            self.generate([ChatMessage(role="user", content="hi")], max_new_tokens=1)
            logger.info("vlm warmup (text path) in %.1fs", time.perf_counter() - t0)

    @staticmethod
    def _build_model(cfg: VLMConfig, state: Mapping[str, torch.Tensor], native_vision: bool = True,
                     tp=None, ep=None) -> VLMModel:
        """A ``VLMModel`` holding ``state`` (strict: names and shapes must
        match; with ``tp`` and ``ep``, one rank's shards); without
        ``native_vision`` the vision subtree is dropped."""
        with torch.device("meta"):
            model = VLMModel(cfg, tp=tp, ep=ep)
        if not native_vision:
            model.vision = None
        model.load_state_dict(state, strict=True, assign=True)
        return model

    def _place_params(self, cfg: VLMConfig, state: Mapping[str, torch.Tensor], native_vision: bool = True):
        """The model on this manager's mesh (JAX ``_place_params``): on an
        ``expert`` or ``model`` axis every rank builds its shards
        (:func:`place_tp_model`: ``MOE_EP_RULES`` first on an expert axis,
        then on a model axis ``INT8_TP_RULES`` when the decoder is int8 and
        ``TRANSFORMER_TP_RULES``); otherwise the whole model on the device.
        Cast to the policy's parameter dtype."""
        if self.tp_group is not None:
            place = self.mesh.places[0]
            return place.run(place_tp_model, cfg, dict(state), native_vision, self.policy.param_dtype, place)
        model = self._build_model(cfg, state, native_vision)
        return model.to(device=self.device, dtype=self.policy.param_dtype).eval()

    def _new_generator(self, model: VLMModel, cfg: VLMConfig, max_seq: int, **kw) -> Generator:
        """A ``Generator`` over ``model``: on a tensor-parallel group, one
        on every rank over the rank's shards, at the model's place."""
        return run_on(place_of(model), Generator, model, cfg, max_seq, **kw)

    def _make_generator(self, model: VLMModel) -> Generator:
        return self._new_generator(
            model, self.cfg, self.max_seq, cache_dtype=self.compute_dtype,
            seq_buckets=self._seq_buckets, max_new_cap=self.max_new_cap,
        )

    def alive(self) -> bool:
        """False once the manager closed or its tensor-parallel group went
        down (a worker rank died): the service's ``Health``."""
        return self._initialized and (self.tp_group is None or self.tp_group.alive())

    def _build_engine(self, rid: int | None) -> ContinuousScheduler:
        """One replica's continuous engine on its slice's device (also the
        fleet's unpark hook): the weights are shared on the manager's own
        device, copied onto another; on a group, each rank's shards copied
        onto the first place of the replica's slice (:func:`copy_tp_model`)
        unless it is the manager's; gauge names ``vlm-continuous:<model>``
        or ``...-r<rid>``."""
        mesh = self.fleet_plan.meshes[rid or 0]
        device = mesh.device
        if self.tp_group is not None:
            place = mesh.places[0]
            model = self.model if place is place_of(self.model) else place.run(
                copy_tp_model, self.model, self.cfg, self._vision_graph is None, place)
        else:
            model = self.model if device == self.device else copy.deepcopy(self.model).to(device)
        gen = self.generator if model is self.model else self._make_generator(model)
        kw = self._engine_kw
        pages = kw["pool_pages"]
        if pages is None:
            # Sized once, on rank 0, for this rank's KV heads; every
            # rank of a tensor-parallel group allocates as many pages.
            cfg = dataclasses.replace(self.cfg, decoder=dataclasses.replace(self.cfg.decoder, kv_heads=gen.kv_heads))
            pages = resolve_pool_pages(
                cfg, kw["page_size"], self.gen_slots, self.max_seq,
                dtype_bytes=torch.finfo(self.compute_dtype).bits // 8, device=device,
            )
        return ContinuousScheduler(
            gen, slots=self.gen_slots, block=kw["block"], name=batcher_name(self.model_id, rid),
            page_size=kw["page_size"], pages=pages, prefill_chunk=kw["prefill_chunk"],
        )

    # -- the int8 route -----------------------------------------------------

    def _resolve_q8_route(self, cfg: VLMConfig, state: dict) -> tuple[VLMConfig, dict]:
        """Which route an int8 opt-in serves (JAX ``_resolve_q8_route``),
        from ``LUMEN_VLM_Q8_ROUTE``: ``bf16`` pins the unquantized decoder
        (no quantization pass); ``int8`` pins int8 with no timing; ``auto``
        (the default; a malformed value warns and means it) reads this
        model revision's verdict file with ``warmup`` on, else times a
        decode A/B and records its verdict, and without ``warmup`` serves
        int8. Returns the configuration and the route's ``state`` (cast
        to the policy dtype; the vision tower is never quantized) and
        exports the ``vlm-quant:<model>`` gauges (``int8_active``,
        ``q8_speedup_pct``)."""
        route = resolve_q8_route("LUMEN_VLM_Q8_ROUTE")
        param = self.policy.param_dtype
        # Cast first, so the int8 grid comes from the weights serving would
        # otherwise stream.
        cast = {k: v.to(param) if v.is_floating_point() else v for k, v in state.items()}
        base_cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, weight_quant=None))
        qstate = None
        if route == "bf16":
            logger.info("VLM quantize=int8 overridden to bf16 (LUMEN_VLM_Q8_ROUTE); skipping quantization")
            chosen = "bf16"
        else:
            cached = self._load_q8_verdict() if route == "auto" and self.warmup else None
            if cached is not None:
                chosen = cached["route"]
                self.quant_speedup = cached.get("q8_speedup")
                logger.info(
                    "VLM q8 decode verdict for %s loaded from %s: %s (measured %s); skipping the warm-up A/B",
                    self._q8_verdict_key(), self._q8_verdict_path(), chosen, cached.get("measured_at", "?"),
                )
            elif route == "int8" or not self.warmup:
                chosen = "int8"
            else:
                qstate = quantize_decoder_int8(cast)
                chosen = self._q8_decode_ab(base_cfg, cfg, cast, qstate)
                self._save_q8_verdict(chosen)
        self.quant_route = chosen
        self._route_gauge_fn = register_route_gauges(self, f"vlm-quant:{self.model_id}")
        if chosen == "bf16":
            return base_cfg, cast
        return cfg, qstate if qstate is not None else quantize_decoder_int8(cast)

    def _q8_verdict_key(self) -> str | None:
        return f"{self.info.name}@{self.info.version}" if self.info is not None else None

    def _q8_verdict_path(self) -> str | None:
        return os.path.join(self.model_dir, ".lumen_q8_verdict.json") if self.model_dir else None

    def _load_q8_verdict(self) -> dict | None:
        """This model revision's recorded A/B verdict, or None when the file
        is missing, names another revision or does not parse (each of which
        measures again: a stale or mangled file never pins a route)."""
        path = self._q8_verdict_path()
        if path is None or self.info is None:
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if (
            not isinstance(data, dict)
            or data.get("model") != self._q8_verdict_key()
            or data.get("route") not in ("int8", "bf16")
        ):
            return None
        return data

    def _save_q8_verdict(self, route: str) -> None:
        """Best-effort record (a read-only model directory loses the
        verdict, not the boot)."""
        path = self._q8_verdict_path()
        if path is None or self.info is None:
            return
        data = {
            "model": self._q8_verdict_key(),
            "route": route,
            "q8_speedup": self.quant_speedup,
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(data, f)
        except OSError as e:
            logger.debug("could not record the q8 verdict in %s: %s", path, e)

    def _q8_decode_ab(self, base_cfg: VLMConfig, q_cfg: VLMConfig, cast: dict, qstate: dict) -> str:
        """The warm-up decode A/B (JAX ``_q8_decode_ab``) of the cast and the
        quantized states: the bf16 decoder placed, timed and freed, then the
        int8 one, so the device never holds two decoder sets. int8 is
        served when it decodes at least as fast; else ``vlm_q8_fallbacks``
        counts the fallback."""

        def decoder(state):
            return {k: v for k, v in state.items() if not k.startswith("vision.")}

        tps_bf16 = self._time_decode_route(base_cfg, decoder(cast))
        tps_q8 = self._time_decode_route(q_cfg, decoder(qstate))
        self.quant_speedup = tps_q8 / max(tps_bf16, 1e-9)
        if self.quant_speedup >= 1.0:
            logger.info("VLM int8 decode route confirmed: %.3fx bf16 tokens/s", self.quant_speedup)
            return "int8"
        logger.warning(
            "VLM int8 decode route DISABLED: the warm-up A/B measured q8 decode at %.3fx bf16 tokens/s; "
            "serving bf16. Pin LUMEN_VLM_Q8_ROUTE=int8 to force.", self.quant_speedup,
        )
        metrics.count("vlm_q8_fallbacks")
        return "bf16"

    def _time_decode_route(self, cfg: VLMConfig, decoder_state: dict) -> float:
        """Decode tokens/s of one route (JAX ``_time_decode_route``) on the
        program this manager's scheduler serves with: the continuous
        engine's ``step_block`` (:meth:`_engine_decode_probe`) or the
        coalescer's fused decode (:meth:`_fused_decode_probe`), at a batch
        of ``min(4, slots)`` or ``min(4, gen_batch_size)`` rows of a
        16-token synthetic prompt and 64 new tokens a row. The best of 2
        after a settling pass, each ended by a device synchronization. The
        decoder is placed here and freed before returning."""
        prompt_len, new_tokens = 16, 64
        continuous = self.scheduler == "continuous"
        batch = max(1, min(4, self.gen_slots if continuous else self.gen_batch_size))
        dev = self.device
        model = self._place_params(cfg, decoder_state, native_vision=False)
        probe = self._engine_decode_probe if continuous else self._fused_decode_probe
        prepare, decode = probe(model, cfg, batch, prompt_len, new_tokens)
        best = 0.0
        for i in range(3):  # a settling pass off the clock, then the best of 2
            prepare()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            n = decode()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if i:
                best = max(best, max(n, 1) / (time.perf_counter() - t0))
        del prepare, decode, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return best

    def _fused_decode_probe(self, model: VLMModel, cfg: VLMConfig, batch: int, prompt_len: int, new_tokens: int):
        """``(prepare, decode)`` of the coalescer's program: ``decode`` is one
        ``Generator.generate`` call (prefill included) of ``new_tokens`` a
        row and returns the tokens it generated; nothing to prepare."""
        dev = self.device
        gen = self._new_generator(model, cfg, prompt_len + new_tokens + 8, cache_dtype=self.compute_dtype,
                                  max_new_cap=new_tokens)
        embeds = torch.zeros((batch, prompt_len, cfg.decoder.hidden_size), dtype=self.compute_dtype, device=dev)
        positions = torch.arange(prompt_len, device=dev).expand(batch, prompt_len)
        prompt_ids = torch.ones((batch, prompt_len), dtype=torch.long, device=dev)
        lengths = np.full((batch,), prompt_len)
        rng = torch.Generator(device=dev)

        def decode() -> int:
            out = gen.generate(embeds, positions, lengths, prompt_ids, rng, max_new_tokens=new_tokens)
            return int(out.n_generated.sum())

        return (lambda: None), decode

    def _engine_decode_probe(self, model: VLMModel, cfg: VLMConfig, batch: int, prompt_len: int, new_tokens: int):
        """``(prepare, decode)`` of the continuous engine's decode on a
        throwaway paged pool of ``page_size`` pages: ``prepare`` prefills
        ``batch`` rows and admits them (off the clock); ``decode`` runs
        ``new_tokens`` a row (rounded up to whole blocks) through
        ``step_block`` in blocks of ``gen_block``, fetching each block's
        tokens to the host as ``_run_block`` does, and returns the row
        steps it ran."""
        dev = self.device
        page, block = self.page_size, max(1, self.gen_block)
        steps = -(-new_tokens // block) * block
        span = -(-prompt_len // page) * page
        maxp = -(-(span + steps) // page)
        gen = self._new_generator(model, cfg, maxp * page, cache_dtype=self.compute_dtype, max_new_cap=steps)
        pool = gen.init_pool(batch, pages=batch * maxp + 1, page_size=page)
        tables_h = np.arange(1, batch * maxp + 1, dtype=np.int32).reshape(batch, maxp)
        tables = torch.from_numpy(tables_h).to(dev)
        embeds = torch.zeros((batch, span, cfg.decoder.hidden_size), dtype=self.compute_dtype, device=dev)
        positions = torch.arange(span, device=dev).expand(batch, span)
        prompt_ids = torch.ones((batch, span), dtype=torch.long, device=dev)
        lengths = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
        params = (torch.zeros((batch,), device=dev), torch.ones((batch,), device=dev),
                  torch.zeros((batch,), dtype=torch.bool, device=dev), torch.ones((batch,), device=dev))
        rng = torch.Generator(device=dev)

        def prepare() -> None:
            caches, tok0, seen = gen.prefill(embeds, positions, lengths, prompt_ids, rng, *params, kv_len=span)
            for i in range(batch):
                gen.admit(pool, i, caches, tok0, seen, prompt_len, tables_h[i], steps, 0.0, 1.0, False, 1.0, row=i)

        def decode() -> int:
            for _ in range(steps // block):
                gen.step_block(pool, tables, rng, block).cpu()
            return batch * steps

        return prepare, decode

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_model_dir(
        cls,
        model_dir: str,
        device: "str | torch.device | None" = None,
        dtype: str = "bfloat16",
        max_seq: int = 2048,
        max_new_cap: int = 512,
        prefill_buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS,
        gen_slots: int = 8,
        gen_block: int = 8,
        quantize: str | None = None,
        **kw,
    ) -> "VLMManager":
        """Serve the model directory ``model_dir`` (the JAX manager's
        loading order, ``manager.py:207-357`` and ``:593-700``):
        ``model_info.json``, the configuration from ``config.json`` or the
        manifest's ``extra_metadata``, the checkpoint
        (``convert_vlm_checkpoint``; tensors keep their stored dtype until
        the policy cast), the vision tower, then the tokenizer and chat
        template. ``vision_backend`` in ``extra_metadata`` picks the tower:
        ``native`` the checkpoint's ViT; ``graph`` a ``vision*.onnx``
        (``find_vision_onnx``; none raises ``FileNotFoundError``); ``auto``
        (the default) the native tower when the checkpoint holds all of
        it, else a ``vision*.onnx`` when there is one. ``kw`` passes the
        constructor's other arguments (``page_size``, ``pool_pages``,
        ``prefill_chunk``, ``scheduler``, ``gen_batch_size``,
        ``gen_batch_latency_ms``, ``warmup``) through."""
        info = load_model_info(model_dir)
        cfg = build_config(model_dir, info)
        state = convert_vlm_checkpoint(
            load_state_dict(model_dir), tie_word_embeddings=cfg.decoder.tie_word_embeddings
        )
        backend = str((info.extra_metadata or {}).get("vision_backend", "auto"))
        vision_onnx = find_vision_onnx(model_dir) if backend != "native" else None
        vision_graph = None
        if vision_onnx is not None and (backend == "graph" or not _has_native_vision(cfg, state)):
            vision_graph = VisionGraph.from_path(vision_onnx)
        elif backend == "graph":
            raise FileNotFoundError(f"vision_backend=graph but no vision*.onnx in {model_dir}")
        return cls(
            cfg, state, VlmTokenizer.from_model_dir(model_dir), device=device, dtype=dtype,
            max_seq=max_seq, max_new_cap=max_new_cap, prefill_buckets=prefill_buckets,
            gen_slots=gen_slots, gen_block=gen_block, name=info.name, quantize=quantize,
            vision_graph=vision_graph, info=info, model_dir=model_dir, **kw,
        )

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
        if self._engine_fleet is not None:
            # The fleet holds the engines an unpark rebuilt, too.
            self._engine_fleet.close()
        else:
            for engine in self._engines:
                engine.close()
        if fn := getattr(self, "_route_gauge_fn", None):
            metrics.unregister_gauges(f"vlm-quant:{self.model_id}", fn)
        self._initialized = False

    def _ensure_ready(self) -> None:
        if not self._initialized:
            raise RuntimeError("VLMManager is closed")

    def _pick_engine(self) -> ContinuousScheduler:
        """Least-loaded continuous engine (queue + live rows + prefill
        lane); with a fleet, only SERVING engines are candidates, so a
        parked engine takes no work."""
        if self._engine_fleet is not None:
            live = self._engine_fleet.serving_engines()
            if live:
                return min(live, key=lambda e: e.load())
        if len(self._engines) == 1:
            return self._engines[0]
        return min(self._engines, key=lambda e: e.load())

    @property
    def max_concurrency(self) -> int:
        """The suggested client concurrency: the decode width the scheduler
        batches (slots x engine replicas for ``continuous``, the batch for
        ``coalesce``), as the JAX service computes it."""
        if self.scheduler == "continuous":
            return max(1, self.gen_slots * max(1, len(self._engines)))
        return max(1, self.gen_batch_size)

    def kv_layout(self) -> str:
        if self.engine is None:
            return f"contiguous(max_seq={self.max_seq})"
        kv = self.engine.kv
        return f"paged(page={kv.page_size},pages={kv.pages_total},slots={self.engine.n_slots})"

    def topology(self) -> dict[str, str]:
        """Device topology for the capability ``extra``: the device, the
        card count and the replica count (one per continuous engine; the
        coalescer is one replica)."""
        count = torch.cuda.device_count() if self.device.type == "cuda" else 1
        return {"device": str(self.device), "device_count": str(count), "replicas": str(max(1, len(self._engines)))}

    # -- prompt prep -------------------------------------------------------

    def _encode_prompt(self, messages, has_image: bool, add_generation_prompt: bool = True) -> list[int]:
        prompt = self.tokenizer.render(messages, add_generation_prompt=add_generation_prompt)
        ids = self.tokenizer.encode(prompt)
        if has_image and self.cfg.image_token_id not in ids:
            # No <image> slot in the rendered prompt: splice it up front.
            ids = [self.cfg.image_token_id] + ids
        return ids

    def _bucket_len(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds the largest bucket {self.prefill_buckets[-1]}")

    def _pixels(self, pixels) -> torch.Tensor:
        size = self.cfg.vision.image_size
        t = torch.as_tensor(np.asarray(pixels) if not isinstance(pixels, torch.Tensor) else pixels)
        if t.dtype != torch.uint8 or tuple(t.shape) != (size, size, 3):
            raise ValueError(
                f"pixels must be uint8 [{size}, {size}, 3] (decoded, letterboxed); "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        return t.to(self.device)[None]

    @torch.no_grad()
    def _prepare(self, pixels_u8, ids, length):
        """Normalize -> vision tower -> token embed -> splice, all launched
        on the device (a program of every rank on a tensor-parallel group):
        the graph tower runs on float32 NCHW pixels, the native one on the
        compute dtype."""
        if self._vision_graph is not None:
            # The tower runs here alone (rank 0's device on a group); its
            # output goes by value into the splice program of every rank.
            x = (pixels_u8.float() / 255.0 - self._mean) / self._std
            vis = self._vision_graph(self._vision_params, x.permute(0, 3, 1, 2)).to(self.compute_dtype)
            return run_on(place_of(self.model), prepare_graph, self.model, vis, ids, length, self.compute_dtype,
                          self.cfg.image_token_id)
        return run_on(place_of(self.model), prepare_image, self.model, pixels_u8, ids, length, self._mean, self._std,
                      self.compute_dtype, self.cfg.image_token_id)

    @torch.no_grad()
    def _prepare_text(self, ids, length):
        return run_on(place_of(self.model), prepare_text, self.model, ids, length, self.compute_dtype)

    def _prepare_inputs(self, messages, pixels, add_generation_prompt: bool = True):
        """The prepared prompt: ``(embeds, positions, lengths, prompt_ids,
        host ids [1, bucket], n_input, n_live)``."""
        has_image = pixels is not None
        ids = self._encode_prompt(messages, has_image, add_generation_prompt)
        n = len(ids)
        padded = np.full((1, self._bucket_len(n)), self.cfg.pad_token_id, np.int64)
        padded[0, :n] = ids
        prompt_ids = torch.from_numpy(padded).to(self.device)
        length = torch.tensor([n], device=self.device)
        if has_image:
            embeds, positions, lengths = self._prepare(self._pixels(pixels), prompt_ids, length)
            n_live = n - 1 + self.vision_tokens
        else:
            embeds, positions, lengths = self._prepare_text(prompt_ids, length)
            n_live = n
        return embeds, positions, lengths, prompt_ids, padded, n, n_live

    def _next_generator(self, device: torch.device) -> torch.Generator:
        with self._seed_lock:
            self._seed += 1
            seed = self._seed
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return gen

    def _make_gen_request(
        self, messages, pixels, max_new_tokens, temperature, top_p, do_sample,
        repetition_penalty, add_generation_prompt, image_bytes=None,
    ) -> "tuple[_Request | _PendingGen, int]":
        """The scheduler's request object and the prompt's token count:
        a ``_Request`` for the continuous engine it will be submitted to
        (``_submit``), or a ``_PendingGen`` for the coalescer."""
        if image_bytes and pixels is not None:
            raise ValueError("pass an image as pixels or as image_bytes, not both")
        if image_bytes:
            # The decode pool's ``vlm_canvas`` spec (a worker process's
            # shared-memory slot in process mode; ValueError when the bytes
            # do not decode). ``_prepare_inputs`` has copied the pixels to
            # the device (a blocking copy from pageable memory) or, on the
            # CPU, consumed them before it returns, so the slot recycles
            # right after.
            decoded = get_decode_pool().run_decode(
                "vlm_canvas", image_bytes, {"size": self.cfg.vision.image_size}
            )
            try:
                prepared = self._prepare_inputs(messages, decoded.array, add_generation_prompt)
            finally:
                decoded.release()
        else:
            prepared = self._prepare_inputs(messages, pixels, add_generation_prompt)
        embeds, positions, lengths, prompt_ids, host_ids, n_input, n_live = prepared
        common = dict(
            embeds=embeds, positions=positions, prompt_ids=prompt_ids, n_prompt=n_live,
            max_new=min(int(max_new_tokens), self.max_new_cap), temperature=float(temperature),
            top_p=float(top_p), do_sample=bool(do_sample), repetition_penalty=float(repetition_penalty),
        )
        if self._batcher is not None:
            return _PendingGen(**common), n_input
        req = _Request(
            length=lengths, **common,
            prefix_content=self._prefix_content(host_ids, n_input, _image_identity(image_bytes, pixels)),
        )
        owner = disagg.current()
        if owner:
            # Disaggregated serving: the front tier pinned this request's
            # decode to a decode-lane peer; the engine migrates the row
            # there right after prefill.
            req.migrate_to = owner
        return req, n_input

    def _submit(self, req: _Request, stream: bool = False):
        """Hand ``req`` to the least-loaded continuous engine, on that
        engine's device (on a group, its place: a copy there goes to every
        rank by value): its future, or its token iterator (``stream``)."""
        engine = self._pick_engine()
        device = engine.gen.device
        if req.embeds.device != device or place_of(engine.gen) is not place_of(self.model):
            req.embeds, req.positions = req.embeds.to(device, copy=True), req.positions.to(device, copy=True)
            req.length, req.prompt_ids = req.length.to(device, copy=True), req.prompt_ids.to(device, copy=True)
        req.generator = self._next_generator(device)
        return engine.submit_stream(req) if stream else engine.submit(req)

    def _prefix_content(self, host_ids, n: int, image: bytes) -> "np.ndarray | None":
        """Content identity of the POST-SPLICE sequence for the prefix KV
        cache (JAX ``_prefix_content``): the text token ids, with the
        ``<image>`` placeholder expanded to ``V`` int64s derived from the
        image's sha256 digest (``(1<<62) | digest<<14 | position``, far
        above any vocabulary id, so a text prefix never aliases a vision
        prefix). ``image`` is the encoded bytes, or the decoded pixels'
        bytes when the caller passed pixels. None when the engines were
        built without the cache: no hashing on the hot path."""
        if self.engine.prefix is None:
            return None
        ids = host_ids[0, :n].astype(np.int64)
        if not image:
            return ids
        pos = np.where(ids == self.cfg.image_token_id)[0]
        if pos.size == 0:
            return ids
        i = int(pos[0])
        digest = int.from_bytes(hashlib.sha256(image).digest()[:6], "big")
        vis = (1 << 62) + (digest << 14) + np.arange(self.vision_tokens, dtype=np.int64)
        return np.concatenate([ids[:i], vis, ids[i + 1 :]])

    # -- the coalescing scheduler -------------------------------------------

    def _run_gen_batch(self, items: list[_PendingGen]) -> None:
        """Decode a same-shape group as one batch and fan the rows' results
        out (the batcher's thread; JAX ``_run_gen_batch``). The batch is
        padded to a power of two with copies of row 0 at a zero budget,
        which emit nothing."""
        b = len(items)
        bucket = 1
        while bucket < b:
            bucket *= 2
        pad = bucket - b
        rows = items + [items[0]] * pad
        out = self.generator.generate(
            torch.cat([it.embeds for it in rows]),
            torch.cat([it.positions for it in rows]),
            np.asarray([it.n_prompt for it in rows]),
            torch.cat([it.prompt_ids for it in rows]),
            self._next_generator(self.device),
            max_new_tokens=[it.max_new for it in items] + [0] * pad,
            temperature=[it.temperature for it in items] + [0.0] * pad,
            top_p=[it.top_p for it in items] + [1.0] * pad,
            do_sample=[it.do_sample for it in items] + [False] * pad,
            repetition_penalty=[it.repetition_penalty for it in items] + [1.0] * pad,
        )
        for i, item in enumerate(items):
            item.future.set_result((out.tokens[i], int(out.n_generated[i]), bool(out.stopped_eos[i])))

    # -- generation --------------------------------------------------------

    def generate(
        self,
        messages: Sequence[ChatMessage],
        pixels=None,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        top_p: float = 1.0,
        do_sample: bool = False,
        repetition_penalty: float = 1.0,
        stop_sequences: Sequence[str] | None = None,
        add_generation_prompt: bool = True,
        image_bytes: bytes | None = None,
    ) -> GenerationResult:
        """Generate a caption/chat completion for ``messages`` and, when
        given, one image: decoded ``[image_size, image_size, 3]`` uint8
        ``pixels``, or encoded ``image_bytes`` (JPEG, PNG, ...; the JAX
        manager's argument).

        Greedy requests (``do_sample`` false, temperature <= 0) of a
        manager with a model revision go through the result cache, keyed
        on the image and the whole prompt and knob set, behind the
        quarantine gate; concurrent identical requests share one
        computation, and a hit replays the original result (its
        ``generation_time_ms`` included) with ``cached: True``. Sampled
        requests bypass the cache: they are meant to differ."""
        args = (
            messages, pixels, max_new_tokens, temperature, top_p, do_sample,
            repetition_penalty, stop_sequences, add_generation_prompt, image_bytes,
        )
        if do_sample or temperature > 0.0 or self.info is None:
            return self._generate_uncached(*args)
        options = {
            "messages": [(m.role, m.content) for m in messages],
            "max_new_tokens": int(max_new_tokens),
            "top_p": float(top_p),
            "repetition_penalty": float(repetition_penalty),
            "stop_sequences": list(stop_sequences) if stop_sequences else None,
            "add_generation_prompt": bool(add_generation_prompt),
        }

        def clone(result: GenerationResult) -> GenerationResult:
            return dataclasses.replace(
                result, tokens=list(result.tokens), metadata={**result.metadata, "cached": True}
            )

        ns = self._cache_ns()
        payload = _image_identity(image_bytes, pixels)
        key = guarded_key(ns, options, payload)
        return get_result_cache().get_or_compute(
            ns, options, payload, lambda: self._generate_uncached(*args), clone=clone, key=key
        )

    def _cache_ns(self) -> str:
        """Result-cache namespace (JAX ``_cache_ns``): model id and
        revision, compute dtype, decode route and image-decode policy, plus
        the device type -- kernels and plain versions round differently, so
        a result from one must not answer for the other through the disk
        tier."""
        return make_namespace(
            "vlm", "generate", self.model_id, self.info.version,
            str(self.compute_dtype).removeprefix("torch."),
            "int8" if self.quant_route == "int8" else "",
            DECODE_POLICY, self.device.type,
        )

    def _generate_uncached(
        self, messages, pixels, max_new_tokens, temperature, top_p, do_sample,
        repetition_penalty, stop_sequences, add_generation_prompt, image_bytes,
    ) -> GenerationResult:
        self._ensure_ready()
        t0 = time.perf_counter()
        req, n_input = self._make_gen_request(
            messages, pixels, max_new_tokens, temperature, top_p, do_sample,
            repetition_penalty, add_generation_prompt, image_bytes,
        )
        future = self._batcher.submit(req) if self._batcher is not None else self._submit(req)
        row_tokens, n_gen, stopped_eos = future.result()
        tokens = [int(t) for t in row_tokens[:n_gen]]
        text = self.tokenizer.decode(tokens)
        finish = "eos_token" if stopped_eos else "length"
        text, hit = _truncate_on_stop(text, stop_sequences)
        if hit:
            finish = "stop_sequence"
        dt_ms = (time.perf_counter() - t0) * 1e3
        meta = {
            "temperature": temperature,
            "top_p": top_p,
            "repetition_penalty": repetition_penalty,
            "do_sample": do_sample,
            "generation_time_ms": round(dt_ms, 2),
            "tokens_per_second": round(n_gen / max(dt_ms / 1e3, 1e-9), 2),
            **_reuse_meta(req),
        }
        return GenerationResult(
            text=text.strip(), tokens=tokens, finish_reason=finish,
            input_tokens=n_input, metadata=meta,
        )

    def generate_stream(
        self,
        messages: Sequence[ChatMessage],
        pixels=None,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        top_p: float = 1.0,
        do_sample: bool = False,
        repetition_penalty: float = 1.0,
        stop_sequences: Sequence[str] | None = None,
        add_generation_prompt: bool = True,
        image_bytes: bytes | None = None,
    ) -> Iterator[GenerationChunk]:
        """Incremental generation: yields text deltas as tokens arrive,
        then a final chunk whose metadata carries ``ttft_ms`` and
        ``tokens_per_second``."""
        self._ensure_ready()
        args = (
            messages, pixels, max_new_tokens, temperature, top_p, do_sample,
            repetition_penalty, stop_sequences, add_generation_prompt, image_bytes,
        )
        if self._batcher is None:
            yield from self._stream(*args)
            return
        # Each coalescer stream holds a max_seq KV buffer: bound how many
        # are live (the engines' memory is their fixed page pools).
        self._stream_slots.acquire()
        try:
            yield from self._stream(*args)
        finally:
            self._stream_slots.release()

    def _stream(
        self, messages, pixels, max_new_tokens, temperature, top_p, do_sample,
        repetition_penalty, stop_sequences, add_generation_prompt, image_bytes,
    ) -> Iterator[GenerationChunk]:
        t0 = time.perf_counter()
        # Hold back enough text that a stop sequence straddling a chunk
        # boundary can still be cut before emission.
        holdback = max((len(s) for s in stop_sequences), default=1) - 1 if stop_sequences else 0
        req, n_input = self._make_gen_request(
            messages, pixels, max_new_tokens, temperature, top_p, do_sample,
            repetition_penalty, add_generation_prompt, image_bytes,
        )
        tokens: list[int] = []
        emitted = ""
        finish = "length"
        final_text: str | None = None
        # Time to the first emitted chunk and the stream's decode rate,
        # observed at the source (the vlm.ttft / vlm.decode_tps histograms).
        first_emit_s: float | None = None

        def note_first_emit() -> None:
            nonlocal first_emit_s
            if first_emit_s is None:
                first_emit_s = time.perf_counter()
                metrics.observe("vlm.ttft", (first_emit_s - t0) * 1e3)

        if self._batcher is None:
            token_iter = self._submit(req, stream=True)
        else:
            token_iter = self.generator.stream(
                req.embeds, req.positions, [req.n_prompt], req.prompt_ids, self._next_generator(self.device),
                max_new_tokens=req.max_new, temperature=req.temperature, top_p=req.top_p,
                do_sample=req.do_sample, repetition_penalty=req.repetition_penalty,
            )
        for tok in token_iter:
            tokens.append(tok)
            if tok == self.cfg.eos_token_id:
                finish = "eos_token"
                break
            text = self.tokenizer.decode(tokens)
            # A byte-level BPE decode can end mid-character; emit only
            # stable prefixes.
            if text.endswith("�"):
                continue
            if stop_sequences:
                truncated, hit = _truncate_on_stop(text, stop_sequences)
                if hit:
                    finish = "stop_sequence"
                    final_text = truncated
                    break
            if not text.startswith(emitted):
                continue
            delta = text[len(emitted) : max(len(text) - holdback, len(emitted))]
            if delta:
                emitted += delta
                note_first_emit()
                yield GenerationChunk(text=delta, tokens=[tok])
        if final_text is None:
            final_text = self.tokenizer.decode(tokens)
        if final_text.startswith(emitted) and len(final_text) > len(emitted):
            tail = final_text[len(emitted) :]
            emitted = final_text
            note_first_emit()
            yield GenerationChunk(text=tail, tokens=[])
        dt_ms = (time.perf_counter() - t0) * 1e3
        meta = {
            "finish_reason": finish,
            "generated_tokens": len(tokens),
            "input_tokens": n_input,
            "generation_time_ms": round(dt_ms, 2),
        }
        if tokens:
            tps = len(tokens) / max(dt_ms / 1e3, 1e-9)
            # Histogram buckets are labelled in ms but this series carries
            # tokens/s, as in the JAX manager.
            metrics.observe("vlm.decode_tps", tps)
            meta["tokens_per_second"] = round(tps, 2)
        if first_emit_s is not None:
            meta["ttft_ms"] = round((first_emit_s - t0) * 1e3, 2)
        meta.update(_reuse_meta(req))
        yield GenerationChunk(text="", tokens=[], is_final=True, metadata=meta)


@torch.no_grad()
def prepare_image(model: VLMModel, pixels_u8, ids, length, mean, std, dtype, image_token_id: int):
    """The native tower's prepare step (a program on a tensor-parallel
    group): normalize -> vision tower -> token embed -> splice."""
    x = (pixels_u8.float() / 255.0 - mean) / std
    vis = model.encode_vision(x.to(dtype))
    text = model.embed_tokens(ids).to(dtype)
    return merge_image_embeddings(text, vis, ids, image_token_id, length)


@torch.no_grad()
def prepare_graph(model: VLMModel, vis, ids, length, dtype, image_token_id: int):
    """An exported tower's prepare step (a program on a tensor-parallel
    group): token embed -> splice of ``vis``, the tower's ``[1, N, H]``
    output computed on rank 0 and sent by value."""
    text = model.embed_tokens(ids).to(dtype)
    return merge_image_embeddings(text, vis, ids, image_token_id, length)


@torch.no_grad()
def prepare_text(model: VLMModel, ids, length, dtype):
    """A text prompt's prepare step: token embeds and positions."""
    text = model.embed_tokens(ids).to(dtype)
    b, s = ids.shape
    return text, torch.arange(s, device=ids.device).expand(b, s), length


def vlm_heads(cfg: VLMConfig):
    """``(heads, kv_heads, head_dim)`` of the attention block a VLM
    parameter belongs to (``parallel.sharding.HeadLayout``)."""
    d, v = cfg.decoder, cfg.vision

    def heads(name: str):
        if name.startswith("decoder.layers.") and ".attn." in name:
            return d.heads, d.kv_heads, d.dim_per_head
        if name.startswith("vision.blocks.") and ".attn." in name:
            return v.heads, v.heads, v.width // v.heads
        return None

    return heads


def placement_rules(group, int8: bool) -> list:
    """The sharding rules of a serving group, in the JAX manager's order
    (``lumen_tpu/models/vlm/manager.py:361-397``, first match wins):
    ``MOE_EP_RULES`` on an expert axis, then on a model axis
    ``INT8_TP_RULES`` for int8 projections and ``TRANSFORMER_TP_RULES``."""
    rules = list(MOE_EP_RULES) if group.ep is not None else []
    if group.tp.size > 1:
        rules += (INT8_TP_RULES if int8 else []) + TRANSFORMER_TP_RULES
    return rules


def place_tp_model(cfg: VLMConfig, state: Mapping[str, torch.Tensor], native_vision: bool, dtype, group) -> VLMModel:
    """One rank's shards of a VLM on an ``expert x model`` group (a program
    of ``group``): the rank's slice of ``state`` by the JAX placement
    (:func:`placement_rules`; whole heads, ``parallel.sharding.tp_split``),
    built, cast to ``dtype`` and placed on the rank's device. Notes the
    model axis for the int8 routing rule on this rank."""
    note_mesh_model_axis(group.tp.size)
    rules = placement_rules(group, cfg.decoder.weight_quant == "int8")
    local = local_state_dict(state, rules, group.tp, heads=vlm_heads(cfg), ep=group.ep)
    model = VLMManager._build_model(cfg, local, native_vision, tp=group.tp, ep=group.ep)
    return model.to(device=group.device, dtype=dtype).eval()


def copy_tp_model(model: VLMModel, cfg: VLMConfig, native_vision: bool, group) -> VLMModel:
    """A copy of this rank's shards of ``model`` on another place of its
    group (a program of ``group``, the place): a rank holds the same
    slices at every place, so the copy is the rank's own tensors on the
    place's device, over the place's ``tp`` and ``ep``."""
    local = {k: v.to(group.device, copy=True) for k, v in model.state_dict().items()}
    return VLMManager._build_model(cfg, local, native_vision, tp=group.tp, ep=group.ep).eval()


def _has_native_vision(cfg: VLMConfig, state: Mapping[str, torch.Tensor]) -> bool:
    """True when ``state`` holds exactly the native vision tower's names
    and shapes (JAX ``_subtree_matches``): the checkpoint really ships it."""
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in VLMModel(cfg).state_dict().items() if k.startswith("vision.")}
    have = {k: tuple(v.shape) for k, v in state.items() if k.startswith("vision.")}
    return bool(have) and have == want


def _image_identity(image_bytes: bytes | None, pixels) -> bytes:
    """The bytes that identify a request's image for the result and prefix
    caches: the encoded bytes (the JAX manager's key), else the decoded
    pixels' bytes, else none."""
    if image_bytes:
        return image_bytes
    return b"" if pixels is None else np.ascontiguousarray(pixels).tobytes()


def _reuse_meta(req) -> dict:
    """Per-request prefix-reuse and speculation outcomes for the response
    metadata (JAX ``_reuse_meta``): ``prefix_hit`` when the prefix cache is
    on, ``spec_accept_rate`` when the request had proposals; nothing
    otherwise (a coalesced request has neither)."""
    out: dict[str, Any] = {}
    hit = getattr(req, "prefix_hit", None)
    if hit is not None:
        out["prefix_hit"] = round(hit, 3)
    proposed = getattr(req, "spec_proposed", 0)
    if proposed > 0:
        out["spec_accept_rate"] = round(req.spec_accepted / proposed, 3)
    return out


def _truncate_on_stop(text: str, stop_sequences: Sequence[str] | None) -> tuple[str, bool]:
    """Cut at the earliest stop sequence."""
    if not stop_sequences:
        return text, False
    hits = [i for i in (text.find(s) for s in stop_sequences) if i != -1]
    if not hits:
        return text, False
    return text[: min(hits)], True


def build_config(model_dir: str, info: ModelInfo) -> VLMConfig:
    """``config.json`` of the model directory, else the ``model_info.json``
    ``extra_metadata`` fallback (JAX ``VLMManager._build_config``)."""
    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, "r", encoding="utf-8") as f:
            return VLMConfig.from_hf(json.load(f))
    meta = info.extra_metadata or {}
    if "generation_config" not in meta:
        raise FileNotFoundError(f"no config.json or generation_config metadata in {model_dir}")
    gen = dict(meta["generation_config"])
    kv = dict(meta.get("kv_cache_config", {}))
    vis = dict(meta.get("vision_config", {}))
    text_cfg = {
        "vocab_size": gen.get("vocab_size"),
        "bos_token_id": gen.get("bos_token_id"),
        "eos_token_id": gen.get("eos_token_id"),
        "pad_token_id": gen.get("pad_token_id"),
        "max_position_embeddings": gen.get("max_position_embeddings"),
        "hidden_size": kv.get("hidden_size"),
        "num_hidden_layers": kv.get("num_hidden_layers"),
        "num_attention_heads": kv.get("num_attention_heads"),
        "num_key_value_heads": kv.get("num_key_value_heads"),
        "head_dim": kv.get("head_dim"),
    }
    vision_cfg = {
        "image_size": vis.get("image_size"),
        "patch_size": vis.get("patch_size"),
        "image_mean": vis.get("mean"),
        "image_std": vis.get("std"),
    }
    raw = {
        # Absent manifest keys fall through to from_hf's defaults.
        "text_config": {k: v for k, v in text_cfg.items() if v is not None},
        "vision_config": {k: v for k, v in vision_cfg.items() if v is not None},
    }
    if gen.get("image_token_index") is not None:
        raw["image_token_index"] = gen["image_token_index"]
    return VLMConfig.from_hf(raw)
