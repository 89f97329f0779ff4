"""CLIP model manager: embeddings + zero-shot classification on a torch
device (the port of ``lumen_tpu/models/clip/manager.py``).

Business-logic layer mirroring the reference's ``CLIPModelManager``
(``packages/lumen-clip/src/lumen_clip/general_clip/clip_model.py:48-403``)
and ``BioCLIPModelManager`` (``expert_bioclip/bioclip_model.py:45-375``):

- image/text encode are batched device calls (bucketed static shapes)
  behind the port's micro-batchers, one per tower, built through the
  replica fleet (one replica: the plain batcher). A replica's mesh is a
  ``data`` axis over its cards (every card by default; ``devices=``
  names them, one card more than once if need be): the towers are
  copied onto each data place, and a batch (a multiple of the data size)
  splits into one part a place, each run on its place's copy, the rows
  gathered back in batch order (``runtime.batcher.mesh_sharded``);
- image bytes decode and resize on the shared decode pool
  (``clip_resize``); normalisation runs on the device from uint8 pixels;
- classification scores an embedding against a label-embedding matrix
  (softmax mode for curated label sets; raw-cosine mode for huge
  taxonomies, the BioCLIP behavior) on the host: a handler thread's
  device matmul would queue on the default stream behind whole batches;
- label embeddings load from the dataset's precomputed ``.npy`` or are
  computed on startup through the text tower (``clip_model.py:145-172``);
- export-only model directories (``vision.onnx`` + ``text.onnx``, e.g.
  MobileCLIP2) and ``clip_backend: graph`` serve the exported towers on
  the ONNX bridge (``graph.py``), in their exported precision.

- ``quantize="int8"`` on a native checkpoint serves the tower blocks'
  projections as ``QDense`` (W8A8 ``dynamic`` unless ``LUMEN_Q8_KERNEL``
  says ``dequant``) on the route ``_pick_quant_route`` resolves
  (``LUMEN_CLIP_Q8_ROUTE``: ``auto``, ``int8`` or ``bf16``; under
  ``auto`` with ``warmup`` a timed A/B at the top serving bucket keeps
  int8 only if it is at least as fast). On graph towers ``quantize`` is
  ignored with the JAX package's warning.
- ``mesh_axes`` with a ``model`` axis above 1 serves a native checkpoint
  tensor-parallel on the process's rank-0/worker group
  (``runtime.tp_group``): every rank places its shards by the JAX
  placement (``INT8_TP_RULES`` first when int8, then
  ``TRANSFORMER_TP_RULES``; :func:`place_tp_clip`) on every data place of
  every replica's slice of the group's places (the state sent once a
  place, on the place's plane), and every tower forward runs on every
  rank at its part's place; each place's rows come back on rank 0's
  device of the place. The label matrix and the host softmax stay on
  rank 0 (over a ``data`` axis, on place 0's copy: the softmax reads the
  gathered rows). Graph towers have no sharding rules: on a group they
  stay whole, a copy on rank 0's device of each data place of each
  replica (as the face manager's weights), and their forwards are local
  calls there, no program of the group; the workers hold and run no CLIP.
  The JAX manager replicates them over every device of the mesh instead;
  the embeddings are the same.
- a ``seq`` or ``stage`` axis above 1 keeps one copy a data place, at
  the first position of the place's block (``runtime.mesh``): the JAX
  manager replicates the towers over every device of the block and
  splits a batch over ``data`` alone, so its copies compute what one
  does. Placement is not a result: the embeddings are the same. A mesh
  with no ``data`` axis (``{seq: 2}``) serves as one place; the JAX
  manager fails there as it builds its batcher (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Literal, Sequence

import numpy as np
import torch

from ...core.model_info import ModelInfo, load_model_info
from ...ops.image import IMAGENET_MEAN, IMAGENET_STD, OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from ...ops.quant import register_route_gauges, resolve_q8_kernel, resolve_q8_route
from ...ops.quant_matmul import note_mesh_model_axis
from ...parallel.sharding import INT8_TP_RULES, TRANSFORMER_TP_RULES, local_state_dict, replicate
from ...runtime.batcher import MicroBatcher, mesh_buckets, mesh_sharded, warmup_batcher
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
from ...runtime.tp_group import place_of, run_on
from ...runtime.weights import WeightLoadError, load_state_dict
from ...utils.metrics import metrics
from .convert import convert_clip_checkpoint, quantize_clip_int8
from .modeling import CLIPConfig, CLIPModel, TowerConfig
from .tokenizer import ClipTokenizer

logger = logging.getLogger(__name__)

# Scene-classify contract: the reference's 8 hardcoded prompts and its
# label derivation (prompt minus "a photo of " minus "an ") are part of the
# observable output (``clip_model.py:90-99`` builds them, ``:355-357``
# derives the label), so clients see identical scene buckets on both
# stacks. These short strings are wire-contract constants, like proto
# field names.
SCENE_PROMPTS = [
    "a photo of a person",
    "a photo of an animal",
    "a photo of a vehicle",
    "a photo of food",
    "a photo of a building",
    "a photo of nature",
    "a photo of an object",
    "a photo of a landscape",
]
SCENE_LABELS = [
    p.replace("a photo of ", "").replace("an ", "") for p in SCENE_PROMPTS
]
DEFAULT_PROMPT_TEMPLATE = "a photo of a {}"

@dataclass
class ClassifyResult:
    labels: list[tuple[str, float]]  # (label, score) best-first


class CLIPManager:
    """One loaded CLIP model + its datasets, ready to serve."""

    def __init__(
        self,
        model_dir: str,
        dataset: str | None = None,
        dtype: str = "bfloat16",
        batch_size: int = 8,
        max_batch_latency_ms: float = 5.0,
        mesh_axes: dict[str, int] | None = None,
        classify_mode: Literal["softmax", "cosine"] = "softmax",
        warmup: bool = False,
        quantize: str | None = None,
        name_prefix: str = "clip",
        device: "str | torch.device | None" = None,
        devices: "Sequence[torch.device] | None" = None,
    ):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        self.quantize = quantize
        # Batcher/gauge name scope: "clip" for the default manager, the
        # config alias for siblings ("bioclip-image"/"bioclip-text"), so
        # two managers in one service never collide on gauges or replica
        # state keys.
        self.name_prefix = name_prefix
        self.model_dir = model_dir
        self.dataset_name = dataset
        self.classify_mode = classify_mode
        self.policy = get_policy(dtype)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.max_batch_latency_ms = max_batch_latency_ms
        # Replica fleet (LUMEN_REPLICAS / LUMEN_REPLICAS_CLIP): the host's
        # devices (or ``devices``) partition into N slices, one per replica,
        # each a data axis over its slice; ``self.mesh`` stays the primary
        # (replica-0) slice, whose place 0 embeds the labels.
        self.fleet_plan = plan_replicas("clip", mesh_axes, devices=list(devices or fleet_devices(self.device)))
        self.mesh = self.fleet_plan.meshes[0]
        #: the serving group of an ``expert`` or ``model`` axis above 1, else None
        self.tp_group = self.mesh.group
        if self.tp_group is not None and self.mesh.device != self.device:
            raise ValueError(f"the tensor-parallel group's rank 0 is on {self.mesh.device}, not {self.device}")
        note_mesh_model_axis(self.mesh.shape.get("model", 1))
        self.warmup = warmup
        self.info: ModelInfo = load_model_info(model_dir)
        # (vision, text) ClipTowerGraph when graph-served; the probed flag
        # memoizes a negative probe so non-graph models scan the dir once.
        self._graphs = None
        self._graphs_probed = False
        self.cfg = self._build_config(model_dir)
        # Deployment override for the serving-side text pad length (e.g. a
        # BERT-text model whose queries are known-short).
        tsl = self.info.extra("text_serving_length")
        if tsl:
            self.cfg = dataclasses.replace(self.cfg, text_serving_length=int(tsl))
        if self.quantize:
            # Batch embedding is bound by the products: W8A8 ("dynamic")
            # by default, unlike the VLM decoder's "dequant".
            self.cfg = dataclasses.replace(
                self.cfg, weight_quant=self.quantize, weight_quant_kernel=resolve_q8_kernel("dynamic")
            )
        self.model_id = self.info.name
        #: serving route actually in use ("bf16" | "int8"): int8 is opt-in
        #: (``quantize``) and may fall back at the warm-up A/B
        self.quant_route = "bf16"
        #: measured q8 / bf16 image-encode speed, when the A/B ran
        self.quant_speedup: float | None = None
        self._initialized = False
        self._image_batcher: MicroBatcher | None = None  # or ReplicaSet (fleet)
        self._text_batcher: MicroBatcher | None = None
        # One placement per replica and data place: a CLIPModel, or the
        # graph towers' {"vision": params, "text": params} on the place's
        # device.
        self._fleet_models: list[list] | None = None
        #: replica 0's copy on each data place, and the one on place 0
        self.place_models: list = []
        self.model = None
        self.label_names: list[str] = []
        self._label_matrix: np.ndarray | None = None  # [L, D] unit-norm fp32
        #: seconds the label embeddings took at start-up (loaded or computed)
        self.label_embed_s: float | None = None
        self._temperature = 100.0

    # -- configuration ----------------------------------------------------

    def _build_config(self, model_dir: str) -> CLIPConfig:
        cfg_path = os.path.join(model_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, "r", encoding="utf-8") as f:
                raw = json.load(f)
            if "vision_config" in raw:
                return CLIPConfig.from_hf(raw)
        # openclip-style config (open_clip_config.json) — reference loader
        # distinguishes the two the same way (resources/loader.py:186-204).
        oc_path = os.path.join(model_dir, "open_clip_config.json")
        if os.path.exists(oc_path):
            with open(oc_path, "r", encoding="utf-8") as f:
                raw = json.load(f).get("model_cfg", {})
            v, t = raw.get("vision_cfg", {}), raw.get("text_cfg", {})
            return CLIPConfig(
                embed_dim=raw.get("embed_dim", 512),
                image_size=v.get("image_size", 224),
                patch_size=v.get("patch_size", 32),
                vision=TowerConfig(v.get("width", 768), v.get("layers", 12), v.get("width", 768) // 64),
                text=TowerConfig(t.get("width", 512), t.get("layers", 12), t.get("heads", 8)),
                vocab_size=t.get("vocab_size", 49408),
                context_length=t.get("context_length", 77),
            )
        # No tower config at all: an exported-ONNX repo (e.g. MobileCLIP2
        # exports, the region=other default — the reference serves these as
        # its primary dual-session path, ``onnxrt_backend.py:72-745``).
        # Derive the serving shapes from the graphs themselves.
        graphs = self._load_graphs(model_dir)
        if graphs is not None:
            vision_graph, text_graph = graphs
            vshape = next(iter(vision_graph.module.input_shapes().values()), ())
            size = vshape[-1] if len(vshape) == 4 and isinstance(vshape[-1], int) and vshape[-1] > 0 else 224
            return CLIPConfig(
                embed_dim=int(self.info.embedding_dim or 512),
                image_size=int(size),
                context_length=text_graph.context_length(77),
            )
        raise FileNotFoundError(
            f"no config.json / open_clip_config.json / onnx towers in {model_dir}"
        )

    def _load_graphs(self, model_dir: str):
        """Probe for exported vision+text towers; memoized on self (both
        outcomes, so a non-graph model scans the directory only once)."""
        if self._graphs_probed:
            return self._graphs
        self._graphs_probed = True
        from .graph import ClipTowerGraph, find_clip_onnx

        found = find_clip_onnx(model_dir, precision=self.info.extra("precision"))
        if "vision" in found and "text" in found:
            self._graphs = (
                ClipTowerGraph.from_path(found["vision"]),
                ClipTowerGraph.from_path(found["text"]),
            )
        return self._graphs

    @property
    def norm_stats(self) -> tuple[tuple[float, ...], tuple[float, ...]]:
        """Normalization stats; OpenAI-CLIP defaults unless the model name
        suggests ImageNet stats (reference heuristic, loader.py:101-139)."""
        name = self.info.name.lower()
        if "bioclip" in name or "imagenet" in (self.info.extra("norm", "") or ""):
            return IMAGENET_MEAN, IMAGENET_STD
        return OPENAI_CLIP_MEAN, OPENAI_CLIP_STD

    # -- initialization ---------------------------------------------------

    def _load_state(self) -> dict[str, torch.Tensor] | None:
        """The native checkpoint, or None when the graph towers serve
        (``clip_backend: graph``, or ``auto`` on a directory with towers
        and no checkpoint)."""
        backend = str(self.info.extra("clip_backend", "auto") or "auto")
        state = None
        if backend != "graph" and (self._graphs is None or backend == "native"):
            # clip_backend=native must reach for a real checkpoint even when
            # _build_config already derived a graph config (export-only dir).
            try:
                logger.info("loading CLIP weights from %s", self.model_dir)
                state = load_state_dict(self.model_dir)
            except (FileNotFoundError, WeightLoadError):
                if backend == "native" or self._load_graphs(self.model_dir) is None:
                    raise
                logger.info("no native CLIP checkpoint; serving onnx towers")
        if backend == "graph" and self._load_graphs(self.model_dir) is None:
            raise FileNotFoundError(
                f"clip_backend=graph but no vision/text onnx in {self.model_dir}"
            )
        if state is None and self.quantize:
            # Covers EVERY graph-served route (export-only dirs probed at
            # config build, clip_backend=graph, and the no-checkpoint
            # fallback above): an operator who set int8 must not attribute
            # full-precision ONNX numbers to the quantized path.
            logger.warning(
                "quantize=%s ignored: the ONNX graph path runs the exported "
                "precision as-is", self.quantize,
            )
        return state

    def _place(self, model: CLIPModel, mesh=None) -> list:
        """The serving placement of a host ``model`` on ``mesh`` (default
        the primary one): one copy a data place, or on a tensor-parallel
        group each rank's shards at each of the mesh's places (the whole
        state sent to a place on its own plane, where the place's shards
        are cut)."""
        mesh = mesh or self.mesh
        if self.tp_group is None:
            return replicate(model, mesh)
        state, dtype = model.state_dict(), self.policy.param_dtype
        return [place.run(place_tp_clip, model.cfg, state, dtype, place) for place in mesh.places]

    def _place_native(self, state: dict[str, torch.Tensor]) -> None:
        base_cfg = dataclasses.replace(self.cfg, weight_quant=None)
        model = CLIPModel(base_cfg)
        model.load_state_dict(convert_clip_checkpoint(state), strict=True)
        model = model.to(dtype=self.policy.param_dtype).eval().requires_grad_(False)
        # The exported temperature, read once (as the JAX package reads it:
        # exp in fp32 of the policy-cast logit scale).
        self._temperature = float(np.exp(np.float32(model.logit_scale.float().item())))
        if self.quantize == "int8":
            route = resolve_q8_route("LUMEN_CLIP_Q8_ROUTE")
            if route == "bf16":
                # A bf16 pin skips the quantization pass entirely.
                logger.info("CLIP quantize=int8 overridden to bf16 (LUMEN_CLIP_Q8_ROUTE); skipping quantization")
            else:
                qstate = quantize_clip_int8(model.state_dict(), include_text=self.cfg.text_arch != "bert")
                q_model = CLIPModel(self.cfg)
                q_model.load_state_dict(qstate, strict=True)
                model = self._pick_quant_route(model, q_model.to(dtype=self.policy.param_dtype).eval(), route)
            self._route_gauge_fn = register_route_gauges(self, f"clip-quant:{self.model_id}")
        if model.cfg.weight_quant is None:
            self.cfg = model.cfg
        if self.tp_group is not None:
            self._fleet_models = [self._place(model, mesh) for mesh in self.fleet_plan.meshes]
            return
        # Every replica gets its own copy of the weights on each data place.
        self._fleet_models = replicate_all(model, self.fleet_plan)

    def _pick_quant_route(self, base_model: CLIPModel, q_model: CLIPModel, route: str) -> CLIPModel:
        """Whether the int8 opt-in serves int8 (JAX ``_pick_quant_route``):
        ``route`` (``LUMEN_CLIP_Q8_ROUTE``) ``int8`` pins it; ``auto`` (the
        default; a malformed value warns and means it) serves int8 without ``warmup``
        and otherwise times both routes at the top serving bucket, one
        placement at a time (bf16 placed, timed and moved off the device,
        then int8), keeping int8 only if it is at least as fast. Returns
        the model to serve and sets ``quant_route`` / ``quant_speedup``."""
        if route == "int8" or not self.warmup:
            self.quant_route = "int8"
            return q_model
        device = self.mesh.device
        placed = self._place(base_model)
        t_bf16 = self._time_image_encode(placed)
        if self.tp_group is None:
            base_model.to("cpu")
        del placed
        if device.type == "cuda":
            torch.cuda.empty_cache()
        placed = self._place(q_model)
        t_q8 = self._time_image_encode(placed)
        self.quant_speedup = t_bf16 / max(t_q8, 1e-9)
        if self.quant_speedup >= 1.0:
            logger.info("CLIP int8 route confirmed: %.3fx bf16 at the top batch bucket", self.quant_speedup)
            self.quant_route = "int8"
            return q_model
        del placed
        logger.warning(
            "CLIP int8 route DISABLED: the warm-up A/B measured q8 at %.3fx bf16; serving bf16 instead. "
            "Pin LUMEN_CLIP_Q8_ROUTE=int8 to force.", self.quant_speedup,
        )
        metrics.count("clip_q8_fallbacks")
        q_model.to("cpu")
        del q_model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return base_model

    @torch.inference_mode()
    def _time_image_encode(self, models: list) -> float:
        """Best-of-3 wall time of one image encode at the top serving bucket,
        split over the data places as serving splits it (``models``: one
        copy a place; normalization included, ended by a synchronization
        of every place's device), after a settling call."""
        bucket = mesh_buckets(self.batch_size, len(models))[-1]
        size = self.cfg.image_size
        mean, std = self.norm_stats
        devices = self.mesh.data_devices
        inputs = [
            (torch.zeros((bucket // len(models), size, size, 3), dtype=torch.uint8, device=d),
             torch.tensor(mean, device=d), torch.tensor(std, device=d))
            for d in devices
        ]

        def run() -> None:
            for model, (pixels, mu, sigma) in zip(models, inputs):
                run_on(place_of(model), encode_images_native, model, pixels, mu, sigma, self.policy.compute_dtype)
            for d in {d for d in devices if d.type == "cuda"}:
                torch.cuda.synchronize(d)

        run()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        return min(times)

    def _place_graphs(self) -> None:
        """Graph towers: the exporter's own float32 weights on every data
        place of every replica (on a group, rank 0's device of each);
        serving shapes reconciled with the exports' STATIC shapes even
        when a config.json supplied the cfg (a text export built at 52
        tokens cannot run 77-padded ids; the vision export's input side
        fixes the resize target)."""
        vision_graph, text_graph = self._graphs
        vshape = next(iter(vision_graph.module.input_shapes().values()), ())
        updates: dict = {}
        if len(vshape) == 4 and isinstance(vshape[-1], int) and vshape[-1] > 0:
            updates["image_size"] = int(vshape[-1])
        updates["context_length"] = text_graph.context_length(self.cfg.context_length)
        # A static export runs at exactly its built length — any pad cap
        # (config- OR model_info-supplied) shorter than that would feed
        # shapes the graph's fixed ops can't take.
        updates["text_serving_length"] = None
        # Every replica and data place gets its copy BEFORE the host weights
        # are released (there is nothing to re-place from afterwards).
        self._fleet_models = replicate_all(
            lambda device: {"vision": vision_graph.module.place(device), "text": text_graph.module.place(device)},
            self.fleet_plan,
        )
        size = updates.get("image_size", self.cfg.image_size)
        dim = vision_graph.probe_dim(np.zeros((1, 3, size, size), np.float32), self._fleet_models[0][0]["vision"])
        if dim != self.cfg.embed_dim:
            logger.info("graph towers emit %d-d embeddings (config said %d)", dim, self.cfg.embed_dim)
            updates["embed_dim"] = dim
        self.cfg = dataclasses.replace(self.cfg, **updates)
        # The forwards only need the graph TOPOLOGY; drop the host-RAM
        # weight copies now that the devices hold them.
        vision_graph.module.release_weights()
        text_graph.module.release_weights()
        # ONNX exports don't ship the temperature (the reference session
        # path's ``get_temperature`` is optional, ``base.py:254-270``):
        # model_info ``extra.logit_scale``, else the CLIP-standard 100.
        extra = self.info.extra("logit_scale")
        self._temperature = float(np.exp(float(extra))) if extra is not None else 100.0

    def initialize(self) -> None:
        if self._initialized:
            return
        state = self._load_state()
        if state is not None:
            self._place_native(state)
        else:
            self._place_graphs()
        self.place_models = self._fleet_models[0]
        self.model = self.place_models[0]
        mean, std = self.norm_stats
        compute_dtype = self.policy.compute_dtype
        # Per-device normalisation constants, made once (read-only, so two
        # places on one device share them): a host->device copy inside the
        # batched call would be a synchronous one.
        stats = {
            d: (torch.tensor(mean, device=d), torch.tensor(std, device=d))
            for m in self.fleet_plan.meshes for d in m.data_devices
        }

        if state is not None:

            def encode_images(model, pixels_u8):
                # pixels_u8: [B, S, S, 3] uint8 on the model's device;
                # normalize + cast on the device. fp32 unit-norm out.
                return run_on(place_of(model), encode_images_native, model, pixels_u8, *stats[pixels_u8.device],
                              compute_dtype)

            def encode_texts(model, ids):
                return run_on(place_of(model), encode_texts_native, model, ids)

        else:
            vision_graph, text_graph = self._graphs

            # The towers run in their exported float32 and the embeddings
            # are L2-normalized on the device, as the reference session
            # path normalizes them (``onnxrt_backend.py:486-489``).
            @torch.inference_mode()
            def encode_images(params, pixels_u8):
                mu, sigma = stats[pixels_u8.device]
                x = (pixels_u8.float() / 255.0 - mu) / sigma
                z = vision_graph(params["vision"], x.permute(0, 3, 1, 2)).float()
                return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-12)

            @torch.inference_mode()
            def encode_texts(params, ids):
                z = text_graph(params["text"], ids.long()).float()
                return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-12)

        self.tokenizer = ClipTokenizer.from_model_dir(self.model_dir, self.cfg.serving_text_length)
        self._encode_images = encode_images
        self._encode_texts = encode_texts

        dp = self.mesh.shape.get("data", 1)
        buckets = mesh_buckets(self.batch_size, dp)
        pin = self.device.type == "cuda"

        # Batcher fns DISPATCH and return the un-fetched device tensors: the
        # MicroBatcher's fetch worker does the device->host copies of a
        # batch, so the next batch stacks/copies/launches while this one
        # computes. Each data place of each replica closes over ITS copy of
        # the weights; build_fleet hands back the plain single batcher when
        # the plan is one replica, a routed ReplicaSet otherwise. The
        # closures double as the fleet's revive hook.
        def build_image(rid, mesh):
            models = self._fleet_models[rid or 0]
            return MicroBatcher(
                mesh_sharded([lambda pixels, n, _m=m: self._encode_images(_m, pixels) for m in models], mesh),
                max_batch=buckets[-1],
                max_latency_ms=self.max_batch_latency_ms,
                buckets=buckets,
                name=batcher_name(f"{self.name_prefix}-image", rid),
                replica=None if rid is None else f"r{rid}",
                pin_memory=pin,
            ).start()

        def build_text(rid, mesh):
            models = self._fleet_models[rid or 0]
            return MicroBatcher(
                mesh_sharded([lambda ids, n, _m=m: self._encode_texts(_m, ids) for m in models], mesh),
                max_batch=buckets[-1],
                max_latency_ms=self.max_batch_latency_ms,
                buckets=buckets,
                name=batcher_name(f"{self.name_prefix}-text", rid),
                replica=None if rid is None else f"r{rid}",
                pin_memory=pin,
            ).start()

        self._image_batcher = build_fleet(self.fleet_plan, f"{self.name_prefix}-image", build_image)
        self._text_batcher = build_fleet(self.fleet_plan, f"{self.name_prefix}-text", build_text)

        self._load_label_embeddings()
        if self.warmup:
            self._warmup(buckets)
        self._initialized = True
        logger.info(
            "CLIP ready: %s embed_dim=%d labels=%d on %s",
            self.model_id,
            self.cfg.embed_dim,
            len(self.label_names),
            self.mesh,
        )

    def _warmup(self, buckets: list[int]) -> None:
        """Run every batch bucket once at startup so first requests don't
        pay a bucket's first-call cost. Runs through the batchers' own
        callables."""
        t0 = time.perf_counter()
        size = self.cfg.image_size
        for b in each_batcher(self._image_batcher):
            warmup_batcher(b, lambda n: np.zeros((n, size, size, 3), np.uint8))
        for b in each_batcher(self._text_batcher):
            warmup_batcher(
                b, lambda n: np.zeros((n, self.cfg.serving_text_length), np.int32)
            )
        logger.info("warmup: %d bucket(s) run in %.1fs", len(buckets), time.perf_counter() - t0)

    def close(self) -> None:
        if self._image_batcher:
            self._image_batcher.close()
        if self._text_batcher:
            self._text_batcher.close()
        if fn := getattr(self, "_route_gauge_fn", None):
            metrics.unregister_gauges(f"clip-quant:{self.model_id}", fn)
        self._initialized = False

    def topology(self) -> dict[str, str]:
        """Device topology + replica layout for the capability ``extra``."""
        return topology_extra(self.mesh, self._image_batcher, self._text_batcher)

    # -- datasets ---------------------------------------------------------

    def _load_label_embeddings(self) -> None:
        if not self.dataset_name or not self.info.datasets:
            return
        ds = self.info.datasets.get(self.dataset_name)
        if ds is None:
            logger.warning("dataset %r not in model_info; classify disabled", self.dataset_name)
            return
        t0 = time.perf_counter()
        labels_path = os.path.join(self.model_dir, ds.labels)
        with open(labels_path, "r", encoding="utf-8") as f:
            raw_labels = json.load(f)
        self.label_names = [self._label_text(entry) for entry in raw_labels]
        emb_path = os.path.join(self.model_dir, ds.embeddings)
        if os.path.exists(emb_path):
            mat = np.load(emb_path, mmap_mode="r")
            mat = np.asarray(mat, np.float32)
            # Axis-order autodetect (reference: bioclip_model.py:287-309).
            if mat.shape[0] != len(self.label_names) and mat.shape[-1] == len(self.label_names):
                mat = mat.T
            if mat.shape[0] != len(self.label_names):
                raise ValueError(
                    f"label embedding shape {mat.shape} does not match "
                    f"{len(self.label_names)} labels"
                )
        else:
            logger.info("no precomputed label embeddings; encoding %d labels", len(self.label_names))
            mat = self._compute_label_embeddings(self.label_names)
        mat = mat / np.maximum(np.linalg.norm(mat, axis=-1, keepdims=True), 1e-12)
        self._label_matrix = np.ascontiguousarray(mat, np.float32)
        self.label_embed_s = time.perf_counter() - t0

    @staticmethod
    def _label_text(entry) -> str:
        """Dataset label entries are either plain strings or BioCLIP-style
        ``[[taxonomy...], common_name]`` pairs (reference name extraction,
        ``bioclip_model.py:192-217``)."""
        if isinstance(entry, str):
            return entry
        if isinstance(entry, (list, tuple)) and len(entry) == 2:
            taxonomy, common = entry
            if isinstance(common, str) and common:
                return common
            if isinstance(taxonomy, (list, tuple)) and taxonomy:
                return str(taxonomy[-1])
        return str(entry)

    def _compute_label_embeddings(self, labels: list[str], template: str = DEFAULT_PROMPT_TEMPLATE) -> np.ndarray:
        out = []
        bs = max(self.batch_size, 16)
        for i in range(0, len(labels), bs):
            chunk = [template.format(l) for l in labels[i : i + bs]]
            ids = torch.from_numpy(self.tokenizer.encode_batch(chunk)).to(self.mesh.device)
            out.append(self._encode_texts(self.model, ids).cpu().numpy())
        return np.concatenate(out, axis=0)

    # -- inference API ----------------------------------------------------

    def _cache_ns(self, task: str, *qualifiers: str) -> str:
        """Result-cache namespace: qualified by the compute dtype (the JAX
        package's names, ``bfloat16`` / ``float32``) and the quant route;
        image tasks add the decode-policy qualifier."""
        return make_namespace(
            "clip", task, self.model_id, self.info.version,
            str(self.policy.compute_dtype).removeprefix("torch."), self.quant_route,
            *qualifiers,
        )

    def encode_image(self, image_bytes: bytes) -> np.ndarray:
        """Single image bytes -> unit-norm fp32 embedding (batched under the
        hood with concurrent callers). Content-addressed cache first: the
        sha256 runs on the RAW bytes, so a hit (or a coalesced duplicate
        in flight) skips decode pool AND batcher entirely. The same content
        address is the poison-quarantine gate, and it rides the batcher
        submit as the fingerprint bisection quarantines on. On a miss,
        decode+resize run on the shared decode pool — the calling (gRPC
        handler) thread only waits. Every hit returns a private copy."""
        self._ensure_ready()
        from ...ops.image import DECODE_POLICY

        payload = bytes(image_bytes)
        ns = self._cache_ns("image_embed", DECODE_POLICY)
        key = guarded_key(ns, None, payload)
        return get_result_cache().get_or_compute(
            ns,
            None,
            payload,
            lambda: self._encode_image_uncached(image_bytes, fingerprint=key),
            clone=np.copy,
            key=key,
        )

    def _encode_image_uncached(
        self, image_bytes: bytes, fingerprint: str | None = None
    ) -> np.ndarray:
        # The "clip_resize" decode spec (scaled decode + square squash,
        # lumen_tpu_torch.utils.host_decode) runs on the shared pool — in
        # process mode a worker process writes into a shared-memory arena
        # slot, and `decoded.array` is a view the batcher's collector
        # stacks from; release() recycles the slot once the batcher has
        # settled.
        size = self.cfg.image_size
        decoded = get_decode_pool().run_decode(
            "clip_resize", image_bytes, {"size": size}
        )
        try:
            vec = self._image_batcher(decoded.array, fingerprint=fingerprint)
        finally:
            decoded.release()
        return self._check_vector(vec)

    def tensor_input_shape(self) -> tuple[int, int, int]:
        """The pre-decoded pixel tensor accepted on the ``tensor/raw`` wire
        path: exactly what the ``clip_resize`` decode spec produces, so
        tensor- and JPEG-path results are identical."""
        size = self.cfg.image_size
        return (size, size, 3)

    def encode_image_tensor(self, pixels: np.ndarray, raw: bytes | None = None) -> np.ndarray:
        """Pre-decoded tensor -> unit-norm embedding: the zero-decode
        serving path (no decode pool, no resize). ``raw`` is the wire
        payload backing ``pixels``; the result cache keys on sha256 of it
        under a ``tensor``-qualified namespace."""
        self._ensure_ready()
        size = self.cfg.image_size
        if pixels.dtype != np.uint8 or tuple(pixels.shape) != (size, size, 3):
            raise ValueError(
                f"tensor input must be uint8 of shape ({size}, {size}, 3); "
                f"got {pixels.dtype} {tuple(pixels.shape)}"
            )
        payload = raw if raw is not None else pixels.tobytes()
        ns = self._cache_ns("image_embed", "tensor")
        key = guarded_key(ns, None, payload)
        return get_result_cache().get_or_compute(
            ns,
            None,
            payload,
            lambda: self._check_vector(
                self._image_batcher(np.ascontiguousarray(pixels), fingerprint=key)
            ),
            clone=np.copy,
            key=key,
        )

    def encode_text(self, text: str) -> np.ndarray:
        self._ensure_ready()
        payload = text.encode("utf-8")
        ns = self._cache_ns("text_embed")
        key = guarded_key(ns, None, payload)
        return get_result_cache().get_or_compute(
            ns,
            None,
            payload,
            lambda: self._encode_text_uncached(text, fingerprint=key),
            clone=np.copy,
            key=key,
        )

    def _encode_text_uncached(self, text: str, fingerprint: str | None = None) -> np.ndarray:
        ids = self.tokenizer.encode_batch([text])[0]
        vec = self._text_batcher(ids, fingerprint=fingerprint)
        return self._check_vector(vec)

    def classify_image(self, image_bytes: bytes, top_k: int = 5) -> ClassifyResult:
        self._ensure_ready()
        if self._label_matrix is None:
            raise RuntimeError("no dataset loaded; classification unavailable")
        vec = self.encode_image(image_bytes)
        return self._classify_vector(vec, self.label_names, self._label_matrix, top_k)

    def classify_scene(self, image_bytes: bytes, top_k: int = 3) -> ClassifyResult:
        self._ensure_ready()
        if not hasattr(self, "_scene_matrix"):
            # The full prompts embed verbatim (template already baked in);
            # labels are their reference-derived short forms.
            mat = self._compute_label_embeddings(SCENE_PROMPTS, template="{}")
            self._scene_matrix = mat / np.maximum(np.linalg.norm(mat, axis=-1, keepdims=True), 1e-12)
        vec = self.encode_image(image_bytes)
        # Reference scene scoring is a plain softmax over raw cosine
        # similarities (``clip_model.py:344-350``) — no logit-scale
        # temperature, unlike classify_image.
        return self._classify_vector(
            vec, SCENE_LABELS, self._scene_matrix, top_k, temperature=1.0
        )

    def _classify_vector(
        self,
        vec: np.ndarray,
        names: list[str],
        matrix: np.ndarray,
        top_k: int,
        temperature: float | None = None,
    ) -> ClassifyResult:
        sims = matrix @ np.asarray(vec, np.float32)  # cosine: both unit-norm
        top_k = min(top_k, len(names))
        idx = np.argpartition(-sims, top_k - 1)[:top_k]
        idx = idx[np.argsort(-sims[idx])]
        if self.classify_mode == "cosine" and temperature is None:
            # Raw similarity scores (BioCLIP large-taxonomy behavior). An
            # explicitly pinned temperature (the scene path's 1.0) always
            # means softmax — even on a cosine-mode manager.
            scores = sims[idx]
        else:
            # Temperature-scaled stable softmax over ALL labels
            # (reference: clip_model.py:232-317).
            if temperature is None:
                temperature = self.temperature()
            logits = sims * temperature
            logits -= logits.max()
            probs = np.exp(logits)
            probs /= probs.sum()
            scores = probs[idx]
        return ClassifyResult(labels=[(names[i], float(s)) for i, s in zip(idx, scores)])

    # -- utils ------------------------------------------------------------

    def alive(self) -> bool:
        """False until initialized, and once a tensor-parallel group's
        worker rank died: the service's ``Health``."""
        return self._initialized and (self.tp_group is None or self.tp_group.alive())

    def _ensure_ready(self) -> None:
        if not self._initialized:
            raise RuntimeError("CLIPManager.initialize() not called")

    @staticmethod
    def _check_vector(vec: np.ndarray) -> np.ndarray:
        vec = np.asarray(vec, np.float32)
        if not np.isfinite(vec).all():
            raise ValueError("model produced non-finite embedding")
        n = np.linalg.norm(vec)
        if n < 1e-6:
            raise ValueError("model produced zero-norm embedding")
        return vec / n

    def temperature(self) -> float:
        """Exported logit scale (exp'd), read at initialisation. Graph-served
        towers carry no logit_scale param: model_info ``extra.logit_scale``,
        then the CLIP-standard 100."""
        return self._temperature


@torch.inference_mode()
def encode_images_native(model: CLIPModel, pixels_u8, mu, sigma, dtype):
    """The image tower on uint8 pixels (a program of every rank on a
    tensor-parallel group): normalize, cast, encode; fp32 unit-norm."""
    x = (pixels_u8.float() / 255.0 - mu) / sigma
    return model.encode_image(x.to(dtype))


@torch.inference_mode()
def encode_texts_native(model: CLIPModel, ids):
    """The text tower on token ids; fp32 unit-norm."""
    return model.encode_text(ids.long())


def clip_heads(cfg: CLIPConfig):
    """``(heads, kv_heads, head_dim)`` of the tower block a CLIP parameter
    belongs to (``parallel.sharding.HeadLayout``)."""

    def heads(name: str):
        for prefix, t in (("vision.blocks.", cfg.vision), ("text.blocks.", cfg.text)):
            if name.startswith(prefix) and ".attn." in name:
                return t.heads, t.heads, t.width // t.heads
        return None

    return heads


def place_tp_clip(cfg: CLIPConfig, state: dict, dtype, group) -> CLIPModel:
    """One rank's shards of a tensor-parallel CLIP (a program of
    ``group``): the rank's slice of ``state`` (``INT8_TP_RULES`` first for
    int8 towers, then ``TRANSFORMER_TP_RULES``, on a model axis; whole
    heads; an expert axis, which CLIP has nothing to split over, leaves
    the towers whole), built, cast to ``dtype`` and placed on the rank's
    device. Notes the model axis for the int8 routing rule on this rank."""
    note_mesh_model_axis(group.tp.size)
    rules = (INT8_TP_RULES if cfg.weight_quant == "int8" else []) + TRANSFORMER_TP_RULES
    rules = rules if group.tp.size > 1 else []
    local = local_state_dict(state, rules, group.tp, heads=clip_heads(cfg))
    with torch.device("meta"):
        model = CLIPModel(cfg, tp=group.tp)
    model.load_state_dict(local, strict=True, assign=True)
    return model.to(device=group.device, dtype=dtype).eval().requires_grad_(False)
