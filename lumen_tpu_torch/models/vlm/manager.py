"""VLM manager: caption/chat generation on the paged continuous engine
(the Model Manager layer of ``lumen_tpu/models/vlm/manager.py``).

``VLMManager.from_model_dir`` loads a model directory as the JAX manager
does (``model_info.json``, ``config.json`` or the manifest's
``extra_metadata`` fallback, safetensors or torch checkpoints under
HF/FastVLM or native names, ``tokenizer.json`` and the chat template of
``tokenizer_config.json``); the constructor takes a configuration, a
``state_dict`` and a tokenizer object directly. A request carries its
image as encoded bytes (``image_bytes=``, decoded and letterboxed on the
host in the caller's thread) or as decoded pixels (``pixels``). The
manager renders and tokenizes the prompt, runs the prepare step on the
device (normalize -> vision tower -> token embed -> image-token splice),
and submits the request to the continuous scheduler. Prompt lengths are
padded to buckets, as in the JAX package. ``quantize="int8"`` serves the
decoder's projections weight-only int8 (the pinned ``int8`` route of the
JAX manager).

Greedy ``generate`` calls go through the process's content-addressed
result cache (``runtime/result_cache.py``, ``LUMEN_CACHE_BYTES``, default
256 MiB) behind the quarantine gate, as in the JAX manager: a repeated
request is answered without the vision tower, prefill or decode, marked
``cached``. A manager built from a ``state_dict`` has no model revision
to key the cache on and computes every request; ``from_model_dir`` gives
it one. With ``LUMEN_VLM_PREFIX_BYTES`` set, each request carries its
prompt's content identity for the engine's prefix KV cache.

Not ported yet: the coalescing scheduler, the int8 route's warm-up A/B
(``LUMEN_VLM_Q8_ROUTE=auto``) and its verdict file, replica fleets, the
ONNX vision-graph backend, and the process-parallel decode pool.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

from ...core.model_info import ModelInfo, load_model_info
from ...runtime.decode_pool import get_decode_pool
from ...runtime.policy import get_policy, resolve_device
from ...runtime.quarantine import guarded_key
from ...runtime.result_cache import get_result_cache, make_namespace
from ...runtime.weights import load_state_dict
from ...utils.env import env_int
from ...utils.host_decode import DECODE_POLICY
from ...utils.metrics import metrics
from .chat import ChatMessage, VlmTokenizer
from .continuous import ContinuousScheduler, _Request
from .convert import convert_vlm_checkpoint, quantize_decoder_int8
from .generate import Generator
from .modeling import VLMConfig, VLMModel, merge_image_embeddings
from .paged_kv import DEFAULT_PAGE_SIZE, resolve_pool_pages

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


class VLMManager:
    """Serving entry point for one VLM on one device.

    ``device`` defaults to the card (``cuda:0``) and raises without one;
    the tests pass ``device="cpu"``. ``pool_pages`` caps the paged KV pool
    explicitly; None sizes it from the card's free memory (the whole
    slot-era footprint on the CPU). ``page_size`` / ``prefill_chunk``
    default to ``LUMEN_VLM_PAGE_SIZE`` / ``LUMEN_VLM_PREFILL_CHUNK`` (16
    / 256), the JAX engine's knobs. ``quantize="int8"`` casts the
    ``state_dict`` with the policy, then quantizes the decoder's
    projections (``convert.quantize_decoder_int8``) and serves them as
    ``QDense``; the vision tower is cast, never quantized. Speculative
    decoding is the engine's, set by ``LUMEN_VLM_SPEC_K``. ``name`` is the
    model id the service reports.
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
    ):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        self.device = resolve_device(device)
        self.policy = get_policy(dtype)
        self.quantize = quantize
        # The JAX manager's decode route name: int8 when quantized, else bf16.
        self.quant_route = "int8" if quantize else "bf16"
        self.model_id = name
        #: ``model_info.json`` of a model directory (``from_model_dir``):
        #: its version keys the result cache.
        self.info: ModelInfo | None = None
        self.gen_slots = gen_slots
        state = dict(state_dict)
        if quantize:
            cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, weight_quant=quantize))
            # Cast first so the int8 grid comes from the weights serving
            # would otherwise stream; the replaced float weights are not
            # kept (the int8 model holds no bf16 copy of its projections).
            param = self.policy.param_dtype
            state = quantize_decoder_int8({k: v.to(param) if v.is_floating_point() else v for k, v in state.items()})
        self.cfg = cfg
        self.max_seq = max_seq
        self.max_new_cap = max_new_cap
        self.tokenizer = tokenizer if isinstance(tokenizer, VlmTokenizer) else VlmTokenizer(tokenizer)
        with torch.device("meta"):
            model = VLMModel(cfg)
        model.load_state_dict(state, strict=True, assign=True)
        del state
        # QDense keeps q int8 and scale fp32 through this cast.
        self.model = model.to(device=self.device, dtype=self.policy.param_dtype).eval()
        compute = self.policy.compute_dtype
        self.compute_dtype = compute
        v = self.vision_tokens = cfg.vision.num_tokens
        # A prompt bucket is usable only if prompt + vision tokens + the
        # decode budget fit a row.
        self.prefill_buckets = [b for b in sorted(prefill_buckets) if b - 1 + v + max_new_cap + 1 <= max_seq]
        if not self.prefill_buckets:
            raise ValueError(
                f"max_seq={max_seq} too small for any prompt bucket "
                f"(+{v} vision tokens, +{max_new_cap} decode budget)"
            )
        seq_buckets = tuple(
            min(max_seq, -((b - 1 + v + max_new_cap + 1) // -64) * 64) for b in self.prefill_buckets
        )
        self.generator = Generator(self.model, cfg, max_seq, cache_dtype=compute, seq_buckets=seq_buckets)
        page_size = page_size or env_int(
            "LUMEN_VLM_PAGE_SIZE", DEFAULT_PAGE_SIZE, minimum=8, maximum=256
        )
        if pool_pages is None:
            pool_pages = resolve_pool_pages(
                cfg, page_size, gen_slots, max_seq,
                dtype_bytes=torch.finfo(compute).bits // 8, device=self.device,
            )
        self.engine = ContinuousScheduler(
            self.generator, slots=gen_slots, block=gen_block, name=name,
            page_size=page_size, pages=pool_pages, prefill_chunk=prefill_chunk,
        )
        self._mean = torch.tensor(cfg.vision.mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(cfg.vision.std, dtype=torch.float32, device=self.device)
        self._seed_lock = threading.Lock()
        self._seed = 0
        self._initialized = True

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
        **engine_kw,
    ) -> "VLMManager":
        """Serve the model directory ``model_dir`` (the JAX manager's
        loading order, ``manager.py:207-357``): ``model_info.json``, the
        configuration from ``config.json`` or the manifest's
        ``extra_metadata``, the checkpoint (``convert_vlm_checkpoint``;
        tensors keep their stored dtype until the policy cast), then the
        tokenizer and chat template. ``engine_kw`` passes ``page_size``,
        ``pool_pages`` and ``prefill_chunk`` through."""
        info = load_model_info(model_dir)
        cfg = build_config(model_dir, info)
        state = convert_vlm_checkpoint(
            load_state_dict(model_dir), tie_word_embeddings=cfg.decoder.tie_word_embeddings
        )
        mgr = cls(
            cfg, state, VlmTokenizer.from_model_dir(model_dir), device=device, dtype=dtype,
            max_seq=max_seq, max_new_cap=max_new_cap, prefill_buckets=prefill_buckets,
            gen_slots=gen_slots, gen_block=gen_block, name=info.name, quantize=quantize, **engine_kw,
        )
        mgr.info = info
        return mgr

    def close(self) -> None:
        self.engine.close()
        self._initialized = False

    def _ensure_ready(self) -> None:
        if not self._initialized:
            raise RuntimeError("VLMManager is closed")

    def kv_layout(self) -> str:
        kv = self.engine.kv
        return f"paged(page={kv.page_size},pages={kv.pages_total},slots={self.engine.n_slots})"

    def topology(self) -> dict[str, str]:
        """Device topology for the capability ``extra``: one replica on
        one device (replica fleets are not ported yet)."""
        count = torch.cuda.device_count() if self.device.type == "cuda" else 1
        return {"device": str(self.device), "device_count": str(count), "replicas": "1"}

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
        """Normalize -> vision tower -> token embed -> splice."""
        x = pixels_u8.float() / 255.0
        x = ((x - self._mean) / self._std).to(self.compute_dtype)
        vis = self.model.encode_vision(x)
        text = self.model.embed_tokens(ids).to(self.compute_dtype)
        return merge_image_embeddings(text, vis, ids, self.cfg.image_token_id, length)

    @torch.no_grad()
    def _prepare_text(self, ids, length):
        text = self.model.embed_tokens(ids).to(self.compute_dtype)
        b, s = ids.shape
        return text, torch.arange(s, device=ids.device).expand(b, s), length

    def _prepare_inputs(self, messages, pixels, add_generation_prompt: bool = True):
        has_image = pixels is not None
        ids = self._encode_prompt(messages, has_image, add_generation_prompt)
        n = len(ids)
        padded = np.full((1, self._bucket_len(n)), self.cfg.pad_token_id, np.int64)
        padded[0, :n] = ids
        prompt_ids = torch.from_numpy(padded).to(self.device)
        length = torch.tensor([n], device=self.device)
        if has_image:
            embeds, positions, lengths = self._prepare(self._pixels(pixels), prompt_ids, length)
            n_live = n - 1 + self.cfg.vision.num_tokens
        else:
            embeds, positions, lengths = self._prepare_text(prompt_ids, length)
            n_live = n
        return embeds, positions, lengths, prompt_ids, n, n_live

    def _next_generator(self) -> torch.Generator:
        with self._seed_lock:
            self._seed += 1
            seed = self._seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _make_gen_request(
        self, messages, pixels, max_new_tokens, temperature, top_p, do_sample,
        repetition_penalty, add_generation_prompt, image_bytes=None,
    ) -> tuple[_Request, int]:
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
                embeds, positions, lengths, prompt_ids, n_input, n_live = self._prepare_inputs(
                    messages, decoded.array, add_generation_prompt
                )
            finally:
                decoded.release()
        else:
            embeds, positions, lengths, prompt_ids, n_input, n_live = self._prepare_inputs(
                messages, pixels, add_generation_prompt
            )
        req = _Request(
            embeds=embeds, positions=positions, length=lengths, prompt_ids=prompt_ids,
            n_prompt=n_live, max_new=min(int(max_new_tokens), self.max_new_cap),
            temperature=float(temperature), top_p=float(top_p), do_sample=bool(do_sample),
            repetition_penalty=float(repetition_penalty), generator=self._next_generator(),
            prefix_content=self._prefix_content(prompt_ids, n_input, _image_identity(image_bytes, pixels)),
        )
        return req, n_input

    def _prefix_content(self, prompt_ids, n: int, image: bytes) -> "np.ndarray | None":
        """Content identity of the POST-SPLICE sequence for the prefix KV
        cache (JAX ``_prefix_content``): the text token ids, with the
        ``<image>`` placeholder expanded to ``V`` int64s derived from the
        image's sha256 digest (``(1<<62) | digest<<14 | position``, far
        above any vocabulary id, so a text prefix never aliases a vision
        prefix). ``image`` is the encoded bytes, or the decoded pixels'
        bytes when the caller passed pixels. None when the engine was built
        without the cache: no hashing on the hot path."""
        if self.engine.prefix is None:
            return None
        ids = prompt_ids[0, :n].cpu().numpy().astype(np.int64)
        if not image:
            return ids
        pos = np.where(ids == self.cfg.image_token_id)[0]
        if pos.size == 0:
            return ids
        i = int(pos[0])
        digest = int.from_bytes(hashlib.sha256(image).digest()[:6], "big")
        vis = (1 << 62) + (digest << 14) + np.arange(self.cfg.vision.num_tokens, dtype=np.int64)
        return np.concatenate([ids[:i], vis, ids[i + 1 :]])

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
        t0 = time.perf_counter()
        req, n_input = self._make_gen_request(
            messages, pixels, max_new_tokens, temperature, top_p, do_sample,
            repetition_penalty, add_generation_prompt, image_bytes,
        )
        row_tokens, n_gen, stopped_eos = self.engine.submit(req).result()
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

        for tok in self.engine.submit_stream(req):
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


def _image_identity(image_bytes: bytes | None, pixels) -> bytes:
    """The bytes that identify a request's image for the result and prefix
    caches: the encoded bytes (the JAX manager's key), else the decoded
    pixels' bytes, else none."""
    if image_bytes:
        return image_bytes
    return b"" if pixels is None else np.ascontiguousarray(pixels).tobytes()


def _reuse_meta(req: _Request) -> dict:
    """Per-request prefix-reuse and speculation outcomes for the response
    metadata (JAX ``_reuse_meta``): ``prefix_hit`` when the prefix cache is
    on, ``spec_accept_rate`` when the request had proposals; nothing
    otherwise."""
    out: dict[str, Any] = {}
    if req.prefix_hit is not None:
        out["prefix_hit"] = round(req.prefix_hit, 3)
    if req.spec_proposed > 0:
        out["spec_accept_rate"] = round(req.spec_accepted / req.spec_proposed, 3)
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
