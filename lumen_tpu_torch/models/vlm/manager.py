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

Not ported yet: the result cache and quarantine gate, the coalescing
scheduler, the int8 route's warm-up A/B (``LUMEN_VLM_Q8_ROUTE=auto``) and
its verdict file, replica fleets, the ONNX vision-graph backend, and the
process-parallel decode pool.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

from ...core.model_info import ModelInfo, load_model_info
from ...runtime.policy import get_policy, resolve_device
from ...runtime.weights import load_state_dict
from ...utils.env import env_int
from ...utils.host_decode import vlm_canvas
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
        if image_bytes:  # ValueError when the bytes do not decode
            pixels = vlm_canvas(image_bytes, self.cfg.vision.image_size)
        embeds, positions, lengths, prompt_ids, n_input, n_live = self._prepare_inputs(
            messages, pixels, add_generation_prompt
        )
        req = _Request(
            embeds=embeds, positions=positions, length=lengths, prompt_ids=prompt_ids,
            n_prompt=n_live, max_new=min(int(max_new_tokens), self.max_new_cap),
            temperature=float(temperature), top_p=float(top_p), do_sample=bool(do_sample),
            repetition_penalty=float(repetition_penalty), generator=self._next_generator(),
        )
        return req, n_input

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
        manager's argument)."""
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
            **_spec_meta(req),
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
        first_emit_s: float | None = None
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
                if first_emit_s is None:
                    first_emit_s = time.perf_counter()
                yield GenerationChunk(text=delta, tokens=[tok])
        if final_text is None:
            final_text = self.tokenizer.decode(tokens)
        if final_text.startswith(emitted) and len(final_text) > len(emitted):
            tail = final_text[len(emitted) :]
            emitted = final_text
            if first_emit_s is None:
                first_emit_s = time.perf_counter()
            yield GenerationChunk(text=tail, tokens=[])
        dt_ms = (time.perf_counter() - t0) * 1e3
        meta = {
            "finish_reason": finish,
            "generated_tokens": len(tokens),
            "input_tokens": n_input,
            "generation_time_ms": round(dt_ms, 2),
        }
        if tokens:
            meta["tokens_per_second"] = round(len(tokens) / max(dt_ms / 1e3, 1e-9), 2)
        if first_emit_s is not None:
            meta["ttft_ms"] = round((first_emit_s - t0) * 1e3, 2)
        meta.update(_spec_meta(req))
        yield GenerationChunk(text="", tokens=[], is_final=True, metadata=meta)


def _spec_meta(req: _Request) -> dict:
    """``spec_accept_rate`` of a request that had speculative proposals
    (JAX ``_reuse_meta``); nothing otherwise."""
    if req.spec_proposed > 0:
        return {"spec_accept_rate": round(req.spec_accepted / req.spec_proposed, 3)}
    return {}


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
