"""The system under test: caption serving through the program's
``VLMManager.generate_stream``, the call ``VlmService`` makes, on the
default continuous scheduler, built as the app's ``cuda_h100_1`` preset
builds it (its slots and prompt buckets, read from the program's presets
at run time; the manager's defaults for everything else).

A closed loop of callers, each a thread that sends a request and reads
its stream to the end before it sends the next. The callers start in
set-up, and the window opens once the load is steady: every slot
decoding and a request queued behind each. The benchmark's clock stamps
when each request was due, when it was sent, and when each token
arrived.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .tokenizer import WordTokenizer

#: the preset whose VLM settings the cells serve
PRESET = "cuda_h100_1"
#: the longest set-up may wait for the load to become steady
STEADY_WAIT_S = 300.0


@dataclass
class Record:
    index: int
    text: str
    max_tokens: int
    due: float
    repetition_penalty: float = 1.0
    sent: float | None = None
    first: float | None = None
    #: ``(arrival time, tokens)`` of each streamed chunk
    chunks: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    finish: str | None = None
    done: float | None = None
    error: str | None = None


def photo(seed: int, size: int) -> np.ndarray:
    """A unique uint8 ``[size, size, 3]`` photo in host memory, as the
    service hands the manager a decoded one."""
    raw = bytearray(np.random.default_rng(seed).bytes(size * size * 3))
    return np.frombuffer(raw, dtype=np.uint8).reshape(size, size, 3)


class System:
    """One manager over given weights, with its warm-up and its callers."""

    def __init__(self, cfg: dict, state: dict, device):
        from lumen_tpu_torch.app.presets import PRESETS
        from lumen_tpu_torch.models.vlm import ChatMessage, VLMConfig, VLMManager

        preset = PRESETS[PRESET]
        self.ChatMessage = ChatMessage
        self.vcfg = VLMConfig.from_hf(cfg)
        self.tok = WordTokenizer(self.vcfg.decoder.vocab_size)
        self.device = torch.device(device)
        self.size = self.vcfg.vision.image_size
        self.mgr = VLMManager(
            self.vcfg, state, self.tok, device=device, dtype=cfg["dtype"], name=cfg["name"],
            prefill_buckets=tuple(preset.vlm_prefill_buckets), gen_slots=preset.vlm_gen_batch,
            gen_batch_size=preset.vlm_gen_batch, gen_batch_latency_ms=preset.max_batch_latency_ms,
        )
        self.slots = preset.vlm_gen_batch
        self.block = self.mgr.gen_block
        self.buckets = list(self.mgr.prefill_buckets)
        self.chunk = self.mgr.engine.prefill_chunk

    def gauges(self) -> dict:
        """The engine's gauges, and the paged attention kernel's launches
        counted by the program (``paged_launches``)."""
        from lumen_tpu_torch.ops.attention import PAGED

        return dict(self.mgr.engine.gauges(), paged_launches=PAGED.launches)

    def close(self) -> None:
        self.mgr.close()
        self.mgr = None

    def serve(self, rec: Record, photo_seed: int, halt: threading.Event) -> None:
        """Send one request and read its stream to the end, or until
        ``halt`` (the stream is then closed, which frees its slot)."""
        rec.sent = time.perf_counter()
        gen = None
        try:
            pixels = photo(photo_seed, self.size)
            gen = self.mgr.generate_stream(
                [self.ChatMessage("user", rec.text)], pixels, max_new_tokens=rec.max_tokens,
                repetition_penalty=rec.repetition_penalty,
            )
            for chunk in gen:
                t = time.perf_counter()
                if chunk.is_final:
                    rec.finish = chunk.metadata.get("finish_reason", "length")
                    rec.done = t
                    break
                if chunk.tokens:
                    if rec.first is None:
                        rec.first = t
                    rec.chunks.append((t, len(chunk.tokens)))
                    rec.tokens.extend(chunk.tokens)
                if halt.is_set():
                    break
        except Exception as e:  # noqa: BLE001 - a failed request is counted, not raised
            # After the close the manager is shut, which ends every stream
            # still open: that is the benchmark's cancel, not a failure.
            if not halt.is_set():
                rec.error = repr(e)
        finally:
            if gen is not None:
                gen.close()

    def warm(self, traffic) -> int:
        """Every shape the mix sends: for each prompt bucket its requests
        reach, one request through the prefill lane and a decode block (a
        block always steps every slot, so one request warms its shapes).
        Returns the requests sent."""
        from .tokenizer import prompt_ids

        def bucket_of(text: str) -> int:
            n = len(prompt_ids(self.tok, text, self.vcfg.image_token_id))
            return next(b for b in self.buckets if n <= b)

        lengths = {bucket_of(traffic.request(i).text) for i in range(traffic.n)}
        halt = threading.Event()
        sent = 0
        for bucket in sorted(lengths):
            # the bucket's longest prompt: the ids add the image and the
            # transcript's two role words to the text's words
            text = " ".join(f"warm{j}" for j in range(bucket - 3))
            if bucket_of(text) != bucket:
                raise RuntimeError(f"warm-up prompt misses bucket {bucket}")
            recs = [Record(index=-1, text=text, max_tokens=self.block, due=0.0,
                           repetition_penalty=traffic.repetition_penalty)]
            threads = [threading.Thread(target=self.serve, args=(r, 7919 + k, halt)) for k, r in enumerate(recs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            errors = [r.error for r in recs if r.error]
            if errors:
                raise RuntimeError(f"warm-up failed: {errors[0]}")
            sent += len(recs)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return sent

    def start(self, traffic) -> None:
        """Start the mix's callers (set-up): each sends a request, reads its
        stream to the end and sends the next, until the window closes."""
        self._records, self._halt = [], threading.Event()
        self._t1 = float("inf")
        lock = threading.Lock()
        counter = iter(range(1 << 40))

        def client():
            while time.perf_counter() < self._t1 and not self._halt.is_set():
                with lock:
                    i = next(counter)
                    req = traffic.request(i)
                    rec = Record(index=i, text=req.text, max_tokens=req.max_tokens, due=time.perf_counter(),
                                 repetition_penalty=req.repetition_penalty)
                    self._records.append(rec)
                self.serve(rec, traffic.photo_seed(i), self._halt)

        self._clients = traffic.clients
        self._threads = [threading.Thread(target=client, daemon=True) for _ in range(traffic.clients)]
        for t in self._threads:
            t.start()

    def wait_steady(self, timeout_s: float = STEADY_WAIT_S) -> float:
        """Block until the load is steady: every slot decoding (or every
        caller, where there are fewer) and each caller beyond the slots
        with a request queued. Returns the seconds waited."""
        t = time.perf_counter()
        live, queued = min(self.slots, self._clients), max(0, self._clients - self.slots)
        while True:
            g = self.gauges()
            if g["slots_live"] >= live and g["queue_depth"] >= queued:
                return time.perf_counter() - t
            failed = [r.error for r in self._records if r.error]
            if failed:
                raise RuntimeError(f"a request failed before the window: {failed[0]}")
            if time.perf_counter() - t > timeout_s:
                raise RuntimeError(f"load not steady after {timeout_s} s: {g}")
            time.sleep(0.005)

    def run_window(self, seconds: float, tracer=None) -> dict:
        """Measure the running load for ``seconds`` (marking its ends in a
        trace started in set-up), then stop the callers and shut the
        manager. Returns the records, the window's ends, the
        engine's gauges at both ends and the trace."""
        g0 = self.gauges()
        if tracer is not None:
            tracer.mark()
        t0 = time.perf_counter()
        t1 = self._t1 = t0 + seconds
        time.sleep(max(0.0, t1 - time.perf_counter()))
        g1 = self.gauges()
        if tracer is not None:
            tracer.mark()
        trace = tracer.stop() if tracer is not None else None
        t_end = time.perf_counter()
        self._halt.set()
        self.close()
        for t in self._threads:
            t.join(timeout=120)
        return dict(records=self._records, t0=t0, t1=t1, t_end=t_end, gauges0=g0, gauges1=g1, trace=trace)
