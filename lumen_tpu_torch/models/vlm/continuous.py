"""Continuous batching over a paged KV pool for VLM generation (the core of
``lumen_tpu/models/vlm/continuous.py``).

- KV lives in a shared pool of pages (``paged_kv.PagedKVPool`` host
  accounting + ``Generator.init_pool`` device tensors); each row owns a
  block table that grows a page at a time and returns its pages at
  retire, so a request admits the moment a slot and its prompt's pages
  are free;
- decode attention is the paged CUDA kernel on the card, its plain
  PyTorch version on the CPU -- the tests run the same control flow;
- a burst of same-shaped arrivals prefills as ONE batched forward
  (``ADMIT_BUCKETS``), and a prompt longer than ``prefill_chunk`` goes
  through the CHUNKED PREFILL LANE, one chunk per scheduler turn, so a
  long prompt never stalls in-flight decode blocks;
- rows retire on EOS / their own budget without stopping the others; if
  the pool runs dry mid-decode the newest row is preempted and restarts
  from its prompt when that is invisible (greedy, or nothing streamed
  yet; the stream's delivered watermark is kept so nothing is sent
  twice), else it fails with the retryable :class:`PreemptionShed`;
- with ``LUMEN_VLM_SPEC_K`` > 0, SPECULATIVE DECODING: a host n-gram
  drafter (prompt lookup over the row's prompt and output) proposes up to
  K tokens per greedy row, and one verify forward over a K+1 window
  accepts the ones the model would have emitted itself. Acceptance below
  ``LUMEN_VLM_SPEC_MIN_RATE`` after 64 proposals turns it off for the
  engine's lifetime. The knobs are the JAX engine's own.

Not ported yet: the KV spill tier (preempted rows resume without
re-prefill), disaggregated-serving migration, the prefix KV cache,
telemetry, trace spans and fleet gauges. The engine's counters are plain
attributes.
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ...utils.env import env_float, env_int
from .paged_kv import DEFAULT_PAGE_SIZE, PagedKVPool

logger = logging.getLogger(__name__)

_STREAM_END = object()


class PreemptionShed(RuntimeError):
    """A sampled row that had already streamed tokens was preempted by
    KV pool exhaustion and cannot restart without splicing draws; the
    caller may retry after ``retry_after_s``."""

    retry_after_s: float = 0.5


@dataclass
class _Request:
    """One generation request: the prepared prompt (device tensors plus
    the live length as a host int), per-request generation params, the
    sampling generator for its first token, and the delivery plumbing."""

    embeds: Any  # [1, L, H]
    positions: Any  # [1, L]
    length: Any  # [1] live tokens (device)
    prompt_ids: Any  # [1, S] text ids (repetition penalty)
    n_prompt: int  # live tokens (host)
    max_new: int
    temperature: float
    top_p: float
    do_sample: bool
    repetition_penalty: float
    generator: "torch.Generator | None" = None
    future: Future = field(default_factory=Future)
    stream_q: "queue_mod.SimpleQueue | None" = None
    cancelled: bool = False
    #: carried across preemption so a restarted stream never re-delivers.
    delivered: int = 0
    #: speculative decoding tally of this request (response metadata).
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def key(self) -> tuple:
        """Requests of one shape share a batched prefill."""
        return (self.embeds.shape[1], self.prompt_ids.shape[1])


def _fail(req: _Request, err: BaseException) -> None:
    """Retire a request with an error; every retirement path goes through
    here or :func:`_retire`, so a stream consumer is never stranded."""
    if not req.future.done():
        req.future.set_exception(err)
    if req.stream_q is not None:
        req.stream_q.put(_STREAM_END)


def _retire(req: _Request, tokens: list, eos: bool) -> None:
    if not req.future.done():
        req.future.set_result((np.asarray(tokens, np.int64), len(tokens), eos))
    if req.stream_q is not None:
        req.stream_q.put(_STREAM_END)


@dataclass
class _Slot:
    request: _Request
    prompt_len: int = 0
    seq: int = 0  # admission order; preemption evicts the newest first
    tokens: list = field(default_factory=list)
    #: host mirrors for the n-gram drafter (speculative decoding only):
    #: the live TEXT prompt ids and the sampled-but-not-emitted token.
    text_toks: "list | None" = None
    pending_tok: "int | None" = None


@dataclass
class _PrefillJob:
    """One long prompt moving through the chunked prefill lane."""

    request: _Request
    caches: object = None  # contiguous [1, kvh, Lb, dh] scratch per layer
    scratch_len: int = 0
    offset: int = 0  # prompt tokens already processed
    length: int = 0  # live prompt tokens
    last_logits: object = None  # logits of the most recent chunk
    last_off: int = 0


class ContinuousScheduler:
    """Paged continuous-batching decode loop on a dedicated thread.

    ``submit`` returns a Future resolving to ``(tokens_np, n_gen, eos)``;
    :meth:`submit_stream` also yields token ids as blocks complete.
    """

    #: batched-prefill group sizes (bounded distinct batch shapes).
    ADMIT_BUCKETS = (1, 2, 4, 8)

    def __init__(
        self, generator, slots: int = 8, block: int = 8, name: str = "vlm",
        page_size: int = DEFAULT_PAGE_SIZE, pages: int | None = None,
        prefill_chunk: int | None = None,
    ):
        self.gen = generator
        self.name = name
        self.n_slots = slots
        self.block = block
        self.page_size = page_size
        max_pages = -(-generator.max_seq // self.page_size)
        if pages is None:
            pages = slots * max_pages + 1
        self.kv = PagedKVPool(pages, self.page_size, slots, max_pages)
        self.pool = generator.init_pool(slots, pages=pages, page_size=self.page_size)
        chunk = prefill_chunk or env_int("LUMEN_VLM_PREFILL_CHUNK", 256, minimum=32, maximum=4096)
        self.prefill_chunk = -(-chunk // self.page_size) * self.page_size
        # Decode sampling draws from one engine-level stream; a prefill
        # group's first token from its first request's generator.
        self._rng = torch.Generator(device=generator.device)
        self._rng.manual_seed(int.from_bytes(os.urandom(4), "big"))
        self._slots: dict[int, _Slot] = {}
        self._pending: list[_Request] = []
        self._prefill_jobs: deque[_PrefillJob] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._admit_seq = 0
        self.blocks_run = 0
        self.admitted = 0
        self.preemptions = 0
        self.chunks_run = 0
        self.preempt_redone = 0
        self.preempt_failed = 0
        self._block_s_ewma = 0.0
        # Speculative decoding: K = 0 (default) builds no drafter and
        # never runs the verify program.
        self.spec_k = env_int("LUMEN_VLM_SPEC_K", 0, minimum=0, maximum=15)
        self.spec_ngram = env_int("LUMEN_VLM_SPEC_NGRAM", 3, minimum=1, maximum=8)
        self.spec_min_rate = env_float("LUMEN_VLM_SPEC_MIN_RATE", 0.2, minimum=0.0, maximum=1.0)
        self.spec_turns = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_disabled = False
        self._thread = threading.Thread(target=self._loop, name=f"vlm-continuous-{name}", daemon=True)
        self._thread.start()

    # -- public API --------------------------------------------------------

    def submit(self, req: _Request) -> Future:
        # A request whose prompt + budget can NEVER fit (even alone) fails
        # now instead of deadlocking the admission queue later.
        need = req.n_prompt + int(req.max_new) + 1
        if not self.kv.fits(need):
            raise ValueError(
                f"request needs {need} KV tokens but the paged pool holds at most "
                f"{min(self.kv.row_capacity(), (self.kv.pages_total - 1) * self.kv.page_size)} "
                "per row; raise the pool size or lower max_new_tokens"
            )
        with self._cond:
            if self._closed:
                raise RuntimeError("continuous scheduler is closed")
            self._pending.append(req)
            self._cond.notify()
        return req.future

    def submit_stream(self, req: _Request):
        """Submit and iterate generated token ids as they decode."""
        req.stream_q = queue_mod.SimpleQueue()
        self.submit(req)

        def tokens():
            try:
                while True:
                    item = req.stream_q.get()
                    if item is _STREAM_END:
                        err = req.future.exception()
                        if err is not None:
                            raise err
                        return
                    yield item
            finally:
                # Consumer gone: free the slot instead of decoding to the
                # cap into an unread queue.
                req.cancelled = True

        return tokens()

    def load(self) -> int:
        return len(self._pending) + len(self._slots) + len(self._prefill_jobs)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=30)
        with self._cond:
            pending, self._pending = self._pending, []
            live, self._slots = list(self._slots.values()), {}
            jobs, self._prefill_jobs = list(self._prefill_jobs), deque()
        err = RuntimeError("continuous scheduler closed")
        for req in pending + [s.request for s in live] + [j.request for j in jobs]:
            _fail(req, err)

    # -- scheduler loop ----------------------------------------------------

    def _take_work(self) -> list[_Request]:
        """Block until there is something to do; drain admissible requests
        (chunk-lane jobs hold a slot reservation)."""
        with self._cond:
            while (
                not self._closed and not self._pending and not self._slots
                and not self._prefill_jobs
            ):
                self._cond.wait()
            if self._closed:
                return []
            free = self.n_slots - len(self._slots) - len(self._prefill_jobs)
            if free <= 0:
                return []
            take, self._pending = self._pending[:free], self._pending[free:]
            return take

    def _requeue_front(self, reqs: list[_Request]) -> None:
        if reqs:
            with self._cond:
                self._pending[:0] = reqs

    def _loop(self) -> None:
        try:
            while True:
                admit = self._take_work()
                with self._cond:
                    closed = self._closed
                if closed:
                    err = RuntimeError("continuous scheduler closed")
                    for req in admit:
                        _fail(req, err)
                    return
                live = []
                for req in admit:
                    if req.cancelled:
                        _retire(req, [], eos=False)
                    else:
                        live.append(req)
                # Page gating in arrival order; a finished chunk-lane job
                # waiting on pages gets its need reserved first so short
                # arrivals cannot starve it.
                placeable, deferred = [], []
                budget = self.kv.pages_free - self._lane_reserved_pages()
                for req in live:
                    need = self.kv.pages_for(req.n_prompt + 1)
                    if deferred or need > budget:
                        deferred.append(req)
                    else:
                        budget -= need
                        placeable.append(req)
                self._requeue_front(deferred)
                direct = []
                for req in placeable:
                    if req.embeds.shape[1] > self.prefill_chunk:
                        self._prefill_jobs.append(self._start_chunk_job(req))
                    else:
                        direct.append(req)
                for group in self._admit_groups(direct):
                    try:
                        self._admit_group(group)
                    except Exception as e:  # noqa: BLE001 - fail ONE group
                        logger.exception("admission of %d request(s) failed", len(group))
                        for req in group:
                            _fail(req, e)
                self._advance_prefill_lane()
                if self._slots:
                    self._run_block()
        except BaseException as e:  # noqa: BLE001 - never strand callers
            logger.exception("continuous scheduler loop died")
            with self._cond:
                self._closed = True
                pending, self._pending = self._pending, []
                live, self._slots = list(self._slots.values()), {}
                jobs, self._prefill_jobs = list(self._prefill_jobs), deque()
            for req in pending + [s.request for s in live] + [j.request for j in jobs]:
                _fail(req, RuntimeError(f"continuous scheduler died: {e!r}"))
            if not isinstance(e, Exception):
                raise

    def _free_slot(self) -> int:
        for i in range(self.n_slots):
            if i not in self._slots:
                return i
        raise RuntimeError("no free slot (scheduler bug: admission overran pool)")

    def _admit_groups(self, reqs: list[_Request]) -> list[list[_Request]]:
        """Same-shape requests, chunked to ADMIT_BUCKETS sizes."""
        by_shape: dict[tuple, list[_Request]] = {}
        for req in reqs:
            by_shape.setdefault(req.key, []).append(req)
        groups = []
        for group in by_shape.values():
            while group:
                k = max(b for b in self.ADMIT_BUCKETS if b <= len(group))
                groups.append(group[:k])
                group = group[k:]
        return groups

    def _admit_kv_len(self, span: int) -> int:
        """Prefill-scratch length: the generator's KV bucket covering the
        span, rounded up to a page multiple (it scatters into pages)."""
        kv_len = next((b for b in self.gen.seq_buckets if b >= span), self.gen.max_seq)
        kv_len = max(kv_len, span)
        return -(-kv_len // self.page_size) * self.page_size

    def _params(self, reqs: list[_Request]) -> tuple:
        dev = self.gen.device
        return (
            torch.tensor([r.temperature for r in reqs], dtype=torch.float32, device=dev),
            torch.tensor([r.top_p for r in reqs], dtype=torch.float32, device=dev),
            torch.tensor([r.do_sample for r in reqs], dtype=torch.bool, device=dev),
            torch.tensor([r.repetition_penalty for r in reqs], dtype=torch.float32, device=dev),
        )

    def _install_row(self, req: _Request, caches1, tok0, seen1) -> int:
        """Grant pages and write one prefilled row into a free slot."""
        slot = self._free_slot()
        n = req.n_prompt
        bt_row = self.kv.admit(slot, n)
        try:
            self.gen.admit(
                self.pool, slot, caches1, tok0, seen1, n, bt_row, req.max_new,
                req.temperature, req.top_p, req.do_sample, req.repetition_penalty,
            )
        except Exception:
            self.kv.release(slot)
            raise
        self._admit_seq += 1
        slot_state = _Slot(request=req, prompt_len=n, seq=self._admit_seq)
        if self._spec_active():
            slot_state.text_toks = self._text_toks(req)
            slot_state.pending_tok = int(tok0[0])
        with self._cond:
            self._slots[slot] = slot_state
        self.admitted += 1
        return slot

    def _text_toks(self, req: _Request) -> list[int]:
        """Host copy of the live text prompt ids (drafter context)."""
        ids = req.prompt_ids[0].tolist()
        pad = self.gen.cfg.pad_token_id
        while ids and ids[-1] == pad:
            ids.pop()
        return ids

    def _admit_group(self, reqs: list[_Request]) -> None:
        """One batched prefill for the group, then per-row admission. The
        group's first token is drawn from its first request's generator
        (the JAX engine's one key per group)."""
        cat = lambda name: torch.cat([getattr(r, name) for r in reqs], dim=0)  # noqa: E731
        embeds, positions = cat("embeds"), cat("positions")
        lengths, prompt_ids = cat("length"), cat("prompt_ids")
        kv_len = self._admit_kv_len(embeds.shape[1])
        caches, tok0, seen = self.gen.prefill(
            embeds, positions, lengths, prompt_ids, reqs[0].generator,
            *self._params(reqs), kv_len=kv_len,
        )
        group_slots: list[int] = []
        try:
            for i, req in enumerate(reqs):
                caches1 = [{n: c[n][i : i + 1] for n in ("k", "v")} for c in caches]
                group_slots.append(self._install_row(req, caches1, tok0[i : i + 1], seen[i : i + 1]))
        except Exception:
            # The caller fails the whole group: evict rows already in.
            for slot in group_slots:
                self.pool["done"][slot] = True
                with self._cond:
                    self._slots.pop(slot, None)
                self.kv.release(slot)
            raise

    # -- chunked prefill lane ----------------------------------------------

    def _lane_reserved_pages(self) -> int:
        """Pages spoken for by the head lane job once its chunks all ran."""
        if not self._prefill_jobs:
            return 0
        job = self._prefill_jobs[0]
        if job.offset < job.length or job.request.cancelled:
            return 0
        return self.kv.pages_for(job.length + 1)

    def _start_chunk_job(self, req: _Request) -> _PrefillJob:
        scratch_len = self._admit_kv_len(int(req.embeds.shape[1]))
        return _PrefillJob(
            request=req, caches=self.gen.new_prefill_cache(scratch_len),
            scratch_len=scratch_len, length=req.n_prompt,
        )

    def _advance_prefill_lane(self) -> None:
        """Run ONE chunk of the head lane job (decode blocks interleave
        between chunks); admit the job once its last live chunk ran and
        its pages are free."""
        while self._prefill_jobs:
            job = self._prefill_jobs[0]
            req = job.request
            if req.cancelled:
                self._prefill_jobs.popleft()
                _retire(req, [], eos=False)
                continue
            dev = self.gen.device
            if job.offset < job.length:
                off = job.offset
                c = min(self.prefill_chunk, int(req.embeds.shape[1]) - off)
                positions = torch.arange(off, off + c, device=dev)[None, :]
                valid = torch.tensor([min(job.length, off + c)], dtype=torch.int32, device=dev)
                job.last_logits = self.gen.prefill_chunk(
                    job.caches, req.embeds[:, off : off + c], positions, off, valid
                )
                job.last_off = off
                job.offset = off + c
                self.chunks_run += 1
                return  # one chunk per turn
            if not self.kv.can_admit(job.length):
                return
            idx = torch.tensor([job.length - 1 - job.last_off], device=dev)
            tok0, seen = self.gen.chunk_finish(
                job.last_logits, idx, req.prompt_ids, req.length, req.generator,
                *self._params([req]),
            )
            self._prefill_jobs.popleft()
            try:
                self._install_row(req, job.caches, tok0, seen)
            except Exception as e:  # noqa: BLE001 - fail this request only
                logger.exception("chunk-lane admission failed")
                _fail(req, e)
            return

    # -- decode blocks ------------------------------------------------------

    def _preempt_newest(self, protect: int) -> bool:
        """Evict the newest live row (except ``protect``) to free pages.
        A row whose restart is invisible (greedy, or sampled with nothing
        streamed) is requeued at the head to redo from its prompt; a
        sampled row that already streamed fails with
        :class:`PreemptionShed` -- splicing a fresh draw onto delivered
        tokens would emit a sequence no sampling run produced."""
        victims = [i for i in self._slots if i != protect]
        if not victims:
            return False

        def redo_safe(req: _Request) -> bool:
            return not (req.do_sample and req.delivered > 0)

        clean = [i for i in victims if redo_safe(self._slots[i].request)]
        idx = max(clean or victims, key=lambda i: self._slots[i].seq)
        self.pool["done"][idx] = True
        with self._cond:
            slot = self._slots.pop(idx)
        self.kv.release(idx)
        self.preemptions += 1
        logger.warning("paged KV pool exhausted: preempting slot %d (%d tokens in)", idx, len(slot.tokens))
        req = slot.request
        if redo_safe(req):
            self.preempt_redone += 1
            self._requeue_front([req])
        else:
            err = PreemptionShed(
                "preempted by KV pool exhaustion mid-stream; a sampled stream "
                "cannot restart without splicing draws -- retry after the pool drains"
            )
            err.retry_after_s = self._drain_estimate_s()
            self.preempt_failed += 1
            _fail(req, err)
        return True

    def _drain_estimate_s(self) -> float:
        """Soonest retire at the engine's per-token pace (retry hint)."""
        per_tok = self._block_s_ewma / max(self.block, 1)
        if per_tok <= 0.0:
            return 0.5
        remaining = min(
            (s.request.max_new - len(s.tokens) for s in self._slots.values()),
            default=self.block,
        )
        return per_tok * max(remaining, self.block)

    def _row_need(self, slot: _Slot, horizon: int | None = None) -> int:
        """KV tokens a row needs covered before the next block (or a
        verify turn's ``horizon`` of window writes), clamped to its own
        budget and to what a block table can address."""
        return min(
            slot.prompt_len + len(slot.tokens) + (horizon or self.block),
            slot.prompt_len + slot.request.max_new + 1,
            self.kv.row_capacity(),
        )

    def _ensure_growth(self, horizon: int | None = None) -> None:
        """Every live row's pages must cover the next block's (or verify
        window's) writes; preempt the newest rows until the free list can
        grow the rest."""
        for idx in sorted(self._slots, key=lambda i: self._slots[i].seq):
            slot = self._slots.get(idx)
            if slot is None:
                continue
            need = self._row_need(slot, horizon)
            while not self.kv.grow(idx, need):
                if not self._preempt_newest(protect=idx):
                    raise RuntimeError("paged pool cannot grow a lone row (feasibility bug)")

    # -- speculative decoding ---------------------------------------------

    def _spec_active(self) -> bool:
        return self.spec_k > 0 and not self.spec_disabled

    def _draft_row(self, slot: _Slot) -> list[int]:
        """Prompt-lookup draft for one row: the longest recent n-gram
        (``spec_ngram`` down to 1) whose suffix matches the row's tail is
        replayed for up to ``spec_k`` tokens. No draft model -- the prompt
        plus the row's own output is the drafter, which is what templated
        and repetitive captions pay off on. Greedy rows only: verification
        is token identity against argmax."""
        if slot.request.do_sample or slot.pending_tok is None or slot.text_toks is None:
            return []
        ctx = slot.text_toks + slot.tokens + [slot.pending_tok]
        for n in range(min(self.spec_ngram, len(ctx) - 1), 0, -1):
            pat = ctx[-n:]
            # EARLIEST occurrence: on cycling text every match continues
            # alike, and the earliest has the most room before the tail.
            for start in range(len(ctx) - n):
                if ctx[start : start + n] == pat:
                    return ctx[start + n : start + n + self.spec_k]
        return []

    def _spec_try_disable(self) -> None:
        """Permanent auto-off once acceptance is below
        ``LUMEN_VLM_SPEC_MIN_RATE`` after a fair sample (64 proposals):
        every verify turn would be overhead with nothing to show for it."""
        if self.spec_disabled or self.spec_proposed < 64:
            return
        if self.spec_accepted < self.spec_min_rate * self.spec_proposed:
            self.spec_disabled = True
            logger.warning(
                "speculative decoding disabled: acceptance %d/%d below floor %.2f",
                self.spec_accepted, self.spec_proposed, self.spec_min_rate,
            )

    def _spec_plan(self) -> tuple[int, dict[int, list[int]]]:
        """The verify window and the drafts for this turn: width 0 (a plain
        block) unless some row drafted AND every live row's window fits its
        table -- the verify program's position clamp must never engage on
        a live row (it would overwrite history). ``_run_block`` ships a
        table prefix that covers each window's end."""
        if not self._spec_active():
            return 0, {}
        cap = self.kv.row_capacity()
        if any(s.prompt_len + len(s.tokens) + self.spec_k + 1 > cap for s in self._slots.values()):
            return 0, {}
        drafts = {i: d for i, s in self._slots.items() if (d := self._draft_row(s))}
        return (self.spec_k + 1 if drafts else 0), drafts

    def _run_block(self) -> None:
        cancelled = [i for i, s in self._slots.items() if s.request.cancelled]
        for i in cancelled:
            self.pool["done"][i] = True
            with self._cond:
                slot = self._slots.pop(i)
            self.kv.release(i)
            _retire(slot.request, slot.tokens, eos=False)
        if not self._slots:
            return
        width, drafts = self._spec_plan()
        self._ensure_growth(horizon=width or None)
        # Growth may have preempted a drafted row; verify only helps if a
        # surviving row still carries a draft.
        drafts = {i: d for i, d in drafts.items() if i in self._slots}
        if not drafts:
            width = 0
        t0 = time.perf_counter()
        # Ship only a power-of-2 prefix of the block tables covering the
        # longest live row: the plain CPU gather reads every entry it is
        # given, and the kernel's grid needs no more. A verify window
        # writes all ``width`` positions even past the row's budget (onto
        # the dump page), so the prefix covers the uncapped window end:
        # ``_spec_plan`` keeps that within the table, and the verify
        # program's clamp never moves a live window onto its history.
        if width:
            ends = (s.prompt_len + len(s.tokens) + width for s in self._slots.values())
        else:
            ends = (self._row_need(s) for s in self._slots.values())
        maxp_live = max(self.kv.pages_for(e) for e in ends)
        bucket = 1
        while bucket < maxp_live:
            bucket *= 2
        bucket = min(bucket, self.kv.max_pages)
        tables = torch.from_numpy(np.ascontiguousarray(self.kv.block_tables[:, :bucket]))
        tables = tables.to(self.gen.device)
        if width:
            draft = np.zeros((self.n_slots, width), np.int32)
            ql = np.ones((self.n_slots,), np.int32)
            for i, d in drafts.items():
                draft[i, 1 : 1 + len(d)] = d
                ql[i] = 1 + len(d)
            toks = self.gen.verify(
                self.pool, tables, self._rng, torch.from_numpy(draft), torch.from_numpy(ql), width
            )
            self.spec_turns += 1
        else:
            toks = self.gen.step_block(self.pool, tables, self._rng, block=self.block)
        self.blocks_run += 1
        # One device->host transfer for everything the bookkeeping needs
        # (cur_tok rides along only when speculation is configured).
        cols = [toks, self.pool["n_gen"][:, None], self.pool["done"][:, None].int(),
                self.pool["eos"][:, None].int()]
        if self.spec_k > 0:
            cols.append(self.pool["cur_tok"][:, None])
        host = torch.cat(cols, dim=1).cpu().numpy()
        n = toks.shape[1]
        toks_np, n_gen = host[:, :n], host[:, n]
        done, eos = host[:, n + 1], host[:, n + 2]
        dt = time.perf_counter() - t0
        self._block_s_ewma = dt if self._block_s_ewma == 0.0 else 0.8 * self._block_s_ewma + 0.2 * dt
        for idx in list(self._slots):
            slot = self._slots[idx]
            req = slot.request
            new = int(n_gen[idx]) - len(slot.tokens)
            if width and ql[idx] > 1:
                # A verify turn's first emission is the pending token, not
                # a draft: acceptance counts only the drafted tail.
                prop = int(ql[idx]) - 1
                acc = max(min(new - 1, prop), 0)
                self.spec_proposed += prop
                self.spec_accepted += acc
                req.spec_proposed += prop
                req.spec_accepted += acc
            if self.spec_k > 0:
                slot.pending_tok = int(host[idx, n + 3])
            if new > 0:
                slot.tokens.extend(int(t) for t in toks_np[idx, :new])
                if req.stream_q is not None:
                    for t in slot.tokens[req.delivered :]:
                        req.stream_q.put(t)
                    req.delivered = max(req.delivered, len(slot.tokens))
            if done[idx]:
                with self._cond:
                    del self._slots[idx]
                self.kv.release(idx)
                _retire(req, slot.tokens, bool(eos[idx]))
        if width:
            self._spec_try_disable()
