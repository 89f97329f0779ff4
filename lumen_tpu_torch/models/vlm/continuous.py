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
  the pool runs dry mid-decode the newest row is PREEMPTED: its live KV
  pages and exact decode state go to a host SPILL TIER (one device-to-
  host copy, packed as a ``migration.pack_payload`` blob into an
  shm-arena lease, ``utils/shm_arena.py``, or kept as host arrays when
  the arena denies) and re-admission scatters them into a fresh grant --
  no re-prefill, greedy resume token-identical, a sampled mid-stream row
  resumes its own draw. The tier is bounded (``LUMEN_VLM_SPILL_BYTES``,
  default 256 MiB, 0 disables; ``LUMEN_VLM_SPILL_MAX`` entries, default
  32); any spill or resume failure (arena, crc, the ``kv_spill`` /
  ``kv_resume`` fault points) degrades to requeue-and-redo for rows whose
  restart is invisible (greedy, or nothing streamed yet; the stream's
  delivered watermark is kept so nothing is sent twice) and to the typed
  retryable :class:`~lumen_tpu_torch.utils.deadline.PreemptionShed`, with
  the engine's drain estimate, for sampled mid-stream rows. Leases and
  pages balance at drain;
- with ``LUMEN_VLM_PREFIX_BYTES`` set, a content-addressed PREFIX KV
  CACHE (``prefix_cache.py``): a prompt whose page-aligned prefix is
  cached attaches those pages by reference (copy-on-write block tables)
  and prefills only the uncovered suffix, on a scratch seeded from the
  pool pages;
- with ``LUMEN_VLM_SPEC_K`` > 0, SPECULATIVE DECODING: a host n-gram
  drafter (prompt lookup over the row's prompt and output) proposes up to
  K tokens per greedy row, and one verify forward over a K+1 window
  accepts the ones the model would have emitted itself. Acceptance below
  ``LUMEN_VLM_SPEC_MIN_RATE`` after 64 proposals turns it off for the
  engine's lifetime. The knobs are the JAX engine's own;
- with ``LUMEN_GEN_STEP_FLOOR_MS`` > 0, a DECODE PACING FLOOR: a block
  that took less than ``block x floor`` sleeps out the rest before its
  tokens stream, and its EWMA and duty credit include the sleep (the JAX
  engine's knob, for shared hosts that stand in for several cards).

Telemetry is the JAX engine's: the ``vlm-continuous:{name}`` gauge
provider, the ``vlm_*`` counters, the ``device:{name}`` duty meter and
``batch_items:{name}`` arrivals, ``vlm_spill`` / ``vlm_resume``
flight-recorder events, and a ``batch.device`` span per decode block on
every active request's trace.

Disaggregated serving (the JAX engine's too): with a ``migrator`` hook
installed (a federation's ``kv_migrate``), a row tagged ``migrate_to``
is exported right after prefill through the spill tier's export path
and its decode runs on a decode-lane peer; any failure resumes it
locally from the snapshot (``resubmit_spilled``). On the decode host,
``submit_migrated`` parks a wire record as a spill and the resume path
installs it with zero re-prefill. The ``migrated_*`` gauges count both
sides.
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ...testing.faults import KV_RESUME, KV_SPILL, faults
from ...utils import telemetry
from ...utils.deadline import PreemptionShed
from ...utils.env import env_float, env_int
from ...utils.metrics import metrics
from ...utils.shm_arena import ShmArena
from ...utils.telemetry import record_event
from ...utils.trace import current_trace
from . import migration
from .paged_kv import DEFAULT_PAGE_SIZE, PagedKVPool, PoolExhausted, page_bytes
from .prefix_cache import PrefixCache, chunk_keys, prefix_cache_enabled

__all__ = ["ContinuousScheduler", "PreemptionShed"]

logger = logging.getLogger(__name__)

_STREAM_END = object()


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
    #: the submitter's trace: decode blocks land ``batch.device`` spans on it.
    trace: object = None
    #: carried across preemption so a resumed stream never re-delivers.
    delivered: int = 0
    #: parked :class:`_SpillRecord` while the request waits, preempted, at
    #: the queue head for pages to free; None on the normal path.
    spill: "_SpillRecord | None" = None
    #: [L] int64 content identity of the merged prompt (token ids, vision
    #: positions replaced by image-digest ints), the prefix cache's key
    #: material; None when the cache is off.
    prefix_content: "np.ndarray | None" = None
    #: the prefix cache's chain keys over ``prefix_content``, computed once.
    prefix_keys: "list | None" = None
    #: fraction of the prompt served from shared prefix pages, set at
    #: admission when the cache is on (None = cache off).
    prefix_hit: "float | None" = None
    #: speculative decoding tally of this request (response metadata).
    spec_proposed: int = 0
    spec_accepted: int = 0
    #: decode-lane peer address for disaggregated serving: the row is
    #: exported right after prefill and its decode migrates there.
    #: Cleared after one attempt -- any failure decodes locally.
    migrate_to: "str | None" = None
    #: decode-host side of a migration: ``(manifest_keys, n_shared)``
    #: pending prefix-cache resolution at resume. None otherwise.
    migrate_in: "tuple | None" = None

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
    last_logits: object = None  # the most recent chunk's logits at its last valid position
    #: shared prefix pages seeded into the scratch; the JOB holds one
    #: reference on each until admission or cancellation.
    shared: list = field(default_factory=list)


@dataclass
class _SpillRecord:
    """Everything needed to resume a preempted row WITHOUT re-prefill (the
    JAX engine's record).

    The payload leaves are, in order, each layer's K and V page stack
    ``[n_pad, kvh, page, dh]`` (padded to a power of two with dump-page
    garbage) and the row's ``seen`` mask ``[V]``: the flatten order of the
    JAX engine's payload tree, in the same dtypes (bf16 as
    ``ml_dtypes.bfloat16``), so ``nbytes`` and the budget decisions match
    and a blob packed by one package unpacks in the other. The payload
    lives out of line: a :func:`~.migration.pack_payload` blob in an
    shm-arena lease when the arena had room (``crc`` over the blob catches
    a torn lease at resume), else the host arrays themselves. The decode
    scalars are exact state: ``cur_tok`` is the sampled but not yet
    emitted next token. Unlike the JAX record it holds no random state
    that this engine reads: a row's decode draws come from the engine's
    stream, and its own generator served only its first token. ``rng`` is
    set only on a row that migrates out: a ``uint32[2]`` drawn from the
    engine's stream, the JAX PRNG key a JAX decode host samples with."""

    n_pages: int            # live pages exported -- the resume grant size
    n_pad: int              # power-of-2 padded page count in the payload
    nbytes: int             # payload bytes -- ledger budget accounting
    crc: int                # crc32 over the lease's blob (0 = host arrays)
    cur_tok: int            # pending next token (sampled, not yet emitted)
    cur_len: int            # prompt + generated KV length
    n_gen: int              # tokens generated so far (== len(tokens))
    prompt_len: int = 0
    tokens: list = field(default_factory=list)
    lease: object = None    # ArenaSlot when the shm path won
    arrays: "list | None" = None  # host-array payload otherwise
    #: shared prefix pages the row held at spill time. NOT exported: they
    #: stay resident in the pool under one reference held by the RECORD,
    #: and resume re-attaches them ahead of the fresh grant.
    shared_pages: list = field(default_factory=list)
    rng: "np.ndarray | None" = None


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
        # The MicroBatcher's duty meter name: capacity readers see engine
        # families through the same sensor.
        telemetry.set_capacity(f"device:{self.name}", 1.0, union=True)
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
        # -- KV spill tier: bounded by payload bytes (also the shm arena's
        # budget, so the lease path and the host-array fallback draw on one
        # pool) and by entries. LUMEN_VLM_SPILL_BYTES=0 turns it off.
        self._spill_budget = env_int("LUMEN_VLM_SPILL_BYTES", 256 << 20, minimum=0)
        self._spill_max = env_int("LUMEN_VLM_SPILL_MAX", 32, minimum=0)
        self._spill_arena: ShmArena | None = None  # created on first spill
        self._spill_ledger: dict[int, _SpillRecord] = {}  # id(req) -> record
        self._spill_bytes_live = 0
        self.spills = 0
        self.spill_resumes = 0
        self.spill_fallbacks = 0  # arena denied -> host-array payload
        self.spill_denied = 0     # ledger full/disabled -> no spill attempt
        self.preempt_redone = 0   # victim restarted from the prompt
        self.preempt_failed = 0   # victim shed with the typed retryable error
        # -- disaggregated serving: the migration dispatcher hook,
        # ``migrator(scheduler, req, rec, manifest, target)``, installed by
        # the server on peer-aware boots. Requests tagged ``migrate_to`` are
        # then exported right after prefill (the spill tier's record format)
        # and decode on the target peer. None (the default) never exports.
        self.migrator = None
        self.migrated_out = 0        # rows handed to the dispatcher
        self.migrate_out_failed = 0  # wire failed -> resumed/shed locally
        self.migrated_in = 0         # peer rows admitted with zero re-prefill
        self.migrate_in_rejected = 0 # bad commit (manifest/pool) refused
        # -- copy-on-write prefix KV reuse: off (None) unless
        # LUMEN_VLM_PREFIX_BYTES grants a budget.
        self.prefix: PrefixCache | None = None
        if prefix_cache_enabled():
            dtype_bytes = torch.finfo(generator.cache_dtype).bits // 8
            self.prefix = PrefixCache(self.kv, page_bytes(generator.cfg, self.page_size, dtype_bytes))
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_pages = 0  # shared pages attached across all hits
        # Speculative decoding: K = 0 (default) builds no drafter and
        # never runs the verify program.
        self.spec_k = env_int("LUMEN_VLM_SPEC_K", 0, minimum=0, maximum=15)
        self.spec_ngram = env_int("LUMEN_VLM_SPEC_NGRAM", 3, minimum=1, maximum=8)
        self.spec_min_rate = env_float("LUMEN_VLM_SPEC_MIN_RATE", 0.2, minimum=0.0, maximum=1.0)
        self.spec_turns = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_disabled = False
        # Per-token decode pace (EWMA over block wall time): the
        # PreemptionShed retry hint.
        self._block_s_ewma = 0.0
        # Decode pacing floor: the least wall time a decode step takes (a
        # block sleeps out ``block * floor - elapsed``). Off by default (0 =
        # no branch taken); a floor makes a shared host's decode rate
        # measure topology (slots x hosts) rather than its cores: sleeps
        # scale across host processes as separate cards do, spins do not.
        self._step_floor_s = env_float("LUMEN_GEN_STEP_FLOOR_MS", 0.0, minimum=0.0, maximum=1000.0) / 1e3
        self._preempt_log_t = 0.0  # 1/s warning throttle
        # Decode-block occupancy: active rows summed over blocks.
        self._occ_rows = 0
        self._occ_blocks = 0
        self._thread = threading.Thread(target=self._loop, name=f"vlm-continuous-{name}", daemon=True)
        self._thread.start()
        ref = weakref.ref(self)  # the registry must not pin the pool

        def _gauges() -> dict:
            s = ref()
            return {} if s is None else s.gauges()

        self._gauge_fn = _gauges
        metrics.register_gauges(f"vlm-continuous:{self.name}", _gauges)

    def gauges(self) -> dict:
        """The ``vlm-continuous:{name}`` gauges, key for key the JAX
        engine's: resumed + redone + failed add up to preempted once parked
        spills drain, and spill entries/bytes return to 0."""
        stats = self.kv.stats()
        out = {
            "blocks_run": self.blocks_run,
            "admitted": self.admitted,
            "preempted": self.preemptions,
            "prefill_chunks_run": self.chunks_run,
            "prefill_lane_depth": len(self._prefill_jobs),
            "slots_total": self.n_slots,
            "slots_live": len(self._slots),
            "queue_depth": len(self._pending),
            "page_size": stats.page_size,
            "pages_total": stats.pages_total,
            "pages_free": stats.pages_free,
            "pages_live": stats.pages_live,
            "pages_allocated_total": stats.allocated_total,
            "pages_freed_total": stats.freed_total,
            "pages_fill_pct": round(100.0 * stats.pages_live / max(stats.pages_total - 1, 1), 1),
            "spill_entries": len(self._spill_ledger),
            "spill_bytes": self._spill_bytes_live,
            "spill_bytes_budget": self._spill_budget,
            "spill_max_entries": self._spill_max,
            "spilled": self.spills,
            "spill_resumed": self.spill_resumes,
            "spill_fallbacks": self.spill_fallbacks,
            "spill_denied": self.spill_denied,
            "preempt_redone": self.preempt_redone,
            "preempt_failed": self.preempt_failed,
            "migrated_out": self.migrated_out,
            "migrate_out_failed": self.migrate_out_failed,
            "migrated_in": self.migrated_in,
            "migrate_in_rejected": self.migrate_in_rejected,
        }
        if self._spill_arena is not None:
            arena = self._spill_arena.stats()
            out["spill_arena_segments"] = arena["segments"]
            out["spill_arena_bytes"] = arena["bytes"]
            out["spill_arena_live"] = arena["live"]
            out["spill_arena_denied"] = arena["denied"]
        if self.prefix is not None:
            out.update(self.prefix.gauges())
            out["prefix_hits"] = self.prefix_hits
            out["prefix_misses"] = self.prefix_misses
            out["prefix_hit_pages"] = self.prefix_hit_pages
            out["pages_shared"] = stats.pages_shared
        if self.spec_k > 0:
            out["spec_k"] = self.spec_k
            out["spec_turns"] = self.spec_turns
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
            out["spec_accept_rate"] = round(self.spec_accepted / max(self.spec_proposed, 1), 3)
            out["spec_disabled"] = int(self.spec_disabled)
        if self._occ_blocks:
            out["occupancy_pct_mean"] = round(100.0 * self._occ_rows / (self._occ_blocks * self.n_slots), 1)
        return out

    # -- public API --------------------------------------------------------

    def submit(self, req: _Request) -> Future:
        # A request whose prompt + budget can NEVER fit (even alone) fails
        # now instead of deadlocking the admission queue later.
        need = req.n_prompt + int(req.max_new) + 1
        if not self.kv.fits(need):
            raise ValueError(
                f"request needs {need} KV tokens but the paged pool holds at most "
                f"{min(self.kv.row_capacity(), (self.kv.pages_total - 1) * self.kv.page_size)} "
                "per row; raise LUMEN_VLM_KV_PAGES or lower max_new_tokens"
            )
        if req.trace is None:
            req.trace = current_trace()
        with self._cond:
            if self._closed:
                raise RuntimeError("continuous scheduler is closed")
            self._pending.append(req)
            self._cond.notify()
        # Arrivals under the batcher's ``batch_items:{name}`` key.
        telemetry.count(f"batch_items:{self.name}")
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
            self._drop_spill(req)
            _fail(req, err)
        for job in jobs:
            self._drop_job_hold(job)
        if self.prefix is not None:
            self.prefix.clear()
        if self._spill_arena is not None:
            self._spill_arena.close()
        metrics.unregister_gauges(f"vlm-continuous:{self.name}", self._gauge_fn)

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
                        self._drop_spill(req)
                        _fail(req, err)
                    return
                live = []
                for req in admit:
                    if req.cancelled:
                        # A parked record's tokens are what the row
                        # produced: deliver them and free the lease.
                        rec = self._drop_spill(req)
                        _retire(req, list(rec.tokens) if rec else [], eos=False)
                    else:
                        live.append(req)
                # Page gating in arrival order; a finished chunk-lane job
                # waiting on pages gets its need reserved first so short
                # arrivals cannot starve it.
                placeable, deferred = [], []
                budget = self.kv.pages_free - self._lane_reserved_pages()
                for req in live:
                    if req.spill is not None:
                        # A parked victim resumes into exactly its exported
                        # grant; growth past it is _ensure_growth's job.
                        need = req.spill.n_pages
                    else:
                        # A cached prefix needs no fresh grant; coverage is
                        # re-checked at admission.
                        covered = len(self._prefix_lookup(req, req.n_prompt))
                        need = self.kv.pages_for(req.n_prompt + 1) - covered
                    if need > budget and self.prefix is not None and not deferred:
                        # Cached history yields to live admissions first.
                        budget += self.prefix.reclaim(need - budget)
                    if deferred or need > budget:
                        deferred.append(req)
                    else:
                        budget -= need
                        placeable.append(req)
                self._requeue_front(deferred)
                direct, hits = [], []
                for req in placeable:
                    if req.spill is not None:
                        self._resume_row(req)
                    elif req.embeds.shape[1] > self.prefill_chunk:
                        self._prefill_jobs.append(self._start_chunk_job(req))
                    elif self._prefix_lookup(req, req.n_prompt):
                        hits.append(req)
                    else:
                        direct.append(req)
                # Admission units: prefix hits one by one (per-row
                # coverage), misses in batched-prefill groups; a failure
                # fails its unit only.
                units = [(self._admit_prefix_hit, req, [req]) for req in hits]
                units += [(self._admit_group, g, g) for g in self._admit_groups(direct)]
                for admit_fn, arg, members in units:
                    try:
                        admit_fn(arg)
                    except Exception as e:  # noqa: BLE001 - fail ONE unit
                        logger.exception("admission of %d request(s) failed", len(members))
                        for req in members:
                            _fail(req, e)
                self._advance_prefill_lane()
                if self.migrator is not None:
                    self._migrate_sweep()
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
                self._drop_spill(req)
                _fail(req, RuntimeError(f"continuous scheduler died: {e!r}"))
            for job in jobs:
                self._drop_job_hold(job)
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

    # -- prefix cache helpers -----------------------------------------------

    def _prefix_keys(self, req: _Request, n: int) -> list[bytes]:
        """Chain-hash keys over the request's live content identity,
        computed once per request (page-aligned, so a requeue reuses
        them)."""
        if self.prefix is None or req.prefix_content is None:
            return []
        if req.prefix_keys is None:
            req.prefix_keys = chunk_keys(np.asarray(req.prefix_content)[:n], self.page_size)
        return req.prefix_keys

    def _prefix_lookup(self, req: _Request, n: int) -> list[int]:
        """Longest cached prefix for this request, capped one token short
        of the prompt so the write frontier always lands in a private page
        (``admit_shared``'s contract)."""
        keys = self._prefix_keys(req, n)
        if not keys:
            return []
        return self.prefix.lookup(keys)[: (n - 1) // self.page_size]

    def _prefix_insert(self, req: _Request, slot: int, n: int) -> None:
        """Record an installed row's full prompt pages (hit rows refresh
        their shared entries and extend coverage with the fresh suffix)."""
        keys = self._prefix_keys(req, n)
        if not keys:
            return
        pages = self.kv.owned_pages(slot)[: len(keys)]
        self.prefix.insert(keys[: len(pages)], pages)

    def _install_row(self, req: _Request, caches1, tok0, seen1, shared_pages=None, row: int = 0) -> int:
        """Grant pages and write row ``row`` of a prefill into a free slot.
        ``shared_pages`` attaches a cached prefix ahead of the fresh grant:
        the scatter then targets a table whose shared entries point at the
        dump page, so the scratch's prefix segments (already resident in
        the real pages) land harmlessly while the suffix fills the private
        pages."""
        slot = self._free_slot()
        n = req.n_prompt
        shared = list(shared_pages or ())
        if shared:
            bt_row = self.kv.admit_shared(slot, shared, n)
            bt_dev = bt_row.copy()
            bt_dev[: len(shared)] = 0
        else:
            bt_row = bt_dev = self.kv.admit(slot, n)
        try:
            self.gen.admit(
                self.pool, slot, caches1, tok0, seen1, n, bt_dev, req.max_new,
                req.temperature, req.top_p, req.do_sample, req.repetition_penalty, row=row,
            )
        except Exception:
            self.kv.release(slot)
            raise
        self._admit_seq += 1
        slot_state = _Slot(request=req, prompt_len=n, seq=self._admit_seq)
        if self._spec_active():
            slot_state.text_toks = self._text_toks(req)
            slot_state.pending_tok = int(tok0[row])
        with self._cond:
            self._slots[slot] = slot_state
        self.admitted += 1
        if self.prefix is not None:
            if shared:
                self.prefix_hits += 1
                self.prefix_hit_pages += len(shared)
                metrics.count("vlm_prefix_hits")
                req.prefix_hit = len(shared) * self.page_size / max(n, 1)
            else:
                self.prefix_misses += 1
                metrics.count("vlm_prefix_misses")
                req.prefix_hit = 0.0
            self._prefix_insert(req, slot, n)
        return slot

    def _text_toks(self, req: _Request) -> list[int]:
        """Host copy of the live text prompt ids (drafter context)."""
        ids = req.prompt_ids[0].tolist()
        pad = self.gen.cfg.pad_token_id
        while ids and ids[-1] == pad:
            ids.pop()
        return ids

    def _seeded_scratch(self, pages: list[int], scratch_len: int):
        """A prefill scratch whose first ``len(pages)`` page segments hold
        the cached prefix KV (no decoder forward)."""
        ids = np.zeros((scratch_len // self.page_size,), np.int32)
        ids[: len(pages)] = pages
        return self.gen.seed_prefix(self.gen.new_prefill_cache(scratch_len), self.pool, ids)

    def _admit_prefix_hit(self, req: _Request) -> None:
        """Admit one request whose prompt prefix is cached: attach the
        shared pages by reference, seed a prefill scratch with their
        contents, and run the decoder over the UNCOVERED SUFFIX only.
        Coverage is re-resolved here (an eviction since the admission peek
        shrinks it); losing the page race requeues, losing coverage
        entirely admits as a plain batch of one."""
        n = req.n_prompt
        pages = self._prefix_lookup(req, n)
        if not pages:
            self._admit_group([req])
            return
        covered = len(pages) * self.page_size
        span = int(req.embeds.shape[1])
        caches = self._seeded_scratch(pages, self._admit_kv_len(span))
        dev = self.gen.device
        positions = torch.arange(covered, span, device=dev)[None, :]
        logits = self.gen.prefill_chunk(
            caches, self.gen.seq_slice(req.embeds, covered, span), positions, covered,
            torch.tensor([n], dtype=torch.int32, device=dev), last_only=True,
        )
        tok0, seen = self.gen.chunk_finish(
            logits, torch.zeros(1, dtype=torch.long, device=dev), req.prompt_ids, req.length,
            req.generator, *self._params([req]),
        )
        try:
            self._install_row(req, caches, tok0, seen, shared_pages=pages)
        except PoolExhausted:
            # Same-turn eviction shrank coverage and the fresh need no
            # longer fits: park at the queue head and retry next turn.
            self._requeue_front([req])

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
                group_slots.append(self._install_row(req, caches, tok0, seen, row=i))
        except Exception:
            # The caller fails the whole group: evict rows already in.
            if group_slots:
                self.gen.retire(self.pool, group_slots)
            for slot in group_slots:
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
        return self.kv.pages_for(job.length + 1) - len(job.shared)

    def _start_chunk_job(self, req: _Request) -> _PrefillJob:
        scratch_len = self._admit_kv_len(int(req.embeds.shape[1]))
        job = _PrefillJob(request=req, scratch_len=scratch_len, length=req.n_prompt)
        # Lane jobs reuse cached prefixes too: the scratch is seeded from
        # the shared pages and chunking starts AFTER the covered span. The
        # job holds its own reference on the pages so an eviction during
        # the multi-turn chunk run cannot free them; _drop_job_hold
        # releases it on every exit path.
        hit = self._prefix_lookup(req, req.n_prompt)
        if hit:
            self.kv.incref(hit)
            job.shared = list(hit)
            job.caches = self._seeded_scratch(hit, scratch_len)
            job.offset = len(hit) * self.page_size
        else:
            job.caches = self.gen.new_prefill_cache(scratch_len)
        return job

    def _drop_job_hold(self, job: _PrefillJob) -> None:
        """Release a lane job's prefix-page hold (idempotent)."""
        if job.shared:
            self.kv.decref(job.shared)
            job.shared = []

    def _advance_prefill_lane(self) -> None:
        """Run ONE chunk of the head lane job (decode blocks interleave
        between chunks); admit the job once its last live chunk ran and
        its pages are free."""
        while self._prefill_jobs:
            job = self._prefill_jobs[0]
            req = job.request
            if req.cancelled:
                self._prefill_jobs.popleft()
                self._drop_job_hold(job)
                _retire(req, [], eos=False)
                continue
            dev = self.gen.device
            if job.offset < job.length:
                off = job.offset
                c = min(self.prefill_chunk, int(req.embeds.shape[1]) - off)
                positions = torch.arange(off, off + c, device=dev)[None, :]
                valid = torch.tensor([min(job.length, off + c)], dtype=torch.int32, device=dev)
                job.last_logits = self.gen.prefill_chunk(
                    job.caches, self.gen.seq_slice(req.embeds, off, off + c), positions, off, valid,
                    last_only=True,
                )
                job.offset = off + c
                self.chunks_run += 1
                return  # one chunk per turn
            # All live chunks ran: admit when pages allow. Shared prefix
            # pages are granted by reference, so only the fresh suffix
            # competes for the free list; cached history yields first.
            if not self.kv.can_admit(job.length, shared_pages=len(job.shared)):
                if self.prefix is None:
                    return
                short = self.kv.pages_for(job.length + 1) - len(job.shared) - self.kv.pages_free
                if short <= 0 or not self.prefix.reclaim(short):
                    return
                if not self.kv.can_admit(job.length, shared_pages=len(job.shared)):
                    return
            tok0, seen = self.gen.chunk_finish(
                job.last_logits, torch.zeros(1, dtype=torch.long, device=dev), req.prompt_ids, req.length, req.generator,
                *self._params([req]),
            )
            self._prefill_jobs.popleft()
            try:
                self._install_row(req, job.caches, tok0, seen, shared_pages=job.shared)
            except Exception as e:  # noqa: BLE001 - fail this request only
                logger.exception("chunk-lane admission failed")
                _fail(req, e)
            finally:
                self._drop_job_hold(job)
            return

    # -- decode blocks ------------------------------------------------------

    def _preempt_newest(self, protect: int) -> bool:
        """Evict the newest live row (except ``protect``): export its pages
        and decode state into the spill tier and park it at the queue head
        to RESUME (no re-prefill, token-identical), or, when the tier is
        full, off, or the export fails, fall down the ladder:
        requeue-and-redo for a row whose restart is invisible (greedy, or
        nothing streamed yet; ``delivered`` is kept so a restarted stream
        never re-sends its prefix), the typed retryable
        :class:`PreemptionShed` for a sampled row that already streamed --
        splicing a fresh draw onto delivered tokens would emit a sequence
        no sampling run produced. Such rows are the last choice of
        victim."""
        victims = [i for i in self._slots if i != protect]
        if not victims:
            return False

        def redo_safe(i: int) -> bool:
            req = self._slots[i].request
            return not (req.do_sample and req.delivered > 0)

        clean = [i for i in victims if redo_safe(i)]
        idx = max(clean or victims, key=lambda i: self._slots[i].seq)
        record = spill_err = None
        try:
            # Export BEFORE the release, while the row still owns its
            # pages; the export writes nothing, so a failure leaves every
            # row intact.
            record = self._spill_victim(idx)
        except Exception as e:  # noqa: BLE001 - spill is best-effort
            spill_err = e
            logger.warning("KV spill of slot %d failed (%s); degrading", idx, e)
        self.gen.retire(self.pool, [idx])
        with self._cond:
            slot = self._slots.pop(idx)
        self.kv.release(idx)
        self.preemptions += 1
        metrics.count("vlm_paged_preemptions")
        now = time.monotonic()
        if now - self._preempt_log_t >= 1.0:
            # One line a second, not a flood, through a preemption storm.
            self._preempt_log_t = now
            logger.warning(
                "paged KV pool exhausted: preempting slot %d (%d tokens in, %s)",
                idx, len(slot.tokens),
                "spilled for resume" if record is not None else "restarts from prompt",
            )
        req = slot.request
        if record is not None:
            record.prompt_len = slot.prompt_len
            record.tokens = slot.tokens
            self._park_spill(req, record)
        elif not (req.do_sample and req.delivered > 0):
            self.preempt_redone += 1
            metrics.count("vlm_preempt_redone")
            self._requeue_front([req])
        else:
            self._fail_preempted(req, spill_err)
        return True

    # -- KV spill tier -------------------------------------------------------

    def _get_arena(self) -> ShmArena:
        """Created on first use, so an engine that never preempts never
        touches /dev/shm; its budget is the ledger's byte bound."""
        if self._spill_arena is None:
            tag = "".join(c if c.isalnum() else "-" for c in self.name)
            self._spill_arena = ShmArena(name=f"vlmspill-{tag}", max_bytes=self._spill_budget)
        return self._spill_arena

    def _export_state(self, idx: int, n_shared: int) -> "tuple[_SpillRecord, list[int]]":
        """THE export code path (the spill tier's, and later federation's
        ``fed_kv_put``): gather slot ``idx``'s pages past its first
        ``n_shared`` block-table entries (padded to a power of two with
        the dump page) plus its exact decode scalars, in one device-to-
        host copy (``Generator.export_row``). Returns ``(record,
        shared_page_ids)`` with the payload as host arrays; the sink
        decides where the bytes live. Writes nothing, so a failure leaves
        the pool untouched."""
        owned = self.kv.owned_pages(idx)
        shared, private = owned[:n_shared], owned[n_shared:]
        n_pad = 1
        while n_pad < max(1, len(private)):
            n_pad *= 2
        ids = np.zeros((n_pad,), np.int32)
        ids[: len(private)] = private
        host = self.gen.export_row(self.pool, idx, ids)
        leaves = [layer[name] for layer in host["pages"] for name in ("k", "v")] + [host["seen"]]
        rec = _SpillRecord(
            n_pages=len(private), n_pad=n_pad, nbytes=sum(int(a.nbytes) for a in leaves),
            crc=0, cur_tok=host["cur_tok"], cur_len=host["cur_len"], n_gen=host["n_gen"], arrays=leaves,
        )
        return rec, shared

    def _spill_victim(self, idx: int) -> "_SpillRecord | None":
        """Export slot ``idx``'s live pages and decode state into a spill
        record. ``None`` = tier off or ledger full (counted; the caller
        degrades); raises on an export or pack failure (incl. the
        ``kv_spill`` fault point). Runs BEFORE the caller releases the
        pages."""
        if self._spill_budget <= 0 or self._spill_max <= 0:
            return None
        if len(self._spill_ledger) >= self._spill_max:
            self.spill_denied += 1
            metrics.count("vlm_spill_denied")
            return None
        faults.check(KV_SPILL, f"{self.name}:{idx}")
        # A row on a cached prefix does not export its shared pages: they
        # stay resident under the cache's (and this record's) reference
        # and re-attach on resume. Only the PRIVATE suffix goes to host.
        rec, shared = self._export_state(idx, self.kv.shared_prefix_len(idx))
        if self._spill_bytes_live + rec.nbytes > self._spill_budget:
            self.spill_denied += 1
            metrics.count("vlm_spill_denied")
            return None
        # Pack into the one migration blob and park it in the shm arena
        # when the budget allows; else keep the host arrays -- the same
        # bytes against the same ledger budget.
        blob, crc = migration.pack_payload(rec.arrays)
        got = self._get_arena().acquire(len(blob))
        if got is not None:
            np.frombuffer(got.buf, np.uint8, count=len(blob))[:] = np.frombuffer(blob, np.uint8)
            rec.lease, rec.crc, rec.nbytes, rec.arrays = got, crc, len(blob), None
        else:
            self.spill_fallbacks += 1
            metrics.count("vlm_spill_fallbacks")
        # The record's hold on the shared prefix is taken LAST: every
        # failure above returns first, so a record exists iff the incref
        # happened and _drop_spill's decref balances it.
        if shared:
            self.kv.incref(shared)
            rec.shared_pages = list(shared)
        return rec

    def _park_spill(self, req: _Request, record: _SpillRecord) -> None:
        req.spill = record
        self._spill_ledger[id(req)] = record
        self._spill_bytes_live += record.nbytes
        self.spills += 1
        metrics.count("vlm_spills")
        record_event(
            "vlm_spill", self.name,
            f"row spilled for resume: {record.n_pages} pages, {len(record.tokens)} tokens parked",
            min_interval_s=1.0,
            pages=record.n_pages, bytes=record.nbytes, entries=len(self._spill_ledger),
        )
        self._requeue_front([req])

    def _drop_spill(self, req: _Request) -> "_SpillRecord | None":
        """Detach and free a request's spill record (lease back to the
        arena, bytes off the ledger). Idempotent: every retirement path
        calls it, so accounting balances at drain."""
        rec = req.spill
        if rec is None:
            return None
        req.spill = None
        self._spill_ledger.pop(id(req), None)
        self._spill_bytes_live -= rec.nbytes
        if rec.lease is not None:
            rec.lease.release()
            rec.lease = None
        rec.arrays = None
        if rec.shared_pages:
            self.kv.decref(rec.shared_pages)
            rec.shared_pages = []
        return rec

    def _drain_estimate_s(self) -> float:
        """Retry-after hint for :class:`PreemptionShed`: the soonest retire
        (least remaining budget of a live row) at the engine's per-token
        pace; half a second before the first block."""
        per_tok = self._block_s_ewma / max(self.block, 1)
        if per_tok <= 0.0:
            return 0.5
        remaining = min(
            (s.request.max_new - len(s.tokens) for s in self._slots.values()),
            default=self.block,
        )
        return per_tok * max(remaining, self.block)

    def _fail_preempted(self, req: _Request, cause: "BaseException | None") -> None:
        err = PreemptionShed(
            "preempted by KV pool exhaustion mid-stream and the spill tier "
            "could not park the row; a sampled stream cannot restart "
            "without splicing draws -- retry after the pool drains"
        )
        err.retry_after_s = self._drain_estimate_s()
        if cause is not None:
            err.__cause__ = cause
        self.preempt_failed += 1
        metrics.count("vlm_preempt_failed")
        _fail(req, err)

    def _unpack_spill(self, rec: _SpillRecord) -> list:
        """The record's payload leaves as host arrays. A lease is checked
        against its crc (a torn or recycled lease becomes a clean
        degradation, not corrupt tokens) and COPIED out: it recycles right
        after resume."""
        if rec.lease is None:
            if rec.arrays is None:
                raise RuntimeError("spill record has no payload (double resume?)")
            return list(rec.arrays)
        try:
            leaves = migration.unpack_payload(rec.lease.buf[: rec.nbytes], rec.crc)
        except ValueError as e:
            raise RuntimeError(f"spill lease rejected: {e}") from None
        return [leaf.copy() for leaf in leaves]

    def _resume_row(self, req: _Request) -> None:
        """Scatter a parked spill record into a fresh page grant and
        re-install the row: zero re-prefill, greedy continuation
        token-identical, sampled continuation on its own stream. A failure
        anywhere degrades to the ladder (requeue-and-redo or the typed
        shed)."""
        rec: _SpillRecord = req.spill
        slot = granted = None
        try:
            faults.check(KV_RESUME, f"{self.name}:resume")
            if req.migrate_in is not None:
                self._attach_migrate_shared(req, rec)
            leaves = self._unpack_spill(rec)
            n_layers = (len(leaves) - 1) // 2
            pages = [{"k": leaves[2 * i], "v": leaves[2 * i + 1]} for i in range(n_layers)]
            slot = self._free_slot()
            # Shared prefix pages re-attach by reference ahead of the
            # fresh grant; the scatter rewrites only the PRIVATE suffix.
            bt_row = self.kv.admit_exact(slot, rec.n_pages, shared_pages=rec.shared_pages or None)
            granted = slot
            base = len(rec.shared_pages)
            ids = np.zeros((rec.n_pad,), np.int32)
            ids[: rec.n_pages] = bt_row[base : base + rec.n_pages]
            self.gen.resume(
                self.pool, slot, pages, ids, leaves[-1], rec.cur_tok, rec.cur_len,
                rec.n_gen, req.max_new, req.temperature, req.top_p,
                req.do_sample, req.repetition_penalty,
            )
        except PoolExhausted:
            # Lost a page race (lane reservation, same-turn admissions):
            # keep the record parked and try again next turn.
            self._requeue_front([req])
            return
        except Exception as e:  # noqa: BLE001 - degrade, never wedge the loop
            if granted is not None:
                self.kv.release(granted)
            logger.warning("KV resume failed (%s); degrading", e)
            self._drop_spill(req)
            if req.migrate_in is not None:
                # A migrated-in row has no local prompt to redo from: refuse
                # it; the PREFILL host owns the fallback ladder and resumes
                # the row from its own snapshot.
                req.migrate_in = None
                self.migrate_in_rejected += 1
                metrics.count("vlm_migrate_in_rejected")
                _fail(req, e)
            elif not (req.do_sample and req.delivered > 0):
                self.preempt_redone += 1
                metrics.count("vlm_preempt_redone")
                self._requeue_front([req])
            else:
                self._fail_preempted(req, e)
            return
        self._admit_seq += 1
        slot_state = _Slot(request=req, prompt_len=rec.prompt_len, seq=self._admit_seq, tokens=rec.tokens)
        if self._spec_active():
            # The drafter's host mirrors: the prompt ids and the pending
            # token the record carried.
            slot_state.text_toks = self._text_toks(req)
            slot_state.pending_tok = rec.cur_tok
        with self._cond:
            self._slots[slot] = slot_state
        self.admitted += 1
        self.spill_resumes += 1
        metrics.count("vlm_spill_resumes")
        self._drop_spill(req)
        if req.migrate_in is not None:
            keys, _ = req.migrate_in
            req.migrate_in = None
            self.migrated_in += 1
            metrics.count("vlm_migrated_in")
            if self.prefix is not None and keys:
                # The migrated prompt's pages are cacheable history here
                # too: later same-prefix migrations (and local requests)
                # resolve them by reference instead of riding the wire.
                pages = self.kv.owned_pages(slot)[: len(keys)]
                self.prefix.insert(keys[: len(pages)], pages)
        record_event(
            "vlm_resume", self.name,
            f"row resumed into slot {slot}: {rec.n_pages} pages re-installed, "
            f"{len(rec.tokens)} tokens already out",
            min_interval_s=1.0,
            pages=rec.n_pages, tokens=len(rec.tokens),
        )

    # -- KV page migration (disaggregated prefill/decode) --------------------

    def _wire_manifest(self, req: _Request, n: int) -> list:
        """Content-hash chain keys over the prompt's page-aligned prefix
        (capped one page short like the prefix cache's attach cap): the
        offer leg's reference list. Empty when the request carries no
        content identity; the whole prompt then rides the wire."""
        if req.prefix_content is None:
            return []
        content = np.asarray(req.prefix_content)[:n]
        return chunk_keys(content, self.page_size)[: (n - 1) // self.page_size]

    def _migrate_sweep(self) -> None:
        """Hand freshly prefilled rows tagged for a decode-lane peer to the
        migration dispatcher: export through the spill tier's path (shared
        prefix CONTENTS included -- the peer may not hold them), mark the
        row done on the device (an in-place write, no host sync), release
        the slot, and let the dispatcher run the wire legs off-thread.
        Every failure re-enters via :meth:`resubmit_spilled` -- the
        preemption ladder with the peer as one more flaky sink, so a dead
        decode host never loses or duplicates tokens."""
        for idx in list(self._slots):
            slot = self._slots.get(idx)
            if slot is None:
                continue
            req = slot.request
            if not req.migrate_to or slot.tokens or req.cancelled:
                continue
            target, req.migrate_to = req.migrate_to, None  # one attempt
            try:
                # All owned pages export by content (n_shared=0): the record
                # is self-contained; reference-vs-contents is the
                # dispatcher's call after the peer answers the offer.
                rec, _ = self._export_state(idx, 0)
            except Exception as e:  # noqa: BLE001 - decode locally instead
                logger.warning("KV migrate-out export of slot %d failed (%s); decoding locally", idx, e)
                continue
            rec.prompt_len = slot.prompt_len
            rec.rng = self._wire_key()
            manifest = self._wire_manifest(req, slot.prompt_len)
            self.gen.retire(self.pool, [idx])
            with self._cond:
                self._slots.pop(idx, None)
            self.kv.release(idx)
            self.migrated_out += 1
            metrics.count("vlm_migrated_out")
            try:
                self.migrator(self, req, rec, manifest, target)
            except Exception as e:  # noqa: BLE001 - ladder, not a loss
                logger.warning("KV migration dispatch to %s failed (%s); resuming locally", target, e)
                self.resubmit_spilled(req, rec)

    def _wire_key(self) -> np.ndarray:
        """A migrating row's PRNG-key leaf: two ``uint32`` from the engine's
        generator, drawn on the loop thread (the generator's only user), so
        rows sampled on a JAX decode host draw from distinct keys."""
        key = torch.randint(0, 2**32, (2,), generator=self._rng, device=self._rng.device, dtype=torch.int64)
        return key.cpu().numpy().astype(np.uint32)

    def resubmit_spilled(self, req: _Request, rec: _SpillRecord) -> None:
        """Thread-safe re-entry for a migration that failed before or
        mid-stream: park the record as a spill and resume locally with zero
        re-prefill (greedy replays are token-identical and the
        ``delivered`` counter suppresses any already-streamed prefix). A
        sampled row whose peer already streamed past the snapshot cannot
        resume without splicing draws -- it sheds with the typed retryable
        error, exactly the preemption ladder."""
        self.migrate_out_failed += 1
        metrics.count("vlm_migrate_fallbacks")
        with self._cond:
            closed = self._closed
        if closed:
            _fail(req, RuntimeError("continuous scheduler is closed"))
            return
        if req.do_sample and req.delivered > rec.n_gen:
            self._fail_preempted(req, None)
            return
        req.spill = rec
        self._spill_ledger[id(req)] = rec
        self._spill_bytes_live += rec.nbytes
        self._requeue_front([req])
        with self._cond:
            self._cond.notify()

    def submit_migrated(self, req: _Request, rec: _SpillRecord, manifest: list, n_shared: int) -> None:
        """Decode-host entry for a ``fed_kv_put`` commit: park the wire
        record as a spill and queue the request -- the ordinary resume path
        then re-installs the row with ZERO re-prefill device work.
        ``manifest``/``n_shared`` defer shared-prefix resolution to the loop
        thread (the prefix cache is loop-owned); a lost race fails the
        request with :class:`migration.ChunksMissing`, which the wire
        handler maps to a retryable refusal."""
        need = rec.cur_len + max(int(req.max_new) - rec.n_gen, 0) + 1
        if not self.kv.fits(need):
            raise ValueError(
                f"migrated row needs {need} KV tokens but this pool holds at most "
                f"{min(self.kv.row_capacity(), (self.kv.pages_total - 1) * self.kv.page_size)} per row"
            )
        req.spill = rec
        req.migrate_in = (list(manifest), int(n_shared))
        if req.trace is None:
            req.trace = current_trace()
        with self._cond:
            if self._closed:
                raise RuntimeError("continuous scheduler is closed")
            self._spill_ledger[id(req)] = rec
            self._spill_bytes_live += rec.nbytes
            self._pending.append(req)
            self._cond.notify()

    def _attach_migrate_shared(self, req: _Request, rec: _SpillRecord) -> None:
        """Resolve a migrated-in row's shared-prefix references against the
        LOCAL prefix cache (loop thread -- authoritative, unlike the offer
        leg's advisory peek) and take the record's hold on them. Idempotent
        across page-race requeues: once ``shared_pages`` is set the
        references are held and re-resolution would double-count."""
        keys, n_shared = req.migrate_in
        if n_shared <= 0 or rec.shared_pages:
            return
        got = self.prefix.lookup(keys[:n_shared]) if self.prefix is not None else []
        if len(got) < n_shared:
            raise migration.ChunksMissing(
                f"offer promised {n_shared} cached prefix pages but only {len(got)} "
                "survive (evicted since the offer)"
            )
        got = got[:n_shared]
        self.kv.incref(got)
        rec.shared_pages = list(got)

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
        window's) writes; cached prefixes yield first, then the newest rows
        are preempted until the free list can grow the rest. Admission caps
        prefix attachment one token short of the prompt, so the write
        frontier is always private: a copy-on-write here means an allocator
        invariant broke, and it raises."""
        cow: list = []
        for idx in sorted(self._slots, key=lambda i: self._slots[i].seq):
            slot = self._slots.get(idx)
            if slot is None:
                continue
            need = self._row_need(slot, horizon)
            while not self.kv.grow(idx, need, cow):
                if self.prefix is not None and self.prefix.reclaim(1):
                    continue
                if not self._preempt_newest(protect=idx):
                    raise RuntimeError("paged pool cannot grow a lone row (feasibility bug)")
        if cow:
            raise RuntimeError(
                f"unexpected copy-on-write during decode growth: {cow} "
                "(prefix attachment must leave the write frontier private)"
            )

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
        if cancelled:
            self.gen.retire(self.pool, cancelled)
        for i in cancelled:
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
        active = len(self._slots)
        t0 = time.perf_counter()
        tm0 = time.monotonic()
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
        self._occ_rows += active
        self._occ_blocks += 1
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
        t1 = time.perf_counter()
        dt = t1 - t0
        if self._step_floor_s > 0.0:
            # Paced before tokens stream, so the first token pays the floor
            # too: a paced block stands for a slower card, not for late
            # bookkeeping.
            lag = self.block * self._step_floor_s - dt
            if lag > 0.0:
                time.sleep(lag)
                dt = time.perf_counter() - t0
        self._block_s_ewma = dt if self._block_s_ewma == 0.0 else 0.8 * self._block_s_ewma + 0.2 * dt
        # The duty credit covers the paced window: it describes that card.
        telemetry.busy(f"device:{self.name}", tm0, time.monotonic())
        span_meta = {
            "step": self.blocks_run,
            "rows": active,
            "fill_pct": round(100.0 * active / self.n_slots, 1),
            "block": self.block,
        }
        for idx in list(self._slots):
            slot = self._slots[idx]
            req = slot.request
            if req.trace is not None:
                req.trace.add_span("batch.device", t0, t1, dict(span_meta))
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
                metrics.count("vlm_spec_proposed", prop)
                metrics.count("vlm_spec_accepted", acc)
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
