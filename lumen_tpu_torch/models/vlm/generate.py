"""Generation programs (twin of ``lumen_tpu/models/vlm/generate.py``):
the continuous engine's pool programs, and the coalescing scheduler's
fused decode (:meth:`Generator.generate`) and one-request stream
(:meth:`Generator.stream`).

PyTorch runs eagerly, so the JAX package's jitted programs are plain
methods here: prefill (whole prompt, or one chunk of it into a
contiguous scratch), admission of a prefilled row into the paged pool,
and a block of decode steps over every slot. Where the JAX programs
donated the pool and returned a new one, these methods update the pool
tensors IN PLACE and return nothing of it.

Sampling semantics are the JAX package's (greedy unless ``do_sample``
and temperature > 0; repetition penalty over the prompt and the tokens
emitted so far). Random numbers come from ``torch.Generator``s, so a
sampled continuation differs from the JAX one; greedy output does not.

Speculative decoding's verify program (:meth:`Generator.verify`) runs a
W-token window per row through one decode forward and accepts the drafted
tokens the model would have emitted itself.

The spill tier's export and resume (:meth:`Generator.export_row`,
:meth:`Generator.resume`) and the prefix cache's scratch seeding
(:meth:`Generator.seed_prefix`) are plain indexing on the pool tensors.
A row crosses between card and host in ONE copy each way: its leaves are
viewed as bytes and concatenated on the side they start from.

The JAX ``while_loop`` of the fused generate is a host loop over one
decode step against a contiguous KV buffer here. The host tracks every
row's length, so a step reads no device value but the one copy that
tells the loop which rows are done (``stream``: the emitted token).

On a tensor-parallel model (``model.tp``) every method marked
``@program`` is a device program of the group's runtime
(``runtime.tp_group``): rank 0 sends it to the worker ranks, which run
it on their own shards, pools and scratches. Sampling draws the same token
on every rank: the logits are bitwise identical after the sums, and each
program carries rank 0's ``torch.Generator`` state, so every rank
draws the same numbers without a broadcast of the tokens (one collective a
step saved). ``export_row`` gathers each rank's KV heads to rank 0, so
a spilled or migrated row keeps the format of a TP = 1 host; ``resume``
takes that format and each rank keeps its own heads. On an ``expert``
axis the ranks of one ``model`` place hold the same heads, and the MoE
layers sum their routed rows over the axis inside the programs. Over a
group's ``data`` places a ``Generator`` belongs to the place of its
model (its ``tp``'s runtime): its programs, its pools and scratches, its
spills and resumes run there, and an engine replica's generator at
another place than the manager's is another object.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...ops.sampling import apply_repetition_penalty, sample
from ...runtime.tp_group import program
from .modeling import VLMConfig, VLMModel, init_kv_cache, init_paged_kv_cache


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype; bf16 is ``ml_dtypes.bfloat16``,
    the dtype the JAX package's host arrays carry, so a spill payload has
    the same bytes and leaf dtypes in both packages."""
    if dtype == torch.bfloat16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return torch.empty((), dtype=dtype).numpy().dtype


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    """Inverse of :func:`numpy_dtype`."""
    dtype = np.dtype(dtype)
    if dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), dtype)).dtype


@dataclass
class GenerateOutput:
    tokens: np.ndarray  # [B, max_new_cap] generated ids, pad-filled after EOS
    n_generated: np.ndarray  # [B] count of live tokens (EOS included)
    stopped_eos: np.ndarray  # [B] bool: hit EOS (vs the length cap)


class PoolState(dict):
    """The continuous engine's paged pool (:meth:`Generator.init_pool`): a
    dict a tensor-parallel group registers as one rank-local object."""

    _tp_local = True


class Generator:
    """Decode programs for one ``VLMModel`` on one device (one rank's
    shards of a tensor-parallel model).

    ``max_seq`` bounds prompt + vision + new tokens (a row's block-table
    reach, the fused decode's largest KV buffer); ``seq_buckets`` are the
    prefill scratch lengths and the fused decode's KV buffer sizes (the
    smallest covering the request); ``max_new_cap`` is the fused decode's
    output width.
    """

    _tp_local = True

    def __init__(
        self,
        model: VLMModel,
        cfg: VLMConfig,
        max_seq: int = 2048,
        cache_dtype=torch.bfloat16,
        seq_buckets: tuple[int, ...] | None = None,
        max_new_cap: int = 512,
    ):
        self.model = model
        self.cfg = cfg
        self.max_seq = max_seq
        self.max_new_cap = max_new_cap
        self.cache_dtype = cache_dtype
        self.device = next(model.decoder.parameters()).device
        #: the model's tensor-parallel place and runtime (None at TP = 1)
        self.tp = getattr(model, "tp", None)
        self.runtime = self.tp.runtime if self.tp is not None else None
        attn = model.decoder.layers[0].attn
        #: this rank's KV heads (all of them at TP = 1) and their plan
        self.kv_heads, self.attn_plan = attn.kv_heads, attn.plan
        buckets = sorted(set(b for b in (seq_buckets or ()) if b <= max_seq))
        if not buckets or buckets[-1] != max_seq:
            buckets.append(max_seq)
        self.seq_buckets = tuple(buckets)

    # -- shared pieces ------------------------------------------------------

    def _seen_from_prompt(self, prompt_ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """[B, V] bool mask of tokens in the (unpadded) prompt, for the
        repetition penalty. Padding scatters into a spare column, so no
        device value is read back."""
        b, s = prompt_ids.shape
        v = self.cfg.decoder.vocab_size
        valid = torch.arange(s, device=prompt_ids.device)[None, :] < lengths[:, None]
        idx = torch.where(valid, prompt_ids.long(), v)
        seen = torch.zeros((b, v + 1), dtype=torch.bool, device=prompt_ids.device)
        return seen.scatter_(1, idx, True)[:, :v].contiguous()

    def _sample_next(self, logits, seen, temperature, top_p, do_sample, rep, generator, any_sample=None):
        logits = apply_repetition_penalty(logits.float(), seen, rep)
        return sample(logits, temperature, top_p, do_sample, generator=generator, any_sample=any_sample)

    def _prefill_core(self, embeds, positions, lengths, kv_len: int | None = None):
        b = embeds.shape[0]
        caches = init_kv_cache(self.cfg, b, kv_len or self.max_seq, self.cache_dtype, self.device, self.kv_heads)
        logits, caches = self.model.decode(embeds, positions, caches, 0, lengths, last=lengths - 1)
        return caches, logits[:, 0]  # [B, V]

    # -- prefill ---------------------------------------------------------------

    @program
    @torch.no_grad()
    def prefill(
        self, embeds, positions, lengths, prompt_ids, generator,
        temperature, top_p, do_sample, repetition_penalty, kv_len: int | None = None,
    ):
        """Whole-prompt prefill into a fresh contiguous scratch of
        ``kv_len`` slots (JAX ``_prefill_impl``). Returns ``(caches, tok0,
        seen)``; generation params are per-row [B] tensors."""
        caches, last = self._prefill_core(embeds, positions, lengths, kv_len)
        seen = self._seen_from_prompt(prompt_ids, lengths)
        tok0 = self._sample_next(
            last, seen, temperature, top_p, do_sample, repetition_penalty, generator
        ).int()
        return caches, tok0, seen

    @program
    def new_prefill_cache(self, kv_len: int):
        """Contiguous batch-1 scratch cache for one chunked prefill."""
        return init_kv_cache(self.cfg, 1, kv_len, self.cache_dtype, self.device, self.kv_heads)

    @program
    @torch.no_grad()
    def prefill_chunk(self, caches, embeds, positions, offset: int, valid_len, last_only: bool = False):
        """One prompt chunk through the decoder (JAX ``_prefill_chunk_impl``):
        writes its K/V at ``offset`` into ``caches`` in place, returns the
        chunk's logits [B, chunk, V]; with ``last_only`` only each row's
        last valid position in the chunk, [B, 1, V] (``chunk_finish`` then
        reads index 0)."""
        last = None
        if last_only:
            last = torch.clamp(valid_len.to(embeds.device) - 1 - int(offset), 0, embeds.shape[1] - 1)
        logits, _ = self.model.decode(embeds, positions, caches, int(offset), valid_len, last=last)
        return logits

    @program
    def seq_slice(self, x, lo: int, hi: int):
        """``x[:, lo:hi]`` on every rank: a program's output (a prompt's
        embeddings) is sliced where it lives, as a view passed by value
        would carry rank 0's values to the workers."""
        return x[:, lo:hi]

    @program
    @torch.no_grad()
    def chunk_finish(
        self, chunk_logits, idx, prompt_ids, lengths, generator,
        temperature, top_p, do_sample, repetition_penalty,
    ):
        """Sample token 0 from the last live chunk's logits at in-chunk
        index ``idx`` [B] (JAX ``_chunk_finish_impl``)."""
        b = chunk_logits.shape[0]
        last = chunk_logits[torch.arange(b, device=chunk_logits.device), idx.long()]
        seen = self._seen_from_prompt(prompt_ids, lengths)
        tok0 = self._sample_next(
            last, seen, temperature, top_p, do_sample, repetition_penalty, generator
        ).int()
        return tok0, seen

    # -- fused decode and one-request stream (the coalescing scheduler) -------

    def _row_params(self, b: int, temperature, top_p, do_sample, repetition_penalty):
        """Per-row sampling params on the device (each a scalar or a length-B
        sequence) and the host's knowledge of whether any row samples."""
        dev = self.device

        def rows(value, dtype):
            return np.array(np.broadcast_to(np.asarray(value, dtype), (b,)))

        temp, smp = rows(temperature, np.float32), rows(do_sample, bool)
        params = [torch.as_tensor(a, device=dev) for a in (
            temp, rows(top_p, np.float32), smp, rows(repetition_penalty, np.float32))]
        return params, bool(np.any(smp & (temp > 1e-6)))

    def _decode_step(self, caches, cur_tok, cur_len, kv_bound: int, seen, generator, params, any_sample):
        """One token per row against the contiguous ``caches`` at per-row
        slot ``cur_len``: returns the next token [B] (int32)."""
        tok_embed = self.model.embed_tokens(cur_tok.long()[:, None]).to(self.cache_dtype)
        logits, _ = self.model.decode(tok_embed, cur_len[:, None], caches, cur_len, cur_len + 1, kv_bound=kv_bound)
        return self._sample_next(logits[:, 0], seen, *params, generator, any_sample).int()

    @program
    @torch.no_grad()
    def generate(
        self, embeds, positions, lengths, prompt_ids, generator,
        max_new_tokens=256, temperature=0.0, top_p=1.0, do_sample=False, repetition_penalty=1.0,
    ) -> GenerateOutput:
        """Prefill plus decode to EOS or each row's budget (JAX
        ``generate``): ``embeds`` [B, L, H] right-padded merged prompts,
        ``positions`` [B, L], ``lengths`` [B] live counts, ``prompt_ids``
        [B, S] (repetition penalty). Each generation param is a scalar or a
        length-B sequence; ``max_new_tokens`` is capped at ``max_new_cap``,
        and a row with a zero budget emits nothing. The KV buffer is the
        smallest ``seq_buckets`` entry covering the PADDED prompt plus the
        largest budget. Emission semantics are the JAX loop body's; the
        loop stops when every row is done. A step reads back one [B] bool
        copy (which rows are done); the host tracks the lengths, so the
        cache decode's key ladder costs no read. Returns host arrays."""
        b = embeds.shape[0]
        dev = self.device
        cfg = self.cfg
        cap = np.minimum(np.broadcast_to(np.asarray(max_new_tokens, np.int64), (b,)), self.max_new_cap)
        need = int(embeds.shape[1]) + int(cap.max())
        kv_len = next((s for s in self.seq_buckets if s >= need), self.max_seq)
        len_h = (lengths.cpu().numpy() if isinstance(lengths, torch.Tensor) else np.asarray(lengths)).astype(np.int64)
        lengths = torch.as_tensor(len_h, device=dev)
        params, any_sample = self._row_params(b, temperature, top_p, do_sample, repetition_penalty)
        caches, last = self._prefill_core(embeds, positions, lengths, kv_len)
        seen = self._seen_from_prompt(prompt_ids, lengths)
        cur_tok = self._sample_next(last, seen, *params, generator, any_sample).int()
        max_new = torch.as_tensor(cap, dtype=torch.int32, device=dev)
        done_h = cap <= 0
        done = torch.as_tensor(done_h, device=dev)
        eos = torch.zeros((b,), dtype=torch.bool, device=dev)
        n_gen = torch.zeros((b,), dtype=torch.int32, device=dev)
        buf = torch.full((b, self.max_new_cap), cfg.pad_token_id, dtype=torch.int32, device=dev)
        cur_len, cur_len_h = lengths.int(), len_h.copy()
        rows = torch.arange(b, device=dev)
        t = 0
        while t < cap.max() and not done_h.all():
            active, active_h = ~done, ~done_h
            buf[:, t] = torch.where(active, cur_tok, cfg.pad_token_id)
            n_gen += active.int()
            seen[rows, cur_tok.long()] |= active
            eos |= active & (cur_tok == cfg.eos_token_id)
            done = done | eos | (n_gen >= max_new)
            cur_tok = self._decode_step(
                caches, cur_tok, cur_len, int(cur_len_h.max()) + 1, seen, generator, params, any_sample
            )
            cur_len = cur_len + active.int()
            cur_len_h += active_h
            t += 1
            done_h = done.cpu().numpy()
        return GenerateOutput(tokens=buf.cpu().numpy(), n_generated=n_gen.cpu().numpy(), stopped_eos=eos.cpu().numpy())

    @torch.no_grad()
    def stream(
        self, embeds, positions, lengths, prompt_ids, generator,
        max_new_tokens: int = 256, temperature: float = 0.0, top_p: float = 1.0,
        do_sample: bool = False, repetition_penalty: float = 1.0,
    ):
        """Yield one request's generated token ids one at a time (JAX
        ``stream``; batch 1): prefill into a ``max_seq`` buffer, then one
        decode step per token, whose id is the step's one read back. Stops
        after EOS or ``max_new_tokens``. The prefill and each step are
        programs, so a consumer that stops early leaves no rank inside a
        step."""
        len_h = int(lengths[0]) if not isinstance(lengths, torch.Tensor) else int(lengths.cpu()[0])
        params, any_sample = self._row_params(1, temperature, top_p, do_sample, repetition_penalty)
        caches, seen, tok, cur_len = self._stream_open(embeds, positions, len_h, prompt_ids, generator, params,
                                                       any_sample)
        for t in range(min(int(max_new_tokens), self.max_new_cap)):
            tok_host = int(tok[0])
            yield tok_host
            if tok_host == self.cfg.eos_token_id:
                return
            tok, cur_len = self._stream_step(caches, seen, tok, tok_host, cur_len, len_h + t + 1, generator, params,
                                             any_sample)

    @program
    @torch.no_grad()
    def _stream_open(self, embeds, positions, len_h: int, prompt_ids, generator, params, any_sample):
        lengths = torch.tensor([len_h], device=self.device)
        caches, last = self._prefill_core(embeds, positions, lengths)
        seen = self._seen_from_prompt(prompt_ids, lengths)
        tok = self._sample_next(last, seen, *params, generator, any_sample).int()
        return caches, seen, tok, lengths.int()

    @program
    @torch.no_grad()
    def _stream_step(self, caches, seen, tok, tok_host: int, cur_len, kv_bound: int, generator, params, any_sample):
        seen[0, tok_host] = True
        tok = self._decode_step(caches, tok, cur_len, kv_bound, seen, generator, params, any_sample)
        return tok, cur_len + 1

    # -- continuous-batching pool (paged KV) ---------------------------------

    @program
    def init_pool(self, slots: int, pages: int | None = None, page_size: int = 16) -> PoolState:
        """All-slots-free paged pool state (JAX ``init_pool``). ``pages``
        defaults to every slot holding ``max_seq``. ``sampling`` is a host
        mirror of which slots were admitted sampled (it spares the decode
        loop a device sync to learn that no row samples)."""
        if pages is None:
            pages = slots * (-(-self.max_seq // page_size)) + 1
        dev = self.device

        def z(dtype, fill=0):
            return torch.full((slots,), fill, dtype=dtype, device=dev)

        return PoolState(
            caches=init_paged_kv_cache(self.cfg, pages, page_size, self.cache_dtype, dev, self.kv_heads),
            cur_tok=z(torch.int32),
            cur_len=z(torch.int32),
            seen=torch.zeros((slots, self.cfg.decoder.vocab_size), dtype=torch.bool, device=dev),
            n_gen=z(torch.int32),
            eos=z(torch.bool),
            done=z(torch.bool, True),  # free slot == done
            max_new=z(torch.int32),
            temperature=z(torch.float32),
            top_p=z(torch.float32, 1.0),
            do_sample=z(torch.bool),
            rep=z(torch.float32, 1.0),
            sampling=np.zeros((slots,), bool),
        )

    @program
    @torch.no_grad()
    def admit(
        self, pool, slot: int, caches1, tok0, seen1, length: int, bt_row,
        max_new: int, temperature: float, top_p: float, do_sample: bool, rep: float, row: int = 0,
    ) -> None:
        """Write one prefilled request into ``slot`` (JAX ``_admit_impl``):
        scatter row ``row`` of its contiguous prompt KV ([B, kvh, Lb, dh],
        ``Lb`` a page multiple; ``tok0`` and ``seen1`` hold the same rows)
        into the pages ``bt_row`` grants, page by page. Entries past the
        prompt's pages point at the dump page 0, so the scatter needs no
        mask. In place."""
        page = pool["caches"][0]["k"].shape[2]
        lb = caches1[0]["k"].shape[2]
        nseg = lb // page
        dst = torch.as_tensor(np.asarray(bt_row[:nseg]), dtype=torch.long, device=self.device)
        for layer, pre in zip(pool["caches"], caches1):
            for name in ("k", "v"):
                kvh, dh = pre[name].shape[1], pre[name].shape[3]
                seg = pre[name][row].reshape(kvh, nseg, page, dh).transpose(0, 1)
                layer[name][dst] = seg.to(layer[name].dtype)
        pool["cur_tok"][slot] = tok0[row]
        pool["cur_len"][slot] = int(length)
        pool["seen"][slot] = seen1[row]
        pool["n_gen"][slot] = 0
        pool["eos"][slot] = False
        pool["done"][slot] = max_new <= 0
        pool["max_new"][slot] = int(max_new)
        pool["temperature"][slot] = float(temperature)
        pool["top_p"][slot] = float(top_p)
        pool["do_sample"][slot] = bool(do_sample)
        pool["rep"][slot] = float(rep)
        pool["sampling"][slot] = bool(do_sample) and float(temperature) > 1e-6

    @program
    def retire(self, pool, slots) -> None:
        """Mark ``slots`` done (finished, cancelled, preempted or exported
        rows): a free slot is a done one. In place."""
        for slot in slots:
            pool["done"][slot] = True

    @program
    @torch.no_grad()
    def step_block(self, pool, block_tables, generator, block: int) -> torch.Tensor:
        """Advance every live slot ``block`` tokens (JAX
        ``_step_block_impl``): per-slot budgets, EOS and repetition
        penalty, free and finished slots masked out. Every step's K/V write
        and attention go through ``block_tables`` [B, maxp]; the scheduler
        guarantees live rows' pages cover ``cur_len + block``. Returns the
        emitted tokens [B, block] (pad where a row was not active)."""
        cfg = self.cfg
        b = pool["cur_tok"].shape[0]
        capacity = block_tables.shape[1] * pool["caches"][0]["k"].shape[2]
        rows = torch.arange(b, device=self.device)
        any_sample = bool(pool["sampling"].any())
        out = []
        for _ in range(block):
            active = ~pool["done"]
            cur = pool["cur_tok"]
            out.append(torch.where(active, cur, cfg.pad_token_id))
            pool["n_gen"] += active.int()
            pool["seen"][rows, cur.long()] |= active
            pool["eos"] |= active & (cur == cfg.eos_token_id)
            pool["done"] |= pool["eos"] | (pool["n_gen"] >= pool["max_new"])
            tok_embed = self.model.embed_tokens(cur.long()[:, None]).to(self.cache_dtype)
            # Free slots hold cur_len 0 and done rows stop advancing; the
            # clamp only guards a full row writing past its block table.
            pos = torch.clamp(pool["cur_len"], max=capacity - 1)
            logits, _ = self.model.decode_paged(
                tok_embed, pos[:, None], pool["caches"], block_tables, pos, pos + 1
            )
            nxt = self._sample_next(
                logits[:, 0], pool["seen"], pool["temperature"], pool["top_p"],
                pool["do_sample"], pool["rep"], generator, any_sample,
            ).int()
            pool["cur_tok"] = nxt
            pool["cur_len"] += active.int()
        return torch.stack(out, dim=1)

    @program
    @torch.no_grad()
    def verify(self, pool, block_tables, generator, draft, q_lens, width: int) -> torch.Tensor:
        """Speculative verify (JAX ``_verify_impl``): ONE decode forward
        over a ``width``-token window per row (width = K + 1), then an
        accept scan whose emission semantics mirror :meth:`step_block`.
        ``draft`` [B, width]: column 0 is overwritten with the row's pending
        ``cur_tok``, columns 1.. are the drafter's proposals; ``q_lens``
        [B] in 1..width caps how many window slots a row may consume (a
        row with no draft runs q_len 1, the plain one-token step). Window
        slot t attends over exactly the KV a sequential step at that
        position would see, so greedy output is token-identical to
        non-speculative decode; rejected slots' K/V land above the row's
        final ``cur_len``, where the length mask hides them until real
        tokens overwrite them. The pool is updated in place. Returns the
        emitted tokens [B, width] (pad past a row's accepted run)."""
        cfg = self.cfg
        b = pool["cur_tok"].shape[0]
        capacity = block_tables.shape[1] * pool["caches"][0]["k"].shape[2]
        dev = self.device
        rows = torch.arange(b, device=dev)
        toks_in = draft.to(device=dev, dtype=torch.int32).clone()
        toks_in[:, 0] = pool["cur_tok"]
        q_lens = q_lens.to(dev)
        # Like step_block's clamp: the scheduler never dispatches a live
        # row whose window would cross its block table's capacity.
        pos0 = torch.clamp(pool["cur_len"], max=capacity - width)
        positions = pos0[:, None] + torch.arange(width, device=dev, dtype=pos0.dtype)[None, :]
        embeds = self.model.embed_tokens(toks_in.long()).to(self.cache_dtype)
        logits, _ = self.model.decode_paged(
            embeds, positions, pool["caches"], block_tables, pos0, pos0 + 1
        )
        any_sample = bool(pool["sampling"].any())
        cur_tok, cur_len = pool["cur_tok"], pool["cur_len"]
        seen, n_gen = pool["seen"], pool["n_gen"]
        eos, done = pool["eos"], pool["done"]
        accepting = torch.ones((b,), dtype=torch.bool, device=dev)
        toks_out = torch.full((b, width), cfg.pad_token_id, dtype=torch.int32, device=dev)
        for t in range(width):
            step_active = ~done & accepting
            toks_out[:, t] = torch.where(step_active, cur_tok, cfg.pad_token_id)
            n_gen = n_gen + step_active.int()
            seen[rows, cur_tok.long()] |= step_active
            eos = eos | (step_active & (cur_tok == cfg.eos_token_id))
            done = done | eos | (n_gen >= pool["max_new"])
            nxt = self._sample_next(
                logits[:, t], seen, pool["temperature"], pool["top_p"],
                pool["do_sample"], pool["rep"], generator, any_sample,
            ).int()
            cur_len = cur_len + step_active.int()
            if t + 1 < width:
                # Slot t+1 survives only if its drafted token IS what the
                # model just chose: then its logits are exactly the
                # sequential step's.
                accepting = step_active & ~done & (t + 1 < q_lens) & (toks_in[:, t + 1] == nxt)
            cur_tok = torch.where(step_active, nxt, cur_tok)
        pool.update(cur_tok=cur_tok, cur_len=cur_len, n_gen=n_gen, eos=eos, done=done)
        return toks_out

    # -- KV spill tier and prefix cache ----------------------------------------

    @program
    @torch.no_grad()
    def export_row(self, pool, slot: int, page_ids) -> dict:
        """One decode row's spillable state on the host (JAX
        ``_export_row_impl``): its KV pages ``page_ids`` (block-table
        order, padded to a power of two with the dump page 0, whose
        garbage the resume scatter writes straight back to page 0) as
        per-layer ``{"k", "v"}`` arrays ``[n_pad, kvh, page, dh]``, the
        ``seen`` mask ``[V]`` and the decode scalars ``cur_tok``,
        ``cur_len``, ``n_gen``. Every leaf is viewed as bytes and
        concatenated on the card, so the row reaches the host in one
        device-to-host copy; ``.cpu()`` returns after the copy, so the
        caller may hand the pages to another row at once. On a
        tensor-parallel model every rank's KV heads are gathered over its
        ``model`` axis (each head once: an expert place's ranks hold every
        head between them), and the group's rank 0 alone returns the row
        (the workers return None)."""
        ids = torch.as_tensor(np.asarray(page_ids), dtype=torch.long, device=self.device)
        pages = [layer[name].index_select(0, ids) for layer in pool["caches"] for name in ("k", "v")]
        if self.tp is not None:
            pages = [self.tp.gather_heads(p, self.attn_plan, self.cfg.decoder.kv_heads) for p in pages]
            if (self.runtime.rank if self.runtime is not None else self.tp.rank) != 0:
                return None
        scalars = torch.stack([pool["cur_tok"][slot], pool["cur_len"][slot], pool["n_gen"][slot]]).int()
        leaves = pages + [scalars, pool["seen"][slot]]
        host = torch.cat([t.reshape(-1).view(torch.uint8) for t in leaves]).cpu().numpy()
        out, off = [], 0
        for t in leaves:
            n = t.numel() * t.element_size()
            out.append(host[off : off + n].view(numpy_dtype(t.dtype)).reshape(tuple(t.shape)))
            off += n
        *pages_np, scalars_np, seen_np = out
        layers = [{"k": pages_np[2 * i], "v": pages_np[2 * i + 1]} for i in range(len(pool["caches"]))]
        cur_tok, cur_len, n_gen = (int(x) for x in scalars_np)
        return dict(pages=layers, seen=seen_np, cur_tok=cur_tok, cur_len=cur_len, n_gen=n_gen)

    @program
    @torch.no_grad()
    def resume(
        self, pool, slot: int, pages, page_ids, seen1, cur_tok: int, cur_len: int, n_gen: int,
        max_new: int, temperature: float, top_p: float, do_sample: bool, rep: float,
    ) -> None:
        """Re-install a spilled row into ``slot`` (JAX ``_resume_impl``):
        scatter the exported ``pages`` (host arrays, per-layer ``{"k",
        "v"}``, the layout of :meth:`export_row`) into the fresh grant
        ``page_ids`` and restore the decode scalars exactly. ``cur_tok`` is
        the sampled but not yet emitted next token, so a greedy row goes
        on token-identically and a sampled one carries on its own draw.
        The host leaves reach the card in one copy. Pad entries of
        ``page_ids`` all write the dump page 0, which is harmless only
        because page 0 holds garbage: a live page id that repeats would
        lose a page, so it raises. A tensor-parallel rank keeps its own KV
        heads of ``pages`` (every head, :meth:`export_row`'s format). In
        place."""
        ids = np.asarray(page_ids)
        live = ids[ids != 0]
        if np.unique(live).size != live.size:
            raise ValueError(f"resume grant repeats a live page: {ids.tolist()}")
        leaves = [layer[name] for layer in pages for name in ("k", "v")] + [np.asarray(seen1)]
        buf = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.uint8) for a in leaves])
        dev = torch.from_numpy(buf).to(self.device)
        src, off = [], 0
        for a in leaves:
            src.append(dev[off : off + a.nbytes].view(torch_dtype(a.dtype)).reshape(a.shape))
            off += a.nbytes
        dst = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        targets = [layer[name] for layer in pool["caches"] for name in ("k", "v")]
        plan = self.attn_plan
        for t, s in zip(targets, src[:-1]):
            if plan is not None and t.shape[1] != s.shape[1]:
                s = s[:, plan.kv_lo : plan.kv_lo + plan.kv_heads]
            t[dst] = s.to(t.dtype)
        pool["cur_tok"][slot] = int(cur_tok)
        pool["cur_len"][slot] = int(cur_len)
        pool["seen"][slot] = src[-1]
        pool["n_gen"][slot] = int(n_gen)
        pool["eos"][slot] = False
        pool["done"][slot] = False
        pool["max_new"][slot] = int(max_new)
        pool["temperature"][slot] = float(temperature)
        pool["top_p"][slot] = float(top_p)
        pool["do_sample"][slot] = bool(do_sample)
        pool["rep"][slot] = float(rep)
        # The host mirror step_block reads to skip sampling: without it a
        # resumed sampled row would decode greedily whenever no other live
        # row samples.
        pool["sampling"][slot] = bool(do_sample) and float(temperature) > 1e-6

    @program
    @torch.no_grad()
    def seed_prefix(self, caches, pool, page_ids):
        """Prefix-cache hit (JAX ``_seed_prefix_impl``): fill a chunked-
        prefill scratch ``[1, kvh, Lb, dh]`` with the prefix KV gathered
        from the pages ``page_ids`` of the pool ``pool`` (the row's shared pages padded to
        ``Lb / page`` entries with the dump page 0), so only the uncovered
        suffix runs through the decoder. Pad segments land where the suffix
        chunk writes before it attends, or past the valid length. In
        place; returns ``caches``."""
        ids = torch.as_tensor(np.asarray(page_ids), dtype=torch.long, device=self.device)
        for dst, src in zip(caches, pool["caches"]):
            for name in ("k", "v"):
                seg = src[name].index_select(0, ids)  # [nseg, kvh, page, dh]
                nseg, kvh, page, dh = seg.shape
                dst[name].copy_(seg.transpose(0, 1).reshape(1, kvh, nseg * page, dh))
        return caches
