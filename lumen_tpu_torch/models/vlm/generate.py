"""Generation programs for the continuous engine (twin of the pool
programs of ``lumen_tpu/models/vlm/generate.py``).

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

Not ported yet: the fused ``while_loop`` generate and the one-request
stream path (the continuous engine replaces both in serving), and the
programs of the spill tier and the prefix cache (``_export_row``,
``_resume``, ``_seed_prefix``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.sampling import apply_repetition_penalty, sample
from .modeling import VLMConfig, VLMModel, init_kv_cache, init_paged_kv_cache


class Generator:
    """Decode programs for one ``VLMModel`` on one device.

    ``max_seq`` bounds prompt + vision + new tokens (a row's block-table
    reach); ``seq_buckets`` are the prefill scratch lengths (a prompt's
    scratch is the smallest bucket covering it).
    """

    def __init__(
        self,
        model: VLMModel,
        cfg: VLMConfig,
        max_seq: int = 2048,
        cache_dtype=torch.bfloat16,
        seq_buckets: tuple[int, ...] | None = None,
    ):
        self.model = model
        self.cfg = cfg
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.device = next(model.parameters()).device
        buckets = sorted(set(b for b in (seq_buckets or ()) if b <= max_seq))
        if not buckets or buckets[-1] != max_seq:
            buckets.append(max_seq)
        self.seq_buckets = tuple(buckets)

    # -- shared pieces ------------------------------------------------------

    def _seen_from_prompt(self, prompt_ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """[B, V] bool mask of tokens in the (unpadded) prompt, for the
        repetition penalty."""
        b, s = prompt_ids.shape
        valid = torch.arange(s, device=prompt_ids.device)[None, :] < lengths[:, None]
        seen = torch.zeros((b, self.cfg.decoder.vocab_size), dtype=torch.bool, device=prompt_ids.device)
        rows = torch.arange(b, device=prompt_ids.device)[:, None].expand(b, s)
        seen[rows[valid], prompt_ids.long()[valid]] = True
        return seen

    def _sample_next(self, logits, seen, temperature, top_p, do_sample, rep, generator, any_sample=None):
        logits = apply_repetition_penalty(logits.float(), seen, rep)
        return sample(logits, temperature, top_p, do_sample, generator=generator, any_sample=any_sample)

    def _prefill_core(self, embeds, positions, lengths, kv_len: int | None = None):
        b = embeds.shape[0]
        caches = init_kv_cache(self.cfg, b, kv_len or self.max_seq, self.cache_dtype, self.device)
        logits, caches = self.model.decode(embeds, positions, caches, 0, lengths)
        last = logits[torch.arange(b, device=logits.device), lengths.long() - 1]  # [B, V]
        return caches, last

    # -- prefill ---------------------------------------------------------------

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

    def new_prefill_cache(self, kv_len: int):
        """Contiguous batch-1 scratch cache for one chunked prefill."""
        return init_kv_cache(self.cfg, 1, kv_len, self.cache_dtype, self.device)

    @torch.no_grad()
    def prefill_chunk(self, caches, embeds, positions, offset: int, valid_len):
        """One prompt chunk through the decoder (JAX ``_prefill_chunk_impl``):
        writes its K/V at ``offset`` into ``caches`` in place, returns the
        chunk's logits."""
        logits, _ = self.model.decode(embeds, positions, caches, int(offset), valid_len)
        return logits

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

    # -- continuous-batching pool (paged KV) ---------------------------------

    def init_pool(self, slots: int, pages: int | None = None, page_size: int = 16) -> dict:
        """All-slots-free paged pool state (JAX ``init_pool``). ``pages``
        defaults to every slot holding ``max_seq``. ``sampling`` is a host
        mirror of which slots were admitted sampled (it spares the decode
        loop a device sync to learn that no row samples)."""
        if pages is None:
            pages = slots * (-(-self.max_seq // page_size)) + 1
        dev = self.device

        def z(dtype, fill=0):
            return torch.full((slots,), fill, dtype=dtype, device=dev)

        return dict(
            caches=init_paged_kv_cache(self.cfg, pages, page_size, self.cache_dtype, dev),
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

    @torch.no_grad()
    def admit(
        self, pool, slot: int, caches1, tok0, seen1, length: int, bt_row,
        max_new: int, temperature: float, top_p: float, do_sample: bool, rep: float,
    ) -> None:
        """Write one prefilled request into ``slot`` (JAX ``_admit_impl``):
        scatter its contiguous prompt KV ([1, kvh, Lb, dh], ``Lb`` a page
        multiple) into the pages ``bt_row`` grants, page by page. Entries
        past the prompt's pages point at the dump page 0, so the scatter
        needs no mask. In place."""
        page = pool["caches"][0]["k"].shape[2]
        lb = caches1[0]["k"].shape[2]
        nseg = lb // page
        dst = torch.as_tensor(np.asarray(bt_row[:nseg]), dtype=torch.long, device=self.device)
        for layer, pre in zip(pool["caches"], caches1):
            for name in ("k", "v"):
                kvh, dh = pre[name].shape[1], pre[name].shape[3]
                seg = pre[name][0].reshape(kvh, nseg, page, dh).transpose(0, 1)
                layer[name][dst] = seg.to(layer[name].dtype)
        pool["cur_tok"][slot] = tok0[0]
        pool["cur_len"][slot] = int(length)
        pool["seen"][slot] = seen1[0]
        pool["n_gen"][slot] = 0
        pool["eos"][slot] = False
        pool["done"][slot] = max_new <= 0
        pool["max_new"][slot] = int(max_new)
        pool["temperature"][slot] = float(temperature)
        pool["top_p"][slot] = float(top_p)
        pool["do_sample"][slot] = bool(do_sample)
        pool["rep"][slot] = float(rep)
        pool["sampling"][slot] = bool(do_sample) and float(temperature) > 1e-6

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
