"""Content-addressed prefix KV cache for the paged continuous engine.

Serving traffic repeats prompt PREFIXES far more than whole prompts: a
shared system prompt in front of every request, a per-tenant caption
template, the same image asked a different question. The result cache
(:mod:`~lumen_tpu.runtime.result_cache`) only absorbs byte-identical
whole requests; everything else re-prefills a prefix whose KV is already
resident in the page pool. This module closes that gap with the same
content-address idiom, one page at a time:

- the KEY for page ``i`` of a prompt is the sha256 CHAIN hash
  ``h_i = sha256(h_{i-1} || content[i*ps:(i+1)*ps])`` over the prompt's
  page-aligned *content identity* (token ids, with vision positions
  substituted by ints derived from the image-bytes digest — see
  ``VLMManager._prefix_content``). Chaining makes a page's key encode its
  entire prefix, so a lookup is a walk down one path of a prefix tree and
  two different prompts can never collide on a shared suffix.
- the VALUE is a physical page id in the :class:`~.paged_kv.PagedKVPool`;
  the cache holds ONE reference on it. A hit attaches the matched pages
  to a new row as a block-table copy (``PagedKVPool.admit_shared``) and
  only the uncovered suffix runs through prefill — the device work for a
  hot prefix is ~zero.

Eviction is LRU over LEAF entries (an interior entry's children would
become unreachable — wasted pages the walk can never find again), bounded
by a ``LUMEN_VLM_PREFIX_BYTES`` / ``LUMEN_VLM_PREFIX_ENTRIES`` budget;
``reclaim`` additionally frees sole-reference pages (refcount == 1 — the
cache is the only holder) when the pool itself runs dry, so cached
prefixes yield to live rows before any row is preempted. Unconfigured
(no budget set) no cache is built at all and the engine's admission path
is byte-identical to the cache-less build.

NOT thread-safe: owned by the continuous scheduler's single loop thread,
exactly like the page pool it holds references in.
"""

from __future__ import annotations

import hashlib
import logging
from collections import OrderedDict

import numpy as np

from ...utils.env import env_int
from ...utils.metrics import metrics
from .paged_kv import PagedKVPool

logger = logging.getLogger(__name__)

PREFIX_BYTES_ENV = "LUMEN_VLM_PREFIX_BYTES"
PREFIX_ENTRIES_ENV = "LUMEN_VLM_PREFIX_ENTRIES"

#: domain-separation seed for the chain hash (position 0 has no parent).
_CHAIN_SEED = b"lumen-vlm-prefix-v1"


def prefix_budget_bytes() -> int:
    """``LUMEN_VLM_PREFIX_BYTES`` — device bytes (page size x layer KV
    footprint) the cache may pin in the page pool. 0/unset disables
    prefix caching entirely."""
    return env_int(PREFIX_BYTES_ENV, 0, minimum=0)


def prefix_cache_enabled() -> bool:
    return prefix_budget_bytes() > 0


def chunk_keys(content: np.ndarray, page_size: int) -> list[bytes]:
    """Chain-hash keys for every FULL page of ``content`` (the prompt's
    content-identity array). Partial tail pages are never cached — their
    contents would be mutated by the first decode writes."""
    arr = np.ascontiguousarray(content, dtype=np.int64)
    keys: list[bytes] = []
    prev = _CHAIN_SEED
    for i in range(arr.shape[0] // page_size):
        h = hashlib.sha256(prev)
        h.update(arr[i * page_size : (i + 1) * page_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


class _Entry:
    __slots__ = ("page", "parent", "children")

    def __init__(self, page: int, parent: bytes | None):
        self.page = page
        self.parent = parent
        self.children = 0


class PrefixCache:
    """Bounded chain-hash map ``prefix key -> pooled page id``, holding
    one pool reference per entry."""

    def __init__(self, pool: PagedKVPool, page_nbytes: int):
        self._pool = pool
        self.page_nbytes = max(1, int(page_nbytes))
        budget = prefix_budget_bytes()
        by_bytes = max(1, budget // self.page_nbytes) if budget else 0
        explicit = env_int(PREFIX_ENTRIES_ENV, None, minimum=1)
        if explicit is not None:
            self.max_entries = min(explicit, by_bytes) if by_bytes else explicit
        else:
            self.max_entries = by_bytes or 1
        # OrderedDict = LRU order (move_to_end on touch); an entry's key
        # encodes its whole prefix, so this is a prefix tree flattened
        # into one map with parent/children links for leaf-only eviction.
        self._entries: OrderedDict[bytes, _Entry] = OrderedDict()
        self.evictions = 0

    # -- queries -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_held(self) -> int:
        return len(self._entries) * self.page_nbytes

    def held_pages(self) -> list[int]:
        """Every page id the cache holds a reference on (tests/drain)."""
        return [e.page for e in self._entries.values()]

    def lookup(self, keys: list[bytes]) -> list[int]:
        """Longest cached prefix: page ids for the leading run of ``keys``
        present in the cache (LRU-touched). Stops at the first miss —
        chain keys make a gap unbridgeable by construction."""
        pages: list[int] = []
        for k in keys:
            e = self._entries.get(k)
            if e is None:
                break
            self._entries.move_to_end(k)
            pages.append(e.page)
        return pages

    def peek(self, keys: list[bytes]) -> int:
        """ADVISORY leading-run length for ``keys`` — no LRU touch, no
        reference taken, no mutation. Serves the migration offer leg
        from the gRPC thread while the loop thread owns the cache: a
        concurrent resize can at worst mis-size the answer, and the
        commit leg re-resolves authoritatively on the loop thread
        (:class:`~.migration.ChunksMissing` on a lost race). Callers
        off the loop thread must treat any exception as 0."""
        n = 0
        for k in keys:
            if k not in self._entries:
                break
            n += 1
        return n

    # -- mutation ----------------------------------------------------------

    def insert(self, keys: list[bytes], pages: list[int]) -> int:
        """Record a freshly installed row's full prompt pages. Existing
        entries are LRU-touched and KEPT (same content may live in two
        physical pages when two cold rows raced — the cached id is the
        one future hits attach); new entries take one pool reference.
        Returns how many entries were added."""
        added = 0
        parent: _Entry | None = None
        for i, (k, page) in enumerate(zip(keys, pages)):
            e = self._entries.get(k)
            if e is None:
                if not self._make_room():
                    break
                self._pool.incref([page])
                # Parent link is the PREVIOUS key (not the entry object)
                # so eviction can fix up children counts by lookup.
                e = _Entry(page, keys[i - 1] if i else None)
                self._entries[k] = e
                if parent is not None:
                    parent.children += 1
                added += 1
            else:
                self._entries.move_to_end(k)
            parent = e
        return added

    def _pop(self, key: bytes, entry: _Entry) -> int:
        """Drop one entry (must be a leaf) and its pool reference."""
        del self._entries[key]
        if entry.parent is not None:
            par = self._entries.get(entry.parent)
            if par is not None:
                par.children -= 1
        freed = self._pool.decref([entry.page])
        self.evictions += 1
        metrics.count("vlm_prefix_evictions")
        return freed

    def _evict_leaf(self, sole_only: bool) -> int | None:
        """Evict the least-recently-used LEAF entry; ``sole_only``
        restricts victims to pages the cache is the last holder of (the
        only evictions that actually free pool pages). Returns pages
        physically freed, or None when no eligible victim exists."""
        for k in list(self._entries):
            e = self._entries[k]
            if e.children:
                continue
            if sole_only and self._pool.refcount(e.page) != 1:
                continue
            return self._pop(k, e)
        return None

    def _make_room(self) -> bool:
        while len(self._entries) >= self.max_entries:
            if self._evict_leaf(sole_only=False) is None:
                return False
        return True

    def reclaim(self, n_pages: int) -> int:
        """Pool-pressure eviction: free up to ``n_pages`` pool pages by
        dropping sole-reference leaves, LRU-first. Called by the
        scheduler BEFORE it preempts a live row — cached history always
        yields to running work. Returns pages freed."""
        freed = 0
        while freed < n_pages:
            got = self._evict_leaf(sole_only=True)
            if got is None:
                break
            freed += got
        return freed

    def clear(self) -> int:
        """Drop every entry and reference (engine close / tests).
        Returns pages physically freed."""
        entries = self._entries
        self._entries = OrderedDict()
        return self._pool.decref([e.page for e in entries.values()])

    def gauges(self) -> dict:
        return {
            "prefix_entries": len(self._entries),
            "prefix_bytes": self.bytes_held,
            "prefix_budget_bytes": self.max_entries * self.page_nbytes,
            "prefix_evictions": self.evictions,
        }
