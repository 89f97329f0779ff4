"""Device-resident exact-ANN index over L2-normalized embeddings.

The port of ``lumen_tpu/runtime/ann.py``: the CLIP embeddings the photo
pipeline produces become queryable ("search my library") by brute-force
cosine scoring on the card, recall 1.0 by construction. The env knobs,
:func:`normalize`, :func:`shard_of` (the same sha256 placement, bit for
bit) and :func:`exact_oracle` are copied; :func:`merge_topk` is copied
with its tie-break repaired (the JAX heap evicts the smallest id among
equal scores, against its own "score descending, then id ascending"
contract); the shard is rewritten in torch.

Device layout: each shard holds a ``(capacity, dim)`` float32 buffer on
its device. Growth DOUBLES the capacity from ``LUMEN_ANN_MIN_CAPACITY``
(one copy of the committed rows into the new buffer), and an upsert
that would pass ``LUMEN_ANN_MAX_VECTORS`` rows is refused. Scoring is
``q @ buf[:n].T`` over the committed rows only, then ``torch.topk``;
past ``LUMEN_ANN_TILE`` rows it goes tile by tile (only the tiles that
hold committed rows) with a per-tile top-k and one merge, so the score
scratch stays one tile wide. The products run in IEEE float32: the port
sets no TF32 flag, PyTorch's defaults keep float32 matmuls IEEE, and a
scoring pass on the card refuses to run if a caller turned TF32 on (its
~1e-3 error would reorder neighbours that the oracle ranks).

Exact ties: ``torch.topk`` orders equal scores arbitrarily, so each pass
also returns, per query, whether the group tied with its last score may
extend past what it fetched. :meth:`AnnShard.resolve_rows` orders the
fetched candidates by (score descending, id ascending) and, only where
the requested k-th score falls in such a group, reruns that query
exactly (every row scoring at least the k-th score, one snapshot), so
answers equal :func:`exact_oracle` ties included.

Concurrency contract (the JAX one): a query sees the index entirely
before or entirely after any upsert. JAX gets that from immutable
arrays; here the buffer is written in place, so two rules keep it:

- every device write (appends past the committed count, in-place
  updates of committed rows, the growth copy) and every scoring pass is
  LAUNCHED under the shard lock, on the shard's stream, together with
  the snapshot of the committed count it reads. Stream order then runs
  a pass before every write launched after it and after every write
  launched before it, whatever the host does later. The caller's
  current stream waits on the shard's stream after a pass, so a fetch
  ordered on the caller's stream (the batcher's ready event) sees it.
- ids are append-only (an update rewrites its row under the same id),
  so resolving indices against a later id list is safe for every row a
  pass could return.

The host-to-device copies of queries and upsert rows are made before the
lock is taken (pinned, asynchronous); a scoring pass makes no
device-to-host copy of its own: the caller fetches its three results in
one copy (the batcher's fetch worker, or :meth:`AnnShard.query_many`).
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import weakref
from typing import Sequence

import numpy as np
import torch

from ..utils.env import env_int
from ..utils.metrics import metrics
from .batcher import device_get, to_device
from .policy import resolve_device

#: rows per scoring tile. Buffers at or under one tile score in a single
#: product.
TILE_ENV = "LUMEN_ANN_TILE"
#: smallest device buffer allocated per shard (doubling growth above it).
MIN_CAP_ENV = "LUMEN_ANN_MIN_CAPACITY"
#: hard per-shard row cap: an upsert past it is refused with a clear
#: error instead of growing until device memory runs out.
MAX_VECTORS_ENV = "LUMEN_ANN_MAX_VECTORS"
#: logical shards per tenant: the federation front fans a query out to
#: the ring owners of ``ann/<tenant>/<shard>`` keys and merges the lists.
SHARDS_ENV = "LUMEN_ANN_SHARDS"
#: ceiling on a single query's k (results per shard before the merge).
K_CAP_ENV = "LUMEN_ANN_K_CAP"


def ann_tile() -> int:
    return env_int(TILE_ENV, 8192, minimum=128)


def ann_min_capacity() -> int:
    return env_int(MIN_CAP_ENV, 1024, minimum=8)


def ann_max_vectors() -> int:
    return env_int(MAX_VECTORS_ENV, 1_000_000, minimum=1)


def ann_shards() -> int:
    return env_int(SHARDS_ENV, 3, minimum=1)


def ann_k_cap() -> int:
    return env_int(K_CAP_ENV, 128, minimum=1)


def _pow2_at_least(n: int, floor: int = 1) -> int:
    out = max(1, floor)
    while out < n:
        out *= 2
    return out


def normalize(vecs: np.ndarray) -> np.ndarray:
    """L2-normalize rows (host-side, float32). Zero vectors stay zero
    instead of dividing into NaNs — they simply never score above any
    real match."""
    vecs = np.asarray(vecs, dtype=np.float32)
    if vecs.ndim == 1:
        vecs = vecs[None, :]
    norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
    return vecs / np.maximum(norms, 1e-12)


def shard_of(vec_id: str, shards: int) -> int:
    """Stable shard assignment for one vector id — the SAME function on
    the front tier (which partitions upsert batches) and on a single host
    (which partitions locally), so a library indexed standalone reshards
    identically when a fleet grows around it."""
    if shards <= 1:
        return 0
    digest = hashlib.sha256(vec_id.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") % shards


def _rank_key(item: tuple[float, str]) -> tuple[float, str]:
    return -item[0], item[1]


def merge_topk(
    parts: Sequence[tuple[Sequence[str], Sequence[float]]], k: int
) -> tuple[list[str], list[float]]:
    """Merge per-shard ``(ids, scores)`` top-k lists into one global
    top-k under the order score descending, then id ascending — the
    order :func:`exact_oracle` ranks by — so a sharded merge is
    bit-reproducible and equal to the global oracle, ties included.
    Tolerates empty shards and k larger than any shard's contribution.
    A plain sort of the candidates: there are at most ``k`` per shard
    (k <= ``LUMEN_ANN_K_CAP``)."""
    items = [(float(score), str(vid)) for ids, scores in parts for vid, score in zip(ids, scores)]
    items.sort(key=_rank_key)
    top = items[: max(0, k)]
    return [vid for _, vid in top], [score for score, _ in top]


def _tf32_matmul_on() -> bool:
    return bool(torch.backends.cuda.matmul.allow_tf32) or torch.get_float32_matmul_precision() != "highest"


def _score_topk(buf: torch.Tensor, q: torch.Tensor, n: int, k: int, tile: int):
    """One scoring pass over the first ``n`` rows of ``buf`` for the
    ``(Q, dim)`` queries ``q``: ``(scores (Q, k), rows (Q, k) int64,
    partial (Q,) bool)``, scores descending. ``partial`` marks a query
    whose rows tied with its k-th score may extend past the k fetched
    (always exact on the ``False`` side). Launches only; ``k <= n``."""
    if n <= tile:
        s = q @ buf[:n].T
        vals, idx = torch.topk(s, k, dim=1)
        return vals, idx, (s >= vals[:, -1:]).sum(1) > k
    tile_vals, tile_idx, tile_last, more = [], [], [], []
    for base in range(0, n, tile):
        s = q @ buf[base : min(base + tile, n)].T
        kt = min(k, s.shape[1])
        v, i = torch.topk(s, kt, dim=1)
        tile_vals.append(v)
        tile_idx.append(i + base)
        tile_last.append(v[:, -1])
        more.append(kt < s.shape[1])
    all_vals = torch.cat(tile_vals, 1)
    vals, pos = torch.topk(all_vals, k, dim=1)
    idx = torch.gather(torch.cat(tile_idx, 1), 1, pos)
    last = vals[:, -1:]
    partial = (all_vals >= last).sum(1) > k
    # A tile holds every row above its own last fetched score, and that
    # score is never above the merged last; where they are equal and the
    # tile had rows left, some of them may tie with the merged last.
    cut = [t for t, m in zip(tile_last, more) if m]
    if cut:
        partial |= (torch.stack(cut, 1) == last).any(1)
    return vals, idx, partial


class AnnShard:
    """One tenant-shard's device buffer + id table. Thread-safe.
    ``device``: the card unless the caller asks for the CPU."""

    def __init__(self, dim: int, name: str = "ann", device=None):
        if dim < 1:
            raise ValueError(f"embedding dim must be >= 1, got {dim}")
        self.dim = int(dim)
        self.name = name
        self.device = resolve_device(device)
        self._stream = torch.cuda.Stream(device=self.device) if self.device.type == "cuda" else None
        self._lock = threading.Lock()
        self._buf: torch.Tensor | None = None  # lazy: allocated on first upsert
        self._n = 0
        self._ids: list[str] = []
        self._row: dict[str, int] = {}
        self._capacity = 0

    # -- internals --------------------------------------------------------

    def _on_stream(self):
        """Launch on the shard's stream after the caller's current
        stream's work (the caller's host-to-device copies)."""
        if self._stream is None:
            return contextlib.nullcontext()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._stream)

    def _used_on_stream(self, t: torch.Tensor) -> torch.Tensor:
        """Mark a tensor made on the caller's stream as read on the
        shard's, so the caching allocator does not hand its memory out
        before the shard's stream has read it."""
        if self._stream is not None:
            t.record_stream(self._stream)
        return t

    def _after_stream(self) -> None:
        """The caller's stream waits on what was launched on the shard's."""
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def _grow_to(self, need: int) -> None:
        """Ensure capacity >= need (doubling; caller holds the lock and
        is on the shard's stream)."""
        cap = self._capacity or ann_min_capacity()
        cap = _pow2_at_least(need, floor=max(cap, ann_min_capacity()))
        if cap == self._capacity:
            return
        new = torch.zeros((cap, self.dim), dtype=torch.float32, device=self.device)
        if self._buf is not None and self._n:
            new[: self._n].copy_(self._buf[: self._n])
        self._buf = new
        self._capacity = cap
        metrics.count("ann_grows")

    def _check_ieee(self) -> None:
        if self.device.type == "cuda" and _tf32_matmul_on():
            raise RuntimeError(
                "ANN scoring needs IEEE float32 products: TF32 matmuls are on "
                "(torch.backends.cuda.matmul.allow_tf32 / set_float32_matmul_precision)"
            )

    # -- public API -------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._capacity

    def upsert(self, ids: Sequence[str], vecs: np.ndarray) -> tuple[int, int]:
        """Insert-or-replace ``vecs[i]`` under ``ids[i]``. Returns
        ``(added, updated)``. Vectors are L2-normalized here so scoring
        is cosine similarity regardless of what the caller sends."""
        vecs = normalize(vecs)
        if len(ids) != vecs.shape[0]:
            raise ValueError(f"{len(ids)} ids but {vecs.shape[0]} vectors")
        if vecs.shape[1] != self.dim:
            raise ValueError(f"vector dim {vecs.shape[1]} != index dim {self.dim}")
        if not len(ids):
            return 0, 0
        # Last-write-wins WITHIN the batch too: a duplicated id writes its
        # final vector once.
        dedup: dict[str, np.ndarray] = {}
        for vid, vec in zip(ids, vecs):
            dedup[str(vid)] = vec
        rows_d = self._used_on_stream(to_device(torch.from_numpy(np.stack(list(dedup.values()))), self.device))
        with self._lock:
            added = sum(1 for vid in dedup if vid not in self._row)
            updated = len(dedup) - added
            new_n = self._n + added
            if new_n > ann_max_vectors():
                raise ValueError(
                    f"shard {self.name!r} would hold {new_n} vectors, over "
                    f"the {MAX_VECTORS_ENV}={ann_max_vectors()} cap"
                )
            idx_list: list[int] = []
            next_row = self._n
            for vid in dedup:
                row = self._row.get(vid)
                if row is None:
                    row = next_row
                    next_row += 1
                idx_list.append(row)
            with self._on_stream():
                self._grow_to(new_n)
                idx_d = to_device(torch.tensor(idx_list, dtype=torch.int64), self.device)
                self._buf.index_copy_(0, idx_d, rows_d)
            self._after_stream()
            # COMMIT: ids and count together. A pass launched before this
            # block sees none of this batch (stream order); one after sees
            # all of it.
            for vid in dedup:
                if vid not in self._row:
                    self._row[vid] = len(self._ids)
                    self._ids.append(vid)
            self._n = len(self._ids)
        metrics.count("ann_upserts", len(dedup))
        if updated:
            metrics.count("ann_updates", updated)
        return added, updated

    def resolve(self, indices: Sequence[int]) -> list[str]:
        """Row indices -> vector ids. Safe without the query's snapshot:
        ids are append-only and the indices came from a pass over the
        committed rows."""
        ids = self._ids  # list reference; rows < committed n never change id
        return [ids[i] for i in indices]

    def query(self, q: np.ndarray, k: int) -> tuple[list[str], list[float]]:
        """Exact top-k over the committed rows for the FIRST query row
        (``q`` is ``(dim,)`` or ``(Q, dim)``); multi-row callers use
        :meth:`query_many`."""
        ids, scores = self.query_many(np.atleast_2d(np.asarray(q)), k)
        return ids[0], scores[0]

    def query_raw(self, q, k: int):
        """Batched scoring core: ``(B, dim)`` raw query vectors ->
        un-fetched device tensors ``(scores (B, k'), rows (B, k'),
        partial (B,))`` with ``k' = min(k, k_cap, committed_n)``. This is
        the MicroBatcher ``fn`` body (the batcher's fetch worker makes the
        one device-to-host copy per batch). Resolve the rows later with
        :meth:`resolve_rows`."""
        q = normalize(np.asarray(q, np.float32))
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        metrics.count("ann_queries", q.shape[0])
        self._check_ieee()
        q_d = self._used_on_stream(to_device(torch.from_numpy(q), self.device))
        with self._lock:
            n, buf = self._n, self._buf
            if buf is None or n == 0:
                empty = torch.zeros((q.shape[0], 0), dtype=torch.float32)
                return empty, empty.long(), torch.zeros(q.shape[0], dtype=torch.bool)
            k_eff = min(max(1, int(k)), ann_k_cap(), n)
            with self._on_stream():
                out = _score_topk(buf, q_d, n, k_eff, ann_tile())
        self._after_stream()
        return out

    def query_many(self, q: np.ndarray, k: int) -> tuple[list[list[str]], list[list[float]]]:
        q = np.atleast_2d(np.asarray(q, dtype=np.float32))
        scores, rows, partial = device_get(self.query_raw(q, k))
        return self.resolve_rows(scores, rows, partial, q, k)

    def resolve_rows(
        self,
        scores: np.ndarray,
        indices: np.ndarray,
        partial: np.ndarray | None = None,
        queries: np.ndarray | None = None,
        k: int | None = None,
    ) -> tuple[list[list[str]], list[list[float]]]:
        """Fetched ``query_raw`` rows -> per-query ``(ids, scores)`` lists
        of at most ``k`` (default: every fetched row), ordered by score
        descending, then id ascending. A query whose k-th score ties with
        the last fetched one while its ``partial`` flag is set is rerun
        exactly from its ``queries`` row (module docstring)."""
        scores, indices = np.atleast_2d(scores), np.atleast_2d(indices)
        partial = np.zeros(len(scores), bool) if partial is None else np.atleast_1d(partial)
        out_ids: list[list[str]] = []
        out_scores: list[list[float]] = []
        for r, (raw_sc, raw_idx) in enumerate(zip(scores, indices)):
            want = len(raw_sc) if k is None else min(max(1, int(k)), len(raw_sc))
            # The fetched scores are descending: only rows scoring at least
            # the want-th can rank, ties included.
            keep = raw_sc >= raw_sc[want - 1] if want else np.zeros(0, bool)
            items = sorted(
                zip((float(s) for s in raw_sc[keep]), self.resolve([int(i) for i in raw_idx[keep]])), key=_rank_key
            )
            if want and partial[r] and items[want - 1][0] == float(raw_sc[-1]):
                if queries is None:
                    raise ValueError("a tied query needs its vector to be rerun exactly")
                items = self._exact(np.atleast_2d(queries)[r], want)
            out_ids.append([vid for _, vid in items[:want]])
            out_scores.append([score for score, _ in items[:want]])
        return out_ids, out_scores

    def _exact(self, q: np.ndarray, k: int) -> list[tuple[float, str]]:
        """Every committed row scoring at least the query's k-th score, at
        one snapshot, ordered by (score descending, id ascending)."""
        q = normalize(q)
        self._check_ieee()
        q_d = self._used_on_stream(to_device(torch.from_numpy(q), self.device))
        with self._lock:
            n = self._n
            with self._on_stream():
                s = (q_d @ self._buf[:n].T)[0]
        self._after_stream()
        k = min(k, n)
        thr = torch.topk(s, k).values[-1]
        sel = torch.nonzero(s >= thr).flatten()
        sc, rows = device_get((s[sel], sel))
        metrics.count("ann_tie_reruns")
        return sorted(zip((float(x) for x in sc), self.resolve([int(i) for i in rows])), key=_rank_key)

    def gauges(self) -> dict:
        with self._lock:
            return {"vectors": self._n, "capacity": self._capacity, "dim": self.dim}


class AnnIndex:
    """Per-tenant, per-shard index map for one host. Shards materialize
    lazily on first upsert; gauges register per (tenant, shard) so
    ``/metrics`` shows which tenants hold rows where."""

    def __init__(self, dim: int, device=None):
        self.dim = int(dim)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._shards: dict[tuple[str, str], AnnShard] = {}

    def shard(self, tenant: str, shard: str, create: bool = True) -> AnnShard | None:
        key = (tenant or "default", str(shard))
        with self._lock:
            got = self._shards.get(key)
            if got is None and create:
                got = AnnShard(self.dim, name=f"{key[0]}/{key[1]}", device=self.device)
                self._shards[key] = got
                ref = weakref.ref(got)
                metrics.register_gauges(
                    f"ann:{key[0]}:{key[1]}",
                    lambda r=ref: (s.gauges() if (s := r()) is not None else {}),
                )
            return got

    def shards_for(self, tenant: str) -> dict[str, AnnShard]:
        tenant = tenant or "default"
        with self._lock:
            return {sh: shard for (t, sh), shard in self._shards.items() if t == tenant}

    def upsert(
        self, tenant: str, ids: Sequence[str], vecs: np.ndarray, shard: str | None = None,
    ) -> tuple[int, int]:
        """Upsert a batch. With an explicit ``shard`` label (the
        fleet-routed path) everything lands there; without one (direct
        single-host use) rows partition by :func:`shard_of` so a later
        fleet sees the same placement function."""
        vecs = np.atleast_2d(np.asarray(vecs))
        if shard is not None:
            return self.shard(tenant, shard).upsert(ids, vecs)
        n_shards = ann_shards()
        added = updated = 0
        groups: dict[int, list[int]] = {}
        for i, vid in enumerate(ids):
            groups.setdefault(shard_of(str(vid), n_shards), []).append(i)
        for sh, rows in sorted(groups.items()):
            a, u = self.shard(tenant, str(sh)).upsert([str(ids[i]) for i in rows], vecs[rows])
            added += a
            updated += u
        return added, updated

    def query(
        self, tenant: str, q: np.ndarray, k: int, shards: Sequence[str] | None = None,
    ) -> tuple[list[str], list[float], int]:
        """Top-k over the named shards (fleet hop) or every local shard of
        the tenant (direct use). Returns ``(ids, scores, shards_read)``."""
        if shards is None:
            local = self.shards_for(tenant)
        else:
            local = {sh: s for sh in shards if (s := self.shard(tenant, sh, create=False)) is not None}
        parts = [s.query(q, k) for s in local.values()]
        ids, scores = merge_topk(parts, k)
        return ids, scores, len(local)

    def stats(self) -> dict:
        with self._lock:
            return {f"{t}/{sh}": shard.gauges() for (t, sh), shard in sorted(self._shards.items())}


def exact_oracle(
    ids: Sequence[str], vecs: np.ndarray, q: np.ndarray, k: int
) -> tuple[list[str], list[float]]:
    """Numpy reference: full cosine scoring + the same deterministic
    tie-break as :func:`merge_topk`. The recall@k arbiter for tests and
    the smoke phase."""
    vecs = normalize(vecs)
    q = normalize(q)[0]
    scores = vecs @ q
    order = sorted(range(len(ids)), key=lambda i: (-float(scores[i]), str(ids[i])))
    top = order[: min(k, len(order))]
    return [str(ids[i]) for i in top], [float(scores[i]) for i in top]
