"""Semantic-search gRPC service: per-tenant device-resident ANN index.

The port of ``lumen_tpu/serving/services/search_service.py``: the same
two tasks, tensor specs, meta keys, answers and error codes, over the
port's :mod:`~lumen_tpu_torch.runtime.ann` on the device the server hands
``from_config``.

- ``search_query`` — one embedding in (``tensor/raw`` float32 ``(dim,)``,
  validated against the task's spec before the handler, or a JSON
  ``{"vector": [...]}``), top-k ``(ids, scores)`` out. Queries submit
  into a per-(tenant, shard) :class:`MicroBatcher`, so concurrent
  searches coalesce into one scoring pass, admitted on the request's QoS
  lane (interactive for a search), and each caller takes its own k from
  the pass at the k cap.

- ``search_upsert`` — vectors + ids in (``tensor/bundle``: float32
  ``(N, dim)`` then the ids as a UTF-8 JSON array in a uint8 tensor; or
  JSON), ``{added, updated, total}`` out. Upserts never touch the query
  batcher: the handler writes the device buffers directly in
  ``LUMEN_ANN_UPSERT_CHUNK`` slices under the lane the request arrived on
  (the bulk streaming lane tags ``bulk``), so indexing a library never
  holds an interactive batch slot.

Sharding: a ``shard`` meta pins the write or read to one named shard
(the federation hop's shape). Without it, upserts place rows by
``runtime/ann.shard_of`` and a query reads every local shard of the
tenant and merges.
"""

from __future__ import annotations

import json
import threading

import numpy as np

from ...core.config import ServiceConfig
from ...runtime.ann import AnnIndex, ann_k_cap, ann_shards, merge_topk
from ...runtime.batcher import MicroBatcher
from ...utils.env import env_int
from ...utils.qos import current_qos, service_extra as qos_service_extra
from ...utils.tensorwire import BUNDLE_MIME, TENSOR_MIME, TensorSpec, tensor_from_payload, unpack_bundle
from ..base_service import BaseService, InvalidArgument
from ..registry import TaskDefinition, TaskRegistry

SEARCH_QUERY_TASK = "search_query"
SEARCH_UPSERT_TASK = "search_upsert"

#: embedding dimensionality of the index (must match the CLIP family
#: feeding it; 512 is the reference ViT-B tower).
DIM_ENV = "LUMEN_ANN_DIM"
#: rows per device write during one upsert request — bounds one write and
#: interleaves indexing with query passes.
UPSERT_CHUNK_ENV = "LUMEN_ANN_UPSERT_CHUNK"


def ann_dim() -> int:
    return env_int(DIM_ENV, 512, minimum=1)


def upsert_chunk() -> int:
    return env_int(UPSERT_CHUNK_ENV, 1024, minimum=1)


class SearchService(BaseService):
    def __init__(
        self,
        dim: int | None = None,
        batch_size: int = 8,
        max_latency_ms: float = 2.0,
        service_name: str = "search",
        device=None,
    ):
        self.dim = int(dim or ann_dim())
        self.index = AnnIndex(self.dim, device=device)
        self.device = self.index.device
        self._batch_size = max(1, batch_size)
        self._max_latency_ms = max_latency_ms
        self._batchers: dict[tuple[str, str], MicroBatcher] = {}
        self._batcher_lock = threading.Lock()
        registry = TaskRegistry(service_name)
        registry.register(
            TaskDefinition(
                name=SEARCH_QUERY_TASK,
                handler=self._query,
                description="embedding -> top-k (ids, scores) from the tenant's ANN index",
                input_mimes=(TENSOR_MIME, "application/json"),
                output_mime="application/json",
                tensor_spec=TensorSpec("float32", (self.dim,)),
            )
        )
        registry.register(
            TaskDefinition(
                name=SEARCH_UPSERT_TASK,
                handler=self._upsert,
                description="vector batch + ids -> index upsert {added, updated, total}",
                input_mimes=(BUNDLE_MIME, "application/json"),
                output_mime="application/json",
                # Clients chunk large batches; one request stays under the
                # 64 MiB gRPC frame.
                max_payload_bytes=64 * 1024 * 1024,
            )
        )
        super().__init__(registry)

    # -- factory ----------------------------------------------------------

    @classmethod
    def expected_tasks(cls, service_config: ServiceConfig) -> list[str]:  # noqa: ARG003
        return [SEARCH_QUERY_TASK, SEARCH_UPSERT_TASK]

    @classmethod
    def from_config(cls, service_config: ServiceConfig, cache_dir: str, device=None) -> "SearchService":  # noqa: ARG003
        bs = service_config.backend_settings
        return cls(batch_size=bs.batch_size, max_latency_ms=bs.max_batch_latency_ms, device=device)

    def capability(self):
        return self.registry.build_capability(
            model_ids=["ann-exact"],
            runtime="torch-cuda" if self.device.type == "cuda" else "torch-cpu",
            max_concurrency=self._batch_size,
            extra={
                "ann_dim": str(self.dim),
                "ann_shards": str(ann_shards()),
                "bulk_stream": "1",
                "qos": qos_service_extra("search"),
            },
        )

    def healthy(self) -> bool:
        return True

    def close(self) -> None:
        with self._batcher_lock:
            batchers, self._batchers = list(self._batchers.values()), {}
        for b in batchers:
            b.close()

    # -- query path -------------------------------------------------------

    def _batcher(self, tenant: str, shard: str) -> MicroBatcher:
        """Lazily-started batcher for one (tenant, shard): its ``fn`` is
        the shard's launch-only ``query_raw`` at the k cap, so coalesced
        searches share one pass and slice their own k after the fetch."""
        key = (tenant, shard)
        with self._batcher_lock:
            got = self._batchers.get(key)
            if got is None:
                shard_obj = self.index.shard(tenant, shard)

                def fn(batch, n_valid: int, _s=shard_obj):  # noqa: ARG001
                    return _s.query_raw(np.asarray(batch), ann_k_cap())

                got = MicroBatcher(
                    fn,
                    max_batch=self._batch_size,
                    max_latency_ms=self._max_latency_ms,
                    name=f"search:{tenant}:{shard}",
                ).start()
                self._batchers[key] = got
            return got

    def _query(self, payload: bytes, mime: str, meta: dict[str, str]):
        vec = self._parse_query_vector(payload, mime, meta)
        k = _int_meta(meta, "k", 10)
        if k < 1:
            raise InvalidArgument("meta 'k' must be >= 1")
        tenant = _tenant(meta)
        shard = meta.get("shard")
        if shard is not None:
            shards = [shard]
        else:
            # Direct (unfederated) query: every local shard of the tenant,
            # merged — the same answer as the fleet path.
            shards = sorted(self.index.shards_for(tenant)) or ["0"]
        futures = [(self.index.shard(tenant, sh), self._batcher(tenant, sh).submit(vec)) for sh in shards]
        parts: list[tuple[list[str], list[float]]] = []
        for shard_obj, fut in futures:
            scores, idx, partial = fut.result()
            ids_rows, score_rows = shard_obj.resolve_rows(scores, idx, partial, vec, k)
            parts.append((ids_rows[0], score_rows[0]))
        ids, scores = merge_topk(parts, k)
        body = {"ids": ids, "scores": scores, "k": k, "shards": len(shards), "tenant": tenant}
        return json.dumps(body).encode(), "application/json", {}

    def _parse_query_vector(self, payload: bytes, mime: str, meta: dict[str, str]) -> np.ndarray:
        if mime == TENSOR_MIME:
            # Pre-validated against tensor_spec by the base class.
            return np.asarray(tensor_from_payload(payload, meta), np.float32)
        try:
            body = json.loads(payload.decode("utf-8"))
            vec = np.asarray(body["vector"], np.float32)
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            raise InvalidArgument(f"query body must be tensor/raw or JSON {{'vector': [...]}}: {e}") from e
        if vec.shape != (self.dim,):
            raise InvalidArgument(f"query vector shape {vec.shape} != ({self.dim},)")
        return vec

    # -- upsert path ------------------------------------------------------

    def _upsert(self, payload: bytes, mime: str, meta: dict[str, str]):
        ids, vecs = self._parse_upsert(payload, mime)
        tenant = _tenant(meta)
        shard = meta.get("shard")
        added = updated = 0
        # Bounded device writes on the REQUEST's lane, never through the
        # query batcher.
        step = upsert_chunk()
        for lo in range(0, len(ids), step):
            a, u = self.index.upsert(tenant, ids[lo : lo + step], vecs[lo : lo + step], shard=shard)
            added += a
            updated += u
        total = sum(s.count for s in self.index.shards_for(tenant).values())
        body = {"added": added, "updated": updated, "total": total, "tenant": tenant}
        return json.dumps(body).encode(), "application/json", {}

    def _parse_upsert(self, payload: bytes, mime: str) -> tuple[list[str], np.ndarray]:
        if mime == BUNDLE_MIME:
            try:
                tensors = unpack_bundle(payload)
            except ValueError as e:
                raise InvalidArgument(f"bad tensor bundle: {e}") from e
            if len(tensors) != 2:
                raise InvalidArgument(
                    f"upsert bundle must hold [vectors, ids_json], got {len(tensors)} tensors"
                )
            vecs = np.asarray(tensors[0], np.float32)
            try:
                ids = json.loads(bytes(np.asarray(tensors[1], np.uint8)).decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise InvalidArgument(f"ids tensor is not a JSON array: {e}") from e
        else:
            try:
                body = json.loads(payload.decode("utf-8"))
                ids = body["ids"]
                vecs = np.asarray(body["vectors"], np.float32)
            except (ValueError, KeyError, UnicodeDecodeError) as e:
                raise InvalidArgument(
                    "upsert body must be tensor/bundle or JSON "
                    f"{{'ids': [...], 'vectors': [[...]]}}: {e}"
                ) from e
        if not isinstance(ids, list) or not all(isinstance(i, str) for i in ids):
            raise InvalidArgument("ids must be a JSON array of strings")
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise InvalidArgument(f"vectors must be (N, {self.dim}) float32, got {vecs.shape}")
        if len(ids) != vecs.shape[0]:
            raise InvalidArgument(f"{len(ids)} ids but {vecs.shape[0]} vectors")
        if not ids:
            raise InvalidArgument("empty upsert batch")
        return ids, vecs


def _tenant(meta: dict[str, str]) -> str:
    """Tenant identity: explicit request meta first (the federation front
    forwards it), then the QoS contextvar the base service activated from
    invocation metadata, else the default tenant."""
    got = meta.get("tenant")
    if got:
        return got
    return current_qos()[0] or "default"


def _int_meta(meta: dict[str, str], key: str, default: int) -> int:
    try:
        return int(meta.get(key, default))
    except ValueError as e:
        raise InvalidArgument(f"meta {key!r} must be an integer") from e
