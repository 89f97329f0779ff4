"""Generic data-parallel ingest scheduler.

The port of ``lumen_tpu/pipeline/ingest.py``. ``Stage`` and the task-graph
validation (``_build_graph``) are copied; the scheduler is rewritten for
torch on the mesh's data places (one, or several over a ``data`` axis: a
place is an index into ``mesh.data_devices``, which may name one card
twice). Execution model (three overlapped lanes):

1. **host decode/preprocess** — a producer thread drains the item
   iterator, fans per-item work over the decode pool (the ``photo`` spec
   in worker processes when the pool runs them), stacks each stage's
   rows into one fixed-shape batch in pinned host memory (the tail batch
   padded), splits it into equal contiguous parts, one a data place
   (``runtime.mesh.data_sharding``), and copies each part to its place's
   device with ``non_blocking=True`` on that place's copy stream,
   recording one event a place after the copies;
2. **device** — for each place, the consumer makes the place's stream
   wait on its event and launches every stage's ``device_fn`` on the
   place's part, keeping up to ``inflight`` batches launched and
   un-fetched: torch returns before the device finishes, so batch *k+1*
   is copied and launched while batch *k* runs;
3. **host postprocess** — a batch's results (every stage's tree) come
   back in ONE device-to-host copy a place, each on the place's side
   stream after an event recorded after the place's launches
   (``runtime.batcher.device_get``); each is one device-to-host
   synchronization (``IngestStats.syncs``), and the places' rows are put
   back in input order. Per-item ``postprocess`` runs and a merged record
   per item is yielded in order.

Pinned staging buffers come from PyTorch's caching host allocator, which
hands a block out again only after the events of the copies that read it
(the non-blocking copy records one); each batch also keeps its staging
trees until it settles. Every stage's ``preprocess`` must return leaves
of one fixed shape and the batch size is constant (tail padded), so each
stage runs one shape.

Around the lanes, as in the JAX package: the content-addressed result
cache (a hit skips decode and the device, and re-fires ``cache_output=
False`` derived nodes), the poison quarantine, the bulk QoS lane on every
thread, one request trace per batch, and ``_salvage_batch`` when a
batch's device work raises (each item alone, a poison verdict only with
a healthy sibling).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

import torch

from ..runtime.batcher import (
    Parts,
    SideStreams,
    device_get,
    on_device,
    record_ready,
    stack_and_pad,
    tree_flatten,
    tree_map,
    unstack,
)
from ..runtime.decode_pool import DecodePool, get_decode_pool
from ..runtime.mesh import DATA_AXIS, DataSharding, DeviceMesh, data_sharding
from ..runtime.quarantine import QuarantineRegistry, get_quarantine
from ..runtime.result_cache import ResultCache, get_result_cache, make_key
from ..runtime.trace import begin_request, finish_request
from ..utils.deadline import QueueFull
from ..utils.qos import (
    LANE_BULK,
    activate as qos_activate,
    current_qos as qos_current,
    deactivate as qos_deactivate,
    qos_context,
)

logger = logging.getLogger(__name__)


@dataclass
class Stage:
    """One node of an ingest task graph.

    Two kinds, distinguished by ``inputs``:

    **Source node** (``inputs=()``, the classic device-batched stage) —
    consumes the decoded item:

    - ``preprocess(decoded)`` -> fixed-shape numpy pytree for one item (host,
      runs in the decode worker pool);
    - ``device_fn(batched_tree)`` -> batched device result tree (inputs
      arrive on a data place's device, the place's part of the batch; it
      should launch and return without waiting for the device). One
      callable runs on every place (it follows its input's device), or a
      sequence gives one a place, in place order;
    - ``postprocess(decoded, row)`` -> the per-item record value (host).

    **Derived node** (``inputs`` non-empty) — a host-side step fed by other
    nodes' record values instead of a device batch. ``preprocess`` and
    ``device_fn`` are unused (must stay ``None``); ``postprocess(decoded,
    deps)`` receives a ``{input_name: value}`` dict of the declared inputs
    and its return value lands under ``name`` in the record. Inputs name
    other stages, or record meta keys starting with ``_`` (``"_sha256"``).
    Derived nodes run in dependency (topological) order after the item's
    source-stage values settle — including on CACHE-HIT records when
    ``cache_output=False`` (see below), where ``decoded`` is ``None``
    because the item was never decoded; a derived ``postprocess`` must
    tolerate that.

    ``cache_output=False`` marks a node whose value is a side effect (e.g.
    pushing an embedding into a search index), excluded from the result
    cache so it re-fires on every pass — cache hits included — instead of
    replaying a stale verdict.
    """

    name: str
    preprocess: Callable[[Any], Any] | None = None
    device_fn: Callable[[Any], Any] | None = None
    postprocess: Callable[[Any, Any], Any] = field(default=lambda decoded, row: row)
    inputs: tuple[str, ...] = ()
    cache_output: bool = True


def _build_graph(stages: Sequence[Stage]) -> tuple[list[Stage], list[Stage]]:
    """Validate the declared task graph -> ``(device_stages, derived_topo)``.

    Device stages keep their given order (it IS the dispatch and record-key
    order). Derived nodes come back topologically sorted; duplicate names,
    unknown inputs, a ``device_fn`` on a derived node, a missing one on a
    source node, and dependency cycles all raise at construction, not
    mid-run."""
    names = [s.name for s in stages]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate stage names: {sorted(dupes)}")
    known = set(names)
    device: list[Stage] = []
    derived: list[Stage] = []
    for s in stages:
        if s.inputs:
            if s.device_fn is not None or s.preprocess is not None:
                raise ValueError(
                    f"derived stage {s.name!r} declares inputs; it runs "
                    "host-side and must not set preprocess/device_fn"
                )
            for dep in s.inputs:
                if not dep.startswith("_") and dep not in known:
                    raise ValueError(f"stage {s.name!r} depends on unknown stage {dep!r}")
            derived.append(s)
        else:
            if s.preprocess is None or s.device_fn is None:
                raise ValueError(
                    f"source stage {s.name!r} needs both preprocess and "
                    "device_fn (declare inputs to make it a derived node)"
                )
            device.append(s)
    # Kahn's algorithm over the derived subgraph (device stages and meta
    # keys are always-ready inputs).
    derived_names = {s.name for s in derived}
    pending = {s.name: {d for d in s.inputs if d in derived_names} for s in derived}
    by_name = {s.name: s for s in derived}
    order: list[Stage] = []
    ready = [s.name for s in derived if not pending[s.name]]
    while ready:
        name = ready.pop(0)
        order.append(by_name[name])
        for other, deps in pending.items():
            if name in deps:
                deps.discard(name)
                if not deps:
                    ready.append(other)
    if len(order) != len(derived):
        stuck = sorted(set(derived_names) - {s.name for s in order})
        raise ValueError(f"dependency cycle among derived stages: {stuck}")
    return device, order


@dataclass
class IngestStats:
    items: int = 0
    batches: int = 0
    cache_hits: int = 0  # items answered from the result cache (no decode)
    errors: int = 0      # items that became per-item ``_error`` records
    quarantined: int = 0  # items rejected up front by the poison quarantine
    duplicates: int = 0  # byte items whose content sha256 repeated in-run
    syncs: int = 0       # device-to-host copies the consumer waited on
    wall_s: float = 0.0
    decode_s: float = 0.0  # producer-lane time (decode + preprocess + staging + copy launch)
    device_s: float = 0.0  # consumer time blocked on device fetches
    post_s: float = 0.0
    max_inflight: int = 0  # high-water mark of launched-unfetched batches
    pool: dict = field(default_factory=dict)  # decode-pool gauges at run end

    @property
    def items_per_sec(self) -> float:
        return self.items / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / self.items if self.items else 0.0

    def as_dict(self) -> dict:
        out = {
            "items": self.items,
            "batches": self.batches,
            "cache_hits": self.cache_hits,
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "errors": self.errors,
            "quarantined": self.quarantined,
            "duplicates": self.duplicates,
            "syncs": self.syncs,
            "wall_s": round(self.wall_s, 4),
            "items_per_sec": round(self.items_per_sec, 2),
            "decode_s": round(self.decode_s, 4),
            "device_s": round(self.device_s, 4),
            "post_s": round(self.post_s, 4),
            "max_inflight": self.max_inflight,
        }
        if self.pool:
            out["pool"] = self.pool
        return out


class _Batch:
    __slots__ = (
        "decoded", "inputs", "staged", "copied", "outputs", "ready", "n", "indices", "keys", "shas",
        "trace", "qspan", "wspan", "leases",
    )

    def __init__(
        self,
        decoded: list,
        inputs: dict[str, Any],
        n: int,
        indices: list[int] | None = None,
        keys: list[str | None] | None = None,
        shas: list[str | None] | None = None,
    ):
        self.decoded = decoded
        self.inputs = inputs  # stage name -> one device tree a data place
        # Pinned host trees the inputs were copied from, held until the
        # batch settles, and the event a place recorded after its copies.
        self.staged: dict[str, Any] = {}
        self.copied: list | None = None
        self.outputs: list[dict[str, Any]] = []  # a data place's {stage name: device tree}
        self.ready: list | None = None  # an event a place, recorded after its launches
        self.n = n
        # Global item indices (cache hits skip batches, so batch rows are
        # no longer contiguous) and per-row result-cache keys (None when
        # the item is uncacheable or caching is off).
        self.indices = indices if indices is not None else list(range(n))
        self.keys = keys if keys is not None else [None] * n
        # Content sha256 per row (None for non-bytes items): surfaces on
        # records as ``_sha256`` — the dedupe primitive — and is NOT part
        # of the cached value (attached fresh each run).
        self.shas = shas if shas is not None else [None] * n
        # Per-batch request trace (LUMEN_TRACE_SAMPLE > 0): the trace and
        # its open queue-wait / inflight-wait spans hop from the producer
        # thread to the consumer with the batch — contextvars don't cross.
        self.trace = None
        self.qspan = None
        self.wspan = None
        # Shared-memory decode leases (process-mode decode pool): each
        # decoded["img"] may be a zero-copy view over an arena slot. The
        # slots recycle only after the LAST consumer of the pixels —
        # postprocess (face crops, OCR warps) — has run; every exit path
        # of the consumer releases (idempotently).
        self.leases: list = []

    def release(self) -> None:
        for lease in self.leases:
            lease.release()


class IngestPipeline:
    """Stream items through data-parallel device stages on a mesh.

    ``batch_size`` must be a multiple of the mesh's ``data`` axis size (it
    is the GLOBAL batch, as in the JAX package): each data place of the
    :class:`~lumen_tpu_torch.runtime.mesh.DeviceMesh` runs
    ``batch_size / data`` rows of every batch.
    """

    def __init__(
        self,
        mesh: DeviceMesh,
        stages: Sequence[Stage],
        decode: Callable[[Any], Any] = lambda item: item,
        batch_size: int = 64,
        prefetch: int = 2,
        inflight: int = 2,
        workers: int | None = None,
        annotate: Callable[[Any], dict] | None = None,
        cache_namespace: str | None = None,
        cache_options: Mapping[str, Any] | None = None,
        decode_spec: tuple[str, dict] | None = None,
        decode_adapter: Callable[[Any], Any] | None = None,
    ):
        if not stages:
            raise ValueError("need at least one stage")
        dp = mesh.shape.get(DATA_AXIS, 1)
        if batch_size % dp != 0:
            raise ValueError(f"batch_size {batch_size} not a multiple of '{DATA_AXIS}' axis size {dp}")
        self.mesh = mesh
        self.device = mesh.device
        self._sharding = data_sharding(mesh)
        self.stages = list(stages)
        # Task-graph validation: device (source) stages in GIVEN order —
        # the dispatch order and the record key order — and host-side
        # derived nodes, topologically sorted by their declared inputs.
        self._device_stages, self._derived_stages = _build_graph(self.stages)
        #: stage name -> its callable on each data place
        self._place_fns = {s.name: self._fns(s) for s in self._device_stages}
        # Record keys excluded from cache.put values: positional meta plus
        # every ``cache_output=False`` node's value.
        self._strip_keys = {"_index", "_sha256"} | {s.name for s in self.stages if not s.cache_output}
        self.decode = decode
        self.batch_size = batch_size
        self.prefetch = max(prefetch, 1)
        self.inflight = max(inflight, 1)
        # Host decode/preprocess lane: the process-wide shared pool by
        # default; an explicit ``workers`` pins a private pool created per
        # run() and torn down with it.
        self._pinned_workers = max(0, workers or 0)
        #: optional per-item record enrichment from the decoded value (e.g.
        #: surfacing decode-failure markers set by a fault-tolerant decode)
        self.annotate = annotate
        # Result-cache integration: with a namespace set, every BYTES item
        # is hashed and looked up in the process-wide cache BEFORE the
        # decode pool — a hit skips decode, preprocess, the copy and every
        # device stage. Misses are stored after postprocess, so a warm
        # re-ingest of the same library is pure cache traffic.
        self.cache_namespace = cache_namespace
        self.cache_options = dict(cache_options or {})
        # Process-parallel decode: a ``(spec_name, params)`` pair names a
        # registered decode recipe (utils.host_decode) that can run in the
        # pool's worker PROCESSES; ``decode_adapter(DecodedTensor)`` turns
        # one result into the value ``decode`` would have produced. Used
        # only when the shared pool is in process mode AND a chunk is
        # all-bytes.
        self.decode_spec = decode_spec
        self.decode_adapter = decode_adapter
        self._on_card = self.device.type == "cuda"
        # A copy stream and fetch streams of each data place (keyed by the
        # place's index, never its device: two places may share a card).
        self._copy_streams = [torch.cuda.Stream(device=d) for d in self._sharding.devices] if self._on_card else []
        self._fetch_streams = SideStreams()
        self.stats = IngestStats()  # stats of the most recent run()
        self._run_pool_tasks = 0

    def _cache(self) -> ResultCache | None:
        """The shared cache, when this pipeline is configured to use it and
        the env has not disabled it (resolved per run, like the pool)."""
        if not self.cache_namespace:
            return None
        cache = get_result_cache()
        return cache if cache.enabled else None

    @property
    def pool(self) -> DecodePool | None:
        """The shared pool, resolved at use time; ``None`` when ``workers``
        pins a run-scoped private pool."""
        return None if self._pinned_workers else get_decode_pool()

    @property
    def workers(self) -> int:
        pool = self.pool
        return pool.workers if pool is not None else self._pinned_workers

    # -- host <-> device --------------------------------------------------

    def _fns(self, stage: Stage) -> list:
        fn = stage.device_fn
        places = len(self._sharding.devices)
        fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * places
        if len(fns) != places:
            raise ValueError(f"stage {stage.name!r}: {len(fns)} device_fns for {places} data places")
        return fns

    def _stage_to_device(self, trees: list, places: int | None = None) -> tuple[list, Any]:
        """Stack one stage's per-item trees into a pinned batch (tail
        padded) and launch the copy of each data place's part to its
        device: ``(device tree a place, pinned tree)``. ``places``: stack
        ``batch_size / data`` rows for that many leading places only (the
        salvage path's one item on place 0). On the card each copy runs on
        its place's copy stream; the caller records the events the
        consumer waits on."""
        devices = self._sharding.devices[:places] if places else self._sharding.devices
        rows = self._sharding.rows(self.batch_size) * len(devices)
        staged = stack_and_pad(trees, rows, pin=self._on_card)
        parts = DataSharding(devices).split(staged)
        if not self._on_card:
            return [tree_map(lambda leaf: torch.as_tensor(leaf).to(d), part) for d, part in zip(devices, parts)], staged
        placed = []
        for stream, d, part in zip(self._copy_streams, devices, parts):
            with torch.cuda.stream(stream):
                placed.append(tree_map(lambda leaf: leaf.to(d, non_blocking=True), part))
        return placed, staged

    def _await_inputs(self, trees: list, copied: list | None = None) -> None:
        """Each data place's stream waits on the copies of its tree
        (``copied``, else everything launched on its copy stream so far),
        and the caching allocator learns that the inputs are read there."""
        if not self._on_card:
            return
        for i, tree in enumerate(trees):
            stream = torch.cuda.current_stream(self._sharding.devices[i])
            if copied is None:
                stream.wait_stream(self._copy_streams[i])
            else:
                stream.wait_event(copied[i])
            for leaf in tree_flatten(tree)[0]:
                leaf.record_stream(stream)

    def _fetch(self, batch: _Batch) -> dict[str, list]:
        """Every stage's result rows on the host: one device-to-host copy a
        data place, each waited on once, the rows in input order."""
        tree = Parts([{s.name: out[s.name] for s in self._device_stages} for out in batch.outputs])
        if self._on_card:
            self.stats.syncs += len(tree.trees)
        host = device_get(tree, batch.ready, self._fetch_streams)
        return {name: unstack(out, batch.n) for name, out in host.items()}

    def _run_stages(self, inputs: dict[str, list], places: int, trace=None) -> list[dict[str, Any]]:
        """Launch every device stage on each of the first ``places`` data
        places' inputs, each place's with its device current; with a
        ``trace``, a child span a stage launch (which node of the task graph
        took the launch budget)."""
        outputs = []
        for i, device in enumerate(self._sharding.devices[:places]):
            out = {}
            with on_device(device):
                for s in self._device_stages:
                    with trace.span(f"stage.{s.name}") if trace is not None else contextlib.nullcontext():
                        out[s.name] = self._place_fns[s.name][i](inputs[s.name][i])
            outputs.append(out)
        return outputs

    # -- producer lane ----------------------------------------------------

    def _prepare(self, pool: DecodePool, chunk: list[tuple[int, Any, str | None, str | None]]) -> _Batch:
        # One trace per BATCH: decode covers the producer lane (pool
        # fan-out + stack + copy launch), queue is the hand-off wait to the
        # consumer, then dispatch/fetch/post land on the consumer.
        tr = begin_request("ingest")
        dspan = tr.begin("decode", {"items": len(chunk)}) if tr is not None else None
        raw_items = [item for _, item, _, _ in chunk]
        decoded, leases = self._decode_chunk(pool, raw_items)
        try:
            inputs: dict[str, Any] = {}
            staged: dict[str, Any] = {}
            for stage in self._device_stages:
                trees = pool.map(stage.preprocess, decoded)
                inputs[stage.name], staged[stage.name] = self._stage_to_device(trees)
            copied = [stream.record_event() for stream in self._copy_streams] if self._on_card else None
        except BaseException:
            for lease in leases:
                lease.release()
            raise
        # Producer-side count (only the producer thread writes): the pool's
        # own `tasks` gauge is process-wide.
        self._run_pool_tasks += len(raw_items) * (1 + len(self._device_stages))
        batch = _Batch(
            decoded,
            inputs,
            len(raw_items),
            [idx for idx, _, _, _ in chunk],
            [key for _, _, key, _ in chunk],
            [sha for _, _, _, sha in chunk],
        )
        batch.staged, batch.copied = staged, copied
        batch.leases = leases
        if tr is not None:
            dspan.end()
            batch.trace = tr
            batch.qspan = tr.begin("queue")
        return batch

    def _decode_chunk(self, pool: DecodePool, raw_items: list) -> tuple[list, list]:
        """Decode one chunk -> ``(decoded_values, shm_leases)``. Routes
        through the process lane (registered spec, all-bytes chunk,
        process-mode pool) or the thread lane (the ``decode`` callable),
        producing identical values either way."""
        if (
            self.decode_spec is not None
            and pool.process_mode
            and all(isinstance(it, (bytes, bytearray)) for it in raw_items)
        ):
            name, params = self.decode_spec
            try:
                results = pool.map_decode(name, raw_items, params)
            except QueueFull as e:
                # A decode worker died mid-chunk: a bulk run retries ITSELF
                # on the thread lane (map_decode already released any
                # half-chunk leases).
                logger.warning(
                    "process decode of a %d-item chunk failed (%s); re-decoding on the thread lane",
                    len(raw_items), e,
                )
                return pool.map(self.decode, raw_items), []
            adapt = self.decode_adapter or (lambda r: r.array)
            return [adapt(r) for r in results], results
        return pool.map(self.decode, raw_items), []

    @staticmethod
    def _offer(out: queue.Queue, entry, stop: threading.Event) -> bool:
        """put() that gives up when the consumer has stopped (an abandoned
        run() generator must not leave the producer parked on a full queue)."""
        while not stop.is_set():
            try:
                out.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(
        self,
        items: Iterable[Any],
        out: queue.Queue,
        stop: threading.Event,
        pool: DecodePool | None,
        cache: ResultCache | None,
        quarantine: QuarantineRegistry,
        tenant: str | None = None,
    ) -> None:
        # ``pool`` is run()'s single resolve of the shared pool (None when
        # ``workers`` is pinned). The producer runs on the BULK QoS lane
        # under run()'s caller tenant (contextvars do not cross thread
        # starts): its cache keys and quarantine fingerprints stay in the
        # caller's namespace, and any lane-aware component it reaches
        # sees bulk.
        private: DecodePool | None = None
        qos_token = qos_activate(tenant, LANE_BULK)
        try:
            if pool is None:  # workers pinned: run-scoped private pool
                pool = private = DecodePool(self._pinned_workers, name=f"ingest-prep:{id(self) & 0xFFFF:04x}")
            chunk: list[tuple[int, Any, str | None, str | None]] = []
            hits: dict[int, dict] = {}
            index = 0
            # Content-fingerprint dedupe tally: one sha256 of the RAW bytes
            # per item, surfaced per record as ``_sha256``; repeats within
            # this run count as ``duplicates``.
            seen_shas: set[str] = set()

            def emit_hits() -> bool:
                nonlocal hits
                if not hits:
                    return True
                pending, hits = hits, {}
                return self._offer(out, ("hits", pending), stop)

            def emit_chunk() -> bool:
                nonlocal chunk
                t0 = time.perf_counter()
                batch = self._prepare(pool, chunk)
                self.stats.decode_s += time.perf_counter() - t0
                chunk = []
                if not self._offer(out, batch, stop):
                    batch.release()  # abandoned run: recycle shm slots
                    return False
                return True

            for item in items:
                if stop.is_set():
                    return
                key = None
                record = None
                sha = None
                if isinstance(item, (bytes, bytearray)):
                    sha = hashlib.sha256(item).hexdigest()
                    if sha in seen_shas:
                        self.stats.duplicates += 1
                    else:
                        seen_shas.add(sha)
                if (
                    self.cache_namespace
                    and isinstance(item, (bytes, bytearray))
                    and (cache is not None or quarantine.enabled)
                ):
                    # One sha256 over the RAW bytes serves both pre-decode
                    # gates: the quarantine rejection and the cache lookup.
                    key = make_key(self.cache_namespace, self.cache_options, item)
                    reason = quarantine.reason(key)
                    if reason is not None:
                        # A known-bad item becomes a per-item error record
                        # instead of failing the same way again.
                        self.stats.quarantined += 1
                        self.stats.errors += 1
                        record = {"_error": f"quarantined: {reason}"}
                    elif cache is not None:
                        found, rec = cache.get(key, clone=copy.deepcopy)
                        if found:
                            self.stats.cache_hits += 1
                            record = rec
                if record is not None:
                    record["_sha256"] = sha
                    hits[index] = record
                    index += 1
                    # Bound the consumer's reorder buffer: a long hit run
                    # stuck behind a part-filled miss chunk flushes that
                    # chunk (padded batch).
                    if chunk and len(hits) >= self.batch_size:
                        if not emit_chunk():
                            return
                    if not chunk and not emit_hits():
                        return
                    continue
                chunk.append((index, item, key, sha))
                index += 1
                if len(chunk) == self.batch_size:
                    if not emit_hits() or not emit_chunk():
                        return
            if not emit_hits():
                return
            if chunk and not stop.is_set():
                if not emit_chunk():
                    return
            self._offer(out, None, stop)
        except BaseException as e:  # noqa: BLE001 - surface in the consumer
            self._offer(out, e, stop)
        finally:
            qos_deactivate(qos_token)
            if private is not None:
                self.stats.pool = private.gauges()
                private.close()

    # -- consumer ---------------------------------------------------------

    def _launch(self, batch: _Batch) -> None:
        """Launch every device stage on each data place's part of the batch
        and record the events its fetch waits on."""
        places = len(self._sharding.devices)
        self._await_inputs([{n: t[i] for n, t in batch.inputs.items()} for i in range(places)], batch.copied)
        if batch.trace is not None:
            with batch.trace.span("device.dispatch"):
                batch.outputs = self._run_stages(batch.inputs, places, batch.trace)
        else:
            batch.outputs = self._run_stages(batch.inputs, places)
        batch.ready = record_ready(Parts(batch.outputs))

    def run(self, items: Iterable[Any]) -> Iterator[dict]:
        """Yield one record dict per input item, in input order. Record keys
        are stage names plus ``_index``.

        With ``cache_namespace`` set, byte items found in the result cache
        bypass the batches entirely (their records arrive as ``hits``
        queue entries) and settled miss records are stored back — a small
        reorder buffer re-serializes the two streams into input order."""
        self.stats = IngestStats()  # fresh stats per run
        self._run_pool_tasks = 0
        # One resolve for the whole run (pool, cache, quarantine).
        run_pool = self.pool
        cache = self._cache()
        quarantine = get_quarantine()
        # Fence taken at run start: a namespace invalidation (model
        # hot-swap) landing mid-run must stop this run's records from
        # being stored past it.
        fence = cache.current_fence() if cache is not None else 0
        start = time.perf_counter()
        ready: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        producer = threading.Thread(
            target=self._producer,
            args=(items, ready, stop, run_pool, cache, quarantine, qos_current()[0]),
            name="ingest-producer",
            daemon=True,
        )
        producer.start()
        pending: deque[_Batch] = deque()
        current: _Batch | None = None  # batch mid-postprocess (lease cleanup)
        # Reorder buffer: index -> finished record.
        finished: dict[int, dict] = {}
        next_idx = 0
        try:
            done = False
            while True:
                # Launch up to `inflight` batches before fetching results.
                # Only BLOCK when nothing else is actionable.
                while not done and len(pending) < self.inflight:
                    try:
                        got = ready.get(block=not pending and next_idx not in finished)
                    except queue.Empty:
                        break
                    if got is None:
                        done = True
                        break
                    if isinstance(got, BaseException):
                        raise got
                    if isinstance(got, tuple) and got and got[0] == "hits":
                        for i, rec in got[1].items():
                            rec["_index"] = i
                            # Side-effect nodes (cache_output=False) fire on
                            # hits too, with decoded=None, on the bulk lane.
                            if self._derived_stages:
                                try:
                                    with qos_context(None, LANE_BULK):
                                        self._apply_derived(rec, None, skip_cached=True)
                                except QueueFull as e:
                                    rec["_error"] = f"shed: {type(e).__name__}: {e}"
                                    self.stats.errors += 1
                            finished[i] = rec
                        continue
                    if got.qspan is not None:
                        got.qspan.end()  # thread hop: producer -> consumer
                    try:
                        with qos_context(None, LANE_BULK):
                            self._launch(got)
                    except Exception as e:  # noqa: BLE001 - contain, don't abort the run
                        self._salvage_batch(got, e, cache, fence, quarantine, finished)
                        got.release()
                        continue
                    if got.trace is not None:
                        # Device compute overlaps this wait: the batch sits
                        # launched-but-unfetched while the consumer settles
                        # its predecessors.
                        got.wspan = got.trace.begin("inflight")
                    pending.append(got)
                    self.stats.max_inflight = max(self.stats.max_inflight, len(pending))
                yielded = False
                while next_idx in finished:
                    record = finished.pop(next_idx)
                    next_idx += 1
                    self.stats.items += 1
                    yielded = True
                    yield record
                if yielded:
                    continue
                if not pending:
                    if done:
                        break
                    continue  # block in the fill loop for more input
                batch = current = pending.popleft()
                t0 = time.perf_counter()
                if batch.wspan is not None:
                    batch.wspan.end()
                fspan = batch.trace.begin("fetch") if batch.trace is not None else None
                try:
                    rows_by_stage = self._fetch(batch)
                except Exception as e:  # noqa: BLE001 - device errors often land at the fetch
                    if fspan is not None:
                        fspan.end(error=type(e).__name__)
                    self.stats.device_s += time.perf_counter() - t0
                    self._salvage_batch(batch, e, cache, fence, quarantine, finished)
                    batch.release()
                    continue
                if fspan is not None:
                    fspan.end()
                self.stats.device_s += time.perf_counter() - t0
                t0 = time.perf_counter()
                pspan = batch.trace.begin("post") if batch.trace is not None else None
                # Postprocess runs under the BULK lane: per-item hooks submit
                # into SHARED admission queues (the face stage's embedder
                # batcher), and those submits must queue as bulk. Scoped to
                # the loop so the tag cannot leak across a yield.
                with qos_context(None, LANE_BULK):
                    for i in range(batch.n):
                        record: dict[str, Any] = {"_index": batch.indices[i]}
                        if batch.shas[i] is not None:
                            record["_sha256"] = batch.shas[i]
                        try:
                            for s in self._device_stages:
                                record[s.name] = s.postprocess(batch.decoded[i], rows_by_stage[s.name][i])
                            if self.annotate is not None:
                                record.update(self.annotate(batch.decoded[i]))
                            self._apply_derived(record, batch.decoded[i])
                        except QueueFull as e:
                            # A bulk-lane shed from a shared admission queue:
                            # transient load, not bad input — a retryable
                            # _error record, and the run continues.
                            record = {"_index": batch.indices[i], "_error": f"shed: {type(e).__name__}: {e}"}
                            self.stats.errors += 1
                        # Store back (deep-copied: the caller owns the
                        # yielded record) — except error records.
                        if cache is not None and batch.keys[i] is not None and not record.get("_error"):
                            cache.put(
                                batch.keys[i],
                                {k: v for k, v in record.items() if k not in self._strip_keys},
                                clone=copy.deepcopy,
                                fence=fence,
                            )
                        finished[batch.indices[i]] = record
                if pspan is not None:
                    pspan.end()
                finish_request(batch.trace)
                # Postprocess (the last pixel consumer) is done: recycle shm
                # slots.
                batch.release()
                current = None
                self.stats.post_s += time.perf_counter() - t0
                self.stats.batches += 1
        finally:
            stop.set()
            # Abandoned run: launched-but-unfetched batches (and any still
            # in the hand-off queue, drained below) hold arena leases.
            if current is not None:
                current.release()
            for b in pending:
                b.release()
            while producer.is_alive():
                try:
                    got = ready.get(timeout=0.05)
                    if isinstance(got, _Batch):
                        got.release()
                except queue.Empty:
                    pass
                producer.join(timeout=0.05)
            self.stats.wall_s = time.perf_counter() - start
            if run_pool is not None:  # private pools snapshot at teardown
                g = run_pool.gauges()
                # `tasks` is this run's own submissions; the other gauges
                # are pool-level context.
                g["tasks"] = self._run_pool_tasks
                self.stats.pool = g

    def _apply_derived(self, record: dict, decoded, skip_cached: bool = False) -> None:
        """Evaluate the derived nodes of the task graph (topological
        order) against one record. A node whose declared inputs are not
        all present (an ``_error`` record, a stale cached shape) is
        skipped, not crashed. ``skip_cached=True`` — the cache-hit path —
        leaves already-cached values alone and only (re-)fires nodes
        missing from the record."""
        for s in self._derived_stages:
            if skip_cached and s.name in record:
                continue
            if not all(d in record for d in s.inputs):
                continue
            record[s.name] = s.postprocess(decoded, {d: record[d] for d in s.inputs})

    def _salvage_batch(
        self,
        batch: _Batch,
        error: Exception,
        cache: ResultCache | None,
        fence: int,
        quarantine: QuarantineRegistry,
        finished: dict[int, dict],
    ) -> None:
        """A batch's device work raised: contain instead of aborting the
        run. Every item re-runs ALONE — its single-item tree padded to the
        same ``batch_size`` shape — and the item(s) that still fail become
        per-item ``_error`` records with their fingerprints quarantined;
        innocents keep their real records.

        A :class:`QueueFull` is a bulk-lane load shed from a shared
        admission queue, not a poison suspicion: every item becomes a
        retryable ``shed:`` record immediately (no re-runs, no
        quarantine)."""
        t0 = time.perf_counter()
        if isinstance(error, QueueFull):
            logger.warning(
                "ingest batch of %d shed by a shared admission queue (%s); items marked retryable", batch.n, error,
            )
            for i in range(batch.n):
                finished[batch.indices[i]] = {
                    "_index": batch.indices[i],
                    "_error": f"shed: {type(error).__name__}: {error}",
                }
                self.stats.errors += 1
            finish_request(batch.trace, error=f"{type(error).__name__}: {error}")
            self.stats.post_s += time.perf_counter() - t0
            self.stats.batches += 1
            return
        logger.warning(
            "ingest batch of %d failed (%s: %s); salvaging per-item", batch.n, type(error).__name__, error,
        )
        succeeded = 0
        failed: list[tuple[int, Exception]] = []  # (batch row, its error)
        with qos_context(None, LANE_BULK):
            for i in range(batch.n):
                idx = batch.indices[i]
                record: dict[str, Any] = {"_index": idx}
                if batch.shas[i] is not None:
                    record["_sha256"] = batch.shas[i]
                try:
                    # Each item alone on place 0, padded to a place's part.
                    inputs = {}
                    for s in self._device_stages:
                        inputs[s.name], _ = self._stage_to_device([s.preprocess(batch.decoded[i])], places=1)
                    self._await_inputs([{n: t[0] for n, t in inputs.items()}])
                    out = self._run_stages(inputs, 1)[0]
                    rows = unstack(device_get(out, record_ready(out), self._fetch_streams), 1)[0]
                    for s in self._device_stages:
                        record[s.name] = s.postprocess(batch.decoded[i], rows[s.name])
                except QueueFull as e:
                    # Shed mid-salvage: transient, never a poison verdict.
                    record = {"_index": idx, "_error": f"shed: {type(e).__name__}: {e}"}
                    self.stats.errors += 1
                except Exception as e:  # noqa: BLE001 - candidate poison (pending sibling evidence)
                    record = {"_index": idx, "_error": f"poison: {type(e).__name__}: {e}"}
                    self.stats.errors += 1
                    failed.append((i, e))
                else:
                    succeeded += 1
                    if self.annotate is not None:
                        record.update(self.annotate(batch.decoded[i]))
                    try:
                        self._apply_derived(record, batch.decoded[i])
                    except QueueFull as e:
                        record = {"_index": idx, "_error": f"shed: {type(e).__name__}: {e}"}
                        self.stats.errors += 1
                    if cache is not None and batch.keys[i] is not None and not record.get("_error"):
                        cache.put(
                            batch.keys[i],
                            {k: v for k, v in record.items() if k not in self._strip_keys},
                            clone=copy.deepcopy,
                            fence=fence,
                        )
                finished[idx] = record
        # Same evidence rule as the batcher's bisection: a poison verdict
        # needs at least one sibling that ran clean. If EVERY item failed
        # alone, the device — not the inputs — is broken: nothing is
        # quarantined.
        if succeeded:
            for i, e in failed:
                if batch.keys[i]:
                    quarantine.add(batch.keys[i], f"ingest: {type(e).__name__}: {e}")
        elif failed:
            logger.error(
                "ingest salvage found no healthy item in a batch of %d; "
                "treating as a device-level failure (nothing quarantined)",
                batch.n,
            )
            for i, _ in failed:
                finished[batch.indices[i]]["_error"] = f"batch: {type(error).__name__}: {error}"
        finish_request(batch.trace, error=f"{type(error).__name__}: {error}")
        self.stats.post_s += time.perf_counter() - t0
        self.stats.batches += 1

    def run_all(self, items: Iterable[Any]) -> list[dict]:
        return list(self.run(items))
