#!/usr/bin/env python
"""gRPC client of the lumen-tpu protocol (``python -m lumen_tpu_torch.client``).

The port's copy of the JAX package's client; it speaks the same wire
protocol as reference Lumen clients (``src/lumen/proto/ml_service.proto``):
one bidi ``Infer`` stream per request, task keyword on the first message,
JSON result bytes back. It talks to either package's server.

Usage (server from `python -m lumen_tpu_torch.serving.server --config ...`):

    python -m lumen_tpu_torch.client caps
    python -m lumen_tpu_torch.client topology
    python -m lumen_tpu_torch.client health
    python -m lumen_tpu_torch.client stats --metrics-addr 127.0.0.1:9100 --window 60
    python -m lumen_tpu_torch.client autopilot --metrics-addr 127.0.0.1:9100
    python -m lumen_tpu_torch.client peers --metrics-addr 127.0.0.1:9100
    python -m lumen_tpu_torch.client embed-text "a photo of a cat"
    python -m lumen_tpu_torch.client embed-image photo.jpg
    python -m lumen_tpu_torch.client classify photo.jpg --top-k 5
    python -m lumen_tpu_torch.client faces photo.jpg
    python -m lumen_tpu_torch.client ocr scan.png
    python -m lumen_tpu_torch.client caption photo.jpg --prompt "Describe this photo."
    python -m lumen_tpu_torch.client caption photo.jpg --stream
    python -m lumen_tpu_torch.client bulk clip_image_embed *.jpg
    python -m lumen_tpu_torch.client upsert batch.json --tenant alice
    python -m lumen_tpu_torch.client search query_vec.json -k 10 --tenant alice

``--full`` prints an answer's embedding vectors whole (the result JSON as
the server sent it) instead of the compact view.

Large payloads are chunked with the protocol's seq/total/offset framing —
the same reassembly path reference clients use.
"""

from __future__ import annotations

import argparse
import json
import mimetypes
import os
import sys

import grpc
from google.protobuf import empty_pb2

from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
from lumen_tpu_torch.serving.proto import ml_service_pb2_grpc as pbg
from lumen_tpu_torch.utils import tensorwire
from lumen_tpu_torch.utils import trace as utrace
from lumen_tpu_torch.utils.qos import RETRY_AFTER_META, TENANT_META_KEY

CHUNK = 1 << 20  # 1 MiB


def _as_bytes(part) -> bytes:
    """protobuf insists on ``bytes``: convert a memoryview slice at the
    last moment so an ndarray payload is copied exactly once, at proto
    construction — not once to serialize plus once per chunk."""
    return part if isinstance(part, bytes) else bytes(part)


def _tensor_item(payload, meta: dict[str, str]):
    """Normalize one payload: ndarrays become ``tensor/raw`` wire items
    (flat memoryview + dtype/shape meta merged over the caller's)."""
    import numpy as np

    if isinstance(payload, np.ndarray):
        buf, tmeta = tensorwire.tensor_payload(payload)
        return buf, tensorwire.TENSOR_MIME, {**meta, **tmeta}
    return payload, None, meta


def infer(stub, task: str, payload, mime: str = "application/octet-stream",
          meta: dict[str, str] | None = None, timeout: float = 300.0,
          stream: bool = False, tenant: str | None = None):
    """One Infer call. ``payload`` may be raw bytes (``mime`` describes
    them) or a numpy ndarray — arrays ride the ``tensor/raw`` wire path:
    dtype/shape meta, one serialization copy, and on the server side ZERO
    decode-pool work (the tensor goes straight to the batcher). Validate
    shapes against the service's ``tensor_input:<task>`` capability key
    before bulk traffic; a mismatch answers INVALID_ARGUMENT."""
    payload, tmime, meta = _tensor_item(payload, meta or {})
    return _infer(stub, task, payload, tmime or mime, meta, timeout,
                  stream=stream, tenant=tenant)


def _sidecar_get(metrics_addr: str, path: str, timeout: float = 10.0) -> dict:
    """One JSON GET against the observability sidecar. ``metrics_addr``
    is the sidecar's ``host:port`` (the server's ``--metrics-port``) or a
    full URL — the one place that normalization lives for every sidecar
    subcommand (stats, autopilot, peers)."""
    import urllib.request

    base = metrics_addr if "://" in metrics_addr else f"http://{metrics_addr}"
    with urllib.request.urlopen(f"{base.rstrip('/')}{path}", timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def get_stats(metrics_addr: str, window: float = 60.0, timeout: float = 10.0) -> dict:
    """Fetch the observability sidecar's rolling-window capacity view
    (``GET /stats?window=N``): last-N-seconds task latencies, device and
    decode-pool duty cycles, batch padding waste, HBM occupancy/headroom
    and the SLO burn summary."""
    return _sidecar_get(metrics_addr, f"/stats?window={int(window)}", timeout)


def _print_stats(stats: dict) -> None:
    """Operator view of the capacity-telemetry layer: one block per
    surface, omitting whatever the window saw nothing of."""
    w = stats.get("window_s", 0)
    print(f"window: last {w:.0f}s (telemetry {'on' if stats.get('enabled') else 'OFF'})")
    tasks = {
        name: s for name, s in stats.get("tasks", {}).items()
        if not name.startswith("stage:")
    }
    if tasks:
        print("tasks:")
        for name, s in tasks.items():
            print(
                f"  {name}: n={s['count']} rps={s.get('rps', 0)} "
                f"p50={s['p50_ms']}ms p95={s['p95_ms']}ms p99={s['p99_ms']}ms"
            )
    duty = stats.get("duty", {})
    if duty:
        print("duty cycles:")
        for name, d in duty.items():
            print(
                f"  {name}: {100 * d['fraction']:.1f}% busy "
                f"({d['busy_s']:.2f}s of {w:.0f}s x {d['capacity']:.0f})"
            )
    for batcher, b in stats.get("batch", {}).items():
        print(
            f"batch {batcher}: items={b.get('items', 0)} "
            f"padded={b.get('padded', 0)} "
            f"waste={b.get('padding_waste_pct', 0.0)}% "
            f"buckets={b.get('distinct_buckets', 0)}"
        )
    comp = stats.get("compile", {})
    if comp.get("compiles"):
        print(f"xla compiles: {comp['compiles']} in window (recompile storm?)")
    for dev, m in stats.get("device_memory", {}).items():
        if "occupancy_pct" in m:
            print(
                f"device {dev}: HBM {m['occupancy_pct']}% used, "
                f"headroom {m['headroom_bytes'] / 2**30:.2f} GiB "
                f"of {m.get('bytes_limit', 0) / 2**30:.2f} GiB"
            )
    slo = stats.get("slo", {})
    if slo:
        print("slo:")
        for task, rec in slo.items():
            print(
                f"  {task}: {rec.get('state')} burn_5m={rec.get('burn_5m')} "
                f"burn_1h={rec.get('burn_1h')}"
            )
    else:
        print("slo: no objectives configured (set LUMEN_SLO_<TASK>_P95_MS)")


def get_autopilot(metrics_addr: str, timeout: float = 10.0) -> dict:
    """Fetch the capacity controller's state from the observability
    sidecar (``GET /autopilot``): per-loop enable flags + latest sensor
    readings, the chip ledger, and the recent actuation decisions with
    the sensor readings that justified them."""
    return _sidecar_get(metrics_addr, "/autopilot", timeout)


def _print_autopilot(out: dict) -> None:
    """Operator view of the autopilot: policy header, one line per loop,
    then the decision tail (newest last)."""
    state = "running" if out.get("running") else (
        "enabled (not running)" if out.get("enabled") else "OFF"
    )
    print(f"autopilot: {state}")
    if not out.get("enabled") and not out.get("running"):
        print("  set LUMEN_AUTOPILOT=1 on the server to close the loops")
    if out.get("running"):
        print(
            f"  tick={out.get('tick_s', 0)}s cooldown={out.get('cooldown_s', 0)}s "
            f"sense={out.get('sense_window_s', 0)}s "
            f"rate<={out.get('rate_limit_per_min', 0)}/min "
            f"ticks={out.get('ticks', 0)} actuations={out.get('actuations', 0)}"
        )
    chips = out.get("chips") or {}
    if chips.get("capacity") is not None:
        print(
            f"  chip ledger: {chips.get('claimed', '?')} claimed "
            f"of {chips['capacity']}"
        )
    loops = out.get("loops") or {}
    for name, loop in loops.items():
        flag = "on" if loop.get("enabled") else "off (manual override)"
        detail = ""
        if name == "scale":
            fams = loop.get("families") or {}
            parts = [
                f"{fam}: duty={r.get('duty')} active={r.get('active')}"
                f"+{r.get('parked', 0)} parked"
                for fam, r in sorted(fams.items())
            ]
            detail = "; ".join(parts)
        elif name == "brownout":
            s = loop.get("sensors") or {}
            detail = f"rung={loop.get('rung', 0)} burn_5m={s.get('burn_5m')}"
        elif name == "window":
            caps = loop.get("batchers") or {}
            detail = "; ".join(
                f"{b}: waste={r.get('waste_pct')}% cap={r.get('cap_ms')}ms"
                for b, r in sorted(caps.items())
            )
        print(f"  loop {name}: {flag}" + (f" — {detail}" if detail else ""))
    decisions = out.get("decisions") or []
    if decisions:
        print(f"decisions (last {len(decisions)}):")
        for d in decisions:
            print(
                f"  [{d.get('loop')}] {d.get('component')}: {d.get('action')} "
                f"— {d.get('reason')}"
            )
    else:
        print("decisions: none recorded")


def get_peers(metrics_addr: str, timeout: float = 10.0) -> dict:
    """Fetch the federation fleet view from the observability sidecar
    (``GET /peers``): per-peer state (serving/ejected), dispatch/failover
    counters, ring ownership share, and the peer-cache hit rate."""
    return _sidecar_get(metrics_addr, "/peers", timeout)


def _print_peers(out: dict) -> None:
    """Operator view of the fleet: one line per peer, worst news first in
    each line (state), then traffic and cache columns."""
    if not out.get("enabled"):
        print("federation: not configured"
              + (f" ({out['detail']})" if out.get("detail") else ""))
        print("  set LUMEN_FED_PEERS (or LUMEN_FED_DISCOVER=1) on the server")
        return
    mode = out.get("mode", "?")
    print(f"federation: {mode} mode"
          + (f", self={out['self']}" if out.get("self") else "")
          + f", hop budget {out.get('hops', '?')}"
          + (f", role={out['role']}" if out.get("role") else ""))
    if out.get("capacity_gossip"):
        print("capacity gossip: on (ring weights follow reported headroom)")
    peers = out.get("peers") or {}
    for name, p in peers.items():
        state = p.get("state", "?")
        if p.get("draining"):
            # Drain leads the line: a planned handoff is the most
            # operator-relevant fact about this peer right now.
            state += " DRAINING"
        line = (
            f"  {name}: {state}"
            f" share={100 * p.get('ring_share', 0):.1f}%"
            f" dispatches={p.get('dispatches', 0)}"
            f" failovers={p.get('failovers', 0)}"
            f" sheds={p.get('sheds', 0)}"
        )
        # Gossiped capacity columns: present only when LUMEN_FED_CAPACITY
        # is armed on the server (the sidecar payload omits them
        # otherwise, so unconfigured output is unchanged).
        if p.get("weight") is not None:
            line += f" weight={p['weight']:.2f}"
        if p.get("duty") is not None:
            line += f" duty={100 * p['duty']:.0f}%"
        if p.get("burn_5m") is not None:
            line += f" burn_5m={p['burn_5m']}"
        if p.get("fed_role"):
            line += f" role={p['fed_role']}"
        hits, misses = p.get("cache_hits", 0), p.get("cache_misses", 0)
        if hits or misses:
            line += f" cache_hits={hits}/{hits + misses}"
        if state != "serving" and p.get("last_error"):
            line += f" last_error={p['last_error']!r}"
        print(line)
    mig = out.get("kv_migration") or {}
    if any(mig.values()):
        print(
            "kv migration:"
            f" out={mig.get('puts', 0)}"
            f" ({mig.get('put_bytes', 0)}B wire,"
            f" {mig.get('ref_pages', 0)} pages by-ref,"
            f" {mig.get('put_failures', 0)} failed,"
            f" {mig.get('lane_busy', 0)} lane-busy)"
            f" in={mig.get('in_commits', 0)}"
            f" ({mig.get('in_bytes', 0)}B,"
            f" {mig.get('in_rejected', 0)} rejected)"
        )
        puts, commits = mig.get("puts", 0), mig.get("in_commits", 0)
        if puts + commits:
            print(
                "duty split:"
                f" prefill {100 * puts / (puts + commits):.0f}%"
                f" / decode {100 * commits / (puts + commits):.0f}%"
            )
    print(f"peer-cache hit rate: {out.get('cache_peer_hit_rate', 0.0)}")


def _with_tenant(md, tenant: str | None):
    """Append the ``lumen-tenant`` request-metadata pair to the (possibly
    None) trace metadata — None stays None when there is nothing to send,
    preserving the exact no-metadata call shape for fakes/stubs."""
    if not tenant:
        return md
    return (*(md or ()), (TENANT_META_KEY, tenant))


def _shed_retry_after_s(meta, call=None) -> float | None:
    """Parse the server's ``lumen-retry-after-ms`` hint (sent on
    quota/queue/breaker/drain sheds) into seconds. Checked in response
    meta first; when absent there and ``call`` is the live RPC, the
    call's TRAILING metadata is scanned too — a federation front tier
    relaying an exhausted failover echoes the last peer's hint in the
    trailer, and the backoff floor must survive that hop exactly like a
    direct shed."""
    try:
        ms = int(meta[RETRY_AFTER_META])
    except (KeyError, TypeError, ValueError):
        ms = None
    if ms is None and call is not None:
        tm = getattr(call, "trailing_metadata", None)
        if callable(tm):
            try:
                for item in tm() or ():
                    key = getattr(item, "key", None)
                    if key is None and isinstance(item, (tuple, list)) and len(item) == 2:
                        key, value = item
                    else:
                        value = getattr(item, "value", None)
                    if key == RETRY_AFTER_META:
                        ms = int(value)
                        break
            except (TypeError, ValueError):
                ms = None
            except Exception:  # noqa: BLE001 - fakes without real metadata
                ms = None
    if ms is None:
        return None
    return ms / 1000.0 if ms > 0 else None


def _begin_client_trace(task: str):
    """Client half of end-to-end tracing (``LUMEN_TRACE_SAMPLE`` > 0 in
    the CLIENT environment): returns ``(trace, grpc_metadata)``. The
    trace id rides the ``lumen-trace`` request-metadata key, so the
    server's ``/traces`` records carry the SAME id as this process's
    recorder — one grep joins both sides of the RPC."""
    tr = utrace.begin_request(f"client:{task}")
    if tr is None:
        return None, None
    return tr, ((utrace.TRACE_META_KEY, tr.trace_id),)


def _requests(task: str, payload, mime: str, meta: dict[str, str]):
    """Yield chunked InferRequests (single message when small)."""
    if len(payload) <= CHUNK:
        yield pb.InferRequest(
            correlation_id="cli", task=task, payload=_as_bytes(payload),
            payload_mime=mime, meta=meta,
        )
        return
    total = (len(payload) + CHUNK - 1) // CHUNK
    for i in range(total):
        part = payload[i * CHUNK : (i + 1) * CHUNK]
        yield pb.InferRequest(
            correlation_id="cli", task=task, payload=_as_bytes(part),
            payload_mime=mime,
            meta=meta if i == 0 else {}, seq=i, total=total, offset=i * CHUNK,
        )


def _bulk_requests(task: str, items, mime: str, meta: dict[str, str]):
    """Chunked requests for N tagged items on ONE stream (correlation_id =
    item index; ``bulk: 1`` meta switches the server onto the concurrent
    fan-out lane). ndarray items ride ``tensor/raw`` with their own
    dtype/shape meta (see :func:`_tensor_item`)."""
    for i, raw_item in enumerate(items):
        payload, item_mime, item_meta = _tensor_item(raw_item, meta)
        cid = str(i)
        tagged = {**item_meta, "bulk": "1"}
        wire_mime = item_mime or mime
        if len(payload) <= CHUNK:
            yield pb.InferRequest(
                correlation_id=cid, task=task, payload=_as_bytes(payload),
                payload_mime=wire_mime, meta=tagged,
            )
            continue
        total = (len(payload) + CHUNK - 1) // CHUNK
        for j in range(total):
            part = payload[j * CHUNK : (j + 1) * CHUNK]
            yield pb.InferRequest(
                correlation_id=cid, task=task, payload=_as_bytes(part),
                payload_mime=wire_mime,
                meta=tagged if j == 0 else {}, seq=j, total=total, offset=j * CHUNK,
            )


def infer_bulk(stub, task: str, payloads=None, mime: str = "application/octet-stream",
               meta: dict[str, str] | None = None, timeout: float = 300.0,
               tenant: str | None = None, tensors=None):
    """Run MANY payloads through ONE ``Infer`` stream (the server's bulk
    fan-out lane): stream setup, admission and context bookkeeping are
    paid once, and the server coalesces the items into full device
    batches.

    ``tensors=`` (instead of, or mixed into, ``payloads``) sends
    pre-decoded ndarrays over the ``tensor/raw`` wire path — per-item
    dtype/shape meta, one serialization copy each, zero server-side
    decode. ``payloads`` items may themselves be ndarrays too.

    Yields ``(index, (result_bytes, mime, meta))`` per item AS RESPONSES
    ARRIVE — out of submission order. A per-item failure yields
    ``(index, ServiceError)`` instead; one poisoned payload never takes
    down its streammates."""
    from lumen_tpu_torch.serving import ServiceError, reassemble_result

    if payloads is None:
        payloads = tensors if tensors is not None else []
    elif tensors is not None:
        payloads = list(payloads) + list(tensors)
    tr, md = _begin_client_trace(task)
    md = _with_tenant(md, tenant)
    # payloads may be any iterable (downstream only enumerates it) — a
    # len() here would make enabling tracing reject generator inputs.
    n_items = str(len(payloads)) if hasattr(payloads, "__len__") else "?"
    rpc_span = tr.begin("rpc.client", {"items": n_items}) if tr else None
    pending: dict[str, list] = {}
    try:
        yield from _infer_bulk_stream(
            stub, task, payloads, mime, meta, timeout, md, pending,
            ServiceError, reassemble_result,
        )
    except BaseException as e:
        if rpc_span is not None:
            rpc_span.end(error=type(e).__name__)
        utrace.finish_request(tr, error=f"{type(e).__name__}: {e}" if tr else None)
        raise
    else:
        if rpc_span is not None:
            rpc_span.end()
        utrace.finish_request(tr)


def _infer_bulk_stream(stub, task, payloads, mime, meta, timeout, md, pending,
                       ServiceError, reassemble_result):
    kwargs = {"timeout": timeout} if md is None else {"timeout": timeout, "metadata": md}
    for resp in stub.Infer(_bulk_requests(task, payloads, mime, meta or {}), **kwargs):
        cid = resp.correlation_id
        if resp.HasField("error") and (resp.error.code or resp.error.message):
            pending.pop(cid, None)
            yield int(cid), ServiceError(resp.error.code, resp.error.message, resp.error.detail)
            continue
        chunks = pending.setdefault(cid, [])
        chunks.append(resp)
        if not resp.is_final:
            continue
        del pending[cid]
        try:
            data, mime_out, meta_out = reassemble_result(chunks)
        except ServiceError as e:
            yield int(cid), e
            continue
        yield int(cid), (data, mime_out, meta_out)


_RETRYABLE_RPC = (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.RESOURCE_EXHAUSTED)


class _InbandUnavailable(Exception):
    """An in-band ERROR_CODE_UNAVAILABLE response: a load shed or degraded
    service that answered BEFORE dispatching the task, so re-sending is
    explicitly safe (the server's own detail says to retry with backoff).
    ``retry_after_s`` carries the server's ``lumen-retry-after-ms``
    response-meta hint when the shed sent one (quota/queue/breaker sheds
    all do) — the shared retry helper floors its backoff on it."""

    def __init__(self, code: int, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.code = code
        self.retry_after_s = retry_after_s


def _transient_rpc(exc: BaseException) -> bool:
    """Retry transport-level failures a backoff can fix: server not up yet,
    connection dropped during stream setup, or an overloaded backend
    shedding load. Anything the server *answered* (INVALID_ARGUMENT,
    INTERNAL, in-band Error responses) is not retried."""
    return isinstance(exc, grpc.RpcError) and exc.code() in _RETRYABLE_RPC


def _client_retry_policy():
    from lumen_tpu_torch.utils.retry import RetryPolicy, policy_from_env

    return policy_from_env(
        "CLIENT", RetryPolicy(attempts=3, base_delay_s=0.5, max_delay_s=5.0)
    )


def _infer(stub, task: str, payload: bytes, mime: str, meta: dict[str, str],
           timeout: float, stream: bool = False, tenant: str | None = None):
    """One Infer attempt with stream-setup retries: an attempt that dies on
    a transient RpcError *before any response arrived* is retried with
    backoff (re-sending the request stream is safe then — the server never
    dispatched it to a handler we saw output from); after first byte the
    error propagates, since blind re-dispatch could double-run a task."""
    from lumen_tpu_torch.utils.retry import retry_call

    state = {"responded": False}

    def attempt():
        return _infer_once(stub, task, payload, mime, meta, timeout, stream, state,
                           tenant=tenant)

    try:
        return retry_call(
            attempt,
            policy=_client_retry_policy(),
            retryable=lambda e: isinstance(e, _InbandUnavailable)
            or (not state["responded"] and _transient_rpc(e)),
            scope="client_infer",
        )
    except _InbandUnavailable as e:
        raise SystemExit(f"server error [{e.code}]: {e}") from e


def _infer_once(stub, task: str, payload: bytes, mime: str, meta: dict[str, str],
                timeout: float, stream: bool, state: dict, tenant: str | None = None):
    tr, md = _begin_client_trace(task)
    md = _with_tenant(md, tenant)
    rpc_span = tr.begin("rpc.client") if tr is not None else None
    try:
        out = _infer_attempt(stub, task, payload, mime, meta, timeout, stream, state, md)
    except BaseException as e:
        if tr is not None:
            rpc_span.end(error=type(e).__name__)
            utrace.finish_request(tr, error=f"{type(e).__name__}: {e}")
        raise
    if tr is not None:
        rpc_span.end()
        utrace.finish_request(tr)
    return out


def _infer_attempt(stub, task: str, payload: bytes, mime: str, meta: dict[str, str],
                   timeout: float, stream: bool, state: dict, md=None):
    from lumen_tpu_torch.serving import ServiceError, reassemble_result

    state["responded"] = False
    # metadata only when tracing is on: fakes/stubs without the kwarg
    # (and the untraced hot path) keep the exact pre-trace call shape.
    kwargs = {"timeout": timeout} if md is None else {"timeout": timeout, "metadata": md}
    responses = stub.Infer(_requests(task, payload, mime, meta), **kwargs)
    chunked: list = []
    saw_deltas = False
    for resp in responses:
        state["responded"] = True
        if resp.error.message:
            if resp.error.code == pb.ERROR_CODE_UNAVAILABLE:
                # Shed / degraded-service answer: retryable by contract
                # (the server refused before dispatch; see _InbandUnavailable).
                # The response meta — or, for a front-tier relay, the RPC
                # trailer — may say exactly when to come back.
                raise _InbandUnavailable(
                    resp.error.code,
                    resp.error.message,
                    retry_after_s=_shed_retry_after_s(resp.meta, call=responses),
                )
            raise SystemExit(f"server error [{resp.error.code}]: {resp.error.message}")
        # Disambiguate the two total>1 shapes on the wire: a STREAMING
        # final message also carries total=n_deltas+1, but its deltas
        # arrived first with total=0 — only a result split by the
        # server's RESPONSE_CHUNK_BYTES starts chunked (total>1, seq 0).
        if (resp.total > 1 and not saw_deltas) or chunked:
            # reassemble_result joins AND enforces completeness — a stream
            # cut short before is_final must error, not return {}.
            chunked.append(resp)
            continue
        if resp.is_final:
            return json.loads(resp.result) if resp.result else {}
        saw_deltas = True
        if stream and resp.result:
            # Delta chunks are raw UTF-8 text (result_mime text/plain);
            # only the final response is JSON.
            print(resp.result.decode("utf-8", errors="replace"), end="", flush=True)
    if chunked:
        try:
            data, _mime, _meta = reassemble_result(chunked)
        except ServiceError as e:
            raise SystemExit(f"server error [{e.code}]: {e}") from e
        return json.loads(data) if data else {}
    return {}


def _read(path: str) -> tuple[bytes, str]:
    with open(path, "rb") as f:
        data = f.read()
    mime = mimetypes.guess_type(path)[0] or "application/octet-stream"
    return data, mime


def _load_json_arg(path: str):
    """Parse a JSON document from a file path or stdin (``-``)."""
    try:
        raw = sys.stdin.read() if path == "-" else open(path, encoding="utf-8").read()
        return json.loads(raw)
    except OSError as e:
        raise SystemExit(f"cannot read {path}: {e}") from e
    except ValueError as e:
        raise SystemExit(f"{path} is not valid JSON: {e}") from e


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=(__doc__ or "lumen-tpu example client").splitlines()[0]
    )
    ap.add_argument("--addr", default="127.0.0.1:50051")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument(
        "--tenant",
        default=None,
        help="tenant id sent as lumen-tenant request metadata (server-side "
        "weighted-fair queuing + per-tenant quota; default: the 'default' tenant)",
    )
    ap.add_argument(
        "--priority",
        choices=("interactive", "bulk"),
        default=None,
        help="priority lane (interactive > bulk; the bulk command auto-tags bulk)",
    )
    ap.add_argument(
        "--full", action="store_true",
        help="print embedding vectors whole (the result JSON as the server sent it)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("caps")
    sub.add_parser(
        "topology",
        help="per-service device topology + replica fleet layout "
        "(StreamCapabilities extra: device_count, mesh_axes, replicas, "
        "dispatch policy, live replica states)",
    )
    sub.add_parser("health")
    p = sub.add_parser(
        "stats",
        help="rolling-window capacity view from the observability sidecar "
        "(windowed p50/p95 per task, device/decode duty cycles, HBM "
        "headroom, SLO burn)",
    )
    p.add_argument(
        "--metrics-addr",
        default="127.0.0.1:9100",
        help="host:port (or URL) of the server's --metrics-port sidecar",
    )
    p.add_argument("--window", type=float, default=60.0, help="window seconds")
    p.add_argument("--json", action="store_true", help="raw JSON instead of the summary")
    p = sub.add_parser(
        "autopilot",
        help="capacity-controller state from the observability sidecar "
        "(per-loop flags + sensors, chip ledger, recent actuation "
        "decisions with their justifying readings)",
    )
    p.add_argument(
        "--metrics-addr",
        default="127.0.0.1:9100",
        help="host:port (or URL) of the server's --metrics-port sidecar",
    )
    p.add_argument("--json", action="store_true", help="raw JSON instead of the summary")
    p = sub.add_parser(
        "peers",
        help="federation fleet view from the observability sidecar "
        "(per-peer serving/ejected state, ring ownership share, "
        "dispatch/failover counters, peer-cache hit rate)",
    )
    p.add_argument(
        "--metrics-addr",
        default="127.0.0.1:9100",
        help="host:port (or URL) of the server's --metrics-port sidecar",
    )
    p.add_argument("--json", action="store_true", help="raw JSON instead of the summary")
    p = sub.add_parser("embed-text"); p.add_argument("text")
    p = sub.add_parser("embed-image"); p.add_argument("image")
    p = sub.add_parser("classify"); p.add_argument("image"); p.add_argument("--top-k", type=int, default=5); p.add_argument("--scene", action="store_true")
    p = sub.add_parser("faces"); p.add_argument("image"); p.add_argument("--embed", action="store_true")
    p = sub.add_parser("ocr"); p.add_argument("image")
    p = sub.add_parser("caption"); p.add_argument("image")
    p.add_argument("--prompt", default="Describe this photo in one sentence.")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--stream", action="store_true")
    p = sub.add_parser("bulk", help="many images down ONE stream (server bulk lane)")
    p.add_argument("task"); p.add_argument("images", nargs="+")
    p = sub.add_parser(
        "search",
        help="ANN top-k over the tenant's index — the query vector rides "
        "the tensor/raw wire path (zero server-side decode); a federated "
        "front fans it to the tenant's shard owners and merges",
    )
    p.add_argument("vector", help="path to a JSON array of floats ('-' = stdin)")
    p.add_argument("-k", "--top-k", type=int, default=10)
    p.add_argument(
        "--shard", default=None,
        help="pin one named shard (default: the server fans over all of them)",
    )
    p.add_argument("--json", action="store_true", help="raw response JSON instead of the ranked list")
    p = sub.add_parser(
        "upsert",
        help="index a vector batch — packed client-side as a tensor/bundle "
        "([vectors f32, ids as JSON-in-uint8]), the same raw-tensor shape "
        "the fleet-internal hop re-packs per shard",
    )
    p.add_argument(
        "batch",
        help="path to JSON {'ids': [...], 'vectors': [[...]]} ('-' = stdin)",
    )
    p.add_argument("--json", action="store_true", help="raw response JSON instead of the added/updated summary")
    args = ap.parse_args(argv)

    if args.cmd == "stats":
        # Sidecar HTTP, not gRPC: no channel needed (and none opened).
        stats = get_stats(args.metrics_addr, window=args.window)
        if args.json:
            print(json.dumps(stats, indent=2))
        else:
            _print_stats(stats)
        return 0
    if args.cmd == "autopilot":
        # Sidecar HTTP like stats: the controller's state and decision ring.
        out = get_autopilot(args.metrics_addr)
        if args.json:
            print(json.dumps(out, indent=2))
        else:
            _print_autopilot(out)
        return 0
    if args.cmd == "peers":
        # Sidecar HTTP like stats: the federation fleet view.
        out = get_peers(args.metrics_addr)
        if args.json:
            print(json.dumps(out, indent=2))
        else:
            _print_peers(out)
        return 0

    from lumen_tpu_torch.utils.retry import retry_call

    chan = grpc.insecure_channel(args.addr)
    # Channel establishment retries: a server mid-restart (or mid-recovery)
    # comes up within a few backoff steps; a genuinely absent one still
    # fails fast enough to be usable interactively.
    retry_call(
        lambda: grpc.channel_ready_future(chan).result(timeout=min(args.timeout, 10)),
        policy=_client_retry_policy(),
        retryable=(grpc.FutureTimeoutError,),
        scope="client_connect",
    )
    stub = pbg.InferenceStub(chan)

    if args.cmd == "caps":
        caps = stub.GetCapabilities(empty_pb2.Empty(), timeout=args.timeout)
        print(json.dumps({
            "service": caps.service_name,
            "models": list(caps.model_ids),
            "runtime": caps.runtime,
            "tasks": [t.name for t in caps.tasks],
        }, indent=2))
        return 0
    if args.cmd == "topology":
        # The per-service capability records carry the fleet layout in
        # ``extra`` — a fleet-internal client picks its endpoint (and how
        # hard to fan out) from this, with zero Infer probes.
        topo_keys = (
            "device_count", "mesh_axes", "devices_per_replica", "replicas",
            "replica_policy", "replica_states", "breaker",
        )
        out = {}
        for cap in stub.StreamCapabilities(empty_pb2.Empty(), timeout=args.timeout):
            extra = dict(cap.extra)
            out[cap.service_name] = {
                "models": list(cap.model_ids),
                "max_concurrency": cap.max_concurrency,
                **{k: extra[k] for k in topo_keys if k in extra},
            }
        print(json.dumps(out, indent=2))
        return 0
    if args.cmd == "health":
        stub.Health(empty_pb2.Empty(), timeout=args.timeout)
        print("ok")
        return 0

    # QoS identity for every Infer this invocation makes: the tenant rides
    # gRPC request metadata, the priority lane rides request meta.
    qos_meta = {"priority": args.priority} if args.priority else {}

    def run_infer(task, payload, mime, meta, stream=False):
        return _infer(stub, task, payload, mime, {**qos_meta, **meta},
                      args.timeout, stream=stream, tenant=args.tenant)

    if args.cmd == "bulk":
        from lumen_tpu_torch.serving import ServiceError

        payloads, mimes = zip(*(_read(p) for p in args.images))
        failed = 0
        for idx, res in infer_bulk(
            stub, args.task, list(payloads), mime=mimes[0], timeout=args.timeout,
            meta=qos_meta, tenant=args.tenant,
        ):
            name = args.images[idx]
            if isinstance(res, ServiceError):
                failed += 1
                print(f"{name}: ERROR [{res.code}] {res}")
                continue
            data, _mime, meta = res
            out = json.loads(data) if data else {}
            if "vector" in out:
                out["vector"] = f"[{len(out['vector'])} floats]"
            hit = " (cache hit)" if meta.get("cache_hit") == "1" else ""
            print(f"{name}{hit}: {json.dumps(out, ensure_ascii=False)}")
        return 1 if failed else 0

    if args.cmd == "search":
        import numpy as np

        vec = np.asarray(_load_json_arg(args.vector), np.float32)
        if vec.ndim != 1:
            raise SystemExit(f"query vector must be a flat array, got shape {vec.shape}")
        meta = dict(qos_meta)
        meta["k"] = str(args.top_k)
        if args.shard is not None:
            meta["shard"] = args.shard
        out = infer(stub, "search_query", vec, meta=meta,
                    timeout=args.timeout, tenant=args.tenant)
        if args.json:
            print(json.dumps(out, indent=2))
            return 0
        hits = list(zip(out.get("ids", []), out.get("scores", [])))
        if not hits:
            print(f"no hits (searched {out.get('shards', 0)} shards, "
                  f"tenant {out.get('tenant', 'default')!r})")
            return 0
        for rank, (vid, score) in enumerate(hits, 1):
            print(f"{rank:3d}. {score:8.4f}  {vid}")
        return 0
    if args.cmd == "upsert":
        import numpy as np

        body = _load_json_arg(args.batch)
        try:
            ids, vecs = body["ids"], np.asarray(body["vectors"], np.float32)
        except (TypeError, KeyError) as e:
            raise SystemExit(
                "batch must be JSON {'ids': [...], 'vectors': [[...]]}"
            ) from e
        payload = tensorwire.pack_bundle([
            vecs, np.frombuffer(json.dumps(ids).encode("utf-8"), np.uint8),
        ])
        out = run_infer("search_upsert", payload, tensorwire.BUNDLE_MIME, {})
        if args.json:
            print(json.dumps(out, indent=2))
        else:
            print(f"added={out.get('added', 0)} updated={out.get('updated', 0)}"
                  + (f" total={out['total']}" if "total" in out else "")
                  + f" tenant={out.get('tenant', 'default')}")
        return 0

    if args.cmd == "embed-text":
        out = run_infer("clip_text_embed", args.text.encode(), "text/plain", {})
    elif args.cmd == "embed-image":
        data, mime = _read(args.image)
        out = run_infer("clip_image_embed", data, mime, {})
    elif args.cmd == "classify":
        data, mime = _read(args.image)
        task = "clip_scene_classify" if args.scene else "clip_classify"
        out = run_infer(task, data, mime, {"topk": str(args.top_k)})
    elif args.cmd == "faces":
        data, mime = _read(args.image)
        task = "face_detect_and_embed" if args.embed else "face_detect"
        out = run_infer(task, data, mime, {})
    elif args.cmd == "ocr":
        data, mime = _read(args.image)
        out = run_infer("ocr", data, mime, {})
    elif args.cmd == "caption":
        data, mime = _read(args.image)
        meta = {
            "messages": json.dumps([{"role": "user", "content": args.prompt}]),
            "max_new_tokens": str(args.max_new_tokens),
            "do_sample": "false",
        }
        task = "vlm_generate_stream" if args.stream else "vlm_generate"
        out = run_infer(task, data, mime, meta, stream=args.stream)
        if args.stream:
            print()  # newline after streamed chunks
    else:  # pragma: no cover
        raise SystemExit(f"unknown command {args.cmd}")

    # Embeddings are long; print a compact view unless asked for the whole.
    if "vector" in out and not args.full:
        vec = out.pop("vector")
        out["vector"] = f"[{len(vec)} floats: {vec[0]:.4f}, {vec[1]:.4f}, ...]"
    print(json.dumps(out, indent=2, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
