"""Fleet federation: consistent-hash peer routing + cross-host cache tier.

Everything below this module serves from ONE process on one host's chips —
the actual ceiling for the ROADMAP's "millions of users" north star. This
module is the first subsystem where the *process boundary* is the unit of
scale: a set of lumen-tpu servers (peers) becomes one fleet, glued by
three ideas that all reuse machinery the stack already has, one level up:

- **consistent-hash ring keyed by the content address.** The result cache
  already addresses work by ``sha256(payload bytes)`` — that digest is
  network-portable by construction, so hashing it onto a ring of peers
  gives *cache affinity for free*: identical payloads always land on the
  same peer, whose RAM/disk tiers therefore concentrate the hits. The
  ring uses virtual nodes (64 per peer) so 3 peers split the keyspace
  within a few percent, and membership changes move only the
  departed/arrived peer's arcs (the classic consistent-hashing property —
  tested by ``tests/test_federation_props.py``).

- **per-peer health, breaker-style, one level up.** Each peer carries the
  same failure-streak → eject → background-probe → readmit lifecycle a
  :class:`~lumen_tpu_torch.serving.breaker.CircuitBreaker` gives one service and
  a :class:`~lumen_tpu_torch.runtime.fleet.ReplicaSet` gives one replica:
  in-band forward failures and Health-poll failures feed one streak
  (``LUMEN_FED_FAILURES``), an ejected peer's ring segment spills to its
  successors, and a background probe (``LUMEN_FED_POLL_S`` cadence, after
  ``LUMEN_FED_EJECT_S``) readmits it. Ejection records a ``fed_peer_down``
  flight-recorder event that captures an incident bundle; readmission
  records ``fed_peer_readmit``.

- **a peer-cache lookup protocol.** Before computing a missed request, a
  non-owner peer asks the ring owner's cache over the unchanged gRPC
  protocol (the reserved ``fed_cache_lookup`` task answered by the hub
  router, O(1) on the owner, before any admission accounting).
  Owner-side single-flight extends across the tier: the lookup can wait
  (``wait_ms``) on the owner's in-flight computation instead of
  duplicating it. Dedupe is **owner-anchored** (lookup-only, no
  write-back): traffic routed through a front tier always lands on the
  owner first, so a duplicate payload costs device work exactly once
  fleet-wide there (the bench-asserted guarantee); a result computed AT
  a non-owner (direct traffic that bypassed the front) stays in that
  host's local cache, so worst case is one compute per first-touch side.

A server with ``LUMEN_FED_PEERS`` **unset boots byte-identical to the
single-host path**: :func:`maybe_federation` returns ``None``, no thread
starts, no gauge registers, and the per-request serving path gains only a
task-name compare (tier-1 guard in ``tests/test_federation.py``).

Pure host plumbing over gRPC (like :mod:`~lumen_tpu_torch.runtime.result_cache`),
usable by a front tier that owns no models and touches no device.

The port's copy of ``lumen_tpu/runtime/federation.py``. It speaks the same
wire as the JAX package, so the two can share a fleet, with two
differences that the port's own state forces:

- a migration commit's rng leaf keeps the JAX shape and dtype (a
  ``uint32[2]`` PRNG key), drawn for each row from the prefill engine's
  ``torch.Generator`` at export: the port's engine draws a row's decode
  from that one generator, not a per-row key, so a sampled row that
  migrates goes on with the decode host's draws (a JAX host's from this
  key). Greedy rows are token-identical either way;
- a peer-cache blob is unpickled by
  :func:`~lumen_tpu_torch.runtime.result_cache.peer_loads`, which refuses
  a blob that names a JAX-package class: such an answer is a miss, never
  an import of that package.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import logging
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable

import grpc
from google.protobuf import empty_pb2

from ..utils import telemetry
from ..utils.deadline import remaining
from ..utils.env import env_float, env_int, env_list
from ..utils.metrics import metrics
from ..utils.trace import current_trace

logger = logging.getLogger(__name__)

PEERS_ENV = "LUMEN_FED_PEERS"
SELF_ENV = "LUMEN_FED_SELF"
DISCOVER_ENV = "LUMEN_FED_DISCOVER"

# The reserved cache-lookup task name and the owner-side wait clamp live
# with their server half in the router (this module cannot be imported
# there); re-exported so federation callers have one local name
# for the protocol.
from ..serving.router import (  # noqa: E402,F401
    FED_CACHE_MAX_WAIT_S,
    FED_CACHE_TASK,
    FED_CAPACITY_ENV,
    FED_CAPACITY_META,
    FED_KV_PUT_TASK,
    FED_ROLE_META,
    ROLE_ENV,
    advertised_fed_role,
    capacity_gossip_enabled,
)

#: per-peer virtual nodes on the ring — enough that 3 peers split the
#: keyspace within a few percent, cheap enough that membership changes
#: rebuild in microseconds.
VNODES = 64

SERVING = "serving"
EJECTED = "ejected"
_STATE_CODES = {SERVING: 0, EJECTED: 2}

#: disaggregation lanes + their codes for the numeric-only gauges
#: registry (``federation:{peer}`` → ``fed_role``).
ROLE_BOTH, ROLE_PREFILL, ROLE_DECODE = "both", "prefill", "decode"
_ROLE_CODES = {ROLE_BOTH: 0, ROLE_PREFILL: 1, ROLE_DECODE: 2}

#: tasks the disaggregation planner splits across lanes — generation is
#: the only protocol task with a prefill/decode phase boundary to cut at.
DISAGG_TASKS = ("vlm_generate", "vlm_generate_stream")

#: wire chunk size for a migration commit's page payload (under the
#: 64 MB gRPC message cap with protobuf headroom).
_KV_CHUNK_BYTES = 48 * 1024 * 1024

#: process-wide KV-migration counters — both wire halves call in via
#: :func:`note_migration` (lock-free int += like ``Peer.stats``),
#: surfaced in ``export_status()["kv_migration"]`` and the client
#: ``peers`` subcommand's duty-split line.
MIGRATION = {
    "puts": 0,            # commit legs that retired on the decode peer
    "put_bytes": 0,       # payload bytes shipped out on the wire
    "put_failures": 0,    # outbound attempts that fell back to the local ladder
    "ref_pages": 0,       # pages resolved by content-hash reference, not bytes
    "lane_busy": 0,       # dispatches refused: all migration lanes in flight
    "in_commits": 0,      # rows this host admitted from a prefill peer
    "in_bytes": 0,        # payload bytes received on the wire
    "in_rejected": 0,     # inbound commits this host refused (typed, in-band)
}


def note_migration(**deltas: int) -> None:
    for key, delta in deltas.items():
        MIGRATION[key] = MIGRATION.get(key, 0) + int(delta)



def fed_hops() -> int:
    """``LUMEN_FED_HOPS``: forward attempts per request through the front
    tier (first ring owner + failover successors; default 3)."""
    return env_int("LUMEN_FED_HOPS", 3, minimum=1)


def fed_failures() -> int:
    """``LUMEN_FED_FAILURES``: consecutive transport/poll failures that
    eject a peer from the ring (default 3)."""
    return env_int("LUMEN_FED_FAILURES", 3, minimum=1)


def fed_eject_s() -> float:
    """``LUMEN_FED_EJECT_S``: how long an ejected peer sheds ring traffic
    before the background probe may readmit it (default 5s)."""
    return env_float("LUMEN_FED_EJECT_S", 5.0, minimum=0.1)


def fed_poll_s() -> float:
    """``LUMEN_FED_POLL_S``: health-poll cadence over the peer set
    (default 2s; each tick Health-probes every non-ejected peer and any
    ejected peer whose eject window elapsed)."""
    return env_float("LUMEN_FED_POLL_S", 2.0, minimum=0.1)


def fed_lookup_timeout_s() -> float:
    """``LUMEN_FED_LOOKUP_TIMEOUT_S``: RPC deadline for one peer-cache
    lookup (default 2s) — a lookup must always be much cheaper than the
    device work it tries to avoid."""
    return env_float("LUMEN_FED_LOOKUP_TIMEOUT_S", 2.0, minimum=0.05)


def fed_lookup_wait_ms() -> int:
    """``LUMEN_FED_LOOKUP_WAIT_MS``: how long the OWNER may hold a cache
    lookup on its in-flight computation of the same key (default 10000) —
    this is what extends single-flight coalescing across the tier. 0
    disables the wait (pure cache peek)."""
    return env_int("LUMEN_FED_LOOKUP_WAIT_MS", 10000, minimum=0)


def fed_forward_timeout_s() -> float:
    """``LUMEN_FED_FORWARD_TIMEOUT_S``: front-tier forward deadline per
    hop when the client set none (default 300s, the client default)."""
    return env_float("LUMEN_FED_FORWARD_TIMEOUT_S", 300.0, minimum=1.0)


def fed_role() -> str:
    """``LUMEN_FED_ROLE``: this host's lane in a disaggregated fleet —
    ``prefill`` (serve prompt prefill + vision encode, migrate the decode
    out), ``decode`` (accept migrated rows), or ``both`` (the default AND
    the byte-identical unconfigured state: nothing advertised, no routing
    change anywhere)."""
    return advertised_fed_role() or ROLE_BOTH


def fed_kv_timeout_s() -> float:
    """``LUMEN_FED_KV_TIMEOUT_S``: end-to-end deadline for one migration
    commit (default 300s). It covers the decode host's ENTIRE remaining
    decode, not just the page transfer — the token stream rides the same
    RPC back."""
    return env_float("LUMEN_FED_KV_TIMEOUT_S", 300.0, minimum=1.0)


def fed_kv_lanes() -> int:
    """``LUMEN_FED_KV_LANES``: concurrent migration dispatches in flight
    per prefill host (default 4). Over budget, rows decode locally
    instead of queueing — migration is an optimization, never a wait."""
    return env_int("LUMEN_FED_KV_LANES", 4, minimum=1)


def fed_capacity_hyst() -> float:
    """``LUMEN_FED_CAPACITY_HYST``: minimum per-peer weight delta before
    a capacity report may rebuild the ring (default 0.1) — sub-threshold
    duty jitter must not move arcs at all."""
    return env_float("LUMEN_FED_CAPACITY_HYST", 0.1, minimum=0.0, maximum=1.0)


def fed_capacity_remap_s() -> float:
    """``LUMEN_FED_CAPACITY_REMAP_S``: minimum seconds between two
    capacity-driven ring rebuilds (default 10) — the remap-rate cap that
    keeps a noisy fleet from thrashing arc ownership. A drain flip
    bypasses it: handing off a planned drain is exactly the case where
    waiting means discovering it by error."""
    return env_float("LUMEN_FED_CAPACITY_REMAP_S", 10.0, minimum=0.0)


def fed_capacity_stale_polls() -> int:
    """``LUMEN_FED_CAPACITY_STALE_POLLS``: consecutive polls without a
    capacity report before a peer's last report decays to neutral weight
    (default 3) — a silent sidecar must not keep its last headroom claim
    forever."""
    return env_int("LUMEN_FED_CAPACITY_STALE_POLLS", 3, minimum=1)


#: weight floor for a loaded-but-alive peer: ~3 vnodes of 64, so a fully
#: busy host sheds most arcs yet stays reachable. Only a DRAINING peer
#: goes to exactly 0 (no arcs at all).
MIN_CAPACITY_WEIGHT = 0.05

#: hot result-cache keys a draining peer advertises (and the front
#: prefetches onto ring successors) per drain handoff.
FED_HANDOFF_KEYS = 8


# ---------------------------------------------------------------------------
# Consistent-hash ring
# ---------------------------------------------------------------------------


class HashRing:
    """Consistent-hash ring over peer names, keyed by sha256 hex digests.

    Positions are the first 8 bytes of ``sha256(f"{name}#{vnode}")``; a
    key (a sha256 hexdigest — the result cache's content address) maps to
    the first vnode clockwise from ``int(key[:16], 16)``. Deterministic
    across processes and insertion orders by construction — the front
    tier and every peer build the SAME ring from the same peer list, so
    ownership agrees fleet-wide with zero coordination.

    ``weights`` (capacity gossip) scale a peer's vnode COUNT: weight
    ``w`` keeps ``round(vnodes * w)`` of its points, clamped to
    ``[0, vnodes]``; an omitted name keeps all of them. Because a peer's
    vnodes are the prefix ``name#0..#(k-1)``, changing one peer's weight
    only adds/removes that peer's own points — the minimal-remap
    property survives weighting (property-tested). Weight 0 removes the
    peer from the ring entirely (a draining host owns no arcs).
    """

    def __init__(
        self,
        names: list[str],
        vnodes: int = VNODES,
        weights: dict[str, float] | None = None,
    ):
        self.names = sorted(set(names))
        self.vnodes = vnodes
        self.weights = dict(weights) if weights else {}
        points: list[tuple[int, str]] = []
        for name in self.names:
            w = self.weights.get(name)
            count = (
                vnodes if w is None
                else max(0, min(vnodes, round(vnodes * w)))
            )
            for i in range(count):
                digest = hashlib.sha256(f"{name}#{i}".encode()).digest()
                points.append((int.from_bytes(digest[:8], "big"), name))
        points.sort()
        self._points = points
        self._positions = [p for p, _ in points]

    @staticmethod
    def key_position(key_hex: str) -> int:
        """Ring position of a content address (sha256 hexdigest or any
        hex string; shorter strings are zero-extended)."""
        return int((key_hex[:16] or "0").ljust(16, "0"), 16)

    def owners(self, key_hex: str, n: int = 1, skip: frozenset | set = frozenset()) -> list[str]:
        """Up to ``n`` DISTINCT peer names in preference order (the ring
        owner first, then clockwise successors), skipping names in
        ``skip`` — an ejected peer's arc spills to its successors."""
        if not self._points or n <= 0:
            return []
        out: list[str] = []
        start = bisect.bisect_right(self._positions, self.key_position(key_hex))
        total = len(self._points)
        for step in range(total):
            name = self._points[(start + step) % total][1]
            if name in skip or name in out:
                continue
            out.append(name)
            if len(out) >= n:
                break
        return out

    def owner(self, key_hex: str, skip: frozenset | set = frozenset()) -> str | None:
        owners = self.owners(key_hex, 1, skip)
        return owners[0] if owners else None

    def shares(self) -> dict[str, float]:
        """Fraction of the keyspace each peer owns (arc-length exact,
        not sampled) — the ``ring_share`` gauge and the ``peers``
        subcommand's ownership column."""
        if not self._points:
            return {}
        out = {name: 0 for name in self.names}
        span = 1 << 64
        prev = self._points[-1][0] - span  # wrap: last point opens the first arc
        for pos, name in self._points:
            out[name] += pos - prev
            prev = pos
        return {name: width / span for name, width in out.items()}


# ---------------------------------------------------------------------------
# Peer set
# ---------------------------------------------------------------------------


@dataclass
class PeerSpec:
    """One configured peer: gRPC address plus an optional observability
    sidecar. Spelled ``host:port`` or ``host:port@sidecar`` in
    ``LUMEN_FED_PEERS``, where ``sidecar`` is a bare port (same host) or
    its own ``host:port``."""

    addr: str
    sidecar: str | None = None

    @property
    def name(self) -> str:
        return self.addr


def parse_peer_spec(entry: str) -> PeerSpec | None:
    entry = entry.strip()
    if not entry:
        return None
    addr, _, sidecar = entry.partition("@")
    addr = addr.strip()
    if ":" not in addr:
        logger.warning("malformed %s entry %r (need host:port); ignored", PEERS_ENV, entry)
        return None
    sidecar = sidecar.strip() or None
    if sidecar and ":" not in sidecar:
        sidecar = f"{addr.rsplit(':', 1)[0]}:{sidecar}"
    return PeerSpec(addr=addr, sidecar=sidecar)


def parse_peer_specs() -> list[PeerSpec]:
    """The resolved static peer set from ``LUMEN_FED_PEERS`` (empty when
    unset — federation stays entirely off)."""
    specs = [parse_peer_spec(e) for e in env_list(PEERS_ENV)]
    out: list[PeerSpec] = []
    seen: set[str] = set()
    for spec in specs:
        if spec is not None and spec.addr not in seen:
            seen.add(spec.addr)
            out.append(spec)
    return out


class Peer:
    """Live state for one peer: lazy channel/stub, breaker-style health,
    and dispatch accounting surfaced as ``federation:{addr}`` gauges."""

    def __init__(self, spec: PeerSpec, stub_factory: Callable[[str], Any]):
        self.spec = spec
        self.name = spec.name
        self._stub_factory = stub_factory
        self._stub = None
        self._stub_lock = threading.Lock()
        self.state = SERVING
        self.streak = 0
        self.ejected_at = 0.0
        self.last_ok = 0.0
        self.last_error = ""
        self.slo: dict = {}
        # Disaggregation lane, learned passively from the peer's Health
        # trailing metadata; "both" until (unless) the peer advertises.
        self.role = ROLE_BOTH
        # Capacity gossip (duty / burn_5m / draining / hot keys), learned
        # the same way; {} until the peer reports, and decayed back to {}
        # (= neutral weight) after LUMEN_FED_CAPACITY_STALE_POLLS silent
        # polls.
        self.capacity: dict = {}
        self.weight = 1.0
        self.missed_capacity = 0
        self._stale_warned = False
        # Incremented lock-free from handler threads: int += is fine for
        # telemetry (same convention as ResultCache.stats) — health
        # decisions never read these, only streak/state, which ARE
        # taken under the manager lock.
        self.stats = {
            "dispatches": 0,
            "failovers": 0,
            "sheds": 0,
            "failures": 0,
            "cache_hits": 0,
            "cache_misses": 0,
        }

    @property
    def stub(self):
        if self._stub is None:
            with self._stub_lock:
                if self._stub is None:
                    self._stub = self._stub_factory(self.spec.addr)
        return self._stub

    def close(self) -> None:
        stub = self._stub
        self._stub = None
        chan = getattr(stub, "_lumen_channel", None)
        if chan is not None:
            try:
                chan.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass


def _default_stub_factory(addr: str):
    from ..serving.proto.ml_service_pb2_grpc import InferenceStub

    channel = grpc.insecure_channel(
        addr,
        options=[
            ("grpc.max_send_message_length", 64 * 1024 * 1024),
            ("grpc.max_receive_message_length", 64 * 1024 * 1024),
        ],
    )
    stub = InferenceStub(channel)
    stub._lumen_channel = channel  # teardown handle (Peer.close)
    return stub


# ---------------------------------------------------------------------------
# Federation manager
# ---------------------------------------------------------------------------


class FederationManager:
    """The fleet view one server holds: the ring, per-peer health, the
    background poller, and the peer-cache lookup client.

    Two roles share this one class:

    - a **front tier** (no local models) uses :meth:`plan` +
      :meth:`record_*` from the routing loop in
      :class:`~lumen_tpu_torch.serving.router.FederationRouter`;
    - a **peer-aware backend** (``LUMEN_FED_SELF`` set) installs
      :meth:`peer_cache_lookup` as the result cache's pre-compute hook so
      its misses consult the ring owner's cache first.
    """

    def __init__(
        self,
        specs: list[PeerSpec],
        self_name: str | None = None,
        stub_factory: Callable[[str], Any] | None = None,
        hops: int | None = None,
        failures: int | None = None,
        eject_s: float | None = None,
        poll_s: float | None = None,
    ):
        if not specs:
            raise ValueError("federation needs at least one peer")
        factory = stub_factory or _default_stub_factory
        self.peers: dict[str, Peer] = {s.name: Peer(s, factory) for s in specs}
        self.self_name = self_name or None
        # A self that matches no listed peer is NOT benign for lookups:
        # the ring still owns arcs under this host's LISTED name, so the
        # `owner == self` guard would fail and every owned-key miss
        # would RPC this host's own address and ride its own unresolved
        # flight until the wait times out (~10s/unique payload). The
        # server only installs the cache hook when `self_listed`.
        self.self_listed = self.self_name in self.peers
        if self.self_name and not self.self_listed:
            logger.warning(
                "%s=%r matches no %s entry %s — peer-cache lookups are "
                "DISABLED on this host (spell self exactly as it appears "
                "in the peer list)",
                SELF_ENV, self.self_name, PEERS_ENV, sorted(self.peers),
            )
        self.ring = HashRing(list(self.peers))
        self.hops = fed_hops() if hops is None else max(1, hops)
        self.failures = fed_failures() if failures is None else max(1, failures)
        self.eject_s = fed_eject_s() if eject_s is None else max(0.1, eject_s)
        self.poll_s = fed_poll_s() if poll_s is None else max(0.1, poll_s)
        self.lookup_timeout_s = fed_lookup_timeout_s()
        self.lookup_wait_ms = fed_lookup_wait_ms()
        self.forward_timeout_s = fed_forward_timeout_s()
        self.kv_timeout_s = fed_kv_timeout_s()
        self._kv_lanes = threading.BoundedSemaphore(fed_kv_lanes())
        self._role_warned = False
        if self.self_listed:
            # Our own lane comes from the env, not from probing ourselves
            # (the poll loop skips self on purpose).
            self.peers[self.self_name].role = fed_role()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Capacity-weighted ring state. Latched at build like the other
        # knobs: with the gossip knob unset nothing below ever runs and
        # the ring stays the equal-weight one built above.
        self._capacity_on = capacity_gossip_enabled()
        self.capacity_hyst = fed_capacity_hyst()
        self.capacity_remap_s = fed_capacity_remap_s()
        self.capacity_stale_polls = fed_capacity_stale_polls()
        self._last_remap = -float("inf")
        # Shares are cached per ring BUILD (weight changes rebuild), so
        # the gauges below read live ownership, not the boot snapshot.
        self._shares = self.ring.shares()
        ref = weakref.ref(self)
        for name, peer in self.peers.items():

            def _gauges(p=peer, name=name) -> dict:
                m = ref()
                if m is None:
                    return {}
                out = {
                    **p.stats,
                    "state": _STATE_CODES[p.state],
                    "streak": p.streak,
                    "ring_share": round(m._shares.get(name, 0.0), 4),
                    "fed_role": _ROLE_CODES.get(p.role, 0),
                }
                if m._capacity_on:
                    out["weight"] = round(p.weight, 4)
                    out["draining"] = 1 if p.capacity.get("draining") else 0
                return out

            peer._gauge_fn = _gauges
            metrics.register_gauges(f"federation:{name}", _gauges)

    # -- routing -----------------------------------------------------------

    def _ejected_names(self) -> set[str]:
        with self._lock:
            return {n for n, p in self.peers.items() if p.state == EJECTED}

    def plan(self, digest_hex: str) -> list[Peer]:
        """Forward attempts for one content address, in preference order:
        live ring owner first, then live successors, up to the hop
        budget. With every peer ejected the raw owner order is returned
        anyway — trying a possibly-dead peer beats refusing outright (it
        doubles as the dispatch-path probe)."""
        ejected = self._ejected_names()
        names = self.ring.owners(digest_hex, self.hops, skip=ejected)
        if not names:
            names = self.ring.owners(digest_hex, self.hops)
        return [self.peers[n] for n in names]

    def owner_of(self, digest_hex: str) -> Peer | None:
        name = self.ring.owner(digest_hex, skip=self._ejected_names())
        return self.peers.get(name) if name else None

    def disagg_plan(
        self, task: str, plan: list[Peer]
    ) -> tuple[list[Peer], str | None]:
        """Role-aware rewrite of a forward plan. For generation tasks in
        a fleet with configured lanes: prefill-capable peers lead (the
        forward target runs vision encode + prefill) and the first
        decode-capable peer in RING ORDER is named the row's decode OWNER
        — the prefill host migrates the row's KV there after prefill.
        Identity ``(plan, None)`` whenever roles are unconfigured, the
        task has no phase boundary, only one peer is live, or a lane is
        missing entirely (unservable — warned once, routing stays
        role-blind rather than refusing). Owner is also None when the
        chosen forward peer IS the owner: colocated, no migration."""
        if task not in DISAGG_TASKS or len(plan) < 2:
            return plan, None
        roles = {p.name: p.role for p in plan}
        if all(r == ROLE_BOTH for r in roles.values()):
            return plan, None
        prefill = [p for p in plan if roles[p.name] != ROLE_DECODE]
        decode = [p for p in plan if roles[p.name] != ROLE_PREFILL]
        if not prefill or not decode:
            self._warn_unservable()
            return plan, None
        ordered = prefill + [p for p in plan if roles[p.name] == ROLE_DECODE]
        owner = decode[0].name
        if ordered[0].name == owner:
            return ordered, None
        return ordered, owner

    # -- health accounting (breaker semantics one level up) ----------------

    def record_dispatch(self, peer: Peer, failover: bool = False) -> None:
        peer.stats["dispatches"] += 1
        metrics.count("fed_dispatches")
        if failover:
            peer.stats["failovers"] += 1
            metrics.count("fed_failovers")

    def record_success(self, peer: Peer) -> None:
        with self._lock:
            peer.streak = 0
            peer.last_ok = time.monotonic()
            readmitted = peer.state == EJECTED
            if readmitted:
                peer.state = SERVING
        if readmitted:
            self._announce_readmit(peer, "dispatch succeeded")

    def record_shed(self, peer: Peer) -> None:
        """An in-band UNAVAILABLE answer (quota/queue/breaker/drain shed):
        the peer is ALIVE and talking — overload is not a health verdict
        (the same neutrality rule the service breaker applies), so the
        streak is untouched; the request just spills to a successor."""
        peer.stats["sheds"] += 1
        metrics.count("fed_sheds")

    def record_unreachable(self, peer: Peer, exc: BaseException, what: str) -> bool:
        """The ONE filter between an RPC exception and the ejection
        streak, shared by every dispatch surface (forward, caps, cache
        lookup): only a transport-unreachable verdict (UNAVAILABLE, or a
        non-gRPC error from a broken stub) counts. DEADLINE_EXCEEDED and
        CANCELLED describe the CALLER's budget or patience — ejecting a
        busy healthy peer for them is the one thing peer health must
        never do. Returns True when the failure was recorded."""
        code = (
            exc.code()
            if isinstance(exc, grpc.RpcError) and callable(getattr(exc, "code", None))
            else None
        )
        if code is None or code == grpc.StatusCode.UNAVAILABLE:
            self.record_failure(peer, f"{what}: {type(exc).__name__}: {code or exc}")
            return True
        return False

    def record_failure(self, peer: Peer, reason: str) -> None:
        """A transport-level forward/poll failure — the peer may be gone.
        ``LUMEN_FED_FAILURES`` consecutive ones eject it from the ring."""
        peer.stats["failures"] += 1
        peer.last_error = reason[:200]
        with self._lock:
            peer.streak += 1
            eject = peer.state == SERVING and peer.streak >= self.failures
            if eject:
                peer.state = EJECTED
                peer.ejected_at = time.monotonic()
        if eject:
            metrics.count("fed_peer_down")
            logger.error(
                "federation peer %s EJECTED after %d consecutive failures "
                "(%s); ring segment spills to successors, probe in %.1fs",
                peer.name, peer.streak, reason, self.eject_s,
            )
            # Incident-grade: fed_peer_down is in telemetry.INCIDENT_KINDS,
            # so this captures a flight-recorder bundle (events + traces +
            # device memory) exactly like a breaker-open or replica-down.
            telemetry.record_event(
                "fed_peer_down", peer.name,
                f"peer ejected after {self.failures} consecutive failures: "
                f"{reason}",
                streak=peer.streak,
            )

    def _announce_readmit(self, peer: Peer, how: str) -> None:
        metrics.count("fed_peer_readmits")
        logger.info("federation peer %s readmitted (%s)", peer.name, how)
        telemetry.record_event(
            "fed_peer_readmit", peer.name, f"peer readmitted: {how}"
        )

    # -- disaggregation role coverage --------------------------------------

    def _check_role_coverage(self) -> None:
        """An all-prefill or all-decode fleet can never FINISH a
        generation (no decode lane to own rows / no prefill lane to admit
        prompts). Roles are advisory — routing silently falls back to
        role-blind order — but a misconfigured fleet must say so LOUDLY,
        once, instead of quietly serving degraded forever."""
        roles = [p.role for p in self.peers.values()]
        if all(r == ROLE_BOTH for r in roles):
            return
        has_prefill = any(r in (ROLE_PREFILL, ROLE_BOTH) for r in roles)
        has_decode = any(r in (ROLE_DECODE, ROLE_BOTH) for r in roles)
        if not (has_prefill and has_decode):
            self._warn_unservable()

    def _warn_unservable(self) -> None:
        if self._role_warned:
            return
        self._role_warned = True
        roles = {n: p.role for n, p in sorted(self.peers.items())}
        missing = ROLE_DECODE if ROLE_PREFILL in roles.values() else ROLE_PREFILL
        logger.error(
            "federation role set is UNSERVABLE: %s — no %s-capable peer; "
            "role-aware routing is DISABLED (every peer treated as 'both') "
            "until %s on at least one host provides the missing lane",
            roles, missing, ROLE_ENV,
        )
        telemetry.record_event(
            "fed_roles_unservable", "federation",
            f"no {missing}-capable peer among {sorted(roles)}; "
            "role routing disabled, serving role-blind",
        )

    # -- KV page migration (disaggregated prefill/decode) ------------------

    def kv_migrate(self, scheduler, req, rec, manifest: list, target: str) -> None:
        """Migration dispatcher — installed as ``ContinuousScheduler.
        migrator`` on peer-aware backends. Validates the target and the
        lane budget SYNCHRONOUSLY (raising hands the row straight back to
        the scheduler's local degradation ladder, nothing half-done),
        then runs the wire legs on a short-lived daemon thread so the
        scheduler loop never blocks on the network."""
        peer = self.peers.get(target)
        if peer is None:
            raise RuntimeError(f"migration target {target!r} is not a peer")
        if self.self_listed and target == self.self_name:
            raise RuntimeError("migration target is this host (colocated row)")
        with self._lock:
            state = peer.state
        if state == EJECTED:
            raise RuntimeError(f"migration target {target} is ejected")
        if not self._kv_lanes.acquire(blocking=False):
            note_migration(lane_busy=1)
            metrics.count("fed_kv_lane_busy")
            raise RuntimeError("all KV migration lanes are in flight")
        threading.Thread(
            target=self._kv_migrate_run,
            args=(scheduler, req, rec, list(manifest), peer),
            name="fed-kv-migrate",
            daemon=True,
        ).start()

    def _kv_migrate_run(self, scheduler, req, rec, manifest, peer) -> None:
        ok = False
        try:
            ok = self._kv_migrate_legs(scheduler, req, rec, manifest, peer)
        except Exception as e:  # noqa: BLE001 - any crash -> the local ladder
            logger.warning(
                "KV migration to %s died (%s: %s); resuming locally",
                peer.name, type(e).__name__, e,
            )
        finally:
            self._kv_lanes.release()
        if not ok:
            note_migration(put_failures=1)
            metrics.count("fed_kv_put_failures")
            # rec.arrays still holds the full pre-slice snapshot
            # (slice_pages copies the list), so the local resume replays
            # the exact state the wire failed to deliver.
            scheduler.resubmit_spilled(req, rec)

    def _kv_migrate_legs(self, scheduler, req, rec, manifest, peer) -> bool:
        tr = getattr(req, "trace", None)
        span = (
            tr.begin("fed.kv_migrate", {"peer": peer.name, "pages": str(rec.n_pages)})
            if tr is not None
            else None
        )
        h = self._kv_offer(peer, manifest, rec) if manifest else 0
        status = self._kv_commit(scheduler, req, rec, manifest, peer, h)
        if status == "chunks_missing" and h > 0 and not getattr(req, "delivered", 0):
            # Offer/commit race: the promised prefix chunks were evicted
            # between the legs. One retry shipping full page contents —
            # safe only while no token has streamed to the client.
            status = self._kv_commit(scheduler, req, rec, manifest, peer, 0)
        if span is not None:
            span.end(ok="1" if status == "done" else "0", ref_pages=str(h))
        return status == "done"

    def _kv_offer(self, peer: Peer, manifest: list, rec) -> int:
        """Offer leg: ship the prompt's chain-key manifest, learn how
        many LEADING pages the decode host's prefix cache already holds —
        those migrate as references, only the missed suffix rides the
        commit. Advisory and best-effort: any failure means "ship
        everything" (0), never a migration failure."""
        from ..models.vlm import migration
        from ..serving.proto import ml_service_pb2 as pb

        try:
            resps = list(peer.stub.Infer(iter([pb.InferRequest(
                correlation_id="fedkv-offer",
                task=FED_KV_PUT_TASK,
                meta={"op": "offer", "manifest": migration.manifest_csv(manifest)},
            )]), timeout=self.lookup_timeout_s))
        except Exception as e:  # noqa: BLE001 - a failed offer ships bytes
            self.record_unreachable(peer, e, "kv offer")
            return 0
        last = resps[-1] if resps else None
        if last is None or last.HasField("error") or last.meta.get("fed_kv") != "ok":
            return 0
        try:
            hit = int(last.meta.get("hit", "0"))
        except ValueError:
            return 0
        # At least one page must ride the wire (the row's live tail page
        # is never content-addressable), and never claim more than the
        # manifest covers.
        return max(0, min(hit, rec.n_pages - 1, len(manifest)))

    def _kv_commit(self, scheduler, req, rec, manifest, peer: Peer, h: int) -> str:
        """Commit leg: slice off the ``h`` offered pages, pack the rest +
        decode state into chunked bundle frames, stream the decode host's
        tokens back into the request, and retire it on the done frame.
        Returns ``"done"``, ``"chunks_missing"`` (retryable offer race),
        or ``"failed"`` (caller falls back to the local ladder)."""
        import numpy as np
        import torch

        # Lazy: the scheduler exists, so the engine module is loaded —
        # a front tier never imports the engine for this.
        from ..models.vlm import continuous, migration
        from ..serving.proto import ml_service_pb2 as pb

        n_page_leaves = len(rec.arrays) - 1  # [per-layer page stacks..., seen]
        leaves = migration.slice_pages(
            rec.arrays, n_page_leaves, h, stop=rec.n_pages
        )
        # The JAX record's PRNG-key leaf, drawn at export (module docstring).
        leaves.append(np.ascontiguousarray(rec.rng))
        leaves.append(np.ascontiguousarray(
            torch.as_tensor(req.prompt_ids).cpu().numpy().astype(np.int32)
        ))
        blob, crc = migration.pack_payload(leaves)
        meta = migration.commit_meta(
            crc=crc,
            n_page_leaves=n_page_leaves,
            n_pages=rec.n_pages,
            n_shared=h,
            page_size=scheduler.page_size,
            cur_tok=rec.cur_tok,
            cur_len=rec.cur_len,
            n_gen=rec.n_gen,
            prompt_len=rec.prompt_len,
            max_new=int(req.max_new),
            temperature=req.temperature,
            top_p=req.top_p,
            do_sample=req.do_sample,
            repetition_penalty=req.repetition_penalty,
            manifest=manifest,
        )
        from ..utils.tensorwire import BUNDLE_MIME

        n_chunks = max(1, -(-len(blob) // _KV_CHUNK_BYTES))
        msgs = []
        for i in range(n_chunks):
            part = blob[i * _KV_CHUNK_BYTES : (i + 1) * _KV_CHUNK_BYTES]
            msgs.append(pb.InferRequest(
                correlation_id="fedkv-commit",
                task=FED_KV_PUT_TASK,
                payload=part,
                payload_mime=BUNDLE_MIME if i == 0 else "",
                meta=meta if i == 0 else None,
                seq=i,
                total=n_chunks,
            ))
        tokens: list[int] = []
        done = None
        try:
            for resp in peer.stub.Infer(iter(msgs), timeout=self.kv_timeout_s):
                if resp.HasField("error"):
                    if resp.meta.get("fed_kv") == "chunks_missing":
                        return "chunks_missing"
                    if resp.error.code == pb.ERROR_CODE_UNAVAILABLE:
                        self.record_shed(peer)  # alive but refusing: neutral
                    logger.warning(
                        "fed_kv_put to %s refused: %s",
                        peer.name, resp.error.message,
                    )
                    return "failed"
                kind = resp.meta.get("fed_kv", "")
                if kind == "tok":
                    for part in resp.meta.get("toks", "").split(","):
                        if not part:
                            continue
                        tok = int(part)
                        tokens.append(tok)
                        if req.stream_q is not None:
                            # Relay live so the CLIENT's stream keeps
                            # flowing during remote decode; delivered
                            # tracks it so a mid-stream peer death never
                            # double-delivers on the local fallback.
                            req.stream_q.put(tok)
                            req.delivered += 1
                elif kind == "done":
                    done = resp
                    break
        except Exception as e:  # noqa: BLE001 - transport death mid-stream
            self.record_unreachable(peer, e, "kv commit")
            logger.warning(
                "fed_kv_put commit to %s died mid-stream after %d token(s): %s",
                peer.name, len(tokens), e,
            )
            return "failed"
        if done is None:
            return "failed"
        eos = done.meta.get("eos") == "1"
        note_migration(puts=1, put_bytes=len(blob), ref_pages=h)
        metrics.count("fed_kv_puts")
        metrics.count("fed_kv_put_bytes", len(blob))
        self.record_success(peer)
        continuous._retire(req, tokens, eos)
        return "done"

    # -- background health poll --------------------------------------------

    def start(self) -> None:
        """Start the one poll thread (idempotent). Never called on the
        single-host path — :func:`maybe_federation` returns None before
        any thread exists."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._poll_loop, name="fed-poll", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None
        for peer in self.peers.values():
            metrics.unregister_gauges(f"federation:{peer.name}", peer._gauge_fn)
            peer.close()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            for peer in list(self.peers.values()):
                if self._stop.is_set():
                    return
                if peer.name == self.self_name:
                    continue
                with self._lock:
                    ejected = peer.state == EJECTED
                    waiting = ejected and (
                        time.monotonic() - peer.ejected_at < self.eject_s
                    )
                if waiting:
                    continue  # still inside the eject window: no probe yet
                self._probe(peer, ejected)
            self._check_role_coverage()
            self._maybe_reweight()

    def _probe(self, peer: Peer, ejected: bool) -> None:
        try:
            stub = peer.stub
            call = stub.Health.with_call(empty_pb2.Empty(), timeout=2.0)
        except AttributeError:
            # Test stubs without with_call: plain Health is probe enough.
            try:
                peer.stub.Health(empty_pb2.Empty(), timeout=2.0)
                call = None
            except Exception as e:  # noqa: BLE001 - probe failure is the signal
                self.record_failure(peer, f"health probe: {type(e).__name__}: {e}")
                self._note_capacity(peer, None)
                return
        except Exception as e:  # noqa: BLE001 - probe failure is the signal
            self.record_failure(peer, f"health probe: {type(e).__name__}: {e}")
            self._note_capacity(peer, None)
            return
        cap_seen = None
        if call is not None:
            try:
                # SLO burn + service status ride Health trailing metadata;
                # stash them so /peers answers "how is that host doing"
                # without another hop.
                trailing = call[1].trailing_metadata() or ()
                role_seen = None
                for item in trailing:
                    if item.key == telemetry.SLO_META_KEY:
                        peer.slo = json.loads(item.value)
                    elif item.key == FED_ROLE_META:
                        role = str(item.value)
                        if role in _ROLE_CODES:
                            role_seen = role
                    elif item.key == FED_CAPACITY_META:
                        cap_seen = json.loads(item.value)
                # No trailer = the default lane: a peer restarted WITHOUT
                # the knob must shed its stale role, not keep it forever.
                peer.role = role_seen or ROLE_BOTH
            except Exception:  # noqa: BLE001 - telemetry, never a verdict
                pass
        self._note_capacity(peer, cap_seen)
        with self._lock:
            peer.streak = 0
            peer.last_ok = time.monotonic()
            readmitted = peer.state == EJECTED
            if readmitted:
                peer.state = SERVING
        if readmitted:
            self._announce_readmit(peer, "health probe succeeded")

    # -- capacity gossip -> weighted ring + drain handoff ------------------

    def _note_capacity(self, peer: Peer, cap: dict | None) -> None:
        """Fold one poll's capacity report (or its absence) into the
        peer's state. Does nothing unless this host enables the gossip
        (``LUMEN_FED_CAPACITY=1``) — the unconfigured path keeps the
        boot-time equal-weight ring untouched."""
        if not self._capacity_on:
            return
        if not isinstance(cap, dict):
            peer.missed_capacity += 1
            if (
                peer.capacity
                and peer.missed_capacity >= self.capacity_stale_polls
            ):
                peer.capacity = {}
                metrics.count("fed_gossip_stale")
                if not peer._stale_warned:
                    peer._stale_warned = True
                    logger.warning(
                        "federation peer %s stopped reporting capacity "
                        "(%d silent poll(s)); last report discarded, "
                        "weight decays to neutral",
                        peer.name, peer.missed_capacity,
                    )
                self._maybe_reweight()
            return
        peer.missed_capacity = 0
        peer._stale_warned = False
        was_draining = bool(peer.capacity.get("draining"))
        peer.capacity = cap
        if bool(cap.get("draining")) and not was_draining:
            # A planned drain must never be discovered by failover: zero
            # the weight NOW (bypassing the remap-rate cap) and prefetch
            # the drained arcs' hottest cache entries onto successors.
            self._maybe_reweight(force=True)
            self._drain_handoff(peer)

    def _desired_weight(self, peer: Peer) -> float:
        """Gossip report -> ring weight: headroom (``1 - duty``), halved
        while the peer's error budget burns faster than sustainable,
        floored at :data:`MIN_CAPACITY_WEIGHT` so a busy-but-alive host
        keeps a sliver of the ring. Draining = exactly 0 (no arcs);
        no/stale report = neutral 1.0."""
        cap = peer.capacity
        if not cap:
            return 1.0
        if cap.get("draining"):
            return 0.0
        duty = cap.get("duty")
        try:
            w = 1.0 if duty is None else 1.0 - min(1.0, max(0.0, float(duty)))
        except (TypeError, ValueError):
            w = 1.0
        try:
            if float(cap.get("burn_5m") or 0.0) > 1.0:
                w *= 0.5
        except (TypeError, ValueError):
            pass
        return max(MIN_CAPACITY_WEIGHT, w)

    def _maybe_reweight(self, force: bool = False) -> bool:
        """Rebuild the ring from gossiped capacity — only when some
        weight moved past the hysteresis band, and at most once per
        ``LUMEN_FED_CAPACITY_REMAP_S`` (``force``, used by drain flips,
        bypasses both). Returns True when the ring was rebuilt."""
        if not self._capacity_on:
            return False
        desired = {n: self._desired_weight(p) for n, p in self.peers.items()}
        now = time.monotonic()
        with self._lock:
            current = self.ring.weights
            moved = any(
                abs(w - current.get(n, 1.0)) > self.capacity_hyst
                for n, w in desired.items()
            )
            if not moved and not force:
                return False
            if not force and now - self._last_remap < self.capacity_remap_s:
                return False
            weights = desired
            if all(w <= 0.0 for w in desired.values()):
                # Every peer drained at once: an empty ring refuses all
                # traffic, which is strictly worse — keep the equal-weight
                # ring and let per-request drain sheds steer instead.
                weights = {}
            self.ring = HashRing(list(self.peers), weights=weights)
            self._shares = self.ring.shares()
            self._last_remap = now
            for n, p in self.peers.items():
                p.weight = desired.get(n, 1.0)
        metrics.count("fed_ring_remaps")
        logger.info(
            "federation ring re-weighted from capacity gossip: %s",
            {n: round(w, 2) for n, w in sorted(desired.items())},
        )
        return True

    def _drain_handoff(self, peer: Peer) -> None:
        """Kick the hot-cache prefetch for a peer that just flipped its
        gossiped ``draining`` flag: its advertised hottest result-cache
        keys are fetched over the fed_cache_lookup peer-export path and
        pushed onto their new ring owners, so the handed-off arcs arrive
        warm. Runs on a short-lived daemon thread — the poll loop never
        blocks on N cross-host copies."""
        keys = [
            k for k in (peer.capacity.get("hot") or [])
            if isinstance(k, str)
        ][:FED_HANDOFF_KEYS]
        metrics.count("fed_drain_handoffs")
        telemetry.record_event(
            "fed_drain_handoff", peer.name,
            f"draining peer re-weighted to zero; prefetching {len(keys)} "
            "hot cache key(s) onto ring successors",
            keys=len(keys),
        )
        if keys:
            threading.Thread(
                target=self._drain_handoff_run, args=(peer, keys),
                name="fed-drain-handoff", daemon=True,
            ).start()

    def _drain_handoff_run(self, peer: Peer, keys: list[str]) -> None:
        moved = 0
        for key in keys:
            digest = key.rpartition(":")[2]
            target = None
            for name in self.ring.owners(digest, 2, skip=self._ejected_names()):
                if name not in (peer.name, self.self_name):
                    target = self.peers.get(name)
                    break
            if target is None:
                continue
            blob = self._fetch_blob(peer, key)
            if blob is not None and self._push_blob(target, key, blob):
                moved += 1
        if moved:
            metrics.count("fed_drain_prefetch", moved)
            logger.info(
                "drain handoff from %s: %d/%d hot cache blob(s) "
                "prefetched onto ring successors",
                peer.name, moved, len(keys),
            )

    def _fetch_blob(self, owner: Peer, key: str) -> bytes | None:
        """One raw (un-unpickled) cache export from ``owner`` — the
        drain-handoff fetch leg; the blob is relayed verbatim."""
        from ..serving.proto import ml_service_pb2 as pb

        try:
            req = pb.InferRequest(
                correlation_id="fedcache-handoff",
                task=FED_CACHE_TASK,
                payload=key.encode("utf-8"),
                meta={"wait_ms": "0"},
            )
            resps = list(owner.stub.Infer(iter([req]), timeout=self.lookup_timeout_s))
        except Exception as e:  # noqa: BLE001 - a failed fetch skips the key
            self.record_unreachable(owner, e, "drain handoff fetch")
            return None
        last = resps[-1] if resps else None
        if (
            last is None
            or last.HasField("error")
            or last.meta.get("fed_cache") != "hit"
        ):
            return None
        return b"".join(r.result for r in resps)

    def _push_blob(self, target: Peer, key: str, blob: bytes) -> bool:
        """Drain-handoff store leg: push one exported blob to its new
        ring owner (the ``op=put`` extension of the fed_cache task)."""
        from ..serving.proto import ml_service_pb2 as pb

        try:
            resps = list(target.stub.Infer(iter([pb.InferRequest(
                correlation_id="fedcache-put",
                task=FED_CACHE_TASK,
                payload=blob,
                meta={"op": "put", "key": key},
            )]), timeout=self.lookup_timeout_s))
        except Exception as e:  # noqa: BLE001 - a failed push skips the key
            self.record_unreachable(target, e, "drain handoff put")
            return False
        last = resps[-1] if resps else None
        return bool(
            last is not None
            and not last.HasField("error")
            and last.meta.get("fed_cache") == "stored"
        )

    # -- peer cache lookup (the ResultCache pre-compute hook) --------------

    def peer_cache_lookup(self, key: str, payload: bytes) -> tuple[bool, Any]:
        """Ask the ring owner's cache for ``key`` before computing
        locally. Installed as ``ResultCache.peer_lookup`` on peer-aware
        backends; returns ``(False, None)`` whenever the owner is self,
        ejected, or unreachable — the caller then computes as before."""
        if not self.self_listed:
            # Without a verified self identity the `owner == self` guard
            # below cannot work — a lookup could land on our own address
            # and ride our own unresolved flight. Defense in depth for
            # callers that bypass the server's install gate.
            return False, None
        digest = hashlib.sha256(payload).hexdigest()
        owner = self.owner_of(digest)
        if owner is None or owner.name == self.self_name:
            return False, None
        # The RPC deadline must COVER the owner-side flight wait we are
        # about to request (plus the probe itself), or the call always
        # dies DEADLINE_EXCEEDED before the owner's compute resolves and
        # cross-host coalescing can never engage for slow computes. Still
        # bounded by our own caller's remaining request deadline.
        wait_s = min(self.lookup_wait_ms / 1000.0, FED_CACHE_MAX_WAIT_S)
        timeout = self.lookup_timeout_s + wait_s
        rem = remaining()
        if rem is not None:
            if rem <= 0.01:
                return False, None
            timeout = min(timeout, rem)
        tr = current_trace()
        span = tr.begin("fed.peer_cache", {"peer": owner.name}) if tr else None
        found, value = self._lookup_once(owner, key, timeout)
        if span is not None:
            span.end(hit="1" if found else "0")
        return found, value

    def _lookup_once(self, owner: Peer, key: str, timeout: float) -> tuple[bool, Any]:
        from ..serving.proto import ml_service_pb2 as pb

        try:
            req = pb.InferRequest(
                correlation_id="fedcache",
                task=FED_CACHE_TASK,
                payload=key.encode("utf-8"),
                meta={"wait_ms": str(self.lookup_wait_ms)},
            )
            resps = list(owner.stub.Infer(iter([req]), timeout=timeout))
        except Exception as e:  # noqa: BLE001 - a failed lookup is a miss
            owner.stats["cache_misses"] += 1
            metrics.count("fed_cache_peer_misses")
            # Streak only on transport-unreachable (see record_unreachable):
            # a DEADLINE_EXCEEDED means the peer answered at the TCP level
            # but our own budget ran out (slow flight, caller's deadline).
            self.record_unreachable(owner, e, "cache lookup")
            return False, None
        last = resps[-1] if resps else None
        if (
            last is None
            or last.HasField("error")
            or last.meta.get("fed_cache") != "hit"
        ):
            owner.stats["cache_misses"] += 1
            metrics.count("fed_cache_peer_misses")
            return False, None
        try:
            from .result_cache import peer_loads

            value = peer_loads(b"".join(r.result for r in resps))
        except Exception as e:  # noqa: BLE001 - a torn blob is a miss
            logger.warning("peer cache blob from %s undecodable: %s", owner.name, e)
            owner.stats["cache_misses"] += 1
            metrics.count("fed_cache_peer_misses")
            return False, None
        owner.stats["cache_hits"] += 1
        self.record_success(owner)
        metrics.count("fed_cache_peer_hits")
        return True, value

    # -- status surfaces ----------------------------------------------------

    def health_status(self) -> dict:
        """Compact per-peer state for the ``lumen-fed-status`` Health
        trailing-metadata key."""
        with self._lock:
            states = {n: p.state for n, p in sorted(self.peers.items())}
        return {"self": self.self_name, "peers": states}

    def export_status(self) -> dict:
        """Full per-peer view for ``GET /peers`` and the client ``peers``
        subcommand."""
        now = time.monotonic()
        peers: dict[str, dict] = {}
        hits = misses = 0
        with self._lock:
            shares = dict(self._shares)
            for name, p in sorted(self.peers.items()):
                hits += p.stats["cache_hits"]
                misses += p.stats["cache_misses"]
                peers[name] = {
                    "state": p.state,
                    "streak": p.streak,
                    "fed_role": p.role,
                    **p.stats,
                    "ring_share": round(shares.get(name, 0.0), 4),
                    "sidecar": p.spec.sidecar,
                    "last_ok_s_ago": (
                        round(now - p.last_ok, 1) if p.last_ok else None
                    ),
                    "last_error": p.last_error or None,
                    "slo": p.slo or None,
                }
                if self._capacity_on:
                    # Gossiped capacity columns (the `client peers` view):
                    # absent entirely when the gossip is off, so the
                    # unconfigured payload is unchanged.
                    peers[name].update({
                        "weight": round(p.weight, 4),
                        "duty": p.capacity.get("duty"),
                        "burn_5m": p.capacity.get("burn_5m"),
                        "draining": bool(p.capacity.get("draining")),
                    })
        out = {
            "enabled": True,
            "mode": "peer" if self.self_name else "front",
            "self": self.self_name,
            "role": fed_role(),
            "hops": self.hops,
            "peers": peers,
            "kv_migration": dict(MIGRATION),
            "cache_peer_hit_rate": round(hits / (hits + misses), 4)
            if hits + misses
            else 0.0,
        }
        if self._capacity_on:
            out["capacity_gossip"] = True
        return out


# ---------------------------------------------------------------------------
# Process-wide instance + boot wiring
# ---------------------------------------------------------------------------

_manager: FederationManager | None = None
_manager_lock = threading.Lock()


def get_federation() -> FederationManager | None:
    return _manager


def install_federation(manager: FederationManager | None) -> None:
    global _manager
    with _manager_lock:
        _manager = manager


def export_status() -> dict:
    """Module-level status for the observability sidecar's ``GET /peers``
    (read via ``sys.modules`` so the sidecar never imports this)."""
    m = _manager
    if m is None:
        return {"enabled": False, "peers": {}, "detail": "federation not configured"}
    return m.export_status()


def health_status() -> dict:
    m = _manager
    return m.health_status() if m is not None else {}


def maybe_federation() -> FederationManager | None:
    """Build (and install) the fleet view from the environment, or None.

    Peer sources: the ``LUMEN_FED_PEERS`` comma list, plus (with
    ``LUMEN_FED_DISCOVER=1``) a one-shot mDNS browse for ``_lumen._tcp``
    advertisers on the LAN. With neither configured this returns None
    having done NOTHING — no thread, no gauge, no socket — which is the
    whole single-host overhead story. The resolved peer set is logged
    once. The poll thread starts only when the caller says so
    (``manager.start()``)."""
    import os

    specs = parse_peer_specs()
    if os.environ.get(DISCOVER_ENV) == "1":
        from ..serving.mdns import discover_peers

        known = {s.addr for s in specs}
        discovered = [a for a in discover_peers() if a not in known]
        if discovered:
            # Trust posture, stated where the decision lands: mDNS is
            # unauthenticated and the peer protocol (insecure gRPC +
            # pickled cache blobs) assumes fleet-internal trust — any
            # LAN host that advertises _lumen._tcp joins the ring and
            # can answer cache lookups. Only enable discovery on
            # networks where every host is already trusted to serve.
            logger.warning(
                "federation: adding %d UNAUTHENTICATED mDNS-discovered "
                "peer(s) %s — the peer protocol assumes a trusted "
                "network (insecure gRPC, pickled cache payloads); use "
                "%s on untrusted LANs instead",
                len(discovered), discovered, PEERS_ENV,
            )
        for addr in discovered:
            specs.append(PeerSpec(addr=addr))
    if not specs:
        return None
    manager = FederationManager(specs, self_name=os.environ.get(SELF_ENV) or None)
    logger.info(
        "federation: %d peer(s) resolved: %s%s (hops=%d, failures=%d, "
        "eject=%.1fs, poll=%.1fs)",
        len(specs),
        [s.addr for s in specs],
        f"; self={manager.self_name}" if manager.self_name else " (front tier)",
        manager.hops, manager.failures, manager.eject_s, manager.poll_s,
    )
    install_federation(manager)
    return manager
