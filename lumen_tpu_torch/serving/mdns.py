"""Minimal multicast-DNS service advertiser (dependency-free).

LAN discovery parity with the reference, which registers a zeroconf
``_lumen._tcp.local.`` service (``src/lumen/server.py:75-149``). The port's
copy of ``lumen_tpu/serving/mdns.py``: ``zeroconf`` is no dependency, so
this module speaks just enough raw mDNS itself: it answers PTR/SRV/TXT/A queries for the advertised
instance and sends periodic unsolicited announcements.

Environment overrides mirror the reference: ``ADVERTISE_IP`` (skip
autodetection), ``SERVICE_UUID`` (stable instance identity), plus
``SERVICE_STATUS`` / ``SERVICE_VERSION`` merged into TXT properties.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import threading
import time
import uuid

logger = logging.getLogger(__name__)

MDNS_GROUP = "224.0.0.251"
MDNS_PORT = 5353
SERVICE_TYPE = "_lumen._tcp.local."

_TYPE_A, _TYPE_PTR, _TYPE_TXT, _TYPE_SRV, _TYPE_ANY = 1, 12, 16, 33, 255
_CLASS_IN = 1
_CACHE_FLUSH = 0x8001  # class IN with cache-flush bit


def detect_lan_ip() -> str:
    """Best-effort LAN IP via the UDP connect trick (no packets sent)."""
    override = os.environ.get("ADVERTISE_IP")
    if override:
        return override
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def _encode_name(name: str) -> bytes:
    out = b""
    for label in name.rstrip(".").split("."):
        raw = label.encode("utf-8")
        out += struct.pack("!B", len(raw)) + raw
    return out + b"\x00"


def _decode_name(data: bytes, off: int) -> tuple[str, int]:
    """Decode a DNS name honouring compression pointers; returns (name, next_offset)."""
    labels: list[str] = []
    jumped = False
    next_off = off
    hops = 0
    while True:
        if off >= len(data):
            break
        length = data[off]
        if length == 0:
            if not jumped:
                next_off = off + 1
            break
        if length & 0xC0 == 0xC0:  # compression pointer
            if off + 1 >= len(data) or hops > 32:
                break
            ptr = ((length & 0x3F) << 8) | data[off + 1]
            if not jumped:
                next_off = off + 2
                jumped = True
            off = ptr
            hops += 1
            continue
        labels.append(data[off + 1 : off + 1 + length].decode("utf-8", "replace"))
        off += 1 + length
    return ".".join(labels) + ".", next_off


def _record(name: str, rtype: int, rdata: bytes, ttl: int = 120) -> bytes:
    return _encode_name(name) + struct.pack("!HHIH", rtype, _CACHE_FLUSH if rtype != _TYPE_PTR else _CLASS_IN, ttl, len(rdata)) + rdata


class MdnsAdvertiser:
    """Advertise one service instance; run as a daemon thread."""

    def __init__(
        self,
        service_name: str,
        port: int,
        properties: dict[str, str] | None = None,
        ip: str | None = None,
    ):
        self.instance = f"{service_name}-{os.environ.get('SERVICE_UUID', uuid.uuid4().hex[:8])}"
        self.port = port
        self.ip = ip or detect_lan_ip()
        props = dict(properties or {})
        props.setdefault("status", os.environ.get("SERVICE_STATUS", "ready"))
        props.setdefault("version", os.environ.get("SERVICE_VERSION", "0.1.0"))
        self.properties = props
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- names ------------------------------------------------------------

    @property
    def instance_name(self) -> str:
        return f"{self.instance}.{SERVICE_TYPE}"

    @property
    def host_name(self) -> str:
        return f"{self.instance}.local."

    # -- packet building ---------------------------------------------------

    def _txt_rdata(self) -> bytes:
        out = b""
        for k, v in self.properties.items():
            kv = f"{k}={v}".encode("utf-8")[:255]
            out += struct.pack("!B", len(kv)) + kv
        return out or b"\x00"

    def _answers(self) -> list[bytes]:
        srv_rdata = struct.pack("!HHH", 0, 0, self.port) + _encode_name(self.host_name)
        a_rdata = socket.inet_aton(self.ip)
        return [
            _record(SERVICE_TYPE, _TYPE_PTR, _encode_name(self.instance_name)),
            _record(self.instance_name, _TYPE_SRV, srv_rdata),
            _record(self.instance_name, _TYPE_TXT, self._txt_rdata()),
            _record(self.host_name, _TYPE_A, a_rdata),
        ]

    def _response_packet(self) -> bytes:
        answers = self._answers()
        header = struct.pack("!HHHHHH", 0, 0x8400, 0, len(answers), 0, 0)
        return header + b"".join(answers)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_UDP)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind(("", MDNS_PORT))
            mreq = socket.inet_aton(MDNS_GROUP) + socket.inet_aton("0.0.0.0")
            sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        except OSError as e:
            logger.warning("mDNS unavailable (%s); discovery disabled", e)
            sock.close()
            return
        sock.settimeout(1.0)
        self._sock = sock
        self._thread = threading.Thread(target=self._run, name="mdns", daemon=True)
        self._thread.start()
        logger.info("mDNS advertising %s at %s:%d", self.instance_name, self.ip, self.port)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)
        if self._sock:
            try:
                # Goodbye packet: TTL 0 announcement.
                pkt = struct.pack("!HHHHHH", 0, 0x8400, 0, 1, 0, 0) + _record(
                    SERVICE_TYPE, _TYPE_PTR, _encode_name(self.instance_name), ttl=0
                )
                self._sock.sendto(pkt, (MDNS_GROUP, MDNS_PORT))
            except OSError:
                pass
            self._sock.close()
            self._sock = None

    def _run(self) -> None:
        next_announce = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            if now >= next_announce:
                try:
                    self._sock.sendto(self._response_packet(), (MDNS_GROUP, MDNS_PORT))
                except OSError:
                    pass
                next_announce = now + 60.0
            try:
                data, addr = self._sock.recvfrom(4096)
                if self._matches_query(data):
                    self._sock.sendto(self._response_packet(), (MDNS_GROUP, MDNS_PORT))
            except socket.timeout:
                pass
            except OSError:
                break

    def _matches_query(self, data: bytes) -> bool:
        if len(data) < 12:
            return False
        (tid, flags, qdcount, *_rest) = struct.unpack("!HHHHHH", data[:12])
        if flags & 0x8000:  # a response, not a query
            return False
        off = 12
        ours = {SERVICE_TYPE.lower(), self.instance_name.lower(), self.host_name.lower()}
        for _ in range(qdcount):
            try:
                qname, off = _decode_name(data, off)
                off += 4  # qtype + qclass
            except Exception:  # noqa: BLE001 - malformed packet
                return False
            if qname.lower() in ours:
                return True
        return False


def parse_mdns_response(data: bytes) -> list[dict]:
    """Parse one mDNS RESPONSE packet into advertised ``_lumen._tcp``
    instances: ``[{instance, host, ip, port, properties}]``.

    The inverse of :meth:`MdnsAdvertiser._response_packet` (and of any
    zeroconf-compliant advertiser): walk the answer records, join SRV
    (port + target host) with A (host -> IP) and TXT (properties) per
    instance. Records for other service types are ignored. Malformed
    packets return ``[]`` — discovery is best-effort by construction."""
    if len(data) < 12:
        return []
    try:
        _tid, flags, qdcount, ancount, nscount, arcount = struct.unpack(
            "!HHHHHH", data[:12]
        )
    except struct.error:
        return []
    if not flags & 0x8000:  # a query, not a response
        return []
    off = 12
    try:
        for _ in range(qdcount):  # skip the (usually absent) question section
            _q, off = _decode_name(data, off)
            off += 4
        srv: dict[str, tuple[str, int]] = {}  # instance -> (target host, port)
        txt: dict[str, dict[str, str]] = {}
        a_records: dict[str, str] = {}  # host name -> dotted quad
        for _ in range(ancount + nscount + arcount):
            name, off = _decode_name(data, off)
            if off + 10 > len(data):
                break
            rtype, _rclass, _ttl, rdlen = struct.unpack(
                "!HHIH", data[off : off + 10]
            )
            off += 10
            rdata_off, off = off, off + rdlen
            if off > len(data):
                break
            if rtype == _TYPE_SRV and rdlen >= 6:
                _prio, _weight, port = struct.unpack(
                    "!HHH", data[rdata_off : rdata_off + 6]
                )
                target, _ = _decode_name(data, rdata_off + 6)
                srv[name.lower()] = (target.lower(), port)
            elif rtype == _TYPE_A and rdlen == 4:
                a_records[name.lower()] = socket.inet_ntoa(
                    data[rdata_off : rdata_off + 4]
                )
            elif rtype == _TYPE_TXT:
                props: dict[str, str] = {}
                p = rdata_off
                while p < rdata_off + rdlen:
                    ln = data[p]
                    kv = data[p + 1 : p + 1 + ln].decode("utf-8", "replace")
                    p += 1 + ln
                    if "=" in kv:
                        k, _, v = kv.partition("=")
                        props[k] = v
                txt[name.lower()] = props
    except Exception:  # noqa: BLE001 - malformed packet: nothing discovered
        return []
    out = []
    for instance, (target, port) in srv.items():
        if not instance.endswith(SERVICE_TYPE.lower()):
            continue
        ip = a_records.get(target)
        if ip is None and a_records:
            # Single-advertiser packets (ours) carry exactly one A record.
            ip = next(iter(a_records.values()))
        if ip is None:
            continue
        out.append({
            "instance": instance[: -len(SERVICE_TYPE) - 1] or instance,
            "host": target,
            "ip": ip,
            "port": port,
            "properties": txt.get(instance, {}),
        })
    return out


class MdnsBrowser:
    """One-shot LAN browse for ``_lumen._tcp`` advertisers — the matching
    half of :class:`MdnsAdvertiser` (which only answers queries). Used by
    federation peer discovery (``LUMEN_FED_DISCOVER=1``): send one PTR
    query for the service type, collect responses for ``timeout_s``,
    return the parsed instances."""

    def __init__(self, timeout_s: float = 1.5):
        self.timeout_s = timeout_s

    def _query_packet(self) -> bytes:
        header = struct.pack("!HHHHHH", 0, 0, 1, 0, 0, 0)
        question = _encode_name(SERVICE_TYPE) + struct.pack("!HH", _TYPE_PTR, _CLASS_IN)
        return header + question

    def browse(self) -> list[dict]:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_UDP)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        found: dict[tuple[str, int], dict] = {}
        try:
            try:
                sock.bind(("", MDNS_PORT))
                mreq = socket.inet_aton(MDNS_GROUP) + socket.inet_aton("0.0.0.0")
                sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
            except OSError as e:
                logger.warning("mDNS browse unavailable (%s)", e)
                return []
            sock.settimeout(0.25)
            sock.sendto(self._query_packet(), (MDNS_GROUP, MDNS_PORT))
            deadline = time.monotonic() + self.timeout_s
            while time.monotonic() < deadline:
                try:
                    data, _addr = sock.recvfrom(4096)
                except socket.timeout:
                    continue
                except OSError:
                    break
                for rec in parse_mdns_response(data):
                    found[(rec["ip"], rec["port"])] = rec
        finally:
            sock.close()
        return list(found.values())


def discover_peers(timeout_s: float = 1.5) -> list[str]:
    """One-shot federation peer discovery: browse the LAN and return
    ``host:port`` gRPC addresses of advertised lumen servers, sorted for
    deterministic ring membership across hosts that ran the same browse."""
    peers = sorted(f"{r['ip']}:{r['port']}" for r in MdnsBrowser(timeout_s).browse())
    if peers:
        logger.info("mDNS discovery resolved %d peer(s): %s", len(peers), peers)
    else:
        logger.info("mDNS discovery found no lumen advertisers on the LAN")
    return peers
