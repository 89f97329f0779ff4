"""The ``tensor/raw`` wire format: pre-decoded tensors on the Infer payload.

The device does ~9k img/s/chip while gRPC c10 delivers tens of rps — and
the duty meters say the gap is host JPEG decode plus per-item Python
serialization (ROADMAP item 2). For fleet-internal callers and ingest
pipelines that ALREADY hold decoded pixels, re-encoding to JPEG so the
server can decode it again is pure waste. This module defines the
protocol that skips it, **with no proto change**:

- ``payload`` carries the tensor's raw C-contiguous bytes;
- ``payload_mime`` is ``tensor/raw``;
- two request-meta keys describe the buffer: ``dtype`` (numpy name,
  e.g. ``uint8``) and ``shape`` (``224x224x3``);
- each task that accepts tensors advertises its input spec in the
  capability ``extra`` map under ``tensor_input:<task>`` (e.g.
  ``uint8:224x224x3``, ``*`` = any extent), so a caller can validate
  before sending a byte.

Server-side the payload is materialized with one ``np.frombuffer`` —
no decode pool, no pickle, no copy. Client-side the tensor is
serialized through one ``memoryview`` pass (protobuf insists on
``bytes``, so exactly ONE copy happens, at proto construction — the
chunked path slices the memoryview so large tensors still copy once
total, not once per chunk).

Validation (:func:`validate_tensor_meta`) happens in the serving base
class BEFORE the handler: a mismatched dtype/shape/byte-length answers
INVALID_ARGUMENT with a message naming the advertised spec, and never
reaches the batcher, the cache, or the quarantine.

jax-free on purpose: imported by the serving base class and the client.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np

#: ``payload_mime`` value that switches a request onto the tensor path.
TENSOR_MIME = "tensor/raw"
#: ``payload_mime`` value for a length-prefixed MULTI-tensor payload
#: (:func:`pack_bundle` / :func:`unpack_bundle`) — the KV-migration wire
#: format, one self-describing frame per tensor inside one payload.
BUNDLE_MIME = "tensor/bundle"
#: request-meta key: numpy dtype name of the payload buffer.
DTYPE_META = "dtype"
#: request-meta key: ``x``-separated tensor shape (commas also accepted).
SHAPE_META = "shape"
#: capability-extra key prefix advertising a task's tensor input spec.
TENSOR_INPUT_EXTRA = "tensor_input:"


@dataclass(frozen=True)
class TensorSpec:
    """What a task accepts on the tensor path: a dtype and a shape
    template where ``None`` means any extent (wire spelling ``*``)."""

    dtype: str
    shape: tuple[int | None, ...]

    def wire(self) -> str:
        dims = "x".join("*" if d is None else str(d) for d in self.shape)
        return f"{self.dtype}:{dims}"

    @classmethod
    def from_wire(cls, text: str) -> "TensorSpec":
        dtype, _, dims = text.partition(":")
        shape = tuple(
            None if d == "*" else int(d) for d in dims.split("x") if d
        )
        return cls(dtype, shape)


def _parse_shape(text: str) -> tuple[int, ...]:
    parts = [p for p in text.replace(",", "x").split("x") if p.strip()]
    try:
        shape = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(
            f"meta {SHAPE_META!r} must be integers like '224x224x3'; got {text!r}"
        ) from None
    if not shape or any(d <= 0 for d in shape):
        raise ValueError(
            f"meta {SHAPE_META!r} must be positive dims; got {text!r}"
        )
    return shape


def validate_tensor_meta(
    meta: dict[str, str], payload_len: int, spec: TensorSpec
) -> tuple[np.dtype, tuple[int, ...]]:
    """Validate a ``tensor/raw`` request against the task's advertised
    spec. Returns ``(dtype, shape)`` on success; raises :class:`ValueError`
    with a precise, client-actionable message on any mismatch. Runs
    BEFORE the handler — an invalid tensor never touches the batcher."""
    dtype_name = meta.get(DTYPE_META)
    if not dtype_name:
        raise ValueError(
            f"tensor/raw payload requires the {DTYPE_META!r} meta key "
            f"(expected {spec.wire()!r})"
        )
    shape_text = meta.get(SHAPE_META)
    if not shape_text:
        raise ValueError(
            f"tensor/raw payload requires the {SHAPE_META!r} meta key "
            f"(expected {spec.wire()!r})"
        )
    try:
        dtype = np.dtype(dtype_name)
    except TypeError:
        raise ValueError(f"unknown tensor dtype {dtype_name!r}") from None
    if dtype != np.dtype(spec.dtype):
        raise ValueError(
            f"tensor dtype {dtype.name!r} does not match the advertised "
            f"input spec {spec.wire()!r}"
        )
    shape = _parse_shape(shape_text)
    if len(shape) != len(spec.shape) or any(
        want is not None and got != want for got, want in zip(shape, spec.shape)
    ):
        raise ValueError(
            f"tensor shape {'x'.join(map(str, shape))} does not match the "
            f"advertised input spec {spec.wire()!r}"
        )
    # math.prod: arbitrary precision — np.prod would wrap at int64 on
    # attacker-chosen huge dims and could equal a small payload length.
    expect = math.prod(shape) * dtype.itemsize
    if payload_len != expect:
        raise ValueError(
            f"tensor payload is {payload_len} bytes but dtype "
            f"{dtype.name} shape {'x'.join(map(str, shape))} needs {expect}"
        )
    return dtype, shape


def tensor_from_payload(payload: bytes, meta: dict[str, str]) -> np.ndarray:
    """Materialize the validated wire payload: one ``np.frombuffer``, no
    copy (the array is read-only, which every consumer tolerates)."""
    dtype = np.dtype(meta[DTYPE_META])
    shape = _parse_shape(meta[SHAPE_META])
    return np.frombuffer(payload, dtype=dtype).reshape(shape)


def tensor_payload(arr: "np.ndarray") -> tuple[memoryview, dict[str, str]]:
    """Client half: serialize an ndarray into ``(payload, meta)``. The
    payload is a flat byte memoryview over the array's own buffer — the
    single copy happens when protobuf materializes it into the request
    message, not here."""
    arr = np.ascontiguousarray(arr)
    meta = {
        DTYPE_META: arr.dtype.name,
        SHAPE_META: "x".join(str(d) for d in arr.shape),
    }
    return memoryview(arr).cast("B"), meta


# ---------------------------------------------------------------------------
# Multi-tensor bundles (``tensor/bundle``)
# ---------------------------------------------------------------------------
#
# One payload carrying N self-describing tensors, for protocols that move
# a STRUCTURE of arrays in one hop (KV page migration ships per-layer page
# stacks + the seen mask + the RNG key + prompt ids as one frame train).
# Layout, all little-endian:
#
#   magic  b"LTB1"
#   count  uint32
#   then per tensor, a length-prefixed frame:
#     name_len uint8 | dtype name utf-8 | ndim uint8 | dims int64[ndim]
#     | nbytes uint64 | raw C-contiguous bytes
#
# Validation mirrors :func:`validate_tensor_meta`: every reject names the
# tensor index and the exact mismatch, and byte lengths are checked with
# arbitrary-precision ``math.prod`` so attacker-chosen dims cannot wrap.

_BUNDLE_MAGIC = b"LTB1"
#: sanity bounds — a malformed count must fail fast, not allocate.
_BUNDLE_MAX_TENSORS = 4096
_BUNDLE_MAX_NDIM = 16


def _bundle_dtype(name: str) -> np.dtype:
    """Resolve a wire dtype name, reaching for ``ml_dtypes`` lazily so
    bf16 KV pages round-trip on hosts where plain numpy cannot spell
    ``bfloat16`` (``jax.device_get`` of a bf16 pool yields exactly such
    arrays)."""
    try:
        return np.dtype(name)
    except TypeError:
        pass
    try:
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))
    except (ImportError, AttributeError, TypeError):
        raise ValueError(f"tensor bundle: unknown dtype {name!r}") from None


def pack_bundle(arrays: "list[np.ndarray]") -> bytes:
    """Serialize ``arrays`` into one self-describing payload. Arrays are
    made C-contiguous (the one copy non-contiguous inputs pay); dtype
    names must round-trip through :func:`_bundle_dtype`."""
    if len(arrays) > _BUNDLE_MAX_TENSORS:
        raise ValueError(
            f"tensor bundle: {len(arrays)} tensors exceeds the "
            f"{_BUNDLE_MAX_TENSORS} cap"
        )
    parts = [_BUNDLE_MAGIC, struct.pack("<I", len(arrays))]
    for i, arr in enumerate(arrays):
        shape = np.shape(arr)
        # ascontiguousarray promotes 0-d to 1-d; reshape restores the
        # declared rank so scalars round-trip shape-exactly.
        arr = np.ascontiguousarray(arr).reshape(shape)
        name = arr.dtype.name.encode("utf-8")
        if len(name) > 255:
            raise ValueError(f"tensor bundle: tensor #{i} dtype name too long")
        if arr.ndim > _BUNDLE_MAX_NDIM:
            raise ValueError(
                f"tensor bundle: tensor #{i} has {arr.ndim} dims "
                f"(cap {_BUNDLE_MAX_NDIM})"
            )
        parts.append(struct.pack("<B", len(name)))
        parts.append(name)
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        parts.append(struct.pack("<Q", arr.nbytes))
        parts.append(arr.tobytes())
    return b"".join(parts)


def unpack_bundle(buf: "bytes | memoryview") -> "list[np.ndarray]":
    """Parse a :func:`pack_bundle` payload back into arrays (zero-copy
    views over ``buf`` — read-only, like :func:`tensor_from_payload`).
    Raises :class:`ValueError` with a precise, frame-indexed message on
    any malformation; a valid prefix never masks trailing garbage."""
    view = memoryview(buf)
    if len(view) < 8:
        raise ValueError(
            f"tensor bundle: payload is {len(view)} bytes, shorter than "
            "the 8-byte header"
        )
    if bytes(view[:4]) != _BUNDLE_MAGIC:
        raise ValueError(
            f"tensor bundle: bad magic {bytes(view[:4])!r} "
            f"(expected {_BUNDLE_MAGIC!r})"
        )
    (count,) = struct.unpack("<I", view[4:8])
    if count > _BUNDLE_MAX_TENSORS:
        raise ValueError(
            f"tensor bundle: declares {count} tensors, cap is "
            f"{_BUNDLE_MAX_TENSORS}"
        )
    off = 8
    out: list[np.ndarray] = []
    for i in range(count):
        def need(n: int, what: str, _i=i) -> None:
            if off + n > len(view):
                raise ValueError(
                    f"tensor bundle: tensor #{_i} truncated in {what} "
                    f"(need {n} bytes at offset {off}, have {len(view) - off})"
                )

        need(1, "dtype length")
        name_len = view[off]
        off += 1
        need(name_len, "dtype name")
        name = bytes(view[off : off + name_len]).decode("utf-8", "replace")
        off += name_len
        dtype = _bundle_dtype(name)
        need(1, "ndim")
        ndim = view[off]
        off += 1
        if ndim > _BUNDLE_MAX_NDIM:
            raise ValueError(
                f"tensor bundle: tensor #{i} has {ndim} dims "
                f"(cap {_BUNDLE_MAX_NDIM})"
            )
        need(8 * ndim, "dims")
        shape = struct.unpack(f"<{ndim}q", view[off : off + 8 * ndim])
        off += 8 * ndim
        if any(d < 0 for d in shape):
            raise ValueError(
                f"tensor bundle: tensor #{i} has negative dim in "
                f"{'x'.join(map(str, shape))}"
            )
        need(8, "byte length")
        (nbytes,) = struct.unpack("<Q", view[off : off + 8])
        off += 8
        # math.prod: arbitrary precision, same wrap-proofing rationale as
        # validate_tensor_meta.
        expect = math.prod(shape) * dtype.itemsize
        if nbytes != expect:
            raise ValueError(
                f"tensor bundle: tensor #{i} declares {nbytes} bytes but "
                f"dtype {name} shape {'x'.join(map(str, shape))} needs {expect}"
            )
        need(nbytes, "tensor bytes")
        out.append(
            np.frombuffer(view[off : off + nbytes], dtype=dtype).reshape(shape)
        )
        off += nbytes
    if off != len(view):
        raise ValueError(
            f"tensor bundle: {len(view) - off} trailing byte(s) after the "
            f"last declared tensor"
        )
    return out
