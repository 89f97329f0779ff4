"""KV migration pack/unpack: ONE lease format, two sinks.

The spill tier first packed a preempted row's pages + exact decode state
into an ad-hoc flat byte lease (shapes list + treedef + crc held out of
band). Disaggregated serving needs the SAME bytes to cross a host
boundary, where out-of-band Python objects cannot follow. This module
unifies the two: the payload is a self-describing
:func:`~lumen_tpu.utils.tensorwire.pack_bundle` frame train (per-layer
K/V page stacks in pool flatten order, then the row's ``seen`` vocab
mask) with one crc32 over the whole blob, and the decode scalars travel
as a flat string dict — request meta on the wire, record fields on the
spill ledger. Spill-to-RAM and migrate-to-peer are now one codepath with
two sinks:

- **spill sink** (:meth:`ContinuousScheduler._export_record`): the blob
  lands in the shm arena (or host bytes when the arena denies) and the
  crc gate at resume turns a torn/recycled lease into the degradation
  ladder instead of silent token corruption — exactly the spill tier's contract,
  minus the bespoke layout;
- **wire sink** (``fed_kv_put``): the blob IS the gRPC payload
  (``tensor/bundle`` mime), the scalars ride request meta, and the crc
  rides ``crc`` — the decode host verifies before admitting via
  ``PagedKVPool.admit_exact``/``gen._resume``, zero re-prefill.

Shared-prefix pages migrate as content-hash REFERENCES first: the offer
leg ships the prompt's chain-key manifest (``prefix_cache.chunk_keys``
hex), the decode host answers how many leading pages its own prefix
cache already holds, and only the missed suffix rides the commit leg.

jax-free on purpose: numpy + tensorwire + zlib, importable by the
serving layer and the federation client without dragging in the engine.
"""

from __future__ import annotations

import zlib

import numpy as np

from ...utils.tensorwire import pack_bundle, unpack_bundle

#: wire format version — bumped on any layout change; a mismatch is an
#: INVALID_ARGUMENT on the decode host, never a silent misparse.
MIGRATE_VERSION = "1"


class ChunksMissing(ValueError):
    """Offer/commit race: prefix chunks the offer leg promised were
    evicted before the commit admitted. Retryable — the prefill host
    re-commits with the full page contents (or decodes locally)."""

#: scalar meta fields every commit leg must carry (gen params ride as
#: repr() strings so float round-trips are exact).
_INT_FIELDS = ("cur_tok", "cur_len", "n_gen", "prompt_len", "n_pages",
               "n_shared", "n_page_leaves", "max_new", "page_size")
_FLOAT_FIELDS = ("temperature", "top_p", "repetition_penalty")


def pack_payload(leaves: "list[np.ndarray]") -> tuple[bytes, int]:
    """Serialize record leaves into the one lease blob. Returns
    ``(blob, crc32)`` — both sinks store/ship exactly these bytes."""
    blob = pack_bundle(leaves)
    return blob, zlib.crc32(blob)


def unpack_payload(buf: "bytes | memoryview", crc: "int | None") -> "list[np.ndarray]":
    """Parse a lease blob back into leaves, crc-gated. ``crc=None``
    skips the check (caller already verified); any mismatch or malformed
    frame raises :class:`ValueError` loudly — the degradation ladder's
    entry point, never a silent corruption."""
    if crc is not None and zlib.crc32(buf) != crc:
        raise ValueError(
            "migration payload failed crc verification (torn lease or "
            "corrupt wire frame)"
        )
    return unpack_bundle(buf)


# -- content-hash manifests --------------------------------------------------


def manifest_csv(keys: "list[bytes]") -> str:
    """Chain-key manifest as wire text (comma-joined hex)."""
    return ",".join(k.hex() for k in keys)


def manifest_from_csv(text: str) -> "list[bytes]":
    """Inverse of :func:`manifest_csv`; malformed hex raises ValueError."""
    return [bytes.fromhex(part) for part in text.split(",") if part]


# -- wire meta codec ---------------------------------------------------------


def commit_meta(
    *,
    crc: int,
    n_page_leaves: int,
    n_pages: int,
    n_shared: int,
    page_size: int,
    cur_tok: int,
    cur_len: int,
    n_gen: int,
    prompt_len: int,
    max_new: int,
    temperature: float,
    top_p: float,
    do_sample: bool,
    repetition_penalty: float,
    manifest: "list[bytes]",
) -> dict:
    """Request meta for the commit leg: every scalar the decode host
    needs to rebuild the row, as strings (the gRPC meta map)."""
    meta = {
        "op": "commit",
        "ver": MIGRATE_VERSION,
        "crc": str(crc),
        "n_page_leaves": str(n_page_leaves),
        "n_pages": str(n_pages),
        "n_shared": str(n_shared),
        "page_size": str(page_size),
        "cur_tok": str(cur_tok),
        "cur_len": str(cur_len),
        "n_gen": str(n_gen),
        "prompt_len": str(prompt_len),
        "max_new": str(max_new),
        "temperature": repr(float(temperature)),
        "top_p": repr(float(top_p)),
        "do_sample": "1" if do_sample else "0",
        "repetition_penalty": repr(float(repetition_penalty)),
    }
    if manifest:
        meta["manifest"] = manifest_csv(manifest)
    return meta


def parse_commit_meta(meta) -> dict:
    """Validate + type the commit leg's meta. Raises :class:`ValueError`
    naming the exact field on any malformation (the decode host answers
    INVALID_ARGUMENT with the message verbatim)."""
    if meta.get("ver") != MIGRATE_VERSION:
        raise ValueError(
            f"fed_kv_put version {meta.get('ver')!r} unsupported "
            f"(this host speaks {MIGRATE_VERSION!r})"
        )
    out: dict = {}
    for key in _INT_FIELDS + ("crc",):
        raw = meta.get(key)
        if raw is None:
            raise ValueError(f"fed_kv_put commit missing meta key {key!r}")
        try:
            out[key] = int(raw)
        except ValueError:
            raise ValueError(
                f"fed_kv_put meta {key!r} must be an integer; got {raw!r}"
            ) from None
    for key in _FLOAT_FIELDS:
        raw = meta.get(key)
        if raw is None:
            raise ValueError(f"fed_kv_put commit missing meta key {key!r}")
        try:
            out[key] = float(raw)
        except ValueError:
            raise ValueError(
                f"fed_kv_put meta {key!r} must be a float; got {raw!r}"
            ) from None
    out["do_sample"] = meta.get("do_sample") == "1"
    try:
        out["manifest"] = manifest_from_csv(meta.get("manifest", ""))
    except ValueError:
        raise ValueError("fed_kv_put meta 'manifest' is not valid hex") from None
    if out["n_pages"] < 1:
        raise ValueError(f"fed_kv_put n_pages must be >= 1; got {out['n_pages']}")
    if not 0 <= out["n_shared"] < out["n_pages"]:
        raise ValueError(
            f"fed_kv_put n_shared {out['n_shared']} outside "
            f"[0, {out['n_pages']}) — at least one page must ride the wire"
        )
    if len(out["manifest"]) < out["n_shared"]:
        raise ValueError(
            f"fed_kv_put n_shared {out['n_shared']} exceeds the "
            f"{len(out['manifest'])}-key manifest"
        )
    return out


# -- page-stack helpers ------------------------------------------------------


def slice_pages(
    leaves: "list[np.ndarray]", n_page_leaves: int, skip: int,
    stop: "int | None" = None,
) -> "list[np.ndarray]":
    """Drop the first ``skip`` pages from every page leaf (the offer leg
    said the decode host already holds them) and everything past
    ``stop`` — the export gather pads page leaves up to a power of two
    for its compiled shape, and those pad rows are dump-page garbage
    that must never ride the wire (the decode host refuses a commit
    whose leaves disagree with the declared page count). Non-page
    trailing leaves pass through untouched."""
    if skip <= 0 and stop is None:
        return list(leaves)
    window = slice(max(0, skip), stop)
    return [
        leaf[window] if i < n_page_leaves else leaf
        for i, leaf in enumerate(leaves)
    ]


def pad_pages(
    leaves: "list[np.ndarray]", n_page_leaves: int, n_pad: int
) -> "list[np.ndarray]":
    """Zero-pad every page leaf's page dim up to ``n_pad`` (the resume
    scatter's power-of-2 compiled shape; padded rows target the dump
    page and are never read back)."""
    out: list[np.ndarray] = []
    for i, leaf in enumerate(leaves):
        if i < n_page_leaves and leaf.shape[0] < n_pad:
            pad = np.zeros((n_pad - leaf.shape[0],) + leaf.shape[1:], leaf.dtype)
            leaf = np.concatenate([np.asarray(leaf), pad], axis=0)
        out.append(leaf)
    return out
