"""Parent-owned shared-memory slot arena for the process decode pool.

The port's copy of ``lumen_tpu/utils/shm_arena.py``. It holds the
process decode pool's pixel slots (``runtime/decode_pool.py``) and the
continuous engine's KV spill leases.
Segment names carry a process-wide arena serial: two arenas of one name
in one process never collide.

Decoded pixels produced in a worker process reach the parent without a
pickle copy by landing in a ``multiprocessing.shared_memory`` slot the
PARENT allocated: the parent picks a slot, ships its *name* with the
task, the worker attaches and writes, and the parent maps a numpy view
over the same pages. The batcher's collector then stacks straight from
that view — the only pixel copy on the whole hop is the one the
collector was already making into its staging arena.

Design rules (the same ones the batcher's pinned staging arenas follow):

- **Slots are recycled, not churned.** Capacities are power-of-two size
  classes with a per-class free list, so steady-state traffic of one
  image geometry reuses the same few segments forever — zero
  ``shm_open``/``mmap`` on the hot path.
- **The parent owns every lifecycle.** Workers only ever attach; they
  never create or unlink. Whatever a worker does — including dying
  mid-write with SIGKILL — cleanup is one process's job. ``close()``
  unlinks everything, and a ``weakref.finalize`` (which doubles as an
  atexit hook) backstops a dropped or crashed parent so ``/dev/shm``
  never accumulates orphans.
- **Accounting must balance.** ``acquired - released`` is the number of
  live checkouts; at drain it is zero, and the gauges make that an
  assertable invariant rather than a hope.

A soft byte budget (default 256 MiB) bounds arena growth under a
payload flood: past it, ``acquire`` returns ``None`` and the caller
degrades to the pickled spill path (correct, just not zero-copy).
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import weakref
from multiprocessing import shared_memory

logger = logging.getLogger(__name__)

#: smallest slot: one size class covers all thumbnail-ish outputs.
MIN_SLOT_BYTES = 1 << 16

#: process-wide arena serial: two arenas of one name in one process (two
#: engines serving one model, one after the other or side by side) must
#: never name a segment alike.
_ARENA_SERIAL = itertools.count()


class ArenaSlot:
    """One checked-out shared-memory slot. ``name`` is what crosses the
    process boundary; ``view(shape, dtype)`` maps the decoded result."""

    __slots__ = ("name", "capacity", "_shm", "_arena", "_released")

    def __init__(self, arena: "ShmArena", shm: shared_memory.SharedMemory, capacity: int):
        self._arena = arena
        self._shm = shm
        self.name = shm.name
        self.capacity = capacity
        self._released = False

    def view(self, shape, dtype, offset: int = 0):
        """Map ``shape``/``dtype`` over the slot's pages starting at byte
        ``offset`` — several arrays can pack into one lease (the KV spill
        tier lays a whole page export out back to back in one slot)."""
        import numpy as np

        return np.ndarray(
            shape, dtype=np.dtype(dtype), buffer=self._shm.buf, offset=offset
        )

    @property
    def buf(self):
        """The slot's raw buffer (memoryview) — checksum/packing helpers
        read it directly instead of materializing a typed view."""
        return self._shm.buf

    def release(self) -> None:
        """Return the slot to its free list (idempotent — a finally block
        and a safety finalizer may both call it)."""
        if self._released:
            return
        self._released = True
        self._arena._release(self)


class ShmArena:
    def __init__(self, name: str = "decode", max_bytes: int = 256 << 20):
        self.name = name
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._free: dict[int, list[shared_memory.SharedMemory]] = {}
        #: every segment ever created, free or checked out — the one map
        #: cleanup walks. Shared with the finalizer closure, NOT self:
        #: a finalize callback holding self would keep the arena alive.
        self._segments: dict[str, shared_memory.SharedMemory] = {}
        self._bytes = 0
        self._seq = itertools.count()
        self._serial = next(_ARENA_SERIAL)
        self._acquired = 0
        self._released = 0
        self._denied = 0
        self._closed = False
        # weakref.finalize registers an atexit hook too: GC'd arena OR
        # interpreter exit, either way the segments are unlinked exactly
        # once. The shared mutable dict is emptied by close(), so a
        # later finalize run finds nothing left to do.
        self._finalizer = weakref.finalize(self, ShmArena._unlink_all, self._segments)

    @staticmethod
    def _unlink_all(segments: dict[str, shared_memory.SharedMemory]) -> None:
        for seg in list(segments.values()):
            try:
                seg.close()
                seg.unlink()
            except Exception:  # noqa: BLE001 - cleanup keeps going regardless
                pass
        segments.clear()

    @staticmethod
    def _capacity_for(nbytes: int) -> int:
        cap = MIN_SLOT_BYTES
        while cap < nbytes:
            cap <<= 1
        return cap

    def acquire(self, nbytes: int) -> ArenaSlot | None:
        """A slot of at least ``nbytes`` capacity, or ``None`` when the
        arena is closed or the byte budget would be exceeded (caller
        falls back to the non-shm path)."""
        cap = self._capacity_for(max(1, nbytes))
        with self._lock:
            if self._closed:
                return None
            free = self._free.get(cap)
            if free:
                shm = free.pop()
            else:
                if self._bytes + cap > self.max_bytes:
                    self._denied += 1
                    return None
                name = f"lumentorch_{self.name}_{os.getpid()}_{self._serial}_{next(self._seq)}"
                try:
                    shm = shared_memory.SharedMemory(name=name, create=True, size=cap)
                except Exception as e:  # noqa: BLE001 - no /dev/shm, exotic platform
                    logger.warning("shm arena allocation failed (%s); spilling", e)
                    self._denied += 1
                    return None
                self._segments[shm.name] = shm
                self._bytes += cap
            self._acquired += 1
        return ArenaSlot(self, shm, cap)

    def _release(self, slot: ArenaSlot) -> None:
        with self._lock:
            self._released += 1
            if self._closed or slot.name not in self._segments:
                # Closed mid-flight: the finalizer/close already unlinked
                # (or will); do not resurrect the segment into a free list.
                return
            self._free.setdefault(slot.capacity, []).append(slot._shm)

    def live(self) -> int:
        with self._lock:
            return self._acquired - self._released

    def stats(self) -> dict:
        with self._lock:
            return {
                "segments": len(self._segments),
                "bytes": self._bytes,
                "acquired": self._acquired,
                "recycled": self._released,
                "live": self._acquired - self._released,
                "denied": self._denied,
            }

    def close(self) -> None:
        """Unlink every segment now (idempotent). Live views become
        invalid — callers drain before closing, same contract as the
        decode pool's own close."""
        with self._lock:
            self._closed = True
            self._free.clear()
            self._bytes = 0
        self._unlink_all(self._segments)
