"""The device trace of a measured window (``--trace 1``).

``torch.profiler`` with CUDA activity only (CUPTI: every kernel, copy and
set on the card, no host operator events, so the trace stays small over a
whole window). From it: the device operations with their intervals, the
busy time as the UNION of those intervals (kernels that overlap on other
streams count once), the kernels by name, and the idle gaps between busy
stretches, each named by the operation it follows.

The profiler starts in set-up, before the callers do: started while
threads were launching kernels, it kept only the first fraction of a
second in two traced windows of six. The window's ends are marked on the
card by a marker kernel each (``torch.cuda._sleep``'s ``spin_kernel``, on
a stream of its own), and the trace keeps the operations between them.
"""

from __future__ import annotations

import functools
from collections import defaultdict
from dataclasses import dataclass, field


#: the marker kernel's name, and the cycles it spins
MARKER, MARKER_CYCLES = "spin_kernel", 1000


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


@dataclass
class DeviceTrace:
    #: ``(name, start_ns, end_ns)`` of every device operation, by start
    ops: list = field(default_factory=list)
    window_s: float = 0.0

    def kernels(self) -> list:
        """The kernel launches: every operation but copies and sets."""
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        total, end = 0, None
        for _, a, b in self.ops:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e9

    def time_of(self, match) -> tuple:
        """``(calls, device seconds)`` of the kernels whose name ``match``
        accepts."""
        n, t = 0, 0
        for name, a, b in self.ops:
            if match(name):
                n += 1
                t += b - a
        return n, t / 1e9

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for name, a, b in self.ops:
            by[short(name)] += b - a
        return [[name, ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The idle time between busy stretches, summed by the operation
        each gap follows, largest first."""
        by = defaultdict(int)
        end, last = None, None
        for name, a, b in self.ops:
            if end is not None and a > end:
                by[f"after {last}"] += a - end
            if end is None or b > end:
                end, last = b, short(name)
        return [[name, ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


@functools.lru_cache(maxsize=None)
def short(name: str, limit: int = 96) -> str:
    """A kernel's name without template arguments and parameter lists."""
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).replace("void ", "").strip() or name
    return s[:limit]


class Tracer:
    """Starts and stops the profiler around a window."""

    def __init__(self):
        import torch

        self._torch = torch
        self._prof = None
        self._t0 = 0.0

    def _profile(self):
        torch = self._torch
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Load CUPTI once, so the profiler starts quickly."""
        torch = self._torch
        with self._profile():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        """Start tracing (in set-up, while no thread launches kernels)."""
        torch = self._torch
        self._side = torch.cuda.Stream()
        torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()

    def mark(self) -> None:
        """Mark an end of the window on the card."""
        torch = self._torch
        with torch.cuda.stream(self._side):
            torch.cuda._sleep(MARKER_CYCLES)

    def stop(self) -> DeviceTrace:
        """Stop tracing; the operations between the two marks."""
        torch = self._torch
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            a = _ns(e, "start")
            ops.append((e.name(), a, a + _ns(e, "duration")))
        self._prof = None
        return window_of(ops)


def window_of(ops: list) -> DeviceTrace:
    """The operations that start between the first two marker kernels,
    each cut at the second, and the time between the marks."""
    marks = sorted((o for o in ops if MARKER in o[0]), key=lambda o: o[1])
    if len(marks) < 2:
        raise RuntimeError(f"the device trace holds {len(marks)} window marks of 2")
    lo, hi = marks[0][2], marks[1][1]
    kept = sorted((n, a, min(b, hi)) for n, a, b in ops if lo <= a < hi and MARKER not in n)
    kept.sort(key=lambda o: o[1])
    return DeviceTrace(ops=kept, window_s=(hi - lo) / 1e9)
