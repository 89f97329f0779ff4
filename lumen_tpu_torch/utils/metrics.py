"""Per-task latency histograms and counters.

The reference's only observability is a per-request ``lat_ms`` response
field (SURVEY.md §5 "Tracing/profiling: none"); here every dispatch also
lands in a process-global registry with log-scale latency histograms, so
operators get p50/p90/p99 per task without scraping response metadata.
Snapshots are exported by the serving server's HTTP metrics endpoint
(``lumen_tpu.serving.observability``) in JSON and Prometheus text formats.
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from typing import Callable, Iterator


def _telemetry():
    """Lazy handle on :mod:`lumen_tpu.utils.telemetry` — resolved at
    first use (telemetry imports THIS module at its top level, so the
    reverse edge must not be an import-time one) and cached."""
    global _telemetry_mod
    if _telemetry_mod is None:
        from . import telemetry

        _telemetry_mod = telemetry
    return _telemetry_mod


_telemetry_mod = None


def _default_bounds() -> list[float]:
    """Log-spaced latency bucket upper bounds in ms: 0.1ms .. ~100s."""
    return [0.1 * (10 ** (i / 6)) for i in range(37)]  # x10 every 6 buckets


class LatencyHistogram:
    """Thread-safe fixed-bucket histogram (ms)."""

    def __init__(self, bounds: list[float] | None = None):
        self.bounds = bounds if bounds is not None else _default_bounds()
        self.counts = [0] * (len(self.bounds) + 1)  # +1 overflow bucket
        self.total = 0
        self.sum_ms = 0.0
        self.min_ms = math.inf
        self.max_ms = 0.0
        self._lock = threading.Lock()

    def observe(self, ms: float) -> None:
        idx = bisect_left(self.bounds, ms)
        with self._lock:
            self.counts[idx] += 1
            self.total += 1
            self.sum_ms += ms
            self.min_ms = min(self.min_ms, ms)
            self.max_ms = max(self.max_ms, ms)

    def percentile(self, q: float) -> float:
        """Approximate quantile (bucket upper bound); 0.0 when empty."""
        with self._lock:
            if self.total == 0:
                return 0.0
            rank = q * self.total
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= rank:
                    return self.bounds[i] if i < len(self.bounds) else self.max_ms
            return self.max_ms

    def cumulative(self) -> list[tuple[float, int]]:
        """``(upper_bound_ms, cumulative_count)`` pairs ending with
        ``(inf, total)`` — the Prometheus histogram ``_bucket`` contract
        (cumulative ``le`` buckets), not the internal per-bucket counts."""
        return self.exposition()[0]

    def exposition(self) -> tuple[list[tuple[float, int]], int, float]:
        """``(cumulative_buckets, total, sum_ms)`` from ONE locked read:
        the exposition format requires ``_bucket{le="+Inf"}`` == ``_count``
        within a scrape, so buckets and totals must not come from two
        reads with observes landing in between."""
        with self._lock:
            counts = list(self.counts)
            total = self.total
            sum_ms = self.sum_ms
        out: list[tuple[float, int]] = []
        seen = 0
        for bound, n in zip(self.bounds, counts):
            seen += n
            out.append((bound, seen))
        out.append((math.inf, total))
        return out, total, sum_ms

    def snapshot(self) -> dict:
        with self._lock:
            total, s = self.total, self.sum_ms
            mn = 0.0 if math.isinf(self.min_ms) else self.min_ms
            mx = self.max_ms
        return {
            "count": total,
            "sum_ms": round(s, 3),
            "mean_ms": round(s / total, 3) if total else 0.0,
            "min_ms": round(mn, 3),
            "max_ms": round(mx, 3),
            "p50_ms": round(self.percentile(0.50), 3),
            "p90_ms": round(self.percentile(0.90), 3),
            "p99_ms": round(self.percentile(0.99), 3),
        }


class MetricsRegistry:
    """Task name -> latency histogram + ok/error counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hist: dict[str, LatencyHistogram] = {}
        self._errors: dict[str, int] = {}
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, Callable[[], dict]] = {}
        self._provider_errors_warned: set[str] = set()
        self.started_at = time.time()

    def register_gauges(self, provider: str, fn: Callable[[], dict]) -> None:
        """Attach a named callable returning ``{gauge_name: number}``,
        sampled at snapshot time. Batchers and decode schedulers use this
        to expose live state (queue depth, pool occupancy, padding waste)
        that per-request latency histograms can't show.

        Providers should close over a ``weakref`` to their component (see
        the batcher) — the process-global registry must not be what keeps
        a dropped component's weights alive. Re-registering a name
        replaces the previous provider (last writer wins)."""
        with self._lock:
            self._gauges[provider] = fn

    def unregister_gauges(self, provider: str, fn: Callable | None = None) -> None:
        """Remove a provider. Pass the registered ``fn`` to make removal
        ownership-guarded: if a newer same-name registration replaced
        yours, your close() must not delete the live component's gauges."""
        with self._lock:
            if fn is None or self._gauges.get(provider) is fn:
                self._gauges.pop(provider, None)

    def observe(self, task: str, ms: float) -> None:
        hist = self._hist.get(task)
        if hist is None:
            with self._lock:
                hist = self._hist.setdefault(task, LatencyHistogram())
        hist.observe(ms)
        # Tee into the rolling-window capacity layer: the cumulative
        # histogram above answers "since boot", the ring answers "the
        # last N seconds" (and feeds the SLO burn engine). No-op (one
        # cached env check) under LUMEN_TELEMETRY=0.
        _telemetry().observe(task, ms)

    def count_error(self, task: str) -> None:
        with self._lock:
            self._errors[task] = self._errors.get(task, 0) + 1
        _telemetry().count_error(task)

    def count(self, name: str, n: int = 1) -> None:
        """Bump a named event counter (monotonic). The resilience layer
        records load sheds, deadline drops, retries, and degraded-service
        recoveries here — overload behavior must be observable, not
        inferred from latency percentiles after the fact."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
        _telemetry().count(name, n)

    def counter_value(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            hists = dict(self._hist)
            errors = dict(self._errors)
            counters = dict(self._counters)
            providers = dict(self._gauges)
        tasks = {
            name: {**h.snapshot(), "errors": errors.get(name, 0)}
            for name, h in hists.items()
        }
        # Tasks that only ever failed still belong in the table (a
        # 100%-failing task must not be invisible to consumers).
        empty = LatencyHistogram(bounds=[]).snapshot()
        for name, n in errors.items():
            if name not in tasks:
                tasks[name] = {**empty, "errors": n}
        gauges: dict[str, dict] = {}
        for name, fn in sorted(providers.items()):
            try:
                vals = fn() or {}
            except Exception:  # noqa: BLE001 - metrics must never take down serving
                # One bad provider is skipped, never a 500 for the whole
                # scrape — but silently is how a dashboard goes dark:
                # log it once per provider name and keep a counter so
                # the failure itself is observable.
                self.count("gauge_provider_errors")
                with self._lock:
                    first = name not in self._provider_errors_warned
                    self._provider_errors_warned.add(name)
                if first:
                    import logging

                    logging.getLogger("lumen_tpu_torch.metrics").exception(
                        "gauge provider %r raised; skipping it in this and "
                        "future snapshots until it behaves", name,
                    )
                continue
            vals = {
                k: v for k, v in vals.items()
                # bools pass isinstance(int) but render as True/False,
                # which breaks the whole Prometheus scrape parse
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
            if vals:
                gauges[name] = vals
        out = {
            "uptime_s": round(time.time() - self.started_at, 1),
            "tasks": dict(sorted(tasks.items())),
        }
        if counters:
            out["counters"] = dict(sorted(counters.items()))
        if gauges:
            out["gauges"] = gauges
        return out

    @staticmethod
    def device_memory() -> dict[str, dict[str, int]]:
        """Per-device memory stats of the CUDA caching allocator (params +
        KV pools + live buffers): ``bytes_in_use``, ``peak_bytes_in_use``,
        ``bytes_reserved`` and ``bytes_limit``. Empty when torch was never
        imported or CUDA was never initialized -- metrics must not
        initialize a device from the metrics thread."""
        try:
            import sys

            torch = sys.modules.get("torch")
            if torch is None or not torch.cuda.is_initialized():
                return {}
            out = {}
            for i in range(torch.cuda.device_count()):
                out[str(i)] = {
                    "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                    "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                    "bytes_reserved": int(torch.cuda.memory_reserved(i)),
                    "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
                }
            return out
        except Exception:  # noqa: BLE001 - metrics must never take down serving
            return {}

    @staticmethod
    def _le(bound: float) -> str:
        return "+Inf" if math.isinf(bound) else f"{bound:.6g}"

    def prometheus_lines(self) -> Iterator[str]:
        """Prometheus text exposition of the same data. Latency is a real
        cumulative histogram (``le``-labeled ``_bucket`` series plus
        ``_sum``/``_count``) — scrapeable by an actual Prometheus/Grafana
        stack (``histogram_quantile()`` works server-side), unlike the
        snapshot-only quantile gauges this replaced, which could not be
        aggregated across instances or re-quantiled over time ranges.
        ``/metrics.json`` keeps the p50/p90/p99 snapshot shape."""
        snap = self.snapshot()
        with self._lock:
            hists = dict(self._hist)
        yield "# TYPE lumen_task_requests_total counter"
        for name, s in snap["tasks"].items():
            yield f'lumen_task_requests_total{{task="{name}"}} {s["count"]}'
        yield "# TYPE lumen_task_errors_total counter"
        for name, s in snap["tasks"].items():
            yield f'lumen_task_errors_total{{task="{name}"}} {s["errors"]}'
        yield "# TYPE lumen_task_latency_ms histogram"
        for name, s in snap["tasks"].items():
            hist = hists.get(name)
            if hist is not None:
                # Buckets + sum + count from ONE locked read: an observe
                # landing mid-scrape must not make le="+Inf" disagree
                # with _count (an inconsistent histogram breaks
                # OpenMetrics validation and bucket-based rate math).
                buckets, total, sum_ms = hist.exposition()
                for bound, cum in buckets:
                    yield (
                        f'lumen_task_latency_ms_bucket{{task="{name}",'
                        f'le="{self._le(bound)}"}} {cum}'
                    )
                yield f'lumen_task_latency_ms_sum{{task="{name}"}} {round(sum_ms, 3)}'
                yield f'lumen_task_latency_ms_count{{task="{name}"}} {total}'
            else:
                # Error-only task: no histogram yet, but the series must
                # still be well-formed (a +Inf bucket is mandatory).
                yield f'lumen_task_latency_ms_bucket{{task="{name}",le="+Inf"}} 0'
                yield f'lumen_task_latency_ms_sum{{task="{name}"}} 0.0'
                yield f'lumen_task_latency_ms_count{{task="{name}"}} 0'
        if snap.get("counters"):
            yield "# TYPE lumen_events_total counter"
            for name, val in snap["counters"].items():
                yield f'lumen_events_total{{event="{name}"}} {val}'
        if snap.get("gauges"):
            yield "# TYPE lumen_component_gauge gauge"
            for provider, vals in snap["gauges"].items():
                for key, val in vals.items():
                    yield (
                        f'lumen_component_gauge{{provider="{provider}",'
                        f'name="{key}"}} {val}'
                    )
        mem = self.device_memory()
        if any(mem.values()):
            yield "# TYPE lumen_device_memory_bytes gauge"
            for dev_id, stats in mem.items():
                for key, val in stats.items():
                    yield f'lumen_device_memory_bytes{{device="{dev_id}",kind="{key}"}} {val}'


#: process-global registry used by the serving layer
metrics = MetricsRegistry()
