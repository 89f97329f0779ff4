"""Importable stand-in services for integration tests (the port's copy
of the JAX package's ``testing/services.py``).

The built-in :class:`~lumen_tpu_torch.serving.echo.EchoService` hard-codes its
task names, so a hub config with two echo-backed services would collide on
the route table. :class:`SecondaryEchoService` is the same diagnostic
service under distinct task keys — resilience tests point one config
service at each and fault-inject only one of them.
"""

from __future__ import annotations

import json

from ..core.config import ServiceConfig
from ..serving.base_service import BaseService
from ..serving.registry import TaskDefinition, TaskRegistry
from ..serving.services.search_service import SearchService


class SecondaryEchoService(BaseService):
    """Echo semantics under ``echo2*`` task names (see module docstring)."""

    def __init__(self, service_name: str = "echo2"):
        registry = TaskRegistry(service_name)
        registry.register(
            TaskDefinition(
                name="echo2",
                handler=self._echo,
                description="return the payload unchanged",
                input_mimes=("application/octet-stream", "text/plain"),
                output_mime="application/octet-stream",
            )
        )
        registry.register(
            TaskDefinition(
                name="echo2_meta",
                handler=self._echo_meta,
                description="return request meta as JSON",
                output_mime="application/json",
            )
        )
        super().__init__(registry)

    @classmethod
    def expected_tasks(cls, service_config: ServiceConfig) -> list[str]:  # noqa: ARG003
        return ["echo2", "echo2_meta"]

    @classmethod
    def from_config(cls, service_config: ServiceConfig, cache_dir: str, device=None) -> "SecondaryEchoService":  # noqa: ARG003
        return cls()  # no model, no tensor: the server's device is unused

    def capability(self):
        return self.registry.build_capability(model_ids=["echo2"], runtime="none")

    def _echo(self, payload: bytes, mime: str, meta: dict[str, str]):  # noqa: ARG002
        return payload, mime or "application/octet-stream", {}

    def _echo_meta(self, payload: bytes, mime: str, meta: dict[str, str]):  # noqa: ARG002
        return json.dumps(meta, sort_keys=True).encode(), "application/json", {}


class SlowEchoService(BaseService):
    """Echo with a handler-side sleep (``sleep_s`` request meta, default
    0.3s) — the in-flight work the graceful-drain tests hold open across a
    SIGTERM to prove shutdown completes it instead of dropping it."""

    def __init__(self, service_name: str = "slow"):
        registry = TaskRegistry(service_name)
        registry.register(
            TaskDefinition(
                name="slow_echo",
                handler=self._slow_echo,
                description="sleep sleep_s (meta), then echo",
                input_mimes=("application/octet-stream", "text/plain"),
                output_mime="application/octet-stream",
            )
        )
        super().__init__(registry)

    @classmethod
    def expected_tasks(cls, service_config: ServiceConfig) -> list[str]:  # noqa: ARG003
        return ["slow_echo"]

    @classmethod
    def from_config(cls, service_config: ServiceConfig, cache_dir: str, device=None) -> "SlowEchoService":  # noqa: ARG003
        return cls()  # no model, no tensor: the server's device is unused

    def capability(self):
        return self.registry.build_capability(model_ids=["slow-echo"], runtime="none")

    def _slow_echo(self, payload: bytes, mime: str, meta: dict[str, str]):
        import time

        time.sleep(float(meta.get("sleep_s", "0.3")))
        return payload, mime or "application/octet-stream", {"slow": "1"}


class SearchBenchService(SearchService):
    """The REAL :class:`~lumen_tpu_torch.serving.services.search_service.
    SearchService` with a simulated device cost inside each shard's
    batcher dispatch: ``SEARCHBENCH_ROW_NS`` nanoseconds of sleep per
    corpus row the dispatch sweeps. That is where a chip would spend its
    time — per DISPATCH (coalesced queries share one sweep, like one
    matmul), serialized per shard (one device), proportional to the
    shard's committed rows (exact search is memory-bound on the corpus)
    — for a corpus that is sub-millisecond on CPU. Like
    :class:`FederationBenchService` it SLEEPS instead of spinning, so N
    subprocess hosts on one box scale like N hosts and ``bench.py
    --phase search`` can measure sharded fan-out honestly. Everything
    else (upsert, top-k, merge) is the unmodified ANN path, so the
    recall-vs-oracle segment exercises real code; handler threads only
    park on batcher futures, so a bulk upsert flood contends with
    queries exactly where the real system says it must: at the device,
    where upsert's bounded chunk writes interleave between dispatches."""

    def _batcher(self, tenant: str, shard: str):
        import os
        import time

        import numpy as np

        from ..runtime.ann import ann_k_cap
        from ..runtime.batcher import MicroBatcher

        key = (tenant, shard)
        with self._batcher_lock:
            got = self._batchers.get(key)
            if got is None:
                shard_obj = self.index.shard(tenant, shard)
                try:
                    row_ns = int(os.environ.get("SEARCHBENCH_ROW_NS") or 0)
                except ValueError:
                    row_ns = 0

                def fn(batch, n_valid: int, _s=shard_obj):  # noqa: ARG001
                    if row_ns > 0:
                        time.sleep(_s.count * row_ns / 1e9)
                    return _s.query_raw(np.asarray(batch), ann_k_cap())

                got = MicroBatcher(
                    fn,
                    max_batch=self._batch_size,
                    max_latency_ms=self._max_latency_ms,
                    name=f"search:{tenant}:{shard}",
                ).start()
                self._batchers[key] = got
            return got


class FederationBenchService(BaseService):
    """CPU-only federation backend: a content-addressed "model" whose
    compute is a plain sleep (``device_ms`` request meta, default 20) run
    through the REAL result cache — ``get_or_compute`` with single-flight
    and, on peer-aware boots, the cross-host peer-lookup hook. Every
    actual compute bumps the ``fedbench_device_calls`` counter, so
    ``bench.py --phase federation`` can prove a duplicate payload sent to
    two different fleet entry points cost device work exactly once
    fleet-wide, with no model and no chip. The sleep (not a spin) is what
    lets N subprocess hosts on one box scale like N hosts."""

    def __init__(self, service_name: str = "fedbench"):
        registry = TaskRegistry(service_name)
        registry.register(
            TaskDefinition(
                name="fedbench_embed",
                handler=self._embed,
                description="sleep device_ms per unique payload, return its digest",
                input_mimes=("application/octet-stream",),
                output_mime="application/json",
            )
        )
        super().__init__(registry)

    @classmethod
    def expected_tasks(cls, service_config: ServiceConfig) -> list[str]:  # noqa: ARG003
        return ["fedbench_embed"]

    @classmethod
    def from_config(cls, service_config: ServiceConfig, cache_dir: str, device=None) -> "FederationBenchService":  # noqa: ARG003
        return cls()  # no model, no tensor: the server's device is unused

    def capability(self):
        return self.registry.build_capability(model_ids=["fedbench"], runtime="none")

    def _embed(self, payload: bytes, mime: str, meta: dict[str, str]):  # noqa: ARG002
        import hashlib
        import os
        import time

        from ..runtime.result_cache import get_result_cache, make_namespace
        from ..utils import telemetry as tele
        from ..utils.metrics import metrics

        device_ms = float(meta.get("device_ms", "20"))
        # Per-HOST slowdown (a weak or co-tenanted box). Like device_ms it
        # shapes the simulated compute only, so it stays out of the cache
        # key — and being per-host it cannot ride request meta.
        try:
            device_ms *= float(os.environ.get("FEDBENCH_DEVICE_SCALE") or 1.0)
        except ValueError:
            pass
        try:
            pool = int(os.environ.get("LUMEN_GRPC_WORKERS") or 4)
        except ValueError:
            pool = 4

        def compute() -> dict:
            # The fleet-wide dedupe proof: this counter moving is the
            # ONLY evidence of "device" work, so summing it across hosts
            # counts exact computations per unique payload.
            metrics.count("fedbench_device_calls")
            t0 = time.monotonic()
            time.sleep(device_ms / 1e3)
            # Genuine busy-time accounting against the handler-pool
            # capacity: the host's device_duty is what capacity gossip
            # advertises, so a loaded bench host reports real duty.
            tele.set_capacity("device:fedbench", max(1, pool))
            tele.busy("device:fedbench", t0, time.monotonic())
            return {
                "digest": hashlib.sha256(payload).hexdigest(),
                "n_bytes": len(payload),
            }

        # device_ms deliberately stays OUT of the cache key (options=None):
        # it shapes the simulated compute, not the result.
        out = get_result_cache().get_or_compute(
            make_namespace("fedbench", "fedbench_embed", "fedbench", "0"),
            None,
            payload,
            compute,
        )
        return json.dumps(out).encode(), "application/json", {}
