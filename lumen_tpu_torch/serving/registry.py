"""Task registry: maps task routing keys to handlers + I/O declarations.

One shared implementation for every service (the reference carries four
near-identical per-package copies of this module, e.g.
``packages/lumen-clip/src/lumen_clip/registry.py:20-133``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..utils.tensorwire import TENSOR_INPUT_EXTRA, TENSOR_MIME, TensorSpec
from .proto import ml_service_pb2 as pb

PROTOCOL_VERSION = "1.0.0"
DEFAULT_MAX_PAYLOAD = 50 * 1024 * 1024  # 50 MB, matching the reference limit

#: handler(payload, payload_mime, meta) -> (result_bytes, result_mime, extra_meta)
TaskHandler = Callable[[bytes, str, dict[str, str]], tuple[bytes, str, dict[str, str]]]


@dataclass(frozen=True)
class TaskDefinition:
    name: str
    handler: TaskHandler
    description: str = ""
    input_mimes: tuple[str, ...] = ("application/octet-stream",)
    output_mime: str = "application/json"
    max_payload_bytes: int = DEFAULT_MAX_PAYLOAD
    metadata: dict[str, str] = field(default_factory=dict)
    #: pre-decoded tensor input this task accepts on the ``tensor/raw``
    #: wire path (None = JPEG/bytes only). Advertised in the capability
    #: ``extra`` map under ``tensor_input:<task>`` and enforced by the
    #: serving base class BEFORE the handler runs.
    tensor_spec: TensorSpec | None = None

    def to_io_task(self) -> pb.IOTask:
        limits = {"max_payload_bytes": str(self.max_payload_bytes)}
        limits.update(self.metadata)
        mimes = list(self.input_mimes)
        if self.tensor_spec is not None and TENSOR_MIME not in mimes:
            mimes.append(TENSOR_MIME)
        return pb.IOTask(
            name=self.name,
            input_mimes=mimes,
            output_mimes=[self.output_mime],
            limits=limits,
        )


class TaskRegistry:
    def __init__(self, service_name: str):
        self.service_name = service_name
        self._tasks: dict[str, TaskDefinition] = {}

    def register(self, task: TaskDefinition) -> None:
        if task.name in self._tasks:
            raise ValueError(f"task {task.name!r} already registered in {self.service_name!r}")
        self._tasks[task.name] = task

    def get(self, name: str) -> TaskDefinition | None:
        return self._tasks.get(name)

    def task_names(self) -> list[str]:
        return sorted(self._tasks)

    def __contains__(self, name: str) -> bool:
        return name in self._tasks

    def __len__(self) -> int:
        return len(self._tasks)

    def build_capability(
        self,
        model_ids: list[str],
        runtime: str,
        max_concurrency: int = 1,
        precisions: list[str] | None = None,
        extra: dict[str, str] | None = None,
    ) -> pb.Capability:
        # Tensor input specs ride the extra map (``tensor_input:<task>``):
        # a fleet-internal caller validates its pre-decoded tensors
        # against these keys instead of probing with a request.
        merged = dict(extra or {})
        for name, task in self._tasks.items():
            if task.tensor_spec is not None:
                merged[f"{TENSOR_INPUT_EXTRA}{name}"] = task.tensor_spec.wire()
        return pb.Capability(
            service_name=self.service_name,
            model_ids=model_ids,
            runtime=runtime,
            max_concurrency=max_concurrency,
            precisions=precisions or [],
            extra=merged,
            tasks=[t.to_io_task() for _, t in sorted(self._tasks.items())],
            protocol_version=PROTOCOL_VERSION,
        )
