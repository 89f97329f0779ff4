"""Serving layer of the port: wire protocol, task registry, routing and the
gRPC server (the port's copy of ``lumen_tpu/serving``; the circuit
breaker and the federation front tier are not ported yet)."""

from .base_service import (
    BaseService,
    DeadlineExceeded,
    InvalidArgument,
    ResourceExhausted,
    ServiceError,
    Unavailable,
    reassemble_result,
)
from .registry import TaskDefinition, TaskRegistry
from .resilience import DegradedService, RecoveryManager
from .router import HubRouter

__all__ = [
    "BaseService",
    "ServiceError",
    "InvalidArgument",
    "Unavailable",
    "ResourceExhausted",
    "DeadlineExceeded",
    "DegradedService",
    "RecoveryManager",
    "TaskDefinition",
    "TaskRegistry",
    "HubRouter",
    "reassemble_result",
]
