"""Serving layer of the port: wire protocol, task registry, routing (the
hub and the federation front tier), circuit breakers and the gRPC server
(the port's copy of ``lumen_tpu/serving``)."""

from .base_service import (
    BaseService,
    DeadlineExceeded,
    InvalidArgument,
    ResourceExhausted,
    ServiceError,
    Unavailable,
    reassemble_result,
)
from .breaker import CircuitBreaker
from .registry import TaskDefinition, TaskRegistry
from .resilience import DegradedService, RecoveryManager
from .router import FederationRouter, HubRouter

__all__ = [
    "BaseService",
    "ServiceError",
    "InvalidArgument",
    "Unavailable",
    "ResourceExhausted",
    "DeadlineExceeded",
    "CircuitBreaker",
    "DegradedService",
    "RecoveryManager",
    "TaskDefinition",
    "TaskRegistry",
    "HubRouter",
    "FederationRouter",
    "reassemble_result",
]
