"""Built-in diagnostic echo service.

Lets a deployment smoke-test the full wire path (routing, chunk reassembly,
streaming, capabilities, health) before any model weights exist — point a
config's ``registry_class`` at ``lumen_tpu_torch.serving.echo.EchoService``
(the JAX path ``lumen_tpu.serving.echo.EchoService`` maps onto it too).
"""

from __future__ import annotations

import json

from ..core.config import ServiceConfig
from .base_service import BaseService
from .registry import TaskDefinition, TaskRegistry


class EchoService(BaseService):
    def __init__(self, service_name: str = "echo"):
        registry = TaskRegistry(service_name)
        registry.register(
            TaskDefinition(
                name="echo",
                handler=self._echo,
                description="return the payload unchanged",
                input_mimes=("application/octet-stream", "text/plain"),
                output_mime="application/octet-stream",
            )
        )
        registry.register(
            TaskDefinition(
                name="echo_meta",
                handler=self._echo_meta,
                description="return request meta as JSON",
                output_mime="application/json",
            )
        )
        super().__init__(registry)

    @classmethod
    def expected_tasks(cls, service_config: ServiceConfig) -> list[str]:  # noqa: ARG003
        """Tasks this service would register (degraded-placeholder routes)."""
        return ["echo", "echo_meta"]

    @classmethod
    def from_config(cls, service_config: ServiceConfig, cache_dir: str, device=None) -> "EchoService":  # noqa: ARG003
        """No model and no tensor: ``device`` (the server hands every
        service one) is accepted and unused."""
        return cls()

    def capability(self):
        return self.registry.build_capability(model_ids=["echo"], runtime="none")

    def _echo(self, payload: bytes, mime: str, meta: dict[str, str]):
        return payload, mime or "application/octet-stream", {}

    def _echo_meta(self, payload: bytes, mime: str, meta: dict[str, str]):  # noqa: ARG002
        return json.dumps(meta, sort_keys=True).encode(), "application/json", {}
