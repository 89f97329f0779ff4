"""Parallelism of the port (twin of ``lumen_tpu/parallel``): the routed
mixture-of-experts FFN on one device. Sharding rules, sequence, pipeline
and expert-parallel dispatch over ``torch.distributed`` are not ported yet
(ROADMAP queue A)."""

from .moe import MoEParams, init_moe_params, moe_ffn

__all__ = ["MoEParams", "init_moe_params", "moe_ffn"]
