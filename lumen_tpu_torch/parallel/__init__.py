"""Parallelism of the port (twin of ``lumen_tpu/parallel``): sharding
rules and DTensor placement, ring and all-to-all sequence parallelism,
pipeline and expert parallelism over ``torch.distributed`` process
groups, and process-group initialization. One process drives one device
(``distributed.initialize``)."""

from .distributed import initialize, is_primary
from .moe import MoEParams, init_moe_params, moe_ffn, moe_sharding
from .pipeline import pipeline_apply, stack_stage_params, stage_sharding
from .ring_attention import ring_attention
from .sharding import (
    INT8_TP_RULES,
    MOE_EP_RULES,
    TRANSFORMER_TP_RULES,
    replicate,
    sanitize_spec,
    shard_params,
    spec_for,
)
from .ulysses import ulysses_attention

__all__ = [
    "initialize",
    "is_primary",
    "ring_attention",
    "ulysses_attention",
    "pipeline_apply",
    "stack_stage_params",
    "stage_sharding",
    "MoEParams",
    "init_moe_params",
    "moe_ffn",
    "moe_sharding",
    "shard_params",
    "replicate",
    "spec_for",
    "sanitize_spec",
    "TRANSFORMER_TP_RULES",
    "INT8_TP_RULES",
    "MOE_EP_RULES",
]
