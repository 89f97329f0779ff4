"""Runtime core of the port: device mesh and tensor-parallel group, dtype
policy, weight loading, batching, fleets, caches (the names of
``lumen_tpu/runtime/__init__.py``).

Loaded lazily (a module ``__getattr__``): ``native/__init__.py`` imports
``runtime.compile_cache``, and the decode-pool workers that load it must
not import torch. ``data_sharding`` is the twin of the JAX helper: the
mesh's data places, into which a batch's leading dimension splits. The
JAX ``replicated`` has no twin: ``parallel.sharding.replicate`` copies a
model onto each data place of a serving mesh (and places DTensors on a
process mesh)."""

from __future__ import annotations

import importlib

#: each exported name -> the module of this package that defines it
_NAMES = {
    "enable_persistent_cache": "compile_cache",
    **dict.fromkeys(("MicroBatcher", "bucket_for", "default_buckets", "live_batchers"), "batcher"),
    **dict.fromkeys(("DecodePool", "get_decode_pool", "shutdown_decode_pool"), "decode_pool"),
    **dict.fromkeys(("FleetPlan", "ReplicaSet", "build_fleet", "each_batcher", "live_fleets", "plan_replicas",
                     "register_policy", "replicas_for"), "fleet"),
    **dict.fromkeys(("QuarantineRegistry", "get_quarantine", "reset_quarantine"), "quarantine"),
    **dict.fromkeys(("ResultCache", "get_result_cache", "reset_result_cache"), "result_cache"),
    **dict.fromkeys(("DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "build_mesh", "data_sharding", "local_batch_multiple",
                     "resolve_axes"), "mesh"),
    **dict.fromkeys(("Policy", "get_policy"), "policy"),
    **dict.fromkeys(("WeightLoadError", "apply_rules", "assert_tree_shapes", "conv_kernel", "flatten",
                     "linear_kernel", "load_state_dict", "unflatten"), "weights"),
}

__all__ = [
    "enable_persistent_cache",
    "MicroBatcher",
    "bucket_for",
    "default_buckets",
    "live_batchers",
    "live_fleets",
    "DecodePool",
    "get_decode_pool",
    "shutdown_decode_pool",
    "FleetPlan",
    "ReplicaSet",
    "build_fleet",
    "each_batcher",
    "plan_replicas",
    "register_policy",
    "replicas_for",
    "QuarantineRegistry",
    "get_quarantine",
    "reset_quarantine",
    "ResultCache",
    "get_result_cache",
    "reset_result_cache",
    "build_mesh",
    "data_sharding",
    "resolve_axes",
    "local_batch_multiple",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Policy",
    "get_policy",
    "WeightLoadError",
    "load_state_dict",
    "apply_rules",
    "unflatten",
    "flatten",
    "linear_kernel",
    "conv_kernel",
    "assert_tree_shapes",
]


def __getattr__(name: str):
    module = _NAMES.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
