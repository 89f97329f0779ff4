"""RKNN runtime placeholder.

The reference ships Rockchip-NPU (.rknn) execution as a Linux-only
optional backend and keeps a typed stub in every build so configs and
type checkers see the full interface
(``packages/lumen-clip/src/lumen_clip/backends/rknn_backend.py:32-87``).
The port runs on CUDA: configs may *declare* ``runtime: rknn``
(the manifest schema, downloader patterns, and per-device file dicts all
support it, so one config can drive a mixed fleet), but this process
never executes .rknn graphs. The stub documents that contract and turns
an accidental attempt into a clear, typed error instead of a missing-
attribute crash deep in a manager.
"""

from __future__ import annotations


from ..core.config import ModelConfig

_MESSAGE = (
    "runtime 'rknn' is declared for model {model!r} (device {device!r}), but "
    "lumen-tpu-torch executes models with PyTorch on CUDA only.\n"
    "- .rknn graphs run on Rockchip NPUs via rknn-toolkit2; serve them with "
    "the reference's Linux/RKNN build on the edge device.\n"
    "- This config can still be used here: set runtime: jax or torch for the "
    "service(s) this host should serve, and let the edge device consume the "
    "rknn entries (model_info.json carries per-device rknn file dicts "
    "either way).\n"
    "- The downloader DOES understand rknn entries, so it can pre-fetch "
    "edge bundles from this host."
)


class RknnBackend:
    """Typed placeholder mirroring the reference's RKNNBackend shim: the
    constructor raises immediately with the documented guidance."""

    def __init__(self, model_cfg: ModelConfig) -> None:
        raise ImportError(
            _MESSAGE.format(model=model_cfg.model, device=model_cfg.rknn_device)
        )


def require_executable_runtime(model_cfg: ModelConfig) -> None:
    """Gate used by the service ``from_config`` paths: every runtime this
    process can execute passes through; ``rknn`` raises the documented
    error (the reference raises ImportError from its stub constructor —
    same shape here)."""
    if model_cfg.runtime == "rknn":
        raise ImportError(
            _MESSAGE.format(model=model_cfg.model, device=model_cfg.rknn_device)
        )
