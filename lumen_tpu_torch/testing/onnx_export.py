"""Export a torch module to an ``.onnx`` file without the ``onnx`` package.

The legacy TorchScript exporter (``torch.onnx.export(..., dynamo=False)``)
imports ``onnx`` only to splice custom onnxscript functions into the
proto; a model with no custom ops needs none of it, so a no-op module
satisfies the import. The same shim as ``tests/test_onnx_bridge.py``'s,
for code that may not import the test suite (``chip_smoke.py``). Used to
write test packs (stand-in face graphs, exported CLIP towers); serving
never exports.
"""

from __future__ import annotations

import importlib.machinery
import sys
import types
import warnings

import torch


def _install_onnx_shim() -> None:
    if "onnx" in sys.modules:
        return
    shim = types.ModuleType("onnx")
    # a real ModuleSpec so later importlib.util.find_spec("onnx") probes
    # don't explode
    shim.__spec__ = importlib.machinery.ModuleSpec("onnx", loader=None)

    class _Graph:
        node = ()

    class _Model:
        graph = _Graph()

    shim.load_model_from_string = lambda b: _Model()
    sys.modules["onnx"] = shim


def export_onnx(model: torch.nn.Module, args, path: str, opset: int = 17, **kw) -> str:
    """``model(*args)`` traced to ``path`` (opset 17 by default); ``kw`` go
    to ``torch.onnx.export`` (``input_names``, ``dynamic_axes``, ...)."""
    _install_onnx_shim()
    model.eval()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.onnx.export(model, tuple(args), path, opset_version=opset, dynamo=False, **kw)
    return path
