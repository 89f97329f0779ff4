"""ONNX graph executor: parse once -> an eager ``params, inputs -> outputs``
forward on a torch device (the port of ``lumen_tpu/onnx_bridge/executor.py``).

This replaces the reference's onnxruntime sessions (e.g. the SCRFD/ArcFace
sessions of ``packages/lumen-face/src/lumen_face/backends/onnxrt_backend.py:
485-745`` and the PP-OCR sessions of ``packages/lumen-ocr/src/lumen_ocr/
backends/onnxrt_backend.py:43-633``) with a graph *bridge*: node ops lower
to torch (``ops.py``), float weights become a flat dict of tensors
(castable, placed on any device, one copy per replica), and the forward
runs every node eagerly on the device its inputs live on.

Static-vs-device value split: integer/shape tensors stay numpy, so a
shape subgraph never waits on the device; dense values are torch tensors.
See ``ops.py``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..runtime.policy import resolve_device
from .ops import OP_REGISTRY, STATIC_SLOTS, _TORCH_DTYPES
from .proto import OnnxGraph, load_onnx, parse_onnx

logger = logging.getLogger(__name__)


class _Ctx:
    """Per-call state: the opset, the device every dense value lives on,
    and the module's cache of device copies of static arrays."""

    def __init__(self, opset: int, device: torch.device, module: "OnnxModule"):
        self.opset = opset
        self.device = device
        self._module = module

    def tensor(self, arr) -> torch.Tensor:
        """A device tensor of the static ``arr`` (see
        :meth:`OnnxModule._device_const`)."""
        return self._module._device_const(arr, self.device)


class OnnxModule:
    """A loaded ONNX graph, executable eagerly on a torch device.

    ``params``: float initializers (the model weights) as a flat
    ``{name: torch.Tensor}`` dict of float32 CPU tensors — pass them (or
    a :meth:`place`-d copy) to :meth:`__call__`. Integer/bool initializers,
    and float ones read only as shapes, scales or bounds, are static
    constants and live inside the module.
    """

    def __init__(self, graph: OnnxGraph):
        self.graph = graph
        self.opset = graph.opset
        self.params: dict[str, torch.Tensor] = {}
        self.constants: dict[str, np.ndarray] = {}
        static_only = self._static_only_initializers(graph)
        for name, arr in graph.initializers.items():
            if np.issubdtype(arr.dtype, np.floating) and arr.ndim > 0 and name not in static_only:
                self.params[name] = torch.from_numpy(np.array(arr, np.float32))
            else:
                self.constants[name] = arr
        self._device_cache: dict[tuple, torch.Tensor] = {}
        self.input_names = [vi.name for vi in graph.inputs]
        self.output_names = [vi.name for vi in graph.outputs]
        self._validate_ops()
        self._release_after = self._release_plan(graph, set(self.output_names))

    @staticmethod
    def _release_plan(graph: OnnxGraph, outputs: set[str]) -> list[tuple[str, ...]]:
        """For each node, the values that no later node reads and that are
        no graph output: a forward drops them once the node ran, so it
        holds only its live intermediates (not every value of the graph
        until the end). The graph has no subgraph ops, so every read is a
        node input."""
        last: dict[str, int] = {}
        for i, node in enumerate(graph.nodes):
            for name in node.inputs:
                if name:
                    last[name] = i
            for name in node.outputs:
                if name:
                    last.setdefault(name, i)  # an output nothing reads goes at once
        plan: list[list[str]] = [[] for _ in graph.nodes]
        for name, i in last.items():
            if name not in outputs:
                plan[i].append(name)
        return [tuple(p) for p in plan]

    @staticmethod
    def _static_only_initializers(graph: OnnxGraph) -> set[str]:
        uses: dict[str, list[bool]] = {}
        for node in graph.nodes:
            slots = STATIC_SLOTS.get(node.op_type, set())
            for i, name in enumerate(node.inputs):
                if name in graph.initializers:
                    uses.setdefault(name, []).append(i in slots)
        outputs = {vi.name for vi in graph.outputs}
        return {n for n, u in uses.items() if all(u) and n not in outputs}

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_path(cls, path: str) -> "OnnxModule":
        return cls(load_onnx(path))

    @classmethod
    def from_bytes(cls, data: bytes) -> "OnnxModule":
        return cls(parse_onnx(data))

    # -- introspection -----------------------------------------------------

    def _validate_ops(self) -> None:
        missing = sorted(
            {n.op_type for n in self.graph.nodes if n.op_type not in OP_REGISTRY}
        )
        if missing:
            raise NotImplementedError(
                f"ONNX graph {self.graph.name!r} uses unsupported ops: {missing} "
                f"(supported: {len(OP_REGISTRY)} op types)"
            )

    def input_shapes(self) -> dict[str, tuple]:
        """Declared input shapes; dynamic dims come back as None/str."""
        return {vi.name: tuple(vi.shape) for vi in self.graph.inputs}

    def param_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.params.values())

    def place(self, device, dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
        """A copy of the weights on ``device`` (cast to ``dtype`` if given):
        one per replica."""
        return {k: v.to(device=device, dtype=dtype or v.dtype) for k, v in self.params.items()}

    def release_weights(self) -> None:
        """Drop the host-RAM weights once a device copy exists: the
        float32 ``params`` and the file's arrays in ``graph.initializers``
        they were copied from, which the module keeps alive through the
        graph — both must go."""
        for name in list(self.params):
            self.graph.initializers.pop(name, None)
        self.params.clear()

    def _device_const(self, arr, device: torch.device) -> torch.Tensor:
        """The device copy of a static array that meets a device value,
        keyed by its contents: made once per device and reused by every
        later forward. The static arrays of a graph are its constants and
        what shape arithmetic derives from them, a few per input shape,
        so the cache stays small. No op writes into its inputs."""
        a = np.asarray(arr)
        key = (str(device), a.dtype.str, a.shape, a.tobytes())
        hit = self._device_cache.get(key)
        if hit is None:
            # a writable C-ordered copy (file-backed arrays are read-only);
            # 0-d stays 0-d
            hit = torch.from_numpy(np.array(a, order="C")).to(device=device, dtype=_TORCH_DTYPES[a.dtype])
            self._device_cache[key] = hit
        return hit

    # -- execution ---------------------------------------------------------

    def __call__(self, params: dict, inputs: dict, device=None):
        """Execute the graph. ``inputs``: {input_name: tensor or array};
        arrays are fed as tensors on the device of the params (or
        ``device``). Returns a list of outputs (torch tensors, or numpy
        arrays for outputs that are static)."""
        if device is None:
            first = next(
                (v for v in (*params.values(), *inputs.values()) if isinstance(v, torch.Tensor)), None
            )
            device = first.device if first is not None else torch.device("cpu")
        device = torch.device(device)
        env: dict[str, object] = {}
        env.update(self.constants)
        env.update(params)
        for name, value in inputs.items():
            if not isinstance(value, torch.Tensor):
                a = np.asarray(value)
                value = torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=_TORCH_DTYPES[a.dtype])
            env[name] = value
        ctx = _Ctx(self.opset, device, self)
        for node, dead in zip(self.graph.nodes, self._release_after):
            vals = [env[i] if i else None for i in node.inputs]
            fn = OP_REGISTRY[node.op_type]
            try:
                outs = fn(node, vals, ctx)
            except NotImplementedError:
                raise
            except Exception as e:
                raise RuntimeError(
                    f"ONNX node {node.name!r} ({node.op_type}) failed: {e}"
                ) from e
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
            del vals, outs
            for name in dead:
                env.pop(name, None)
        return [env[name] for name in self.output_names]

    def bind(self, dtype: torch.dtype | None = None, device=None):
        """Convenience: returns ``(fn, params)`` where ``fn(params, *arrays)``
        maps positional inputs to a tuple of outputs. ``params`` are placed
        on ``device`` (``cuda:0`` unless the caller passes another, as
        :func:`~lumen_tpu_torch.runtime.policy.resolve_device` resolves it)
        and cast to ``dtype`` (e.g. ``torch.bfloat16``); float inputs are
        cast to ``dtype`` too, so mixed-precision serving does not trip
        dtype-strict ops (conv)."""
        params = self.place(resolve_device(device), dtype)
        names = self.input_names

        def fn(p, *arrays):
            if len(arrays) != len(names):
                raise ValueError(f"expected inputs {names}, got {len(arrays)} arrays")
            feeds = {}
            dev = next(iter(p.values())).device if p else None
            for name, a in zip(names, arrays):
                if not isinstance(a, torch.Tensor):
                    arr = np.asarray(a)
                    a = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype=_TORCH_DTYPES[arr.dtype])
                if dev is not None:
                    a = a.to(dev)
                if dtype is not None and a.is_floating_point():
                    a = a.to(dtype)
                feeds[name] = a
            outs = self(p, feeds)
            return tuple(o if isinstance(o, torch.Tensor) else torch.as_tensor(np.asarray(o)) for o in outs)

        return fn, params
