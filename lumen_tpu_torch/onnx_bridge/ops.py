"""ONNX op set -> PyTorch lowering rules for the bridge executor (the port
of ``lumen_tpu/onnx_bridge/ops.py``).

Coverage target: the CNN/transformer op mix of the reference's model zoo —
InsightFace SCRFD detectors + ArcFace embedders and PP-OCR det/rec graphs
(consumed by onnxruntime in the reference, ``packages/lumen-face/.../
onnxrt_backend.py``, ``packages/lumen-ocr/.../onnxrt_backend.py``) — plus
everything torch.onnx emits for the golden-test models.

Execution model: values flowing through the graph are either *static*
(numpy arrays — shapes, axes, constants) or *device* values (torch
tensors). The JAX package keeps shape arithmetic static so XLA sees
compile-time shapes; here the same split keeps every shape subgraph
(``Shape -> Gather -> Unsqueeze -> Concat -> Reshape``) on the host, so an
eager forward never waits on the device for a shape. ``_static`` means
"not a ``torch.Tensor``": element-wise and indexing ops run in numpy when
every input is static, exactly where the JAX lowering runs numpy. Dense
compute always runs in torch, on the device of the graph's inputs.

An op that would need a device value on the host (a ``Reshape`` target,
``Slice`` bounds, a ``TopK`` k, ``Range`` limits computed on the device)
raises ``NotImplementedError`` — the JAX lowering cannot trace those
either, and a silent device-to-host copy would stall every forward.
Static constants that meet device values are copied to the device once
per module and device (``_Ctx.tensor``), not once per call.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .proto import TENSOR_DTYPES, Node

OP_REGISTRY: dict = {}


def register(name: str):
    def deco(fn):
        OP_REGISTRY[name] = fn
        return fn

    return deco


def _static(*vals) -> bool:
    return all(not isinstance(v, torch.Tensor) for v in vals if v is not None)


def _int_list(v) -> list[int]:
    if isinstance(v, torch.Tensor):
        raise NotImplementedError("a shape, axis or bound operand was computed on the device; it must be static")
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _shape(v) -> tuple:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def _ndim(v) -> int:
    return v.ndim if isinstance(v, torch.Tensor) else np.ndim(v)


#: numpy dtype -> torch dtype of a device value (float64 runs as float32,
#: as the JAX lowering runs it with x64 off)
_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def _T(ctx, v) -> torch.Tensor:
    """A device tensor of ``v`` (already one, or a static array)."""
    return v if isinstance(v, torch.Tensor) else ctx.tensor(v)


def _operand(ctx, v):
    """A binary operand: tensors as they are, 0-d statics as Python
    scalars (torch promotes those like the JAX lowering promotes numpy
    scalars), other statics as device tensors."""
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    return arr.item() if arr.ndim == 0 else ctx.tensor(v)


def _float_dtype(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.issubdtype(np.asarray(v).dtype, np.floating)


# -- elementwise -------------------------------------------------------------


def _np_erf(x):
    from math import erf

    return np.vectorize(erf)(np.asarray(x, np.float64)).astype(np.asarray(x).dtype)


_UNARY = {
    # name: (numpy, torch)
    "Relu": (lambda x: np.maximum(x, 0), torch.relu),
    "Sigmoid": (lambda x: 1.0 / (1.0 + np.exp(-x)), torch.sigmoid),
    "Tanh": (np.tanh, torch.tanh),
    "Exp": (np.exp, torch.exp),
    "Log": (np.log, torch.log),
    "Sqrt": (np.sqrt, torch.sqrt),
    "Neg": (lambda x: -x, torch.neg),
    "Abs": (np.abs, torch.abs),
    "Floor": (np.floor, torch.floor),
    "Ceil": (np.ceil, torch.ceil),
    "Round": (np.round, torch.round),
    "Reciprocal": (lambda x: 1.0 / x, torch.reciprocal),
    "Not": (lambda x: ~x, torch.logical_not),
    "Erf": (_np_erf, torch.erf),
    "Softplus": (lambda x: np.logaddexp(x, 0.0), lambda x: torch.logaddexp(x, torch.zeros_like(x))),
    "Identity": (lambda x: x, lambda x: x),
}

for _name, (_fnp, _ft) in _UNARY.items():

    def _make(fnp, ft):
        def op(node: Node, vals, ctx):
            x = vals[0]
            return [fnp(x) if _static(x) else ft(x)]

        return op

    OP_REGISTRY[_name] = _make(_fnp, _ft)


def _div(a, b, device: bool):
    if _float_dtype(a) or _float_dtype(b):
        return a / b
    if device:
        if not isinstance(a, torch.Tensor):
            a = torch.full((), a, dtype=b.dtype, device=b.device)
        return torch.div(a, b, rounding_mode="floor")
    return a // b


def _t_min(a, b):
    if isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
        return torch.minimum(a, b)
    return torch.clamp(a, max=b) if isinstance(a, torch.Tensor) else torch.clamp(b, max=a)


def _t_max(a, b):
    if isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
        return torch.maximum(a, b)
    return torch.clamp(a, min=b) if isinstance(a, torch.Tensor) else torch.clamp(b, min=a)


_BINARY = {
    # name: (numpy, torch); the torch side gets tensors or Python scalars
    "Add": (lambda a, b: a + b, lambda a, b: a + b),
    "Sub": (lambda a, b: a - b, lambda a, b: a - b),
    "Mul": (lambda a, b: a * b, lambda a, b: a * b),
    "Div": (lambda a, b: _div(a, b, False), lambda a, b: _div(a, b, True)),
    "Pow": (np.power, torch.pow),
    "Min": (np.minimum, _t_min),
    "Max": (np.maximum, _t_max),
    "Equal": (lambda a, b: a == b, lambda a, b: torch.eq(a, b) if isinstance(a, torch.Tensor) else torch.eq(b, a)),
    "Greater": (lambda a, b: a > b, lambda a, b: a > b),
    "GreaterOrEqual": (lambda a, b: a >= b, lambda a, b: a >= b),
    "Less": (lambda a, b: a < b, lambda a, b: a < b),
    "LessOrEqual": (lambda a, b: a <= b, lambda a, b: a <= b),
    "And": (lambda a, b: a & b, lambda a, b: a & b),
    "Or": (lambda a, b: a | b, lambda a, b: a | b),
    "Mod": (lambda a, b: a % b, lambda a, b: a % b),
}

for _name, (_fnp, _ft) in _BINARY.items():

    def _make2(fnp, ft):
        def op(node: Node, vals, ctx):
            if _static(*vals):
                out = fnp(vals[0], vals[1])
                for v in vals[2:]:  # Min/Max are variadic
                    out = fnp(out, v)
                return [out]
            out = ft(_operand(ctx, vals[0]), _operand(ctx, vals[1]))
            for v in vals[2:]:
                out = ft(_operand(ctx, out), _operand(ctx, v))
            return [out]

        return op

    OP_REGISTRY[_name] = _make2(_fnp, _ft)


@register("Sum")
def op_sum(node, vals, ctx):
    if _static(*vals):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return [out]
    out = _T(ctx, vals[0])
    for v in vals[1:]:
        out = out + _operand(ctx, v)
    return [out]


@register("LeakyRelu")
def op_leaky(node, vals, ctx):
    alpha = node.attr("alpha", 0.01)
    x = vals[0]
    if _static(x):
        return [np.where(x >= 0, x, alpha * x)]
    return [torch.where(x >= 0, x, alpha * x)]


@register("PRelu")
def op_prelu(node, vals, ctx):
    x, slope = vals
    if _static(x, slope):
        s = np.asarray(slope)
        if s.ndim and s.ndim < np.ndim(x):
            s = s.reshape((1, -1) + (1,) * (np.ndim(x) - 2))
        return [np.where(x >= 0, x, s * x)]
    x, s = _T(ctx, x), _T(ctx, slope)
    # ONNX slope broadcasts per channel: [C] / [C,1,1] against NCHW input.
    if s.ndim and s.ndim < x.ndim:
        s = s.reshape((1, -1) + (1,) * (x.ndim - 2))
    return [torch.where(x >= 0, x, s * x)]


@register("HardSigmoid")
def op_hardsigmoid(node, vals, ctx):
    alpha = node.attr("alpha", 0.2)
    beta = node.attr("beta", 0.5)
    x = vals[0]
    if _static(x):
        return [np.clip(alpha * x + beta, 0.0, 1.0)]
    return [torch.clamp(alpha * x + beta, 0.0, 1.0)]


@register("HardSwish")
def op_hardswish(node, vals, ctx):
    x = vals[0]
    if _static(x):
        return [x * np.clip(x / 6.0 + 0.5, 0.0, 1.0)]
    return [x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)]


@register("Mish")
def op_mish(node, vals, ctx):
    x = vals[0]
    if _static(x):
        return [x * np.tanh(np.logaddexp(x, 0.0))]
    return [x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))]


@register("Gelu")
def op_gelu(node, vals, ctx):
    x = _T(ctx, vals[0])
    approximate = "tanh" if node.attr("approximate", "none") == "tanh" else "none"
    return [F.gelu(x, approximate=approximate)]


@register("Clip")
def op_clip(node, vals, ctx):
    x = vals[0]
    lo = vals[1] if len(vals) > 1 and vals[1] is not None else node.attr("min")
    hi = vals[2] if len(vals) > 2 and vals[2] is not None else node.attr("max")
    if _static(x):
        dtype = np.asarray(x).dtype
        if lo is not None:
            x = np.maximum(x, np.asarray(lo, dtype=dtype))
        if hi is not None:
            x = np.minimum(x, np.asarray(hi, dtype=dtype))
        return [x]
    if lo is not None:
        x = _t_max(x, _operand(ctx, lo))
    if hi is not None:
        x = _t_min(x, _operand(ctx, hi))
    return [x]


@register("Where")
def op_where(node, vals, ctx):
    c, a, b = vals
    if _static(c, a, b):
        return [np.where(c, a, b)]
    return [torch.where(_T(ctx, c), _operand(ctx, a), _operand(ctx, b))]


@register("Cast")
def op_cast(node, vals, ctx):
    to = node.attr("to")
    np_dtype = TENSOR_DTYPES.get(to, np.float32)
    x = vals[0]
    if _static(x):
        return [np.asarray(x).astype(np_dtype)]
    return [x.to(_TORCH_DTYPES[np.dtype(np_dtype)])]


# -- normalization -----------------------------------------------------------


@register("BatchNormalization")
def op_batchnorm(node, vals, ctx):
    x, scale, bias, mean, var = vals[:5]
    eps = node.attr("epsilon", 1e-5)
    x = _T(ctx, x)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if _static(var):
        inv = _T(ctx, 1.0 / np.sqrt(np.asarray(var, np.float32) + eps))
    else:
        inv = torch.rsqrt(var + eps)
    scale, bias, mean = _T(ctx, scale), _T(ctx, bias), _T(ctx, mean)
    return [(x - mean.reshape(shape)) * (inv * scale).reshape(shape) + bias.reshape(shape)]


@register("LayerNormalization")
def op_layernorm(node, vals, ctx):
    x = _T(ctx, vals[0])
    scale = _T(ctx, vals[1])
    bias = _T(ctx, vals[2]) if len(vals) > 2 and vals[2] is not None else None
    axis = node.attr("axis", -1)
    eps = node.attr("epsilon", 1e-5)
    axes = tuple(range(axis if axis >= 0 else x.ndim + axis, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return [out]


@register("InstanceNormalization")
def op_instancenorm(node, vals, ctx):
    x, scale, bias = (_T(ctx, v) for v in vals)
    eps = node.attr("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return [(x - mean) * torch.rsqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)]


@register("Dropout")
def op_dropout(node, vals, ctx):
    return [vals[0]]  # inference


@register("Softmax")
def op_softmax(node, vals, ctx):
    x = _T(ctx, vals[0])
    axis = node.attr("axis", -1 if ctx.opset >= 13 else 1)
    if ctx.opset >= 13:
        return [torch.softmax(x, dim=axis)]
    # legacy semantics: flatten from axis, softmax, reshape back
    shape = x.shape
    flat = x.reshape(int(np.prod(shape[:axis])) if axis else 1, -1)
    return [torch.softmax(flat, dim=-1).reshape(shape)]


@register("LogSoftmax")
def op_logsoftmax(node, vals, ctx):
    return [torch.log_softmax(_T(ctx, vals[0]), dim=node.attr("axis", -1))]


# -- conv / pool -------------------------------------------------------------


def _conv_pads(node, spatial: int, x_shape, k_shape, strides, dilations):
    auto_pad = node.attr("auto_pad", "NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    pads = node.attr("pads")
    if auto_pad in ("NOTSET", "", None):
        if pads is None:
            pads = [0] * (2 * spatial)
        return [(pads[i], pads[i + spatial]) for i in range(spatial)]
    if auto_pad == "VALID":
        return [(0, 0)] * spatial
    # SAME_UPPER / SAME_LOWER
    out = []
    for i in range(spatial):
        in_dim = x_shape[2 + i]
        eff_k = (k_shape[i] - 1) * dilations[i] + 1
        out_dim = -(-in_dim // strides[i])
        total = max(0, (out_dim - 1) * strides[i] + eff_k - in_dim)
        lo = total // 2 if auto_pad == "SAME_UPPER" else total - total // 2
        out.append((lo, total - lo))
    return out


def _pad_spatial(x: torch.Tensor, pads, value: float = 0.0):
    """``pads`` [(lo, hi)] per spatial dim -> (x padded where the two sides
    differ, the symmetric padding left for the op). ``F.conv*`` and the
    pools take symmetric padding only; a negative side crops."""
    if all(lo == hi for lo, hi in pads):
        return x, [lo for lo, _ in pads]
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value), [0] * len(pads)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


@register("Conv")
def op_conv(node, vals, ctx):
    x, w = _T(ctx, vals[0]), _T(ctx, vals[1])
    b = _T(ctx, vals[2]) if len(vals) > 2 and vals[2] is not None else None
    spatial = x.ndim - 2
    strides = node.attr("strides", [1] * spatial)
    dilations = node.attr("dilations", [1] * spatial)
    group = node.attr("group", 1)
    k_shape = node.attr("kernel_shape", list(w.shape[2:]))
    pads = _conv_pads(node, spatial, x.shape, k_shape, strides, dilations)
    x, padding = _pad_spatial(x, pads)
    return [_CONV[spatial](x, w, b, stride=strides, padding=padding, dilation=dilations, groups=group)]


@register("ConvTranspose")
def op_conv_transpose(node, vals, ctx):
    x, w = _T(ctx, vals[0]), _T(ctx, vals[1])
    b = _T(ctx, vals[2]) if len(vals) > 2 and vals[2] is not None else None
    spatial = x.ndim - 2
    strides = node.attr("strides", [1] * spatial)
    dilations = node.attr("dilations", [1] * spatial)
    group = node.attr("group", 1)
    pads_attr = node.attr("pads", [0] * (2 * spatial))
    out_pad = node.attr("output_padding", [0] * spatial)
    if node.attr("output_shape") is not None:
        raise NotImplementedError("ConvTranspose with explicit output_shape")
    # ONNX weight layout [C_in, C_out/group, k...] is torch's. The full
    # (unpadded) transposed convolution, then each side cropped by its own
    # pad; output_padding extends the high side with positions no input
    # reaches (the bias alone), which a negative crop pads with zeros.
    out = _CONV_T[spatial](x, w, None, stride=strides, padding=0, groups=group, dilation=dilations)
    crop = []
    for i in reversed(range(spatial)):
        crop += [-pads_attr[i], -(pads_attr[spatial + i] - out_pad[i])]
    if any(crop):
        out = F.pad(out, crop)
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * spatial)
    return [out]


def _pool_pads(node, x, k, strides, dilations):
    spatial = x.ndim - 2
    pads = _conv_pads(node, spatial, x.shape, k, strides, dilations)
    if node.attr("ceil_mode", 0):
        # extend high padding so the last (partial) window is included
        new_pads = []
        for i in range(spatial):
            in_dim = x.shape[2 + i] + pads[i][0] + pads[i][1]
            eff_k = (k[i] - 1) * dilations[i] + 1
            rem = (in_dim - eff_k) % strides[i]
            extra = (strides[i] - rem) % strides[i] if rem else 0
            new_pads.append((pads[i][0], pads[i][1] + extra))
        pads = new_pads
    return pads


def _window_sum(x: torch.Tensor, k, strides, dilations) -> torch.Tensor:
    """Sum over each pooling window of an already padded ``x`` (a
    depthwise convolution with a kernel of ones)."""
    c = x.shape[1]
    ones = torch.ones((c, 1, *k), dtype=x.dtype, device=x.device)
    return _CONV[x.ndim - 2](x, ones, None, stride=strides, dilation=dilations, groups=c)


@register("MaxPool")
def op_maxpool(node, vals, ctx):
    if len(node.outputs) > 1:
        raise NotImplementedError("MaxPool with indices output")
    x = _T(ctx, vals[0])
    spatial = x.ndim - 2
    k = node.attr("kernel_shape")
    strides = node.attr("strides", [1] * spatial)
    dilations = node.attr("dilations", [1] * spatial)
    pads = _pool_pads(node, x, k, strides, dilations)
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if any(flat):
        x = F.pad(x, flat, value=-math.inf)
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[spatial]
    return [pool(x, k, strides, 0, dilations)]


@register("AveragePool")
def op_avgpool(node, vals, ctx):
    x = _T(ctx, vals[0])
    spatial = x.ndim - 2
    k = node.attr("kernel_shape")
    strides = node.attr("strides", [1] * spatial)
    dilations = node.attr("dilations", [1] * spatial)
    pads = _pool_pads(node, x, k, strides, dilations)
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    padded = F.pad(x, flat) if any(flat) else x
    if all(d == 1 for d in dilations):
        avg = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[spatial]
        out = avg(padded, k, strides, 0)
        if node.attr("count_include_pad", 0) or not any(flat):
            return [out]
        sums = out * float(np.prod(k))
    else:
        sums = _window_sum(padded, k, strides, dilations)
        if node.attr("count_include_pad", 0):
            return [sums / float(np.prod(k))]
    # divide by the number of real (unpadded) elements in each window
    ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device)
    counts = _window_sum(F.pad(ones, flat) if any(flat) else ones, k, strides, dilations)
    return [sums / counts]


@register("GlobalAveragePool")
def op_gap(node, vals, ctx):
    x = _T(ctx, vals[0])
    return [x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)]


@register("GlobalMaxPool")
def op_gmp(node, vals, ctx):
    x = _T(ctx, vals[0])
    return [x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)]


# -- matmul ------------------------------------------------------------------


@register("MatMul")
def op_matmul(node, vals, ctx):
    return [torch.matmul(_T(ctx, vals[0]), _T(ctx, vals[1]))]


@register("Gemm")
def op_gemm(node, vals, ctx):
    a, b = _T(ctx, vals[0]), _T(ctx, vals[1])
    c = vals[2] if len(vals) > 2 else None
    if node.attr("transA", 0):
        a = a.T
    if node.attr("transB", 0):
        b = b.T
    out = node.attr("alpha", 1.0) * (a @ b)
    if c is not None:
        out = out + node.attr("beta", 1.0) * _operand(ctx, c)
    return [out]


@register("Einsum")
def op_einsum(node, vals, ctx):
    return [torch.einsum(node.attr("equation"), *[_T(ctx, v) for v in vals])]


# -- shape / indexing --------------------------------------------------------


@register("Shape")
def op_shape(node, vals, ctx):
    shape = np.asarray(_shape(vals[0]), np.int64)
    start = node.attr("start", 0)
    end = node.attr("end")
    return [shape[start:end]]


@register("Size")
def op_size(node, vals, ctx):
    return [np.asarray(int(np.prod(_shape(vals[0]))), np.int64)]


@register("Reshape")
def op_reshape(node, vals, ctx):
    x, shape = vals
    if isinstance(shape, torch.Tensor):
        raise NotImplementedError(
            f"dynamic Reshape target at node {node.name!r} (shape must be static)"
        )
    target = _int_list(shape)
    x_shape = _shape(x)
    # ONNX: 0 copies the input dim (unless allowzero), -1 infers.
    if not node.attr("allowzero", 0):
        target = [x_shape[i] if t == 0 else t for i, t in enumerate(target)]
    if _static(x):
        return [np.reshape(x, tuple(target))]
    return [x.reshape(tuple(target))]


@register("Transpose")
def op_transpose(node, vals, ctx):
    x = vals[0]
    perm = node.attr("perm")
    if perm is None:
        perm = list(range(_ndim(x)))[::-1]
    if _static(x):
        return [np.transpose(x, perm)]
    return [x.permute(*perm)]


@register("Flatten")
def op_flatten(node, vals, ctx):
    x = vals[0]
    axis = node.attr("axis", 1)
    shape = _shape(x)
    lead = int(np.prod(shape[:axis])) if axis else 1
    if _static(x):
        return [np.reshape(x, (lead, -1))]
    return [x.reshape(lead, -1)]


@register("Squeeze")
def op_squeeze(node, vals, ctx):
    x = vals[0]
    axes = _int_list(vals[1]) if len(vals) > 1 and vals[1] is not None else node.attr("axes")
    if _static(x):
        if axes is None:
            return [np.squeeze(x)]
        return [np.squeeze(x, axis=tuple(int(a) for a in axes))]
    if axes is None:
        return [x.squeeze()]
    return [x.squeeze(tuple(int(a) for a in axes))]


@register("Unsqueeze")
def op_unsqueeze(node, vals, ctx):
    x = vals[0]
    axes = _int_list(vals[1]) if len(vals) > 1 and vals[1] is not None else node.attr("axes")
    out = x
    for a in sorted(int(a) for a in axes):
        a = a if a >= 0 else a + _ndim(out) + 1
        out = np.expand_dims(out, a) if _static(out) else out.unsqueeze(a)
    return [out]


@register("Concat")
def op_concat(node, vals, ctx):
    axis = node.attr("axis")
    if _static(*vals):
        return [np.concatenate([np.asarray(v) for v in vals], axis=axis)]
    return [torch.cat([_T(ctx, v) for v in vals], dim=axis)]


def _wrap_index(idx, dim: int):
    """Negative ONNX indices count from the end."""
    if isinstance(idx, torch.Tensor):
        return torch.where(idx < 0, idx + dim, idx).long()
    idx = np.asarray(idx, np.int64)
    return np.where(idx < 0, idx + dim, idx)


@register("Gather")
def op_gather(node, vals, ctx):
    x, idx = vals
    axis = node.attr("axis", 0)
    if _static(x, idx):
        return [np.take(x, np.asarray(idx, np.int64), axis=axis)]
    x = _T(ctx, x)
    axis = axis % x.ndim
    if _static(idx) and np.ndim(idx) == 0:
        return [x.select(axis, int(_wrap_index(idx, x.shape[axis])))]
    if _static(idx):
        flat = ctx.tensor(_wrap_index(idx, x.shape[axis]).reshape(-1))
        idx_shape = np.shape(idx)
    else:
        flat = _wrap_index(idx, x.shape[axis]).reshape(-1)
        idx_shape = tuple(idx.shape)
    out = x.index_select(axis, flat)
    return [out.reshape(x.shape[:axis] + tuple(idx_shape) + x.shape[axis + 1:])]


@register("GatherElements")
def op_gather_elements(node, vals, ctx):
    x = _T(ctx, vals[0])
    axis = node.attr("axis", 0)
    idx = vals[1]
    if _static(idx):
        idx = ctx.tensor(_wrap_index(idx, x.shape[axis]))
    else:
        idx = _wrap_index(idx, x.shape[axis])
    return [torch.gather(x, axis, idx)]


def _slice_dim(x: torch.Tensor, ax: int, st: int, en: int, sp: int) -> torch.Tensor:
    """Python slice semantics on one dim of a tensor, negative steps too
    (torch slices take positive steps only: flip, then slice forward)."""
    n = x.shape[ax]
    r = range(n)[slice(st, en, sp)]
    if len(r) == 0:
        return x.narrow(ax, 0, 0)
    index = [slice(None)] * x.ndim
    if sp > 0:
        index[ax] = slice(r.start, r.start + (len(r) - 1) * sp + 1, sp)
        return x[tuple(index)]
    start = n - 1 - r.start
    index[ax] = slice(start, start + (len(r) - 1) * -sp + 1, -sp)
    return x.flip(ax)[tuple(index)]


@register("Slice")
def op_slice(node, vals, ctx):
    x = vals[0]
    if len(vals) > 1:  # opset >= 10: starts/ends/axes/steps are inputs
        starts = _int_list(vals[1])
        ends = _int_list(vals[2])
        axes = _int_list(vals[3]) if len(vals) > 3 and vals[3] is not None else list(range(len(starts)))
        steps = _int_list(vals[4]) if len(vals) > 4 and vals[4] is not None else [1] * len(starts)
    else:
        starts = node.attr("starts")
        ends = node.attr("ends")
        axes = node.attr("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    shape = _shape(x)
    if not _static(x):
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            x = _slice_dim(x, ax % x.ndim, st, en, sp)
        return [x]
    index = [slice(None)] * np.ndim(x)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        # ONNX encodes "to the end" as INT64_MAX; clamp for python slices.
        lim = shape[ax]
        st = max(min(st, lim), -lim) if st >= 0 else st
        en = min(en, lim) if en >= 0 else max(en, -lim - 1)
        index[ax] = slice(st, en, sp)
    return [x[tuple(index)]]


@register("Split")
def op_split(node, vals, ctx):
    x = vals[0]
    axis = node.attr("axis", 0)
    split = (
        _int_list(vals[1])
        if len(vals) > 1 and vals[1] is not None
        else node.attr("split")
    )
    n_dim = _shape(x)[axis]
    if split is None:
        n = len(node.outputs)
        if n_dim % n:
            raise ValueError(f"Split of {n_dim} into {n} equal parts")
        split = [n_dim // n] * n
    if _static(x):
        return list(np.split(x, np.cumsum(split[:-1]).tolist(), axis=axis))
    return list(torch.split(x, list(split), dim=axis))


@register("Expand")
def op_expand(node, vals, ctx):
    x, shape = vals
    target = _int_list(shape)
    x_shape = list(_shape(x))
    # ONNX Expand is bidirectional broadcast; result dim = max(x, target)
    ndim = max(len(target), len(x_shape))
    x_shape = [1] * (ndim - len(x_shape)) + x_shape
    target = [1] * (ndim - len(target)) + target
    out_shape = tuple(max(a, b) for a, b in zip(x_shape, target))
    if _static(x):
        return [np.broadcast_to(np.reshape(x, tuple(x_shape)), out_shape)]
    return [x.reshape(tuple(x_shape)).expand(out_shape)]


@register("Tile")
def op_tile(node, vals, ctx):
    x, reps = vals
    reps = tuple(_int_list(reps))
    if _static(x):
        return [np.tile(x, reps)]
    return [torch.tile(x, reps)]


def _scalar(v) -> float:
    if isinstance(v, torch.Tensor):
        raise NotImplementedError("a Pad value computed on the device; it must be static")
    return float(np.asarray(v))


@register("Pad")
def op_pad(node, vals, ctx):
    x = vals[0]
    if len(vals) > 1 and vals[1] is not None:
        pads = _int_list(vals[1])
        cval = vals[2] if len(vals) > 2 and vals[2] is not None else 0.0
    else:
        pads = node.attr("pads")
        cval = node.attr("value", 0.0)
    mode = node.attr("mode", "constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    n = _ndim(x)
    widths = [(pads[i], pads[i + n]) for i in range(n)]
    if _static(x):
        if mode == "constant":
            return [np.pad(x, widths, mode="constant", constant_values=_scalar(cval))]
        return [np.pad(x, widths, mode={"reflect": "reflect", "edge": "edge"}[mode])]
    # F.pad lists (lo, hi) from the last dim backwards; leading unpadded
    # dims drop off (reflect/replicate take the trailing dims only).
    while widths and widths[0] == (0, 0):
        widths = widths[1:]
    flat = []
    for lo, hi in reversed(widths):
        flat += [lo, hi]
    if not flat:
        return [x]
    if mode == "constant":
        return [F.pad(x, flat, mode="constant", value=_scalar(cval))]
    return [F.pad(x, flat, mode={"reflect": "reflect", "edge": "replicate"}[mode])]


@register("Constant")
def op_constant(node, vals, ctx):
    t = node.attr("value")
    if t is not None:
        return [t.array]
    for key in ("value_float", "value_int"):
        v = node.attr(key)
        if v is not None:
            return [np.asarray(v)]
    v = node.attr("value_floats")
    if v:
        return [np.asarray(v, np.float32)]
    v = node.attr("value_ints")
    if v:
        return [np.asarray(v, np.int64)]
    raise NotImplementedError(f"Constant node {node.name!r} without value")


@register("ConstantOfShape")
def op_constant_of_shape(node, vals, ctx):
    shape = tuple(_int_list(vals[0]))
    t = node.attr("value")
    if t is None:
        return [np.zeros(shape, np.float32)]
    return [np.full(shape, t.array.reshape(-1)[0], t.array.dtype)]


@register("Range")
def op_range(node, vals, ctx):
    if not _static(*vals):
        raise NotImplementedError("Range over values computed on the device; its bounds must be static")
    start, limit, delta = [np.asarray(v).item() for v in vals]
    return [np.arange(start, limit, delta)]


def _arg(node, vals, fnp, ft):
    x = vals[0]
    axis = node.attr("axis", 0)
    keepdims = node.attr("keepdims", 1)
    if _static(x):
        out = fnp(x, axis=axis)
        if keepdims:
            out = np.expand_dims(out, axis)
        return [out.astype(np.int64)]
    return [ft(x, dim=axis, keepdim=bool(keepdims))]


@register("ArgMax")
def op_argmax(node, vals, ctx):
    return _arg(node, vals, np.argmax, torch.argmax)


@register("ArgMin")
def op_argmin(node, vals, ctx):
    return _arg(node, vals, np.argmin, torch.argmin)


@register("TopK")
def op_topk(node, vals, ctx):
    x = _T(ctx, vals[0])
    k = _int_list(vals[1])[0]
    axis = node.attr("axis", -1)
    if node.attr("largest", 1) == 0:
        raise NotImplementedError("TopK smallest")
    # A stable descending sort keeps the lower index first among equal
    # values, as ``lax.top_k`` does (``torch.topk`` leaves ties unordered).
    v, i = torch.sort(x, dim=axis, descending=True, stable=True)
    return [v.narrow(axis, 0, k), i.narrow(axis, 0, k)]


def _reduce(node, vals, ctx, fnp, ft):
    x = vals[0]
    if len(vals) > 1 and vals[1] is not None:
        axes = _int_list(vals[1])
    else:
        axes = node.attr("axes")
    keepdims = bool(node.attr("keepdims", 1))
    axes_t = tuple(int(a) for a in axes) if axes else None
    if axes_t is None and node.attr("noop_with_empty_axes", 0):
        return [x]
    if _static(x):
        return [fnp(np.asarray(x), axis=axes_t, keepdims=keepdims)]
    return [ft(x, axes_t if axes_t is not None else tuple(range(x.ndim)), keepdims)]


def _t_prod(x, axes, keepdim):
    for a in sorted((a % x.ndim for a in axes), reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


for _name, _np_fn, _t_fn in [
    ("ReduceMean", np.mean, lambda x, d, k: torch.mean(x, dim=d, keepdim=k)),
    ("ReduceSum", np.sum, lambda x, d, k: torch.sum(x, dim=d, keepdim=k)),
    ("ReduceMax", np.max, lambda x, d, k: torch.amax(x, dim=d, keepdim=k)),
    ("ReduceMin", np.min, lambda x, d, k: torch.amin(x, dim=d, keepdim=k)),
    ("ReduceProd", np.prod, _t_prod),
]:

    def _maker(fnp, ft):
        def op(node, vals, ctx):
            return _reduce(node, vals, ctx, fnp, ft)

        return op

    OP_REGISTRY[_name] = _maker(_np_fn, _t_fn)


@register("ReduceL2")
def op_reduce_l2(node, vals, ctx):
    x = _T(ctx, vals[0])
    axes = (
        tuple(_int_list(vals[1]))
        if len(vals) > 1 and vals[1] is not None
        else (tuple(node.attr("axes")) if node.attr("axes") else None)
    )
    keepdims = bool(node.attr("keepdims", 1))
    return [torch.sqrt(torch.sum(x * x, dim=axes if axes is not None else tuple(range(x.ndim)), keepdim=keepdims))]


# -- resize ------------------------------------------------------------------


def _resize_coords(out_size, in_size, scale, mode, device):
    """Output-pixel -> input-coordinate per ONNX coordinate_transformation_mode
    (the JAX lowering's own rule, in float32 on the device)."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if mode == "align_corners":
        if out_size == 1:
            return torch.zeros((1,), dtype=torch.float32, device=device)
        return i * (in_size - 1) / (out_size - 1)
    if mode == "asymmetric":
        return i / scale
    if mode == "pytorch_half_pixel":
        return (i + 0.5) / scale - 0.5 if out_size > 1 else torch.zeros((1,), dtype=torch.float32, device=device)
    # default: half_pixel
    return (i + 0.5) / scale - 0.5


def _static_operand(v):
    if isinstance(v, torch.Tensor):
        raise NotImplementedError("Resize scales/sizes computed on the device; they must be static")
    return v


@register("Resize")
def op_resize(node, vals, ctx):
    x = _T(ctx, vals[0])
    scales = vals[2] if len(vals) > 2 and vals[2] is not None and np.size(_static_operand(vals[2])) else None
    sizes = vals[3] if len(vals) > 3 and vals[3] is not None and np.size(_static_operand(vals[3])) else None
    mode = node.attr("mode", "nearest")
    coord_mode = node.attr("coordinate_transformation_mode", "half_pixel")
    nearest_mode = node.attr("nearest_mode", "round_prefer_floor")
    if isinstance(mode, bytes):
        mode = mode.decode()
    if isinstance(coord_mode, bytes):
        coord_mode = coord_mode.decode()
    if isinstance(nearest_mode, bytes):
        nearest_mode = nearest_mode.decode()

    in_shape = tuple(x.shape)
    if sizes is not None:
        out_shape = tuple(_int_list(sizes))
        eff_scales = [o / i for o, i in zip(out_shape, in_shape)]
    else:
        eff_scales = [float(s) for s in np.asarray(scales).reshape(-1)]
        out_shape = tuple(
            int(math.floor(i * s)) for i, s in zip(in_shape, eff_scales)
        )
    out = x
    for axis in range(x.ndim):
        if out_shape[axis] == in_shape[axis]:
            continue
        coords = _resize_coords(out_shape[axis], in_shape[axis], eff_scales[axis], coord_mode, x.device)
        if mode == "nearest":
            if nearest_mode == "floor":
                idx = torch.floor(coords)
            elif nearest_mode == "ceil":
                idx = torch.ceil(coords)
            elif nearest_mode == "round_prefer_ceil":
                idx = torch.floor(coords + 0.5)
            else:  # round_prefer_floor
                idx = torch.ceil(coords - 0.5)
            idx = torch.clamp(idx, 0, in_shape[axis] - 1).long()
            out = out.index_select(axis, idx)
        elif mode == "linear":
            c = torch.clamp(coords, 0.0, in_shape[axis] - 1)
            lo = torch.floor(c).long()
            hi = torch.clamp(lo + 1, 0, in_shape[axis] - 1)
            w = (c - lo).to(x.dtype)
            shape = [1] * out.ndim
            shape[axis] = -1
            w = w.reshape(shape)
            out = out.index_select(axis, lo) * (1 - w) + out.index_select(axis, hi) * w
        else:
            raise NotImplementedError(f"Resize mode {mode!r}")
    return [out]


@register("Upsample")
def op_upsample(node, vals, ctx):
    # Legacy (opset<10) alias of Resize with scales input/attr, asymmetric.
    from .proto import Attribute

    scales = vals[1] if len(vals) > 1 else np.asarray(node.attr("scales"), np.float32)
    fake = Node(op_type="Resize", name=node.name, inputs=node.inputs, outputs=node.outputs, attrs=dict(node.attrs))
    fake.attrs["coordinate_transformation_mode"] = Attribute(
        name="coordinate_transformation_mode", type=3, s=b"asymmetric"
    )
    fake.attrs["nearest_mode"] = Attribute(name="nearest_mode", type=3, s=b"floor")
    return op_resize(fake, [vals[0], None, scales], ctx)


@register("DepthToSpace")
def op_depth_to_space(node, vals, ctx):
    x = _T(ctx, vals[0])
    bs = node.attr("blocksize")
    b, c, h, w = x.shape
    if node.attr("mode", "DCR") == "DCR":
        x = x.reshape(b, bs, bs, c // (bs * bs), h, w)
        x = x.permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        x = x.reshape(b, c // (bs * bs), bs, bs, h, w)
        x = x.permute(0, 1, 4, 2, 5, 3)
    return [x.reshape(b, c // (bs * bs), h * bs, w * bs)]


@register("SpaceToDepth")
def op_space_to_depth(node, vals, ctx):
    x = _T(ctx, vals[0])
    bs = node.attr("blocksize")
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // bs, bs, w // bs, bs)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return [x.reshape(b, c * bs * bs, h // bs, w // bs)]


#: (op, input slot) pairs that read a value on the host: a float
#: initializer consumed only there stays a static constant, not a param
STATIC_SLOTS = {
    "Reshape": {1}, "Expand": {1}, "Tile": {1}, "Slice": {1, 2, 3, 4}, "Pad": {1, 2},
    "Squeeze": {1}, "Unsqueeze": {1}, "Split": {1}, "TopK": {1}, "Resize": {1, 2, 3},
    "Upsample": {1}, "ConstantOfShape": {0}, "Range": {0, 1, 2},
    "ReduceMean": {1}, "ReduceSum": {1}, "ReduceMax": {1}, "ReduceMin": {1}, "ReduceProd": {1},
    "ReduceL2": {1},
}
