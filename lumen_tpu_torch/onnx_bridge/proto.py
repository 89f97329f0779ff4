"""Minimal ONNX protobuf reader (hand-rolled wire-format decoder).

The reference ships its face/OCR model zoo as ONNX graphs and runs them
through onnxruntime (e.g. ``packages/lumen-face/src/lumen_face/backends/
onnxrt_backend.py:485-745``). This image has neither ``onnx`` nor
``onnxruntime``, and depending on them would defeat the point anyway — we
want the weights *inside* XLA, not behind a foreign runtime. So this module
decodes the small subset of the ONNX protobuf schema the bridge needs
(graph topology, node attributes, initializer tensors) straight from the
wire format: ~200 lines instead of a protobuf toolchain.

Field numbers follow the public ``onnx.proto3`` schema. Only fields the
executor consumes are decoded; unknown fields are skipped by wire type.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# -- wire-format primitives --------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _skip_field(buf: memoryview, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == 1:
        return pos + 8
    if wire_type == 2:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == 5:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a message buffer.
    Length-delimited values come back as memoryview; varints as int;
    fixed32/64 as raw bytes."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wt == 2:
            n, pos = _read_varint(buf, pos)
            val = buf[pos : pos + n]
            pos += n
        elif wt == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, val


def _packed_ints(val, wt) -> list[int]:
    """Repeated int field: packed (length-delimited) or a single varint."""
    if wt == 0:
        return [val]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _zigzag_signed(v: int, bits: int = 64) -> int:
    """Interpret a varint as two's-complement signed (ONNX ints are int64
    encoded as plain varints, negatives use 10 bytes)."""
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


# -- decoded message types ---------------------------------------------------

# TensorProto.DataType -> numpy dtype
TENSOR_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}
BFLOAT16_DTYPE = 16  # handled specially (numpy has no bfloat16)


@dataclass
class Attribute:
    name: str
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: "TensorValue | None" = None
    floats: list[float] = field(default_factory=list)
    ints: list[int] = field(default_factory=list)
    strings: list[bytes] = field(default_factory=list)

    @property
    def value(self):
        # AttributeProto.AttributeType: FLOAT=1 INT=2 STRING=3 TENSOR=4
        # FLOATS=6 INTS=7 STRINGS=8
        return {
            1: self.f,
            2: self.i,
            3: self.s.decode(errors="replace"),
            4: self.t,
            6: self.floats,
            7: self.ints,
            8: [s.decode(errors="replace") for s in self.strings],
        }.get(self.type)


@dataclass
class TensorValue:
    name: str
    array: np.ndarray


@dataclass
class Node:
    op_type: str
    name: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Attribute]

    def attr(self, name: str, default=None):
        a = self.attrs.get(name)
        return a.value if a is not None else default


@dataclass
class ValueInfo:
    name: str
    dtype: int | None = None  # TensorProto.DataType
    shape: list[int | str | None] = field(default_factory=list)


@dataclass
class OnnxGraph:
    name: str
    nodes: list[Node]
    initializers: dict[str, np.ndarray]
    inputs: list[ValueInfo]  # graph inputs EXCLUDING initializers
    outputs: list[ValueInfo]
    opset: int


# -- message decoders --------------------------------------------------------


def _decode_tensor(buf: memoryview) -> TensorValue:
    dims: list[int] = []
    data_type = 1
    raw: bytes | None = None
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    double_data: list[float] = []
    uint64_data: list[int] = []
    name = ""
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            dims.extend(_zigzag_signed(v) for v in _packed_ints(val, wt))
        elif fnum == 2:
            data_type = val
        elif fnum == 4:  # packed floats
            float_data.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
        elif fnum == 5:
            int32_data.extend(_zigzag_signed(v, 32) for v in _packed_ints(val, wt))
        elif fnum == 7:
            int64_data.extend(_zigzag_signed(v) for v in _packed_ints(val, wt))
        elif fnum == 8:
            name = bytes(val).decode()
        elif fnum == 9:
            raw = bytes(val)
        elif fnum == 10:
            double_data.extend(struct.unpack(f"<{len(val) // 8}d", bytes(val)))
        elif fnum == 11:
            uint64_data.extend(_packed_ints(val, wt))
        elif fnum == 13:
            raise ValueError(f"tensor {name!r} uses external data (unsupported)")
    shape = tuple(dims)
    if raw is not None:
        if data_type == BFLOAT16_DTYPE:
            # decode bfloat16 -> float32 via bit-shift
            u16 = np.frombuffer(raw, dtype=np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32).reshape(shape)
        else:
            np_dtype = TENSOR_DTYPES.get(data_type)
            if np_dtype is None:
                raise ValueError(f"tensor {name!r}: unsupported data_type {data_type}")
            arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    elif float_data:
        arr = np.asarray(float_data, np.float32).reshape(shape)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64).reshape(shape)
    elif int32_data:
        np_dtype = TENSOR_DTYPES.get(data_type, np.int32)
        arr = np.asarray(int32_data).astype(np_dtype).reshape(shape)
    elif double_data:
        arr = np.asarray(double_data, np.float64).reshape(shape)
    elif uint64_data:
        arr = np.asarray(uint64_data, np.uint64).reshape(shape)
    else:
        np_dtype = TENSOR_DTYPES.get(data_type, np.float32)
        arr = np.zeros(shape, np_dtype)
    return TensorValue(name=name, array=arr)


def _decode_attribute(buf: memoryview) -> Attribute:
    a = Attribute(name="")
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            a.name = bytes(val).decode()
        elif fnum == 2:
            a.f = struct.unpack("<f", val)[0]
        elif fnum == 3:
            a.i = _zigzag_signed(val)
        elif fnum == 4:
            a.s = bytes(val)
        elif fnum == 5:
            a.t = _decode_tensor(val)
        elif fnum == 7:
            if wt == 2:
                a.floats.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
            else:
                a.floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            a.ints.extend(_zigzag_signed(v) for v in _packed_ints(val, wt))
        elif fnum == 9:
            a.strings.append(bytes(val))
        elif fnum == 20:
            a.type = val
    if a.type == 0:
        # Exporters may omit type; infer from populated field.
        if a.floats:
            a.type = 6
        elif a.ints:
            a.type = 7
        elif a.strings:
            a.type = 8
        elif a.t is not None:
            a.type = 4
        elif a.s:
            a.type = 3
        elif a.f:
            a.type = 1
        else:
            a.type = 2
    return a


def _decode_node(buf: memoryview) -> Node:
    inputs: list[str] = []
    outputs: list[str] = []
    name = ""
    op_type = ""
    attrs: dict[str, Attribute] = {}
    for fnum, _wt, val in _iter_fields(buf):
        if fnum == 1:
            inputs.append(bytes(val).decode())
        elif fnum == 2:
            outputs.append(bytes(val).decode())
        elif fnum == 3:
            name = bytes(val).decode()
        elif fnum == 4:
            op_type = bytes(val).decode()
        elif fnum == 5:
            a = _decode_attribute(val)
            attrs[a.name] = a
    return Node(op_type=op_type, name=name, inputs=inputs, outputs=outputs, attrs=attrs)


def _decode_value_info(buf: memoryview) -> ValueInfo:
    vi = ValueInfo(name="")
    for fnum, _wt, val in _iter_fields(buf):
        if fnum == 1:
            vi.name = bytes(val).decode()
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 1:
                            vi.dtype = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim_val: int | str | None = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim_val = _zigzag_signed(v5)
                                        elif f5 == 2:
                                            dim_val = bytes(v5).decode()
                                    vi.shape.append(dim_val)
    return vi


def _decode_graph(buf: memoryview, opset: int) -> OnnxGraph:
    nodes: list[Node] = []
    initializers: dict[str, np.ndarray] = {}
    inputs: list[ValueInfo] = []
    outputs: list[ValueInfo] = []
    name = ""
    for fnum, _wt, val in _iter_fields(buf):
        if fnum == 1:
            nodes.append(_decode_node(val))
        elif fnum == 2:
            name = bytes(val).decode()
        elif fnum == 5:
            t = _decode_tensor(val)
            initializers[t.name] = t.array
        elif fnum == 11:
            inputs.append(_decode_value_info(val))
        elif fnum == 12:
            outputs.append(_decode_value_info(val))
    inputs = [vi for vi in inputs if vi.name not in initializers]
    return OnnxGraph(
        name=name, nodes=nodes, initializers=initializers, inputs=inputs, outputs=outputs, opset=opset
    )


def parse_onnx(data: bytes) -> OnnxGraph:
    """Decode a serialized ``ModelProto`` into an :class:`OnnxGraph`."""
    buf = memoryview(data)
    graph_buf: memoryview | None = None
    opset = 13
    for fnum, _wt, val in _iter_fields(buf):
        if fnum == 7:
            graph_buf = val
        elif fnum == 8:  # OperatorSetIdProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1 and bytes(v2):  # non-default domain
                    break
                if f2 == 2:
                    opset = v2
    if graph_buf is None:
        raise ValueError("no graph in ONNX model")
    return _decode_graph(graph_buf, opset)


def load_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        return parse_onnx(f.read())
