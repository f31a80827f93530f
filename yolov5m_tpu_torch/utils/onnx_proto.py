"""Minimal ONNX protobuf writer and reader, with no `onnx` package.

The port's own copy of ``yolov5m_tpu/utils/onnx_proto.py`` (which has no
JAX in it). ONNX files are plain protobufs, so this module hand-encodes
the protobuf wire format (varints and length-delimited submessages) for
the subset of onnx.proto a YOLOv5 graph needs: ModelProto, GraphProto,
NodeProto, AttributeProto, TensorProto, ValueInfoProto/TypeProto. Field
numbers follow the public onnx.proto schema (IR v6, opset 11). The
producer name stays the JAX package's, so both write the same bytes for
the same weights. A small decoder reads the files back for the tests.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

# onnx TensorProto.DataType
FLOAT = 1
INT64 = 7

# onnx AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


def _varint(n: int) -> bytes:
    """Unsigned LEB128; negative ints use 64-bit two's complement (proto)."""
    if n < 0:
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def f_str(field: int, value: str) -> bytes:
    return f_bytes(field, value.encode("utf-8"))


def f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def f_packed_int64(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return f_bytes(field, payload)


def f_packed_float(field: int, values: Sequence[float]) -> bytes:
    payload = b"".join(struct.pack("<f", float(v)) for v in values)
    return f_bytes(field, payload)


# ---------------------------------------------------------------- messages


def tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, raw_data=9, name=8."""
    a = np.asarray(array)
    if a.dtype == np.float32:
        dt = FLOAT
    elif a.dtype == np.int64:
        dt = INT64
    else:
        raise TypeError(f"unsupported tensor dtype {a.dtype}")
    msg = f_packed_int64(1, a.shape)
    msg += f_varint(2, dt)
    msg += f_str(8, name)
    msg += f_bytes(9, np.ascontiguousarray(a).tobytes())
    return msg


def attr_int(name: str, value: int) -> bytes:
    return f_str(1, name) + f_varint(3, value) + f_varint(20, ATTR_INT)


def attr_float(name: str, value: float) -> bytes:
    return f_str(1, name) + f_float(2, value) + f_varint(20, ATTR_FLOAT)


def attr_string(name: str, value: str) -> bytes:
    return f_str(1, name) + f_bytes(4, value.encode()) + f_varint(20, ATTR_STRING)


def attr_ints(name: str, values: Sequence[int]) -> bytes:
    return f_str(1, name) + f_packed_int64(8, values) + f_varint(20, ATTR_INTS)


def attr_floats(name: str, values: Sequence[float]) -> bytes:
    return f_str(1, name) + f_packed_float(7, values) + f_varint(20, ATTR_FLOATS)


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    msg = b"".join(f_str(1, i) for i in inputs)
    msg += b"".join(f_str(2, o) for o in outputs)
    if name:
        msg += f_str(3, name)
    msg += f_str(4, op_type)
    msg += b"".join(f_bytes(5, a) for a in attrs)
    return msg


def value_info(name: str, shape: Sequence[Optional[int]],
               elem_type: int = FLOAT) -> bytes:
    """ValueInfoProto: name=1, type=2 (TypeProto.tensor_type=1:
    {elem_type=1, shape=2: TensorShapeProto.dim=1 {dim_value=1 |
    dim_param=2}}). None dims become a symbolic dim_param (the standard
    ONNX dynamic-batch idiom the Optional hint invites)."""
    dims = b""
    for i, d in enumerate(shape):
        if d is None:                                  # Dimension.dim_param
            dims += f_bytes(1, f_str(2, f"dyn_{i}"))
        else:
            dims += f_bytes(1, f_varint(1, int(d)))    # Dimension.dim_value
    shape_msg = dims
    tensor_type = f_varint(1, elem_type) + f_bytes(2, shape_msg)
    type_proto = f_bytes(1, tensor_type)
    return f_str(1, name) + f_bytes(2, type_proto)


def graph(nodes: Sequence[bytes], name: str, initializers: Sequence[bytes],
          inputs: Sequence[bytes], outputs: Sequence[bytes]) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    msg = b"".join(f_bytes(1, n) for n in nodes)
    msg += f_str(2, name)
    msg += b"".join(f_bytes(5, t) for t in initializers)
    msg += b"".join(f_bytes(11, i) for i in inputs)
    msg += b"".join(f_bytes(12, o) for o in outputs)
    return msg


def model(graph_msg: bytes, opset: int = 11,
          producer: str = "yolov5m_tpu") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8."""
    opset_id = f_varint(2, opset)                      # OperatorSetIdProto
    msg = f_varint(1, 6)                               # IR v6 (opset-11 era)
    msg += f_str(2, producer)
    msg += f_bytes(7, graph_msg)
    msg += f_bytes(8, opset_id)
    return msg


# ------------------------------------------------------------ mini decoder
# Enough structure-awareness to verify our own output in tests without the
# onnx package: walks submessages and extracts node op_types/names.


def _read_varint(buf: bytes, pos: int):
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def decode_fields(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int) triples."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _decode_packed_int64(val) -> list:
    if isinstance(val, int):          # unpacked single element
        return [val]
    out, pos = [], 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _decode_tensor(buf: bytes):
    name, dims, dtype, raw = "", [], FLOAT, b""
    for field, _, val in decode_fields(buf):
        if field == 1:
            dims += _decode_packed_int64(val)
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    np_dt = np.float32 if dtype == FLOAT else np.int64
    return name, np.frombuffer(raw, np_dt).reshape(dims)


def _decode_attr(buf: bytes):
    name, atype = "", None
    raw = {}
    for field, wire, val in decode_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 20:
            atype = val
        else:
            raw.setdefault(field, []).append((wire, val))
    if atype == ATTR_INT:
        value = raw[3][0][1]
    elif atype == ATTR_FLOAT:
        value = struct.unpack("<f", raw[2][0][1])[0]
    elif atype == ATTR_STRING:
        value = raw[4][0][1].decode()
    elif atype == ATTR_INTS:
        value = []
        for wire, v in raw.get(8, []):
            value += _decode_packed_int64(v) if wire == 2 else [v]
    elif atype == ATTR_FLOATS:
        value = []
        for _, v in raw.get(7, []):
            value += list(np.frombuffer(v, np.float32))
    else:  # pragma: no cover
        raise ValueError(f"attr type {atype} not supported")
    return name, value


def _decode_node(buf: bytes) -> dict:
    n = {"inputs": [], "outputs": [], "name": "", "op": "", "attrs": {}}
    for field, _, val in decode_fields(buf):
        if field == 1:
            n["inputs"].append(val.decode())
        elif field == 2:
            n["outputs"].append(val.decode())
        elif field == 3:
            n["name"] = val.decode()
        elif field == 4:
            n["op"] = val.decode()
        elif field == 5:
            k, v = _decode_attr(val)
            n["attrs"][k] = v
    return n


def _decode_value_info_name(buf: bytes) -> str:
    for field, _, val in decode_fields(buf):
        if field == 1:
            return val.decode()
    return ""


def decode_model(blob: bytes) -> dict:
    """Full subset decode of a serialized ModelProto: nodes with attrs,
    initializer arrays, graph input/output names. Lets tests execute the
    exported graph with an independent runtime (e.g. torch) — no onnx pkg."""
    out = {"nodes": [], "inits": {}, "inputs": [], "outputs": []}
    for field, _, val in decode_fields(blob):
        if field == 1:
            out["ir_version"] = val
        elif field == 8:
            for f2, _, v2 in decode_fields(val):
                if f2 == 2:
                    out["opset"] = v2
        elif field == 7:
            for f2, _, v2 in decode_fields(val):
                if f2 == 1:
                    out["nodes"].append(_decode_node(v2))
                elif f2 == 5:
                    name, arr = _decode_tensor(v2)
                    out["inits"][name] = arr
                elif f2 in (11, 12):
                    key = "inputs" if f2 == 11 else "outputs"
                    out[key].append(_decode_value_info_name(v2))
    return out


def summarize_model(blob: bytes) -> dict:
    """Light structural summary for assertions."""
    m = decode_model(blob)
    return {
        "ir_version": m.get("ir_version"),
        "opset": m.get("opset"),
        "ops": [(n["op"], n["name"]) for n in m["nodes"]],
        "n_inits": len(m["inits"]),
        "inputs": m["inputs"],
        "outputs": m["outputs"],
    }
