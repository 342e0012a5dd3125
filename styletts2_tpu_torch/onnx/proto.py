"""ONNX protobuf wire encoding/decoding, from the onnx.proto3 schema.

The port's own copy of styletts2_tpu/onnx/proto.py (numpy and bytes only),
so that both packages write the same bytes for the same graph: the
producer name stays "styletts2_tpu". Only the messages/fields the exporter
emits are implemented, with a generic schema-driven decoder so tests can
round-trip files and external tools (netron, onnxruntime) load them
unchanged. Field numbers follow onnx/onnx.proto3 (IR version 9 / opset 19
era — all stable fields).

Same hand-rolled wire approach as tb_events.py (varints +
length-delimited submessages); no protoc or protobuf runtime needed.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------------------
# TensorProto.DataType (onnx.proto3)
# --------------------------------------------------------------------------

FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
STRING = 8
BOOL = 9
FLOAT16 = 10
DOUBLE = 11

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.int64): INT64,
    np.dtype(np.int32): INT32,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8

# --------------------------------------------------------------------------
# wire primitives
# --------------------------------------------------------------------------


def varint(n: int) -> bytes:
    if n < 0:  # proto int64 negatives are 10-byte two's-complement varints
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def field_varint(num: int, value: int) -> bytes:
    return varint(num << 3) + varint(value)


def field_bytes(num: int, value: bytes) -> bytes:
    return varint(num << 3 | 2) + varint(len(value)) + value


def field_string(num: int, value: str) -> bytes:
    return field_bytes(num, value.encode("utf-8"))


def field_float(num: int, value: float) -> bytes:
    return varint(num << 3 | 5) + struct.pack("<f", value)


def packed_int64s(num: int, values) -> bytes:
    payload = b"".join(varint(int(v)) for v in values)
    return field_bytes(num, payload)


def packed_floats(num: int, values) -> bytes:
    return field_bytes(num, struct.pack(f"<{len(values)}f", *values))


# --------------------------------------------------------------------------
# message encoders
# --------------------------------------------------------------------------


def tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto{dims=1, data_type=2, name=8, raw_data=9} (little-endian)."""
    arr = np.ascontiguousarray(arr)
    dt = NP_TO_ONNX[arr.dtype]
    out = b"".join(field_varint(1, d) for d in arr.shape)
    out += field_varint(2, dt)
    out += field_string(8, name)
    out += field_bytes(9, arr.tobytes())
    return out


def _shape_proto(dims) -> bytes:
    """TensorShapeProto{dim=1{dim_value=1 | dim_param=2}}."""
    out = b""
    for d in dims:
        if isinstance(d, str):
            dim = field_string(2, d)
        else:
            dim = field_varint(1, int(d))
        out += field_bytes(1, dim)
    return out


def value_info(name: str, elem_type: int, dims) -> bytes:
    """ValueInfoProto{name=1, type=2{tensor_type=1{elem_type=1, shape=2}}}."""
    tt = field_varint(1, elem_type) + field_bytes(2, _shape_proto(dims))
    tp = field_bytes(1, tt)
    return field_string(1, name) + field_bytes(2, tp)


def attribute(name: str, value: Any) -> bytes:
    """AttributeProto with the type tag ORT requires (type=20)."""
    out = field_string(1, name)
    if isinstance(value, bool):
        out += field_varint(3, int(value)) + field_varint(20, ATTR_INT)
    elif isinstance(value, int) or isinstance(value, np.integer):
        out += field_varint(3, int(value)) + field_varint(20, ATTR_INT)
    elif isinstance(value, float):
        out += field_float(2, value) + field_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        out += field_bytes(4, value.encode()) + field_varint(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += field_bytes(5, tensor("", value)) + field_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            out += b"".join(field_varint(8, int(v)) for v in value)
            out += field_varint(20, ATTR_INTS)
        elif all(isinstance(v, float) for v in value):
            out += b"".join(field_float(7, v) for v in value)
            out += field_varint(20, ATTR_FLOATS)
        elif all(isinstance(v, str) for v in value):
            out += b"".join(field_bytes(9, v.encode()) for v in value)
            out += field_varint(20, ATTR_STRINGS)
        else:
            raise TypeError(f"mixed attribute list {name}: {value!r}")
    else:
        raise TypeError(f"unsupported attribute {name}: {type(value)}")
    return out


def node(op_type: str, inputs: List[str], outputs: List[str],
         name: str = "", attrs: Optional[Dict[str, Any]] = None) -> bytes:
    """NodeProto{input=1, output=2, name=3, op_type=4, attribute=5}."""
    out = b"".join(field_string(1, i) for i in inputs)
    out += b"".join(field_string(2, o) for o in outputs)
    if name:
        out += field_string(3, name)
    out += field_string(4, op_type)
    for k, v in (attrs or {}).items():
        out += field_bytes(5, attribute(k, v))
    return out


def graph(name: str, nodes: List[bytes], initializers: List[bytes],
          inputs: List[bytes], outputs: List[bytes],
          value_infos: Optional[List[bytes]] = None) -> bytes:
    """GraphProto{node=1, name=2, initializer=5, input=11, output=12,
    value_info=13}."""
    out = b"".join(field_bytes(1, n) for n in nodes)
    out += field_string(2, name)
    out += b"".join(field_bytes(5, t) for t in initializers)
    out += b"".join(field_bytes(11, i) for i in inputs)
    out += b"".join(field_bytes(12, o) for o in outputs)
    out += b"".join(field_bytes(13, v) for v in (value_infos or []))
    return out


def model(graph_bytes: bytes, opset: int = 19, ir_version: int = 9,
          producer: str = "styletts2_tpu") -> bytes:
    """ModelProto{ir_version=1, producer_name=2, graph=7, opset_import=8}."""
    opset_id = field_varint(2, opset)  # OperatorSetIdProto{domain=1,version=2}
    return (field_varint(1, ir_version)
            + field_string(2, producer)
            + field_bytes(7, graph_bytes)
            + field_bytes(8, opset_id))


# --------------------------------------------------------------------------
# generic schema-driven decoder (for tests / the runtime)
# --------------------------------------------------------------------------

# message schemas: field number -> (name, kind); kind: 'msg:<schema>',
# 'int', 'float32', 'bytes', 'str'. Repeated-ness is implied: every decoded
# field becomes a list.
SCHEMAS: Dict[str, Dict[int, Tuple[str, str]]] = {
    "Model": {1: ("ir_version", "int"), 2: ("producer_name", "str"),
              7: ("graph", "msg:Graph"), 8: ("opset_import", "msg:Opset")},
    "Opset": {1: ("domain", "str"), 2: ("version", "int")},
    "Graph": {1: ("node", "msg:Node"), 2: ("name", "str"),
              5: ("initializer", "msg:Tensor"),
              11: ("input", "msg:ValueInfo"), 12: ("output", "msg:ValueInfo"),
              13: ("value_info", "msg:ValueInfo")},
    "Node": {1: ("input", "str"), 2: ("output", "str"), 3: ("name", "str"),
             4: ("op_type", "str"), 5: ("attribute", "msg:Attribute")},
    "Attribute": {1: ("name", "str"), 2: ("f", "float32"), 3: ("i", "int"),
                  4: ("s", "bytes"), 5: ("t", "msg:Tensor"),
                  7: ("floats", "float32"), 8: ("ints", "int"),
                  9: ("strings", "bytes"), 20: ("type", "int")},
    "Tensor": {1: ("dims", "int"), 2: ("data_type", "int"), 8: ("name", "str"),
               9: ("raw_data", "bytes"), 4: ("float_data", "float32"),
               7: ("int64_data", "int")},
    "ValueInfo": {1: ("name", "str"), 2: ("type", "msg:Type")},
    "Type": {1: ("tensor_type", "msg:TensorType")},
    "TensorType": {1: ("elem_type", "int"), 2: ("shape", "msg:Shape")},
    "Shape": {1: ("dim", "msg:Dim")},
    "Dim": {1: ("dim_value", "int"), 2: ("dim_param", "str")},
}


def decode(data: bytes, schema: str = "Model") -> Dict[str, List[Any]]:
    """Decode a message into {field_name: [values...]} per SCHEMAS."""
    fields = SCHEMAS[schema]
    out: Dict[str, List[Any]] = {}
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        fnum, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
            if val >= 1 << 63:
                val -= 1 << 64
            payload: Any = val
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            payload = data[pos: pos + ln]
            pos += ln
        elif wire == 5:
            payload = struct.unpack("<f", data[pos: pos + 4])[0]
            pos += 4
        elif wire == 1:
            payload = struct.unpack("<d", data[pos: pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if fnum not in fields:
            continue  # unknown field: skip (forward compat)
        fname, kind = fields[fnum]
        if kind.startswith("msg:"):
            val = decode(payload, kind[4:])
        elif kind == "str":
            val = payload.decode("utf-8")
        elif kind == "int" and wire == 2:  # packed ints
            val, p2 = [], 0
            while p2 < len(payload):
                v, p2 = _read_varint(payload, p2)
                val.append(v)
            out.setdefault(fname, []).extend(val)
            continue
        else:
            val = payload
        out.setdefault(fname, []).append(val)
    return out


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def tensor_to_numpy(t: Dict[str, List[Any]]) -> np.ndarray:
    dims = [int(d) for d in t.get("dims", [])]
    dt = ONNX_TO_NP[t["data_type"][0]]
    if "raw_data" in t:
        arr = np.frombuffer(t["raw_data"][0], dtype=dt)
    elif "float_data" in t:
        arr = np.asarray(t["float_data"], np.float32)
    elif "int64_data" in t:
        arr = np.asarray(t["int64_data"], np.int64)
    else:
        arr = np.zeros(0, dt)
    return arr.reshape(dims).astype(dt)


def attr_value(a: Dict[str, List[Any]]) -> Any:
    t = a["type"][0]
    if t == ATTR_INT:
        return int(a["i"][0])
    if t == ATTR_FLOAT:
        return float(a["f"][0])
    if t == ATTR_STRING:
        return a["s"][0].decode("utf-8")
    if t == ATTR_INTS:
        return [int(v) for v in a.get("ints", [])]
    if t == ATTR_FLOATS:
        return [float(v) for v in a.get("floats", [])]
    if t == ATTR_STRINGS:
        return [v.decode("utf-8") for v in a.get("strings", [])]
    if t == ATTR_TENSOR:
        return tensor_to_numpy(a["t"][0])
    raise ValueError(f"unsupported attribute type {t}")
