"""Minimal ONNX protobuf wire codec — no `onnx`/`protobuf` dependency
(the port's own copy of `incubator_mxnet_tpu/contrib/onnx_proto.py`,
numpy only, so both packages write the same bytes).

The ONNX model format is ordinary protobuf (onnx/onnx.proto3).  This
module hand-encodes/decodes exactly the message subset the converter in
`contrib/onnx.py` needs: ModelProto, GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto (+TypeProto/TensorShapeProto)
and OperatorSetIdProto.  Field numbers below are copied from the public
onnx.proto3 schema; messages are represented as plain dicts.

Wire format refresher: each field is a key varint
``(field_number << 3) | wire_type`` followed by the payload.  Wire types
used by ONNX: 0 = varint, 2 = length-delimited (strings, bytes, nested
messages, packed arrays), 5 = 32-bit (float).
"""
from __future__ import annotations

import struct

import numpy as np

# -- TensorProto.DataType enum (onnx.proto3) --------------------------------
DT_FLOAT, DT_UINT8, DT_INT8, DT_UINT16, DT_INT16, DT_INT32, DT_INT64, \
    DT_STRING, DT_BOOL, DT_FLOAT16, DT_DOUBLE, DT_UINT32, DT_UINT64 = range(1, 14)
DT_BFLOAT16 = 16

NP_TO_ONNX = {
    np.dtype(np.float32): DT_FLOAT, np.dtype(np.float64): DT_DOUBLE,
    np.dtype(np.float16): DT_FLOAT16, np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.int8): DT_INT8, np.dtype(np.int16): DT_INT16,
    np.dtype(np.int32): DT_INT32, np.dtype(np.int64): DT_INT64,
    np.dtype(np.bool_): DT_BOOL, np.dtype(np.uint16): DT_UINT16,
    np.dtype(np.uint32): DT_UINT32, np.dtype(np.uint64): DT_UINT64,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}
try:                                     # bf16 where ml_dtypes imports
    import ml_dtypes as _mld
    NP_TO_ONNX[np.dtype(_mld.bfloat16)] = DT_BFLOAT16
    ONNX_TO_NP[DT_BFLOAT16] = np.dtype(_mld.bfloat16)
except ImportError:                      # pragma: no cover
    pass

# -- AttributeProto.AttributeType enum --------------------------------------
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_GRAPH = 1, 2, 3, 4, 5
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


# ===========================================================================
# low-level writer
# ===========================================================================

def _varint(n):
    """Unsigned LEB128; negative ints are encoded as 64-bit two's
    complement (protobuf int64 semantics)."""
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


def _tag(field, wire):
    return _varint((field << 3) | wire)


def _field_varint(field, value):
    return _tag(field, 0) + _varint(int(value))


def _field_bytes(field, data):
    if isinstance(data, str):
        data = data.encode("utf-8")
    return _tag(field, 2) + _varint(len(data)) + data


def _field_float(field, value):
    return _tag(field, 5) + struct.pack("<f", float(value))


def _packed_int64(field, values):
    payload = b"".join(_varint(int(v)) for v in values)
    return _field_bytes(field, payload)


def _packed_float(field, values):
    return _field_bytes(field, struct.pack(f"<{len(values)}f", *values))


# ===========================================================================
# message encoders (dict → bytes)
# ===========================================================================

def encode_tensor(t):
    """TensorProto: {name, array} — always raw_data little-endian."""
    arr = np.ascontiguousarray(t["array"])
    out = b""
    if arr.shape:
        out += _packed_int64(1, arr.shape)          # dims
    out += _field_varint(2, NP_TO_ONNX[arr.dtype])  # data_type
    out += _field_bytes(8, t["name"])               # name
    out += _field_bytes(9, arr.tobytes())           # raw_data
    return out


def encode_attribute(a):
    """AttributeProto: {name, type, value}."""
    out = _field_bytes(1, a["name"])
    typ, val = a["type"], a["value"]
    if typ == AT_FLOAT:
        out += _field_float(2, val)
    elif typ == AT_INT:
        out += _field_varint(3, val)
    elif typ == AT_STRING:
        out += _field_bytes(4, val)
    elif typ == AT_TENSOR:
        out += _field_bytes(5, encode_tensor(val))
    elif typ == AT_FLOATS:
        for v in val:                                # not packed in onnx
            out += _field_float(7, v)
    elif typ == AT_INTS:
        for v in val:
            out += _field_varint(8, v)
    elif typ == AT_STRINGS:
        for v in val:
            out += _field_bytes(9, v)
    else:
        raise ValueError(f"unsupported attribute type {typ}")
    out += _field_varint(20, typ)
    return out


def encode_node(n):
    """NodeProto: {op_type, name, inputs, outputs, attributes}."""
    out = b""
    for i in n.get("inputs", ()):
        out += _field_bytes(1, i)
    for o in n.get("outputs", ()):
        out += _field_bytes(2, o)
    out += _field_bytes(3, n.get("name", ""))
    out += _field_bytes(4, n["op_type"])
    for a in n.get("attributes", ()):
        out += _field_bytes(5, encode_attribute(a))
    if n.get("domain"):
        out += _field_bytes(7, n["domain"])
    return out


def encode_value_info(v):
    """ValueInfoProto: {name, elem_type, shape} (shape entries: int or
    str dim_param)."""
    dims = b""
    for d in v.get("shape", ()):
        if isinstance(d, str):
            dim = _field_bytes(2, d)                 # dim_param
        else:
            dim = _field_varint(1, d)                # dim_value
        dims += _field_bytes(1, dim)                 # TensorShapeProto.dim
    tensor_type = _field_varint(1, v["elem_type"]) + _field_bytes(2, dims)
    type_proto = _field_bytes(1, tensor_type)        # TypeProto.tensor_type
    return _field_bytes(1, v["name"]) + _field_bytes(2, type_proto)


def encode_graph(g):
    """GraphProto: {name, nodes, inputs, outputs, initializers}."""
    out = b""
    for n in g.get("nodes", ()):
        out += _field_bytes(1, encode_node(n))
    out += _field_bytes(2, g.get("name", "graph"))
    for t in g.get("initializers", ()):
        out += _field_bytes(5, encode_tensor(t))
    for v in g.get("inputs", ()):
        out += _field_bytes(11, encode_value_info(v))
    for v in g.get("outputs", ()):
        out += _field_bytes(12, encode_value_info(v))
    return out


def encode_model(m):
    """ModelProto: {graph, opset, producer_name, ir_version}."""
    out = _field_varint(1, m.get("ir_version", 8))
    opset = b""
    if m.get("opset_domain"):
        opset += _field_bytes(1, m["opset_domain"])
    opset += _field_varint(2, m.get("opset", 13))
    out += _field_bytes(8, opset)                    # opset_import
    out += _field_bytes(2, m.get("producer_name", "incubator_mxnet_tpu"))
    out += _field_bytes(3, m.get("producer_version", "1.0"))
    out += _field_bytes(7, encode_graph(m["graph"]))
    return out


# ===========================================================================
# low-level reader
# ===========================================================================

def _read_varint(buf, pos):
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return result, pos


def _signed64(n):
    return n - (1 << 64) if n >= (1 << 63) else n


def parse_fields(buf):
    """Generic protobuf scan: returns {field: [raw values]} where raw is
    int for varints, bytes for length-delimited, 4/8-byte bytes for
    fixed-width."""
    fields = {}
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
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def _one(fields, num, default=None):
    return fields[num][-1] if num in fields else default


def _text(v, default=""):
    return v.decode("utf-8") if v is not None else default


def _ints(fields, num):
    """Repeated int64 — accepts both packed and unpacked encodings."""
    out = []
    for v in fields.get(num, ()):
        if isinstance(v, int):
            out.append(_signed64(v))
        else:                                        # packed payload
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(_signed64(x))
    return out


def _floats(fields, num):
    out = []
    for v in fields.get(num, ()):
        if isinstance(v, bytes) and len(v) == 4:
            out.append(struct.unpack("<f", v)[0])
        elif isinstance(v, bytes):                   # packed
            out.extend(struct.unpack(f"<{len(v) // 4}f", v))
    return out


def decode_tensor(buf):
    f = parse_fields(buf)
    dims = tuple(_ints(f, 1))
    dtype_code = _one(f, 2, DT_FLOAT)
    np_dtype = ONNX_TO_NP.get(dtype_code)
    name = _text(_one(f, 8))
    raw = _one(f, 9)
    if raw is not None and np_dtype is not None:
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims).copy()
    elif 4 in f:                                     # float_data
        arr = np.array(_floats(f, 4), np.float32).reshape(dims)
    elif 7 in f:                                     # int64_data
        arr = np.array(_ints(f, 7), np.int64).reshape(dims)
    elif 5 in f:                                     # int32_data
        arr = np.array(_ints(f, 5), np.int32).reshape(dims)
    else:
        arr = np.zeros(dims, np.float32)
    return {"name": name, "array": arr, "data_type": dtype_code}


def decode_attribute(buf):
    f = parse_fields(buf)
    name = _text(_one(f, 1))
    typ = _one(f, 20)
    # type field may be absent in old producers — infer from payload
    if typ is None:
        for num, t in ((2, AT_FLOAT), (3, AT_INT), (4, AT_STRING),
                       (5, AT_TENSOR), (7, AT_FLOATS), (8, AT_INTS),
                       (9, AT_STRINGS)):
            if num in f:
                typ = t
                break
    if typ == AT_FLOAT:
        val = _floats(f, 2)[0]
    elif typ == AT_INT:
        val = _signed64(_one(f, 3, 0))
    elif typ == AT_STRING:
        val = _text(_one(f, 4))
    elif typ == AT_TENSOR:
        val = decode_tensor(_one(f, 5))
    elif typ == AT_FLOATS:
        val = _floats(f, 7)
    elif typ == AT_INTS:
        val = _ints(f, 8)
    elif typ == AT_STRINGS:
        val = [_text(s) for s in f.get(9, ())]
    else:
        val = None
    return {"name": name, "type": typ, "value": val}


def decode_node(buf):
    f = parse_fields(buf)
    return {
        "inputs": [_text(v) for v in f.get(1, ())],
        "outputs": [_text(v) for v in f.get(2, ())],
        "name": _text(_one(f, 3)),
        "op_type": _text(_one(f, 4)),
        "attributes": {a["name"]: a for a in
                       (decode_attribute(v) for v in f.get(5, ()))},
    }


def decode_value_info(buf):
    f = parse_fields(buf)
    name = _text(_one(f, 1))
    elem_type, shape = DT_FLOAT, []
    tp = _one(f, 2)
    if tp is not None:
        tpf = parse_fields(tp)
        tt = _one(tpf, 1)
        if tt is not None:
            ttf = parse_fields(tt)
            elem_type = _one(ttf, 1, DT_FLOAT)
            sh = _one(ttf, 2)
            if sh is not None:
                for dim_buf in parse_fields(sh).get(1, ()):
                    df = parse_fields(dim_buf)
                    if 1 in df:
                        shape.append(_signed64(_one(df, 1)))
                    else:
                        shape.append(_text(_one(df, 2)))
    return {"name": name, "elem_type": elem_type, "shape": shape}


def decode_graph(buf):
    f = parse_fields(buf)
    return {
        "name": _text(_one(f, 2)),
        "nodes": [decode_node(v) for v in f.get(1, ())],
        "initializers": [decode_tensor(v) for v in f.get(5, ())],
        "inputs": [decode_value_info(v) for v in f.get(11, ())],
        "outputs": [decode_value_info(v) for v in f.get(12, ())],
    }


def decode_model(buf):
    f = parse_fields(buf)
    opset = 13
    for v in f.get(8, ()):
        of = parse_fields(v)
        if not _text(_one(of, 1)):                   # default ai.onnx domain
            opset = _one(of, 2, 13)
    return {
        "ir_version": _one(f, 1, 0),
        "producer_name": _text(_one(f, 2)),
        "opset": opset,
        "graph": decode_graph(_one(f, 7, b"")),
    }
