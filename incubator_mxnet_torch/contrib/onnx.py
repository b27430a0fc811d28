"""ONNX export/import (counterpart of
`incubator_mxnet_tpu/contrib/onnx.py`; ref: python/mxnet/contrib/onnx/ —
mx2onnx MXNetGraph.create_onnx_graph_proto + onnx2mx
GraphProto.from_onnx [U]).

No `onnx` python package is needed: the wire format is produced and
consumed by the hand-rolled protobuf codec in `onnx_proto.py`.  The
emitted files are standard ONNX (ir_version 8, default opset 13), and
the same converters on the port's `symbol` give the same bytes as the
JAX package's export of the same graph and parameters (the graph and
the producer keep that package's names, `mxnet_tpu_exported` and
`incubator_mxnet_tpu`).  `import_model` reads files
produced by other exporters; the imported parameters land on the
current context (the card unless the caller asks for the CPU).

Public API mirrors the reference:
  export_model(sym, params, input_shape, input_type, onnx_file_path)
  import_model(model_file) -> (sym, arg_params, aux_params)
  import_to_gluon(model_file, ctx=None) -> SymbolBlock
  get_model_metadata(model_file)
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError
from . import onnx_proto as P

__all__ = ["export_model", "import_model", "import_to_gluon",
           "get_model_metadata"]


# ===========================================================================
# export: Symbol graph → ONNX GraphProto
# ===========================================================================

def _const_value(node):
    """A `_const` node's value on the host (graph constants are tensors,
    possibly on the card)."""
    from ..ndarray.ndarray import to_numpy
    return to_numpy(node._attrs["__value__"])


class _ExportCtx:
    def __init__(self, params):
        self.params = params          # name -> np.ndarray
        self.nodes = []               # NodeProto dicts, topo order
        self.initializers = {}        # name -> np.ndarray
        self.shape_map = {}           # (id(base), out_index) -> shape
        self.counter = 0

    def shape_of(self, sym):
        """Inferred shape of a Symbol input (None when unknown)."""
        base = sym._base or sym
        return self.shape_map.get((id(base), sym._out_index))

    def uniq(self, base):
        self.counter += 1
        return f"{base}__{self.counter}"

    def add_init(self, name, array):
        self.initializers[name] = _np.asarray(array)
        return name

    def emit(self, op_type, inputs, outputs, name=None, **attrs):
        self.nodes.append({
            "op_type": op_type,
            "name": name or self.uniq(op_type.lower()),
            "inputs": list(inputs),
            "outputs": list(outputs),
            "attributes": _encode_attrs(attrs),
        })
        return outputs[0] if outputs else None


def _encode_attrs(attrs):
    out = []
    for k, v in attrs.items():
        if v is None:
            continue
        if isinstance(v, bool):
            out.append({"name": k, "type": P.AT_INT, "value": int(v)})
        elif isinstance(v, int):
            out.append({"name": k, "type": P.AT_INT, "value": v})
        elif isinstance(v, float):
            out.append({"name": k, "type": P.AT_FLOAT, "value": v})
        elif isinstance(v, str):
            out.append({"name": k, "type": P.AT_STRING, "value": v})
        elif isinstance(v, (tuple, list)) and all(
                isinstance(x, (int, bool)) for x in v):
            out.append({"name": k, "type": P.AT_INTS,
                        "value": [int(x) for x in v]})
        elif isinstance(v, (tuple, list)):
            out.append({"name": k, "type": P.AT_FLOATS,
                        "value": [float(x) for x in v]})
        else:
            raise MXNetError(f"cannot encode ONNX attribute {k}={v!r}")
    return out


def _slot_map(node, op):
    """input-name → Symbol for a graph node (honors __present__)."""
    present = node._attrs.get("__present__") or (True,) * len(node._inputs)
    slots = [i for i, p in enumerate(present) if p]
    mapping = {}
    for slot, inp in zip(slots, node._inputs):
        if slot < len(op.input_names):
            mapping[op.input_names[slot]] = inp
        else:
            mapping.setdefault("__extra__", []).append(inp)
    return mapping


def _attr(node, op, name, default=None):
    if name in node._attrs:
        return node._attrs[name]
    return op.attr_defaults.get(name, default)


def _tup(v, n=None):
    if v is None or v == ():
        return None
    if isinstance(v, int):
        return (v,) * (n or 1)
    return tuple(int(x) for x in v)


# -- per-op converters ------------------------------------------------------
# each: fn(ctx, node, op, ins, out_names) where ins maps input-name →
# onnx tensor name; returns nothing (emits via ctx)

def _cv_convolution(ctx, node, op, ins, outs):
    kernel = _tup(_attr(node, op, "kernel"))
    nd = len(kernel)
    stride = _tup(_attr(node, op, "stride"), nd) or (1,) * nd
    dilate = _tup(_attr(node, op, "dilate"), nd) or (1,) * nd
    pad = _tup(_attr(node, op, "pad"), nd) or (0,) * nd
    inputs = [ins["data"], ins["weight"]]
    if "bias" in ins:
        inputs.append(ins["bias"])
    ctx.emit("Conv", inputs, outs, name=node._name,
             kernel_shape=kernel, strides=stride, dilations=dilate,
             pads=list(pad) * 2, group=int(_attr(node, op, "num_group", 1)))


def _cv_deconvolution(ctx, node, op, ins, outs):
    kernel = _tup(_attr(node, op, "kernel"))
    nd = len(kernel)
    stride = _tup(_attr(node, op, "stride"), nd) or (1,) * nd
    dilate = _tup(_attr(node, op, "dilate"), nd) or (1,) * nd
    pad = _tup(_attr(node, op, "pad"), nd) or (0,) * nd
    adj = _tup(_attr(node, op, "adj"), nd) or (0,) * nd
    inputs = [ins["data"], ins["weight"]]
    if "bias" in ins:
        inputs.append(ins["bias"])
    ctx.emit("ConvTranspose", inputs, outs, name=node._name,
             kernel_shape=kernel, strides=stride, dilations=dilate,
             pads=list(pad) * 2, output_padding=adj,
             group=int(_attr(node, op, "num_group", 1)))


def _cv_fully_connected(ctx, node, op, ins, outs):
    data = ins["data"]
    if _attr(node, op, "flatten", True):
        data = ctx.emit("Flatten", [data], [ctx.uniq(f"{node._name}_flat")],
                        axis=1)
    inputs = [data, ins["weight"]]
    if "bias" in ins:
        inputs.append(ins["bias"])
    ctx.emit("Gemm", inputs, outs, name=node._name,
             alpha=1.0, beta=1.0, transA=0, transB=1)


def _cv_batch_norm(ctx, node, op, ins, outs):
    gamma = ins["gamma"]
    if _attr(node, op, "fix_gamma", True) and gamma in ctx.initializers:
        ctx.initializers[gamma] = _np.ones_like(ctx.initializers[gamma])
    ctx.emit("BatchNormalization",
             [ins["data"], gamma, ins["beta"],
              ins["moving_mean"], ins["moving_var"]],
             outs[:1], name=node._name,
             epsilon=float(_attr(node, op, "eps", 1e-5)),
             momentum=float(_attr(node, op, "momentum", 0.9)))


def _cv_pooling(ctx, node, op, ins, outs):
    ptype = _attr(node, op, "pool_type", "max")
    if _attr(node, op, "global_pool", False):
        onnx_op = {"max": "GlobalMaxPool", "avg": "GlobalAveragePool"}.get(ptype)
        if onnx_op is None:
            raise MXNetError(f"ONNX: global {ptype} pooling unsupported")
        ctx.emit(onnx_op, [ins["data"]], outs, name=node._name)
        return
    kernel = _tup(_attr(node, op, "kernel"))
    nd = len(kernel)
    stride = _tup(_attr(node, op, "stride"), nd) or (1,) * nd
    pad = _tup(_attr(node, op, "pad"), nd) or (0,) * nd
    ceil_mode = _attr(node, op, "pooling_convention", "valid") == "full"
    if ptype == "max":
        ctx.emit("MaxPool", [ins["data"]], outs, name=node._name,
                 kernel_shape=kernel, strides=stride, pads=list(pad) * 2,
                 ceil_mode=int(ceil_mode))
    elif ptype == "avg":
        ctx.emit("AveragePool", [ins["data"]], outs, name=node._name,
                 kernel_shape=kernel, strides=stride, pads=list(pad) * 2,
                 ceil_mode=int(ceil_mode),
                 count_include_pad=int(_attr(node, op, "count_include_pad",
                                             True)))
    else:
        raise MXNetError(f"ONNX: pool_type {ptype} unsupported")


_ACT_MAP = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
            "softrelu": "Softplus", "softsign": "Softsign"}


def _cv_activation(ctx, node, op, ins, outs):
    act = _attr(node, op, "act_type", "relu")
    if act not in _ACT_MAP:
        raise MXNetError(f"ONNX: Activation act_type {act} unsupported")
    ctx.emit(_ACT_MAP[act], [ins["data"]], outs, name=node._name)


def _cv_leaky_relu(ctx, node, op, ins, outs):
    act = _attr(node, op, "act_type", "leaky")
    slope = float(_attr(node, op, "slope", 0.25))
    if act == "leaky":
        ctx.emit("LeakyRelu", [ins["data"]], outs, name=node._name,
                 alpha=slope)
    elif act == "elu":
        ctx.emit("Elu", [ins["data"]], outs, name=node._name, alpha=slope)
    elif act == "prelu":
        ctx.emit("PRelu", [ins["data"], ins["gamma"]], outs, name=node._name)
    elif act == "selu":
        ctx.emit("Selu", [ins["data"]], outs, name=node._name)
    elif act == "gelu":
        # 0.5 * x * (1 + erf(x / sqrt(2))) — decomposed, ONNX<20 has no Gelu
        x = ins["data"]
        inv = ctx.add_init(ctx.uniq("gelu_inv_sqrt2"),
                           _np.float32(1.0 / _np.sqrt(2.0)))
        half = ctx.add_init(ctx.uniq("gelu_half"), _np.float32(0.5))
        one = ctx.add_init(ctx.uniq("gelu_one"), _np.float32(1.0))
        t = ctx.emit("Mul", [x, inv], [ctx.uniq("gelu_t")])
        t = ctx.emit("Erf", [t], [ctx.uniq("gelu_erf")])
        t = ctx.emit("Add", [t, one], [ctx.uniq("gelu_add")])
        t = ctx.emit("Mul", [x, t], [ctx.uniq("gelu_mul")])
        ctx.emit("Mul", [t, half], outs, name=node._name)
    else:
        raise MXNetError(f"ONNX: LeakyReLU act_type {act} unsupported")


_UNARY_MAP = {
    "relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
    "softrelu": "Softplus", "softsign": "Softsign", "exp": "Exp",
    "log": "Log", "sqrt": "Sqrt", "abs": "Abs", "negative": "Neg",
    "floor": "Floor", "ceil": "Ceil", "round": "Round", "erf": "Erf",
    "reciprocal": "Reciprocal", "sign": "Sign", "sin": "Sin", "cos": "Cos",
    "tan": "Tan", "arcsin": "Asin", "arccos": "Acos", "arctan": "Atan",
    "sinh": "Sinh", "cosh": "Cosh", "arcsinh": "Asinh", "arccosh": "Acosh",
    "arctanh": "Atanh", "identity": "Identity", "_copy": "Identity",
    "BlockGrad": "Identity", "make_loss": "Identity",
}

_BINARY_MAP = {
    "broadcast_add": "Add", "broadcast_sub": "Sub", "broadcast_mul": "Mul",
    "broadcast_div": "Div", "broadcast_power": "Pow", "broadcast_mod": "Mod",
    "broadcast_maximum": "Max", "broadcast_minimum": "Min",
    "dot": "MatMul", "batch_dot": "MatMul",
    "broadcast_equal": "Equal", "broadcast_greater": "Greater",
    "broadcast_lesser": "Less",
}

_SCALAR_MAP = {"_scalar_add": "Add", "_scalar_sub": "Sub",
               "_scalar_mul": "Mul", "_scalar_div": "Div",
               "_scalar_power": "Pow", "_scalar_maximum": "Max",
               "_scalar_minimum": "Min"}


def _cv_scalar(ctx, node, op, ins, outs):
    onnx_op = _SCALAR_MAP[node._op]
    s = ctx.add_init(ctx.uniq(f"{node._name}_scalar"),
                     _np.float32(_attr(node, op, "scalar", 0.0)))
    data = ins["data"]
    inputs = [s, data] if _attr(node, op, "reverse", False) else [data, s]
    ctx.emit(onnx_op, inputs, outs, name=node._name)


def _cv_dot(ctx, node, op, ins, outs):
    # transpose_a/b swap the LAST TWO axes (matmul semantics), so the
    # emitted Transpose needs a full-rank perm
    a, b = ins["lhs"], ins["rhs"]
    default_rank = 3 if node._op == "batch_dot" else 2

    def last2_perm(sym):
        shp = ctx.shape_of(sym)
        rank = len(shp) if shp is not None else default_rank
        perm = list(range(rank))
        perm[-1], perm[-2] = perm[-2], perm[-1]
        return perm

    if _attr(node, op, "transpose_a", False):
        a = ctx.emit("Transpose", [a], [ctx.uniq(f"{node._name}_ta")],
                     perm=last2_perm(node._inputs[0]))
    if _attr(node, op, "transpose_b", False):
        b = ctx.emit("Transpose", [b], [ctx.uniq(f"{node._name}_tb")],
                     perm=last2_perm(node._inputs[1]))
    ctx.emit("MatMul", [a, b], outs, name=node._name)


def _cv_softmax(ctx, node, op, ins, outs):
    ctx.emit("Softmax", [ins["data"]], outs, name=node._name,
             axis=int(_attr(node, op, "axis", -1)))


def _cv_log_softmax(ctx, node, op, ins, outs):
    ctx.emit("LogSoftmax", [ins["data"]], outs, name=node._name,
             axis=int(_attr(node, op, "axis", -1)))


def _cv_softmax_output(ctx, node, op, ins, outs):
    # deploy-time semantics: plain softmax over classes (ref: mx2onnx
    # _op_translations softmax_output [U])
    ctx.emit("Softmax", [ins["data"]], outs, name=node._name, axis=1)


def _cv_flatten(ctx, node, op, ins, outs):
    ctx.emit("Flatten", list(ins.values())[:1], outs, name=node._name, axis=1)


def _cv_reshape(ctx, node, op, ins, outs):
    shape = _tup(_attr(node, op, "shape"))
    if shape is None or any(s < -1 for s in shape):
        raise MXNetError("ONNX: reshape with special codes <-1 unsupported")
    shp = ctx.add_init(ctx.uniq(f"{node._name}_shape"),
                       _np.array(shape, _np.int64))
    ctx.emit("Reshape", [ins["data"], shp], outs, name=node._name)


def _cv_transpose(ctx, node, op, ins, outs):
    axes = _tup(_attr(node, op, "axes"))
    kw = {"perm": axes} if axes else {}
    ctx.emit("Transpose", [ins["data"]], outs, name=node._name, **kw)


def _cv_swapaxes(ctx, node, op, ins, outs):
    # ONNX Transpose needs a full-rank perm — rank from shape inference
    shp = ctx.shape_of(node._inputs[0])
    if shp is None:
        raise MXNetError("ONNX: swapaxes needs a known input rank — pass "
                         "input_shape to export_model")
    rank = len(shp)
    d1 = int(_attr(node, op, "dim1", 0)) % rank
    d2 = int(_attr(node, op, "dim2", 0)) % rank
    perm = list(range(rank))
    perm[d1], perm[d2] = perm[d2], perm[d1]
    ctx.emit("Transpose", [ins["data"]], outs, name=node._name, perm=perm)


def _cv_expand_dims(ctx, node, op, ins, outs):
    ax = ctx.add_init(ctx.uniq(f"{node._name}_axes"),
                      _np.array([int(_attr(node, op, "axis", 0))], _np.int64))
    ctx.emit("Unsqueeze", [ins["data"], ax], outs, name=node._name)


def _cv_squeeze(ctx, node, op, ins, outs):
    axis = _attr(node, op, "axis")
    inputs = [ins["data"]]
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        inputs.append(ctx.add_init(ctx.uniq(f"{node._name}_axes"),
                                   _np.array(axes, _np.int64)))
    ctx.emit("Squeeze", inputs, outs, name=node._name)


def _cv_concat(ctx, node, op, ins, outs):
    args = ins.get("__extra__", [])
    data = [v for k, v in ins.items() if k != "__extra__"] + args
    ctx.emit("Concat", data, outs, name=node._name,
             axis=int(_attr(node, op, "dim", 1)))


def _cv_stack(ctx, node, op, ins, outs):
    axis = int(_attr(node, op, "axis", 0))
    args = [v for k, v in ins.items() if k != "__extra__"] \
        + ins.get("__extra__", [])
    ax = ctx.add_init(ctx.uniq(f"{node._name}_axes"),
                      _np.array([axis], _np.int64))
    unsq = [ctx.emit("Unsqueeze", [a, ax],
                     [ctx.uniq(f"{node._name}_u{i}")])
            for i, a in enumerate(args)]
    ctx.emit("Concat", unsq, outs, name=node._name, axis=axis)


def _cv_split(ctx, node, op, ins, outs):
    axis = int(_attr(node, op, "axis", 1))
    sq = _attr(node, op, "squeeze_axis", False)
    if not sq:
        ctx.emit("Split", [ins["data"]], outs, name=node._name, axis=axis)
        return
    mids = [ctx.uniq(f"{node._name}_p{i}") for i in range(len(outs))]
    ctx.emit("Split", [ins["data"]], mids, name=node._name, axis=axis)
    ax = ctx.add_init(ctx.uniq(f"{node._name}_axes"),
                      _np.array([axis], _np.int64))
    for mid, out in zip(mids, outs):
        ctx.emit("Squeeze", [mid, ax], [out])


def _cv_slice_axis(ctx, node, op, ins, outs):
    axis = int(_attr(node, op, "axis", 0))
    begin = int(_attr(node, op, "begin", 0))
    end = _attr(node, op, "end")
    end = int(end) if end is not None else (1 << 62)
    names = [ctx.add_init(ctx.uniq(f"{node._name}_{t}"),
                          _np.array([v], _np.int64))
             for t, v in (("starts", begin), ("ends", end), ("axes", axis))]
    ctx.emit("Slice", [ins["data"]] + names, outs, name=node._name)


def _cv_slice(ctx, node, op, ins, outs):
    # begin/end entries may be None (open slice) — no _tup, it int()s
    begin = _attr(node, op, "begin") or ()
    end = _attr(node, op, "end") or ()
    starts = [int(b) if b is not None else 0 for b in begin]
    ends = [int(e) if e is not None else (1 << 62) for e in end]
    axes = list(range(len(starts)))
    names = [ctx.add_init(ctx.uniq(f"{node._name}_{t}"),
                          _np.array(v, _np.int64))
             for t, v in (("starts", starts), ("ends", ends), ("axes", axes))]
    ctx.emit("Slice", [ins["data"]] + names, outs, name=node._name)


def _cv_clip(ctx, node, op, ins, outs):
    lo = _attr(node, op, "a_min")
    hi = _attr(node, op, "a_max")
    inputs = [ins["data"]]
    inputs.append(ctx.add_init(ctx.uniq(f"{node._name}_min"),
                               _np.float32(lo)) if lo is not None else "")
    if hi is not None:
        inputs.append(ctx.add_init(ctx.uniq(f"{node._name}_max"),
                                   _np.float32(hi)))
    ctx.emit("Clip", inputs, outs, name=node._name)


def _cv_cast(ctx, node, op, ins, outs):
    dtype = _np.dtype(_attr(node, op, "dtype", "float32"))
    ctx.emit("Cast", [ins["data"]], outs, name=node._name,
             to=int(P.NP_TO_ONNX[dtype]))


def _cv_embedding(ctx, node, op, ins, outs):
    idx = ctx.emit("Cast", [ins["data"]], [ctx.uniq(f"{node._name}_idx")],
                   to=int(P.DT_INT64))
    ctx.emit("Gather", [ins["weight"], idx], outs, name=node._name, axis=0)


def _cv_take(ctx, node, op, ins, outs):
    idx = ctx.emit("Cast", [ins["indices"]], [ctx.uniq(f"{node._name}_idx")],
                   to=int(P.DT_INT64))
    ctx.emit("Gather", [ins["a"], idx], outs, name=node._name,
             axis=int(_attr(node, op, "axis", 0)))


def _cv_dropout(ctx, node, op, ins, outs):
    ratio = ctx.add_init(ctx.uniq(f"{node._name}_ratio"),
                         _np.float32(_attr(node, op, "p", 0.5)))
    ctx.emit("Dropout", [ins["data"], ratio], outs, name=node._name)


def _cv_where(ctx, node, op, ins, outs):
    cond = ctx.emit("Cast", [ins["condition"]],
                    [ctx.uniq(f"{node._name}_cond")], to=int(P.DT_BOOL))
    ctx.emit("Where", [cond, ins["x"], ins["y"]], outs, name=node._name)


def _reduce_axes(node, op):
    axis = _attr(node, op, "axis")
    if axis is None:
        return None
    return (int(axis),) if isinstance(axis, int) else tuple(axis)


def _cv_reduce(onnx_op, axes_as_input=False):
    def cv(ctx, node, op, ins, outs):
        axes = _reduce_axes(node, op)
        keep = int(bool(_attr(node, op, "keepdims", False)))
        data = list(ins.values())[0]
        if axes_as_input:                   # ReduceSum, opset 13
            inputs = [data]
            if axes is not None:
                inputs.append(ctx.add_init(ctx.uniq(f"{node._name}_axes"),
                                           _np.array(axes, _np.int64)))
            ctx.emit(onnx_op, inputs, outs, name=node._name, keepdims=keep)
        else:
            kw = {"axes": axes} if axes is not None else {}
            ctx.emit(onnx_op, [data], outs, name=node._name,
                     keepdims=keep, **kw)
    return cv


def _cv_norm(ctx, node, op, ins, outs):
    ordv = int(_attr(node, op, "ord", 2))
    axes = _reduce_axes(node, op)
    keep = int(bool(_attr(node, op, "keepdims", False)))
    onnx_op = {1: "ReduceL1", 2: "ReduceL2"}.get(ordv)
    if onnx_op is None:
        raise MXNetError(f"ONNX: norm ord={ordv} unsupported")
    kw = {"axes": axes} if axes is not None else {}
    ctx.emit(onnx_op, [ins["data"]], outs, name=node._name,
             keepdims=keep, **kw)


def _cv_lrn(ctx, node, op, ins, outs):
    ctx.emit("LRN", [ins["data"]], outs, name=node._name,
             alpha=float(_attr(node, op, "alpha", 1e-4)),
             beta=float(_attr(node, op, "beta", 0.75)),
             bias=float(_attr(node, op, "knorm", 2.0)),
             size=int(_attr(node, op, "nsize", 5)))


def _cv_pad(ctx, node, op, ins, outs):
    width = _tup(_attr(node, op, "pad_width")) or ()
    mode = _attr(node, op, "mode", "constant")
    onnx_mode = {"constant": "constant", "edge": "edge",
                 "reflect": "reflect"}.get(mode)
    if onnx_mode is None:
        raise MXNetError(f"ONNX: pad mode {mode} unsupported")
    begins, ends = width[0::2], width[1::2]
    pads = ctx.add_init(ctx.uniq(f"{node._name}_pads"),
                        _np.array(list(begins) + list(ends), _np.int64))
    val = ctx.add_init(ctx.uniq(f"{node._name}_value"),
                       _np.float32(_attr(node, op, "constant_value", 0.0)))
    ctx.emit("Pad", [ins["data"], pads, val], outs, name=node._name,
             mode=onnx_mode)


def _cv_upsampling(ctx, node, op, ins, outs):
    scale = int(_attr(node, op, "scale", 1))
    scales = ctx.add_init(ctx.uniq(f"{node._name}_scales"),
                          _np.array([1.0, 1.0, scale, scale], _np.float32))
    ctx.emit("Resize", [ins["data"], "", scales], outs, name=node._name,
             mode="nearest", nearest_mode="floor",
             coordinate_transformation_mode="asymmetric")


def _cv_l2norm(ctx, node, op, ins, outs):
    mode = _attr(node, op, "mode", "instance")
    axis = {"channel": 1, "instance": -1, "spatial": -1}.get(mode)
    if mode != "channel":
        raise MXNetError("ONNX: L2Normalization only mode='channel'")
    ctx.emit("LpNormalization", [ins["data"]], outs, name=node._name,
             p=2, axis=axis)


_EXPORT_CONVERTERS = {
    "Convolution": _cv_convolution,
    "Deconvolution": _cv_deconvolution,
    "FullyConnected": _cv_fully_connected,
    "BatchNorm": _cv_batch_norm,
    "Pooling": _cv_pooling,
    "Activation": _cv_activation,
    "LeakyReLU": _cv_leaky_relu,
    "softmax": _cv_softmax,
    "log_softmax": _cv_log_softmax,
    "SoftmaxOutput": _cv_softmax_output,
    "flatten": _cv_flatten,
    "reshape": _cv_reshape,
    "transpose": _cv_transpose,
    "swapaxes": _cv_swapaxes,
    "expand_dims": _cv_expand_dims,
    "squeeze": _cv_squeeze,
    "concat": _cv_concat,
    "stack": _cv_stack,
    "split": _cv_split,
    "slice_axis": _cv_slice_axis,
    "slice": _cv_slice,
    "clip": _cv_clip,
    "cast": _cv_cast,
    "Embedding": _cv_embedding,
    "take": _cv_take,
    "Dropout": _cv_dropout,
    "where": _cv_where,
    "dot": _cv_dot,
    "batch_dot": _cv_dot,
    "sum": _cv_reduce("ReduceSum", axes_as_input=True),
    "mean": _cv_reduce("ReduceMean"),
    "max": _cv_reduce("ReduceMax"),
    "min": _cv_reduce("ReduceMin"),
    "prod": _cv_reduce("ReduceProd"),
    "norm": _cv_norm,
    "LRN": _cv_lrn,
    "pad": _cv_pad,
    "UpSampling": _cv_upsampling,
    "L2Normalization": _cv_l2norm,
}


def _sym_topo_export(sym, params, in_shapes, in_dtype, graph_name):
    """Walk the Symbol graph and build a GraphProto dict."""
    from ..symbol.symbol import Group
    from ..ops import registry as _reg

    heads = sym._head_list() if isinstance(sym, Group) else [sym]
    order = sym._topo()
    ctx = _ExportCtx(params)
    tensor_of = {}                 # (id(base), out_index) -> tensor name
    graph_inputs = []

    # infer output/input shapes for value_info (best effort)
    data_vars = [n._name for n in order
                 if n.is_var() and n._name not in params]
    shape_kw = {}
    if in_shapes:
        for name, shp in zip(data_vars, in_shapes):
            shape_kw[name] = tuple(shp)
    out_shapes = [None] * len(heads)
    try:
        _, out_shapes, _ = sym.infer_shape(**shape_kw)
    except Exception:
        pass
    # per-node shapes (rank-dependent converters: swapaxes, batch_dot)
    try:
        internals = sym.get_internals()
        _, int_shapes, _ = internals.infer_shape(**shape_kw)
        for h, shp in zip(internals.heads, int_shapes):
            if shp is not None:
                base = h._base or h
                ctx.shape_map[(id(base), h._out_index)] = tuple(shp)
    except Exception:
        pass

    for node in order:
        if node.is_var():
            name = node._name
            if name in params:
                ctx.add_init(name, params[name])
            else:
                shp = shape_kw.get(name)
                graph_inputs.append({
                    "name": name,
                    "elem_type": P.NP_TO_ONNX[_np.dtype(in_dtype)],
                    "shape": list(shp) if shp else ["?"],
                })
            tensor_of[(id(node), 0)] = name
            continue
        if node._op == "_const":
            val = _const_value(node)
            ctx.add_init(node._name, val)
            tensor_of[(id(node), 0)] = node._name
            continue
        op = _reg.get_opdef(node._op)
        slot_syms = _slot_map(node, op)
        ins = {}
        for iname, s in slot_syms.items():
            if iname == "__extra__":
                ins["__extra__"] = [
                    tensor_of[(id(x._base or x), x._out_index)] for x in s]
            else:
                base = s._base or s
                ins[iname] = tensor_of[(id(base), s._out_index)]
        n_out = node._num_outputs
        outs = [node._name] if n_out == 1 else \
            [f"{node._name}_{i}" for i in range(n_out)]
        for i, t in enumerate(outs):
            tensor_of[(id(node), i)] = t
        cv = _EXPORT_CONVERTERS.get(node._op)
        if cv is None and node._op in _UNARY_MAP:
            ctx.emit(_UNARY_MAP[node._op], [list(ins.values())[0]], outs,
                     name=node._name)
        elif cv is None and node._op in _BINARY_MAP:
            ctx.emit(_BINARY_MAP[node._op],
                     [ins.get("lhs", ins.get("data")),
                      ins.get("rhs")], outs, name=node._name)
        elif cv is None and node._op in _SCALAR_MAP:
            _cv_scalar(ctx, node, op, ins, outs)
        elif cv is not None:
            cv(ctx, node, op, ins, outs)
        else:
            raise MXNetError(
                f"ONNX export: op {node._op!r} has no converter "
                f"(node {node._name!r})")

    graph_outputs = []
    for h, shp in zip(heads, out_shapes):
        base = h._base or h
        graph_outputs.append({
            "name": tensor_of[(id(base), h._out_index)],
            "elem_type": P.NP_TO_ONNX[_np.dtype(in_dtype)],
            "shape": list(shp) if shp else ["?"],
        })

    # every consumed tensor must be produced — catches silently-invalid
    # graphs (e.g. something reading BatchNorm's mean/var outputs, which
    # the ONNX inference BatchNormalization node does not emit)
    produced = set(ctx.initializers)
    produced.update(vi["name"] for vi in graph_inputs)
    produced.add("")                         # empty = omitted optional
    for n in ctx.nodes:
        produced.update(n["outputs"])
    for n in ctx.nodes:
        missing = [t for t in n["inputs"] if t not in produced]
        if missing:
            raise MXNetError(
                f"ONNX export: node {n['name']!r} consumes tensor(s) "
                f"{missing} that no node produces (training-only outputs "
                f"like BatchNorm mean/var cannot be exported)")

    return {
        "name": graph_name,
        "nodes": ctx.nodes,
        "initializers": [{"name": k, "array": v}
                         for k, v in ctx.initializers.items()],
        "inputs": graph_inputs,
        "outputs": graph_outputs,
    }


def export_model(sym, params, input_shape=None, input_type=_np.float32,
                 onnx_file_path="model.onnx", verbose=False):
    """Export a Symbol (or path to -symbol.json) + params (dict or path
    to .params) to a standard ONNX file.  Returns onnx_file_path.
    Ref signature: mx.contrib.onnx.export_model [U]."""
    from ..symbol import load as sym_load
    from ..ndarray import NDArray
    from ..ndarray import load as nd_load

    if isinstance(sym, str):
        sym = sym_load(sym)
    if isinstance(params, str):
        params = nd_load(params)
    np_params = {}
    for k, v in (params or {}).items():
        k = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k
        arr = v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v)
        if arr.dtype.name == "bfloat16":    # ml_dtypes — not in onnx raw_data
            arr = arr.astype(_np.float32)
        np_params[k] = arr
    if input_shape is not None and input_shape and \
            not isinstance(input_shape[0], (tuple, list)):
        input_shape = [input_shape]

    graph = _sym_topo_export(sym, np_params, input_shape, input_type,
                             graph_name="mxnet_tpu_exported")
    model = {"graph": graph, "opset": 13, "ir_version": 8}
    data = P.encode_model(model)
    with open(onnx_file_path, "wb") as f:
        f.write(data)
    if verbose:
        print(f"exported {len(graph['nodes'])} nodes, "
              f"{len(graph['initializers'])} initializers "
              f"-> {onnx_file_path}")
    return onnx_file_path


# ===========================================================================
# import: ONNX → Symbol + params
# ===========================================================================

class _ImportCtx:
    def __init__(self, graph):
        self.graph = graph
        self.init = {t["name"]: t["array"] for t in graph["initializers"]}
        self.sym_of = {}           # tensor name -> Symbol
        self.used_as_param = set()

    def value_of(self, name):
        """Concrete value for structurally-consumed inputs (shape vectors
        etc.) — from initializers or Constant nodes.  Such inputs never
        hit `sym()`, so they are folded into attrs and don't become
        params."""
        if name in self.init:
            return self.init[name]
        s = self.sym_of.get(name)
        if s is not None and getattr(s, "_op", None) == "_const":
            return _const_value(s)
        raise MXNetError(f"ONNX import: input {name!r} must be constant")

    def sym(self, name):
        """Symbol for a data input; initializer-backed → param variable."""
        from ..symbol import Symbol
        if name == "" or name is None:
            return None
        if name not in self.sym_of:
            if name not in self.init:
                raise MXNetError(f"ONNX import: undefined tensor {name!r}")
            self.sym_of[name] = Symbol.var(name)
            self.used_as_param.add(name)
        return self.sym_of[name]


def _iattr(node, name, default=None):
    a = node["attributes"].get(name)
    return a["value"] if a is not None else default


def _maybe_scalar(ctx, name):
    """Scalar value of an initializer OR a Constant-node output."""
    arr = None
    if name in ctx.init:
        arr = ctx.init[name]
    else:
        s = ctx.sym_of.get(name)
        if s is not None and getattr(s, "_op", None) == "_const":
            arr = _const_value(s)
    if arr is not None and (arr.ndim == 0 or arr.size == 1):
        return float(arr.reshape(-1)[0])
    return None


def _imp_conv(ctx, node, apply):
    data = ctx.sym(node["inputs"][0])
    weight = ctx.sym(node["inputs"][1])
    bias = ctx.sym(node["inputs"][2]) if len(node["inputs"]) > 2 else None
    wshape = ctx.init.get(node["inputs"][1])
    kernel = tuple(_iattr(node, "kernel_shape") or
                   (wshape.shape[2:] if wshape is not None else ()))
    nd = len(kernel)
    pads = _iattr(node, "pads") or [0] * (2 * nd)
    if list(pads[:nd]) != list(pads[nd:]):
        raise MXNetError("ONNX import: asymmetric Conv pads unsupported")
    num_filter = int(wshape.shape[0]) if wshape is not None else 0
    attrs = {"kernel": kernel,
             "stride": tuple(_iattr(node, "strides") or (1,) * nd),
             "dilate": tuple(_iattr(node, "dilations") or (1,) * nd),
             "pad": tuple(pads[:nd]),
             "num_filter": num_filter,
             "num_group": int(_iattr(node, "group", 1)),
             "no_bias": bias is None}
    inputs = [data, weight] + ([bias] if bias is not None else [])
    return apply("Convolution", inputs, attrs, node["name"] or None)


def _imp_gemm(ctx, node, apply):
    if int(_iattr(node, "transA", 0)):
        raise MXNetError("ONNX import: Gemm transA unsupported")
    data = ctx.sym(node["inputs"][0])
    wname = node["inputs"][1]
    if not int(_iattr(node, "transB", 0)):
        if wname not in ctx.init:
            raise MXNetError("ONNX import: Gemm transB=0 needs initializer B")
        ctx.init[wname] = _np.ascontiguousarray(ctx.init[wname].T)
    alpha = float(_iattr(node, "alpha", 1.0))
    beta = float(_iattr(node, "beta", 1.0))
    if alpha != 1.0:                         # fold into the weight
        if wname not in ctx.init:
            raise MXNetError("ONNX import: Gemm alpha != 1 needs "
                             "initializer B")
        ctx.init[wname] = ctx.init[wname] * alpha
    if beta != 1.0 and len(node["inputs"]) > 2:
        bname = node["inputs"][2]
        if bname not in ctx.init:
            raise MXNetError("ONNX import: Gemm beta != 1 needs "
                             "initializer C")
        ctx.init[bname] = ctx.init[bname] * beta
    weight = ctx.sym(wname)
    wshape = ctx.init.get(wname)
    bias = ctx.sym(node["inputs"][2]) if len(node["inputs"]) > 2 else None
    attrs = {"num_hidden": int(wshape.shape[0]) if wshape is not None else 0,
             "flatten": False, "no_bias": bias is None}
    inputs = [data, weight] + ([bias] if bias is not None else [])
    return apply("FullyConnected", inputs, attrs, node["name"] or None)


def _imp_bn(ctx, node, apply):
    ins = [ctx.sym(n) for n in node["inputs"][:5]]
    attrs = {"eps": float(_iattr(node, "epsilon", 1e-5)),
             "momentum": float(_iattr(node, "momentum", 0.9)),
             "fix_gamma": False}
    out = apply("BatchNorm", ins, attrs, node["name"] or None)
    return out[0] if len(out) > 1 else out


def _imp_pool(ctx, node, apply, ptype, global_pool):
    data = ctx.sym(node["inputs"][0])
    attrs = {"pool_type": ptype, "global_pool": global_pool}
    if not global_pool:
        kernel = tuple(_iattr(node, "kernel_shape"))
        nd = len(kernel)
        pads = _iattr(node, "pads") or [0] * (2 * nd)
        if list(pads[:nd]) != list(pads[nd:]):
            raise MXNetError("ONNX import: asymmetric pool pads unsupported")
        attrs.update(kernel=kernel,
                     stride=tuple(_iattr(node, "strides") or (1,) * nd),
                     pad=tuple(pads[:nd]))
        if int(_iattr(node, "ceil_mode", 0)):
            attrs["pooling_convention"] = "full"
        if ptype == "avg":
            attrs["count_include_pad"] = \
                bool(int(_iattr(node, "count_include_pad", 1)))
    return apply("Pooling", [data], attrs, node["name"] or None)


def _imp_reshape(ctx, node, apply):
    shape = tuple(int(x) for x in ctx.value_of(node["inputs"][1]))
    return apply("reshape", [ctx.sym(node["inputs"][0])], {"shape": shape},
                 node["name"] or None)


def _imp_slice(ctx, node, apply):
    data = ctx.sym(node["inputs"][0])
    starts = [int(x) for x in ctx.value_of(node["inputs"][1])]
    ends = [int(x) for x in ctx.value_of(node["inputs"][2])]
    axes = [int(x) for x in ctx.value_of(node["inputs"][3])] \
        if len(node["inputs"]) > 3 and node["inputs"][3] \
        else list(range(len(starts)))
    steps = [int(x) for x in ctx.value_of(node["inputs"][4])] \
        if len(node["inputs"]) > 4 and node["inputs"][4] \
        else [1] * len(starts)
    out = data
    big = 1 << 60
    for b, e, a, s in zip(starts, ends, axes, steps):
        if s != 1:
            raise MXNetError("ONNX import: Slice steps != 1 unsupported")
        out = apply("slice_axis", [out],
                    {"axis": a, "begin": b,
                     "end": None if e >= big else e}, None)
    return out


def _imp_clip(ctx, node, apply):
    lo = hi = None
    if len(node["inputs"]) > 1 and node["inputs"][1]:
        lo = _maybe_scalar(ctx, node["inputs"][1])
    if len(node["inputs"]) > 2 and node["inputs"][2]:
        hi = _maybe_scalar(ctx, node["inputs"][2])
    return apply("clip", [ctx.sym(node["inputs"][0])],
                 {"a_min": lo, "a_max": hi}, node["name"] or None)


def _imp_binary(opname):
    def imp(ctx, node, apply):
        a_name, b_name = node["inputs"][:2]
        # scalar initializer operand → _scalar_* (keeps the graph lean)
        smap = {"broadcast_add": "_scalar_add", "broadcast_sub": "_scalar_sub",
                "broadcast_mul": "_scalar_mul", "broadcast_div": "_scalar_div",
                "broadcast_power": "_scalar_power"}
        for name, other, rev in ((b_name, a_name, False),
                                 (a_name, b_name, True)):
            s = _maybe_scalar(ctx, name)
            if s is not None and opname in smap:
                return apply(smap[opname], [ctx.sym(other)],
                             {"scalar": s, "reverse": rev},
                             node["name"] or None)
        return apply(opname, [ctx.sym(a_name), ctx.sym(b_name)], {},
                     node["name"] or None)
    return imp


def _imp_unsqueeze(ctx, node, apply):
    axes = _iattr(node, "axes")
    if axes is None:
        axes = [int(x) for x in ctx.value_of(node["inputs"][1])]
    out = ctx.sym(node["inputs"][0])
    for a in sorted(int(x) for x in axes):
        out = apply("expand_dims", [out], {"axis": a}, None)
    return out


def _imp_squeeze(ctx, node, apply):
    axes = _iattr(node, "axes")
    if axes is None and len(node["inputs"]) > 1:
        axes = [int(x) for x in ctx.value_of(node["inputs"][1])]
    return apply("squeeze", [ctx.sym(node["inputs"][0])],
                 {"axis": tuple(axes) if axes else None},
                 node["name"] or None)


def _imp_reduce(opname, axes_from_input=False, extra=None):
    def imp(ctx, node, apply):
        axes = _iattr(node, "axes")
        if axes is None and axes_from_input and len(node["inputs"]) > 1:
            axes = [int(x) for x in ctx.value_of(node["inputs"][1])]
        attrs = {"axis": tuple(axes) if axes else None,
                 "keepdims": bool(int(_iattr(node, "keepdims", 1)))}
        attrs.update(extra or {})
        return apply(opname, [ctx.sym(node["inputs"][0])], attrs,
                     node["name"] or None)
    return imp


def _imp_gather(ctx, node, apply):
    data, idx = node["inputs"][:2]
    axis = int(_iattr(node, "axis", 0))
    wshape = ctx.init.get(data)
    if axis == 0 and wshape is not None and wshape.ndim == 2:
        return apply("Embedding", [ctx.sym(idx), ctx.sym(data)],
                     {"input_dim": int(wshape.shape[0]),
                      "output_dim": int(wshape.shape[1])},
                     node["name"] or None)
    return apply("take", [ctx.sym(data), ctx.sym(idx)], {"axis": axis},
                 node["name"] or None)


def _imp_pad(ctx, node, apply):
    pads = _iattr(node, "pads")
    if pads is None:
        pads = [int(x) for x in ctx.value_of(node["inputs"][1])]
    n = len(pads) // 2
    width = []
    for i in range(n):
        width += [int(pads[i]), int(pads[n + i])]
    value = 0.0
    if len(node["inputs"]) > 2 and node["inputs"][2]:
        value = _maybe_scalar(ctx, node["inputs"][2]) or 0.0
    return apply("pad", [ctx.sym(node["inputs"][0])],
                 {"mode": _iattr(node, "mode", "constant"),
                  "pad_width": tuple(width), "constant_value": value},
                 node["name"] or None)


def _imp_split(ctx, node, apply):
    return apply("split", [ctx.sym(node["inputs"][0])],
                 {"num_outputs": len(node["outputs"]),
                  "axis": int(_iattr(node, "axis", 0))},
                 node["name"] or None)


def _imp_dropout(ctx, node, apply):
    p = float(_iattr(node, "ratio", 0.5))
    if len(node["inputs"]) > 1 and node["inputs"][1]:
        v = _maybe_scalar(ctx, node["inputs"][1])
        if v is not None:
            p = v
    return apply("Dropout", [ctx.sym(node["inputs"][0])], {"p": p},
                 node["name"] or None)


def _imp_cast(ctx, node, apply):
    to = int(_iattr(node, "to", P.DT_FLOAT))
    return apply("cast", [ctx.sym(node["inputs"][0])],
                 {"dtype": P.ONNX_TO_NP[to].name}, node["name"] or None)


def _imp_constant(ctx, node, apply):
    from ..symbol.symbol import const_symbol
    t = _iattr(node, "value")
    if t is None:
        raise MXNetError("ONNX import: Constant without tensor value")
    return const_symbol(t["array"])


def _imp_where(ctx, node, apply):
    return apply("where", [ctx.sym(n) for n in node["inputs"][:3]], {},
                 node["name"] or None)


def _imp_act(act_type):
    def imp(ctx, node, apply):
        return apply("Activation", [ctx.sym(node["inputs"][0])],
                     {"act_type": act_type}, node["name"] or None)
    return imp


def _imp_leaky(act_type, default_alpha):
    def imp(ctx, node, apply):
        attrs = {"act_type": act_type,
                 "slope": float(_iattr(node, "alpha", default_alpha))}
        ins = [ctx.sym(node["inputs"][0])]
        if act_type == "prelu":
            ins.append(ctx.sym(node["inputs"][1]))
        return apply("LeakyReLU", ins, attrs, node["name"] or None)
    return imp


def _imp_unary(opname):
    def imp(ctx, node, apply):
        return apply(opname, [ctx.sym(node["inputs"][0])], {},
                     node["name"] or None)
    return imp


def _imp_softmax(opname):
    def imp(ctx, node, apply):
        return apply(opname, [ctx.sym(node["inputs"][0])],
                     {"axis": int(_iattr(node, "axis", -1))},
                     node["name"] or None)
    return imp


def _imp_flatten(ctx, node, apply):
    if int(_iattr(node, "axis", 1)) != 1:
        raise MXNetError("ONNX import: Flatten axis != 1 unsupported")
    return apply("flatten", [ctx.sym(node["inputs"][0])], {},
                 node["name"] or None)


def _imp_concat(ctx, node, apply):
    return apply("concat", [ctx.sym(n) for n in node["inputs"]],
                 {"dim": int(_iattr(node, "axis", 0))},
                 node["name"] or None)


def _imp_transpose(ctx, node, apply):
    perm = _iattr(node, "perm")
    return apply("transpose", [ctx.sym(node["inputs"][0])],
                 {"axes": tuple(perm) if perm else None},
                 node["name"] or None)


def _imp_matmul(ctx, node, apply):
    # batch_dot is a plain matmul — the numpy-style stacked semantics
    # ONNX MatMul specifies (MXNet's `dot` contracts differently for >2D)
    return apply("batch_dot", [ctx.sym(n) for n in node["inputs"][:2]], {},
                 node["name"] or None)


def _imp_lrn(ctx, node, apply):
    return apply("LRN", [ctx.sym(node["inputs"][0])],
                 {"alpha": float(_iattr(node, "alpha", 1e-4)),
                  "beta": float(_iattr(node, "beta", 0.75)),
                  "knorm": float(_iattr(node, "bias", 1.0)),
                  "nsize": int(_iattr(node, "size", 5))},
                 node["name"] or None)


def _imp_sum_n(ctx, node, apply):
    syms = [ctx.sym(n) for n in node["inputs"]]
    out = syms[0]
    for s in syms[1:]:
        out = apply("broadcast_add", [out, s], {}, None)
    return out


def _imp_resize(ctx, node, apply):
    mode = _iattr(node, "mode", "nearest")
    if mode == "nearest" and len(node["inputs"]) > 2 and node["inputs"][2]:
        scales = ctx.value_of(node["inputs"][2])
        return apply("UpSampling", [ctx.sym(node["inputs"][0])],
                     {"scale": int(round(float(scales[-1]))),
                      "sample_type": "nearest"}, node["name"] or None)
    if len(node["inputs"]) > 3 and node["inputs"][3]:
        sizes = [int(x) for x in ctx.value_of(node["inputs"][3])]
        return apply("BilinearResize2D", [ctx.sym(node["inputs"][0])],
                     {"height": sizes[-2], "width": sizes[-1]},
                     node["name"] or None)
    raise MXNetError("ONNX import: unsupported Resize configuration")


_IMPORT_CONVERTERS = {
    "Conv": _imp_conv,
    "Gemm": _imp_gemm,
    "BatchNormalization": _imp_bn,
    "MaxPool": lambda c, n, a: _imp_pool(c, n, a, "max", False),
    "AveragePool": lambda c, n, a: _imp_pool(c, n, a, "avg", False),
    "GlobalMaxPool": lambda c, n, a: _imp_pool(c, n, a, "max", True),
    "GlobalAveragePool": lambda c, n, a: _imp_pool(c, n, a, "avg", True),
    "Relu": _imp_act("relu"), "Sigmoid": _imp_act("sigmoid"),
    "Tanh": _imp_act("tanh"), "Softplus": _imp_act("softrelu"),
    "Softsign": _imp_act("softsign"),
    "LeakyRelu": _imp_leaky("leaky", 0.01), "Elu": _imp_leaky("elu", 1.0),
    "PRelu": _imp_leaky("prelu", 0.25), "Selu": _imp_leaky("selu", 0.25),
    "Softmax": _imp_softmax("softmax"),
    "LogSoftmax": _imp_softmax("log_softmax"),
    "Flatten": _imp_flatten,
    "Reshape": _imp_reshape,
    "Transpose": _imp_transpose,
    "Concat": _imp_concat,
    "Unsqueeze": _imp_unsqueeze,
    "Squeeze": _imp_squeeze,
    "Slice": _imp_slice,
    "Clip": _imp_clip,
    "Cast": _imp_cast,
    "Constant": _imp_constant,
    "Gather": _imp_gather,
    "MatMul": _imp_matmul,
    "Dropout": _imp_dropout,
    "Where": _imp_where,
    "Pad": _imp_pad,
    "Split": _imp_split,
    "LRN": _imp_lrn,
    "Sum": _imp_sum_n,
    "Resize": _imp_resize,
    "Identity": _imp_unary("_copy"),
    "Add": _imp_binary("broadcast_add"),
    "Sub": _imp_binary("broadcast_sub"),
    "Mul": _imp_binary("broadcast_mul"),
    "Div": _imp_binary("broadcast_div"),
    "Pow": _imp_binary("broadcast_power"),
    "Mod": _imp_binary("broadcast_mod"),
    "Max": _imp_binary("broadcast_maximum"),
    "Min": _imp_binary("broadcast_minimum"),
    "Equal": _imp_binary("broadcast_equal"),
    "Greater": _imp_binary("broadcast_greater"),
    "Less": _imp_binary("broadcast_lesser"),
    "ReduceSum": _imp_reduce("sum", axes_from_input=True),
    "ReduceMean": _imp_reduce("mean"),
    "ReduceMax": _imp_reduce("max"),
    "ReduceMin": _imp_reduce("min"),
    "ReduceProd": _imp_reduce("prod"),
    "ReduceL1": _imp_reduce("norm", extra={"ord": 1}),
    "ReduceL2": _imp_reduce("norm", extra={"ord": 2}),
    "Neg": _imp_unary("negative"), "Exp": _imp_unary("exp"),
    "Log": _imp_unary("log"), "Sqrt": _imp_unary("sqrt"),
    "Abs": _imp_unary("abs"), "Floor": _imp_unary("floor"),
    "Ceil": _imp_unary("ceil"), "Round": _imp_unary("round"),
    "Erf": _imp_unary("erf"), "Reciprocal": _imp_unary("reciprocal"),
    "Sign": _imp_unary("sign"), "Sin": _imp_unary("sin"),
    "Cos": _imp_unary("cos"), "Tan": _imp_unary("tan"),
    "Asin": _imp_unary("arcsin"), "Acos": _imp_unary("arccos"),
    "Atan": _imp_unary("arctan"), "Sinh": _imp_unary("sinh"),
    "Cosh": _imp_unary("cosh"), "Asinh": _imp_unary("arcsinh"),
    "Acosh": _imp_unary("arccosh"), "Atanh": _imp_unary("arctanh"),
}


def _import_graph(graph):
    """Decoded GraphProto dict → (sym, arg_params, aux_params)."""
    from ..symbol.symbol import _apply as sym_apply
    from ..symbol import Group
    from ..ndarray import array as nd_array

    ctx = _ImportCtx(graph)

    from ..symbol import Symbol
    for vi in graph["inputs"]:
        if vi["name"] not in ctx.init:
            ctx.sym_of[vi["name"]] = Symbol.var(vi["name"])

    def apply(opname, inputs, attrs, name):
        attrs = {k: v for k, v in attrs.items() if v is not None}
        return sym_apply(opname, inputs, attrs, name=name)

    for node in graph["nodes"]:
        cv = _IMPORT_CONVERTERS.get(node["op_type"])
        if cv is None:
            raise MXNetError(
                f"ONNX import: op {node['op_type']!r} unsupported "
                f"(node {node['name']!r})")
        out = cv(ctx, node, apply)
        outs = node["outputs"]
        if len(outs) == 1:
            ctx.sym_of[outs[0]] = out
        else:
            for i, oname in enumerate(outs):
                ctx.sym_of[oname] = out[i]

    heads = [ctx.sym_of[o["name"]] for o in graph["outputs"]]
    sym = heads[0] if len(heads) == 1 else Group(heads)

    aux_names = set(sym.list_auxiliary_states())
    arg_params, aux_params = {}, {}
    for name in ctx.used_as_param:
        arr = ctx.init[name]
        if arr.dtype == _np.int64:      # NDArray default dtypes
            arr = arr.astype(_np.int32)
        target = aux_params if name in aux_names else arg_params
        target[name] = nd_array(arr)
    return sym, arg_params, aux_params


def import_model(model_file):
    """Parse an .onnx file → (sym, arg_params, aux_params).  Ref:
    mx.contrib.onnx.import_model [U]."""
    with open(model_file, "rb") as f:
        model = P.decode_model(f.read())
    return _import_graph(model["graph"])


def import_to_gluon(model_file, ctx=None):
    """Load an .onnx file as a ready-to-run SymbolBlock (ref:
    onnx2mx.import_to_gluon [U])."""
    from ..gluon.block import SymbolBlock
    from ..symbol import Symbol

    with open(model_file, "rb") as f:
        graph = P.decode_model(f.read())["graph"]
    sym, arg_params, aux_params = _import_graph(graph)
    init_names = {t["name"] for t in graph["initializers"]}
    input_names = [vi["name"] for vi in graph["inputs"]
                   if vi["name"] not in init_names]
    inputs = [Symbol.var(n) for n in input_names]
    block = SymbolBlock(sym, inputs)
    params = block.collect_params()
    for name, arr in {**arg_params, **aux_params}.items():
        if name in params:
            params[name].set_data(arr, ctx=ctx)
    return block


def get_model_metadata(model_file):
    """Input/output names+shapes of an .onnx file (ref:
    mx.contrib.onnx.get_model_metadata [U])."""
    with open(model_file, "rb") as f:
        model = P.decode_model(f.read())
    graph = model["graph"]
    init_names = {t["name"] for t in graph["initializers"]}
    return {
        "input_tensor_data": [(vi["name"], tuple(vi["shape"]))
                              for vi in graph["inputs"]
                              if vi["name"] not in init_names],
        "output_tensor_data": [(vi["name"], tuple(vi["shape"]))
                               for vi in graph["outputs"]],
    }
