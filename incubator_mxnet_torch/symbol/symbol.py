"""Symbol: a lazy operator graph (counterpart of
`incubator_mxnet_tpu/symbol/symbol.py`, same names and layout).

A Symbol is a small Python DAG over the same op registry as `nd`:
`sym.Convolution(...)` builds a node, and `registry.apply_op` makes one
whenever a Symbol is among an op's inputs, so the `nd` API doubles as
the symbolic API (this is how `HybridBlock.export` traces a block).
`bind` gives an `Executor`, which interprets the graph eagerly with the
port's ops on the bound device.  Shape and type inference run each node
on `device="meta"` tensors (shapes, no data), where the JAX package
uses `jax.eval_shape`; `tojson`/`load_json` read and write the JAX
package's `-symbol.json` format.
"""
from __future__ import annotations

import json
import threading

import numpy as _np
import torch

from ..base import MXNetError, dtype_name, numpy_dtype, torch_dtype
from ..ops import registry as _reg

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "trace_block_to_symbol"]

# op input names that are auxiliary states (not gradient-taking arguments)
_AUX_INPUTS = {"BatchNorm": ("moving_mean", "moving_var")}

_COUNTER = threading.local()


def _auto_name(opname):
    table = getattr(_COUNTER, "table", None)
    if table is None:
        table = _COUNTER.table = {}
    n = table.get(opname, 0)
    table[opname] = n + 1
    return f"{opname.lower()}{n}"


class Symbol:
    __slots__ = ("_op", "_inputs", "_attrs", "_name", "_out_index",
                 "_num_outputs", "_base", "attr_dict_")

    def __init__(self, op=None, inputs=(), attrs=None, name=None,
                 out_index=0, num_outputs=1, base=None):
        self._op = op                  # None for variables
        self._inputs = list(inputs)    # list[Symbol]
        self._attrs = dict(attrs or {})
        self._name = name or (_auto_name(op) if op else None)
        self._out_index = out_index
        self._num_outputs = num_outputs
        self._base = base              # multi-output selector → base node
        self.attr_dict_ = {}

    # ------------------------------------------------------------------
    @staticmethod
    def var(name, shape=None, dtype=None, **kwargs):
        s = Symbol(name=name)
        s.attr_dict_ = {"shape": tuple(shape) if shape else None,
                        "dtype": dtype_name(dtype) if dtype else None}
        return s

    @property
    def name(self):
        return self._name

    def is_var(self):
        return self._op is None and self._base is None

    # -- graph walks -------------------------------------------------------
    def _topo(self):
        seen, order = set(), []

        def visit(node):
            base = node._base or node
            if id(base) in seen:
                return
            seen.add(id(base))
            for inp in base._inputs:
                visit(inp)
            order.append(base)

        visit(self)
        return order

    def _aux_var_ids(self, order):
        """One-pass id set of variables that are auxiliary op inputs."""
        aux_ids = set()
        for node in order:
            if node._op in _AUX_INPUTS:
                op = _reg.get_opdef(node._op)
                names = _AUX_INPUTS[node._op]
                present = node._attrs.get("__present__") \
                    or (True,) * len(node._inputs)
                slots = [i for i, p in enumerate(present) if p]
                for slot, inp in zip(slots, node._inputs):
                    if slot < len(op.input_names) \
                            and op.input_names[slot] in names and inp.is_var():
                        aux_ids.add(id(inp))
        return aux_ids

    def list_arguments(self):
        order = self._topo()
        aux_ids = self._aux_var_ids(order)
        args = []
        for node in order:
            if node.is_var() and id(node) not in aux_ids \
                    and node._name not in args:
                args.append(node._name)
        return args

    def list_auxiliary_states(self):
        order = self._topo()
        aux_ids = self._aux_var_ids(order)
        aux = []
        for node in order:
            if node.is_var() and id(node) in aux_ids and node._name not in aux:
                aux.append(node._name)
        return aux

    def list_outputs(self):
        if self._op is None and self._base is None:
            return [self._name]
        base = self._base or self
        if base._num_outputs == 1:
            return [f"{base._name}_output"]
        return [f"{base._name}_output{i}" for i in range(base._num_outputs)]

    def get_internals(self):
        outs = []
        for node in self._topo():
            for i in range(node._num_outputs):
                outs.append(node[i] if node._num_outputs > 1 else node)
        return Group(outs)

    def __getitem__(self, index):
        if isinstance(index, str):
            for node in self._topo():
                if node._name == index or f"{node._name}_output" == index:
                    return node
            raise MXNetError(f"no internal output named {index}")
        base = self._base or self
        if self._num_outputs == 1 and index == 0:
            return self
        if index >= base._num_outputs:
            raise MXNetError("output index out of range")
        return Symbol(base._op, base._inputs, base._attrs,
                      name=base._name, out_index=index,
                      num_outputs=base._num_outputs, base=base)

    def __iter__(self):
        base = self._base or self
        for i in range(base._num_outputs):
            yield self[i]

    def __len__(self):
        return (self._base or self)._num_outputs

    # -- arithmetic (mirror NDArray so layer code runs on Symbols) ---------
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _apply(op, [a, b], {})
        if not isinstance(other, (int, float, _np.generic)):
            return NotImplemented
        return _apply(scalar_op, [self],
                      {"scalar": float(other), "reverse": reverse})

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_scalar_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_scalar_sub")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_scalar_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_scalar_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_scalar_div")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_scalar_div", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_scalar_power")

    def __neg__(self):
        return _apply("negative", [self], {})

    # identity comparison, like the reference Symbol (elementwise compare is
    # sym.broadcast_equal / __gt__ etc.; == must stay sane for membership)
    def __eq__(self, o):
        return self is o

    def __ne__(self, o):
        return self is not o

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_scalar_greater")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal", "_scalar_greater_equal")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_scalar_lesser")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal", "_scalar_lesser_equal")

    __hash__ = object.__hash__

    # -- common methods ----------------------------------------------------
    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _apply("reshape", [self], {"shape": shape or kw.get("shape")})

    def transpose(self, axes=None):
        return _apply("transpose", [self], {"axes": axes})

    def flatten(self):
        return _apply("flatten", [self], {})

    def expand_dims(self, axis):
        return _apply("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _apply("squeeze", [self], {"axis": axis})

    def sum(self, axis=None, keepdims=False):
        return _apply("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _apply("mean", [self], {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return _apply("max", [self], {"axis": axis, "keepdims": keepdims})

    def astype(self, dtype):
        return _apply("cast", [self], {"dtype": dtype_name(dtype)})

    def slice_axis(self, axis, begin, end):
        return _apply("slice_axis", [self],
                      {"axis": axis, "begin": begin, "end": end})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _apply("split", [self], {"num_outputs": num_outputs,
                                        "axis": axis,
                                        "squeeze_axis": squeeze_axis})

    def swapaxes(self, dim1, dim2):
        return _apply("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    @property
    def ndim(self):
        raise MXNetError("Symbol has no concrete ndim; use infer_shape")

    # -- shape/type inference (ref: Symbol.infer_shape [U]) ----------------
    def _head_outputs(self):
        """(base, out_index) per OUTPUT, aligned with list_outputs()."""
        heads = self.heads if isinstance(self, Group) else [self]
        outs = []
        for h in heads:
            base = h._base or h
            if h._base is None and base._num_outputs > 1:
                outs.extend((base, i) for i in range(base._num_outputs))
            else:
                outs.append((base, h._out_index))
        return outs

    def _shape_pass(self, seed, var_dtype=None):
        """Fixed-point shape (and, when `var_dtype` is given, dtype)
        propagation; returns (var_shape, shapes, dtypes) keyed by
        (id(base), out_index)."""
        order = self._topo()
        shapes = {}                       # (id(base), out_index) -> shape
        dtypes = {}                       # (id(base), out_index) -> dtype
        var_dtype = var_dtype or {}
        var_shape = {}
        for node in order:                # declared var shapes seed first
            shp = node.attr_dict_.get("shape") if node.is_var() else None
            # MXNet convention: 0 dims mean UNKNOWN (deferred-init
            # params) — a 0-dim shape must not suppress the param rules
            if shp and all(d > 0 for d in shp):
                var_shape[node._name] = tuple(shp)
        var_shape.update({n: tuple(s) for n, s in seed.items()})

        def in_shape(inp):
            base = inp._base or inp
            if base.is_var():
                return var_shape.get(base._name)
            return shapes.get((id(base), inp._out_index))

        def in_dtype_known(inp):
            """Dtype if actually derived, None when still unknown."""
            base = inp._base or inp
            if base.is_var():
                return var_dtype.get(base._name)
            if base._op == "_const":
                return numpy_dtype(base._attrs["__value__"].dtype)
            return dtypes.get((id(base), inp._out_index))

        def in_dtype(inp):
            return in_dtype_known(inp) or _np.dtype(_np.float32)

        changed = True
        while changed:
            changed = False
            for node in order:
                if node.is_var():
                    continue
                if node._op == "_const":
                    if (id(node), 0) not in shapes:
                        shapes[(id(node), 0)] = tuple(
                            node._attrs["__value__"].shape)
                        changed = True
                    continue
                if node._op == "_subgraph":
                    # infer through the carved-out inner graph
                    if (id(node), 0) in shapes:
                        continue
                    in_names = node._attrs["__sg_inputs__"]
                    inner_kw = {}
                    ok = True
                    for nm, inp in zip(in_names, node._inputs):
                        s = in_shape(inp)
                        ok = ok and s is not None
                        if s is not None:
                            inner_kw[nm] = s
                    if ok:
                        inner = node._attrs["__subgraph__"]
                        _, oshapes, _ = inner.infer_shape(**inner_kw)
                        for i, oshp in enumerate(oshapes or ()):
                            if oshp is not None:
                                shapes[(id(node), i)] = tuple(oshp)
                                changed = True
                        if var_dtype:    # dtype-aware pass: recurse too
                            inner_dt = {nm: in_dtype(inp) for nm, inp in
                                        zip(in_names, node._inputs)}
                            try:
                                _, otypes, _ = inner.infer_type(**inner_dt)
                                for i, t in enumerate(otypes or ()):
                                    if t is not None:
                                        dtypes[(id(node), i)] = _np_dtype(t)
                            except Exception:
                                pass
                    continue
                op = _reg.get_opdef(node._op)
                present = node._attrs.get("__present__") \
                    or (True,) * len(node._inputs)
                slots = [i for i, p in enumerate(present) if p]
                slot_of = dict(zip(slots, node._inputs))
                ishapes = {s: in_shape(sym) for s, sym in slot_of.items()}
                # 1) param rules fill unknown variable inputs
                rule = _PARAM_SHAPE_RULES.get(node._op)
                if rule is not None and any(v is None for v in
                                            ishapes.values()):
                    derived = rule(node._attrs, ishapes, op)
                    for s, shp in (derived or {}).items():
                        sym2 = slot_of.get(s)
                        if shp is not None and sym2 is not None \
                                and sym2.is_var() \
                                and var_shape.get(sym2._name) is None:
                            var_shape[sym2._name] = tuple(shp)
                            changed = True
                            ishapes[s] = tuple(shp)
                if var_dtype and _adopt_param_dtypes(
                        node, slot_of, var_dtype, in_dtype_known):
                    changed = True
                # 2) all inputs known → abstract-eval node outputs
                if (id(node), 0) not in shapes \
                        and all(v is not None for v in ishapes.values()):
                    idt = {s: in_dtype(sym) for s, sym in slot_of.items()}
                    outs = _node_eval_shape(op, node, slot_of, ishapes,
                                            idtypes=idt)
                    if outs is not None:
                        for i, (shp, dt) in enumerate(outs):
                            shapes[(id(node), i)] = tuple(shp)
                            dtypes[(id(node), i)] = dt
                        changed = True
        return var_shape, shapes, dtypes

    def infer_shape(self, **kwargs):
        """Partial shape inference (ref: nnvm InferShape pass [U]): given
        (typically) only data/label shapes, derive every parameter/aux
        shape by walking the graph — parameter-carrying ops contribute
        `_PARAM_SHAPE_RULES`, everything else is abstractly evaluated per
        node on meta tensors (no compute).  Shapes declared on
        variables (`sym.var(name, shape=...)`) seed the pass."""
        var_shape, shapes, _ = self._shape_pass(kwargs)
        args = self.list_arguments()
        aux = self.list_auxiliary_states()
        arg_shapes = [var_shape.get(n) for n in args]
        aux_shapes = [var_shape.get(n) for n in aux]
        out_shapes = []
        for base, i in self._head_outputs():
            if base.is_var():
                out_shapes.append(var_shape.get(base._name))
            else:
                out_shapes.append(shapes.get((id(base), i)))
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, **kwargs):
        """Partial dtype inference (ref: nnvm InferType pass [U]): given
        dtypes for some variables (declared `sym.var(..., dtype=...)`
        dtypes seed too; float32 is the default, as in the reference),
        derive every output dtype by abstractly evaluating the graph.
        Where shapes are derivable (declared var shapes) real shapes
        feed the abstract eval; otherwise a (2,2) dummy is used and
        rank-sensitive ops that reject it keep the float32 default."""
        order = self._topo()
        var_dtype = {}
        for node in order:              # declared var dtypes seed first
            if node.is_var() and node.attr_dict_.get("dtype"):
                var_dtype[node._name] = _np_dtype(node.attr_dict_["dtype"])
        var_dtype.update({n: _np_dtype(t) for n, t in kwargs.items()})

        # one dtype-aware fixed-point pass resolves every node whose
        # shapes are derivable; the sweep below only mops up the rest
        # (unknown shapes → dummy-shape abstract eval)
        try:
            var_shapes, node_shapes, dtypes = self._shape_pass(
                {}, var_dtype=var_dtype)
        except Exception:
            var_shapes, node_shapes, dtypes = {}, {}, {}

        def in_dtype_known(inp):
            base = inp._base or inp
            if base.is_var():
                return var_dtype.get(base._name)
            if base._op == "_const":
                return numpy_dtype(base._attrs["__value__"].dtype)
            return dtypes.get((id(base), inp._out_index))

        def in_dtype(inp):
            return in_dtype_known(inp) or _np.dtype(_np.float32)

        def in_shape(inp, dummy):
            base = inp._base or inp
            if base.is_var():
                s = var_shapes.get(base._name)
            elif base._op == "_const":
                s = tuple(base._attrs["__value__"].shape)
            else:
                s = node_shapes.get((id(base), inp._out_index))
            return s if s is not None else dummy

        for node in order:
            if node.is_var() or node._op == "_const" \
                    or (id(node), 0) in dtypes:
                continue
            if node._op == "_subgraph":
                inner = node._attrs["__subgraph__"]
                in_names = node._attrs["__sg_inputs__"]
                inner_kw = {nm: in_dtype(inp)
                            for nm, inp in zip(in_names, node._inputs)}
                try:
                    _, otypes, _ = inner.infer_type(**inner_kw)
                except Exception:
                    continue
                for i, t in enumerate(otypes):
                    if t is not None:
                        dtypes[(id(node), i)] = _np_dtype(t)
                continue
            op = _reg.get_opdef(node._op)
            present = node._attrs.get("__present__") \
                or (True,) * len(node._inputs)
            slots = [i for i, p in enumerate(present) if p]
            slot_of = dict(zip(slots, node._inputs))
            _adopt_param_dtypes(node, slot_of, var_dtype, in_dtype_known)
            idtypes = {s: in_dtype(sym) for s, sym in slot_of.items()}
            # attempt 1: real shapes, scalar () dummies (broadcast-
            # neutral) for the unknown; attempt 2: uniform (2,2)
            # dummies (rank-2 ops); failure keeps the f32 default
            outs = None
            for dummy in ((), (2, 2)):
                ishapes = {s: in_shape(sym, dummy)
                           for s, sym in slot_of.items()}
                outs = _node_eval_shape(op, node, slot_of, ishapes,
                                        idtypes=idtypes)
                if outs is not None:
                    break
            if outs is None:
                continue
            for i, (_shp, dt) in enumerate(outs):
                dtypes[(id(node), i)] = dt

        args = self.list_arguments()
        aux = self.list_auxiliary_states()
        arg_types = [var_dtype.get(n, _np.dtype(_np.float32)).type
                     for n in args]
        aux_types = [var_dtype.get(n, _np.dtype(_np.float32)).type
                     for n in aux]
        out_types = []
        for base, i in self._head_outputs():
            if base.is_var():
                out_types.append(var_dtype.get(
                    base._name, _np.dtype(_np.float32)).type)
            elif base._op == "_const":
                out_types.append(
                    numpy_dtype(base._attrs["__value__"].dtype).type)
            else:
                out_types.append(dtypes.get(
                    (id(base), i), _np.dtype(_np.float32)).type)
        return arg_types, out_types, aux_types

    # -- evaluation --------------------------------------------------------
    def eval_with(self, bindings, is_train=False):
        """Evaluate with a dict name→NDArray (used by SymbolBlock); the
        graph keeps torch's grad mode, so a recorded caller can take
        gradients through it."""
        from ..ndarray import NDArray
        raw = {k: (v._data if isinstance(v, NDArray) else v)
               for k, v in bindings.items()}
        outs = _interp(self._head_list(), raw, is_train)
        res = [NDArray(o) for o in outs]
        return res[0] if len(res) == 1 else res

    def get_backend_symbol(self, backend):
        """Partition for a registered subgraph backend (ref:
        Symbol.get_backend_symbol / MXNET_SUBGRAPH_BACKEND [U])."""
        from ..subgraph import partition_graph
        return partition_graph(self, backend)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx=None, grad_req="write", **shapes):
        """Bind float32 zero arrays of the inferred shapes on `ctx`."""
        from ..executor import Executor
        from ..ndarray import zeros
        args = {}
        shape_hints = {k: v for k, v in shapes.items()
                       if isinstance(v, (tuple, list))}
        inferred, _, aux_shapes = self.infer_shape(**shape_hints)
        if inferred is None:
            raise MXNetError("simple_bind: provide shapes for all arguments "
                             f"({self.list_arguments()})")
        for name, shp in zip(self.list_arguments(), inferred):
            if shp is None:
                raise MXNetError(f"simple_bind: the shape of {name!r} "
                                 "cannot be inferred")
            args[name] = zeros(shp, ctx=ctx)
        aux = {name: zeros(shp, ctx=ctx)
               for name, shp in zip(self.list_auxiliary_states(), aux_shapes)}
        grads = {name: zeros(a.shape, ctx=ctx) for name, a in args.items()}
        return Executor(self, ctx, args, grads, grad_req, aux)

    # -- serialization (ref: Symbol.tojson / legacy_json_util [U]) ---------
    def _head_list(self):
        return [self]

    def tojson(self):
        nodes = self._topo()
        index = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            if n._op == "_const":
                # graph constants: value serialized as nested list + dtype
                v = n._attrs["__value__"]
                attrs = {"__value__": json.dumps(
                    v.detach().cpu().to(torch.float64 if v.is_floating_point()
                                        else v.dtype).tolist()),
                         "__dtype__": repr(dtype_name(v.dtype))}
            else:
                attrs = {k: repr(v) for k, v in n._attrs.items()}
            jnodes.append({
                "op": n._op or "null",
                "name": n._name,
                "attrs": attrs,
                "inputs": [[index[id(i._base or i)], i._out_index, 0]
                           for i in n._inputs],
            })
        heads = [[index[id(h._base or h)], h._out_index, 0]
                 for h in self._head_list()]
        return json.dumps({"nodes": jnodes, "heads": heads,
                           "mxnet_tpu_version": 1}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def __repr__(self):
        if self.is_var():
            return f"<Symbol variable {self._name}>"
        return f"<Symbol {self._name} = {self._op}(...)>"


def const_symbol(array):
    """Embed a concrete array (a tensor, NDArray, numpy array or number)
    as a graph constant; it is moved to the bound device at evaluation."""
    from ..ndarray import NDArray
    if isinstance(array, NDArray):
        array = array._data
    if not isinstance(array, torch.Tensor):
        arr = _np.asarray(array)
        if arr.dtype == _np.float64:
            arr = arr.astype(_np.float32)
        elif arr.dtype == _np.int64:
            arr = arr.astype(_np.int32)
        array = torch.from_numpy(_np.ascontiguousarray(arr))
    s = Symbol(op="_const", name=_auto_name("const"))
    s._attrs["__value__"] = array.detach()
    return s


def _np_dtype(t):
    """A numpy dtype (bfloat16 as `numpy_dtype` gives it) from a name, a
    numpy or a torch dtype."""
    return numpy_dtype(torch_dtype(t))


# --------------------------------------------------------------------------
# Partial shape inference machinery (ref: FInferShape per op [U])
# --------------------------------------------------------------------------

def _prod(xs):
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _fc_rule(attrs, ishapes, op):
    d = ishapes.get(0)
    if d is None:
        return None
    nh = int(attrs.get("num_hidden", 0))
    flatten = attrs.get("flatten", True)
    in_dim = _prod(d[1:]) if flatten else d[-1]
    return {1: (nh, in_dim), 2: (nh,)}


def _conv_rule(attrs, ishapes, op):
    d = ishapes.get(0)
    if d is None:
        return None
    kernel = tuple(attrs.get("kernel", ()))
    nf = int(attrs.get("num_filter", 0))
    groups = int(attrs.get("num_group", 1))
    return {1: (nf, d[1] // groups) + kernel, 2: (nf,)}


def _deconv_rule(attrs, ishapes, op):
    d = ishapes.get(0)
    if d is None:
        return None
    kernel = tuple(attrs.get("kernel", ()))
    nf = int(attrs.get("num_filter", 0))
    groups = int(attrs.get("num_group", 1))
    return {1: (d[1], nf // groups) + kernel, 2: (nf,)}


def _bn_rule(attrs, ishapes, op):
    d = ishapes.get(0)
    if d is None:
        return None
    c = d[int(attrs.get("axis", 1))]
    return {1: (c,), 2: (c,), 3: (c,), 4: (c,)}


def _ln_rule(attrs, ishapes, op):
    d = ishapes.get(0)
    if d is None:
        return None
    c = d[int(attrs.get("axis", -1))]
    return {1: (c,), 2: (c,)}


def _embedding_rule(attrs, ishapes, op):
    return {1: (int(attrs["input_dim"]), int(attrs["output_dim"]))}


def _label_like_rule(attrs, ishapes, op):
    d = ishapes.get(0)
    if d is None:
        return None
    return {1: d}


def _softmax_out_rule(attrs, ishapes, op):
    d = ishapes.get(0)
    if d is None:
        return None
    # sparse class-index labels: (N,) — or full shape for multi_output
    if attrs.get("multi_output", False):
        return {1: (d[0],) + tuple(d[2:])}
    return {1: (d[0],)}


def _rnn_rule(attrs, ishapes, op):
    d = ishapes.get(0)
    if d is None:
        return None
    mode = attrs.get("mode", "lstm")
    H = int(attrs.get("state_size", 0))
    L = int(attrs.get("num_layers", 1))
    bi = 2 if attrs.get("bidirectional", False) else 1
    I = d[-1]
    gates = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}[mode]
    size = 0
    for layer in range(L):
        inp = I if layer == 0 else H * bi
        size += bi * gates * (H * inp + H * H + 2 * H)
    N = d[1]
    out = {1: (size,), 2: (L * bi, N, H)}
    if mode == "lstm":
        out[3] = (L * bi, N, H)
    return out


# Ops whose params do NOT follow the slot-0 input dtype:
# - BatchNorm: the reference pins gamma/beta and running stats to
#   float32 whatever the data is (batch_norm.cc kFloat32 [U]);
# - Embedding: slot 0 is the INTEGER index input — the weight must not
#   adopt int32.
_ADOPT_DTYPE_EXCLUDE = {"BatchNorm", "Embedding"}


def _adopt_param_dtypes(node, slot_of, var_dtype, in_dtype_known):
    """Param-carrying ops: undeclared param vars adopt the DATA input's
    dtype once it is KNOWN (reference InferType behavior — f16 data
    implies f16 weights, not f32 promotion).  Returns True if any var
    dtype was newly derived."""
    if node._op not in _PARAM_SHAPE_RULES \
            or node._op in _ADOPT_DTYPE_EXCLUDE or 0 not in slot_of:
        return False
    d0 = in_dtype_known(slot_of[0])
    if d0 is None:          # data dtype not derived yet: adopting the
        return False        # f32 default would PIN downstream params
    changed = False
    for s, sym2 in slot_of.items():
        if s != 0 and sym2.is_var() and sym2._name not in var_dtype:
            var_dtype[sym2._name] = d0
            changed = True
    return changed


_PARAM_SHAPE_RULES = {
    "FullyConnected": _fc_rule,
    "Convolution": _conv_rule,
    "Deconvolution": _deconv_rule,
    "BatchNorm": _bn_rule,
    "LayerNorm": _ln_rule,
    "InstanceNorm": _bn_rule,
    "Embedding": _embedding_rule,
    "SoftmaxOutput": _softmax_out_rule,
    "LinearRegressionOutput": _label_like_rule,
    "LogisticRegressionOutput": _label_like_rule,
    "MAERegressionOutput": _label_like_rule,
    "RNN": _rnn_rule,
}


def _node_eval_shape(op, node, slot_of, ishapes, idtypes=None):
    """Abstract-evaluate one graph node: (shapes[, dtypes]) in →
    [(shape, dtype)] out — the single core behind infer_shape and
    infer_type.  The op runs on `device="meta"` tensors, which carry
    shapes and dtypes and no data (kernel wrappers take their plain
    versions there); an op that cannot run so gives None, and the shape
    rules decide."""
    from .. import autograd
    n_slots = max(slot_of) + 1 if slot_of else 0
    full = []
    for s in range(max(n_slots, len(op.input_names)
                       if not op.variadic else n_slots)):
        if s in ishapes and ishapes[s] is not None:
            dt = torch_dtype((idtypes or {}).get(s, _np.float32))
            full.append(torch.empty(tuple(ishapes[s]), dtype=dt,
                                    device="meta"))
        else:
            full.append(None)
    if op.variadic:
        full = [t for t in full if t is not None]

    kw = {a: node._attrs[a] for a in op.attr_names if a in node._attrs}
    for a, dflt in op.attr_defaults.items():
        kw.setdefault(a, dflt)
    try:
        with autograd.predict_mode(), torch.no_grad():
            out = op.impl(*full, **kw)
    except Exception:
        return None
    outs = out if isinstance(out, (tuple, list)) else [out]
    if not all(isinstance(o, torch.Tensor) for o in outs):
        return None
    return [(tuple(o.shape), numpy_dtype(o.dtype)) for o in outs]


# Op inputs that auto-create a Variable when the user omits them —
# MXNet's convention where sym.FullyConnected(data, name='fc1') implies
# fc1_weight/fc1_bias vars and SoftmaxOutput implies <name>_label
# (ref: NNVM op FListInputNames + MXSymbolCompose auto-var behavior [U]).
_AUTO_VAR_INPUTS = {"weight", "bias", "gamma", "beta", "moving_mean",
                    "moving_var", "label", "parameters", "state",
                    "state_cell"}
_SKIP_AUTO = {
    "bias": lambda a: a.get("no_bias", False),
    "state_cell": lambda a: a.get("mode", "lstm") != "lstm",
}


def _apply(op_name, inputs, attrs, name=None):
    op = _reg.get_opdef(op_name)
    attrs = {k: v for k, v in attrs.items() if v is not None or k == "axis"}
    bad = set(attrs) - set(op.attr_names) - {"__present__"}
    if bad:
        raise MXNetError(f"{op_name}: unknown attribute(s) {sorted(bad)}")
    if name is None:
        name = _auto_name(op_name)
    if not op.variadic:
        full = list(inputs) + [None] * (len(op.input_names) - len(inputs))
        for i, iname in enumerate(op.input_names):
            if full[i] is None and iname in _AUTO_VAR_INPUTS:
                skip = _SKIP_AUTO.get(iname)
                if skip is not None and skip(attrs):
                    continue
                full[i] = Symbol.var(f"{name}_{iname}"
                                     if iname != "label"
                                     else f"{name}_label")
        inputs = full
    # optional inputs (e.g. bias under no_bias) are recorded as a presence
    # mask so the interpreter can rebuild the impl's full signature
    present = tuple(i is not None for i in inputs)
    if not all(present):
        attrs["__present__"] = present
    n_out = _probe_num_outputs(op, attrs)
    return Symbol(op.name, [i for i in inputs if i is not None], attrs,
                  name=name, num_outputs=n_out)


_MULTI_OUTPUT_OPS = {"split": lambda a: a.get("num_outputs", 1),
                     "SliceChannel": lambda a: a.get("num_outputs", 1),
                     "BatchNorm": lambda a: 3,
                     "RNN": lambda a: 3 if a.get("mode", "lstm") == "lstm" else 2,
                     "topk": lambda a: 2 if a.get("ret_typ") == "both" else 1,
                     "lamb_update_phase1": lambda a: 3,
                     "moments": lambda a: 2,
                     "amp_multicast": lambda a: a.get("num_outputs", 1),
                     "_contrib_MultiBoxTarget": lambda a: 3,
                     "_contrib_bipartite_matching": lambda a: 2,
                     "multi_sgd_update": lambda a: a.get("num_weights", 1),
                     "multi_sgd_mom_update":
                         lambda a: 2 * a.get("num_weights", 1),
                     "mp_sgd_update": lambda a: 2,
                     "mp_sgd_mom_update": lambda a: 3,
                     "_contrib_quantize_v2": lambda a: 3,
                     "_contrib_requantize": lambda a: 3,
                     "_contrib_quantized_conv": lambda a: 3,
                     "_contrib_quantized_fully_connected": lambda a: 3,
                     "_contrib_quantized_pooling": lambda a: 3,
                     "_contrib_quantized_act": lambda a: 3,
                     "_contrib_quantized_flatten": lambda a: 3}


def _probe_num_outputs(op, attrs):
    fn = _MULTI_OUTPUT_OPS.get(op.name)
    return fn(attrs) if fn else 1


def symbol_apply(op, inputs, attrs, name=None):
    """Entry point used by registry.apply_op when inputs are Symbols:
    inputs that are not Symbols become graph constants."""
    inputs = [a if a is None or isinstance(a, Symbol) else const_symbol(a)
              for a in inputs]
    return _apply(op.name, inputs, attrs, name=name)


# --------------------------------------------------------------------------
# graph interpreter (run eagerly by Executor and SymbolBlock)
# --------------------------------------------------------------------------

def _topo_of(output_syms):
    order, seen = [], set()

    def visit(s):
        base = s._base or s
        if id(base) in seen:
            return
        seen.add(id(base))
        for inp in base._inputs:
            visit(inp)
        order.append(base)

    for s in output_syms:
        visit(s)
    return order


def _interp(output_syms, bindings, is_train, monitor=None):
    """Topologically evaluate symbols given name→tensor bindings, each
    node through its op's function on the bindings' device, in train
    mode or predict mode (`autograd.is_training()`, which the ops read).
    Random ops draw from the framework generator of that device.
    `monitor(name, tensor)` sees every node output."""
    from .. import autograd
    cache = {}
    order = _topo_of(output_syms)
    device = next((t.device for t in bindings.values()
                   if isinstance(t, torch.Tensor)), None)
    with (autograd.train_mode() if is_train else autograd.predict_mode()):
        for node in order:
            if node.is_var():
                if node._name not in bindings:
                    raise MXNetError(
                        f"unbound symbol variable {node._name!r}")
                cache[id(node)] = (bindings[node._name],)
                continue
            if node._op == "_const":
                v = node._attrs["__value__"]
                cache[id(node)] = (v if device is None else v.to(device),)
                continue
            if node._op == "_subgraph":
                # backend-carved region (subgraph.py): inline the inner
                # graph
                inner = node._attrs["__subgraph__"]
                in_names = node._attrs["__sg_inputs__"]
                inner_bind = {}
                for nm, inp in zip(in_names, node._inputs):
                    vals = cache[id(inp._base or inp)]
                    inner_bind[nm] = vals[inp._out_index]
                outs = _interp([inner], inner_bind, is_train, monitor)
                cache[id(node)] = tuple(outs)
                continue
            op = _reg.get_opdef(node._op)
            arrays = []
            for inp in node._inputs:
                vals = cache[id(inp._base or inp)]
                arrays.append(vals[inp._out_index])
            present = node._attrs.get("__present__")
            if present is not None:
                full, it = [], iter(arrays)
                for pres in present:
                    full.append(next(it) if pres else None)
                arrays = full
            attrs = dict(node._attrs)
            for aname, adefault in op.attr_defaults.items():
                attrs.setdefault(aname, adefault)
            attrs = {k: v for k, v in attrs.items() if k in op.attr_names}
            out = op.impl(*arrays, **attrs)
            outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            cache[id(node)] = outs
            if monitor is not None:
                names = Symbol.list_outputs(node)
                for nm, o in zip(names, outs):
                    monitor(nm, o)

    results = []
    for s in output_syms:
        vals = cache[id(s._base or s)]
        results.append(vals[s._out_index])
    return results


# --------------------------------------------------------------------------
def var(name, **kwargs):
    return Symbol.var(name, **kwargs)


Variable = var


class Group(Symbol):
    """Multiple heads as one symbol (ref: sym.Group [U])."""

    def __init__(self, symbols):
        super().__init__(name="group")
        self._heads = list(symbols)

    def _topo(self):
        seen, order = set(), []

        def visit(node):
            base = node._base or node
            if id(base) in seen:
                return
            seen.add(id(base))
            for inp in base._inputs:
                visit(inp)
            order.append(base)

        for h in self._heads:
            visit(h)
        return order

    def list_outputs(self):
        return [o for h in self._heads for o in h.list_outputs()]

    def _head_list(self):
        return list(self._heads)

    @property
    def heads(self):
        return self._heads


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    import ast
    for jn in data["nodes"]:
        attrs = {}
        for k, v in jn.get("attrs", {}).items():
            try:
                attrs[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                attrs[k] = v
        if jn["op"] == "null":
            nodes.append(Symbol.var(jn["name"]))
        elif jn["op"] == "_const":
            val = torch.tensor(
                json.loads(jn["attrs"]["__value__"]),
                dtype=torch_dtype(attrs.get("__dtype__", "float32")))
            s = Symbol(op="_const", name=jn["name"])
            s._attrs["__value__"] = val
            nodes.append(s)
        else:
            inputs = []
            for (ni, oi, _) in jn["inputs"]:
                src = nodes[ni]
                inputs.append(src[oi] if len(src) > 1 else src)
            op = _reg.get_opdef(jn["op"])
            s = Symbol(op.name, inputs, attrs, name=jn["name"],
                       num_outputs=_probe_num_outputs(op, attrs))
            nodes.append(s)
    heads = []
    for (hi, oi, _) in data["heads"]:
        head = nodes[hi]
        heads.append(head[oi] if len(head) > 1 else head)
    if len(heads) == 1:
        return heads[0]
    return Group(heads)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def trace_block_to_symbol(block, input_names=("data",)):
    """Trace a HybridBlock into a Symbol graph (the export path): each
    parameter reads as a variable named by its structural name, and the
    block's forward runs on Symbols in predict mode."""
    from .. import autograd
    params = block._collect_params_with_prefix()
    saved = []
    for struct_name, p in params.items():
        saved.append((p, p._trace_override))
        p._trace_override = Symbol.var(struct_name)
    try:
        ins = [Symbol.var(n) for n in input_names]
        with autograd.predict_mode():
            out = block._eager_forward(*ins)
    finally:
        for p, old in saved:
            p._trace_override = old
    if isinstance(out, (list, tuple)):
        return Group(list(out))
    return out


_reg.set_symbol_type(Symbol)
