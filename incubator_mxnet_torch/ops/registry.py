"""Operator registry: one registration per op, whose implementation is a
plain function on torch tensors (array inputs positional, static
attributes keyword-only).

PyTorch counterpart of `incubator_mxnet_tpu/ops/registry.py`
(`register`, `OpDef`, `apply_op`).  PyTorch runs eagerly, so there is
no executable cache: `apply_op` unwraps NDArrays, calls the function
under `autograd.grad_scope()` (a graph is kept only inside `record()`)
and wraps what it returns.  A `Symbol` among the inputs makes the call a
graph node instead (`symbol.symbol_apply`), so the `nd` functions, which
are the `F` that `HybridBlock.hybrid_forward` receives, build graphs
too.  Each op's `OpDef` is derived from its function's signature, as
the JAX registry derives it: the input and attribute names become the
argument names (`fc1_weight`) and the `-symbol.json` keys of a graph.
"""
from __future__ import annotations

import inspect

from ..base import MXNetError
from ..autograd import grad_scope

__all__ = ["register", "add_alias", "get_op", "get_opdef", "list_ops",
           "apply_op", "write_out", "make_nd_function", "OpDef",
           "split_args"]

_REGISTRY = {}          # name -> the function
_DEFS = {}              # name -> its OpDef (aliases share the canonical's)

# keyword parameters an impl takes that are not attributes: the device
# of the sampling ops, given at each call (`nd.random.uniform(ctx=...)`)
_CALL_ARGS = ("ctx",)


class OpDef:
    """What the symbolic layer reads of an op, from its function's
    signature: POSITIONAL_OR_KEYWORD parameters are the array inputs (a
    default of None marks an optional one, e.g. `bias` under
    `no_bias`), KEYWORD_ONLY ones the attributes, `*args` a variadic
    op.  `needs_rng`/`needs_mode` mark ops that draw random numbers or
    read the train mode, `amp_exclude` the inputs amp leaves alone."""

    __slots__ = ("name", "impl", "input_names", "n_required_inputs",
                 "attr_names", "attr_defaults", "needs_rng", "needs_mode",
                 "variadic", "doc", "amp_exclude")

    def __init__(self, name, impl, needs_rng=False, needs_mode=False,
                 amp_exclude=()):
        self.name = name
        self.impl = impl
        self.needs_rng = needs_rng
        self.needs_mode = needs_mode
        self.amp_exclude = frozenset(amp_exclude)
        self.doc = impl.__doc__
        inputs, attrs, defaults = [], [], {}
        self.variadic = False
        n_req = 0
        for pname, p in inspect.signature(impl).parameters.items():
            if pname.startswith("_") or pname in _CALL_ARGS:
                continue
            if p.kind == inspect.Parameter.VAR_POSITIONAL:
                self.variadic = True
            elif p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD:
                inputs.append(pname)
                if p.default is inspect.Parameter.empty:
                    n_req += 1
            elif p.kind == inspect.Parameter.KEYWORD_ONLY:
                attrs.append(pname)
                if p.default is not inspect.Parameter.empty:
                    defaults[pname] = p.default
        self.input_names = tuple(inputs)
        self.n_required_inputs = n_req
        self.attr_names = tuple(attrs)
        self.attr_defaults = defaults

    def __repr__(self):
        return (f"OpDef({self.name}, inputs={self.input_names}, "
                f"attrs={self.attr_names})")


def register(name, aliases=(), needs_rng=False, needs_mode=False,
             amp_exclude=()):
    """Register `impl` under `name` (and `aliases`)."""
    def deco(impl):
        op = OpDef(name, impl, needs_rng, needs_mode, amp_exclude)
        for n in (name,) + tuple(aliases):
            _REGISTRY[n] = impl
            _DEFS[n] = op
        return impl
    return deco


def add_alias(alias, target):
    """Register another name for op `target` (legacy names)."""
    _REGISTRY[alias] = get_op(target)
    _DEFS[alias] = _DEFS[target]


def get_op(name):
    """The function registered under `name`."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} is not registered") from None


def get_opdef(name):
    """The `OpDef` of the op registered under `name`."""
    get_op(name)
    return _DEFS[name]


def list_ops():
    return sorted(_REGISTRY)


# amp's cast policy, `amp.policy_for` while `amp.init` holds (None
# otherwise): one global read per call when amp is off
amp_policy = None


def _amp_cast(name, tensors, kw, dtype):
    """Floating inputs cast to `dtype`, as the JAX registry's amp cast
    does, but for the op's `amp_exclude` inputs."""
    from ..base import torch_dtype
    dt = torch_dtype(dtype)
    op = _DEFS[name]

    def cast(t, iname):
        if getattr(t, "is_floating_point", None) is None \
                or not t.is_floating_point() or t.dtype == dt \
                or iname in op.amp_exclude:
            return t
        return t.to(dt)
    names = (op.input_names if not op.variadic
             else ("",) * len(tensors))
    tensors = [cast(t, names[i] if i < len(names) else "")
               for i, t in enumerate(tensors)]
    kw = {k: cast(v, k) if k in op.input_names else v
          for k, v in kw.items()}
    return tensors, kw


class _NoSymbol:
    """Stands for `symbol.Symbol` until that module is imported (no
    value is an instance, so no call is symbolic before then)."""


_SYMBOL = _NoSymbol


def set_symbol_type(cls):
    """Called by `symbol.symbol` on import: instances of `cls` among an
    op's inputs make the call a graph node."""
    global _SYMBOL
    _SYMBOL = cls


def split_args(op, args, kwargs):
    """(inputs, attrs) of a call of `op`: positional arguments and
    keywords named as inputs fill the input slots (None where absent),
    the other keywords are attributes."""
    if op.variadic:
        return list(args), dict(kwargs)
    if len(args) > len(op.input_names):
        raise MXNetError(f"{op.name}: too many positional inputs")
    inputs = list(args) + [None] * (len(op.input_names) - len(args))
    attrs = {}
    for k, v in kwargs.items():
        if k in op.input_names:
            inputs[op.input_names.index(k)] = v
        else:
            attrs[k] = v
    return inputs, attrs


def apply_op(name, *inputs, **attrs):
    """Run a registered op on NDArrays (or tensors); returns NDArrays.
    An output that shares an input's storage is registered as a view
    (`ndarray.ndarray`: a write to either side leaves the other).  A
    `Symbol` among the inputs (positional or by keyword) makes a graph
    node instead; the test costs an input that is an NDArray nothing
    beyond the one type test that unwraps it."""
    from ..ndarray.ndarray import NDArray, wrap
    impl = get_op(name)
    tensors = []
    symbolic = False
    for a in inputs:
        if isinstance(a, NDArray):
            tensors.append(a._data)
        else:
            symbolic = symbolic or isinstance(a, _SYMBOL)
            tensors.append(a)
    kw = {}
    for k, v in attrs.items():
        if isinstance(v, NDArray):
            kw[k] = v._data
        else:
            symbolic = symbolic or isinstance(v, _SYMBOL)
            kw[k] = v
    if symbolic:
        return _symbolic(name, inputs, attrs)
    if amp_policy is not None:
        dtype = amp_policy(_DEFS[name].name)
        if dtype is not None:
            tensors, kw = _amp_cast(name, tensors, kw, dtype)
    with grad_scope():
        out = impl(*tensors, **kw)
    return wrap(out, tensors)


def _symbolic(name, args, kwargs):
    """The graph node of a call with a Symbol among its inputs (JAX
    `registry.invoke`'s symbolic dispatch; the node is auto-named, as
    there: `sym.X(..., name=...)` names one)."""
    from ..symbol.symbol import symbol_apply
    op = get_opdef(name)
    inputs, attrs = split_args(op, args, kwargs)
    return symbol_apply(op, inputs, attrs)


def write_out(res, out):
    """Write result `res` into `out` (an NDArray, or a list of them for
    several outputs), as the JAX package's `out=` rebinds them; returns
    `out`."""
    if isinstance(res, tuple):
        if not isinstance(out, (list, tuple)) or len(out) != len(res):
            raise MXNetError(f"out= must be a list of {len(res)} arrays")
        for o, r in zip(out, res):
            o._assign(r._data)
        return tuple(out)
    out._assign(res._data)
    return out


def make_nd_function(name):
    def fn(*args, **kwargs):
        kwargs.pop("name", None)     # symbol-compat: a no-op in nd
        out = kwargs.pop("out", None)
        res = apply_op(name, *args, **kwargs)
        return res if out is None else write_out(res, out)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = get_op(name).__doc__
    return fn
