"""`sym` namespace: Symbol and one function per registered op, so that
`sym.X` exists for every `nd.X` (counterpart of
`incubator_mxnet_tpu/symbol/__init__.py`)."""
import sys as _sys
import types as _types

from .symbol import (Symbol, var, Variable, Group, load, load_json,
                     trace_block_to_symbol, const_symbol)
from ..ops import registry as _registry


def _make_sym_function(op):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        inputs, attrs = _registry.split_args(op, args, kwargs)
        from .symbol import symbol_apply
        return symbol_apply(op, inputs, attrs, name=name)
    fn.__name__ = fn.__qualname__ = op.name
    fn.__doc__ = op.doc
    return fn


_this = _sys.modules[__name__]
_seen = {}
for _name in _registry.list_ops():
    _op = _registry.get_opdef(_name)
    if id(_op) not in _seen:
        _seen[id(_op)] = _make_sym_function(_op)
    setattr(_this, _name, _seen[id(_op)])


# sym.contrib: every _contrib_* op under its public name
contrib = _types.ModuleType(__name__ + ".contrib")
for _name in _registry.list_ops():
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):], getattr(_this, _name))
_sys.modules[contrib.__name__] = contrib


def zeros(shape, dtype="float32", **kw):
    import numpy as _np
    return const_symbol(_np.zeros(shape, dtype=dtype))


def ones(shape, dtype="float32", **kw):
    import numpy as _np
    return const_symbol(_np.ones(shape, dtype=dtype))
