"""Block / HybridBlock — the Gluon module system on `torch.nn.Module`.

Counterpart of `incubator_mxnet_tpu/gluon/block.py`.  A Block is an
`nn.Module` that keeps Gluon's naming (prefixes, `name_scope`), its
Parameters with deferred init, `collect_params`, the structural names of
`_collect_params_with_prefix` (the checkpoint keys) and
`save/load_parameters`.  `HybridBlock.forward` calls
`hybrid_forward(F, *args, **params)` with `F` the `nd` namespace, on
NDArrays; called with torch tensors it returns torch tensors.  Called
on NDArrays it keeps a graph only inside `autograd.record()`; called on
torch tensors it follows torch's grad mode.

`hybridize()` is accepted and does nothing yet: PyTorch runs eagerly,
and the CachedOp counterpart (a CUDA graph of the forward) is later
work.  It is not `torch.compile`.  `HybridBlock.export` traces the
block into a `Symbol` (its parameters as variables of their structural
names) and writes `prefix-symbol.json` and `prefix-0000.params` in the
JAX package's formats; `SymbolBlock` runs such a graph as a block.
"""
from __future__ import annotations

import contextlib
import re
import threading
from collections import OrderedDict

import torch

from ..base import MXNetError
from ..autograd import grad_scope
from ..ndarray import NDArray
from .. import ndarray as F
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock", "record_rows"]

_naming = threading.local()


class _BlockScope:
    """Automatic name prefixes."""

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old = None

    @staticmethod
    def current():
        return getattr(_naming, "scope", None)

    @staticmethod
    def create(prefix, params, hint):
        current = _BlockScope.current()
        if current is None:
            if prefix is None:
                root = getattr(_naming, "root_counter", {})
                count = root.get(hint, 0)
                root[hint] = count + 1
                _naming.root_counter = root
                prefix = f"{hint}{count}_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old = _BlockScope.current()
        _naming.scope = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return False
        _naming.scope = self._old
        return False


def _to_tensors(out):
    if isinstance(out, NDArray):
        return out._data
    if isinstance(out, (tuple, list)):
        return type(out)(_to_tensors(o) for o in out)
    return out


class Block(torch.nn.Module):
    """Base building block."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = {}

    def _alias(self):
        return type(self).__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    @property
    def _children(self):
        return self._modules

    def name_scope(self):
        return self._scope

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            value._attach(self, name)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    # ------------------------------------------------------------------
    def collect_params(self, select=None):
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select is not None else None
        ret.update({p.name: p for p in self._reg_params.values()
                    if pattern is None or pattern.match(p.name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; a no-op until the CachedOp
        counterpart is ported."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    # -- structural-name checkpointing ----------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        params = self._collect_params_with_prefix()
        F.save(filename, {k: v._data for k, v in params.items()
                          if v._data is not None})

    def load_dict(self, loaded, ctx=None, allow_missing=False,
                  ignore_extra=False, source="dict"):
        """Set parameters from {structural name: tensor}.  An
        uninitialized parameter takes its shape from the tensor and is
        created on its pending init's device, else on `ctx`."""
        params = self._collect_params_with_prefix()
        for name, p in params.items():
            if name in loaded:
                p.set_data(loaded[name], ctx=ctx)
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing in {source}")
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(
                    f"extra parameters in {source}: {sorted(extra)}")

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set the parameters from a file of `save_parameters` (either
        package's).  Each parameter keeps its own dtype, so a float32
        file loads into a bfloat16 net as bfloat16; `cast_dtype` and
        `dtype_source` are taken and change nothing, as in the JAX
        package."""
        self.load_dict(F.load_tensors(filename), ctx, allow_missing,
                       ignore_extra, source=filename)

    # the names of older MXNet versions
    save_params = save_parameters
    load_params = load_parameters


class HybridBlock(Block):
    """Block whose forward is `hybrid_forward(F, ...)`."""

    def infer_shape(self, *args):
        """Layers with deferred-shape params override this."""
        raise MXNetError(
            f"{type(self).__name__} has uninitialized parameters and no "
            "infer_shape; initialize with explicit shapes")

    def forward(self, *args, **kwargs):
        tensors_in = bool(args) and isinstance(args[0], torch.Tensor)
        args = [NDArray(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        kwargs = {k: NDArray(v) if isinstance(v, torch.Tensor) else v
                  for k, v in kwargs.items()}
        if tensors_in:
            return _to_tensors(self._eager_forward(*args, **kwargs))
        with grad_scope():
            return self._eager_forward(*args, **kwargs)

    def _eager_forward(self, *args, **kwargs):
        try:
            params = {name: p.data() for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in self._reg_params.values():
                if p._deferred_init is not None:
                    p._finish_deferred_init()
            params = {name: p.data() for name, p in self._reg_params.items()}
        return self.hybrid_forward(F, *args, **params, **kwargs)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write the graph and the parameters for deployment:
        `path-symbol.json` (the block traced on a variable `data`) and
        `path-NNNN.params` keyed by the parameters' structural names,
        both readable by either package; returns the two file names."""
        from ..symbol import trace_block_to_symbol
        sym = trace_block_to_symbol(self)
        with open(f"{path}-symbol.json", "w") as f:
            f.write(sym.tojson())
        params = self._collect_params_with_prefix()
        F.save(f"{path}-{epoch:04d}.params",
               {k: v._data for k, v in params.items()
                if v._data is not None})
        return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"


class SymbolBlock(HybridBlock):
    """Run a loaded symbolic graph as a block: its arguments other than
    the inputs, and its auxiliary states, become parameters named as in
    the graph."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        self._out_sym = outputs
        self._in_syms = inputs if isinstance(inputs, (list, tuple)) \
            else [inputs]
        arg_names = set(s.name for s in self._in_syms)
        aux = set(outputs.list_auxiliary_states())
        for name in (outputs.list_arguments()
                     + outputs.list_auxiliary_states()):
            if name not in arg_names:
                self.params.get(name, allow_deferred_init=True,
                                grad_req="null" if name in aux else "write")
        self._graph_params = OrderedDict(
            (name, p) for name, p in self.params.items())

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of `symbol_file`'s graph with inputs
        `input_names`, its parameters loaded from `param_file` onto
        `ctx` (default: the current context, gpu(0))."""
        from ..symbol import load as sym_load
        from ..symbol import Symbol
        sym = sym_load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [Symbol.var(n) for n in input_names]
        block = SymbolBlock(sym, inputs)
        if param_file:
            block.collect_params().load(param_file, ctx)
        return block

    def collect_params(self, select=None):
        ret = super().collect_params(select)
        pattern = re.compile(select) if select is not None else None
        ret.update({n: p for n, p in self._graph_params.items()
                    if pattern is None or pattern.match(n)})
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        return {prefix + k: v for k, v in self._graph_params.items()}

    def _eager_forward(self, *args):
        bindings = {s.name: a for s, a in zip(self._in_syms, args)}
        for name, p in self._graph_params.items():
            bindings[name] = p.data()
        return self._out_sym.eval_with(bindings)


@contextlib.contextmanager
def record_rows(params, rows_out):
    """Within the scope, the row lookups of every `grad_stype ==
    "row_sparse"` parameter of `params` (an `Embedding(sparse_grad=True)`
    weight) record their ids in `rows_out` under the parameter's index
    in `params`, as flat tensors (a table looked up twice gets both).
    The read counters `_trace_reads` and `_rows_lookups` of every
    parameter start from 0 and keep their counts after the scope, for
    the caller to compare."""
    for i, p in enumerate(params):
        p._trace_reads = p._rows_lookups = 0
        if p.grad_stype == "row_sparse":
            p._rows_sink = (rows_out, i)
    try:
        yield rows_out
    finally:
        for p in params:
            p._rows_sink = None
