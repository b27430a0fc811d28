"""Parameter / ParameterDict (counterpart of
`incubator_mxnet_tpu/gluon/parameter.py`).

A Parameter carries a name, a shape that may be left partly unknown
until the first forward (deferred init), a dtype and an initializer.
Once initialized its data is one `torch.nn.Parameter` on one device.
Every Block that holds the Parameter as an attribute also registers that
`nn.Parameter` in its own `_parameters` under the attribute name, so
`named_parameters()`, `state_dict()` and `.to()` see the weights.

Its gradient is the `nn.Parameter`'s `.grad`, a zero buffer until the
first backward.  `grad_req` "write" makes each `autograd.backward`
overwrite it, "add" accumulates across backward calls, "null" keeps no
gradient (`requires_grad` off).  With `grad_stype="row_sparse"` a
"write" backward through `Embedding(sparse_grad=True)` leaves a sparse
gradient, which `grad()` gives as a `RowSparseNDArray`; the data itself
is always dense, whatever `stype` says, as in the JAX package.

`data()` counts its reads in `_trace_reads`, and a rows-recording
`Embedding` its lookups in `_rows_lookups`, while `ParallelTrainer`
records the rows a step looks up (`_rows_sink`): more reads than
lookups means another op read the table too (a tied decoder), and the
trainer takes the dense update.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype, dtype_name
from ..ndarray.ndarray import _GRAD_REQS, _numpy_dtype_32
from ..context import Context, as_device
from .. import initializer as init_mod
from ..ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape was inferred."""


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        """`lr_mult` and `wd_mult` scale the learning rate and weight
        decay that `gluon.Trainer` applies to this parameter."""
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        if grad_req not in _GRAD_REQS:
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        self._grad_req = grad_req if differentiable else "null"
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.stype = stype
        self.grad_stype = grad_stype
        self._data = None           # nn.Parameter once initialized
        self._deferred_init = None  # (init, device, default_init)
        self._owners = []           # (weakref to Block, attribute name)
        self._rows_sink = None      # (rows dict, index) while a step
        self._trace_reads = 0       # records the rows it looks up
        self._rows_lookups = 0

    @property
    def shape(self):
        return self._shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise MXNetError(f"invalid grad_req {req!r}")
        self._grad_req = req
        if self._data is not None:
            self._set_tensor(self._data)

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and (
                len(self._shape) != len(new_shape) or any(
                    s != 0 and s != n for s, n in zip(self._shape, new_shape))):
            raise MXNetError(
                f"cannot reset shape of {self.name} from {self._shape} "
                f"to {new_shape}")
        self._shape = new_shape

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    # ------------------------------------------------------------------
    def _attach(self, block, attr):
        self._owners.append((weakref.ref(block), attr))
        if self._data is not None:
            block._parameters[attr] = self._data

    def _set_tensor(self, t):
        """Make `t` the data, as a fresh nn.Parameter seen by every
        owning Block."""
        self._data = torch.nn.Parameter(
            t.detach(), requires_grad=self.grad_req != "null"
            and t.is_floating_point())
        self._data._grad_req = self.grad_req
        self._data._grad_stype = self.grad_stype
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                block._parameters[attr] = self._data

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._data is not None and not force_reinit:
            return
        device = as_device(ctx)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init)
                return
            raise MXNetError(
                f"cannot initialize {self.name}: shape {self._shape} unknown; "
                "set allow_deferred_init=True or provide full shape")
        self._finish_init(init, device, default_init)

    def _finish_init(self, initializer, device, default_init):
        chosen = initializer or self.init or default_init or init_mod.Uniform()
        t = torch.zeros(self._shape, dtype=torch.float32, device=device)
        init_mod.create(chosen)(self.name, t)
        self._set_tensor(t.to(torch_dtype(self.dtype)))
        self._deferred_init = None

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            raise DeferredInitializationError(
                f"parameter {self.name} was not initialized — call "
                ".initialize() before first forward")
        if not self._shape_known():
            raise DeferredInitializationError(
                f"parameter {self.name} shape {self._shape} still unknown")
        self._finish_init(*self._deferred_init)

    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} deferred init pending")
            raise MXNetError(
                f"parameter {self.name} has not been initialized; call "
                "net.initialize() first")

    # ------------------------------------------------------------------
    def data(self, ctx=None):
        self._check_initialized()
        self._trace_reads += 1
        return NDArray(self._data)

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        """The one context of the data (or of its pending init)."""
        if self._data is None and self._deferred_init is not None:
            return [Context.from_device(self._deferred_init[1])]
        self._check_initialized()
        return [Context.from_device(self._data.device)]

    def reset_ctx(self, ctx):
        """Move the data, and its gradient buffer, to `ctx`; a pending
        init will create it there."""
        device = as_device(ctx)
        if self._data is not None:
            grad = self._data.grad
            self._set_tensor(self._data.to(device))
            if grad is not None and self._data.requires_grad:
                self._data.grad = grad.to(device)
        elif self._deferred_init is not None:
            init, _, default = self._deferred_init
            self._deferred_init = (init, device, default)

    def grad(self, ctx=None):
        """The gradient as an NDArray over the `.grad` buffer (zeros
        before the first backward), or a `RowSparseNDArray` of a sparse
        one."""
        self._check_initialized()
        if not self._data.requires_grad:
            raise MXNetError(
                f"cannot get gradient of {self.name}: grad_req is 'null'")
        g = self._data.grad
        if g is None:
            g = self._data.grad = torch.zeros_like(self._data)
        if g.is_sparse:
            from ..ndarray.sparse import from_torch_sparse
            return from_torch_sparse(g)
        return NDArray(g)

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._data is not None and self._data.grad is not None:
            if self._data.grad.is_sparse:
                self._data.grad = None
            else:
                self._data.grad.zero_()

    def set_data(self, data, ctx=None):
        """Replace the values.  An initialized parameter keeps its device
        and dtype; an uninitialized one takes the shape of `data` and the
        device of its pending init, else `ctx`.  The values are copied,
        never shared with `data`, outside any graph: inside
        `autograd.record()` nothing is recorded."""
        t = data._data if isinstance(data, NDArray) else torch.as_tensor(data)
        t = t.detach()
        if self._data is None:
            self.shape = t.shape
            device = self._deferred_init[1] if self._deferred_init \
                else as_device(ctx)
            self._deferred_init = None
            self._set_tensor(t.to(device=device,
                                  dtype=torch_dtype(self.dtype), copy=True))
            return
        if tuple(t.shape) != self._shape:
            raise MXNetError(
                f"shape mismatch setting {self.name}: {tuple(t.shape)} vs "
                f"{self._shape}")
        with torch.no_grad():
            self._data.copy_(t)

    def cast(self, dtype):
        self.dtype = dtype_name(dtype)
        if self._data is not None:
            self._set_tensor(self._data.to(torch_dtype(dtype)))

    def __repr__(self):
        return f"Parameter {self.name} (shape={self._shape}, dtype={self.dtype})"


class Constant(Parameter):
    """A parameter that holds `value` and takes no gradient.  Its dtype
    is the value's, with numpy's float64 and int64 as float32 and int32
    (as the JAX package stores them)."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value.asnumpy()
        value = _np.asarray(value)
        value = value.astype(_numpy_dtype_32(value.dtype))
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype)

    def _finish_init(self, initializer, device, default_init):
        self._set_tensor(torch.from_numpy(self.value.copy()).to(
            device=device, dtype=torch_dtype(self.dtype)))
        self._deferred_init = None


class ParameterDict:
    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """Create-or-retrieve `prefix+name`."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None:
                    param.shape = tuple(v)
                elif k == "init" and v is not None and param.init is None:
                    param.init = v
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._params[name]
        return None

    def get_constant(self, name, value=None):
        """The `Constant` `prefix+name`, created from `value` if new."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            if value is None:
                raise MXNetError(f"no constant named {full}")
            param = Constant(full, value)
            self._params[full] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(None, ctx, default_init=init or init_mod.Uniform(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        """Set attribute `name` (grad_req, lr_mult, ...) on every
        parameter."""
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def save(self, filename, strip_prefix=""):
        """Write {name: data} to `filename` in the JAX package's `.npz`
        layout (`nd.save`), `strip_prefix` cut from the names."""
        from ..ndarray import save as nd_save
        arg = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p.data()
        nd_save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set the parameters from a file of `save` (either package's),
        `restore_prefix` put before its names.  An initialized parameter
        keeps its device and dtype; an uninitialized one takes the
        file's shape and dtype, on its pending init's device, else on
        `ctx`."""
        from ..ndarray import load_tensors
        loaded = {restore_prefix + k: v
                  for k, v in load_tensors(filename).items()}
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        for name, p in self.items():
            if name in loaded:
                if p._data is None:
                    p.dtype = dtype_name(loaded[name].dtype)
                p.set_data(loaded[name], ctx=ctx)
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing in file "
                                 f"{filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise MXNetError(f"extra parameters in file: {sorted(extra)}")

    def __repr__(self):
        body = "\n".join(f"  {v}" for v in self.values())
        return f"{type(self).__name__}(\n{body}\n)"
