"""NDArray: MXNet's array over a `torch.Tensor`.

Counterpart of `incubator_mxnet_tpu/ndarray/ndarray.py`: arithmetic
through the registered broadcast and scalar ops (a Python or numpy
scalar operand keeps the array's dtype, as the JAX `_scalar_*` ops
cast it), comparisons, `**`, `%`, `@`, indexing with NumPy's forms
(negative steps, None, Ellipsis, lists and integer index arrays; float
index arrays raise `TypeError`), the shape, reduction and math methods,
`copy`/`copyto`/`as_in_context`, `attach_grad`/`grad`/`backward`, the
DLPack hand-off, and the creation functions.  Operations record a graph
only inside `autograd.record()`.  `save`/`load` read and write the JAX
package's `.npz` layout, so parameter files cross between the packages
both ways.

Writes.  The JAX package's arrays are immutable, so a write (`x[k] =
v`, `x op= y`, `out=`) rebinds one NDArray and no other NDArray ever
sees it.  Here a write goes into the tensor itself, so every holder of
the one storage (a Parameter's `data()` too) sees it, with one rule
that keeps the JAX contract: an NDArray made as a view of another's
storage (an op whose output shares its input's storage: `reshape`,
`transpose`, basic indexing, `split`, `detach`, ...) is registered as a
view.  Writing a view first gives it a storage of its own; writing any
other holder of a storage first gives each live view of it a storage of
its own.  Views are copied only when one side is written, never when
they are made.  Inside `record()` an `op=` rebinds to the recorded
result and `x[k] = v` raises, as in the JAX package.
"""
from __future__ import annotations

import threading
import weakref

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype_32, dtype_name, numpy_dtype, \
    traced
from ..context import Context, as_device
from ..autograd import grad_scope, is_recording

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "linspace", "eye", "zeros_like", "ones_like", "from_numpy",
           "waitall", "save", "load", "load_tensors", "to_numpy"]

_GRAD_REQS = ("write", "add", "null")
_NUMERIC = (int, float, _np.generic)        # the JAX `numeric_types`
_INTEGER = (int, _np.integer)


# ----------------------------------------------------------------------
# views: storage -> the live NDArrays registered as views of it.  A
# reentrant lock: a collected view's weakref callback may run inside a
# locked section of the same thread.
# ----------------------------------------------------------------------
_VIEWS = {}
_VIEWS_LOCK = threading.RLock()


def _storage(t):
    return t.untyped_storage().data_ptr()


def _forget(key, ident):
    with _VIEWS_LOCK:
        group = _VIEWS.get(key)
        if group is not None:
            group.pop(ident, None)
            if not group:
                del _VIEWS[key]


def _register_view(nd):
    key = _storage(nd._data)
    ident = id(nd)
    ref = weakref.ref(nd, lambda _r, key=key, ident=ident:
                      _forget(key, ident))
    with _VIEWS_LOCK:
        _VIEWS.setdefault(key, {})[ident] = ref


def wrap(out, inputs=()):
    """NDArrays of tensor `out` (or a tuple/list of them), each
    registered as a view when it shares the storage of a tensor of
    `inputs`; anything else comes back as it is.  A traced tensor
    (`torch.export`, `make_fx`) has no storage and is never registered."""
    if isinstance(out, (tuple, list)):
        return tuple(wrap(o, inputs) for o in out)
    if not isinstance(out, torch.Tensor):
        return out
    nd = NDArray(out)
    if inputs and out.layout == torch.strided and not traced(out):
        ptrs = [_storage(t) for t in inputs if isinstance(t, torch.Tensor)
                and t.layout == torch.strided]
        if ptrs and _storage(out) in ptrs:
            _register_view(nd)
    return nd


def _numpy_dtype_32(dtype):
    """numpy's 64-bit types as the JAX package stores them without x64:
    float64, int64 and uint64 become float32, int32 and uint32."""
    return {"float64": _np.float32, "int64": _np.int32,
            "uint64": _np.uint32}.get(_np.dtype(dtype).name, dtype)


class NDArray:
    """An n-dimensional array on one device."""

    __slots__ = ("_data", "_recorded", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got "
                             f"{type(data).__name__}")
        self._data = data
        # made inside `record()`: `backward` from it is a sweep, which
        # writes nothing when no input takes a gradient
        self._recorded = is_recording()

    @property
    def data(self):
        """The underlying `torch.Tensor`."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        """The numpy dtype, as in the JAX package (`base.numpy_dtype`);
        the tensor's own is `.data.dtype`."""
        return numpy_dtype(self._data.dtype)

    @property
    def context(self):
        return Context.from_device(self._data.device)

    ctx = context

    @property
    def stype(self):
        """Storage type: "default" (dense); `sparse.RowSparseNDArray`
        is "row_sparse"."""
        return "default"

    @property
    def T(self):
        return self.transpose()

    def tostype(self, stype):
        """This array in storage `stype` ("default" or "row_sparse")."""
        if stype == "default":
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

    # -- conversion ----------------------------------------------------
    def asnumpy(self):
        return to_numpy(self._data)

    def asscalar(self):
        """The one element as a numpy scalar of the array's dtype (a
        bfloat16 array's as float32)."""
        if self.size != 1:
            raise MXNetError(f"asscalar needs one element, got {self.shape}")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def tolist(self):
        return self.asnumpy().tolist()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def astype(self, dtype, copy=True):
        """This array cast to `dtype` (float64 and int64 as float32 and
        int32); with `copy=False` and the same dtype, this array itself
        (the JAX method's rule)."""
        dt = torch_dtype_32(dtype)
        if not copy and dt == self._data.dtype:
            return self
        from ..ops.registry import apply_op
        return apply_op("cast", self, dtype=dt)

    def copy(self):
        return self._apply("_copy")

    def copyto(self, other):
        """Copy into NDArray `other` (a write: its holders see the
        values, its views do not), or onto Context `other`."""
        if isinstance(other, NDArray):
            other._assign(self._data.to(other._data.device))
            return other
        if isinstance(other, Context):
            with grad_scope():
                return NDArray(self._data.to(other.torch_device, copy=True))
        raise MXNetError("copyto target must be NDArray or Context")

    def as_in_context(self, ctx):
        """This array on `ctx`: itself when it is there already."""
        dev = as_device(ctx)
        if dev == self._data.device:
            return self
        with grad_scope():
            return NDArray(self._data.to(dev))

    as_in_ctx = as_in_context

    def wait_to_read(self):
        """Block until the values are computed (the device's queue)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    # -- DLPack ----------------------------------------------------------
    def __dlpack__(self, stream=None):
        return self._data.detach().__dlpack__(stream=stream)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def to_dlpack_for_read(self):
        """A DLPack capsule over this array's storage (no copy)."""
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    def to_dlpack_for_write(self):
        """A DLPack capsule whose writes land in this array (and in every
        holder of its storage, not in its views: they get a storage of
        their own first).  The JAX package raises here: its buffers
        cannot be written."""
        self._prepare_write()
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    # -- autograd ------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a leaf with a zero gradient buffer of its
        shape, overwritten ("write") or accumulated ("add") by each
        `backward`; with "null" no backward writes it."""
        if grad_req not in _GRAD_REQS:
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        t = self._data.detach()
        t.requires_grad_(grad_req != "null")
        t.grad = torch.zeros_like(t)
        t._grad_req = grad_req
        self._data = t

    @property
    def grad(self):
        """The gradient buffer, or None without `attach_grad`."""
        g = self._data.grad
        return None if g is None else NDArray(g)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        return wrap(self._data.detach(), (self._data,))

    # -- writes --------------------------------------------------------
    def _rebind(self, t):
        """Make `t` this array's tensor; a gradient-taking leaf stays
        one, with its gradient buffer and grad_req."""
        old = self._data
        if old.is_leaf and old.requires_grad:
            t = t.detach().requires_grad_(True)
            t.grad = old.grad
            for attr in ("_grad_req", "_grad_stype"):
                if hasattr(old, attr):
                    setattr(t, attr, getattr(old, attr))
        self._data = t

    def _prepare_write(self):
        """Before an in-place write: a registered view takes a storage of
        its own; any other holder first gives each live view of its
        storage one of their own."""
        key = _storage(self._data)
        with _VIEWS_LOCK:
            group = _VIEWS.get(key)
            if not group:
                return
            me = group.get(id(self))
            mine = me is not None and me() is self
            if mine:
                _forget(key, id(self))
            else:
                views = [ref() for ref in group.values()]
                del _VIEWS[key]
        with torch.no_grad():
            if mine:
                self._rebind(self._data.clone())
                return
            for view in views:
                if view is not None and _storage(view._data) == key:
                    view._rebind(view._data.clone())

    def _assign(self, t):
        """Write the values of tensor `t` into this array (`out=`,
        `copyto`): in place when shape and dtype agree outside
        `record()`, else this array is rebound to `t` (the JAX
        package rebinds always); inside `record()` to the recorded
        result itself."""
        if is_recording():
            self._data = t
            return
        if tuple(t.shape) != self.shape or t.dtype != self._data.dtype:
            self._rebind(t)
            return
        self._prepare_write()
        with torch.no_grad():
            if _storage(t) == _storage(self._data):
                t = t.clone()
            self._data.copy_(t)

    # -- indexing --------------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self._data.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, key):
        spec, arrays = _canon_index(key, self._data.device)
        from ..ops.registry import apply_op
        if arrays:
            return apply_op("_fancy_index", self, *arrays, key_spec=spec)
        return apply_op("_index", self, key_spec=spec)

    def __setitem__(self, key, value):
        """Assignment, outside any recorded graph (inside `record()` it
        raises, as in the JAX package).  Numbers and numpy values are
        cast to this array's dtype; a Python integer out of an integer
        dtype's range raises `OverflowError`, as there."""
        if is_recording():
            raise MXNetError("in-place assignment on an array is not "
                             "allowed inside autograd.record()")
        spec, arrays = _canon_index(key, self._data.device)
        idx, padded = _write_index(rebuild_index(spec, arrays),
                                   self._data.shape)
        if idx is None:
            return                  # an integer key past the end: dropped
        self._prepare_write()
        t = self._data
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            value = value.to(device=t.device, dtype=t.dtype)
            if value.layout == torch.strided and \
                    _storage(value) == _storage(t):
                value = value.clone()
        else:
            if isinstance(value, int) and not isinstance(value, bool) \
                    and not t.is_floating_point() and t.dtype != torch.bool:
                from ..ops.math import scalar_of
                scalar_of(value, t.dtype)       # out of range: raises
            value = torch.as_tensor(_np.asarray(value)).to(device=t.device,
                                                           dtype=t.dtype)
        with torch.no_grad():
            if padded:
                _put_in_range(t, idx, padded, value)
                return
            flips, tkey = torch_index(idx, t.shape)
            if not flips:
                t[tkey] = value
                return
            # a negative step: write through the flat positions it selects
            pos = torch.arange(t.numel(), device=t.device).reshape(t.shape)
            sel = pos.flip(flips)[tkey]
            t.put_(sel.reshape(-1), value.expand(sel.shape).reshape(-1))

    # -- arithmetic ----------------------------------------------------
    @staticmethod
    def _raw(o):
        return o._data if isinstance(o, NDArray) else o

    def _apply(self, name, *others, **attrs):
        from ..ops.registry import apply_op
        return apply_op(name, self, *others, **attrs)

    def _binary(self, other, op, scalar_op, reverse=False):
        """The JAX `_binary`: an NDArray operand through the broadcast
        op, a number through the scalar op (cast to this dtype), a numpy
        array as an NDArray of its dtype (64-bit types as 32-bit)."""
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return a._apply(op, b)
        if isinstance(other, _NUMERIC):
            return self._apply(scalar_op, scalar=other, reverse=reverse)
        if isinstance(other, _np.ndarray):
            return self._binary(
                array(other, ctx=self.context,
                      dtype=_numpy_dtype_32(other.dtype)),
                op, scalar_op, reverse)
        if isinstance(other, torch.Tensor):
            return self._binary(NDArray(other), op, scalar_op, reverse)
        return NotImplemented

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

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_scalar_power",
                            reverse=True)

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_scalar_mod")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_scalar_mod", reverse=True)

    def __matmul__(self, o):
        return self._apply("dot", o)

    def __neg__(self):
        return self._apply("negative")

    def __abs__(self):
        return self._apply("abs")

    def _inplace(self, other, op, scalar_op):
        """`x op= y`: the JAX `_inplace`, which rebinds x to `x op y`.
        Outside `record()` a result of x's shape and dtype is written
        into x's tensor instead, so every holder of x (a Parameter's
        `data()` too) sees it; inside, x is rebound to the recorded
        result."""
        res = self._binary(other, op, scalar_op)
        if res is NotImplemented:
            return res
        self._assign(res._data)
        return self

    def __iadd__(self, o):
        return self._inplace(o, "broadcast_add", "_scalar_add")

    def __isub__(self, o):
        return self._inplace(o, "broadcast_sub", "_scalar_sub")

    def __imul__(self, o):
        return self._inplace(o, "broadcast_mul", "_scalar_mul")

    def __itruediv__(self, o):
        return self._inplace(o, "broadcast_div", "_scalar_div")

    # -- comparison and truth: 1 where it holds and 0 elsewhere, in the
    # data's dtype (the JAX `broadcast_equal` family) --------------------
    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_scalar_equal")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_scalar_not_equal")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_scalar_greater")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_scalar_greater_equal")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_scalar_lesser")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_scalar_lesser_equal")

    __hash__ = None   # a mutable array, as in the JAX package

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous")
        return bool(self.asscalar())

    def __repr__(self):
        a = self.asnumpy()
        if self._data.dtype == torch.bfloat16:
            a = a.astype(numpy_dtype(torch.bfloat16))
        return (f"\n{a}\n<NDArray {'x'.join(map(str, self.shape))}"
                f" @{self.context}>")

    # -- shape ---------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """MXNet's reshape codes; `reverse=True` matches them from the
        right, as the `reshape` op does (the JAX method drops it)."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = kwargs.pop("shape", shape)
        return self._apply("reshape", shape=tuple(shape),
                           reverse=kwargs.pop("reverse", False))

    def reshape_like(self, other):
        return self._apply("reshape", shape=other.shape)

    def transpose(self, axes=None):
        return self._apply("transpose", axes=axes)

    def flatten(self):
        return self._apply("flatten")

    def expand_dims(self, axis):
        return self._apply("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._apply("squeeze", axis=axis)

    def swapaxes(self, dim1, dim2):
        return self._apply("swapaxes", dim1=dim1, dim2=dim2)

    def broadcast_to(self, shape):
        return self._apply("broadcast_to", shape=tuple(shape))

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def slice_axis(self, axis, begin, end):
        return self._apply("slice_axis", axis=axis, begin=begin, end=end)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._apply("split", num_outputs=num_outputs, axis=axis,
                           squeeze_axis=squeeze_axis)

    def flip(self, axis):
        return self._apply("flip", axis=axis)

    def tile(self, reps):
        return self._apply("tile", reps=tuple(reps))

    def repeat(self, repeats, axis=None):
        return self._apply("repeat", repeats=repeats, axis=axis)

    def pad(self, mode="constant", pad_width=None, constant_value=0.0):
        return self._apply("pad", mode=mode, pad_width=tuple(pad_width),
                           constant_value=constant_value)

    def take(self, indices, axis=0, mode="clip"):
        return self._apply("take", indices, axis=axis, mode=mode)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return self._apply("one_hot", depth=depth, on_value=on_value,
                           off_value=off_value, dtype=dtype)

    def dot(self, other):
        return self._apply("dot", other)

    # -- reductions and elementwise math ---------------------------------
    def _reduce(self, op, axis, keepdims):
        if isinstance(axis, list):
            axis = tuple(axis)
        return self._apply(op, axis=axis, keepdims=keepdims)

    def sum(self, axis=None, keepdims=False, **kw):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return self._reduce("prod", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._apply("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._apply("argmin", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        if isinstance(axis, list):
            axis = tuple(axis)
        return self._apply("norm", ord=ord, axis=axis, keepdims=keepdims)

    def clip(self, a_min=None, a_max=None):
        return self._apply("clip", a_min=a_min, a_max=a_max)

    def abs(self):
        return self._apply("abs")

    def sqrt(self):
        return self._apply("sqrt")

    def square(self):
        return self._apply("square")

    def exp(self):
        return self._apply("exp")

    def log(self):
        return self._apply("log")

    def sigmoid(self):
        return self._apply("sigmoid")

    def tanh(self):
        return self._apply("tanh")

    def relu(self):
        return self._apply("relu")

    def softmax(self, axis=-1):
        return self._apply("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._apply("log_softmax", axis=axis)


# ----------------------------------------------------------------------
# indexing: the JAX package's key encoding, read into torch's indexing
# ----------------------------------------------------------------------

def _index_tensor(a, device):
    """An integer or bool index array as a tensor on `device`; float
    index arrays raise TypeError, as `jnp` indexing does."""
    t = a._data if isinstance(a, NDArray) else torch.as_tensor(
        _np.asarray(a))
    if t.is_floating_point() or t.is_complex():
        raise TypeError(f"index arrays must be of integer or boolean "
                        f"type, got {dtype_name(t.dtype)}")
    if t.dtype != torch.bool:
        t = t.to(torch.int64)
    return t.to(device)


def _canon_index(key, device):
    """(spec, index arrays): the JAX `_canon_index` encoding, a hashable
    spec with ("__arr__", i) in place of each index array (NDArrays,
    numpy arrays and non-object lists), as int64 or bool tensors."""
    arrays = []

    def conv(k):
        if isinstance(k, (NDArray, torch.Tensor, _np.ndarray)):
            arrays.append(_index_tensor(k, device))
            return ("__arr__", len(arrays) - 1)
        if isinstance(k, slice):
            return ("__slice__", k.start, k.stop, k.step)
        if k is Ellipsis:
            return "__ellipsis__"
        if k is None:
            return "__newaxis__"
        if isinstance(k, (list, tuple)):
            arr = _np.asarray(k)
            if arr.dtype == object:
                raise MXNetError(f"unsupported index component {k!r}")
            arrays.append(_index_tensor(arr, device))
            return ("__arr__", len(arrays) - 1)
        if isinstance(k, _INTEGER):
            return int(k)
        raise MXNetError(f"unsupported index component {k!r}")

    if isinstance(key, tuple):
        spec = ("__tuple__",) + tuple(conv(k) for k in key)
    else:
        spec = conv(key)
    return spec, arrays


def rebuild_index(spec, arrays):
    """The index tuple that `spec` encodes, with `arrays` in place."""
    def un(s):
        if isinstance(s, tuple):
            if s and s[0] == "__arr__":
                return arrays[s[1]]
            if s and s[0] == "__slice__":
                return slice(s[1], s[2], s[3])
            if s and s[0] == "__tuple__":
                return tuple(un(x) for x in s[1:])
            return tuple(un(x) for x in s)
        if s == "__ellipsis__":
            return Ellipsis
        if s == "__newaxis__":
            return None
        return s
    out = un(spec)
    return out if isinstance(out, tuple) else (out,)


def _component_dims(idx, ndim):
    """The dim of the indexed array that each component of index tuple
    `idx` starts at (None for a new axis)."""
    used = sum(0 if k is None or k is Ellipsis else
               (k.ndim if isinstance(k, torch.Tensor) and
                k.dtype == torch.bool else 1) for k in idx)
    dims, dim = [], 0
    for k in idx:
        if k is None:
            dims.append(None)
            continue
        dims.append(dim)
        if k is Ellipsis:
            dim += ndim - used
        elif isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            dim += k.ndim
        else:
            dim += 1
    return dims


def _is_int_array(k):
    return isinstance(k, torch.Tensor) and k.dtype != torch.bool


def clamp_index(idx, shape):
    """`idx` read as a `jnp` gather reads it: each integer and integer
    array component counts from the end where negative and is then
    clamped into [0, n - 1], so an index past either end reads the
    nearest row."""
    out = []
    for k, dim in zip(idx, _component_dims(idx, len(shape))):
        if isinstance(k, _INTEGER) and not isinstance(k, bool):
            n = shape[dim]
            k = min(max(k + n if k < 0 else k, 0), n - 1)
        elif _is_int_array(k):
            n = shape[dim]
            k = torch.where(k < 0, k + n, k).clamp(0, n - 1)
        out.append(k)
    return tuple(out)


def _write_index(idx, shape):
    """(idx, the dims of its integer index arrays if one of them reaches
    past an end, else ()) for a write, which drops what lies out of
    range as `.at[].set` does; idx is None when an integer component is
    out of range (nothing is written)."""
    bad, arrays = [], []
    for k, dim in zip(idx, _component_dims(idx, len(shape))):
        if isinstance(k, _INTEGER) and not isinstance(k, bool):
            if not -shape[dim] <= k < shape[dim]:
                return None, ()
        elif _is_int_array(k) and k.numel():
            arrays.append(dim)
            bad.append(((k < -shape[dim]) | (k >= shape[dim])).any())
    if not bad or not bool(torch.stack(bad).any()):
        return idx, ()
    return idx, tuple(arrays)


def _put_in_range(t, idx, padded, value):
    """`t[idx] = value` with the entries of the index arrays on dims
    `padded` that lie out of range dropped: the array is read through a
    table of its flat positions with one more row on each such dim, the
    row that every out-of-range index is sent to, holding -1."""
    shape = tuple(t.shape)
    table = torch.full(tuple(n + (d in padded) for d, n in enumerate(shape)),
                       -1, dtype=torch.int64, device=t.device)
    table[tuple(slice(0, n) for n in shape)] = torch.arange(
        t.numel(), device=t.device).reshape(shape)
    key = []
    for k, dim in zip(idx, _component_dims(idx, len(shape))):
        if dim in padded and _is_int_array(k):
            n = shape[dim]
            k = torch.where(k < 0, k + n, k)
            k = torch.where((k < 0) | (k >= n), n, k)
        key.append(k)
    flips, tkey = torch_index(tuple(key), table.shape)
    sel = (table.flip(flips) if flips else table)[tkey]
    ok = sel >= 0
    t.put_(sel[ok], value.expand(sel.shape)[ok])


def torch_index(idx, shape):
    """(dims to flip, key) such that `t.flip(dims)[key]` is NumPy's
    `t[idx]`: torch takes no negative slice step, so each such slice
    becomes a positive one over its dim flipped."""
    flips, out = [], []
    for k, dim in zip(idx, _component_dims(idx, len(shape))):
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = shape[dim]
            r = range(*k.indices(n))
            if len(r) == 0:
                k = slice(0, 0)
            else:
                flips.append(dim)
                k = slice(n - 1 - r[0], n - r[-1], -k.step)
        out.append(k)
    return flips, tuple(out)


# ----------------------------------------------------------------------
# creation
# ----------------------------------------------------------------------

def to_numpy(t):
    """A host numpy copy of tensor `t` (never its memory: a later write
    into the tensor leaves it); bfloat16 comes back as float32, which
    holds every bfloat16 value exactly."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).cpu().numpy()
    return t.cpu().numpy().copy() if t.device.type == "cpu" \
        else t.cpu().numpy()


def array(source_array, ctx=None, dtype=None):
    """An NDArray of `source_array` on `ctx` (default: the current
    context, gpu(0)).  The dtype defaults, as in the JAX package, to a
    numpy array's own with its 64-bit types as 32-bit ones (float64,
    int64 and uint64 become float32, int32 and uint32, as JAX stores them
    without x64), a tensor's or NDArray's own, and float32 for Python
    lists, tuples and scalars and numpy scalars.  A 0-d source gives a
    0-d array.  An explicit `dtype` of float64 or int64 is stored as
    float32 or int32, as in the JAX package.  The result owns its
    storage, as the JAX package's does: writing into it never changes
    the source, on any device."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        t = source_array
    else:
        src = _np.asarray(source_array)
        if dtype is None:
            src = src.astype(_numpy_dtype_32(src.dtype)
                             if isinstance(source_array, _np.ndarray)
                             else _np.float32)
        t = torch.from_numpy(_np.require(src, requirements=("C", "W")))
    dev = as_device(ctx)
    with torch.no_grad():
        return NDArray(t.to(device=dev, dtype=None if dtype is None
                            else torch_dtype_32(dtype), copy=True))


def from_numpy(a, zero_copy=False):
    """`array(a)`: a copy, as in the JAX package."""
    return array(a)


def _filled(shape, ctx, dtype, fill):
    if isinstance(shape, _INTEGER):
        shape = (int(shape),)
    return NDArray(torch.full(tuple(shape), fill, dtype=torch_dtype_32(
        dtype if dtype is not None else "float32"), device=as_device(ctx)))


def zeros(shape, ctx=None, dtype=None, **kw):
    return _filled(shape, ctx, dtype, 0)


def ones(shape, ctx=None, dtype=None, **kw):
    return _filled(shape, ctx, dtype, 1)


def full(shape, val, ctx=None, dtype=None, **kw):
    return _filled(shape, ctx, dtype, val)


def empty(shape, ctx=None, dtype=None):
    """Zeros, as the JAX package's `empty` gives."""
    return zeros(shape, ctx, dtype)


def zeros_like(a, **kw):
    """Zeros of `a`'s shape, dtype and device (other arguments are taken
    and ignored, as in the JAX package)."""
    return NDArray(torch.zeros_like(NDArray._raw(a),
                                    memory_format=torch.contiguous_format))


def ones_like(a, **kw):
    return NDArray(torch.ones_like(NDArray._raw(a),
                                   memory_format=torch.contiguous_format))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """numpy's `arange` (in float64, then cast), each value `repeat`
    times; float32 unless `dtype` says otherwise."""
    a = _np.arange(start, stop, step)
    if repeat != 1:
        a = _np.repeat(a, repeat)
    return array(a, ctx=ctx, dtype=dtype if dtype is not None else "float32")


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    return array(_np.linspace(start, stop, num, endpoint=endpoint), ctx=ctx,
                 dtype=dtype if dtype is not None else "float32")


def eye(N, M=0, k=0, ctx=None, dtype=None):
    return array(_np.eye(N, M if M else N, k), ctx=ctx,
                 dtype=dtype if dtype is not None else "float32")


def waitall():
    """Block until every queued operation of every card is done."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ----------------------------------------------------------------------
# files
# ----------------------------------------------------------------------

def save(fname, data):
    """Write an NDArray, a list of them or {name: NDArray} to one `.npz`
    file in the JAX package's layout, which needs no pickle: `arr_<i>`,
    a `__dtypes__` array of dtype names and, for a dict, a `__names__`
    array.  numpy has no bfloat16, so such arrays are stored as their
    uint16 bit patterns.  Torch tensors are taken beside NDArrays."""
    if isinstance(data, (NDArray, torch.Tensor)):
        names, payload = None, [data]
    elif isinstance(data, (list, tuple)):
        names, payload = None, list(data)
    elif isinstance(data, dict):
        names = list(data)
        payload = [data[k] for k in names]
    else:
        raise MXNetError("save expects NDArray, list, or dict")
    arrays, dtypes = {}, []
    for i, a in enumerate(payload):
        t = (a._data if isinstance(a, NDArray) else a).detach().cpu() \
            .contiguous()
        dtypes.append(dtype_name(t.dtype))
        arrays[f"arr_{i}"] = (t.view(torch.int16).numpy().view(_np.uint16)
                              if t.dtype == torch.bfloat16 else t.numpy())
    arrays["__dtypes__"] = _np.array(dtypes)
    if names is not None:
        arrays["__names__"] = _np.array(names)
    with open(fname, "wb") as f:
        _np.savez(f, **arrays)


def load_tensors(fname):
    """Read a file written by `save` (either package's) as CPU tensors:
    {name: tensor} for a dict, else a list."""
    with _np.load(fname, allow_pickle=False) as z:
        n = sum(k.startswith("arr_") for k in z.files)
        dtypes = ([str(d) for d in z["__dtypes__"]]
                  if "__dtypes__" in z.files else [None] * n)
        payload = []
        for i in range(n):
            a = z[f"arr_{i}"]
            if dtypes[i] == "bfloat16":
                t = torch.from_numpy(a.view(_np.int16).copy()) \
                    .view(torch.bfloat16)
            else:
                if dtypes[i] and a.dtype.name != dtypes[i]:
                    a = a.view(_np.dtype(dtypes[i]))
                t = torch.from_numpy(a.copy())
            payload.append(t)
        if "__names__" in z.files:
            return dict(zip((str(k) for k in z["__names__"]), payload))
        return payload


def load(fname):
    """Read a file written by `save` (either package's): {name: NDArray}
    for a dict, else a list of NDArrays, on the current context."""
    loaded = load_tensors(fname)
    if isinstance(loaded, dict):
        return {k: array(t) for k, t in loaded.items()}
    return [array(t) for t in loaded]

