"""NDArray: MXNet's array over a `torch.Tensor`.

Counterpart of `incubator_mxnet_tpu/ndarray/ndarray.py`, with the
surface the Gluon blocks, the models and the imperative training loops
use: arithmetic, comparisons, `reshape` with MXNet's special codes,
`expand_dims`, `squeeze`, `swapaxes`, `split`, `slice_axis`, the
reductions `sum`/`mean`/`norm`, `clip`, `sigmoid`/`tanh`/`relu`,
`astype`, `asnumpy`, `shape`/`dtype`/`context`,
`attach_grad`/`grad`/`backward`/`detach`/`wait_to_read`, in-place
assignment `x[key] = y`, and the creation functions
`array`/`zeros`/`zeros_like`/`ones_like`.  Operations record a graph
only inside `autograd.record()`.  Assignment writes into the tensor
itself (the JAX package rebinds an immutable array), so every holder
of the NDArray sees the new values.  `save`/`load` read and write the
JAX package's `.npz` layout, so parameter files cross between the
packages both ways.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype, dtype_name, numpy_dtype
from ..context import Context, as_device
from ..autograd import grad_scope, is_recording

__all__ = ["NDArray", "array", "zeros", "zeros_like", "ones_like", "save",
           "load", "load_tensors", "to_numpy"]

_GRAD_REQS = ("write", "add", "null")


class NDArray:
    """An n-dimensional array on one device."""

    __slots__ = ("_data", "_recorded")

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

    @property
    def stype(self):
        """Storage type: "default" (dense); `sparse.RowSparseNDArray`
        is "row_sparse"."""
        return "default"

    def tostype(self, stype):
        """This array in storage `stype` ("default" or "row_sparse")."""
        from .sparse import cast_storage
        return cast_storage(self, stype)

    def asnumpy(self):
        return to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError(f"asscalar needs one element, got {self.shape}")
        return self.asnumpy().reshape(()).item()

    def astype(self, dtype, copy=True):
        with grad_scope():
            out = self._data.to(torch_dtype(dtype))
            return NDArray(out.clone() if copy and out is self._data
                           else out)

    def as_in_context(self, ctx):
        with grad_scope():
            return NDArray(self._data.to(as_device(ctx)))

    def wait_to_read(self):
        """Block until the values are computed (the device's queue)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

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
        return NDArray(self._data.detach())

    def __repr__(self):
        return (f"\n{self.asnumpy()!r}\n<NDArray {'x'.join(map(str, self.shape))}"
                f" @{self.context}>")

    def __len__(self):
        return self._data.shape[0]

    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data
        with grad_scope():
            return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """In-place assignment, outside any recorded graph."""
        if isinstance(key, NDArray):
            key = key._data
        with torch.no_grad():
            self._data[key] = self._raw(value)

    # -- arithmetic ----------------------------------------------------
    @staticmethod
    def _raw(o):
        return o._data if isinstance(o, NDArray) else o

    def _op(self, fn, *others):
        with grad_scope():
            return NDArray(fn(self._data, *map(self._raw, others)))

    def __add__(self, o):
        return self._op(torch.add, o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._op(torch.sub, o)

    def __rsub__(self, o):
        return self._op(lambda a, b: b - a, o)

    def __mul__(self, o):
        return self._op(torch.mul, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._op(torch.div, o)

    def __rtruediv__(self, o):
        return self._op(lambda a, b: b / a, o)

    def __neg__(self):
        return self._op(torch.neg)

    def _inplace(self, method, o):
        """`x op= o` writes into x's own tensor, so every holder of x
        (a Parameter's `data()` too) sees the new values, as the JAX
        package's `_inplace` rebinds the one array they share.  Inside
        `record()` torch's in-place rules apply."""
        with grad_scope():
            getattr(self._data, method)(self._raw(o))
        return self

    def __iadd__(self, o):
        return self._inplace("add_", o)

    def __isub__(self, o):
        return self._inplace("sub_", o)

    def __imul__(self, o):
        return self._inplace("mul_", o)

    def __itruediv__(self, o):
        return self._inplace("div_", o)

    # -- comparison and truth -------------------------------------------
    def _compare(self, fn, o):
        """1 where `fn` holds and 0 elsewhere, in the data's dtype (the
        JAX `broadcast_equal` family)."""
        if not isinstance(o, (NDArray, torch.Tensor, int, float, bool,
                              _np.ndarray, _np.number)):
            return NotImplemented
        if isinstance(o, (_np.ndarray, _np.number)):
            o = torch.as_tensor(o, device=self._data.device)
        with torch.no_grad():
            return NDArray(fn(self._data, self._raw(o)).to(self._data.dtype))

    def __eq__(self, o):
        if o is None:
            return False
        return self._compare(torch.eq, o)

    def __ne__(self, o):
        if o is None:
            return True
        return self._compare(torch.ne, o)

    def __gt__(self, o):
        return self._compare(torch.gt, o)

    def __ge__(self, o):
        return self._compare(torch.ge, o)

    def __lt__(self, o):
        return self._compare(torch.lt, o)

    def __le__(self, o):
        return self._compare(torch.le, o)

    __hash__ = None   # a mutable array, as in the JAX package

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous")
        return bool(self.asscalar())

    # -- shape ---------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = kwargs.pop("shape", shape)
        from ..ops.shape import reshape
        reverse = kwargs.pop("reverse", False)
        return self._op(lambda t: reshape(t, shape=shape, reverse=reverse))

    def expand_dims(self, axis):
        return self._op(lambda t: t.unsqueeze(axis))

    def slice_axis(self, axis, begin, end):
        from ..ops.shape import slice_axis
        return self._op(lambda t: slice_axis(t, axis=axis, begin=begin,
                                             end=end))

    def _apply(self, name, **attrs):
        from ..ops.registry import apply_op
        return apply_op(name, self, **attrs)

    def squeeze(self, axis=None):
        return self._apply("squeeze", axis=axis)

    def swapaxes(self, dim1, dim2):
        return self._apply("swapaxes", dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._apply("split", num_outputs=num_outputs, axis=axis,
                           squeeze_axis=squeeze_axis)

    # -- reductions and elementwise math ---------------------------------
    def sum(self, axis=None, keepdims=False):
        return self._apply("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._apply("mean", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._apply("norm", ord=ord, axis=axis, keepdims=keepdims)

    def clip(self, a_min=None, a_max=None):
        return self._apply("clip", a_min=a_min, a_max=a_max)

    def sigmoid(self):
        return self._apply("sigmoid")

    def tanh(self):
        return self._apply("tanh")

    def relu(self):
        return self._apply("relu")


def to_numpy(t):
    """A host numpy copy of tensor `t`; bfloat16 comes back as float32,
    which holds every bfloat16 value exactly."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def array(source_array, ctx=None, dtype=None):
    """An NDArray of `source_array` on `ctx` (default: the current
    context, gpu(0)).  The dtype defaults, as in the JAX package, to a
    numpy array's own (float32 for float64), a tensor's or NDArray's
    own, and float32 for Python lists, tuples and scalars and numpy
    scalars.  A 0-d source gives a 0-d array.  The result owns its
    storage, as the JAX package's does: writing into it never changes
    the source, on any device."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        t = source_array
    else:
        src = _np.asarray(source_array)
        if dtype is None and not (isinstance(source_array, _np.ndarray)
                                  and src.dtype != _np.float64):
            src = src.astype(_np.float32)
        t = torch.from_numpy(_np.require(src, requirements=("C", "W")))
    dev = as_device(ctx)
    return NDArray(t.to(device=dev, dtype=None if dtype is None
                        else torch_dtype(dtype), copy=True))


def zeros(shape, ctx=None, dtype="float32"):
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=as_device(ctx)))


def zeros_like(a):
    return NDArray(torch.zeros_like(NDArray._raw(a)))


def ones_like(a):
    return NDArray(torch.ones_like(NDArray._raw(a)))


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
