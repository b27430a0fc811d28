"""Row-sparse storage (counterpart of the `row_sparse` half of
`incubator_mxnet_tpu/ndarray/sparse.py`).

A `RowSparseNDArray` is a struct of two tensors on one device, as in
the JAX package: `data` of shape (nnz_rows, *row_shape) and sorted,
unique int64 row `indices`.  It is what `Embedding(sparse_grad=True)`
gives as its weight's gradient, and what the lazy optimizer updates
take: `sgd_update_rsp`, `sgd_mom_update_rsp` and `adam_update_rsp`
touch only the gradient's rows, so every other row keeps its weight and
its optimizer state.

Dense materialisation is explicit (`tostype("default")`); indexing and
assignment raise, and NDArray's dense methods do not apply.  `+`, `-` and `*` of two row-sparse arrays stay
row-sparse over the union of their rows, a row-sparse array times a
Python number stays row-sparse, and any mix with a dense array is
computed densely, as the JAX package's `_binary` does.  Index discovery
(`cast_storage` to row_sparse, `retain`, the union) runs on the host.
CSR storage and sparse `dot` are not ported yet.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import Context, as_device
from ..ops.shape import embedding, lookup_ids
from .ndarray import NDArray, array as _dense_array

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "row_sparse_array",
           "zeros", "cast_storage", "retain", "add", "subtract",
           "multiply", "sgd_update_rsp", "sgd_mom_update_rsp",
           "adam_update_rsp", "sparse_embedding"]

_F32 = torch.float32


class BaseSparseNDArray(NDArray):
    """Common behaviour of the sparse storage types: the dense slot
    `_data` stays None."""

    __slots__ = ("_sp_shape", "_sp_values", "_sp_aux")

    def __init__(self, values, aux, shape):
        self._data = None
        self._recorded = False
        self._sp_values = values
        self._sp_aux = tuple(aux)
        self._sp_shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._sp_shape

    @property
    def ndim(self):
        return len(self._sp_shape)

    @property
    def size(self):
        return int(_np.prod(self._sp_shape))

    @property
    def dtype(self):
        return numpy_dtype(self._sp_values.dtype)

    @property
    def context(self):
        return Context.from_device(self._sp_values.device)

    @property
    def data(self):
        """The values, an NDArray of shape (nnz_rows, *row_shape)."""
        return NDArray(self._sp_values)

    @property
    def indices(self):
        return NDArray(self._sp_aux[-1])

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def copy(self):
        return type(self)(self._sp_values.clone(),
                          tuple(a.clone() for a in self._sp_aux),
                          self._sp_shape)

    def _deny(self, what):
        raise MXNetError(f"{what} is not supported on stype={self.stype!r}; "
                         f"call .tostype('default') first")

    def __getitem__(self, key):
        self._deny("indexing")

    def __setitem__(self, key, value):
        self._deny("assignment")

    def __repr__(self):
        return f"\n<{type(self).__name__} {self.shape} @{self.context}>"


class RowSparseNDArray(BaseSparseNDArray):
    """`row_sparse`: values (nnz_rows, *row_shape) and sorted row ids."""

    @property
    def stype(self):
        return "row_sparse"

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            v, idx = self._sp_values, self._sp_aux[0]
            out = torch.zeros(self._sp_shape, dtype=v.dtype, device=v.device)
            return NDArray(out.index_copy_(0, idx, v))
        raise MXNetError(f"cannot convert row_sparse to {stype!r}")

    def retain(self, indices):
        return retain(self, indices)

    def __add__(self, other):
        return add(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return subtract(self, other)

    def __mul__(self, other):
        return multiply(self, other)

    __rmul__ = __mul__


def _tensor(x, dtype=None, device=None):
    """A dense tensor of an NDArray, a tensor or array-like data (float64
    becomes float32, as in the JAX package)."""
    if isinstance(x, BaseSparseNDArray):
        x = x.tostype("default")
    if isinstance(x, NDArray):
        x = x._data
    elif not isinstance(x, torch.Tensor):
        x = _np.asarray(x)
        x = torch.from_numpy(x.astype(_np.float32) if x.dtype == _np.float64
                             else _np.array(x))
    return x.to(device=device, dtype=None if dtype is None
                else torch_dtype(dtype))


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from `(data, indices)` (rows sorted here) or
    from a dense source (its nonzero rows)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        if shape is None:
            raise MXNetError("row_sparse_array((data, indices)) needs shape=")
        dev = as_device(ctx)
        values = _tensor(arg1[0], dtype, dev)
        idx = _tensor(arg1[1], None, dev).to(torch.int64)
        order = torch.argsort(idx, stable=True)
        return RowSparseNDArray(values[order], (idx[order],), shape)
    if isinstance(arg1, RowSparseNDArray):
        return arg1.copy()
    dense = arg1 if isinstance(arg1, NDArray) else \
        _dense_array(arg1, ctx=ctx, dtype=dtype)
    return cast_storage(dense, "row_sparse")


def zeros(stype, shape, ctx=None, dtype="float32"):
    """All-zero array of storage `stype` ("row_sparse": no rows)."""
    if isinstance(shape, int):
        shape = (shape,)
    dt, dev = torch_dtype(dtype), as_device(ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            (torch.zeros((0,), dtype=torch.int64, device=dev),), shape)
    if stype == "default":
        from .ndarray import zeros as _dense_zeros
        return _dense_zeros(shape, ctx, dtype=dtype)
    raise MXNetError(f"stype {stype!r} is not ported (row_sparse and "
                     f"default are)")


def cast_storage(arr, stype):
    """`arr` in storage `stype`; to row_sparse keeps the rows with a
    nonzero entry."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if not isinstance(arr, NDArray):
        arr = _dense_array(arr)
    if stype == "default":
        return arr
    if stype != "row_sparse":
        raise MXNetError(f"stype {stype!r} is not ported (row_sparse and "
                         f"default are)")
    t = arr._data
    flat = t.reshape(t.shape[0], -1) if t.ndim > 1 else t.reshape(-1, 1)
    rows = torch.nonzero(flat.ne(0).any(dim=1)).reshape(-1)
    return RowSparseNDArray(t.index_select(0, rows), (rows,), t.shape)


def retain(rsp, indices):
    """Only the rows of `indices` (sorted, unique); a row `rsp` lacks is
    zero."""
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    v, idx = rsp._sp_values, rsp._sp_aux[0]
    keep = torch.unique(_tensor(indices, None, v.device).to(torch.int64))
    vals = torch.zeros((keep.numel(),) + tuple(rsp.shape[1:]), dtype=v.dtype,
                       device=v.device)
    if idx.numel():
        pos = torch.searchsorted(idx, keep).clamp_max(idx.numel() - 1)
        found = idx[pos] == keep
        vals[found] = v[pos[found]]
    return RowSparseNDArray(vals, (keep,), rsp.shape)


def _binary(op, a, b):
    sa, sb = isinstance(a, RowSparseNDArray), isinstance(b, RowSparseNDArray)
    if sa and sb:
        if a.shape != b.shape:
            raise MXNetError("sparse elemwise: shape mismatch")
        union = torch.unique(torch.cat([a._sp_aux[0], b._sp_aux[0]]))
        ra, rb = retain(a, union), retain(b, union)
        return RowSparseNDArray(op(ra._sp_values, rb._sp_values), (union,),
                                a.shape)
    if sa and op is torch.mul and isinstance(b, (int, float)):
        return RowSparseNDArray(a._sp_values * b, a._sp_aux, a.shape)
    da = a.tostype("default")._data if sa else NDArray._raw(a)
    db = b.tostype("default")._data if sb else NDArray._raw(b)
    return NDArray(op(da, db))


def add(a, b):
    return _binary(torch.add, a, b)


def subtract(a, b):
    return _binary(torch.sub, a, b)


def multiply(a, b):
    return _binary(torch.mul, a, b)


# -- lazy optimizer updates: only the gradient's rows -------------------

def _prep_rows(w_rows, values, rescale, clip, wd):
    g = values.to(_F32) * rescale
    if clip > 0:
        g = g.clamp(-clip, clip)
    return g + wd * w_rows


def sgd_update_rsp(weight, grad, lr, wd, rescale_grad, clip_gradient):
    """In-place lazy SGD of a dense weight by a row-sparse gradient."""
    idx, w = grad._sp_aux[0], weight._data
    with torch.no_grad():
        rows = w.index_select(0, idx).to(_F32)
        g = _prep_rows(rows, grad._sp_values, rescale_grad, clip_gradient,
                       wd)
        w.index_copy_(0, idx, (rows - lr * g).to(w.dtype))


def sgd_mom_update_rsp(weight, mom, grad, lr, momentum, wd, rescale_grad,
                       clip_gradient):
    idx, w, m = grad._sp_aux[0], weight._data, mom._data
    with torch.no_grad():
        rows = w.index_select(0, idx).to(_F32)
        g = _prep_rows(rows, grad._sp_values, rescale_grad, clip_gradient,
                       wd)
        new_m = momentum * m.index_select(0, idx) - lr * g
        w.index_copy_(0, idx, (rows + new_m).to(w.dtype))
        m.index_copy_(0, idx, new_m)


def adam_update_rsp(weight, mean, var, grad, lr, beta1, beta2, epsilon, wd,
                    rescale_grad, clip_gradient):
    """Lazy Adam; `lr` has the bias correction folded in."""
    idx, w = grad._sp_aux[0], weight._data
    with torch.no_grad():
        rows = w.index_select(0, idx).to(_F32)
        g = _prep_rows(rows, grad._sp_values, rescale_grad, clip_gradient,
                       wd)
        new_mean = beta1 * mean._data.index_select(0, idx) + (1 - beta1) * g
        new_var = beta2 * var._data.index_select(0, idx) \
            + (1 - beta2) * g.square()
        upd = lr * new_mean / (torch.sqrt(new_var) + epsilon)
        w.index_copy_(0, idx, (rows - upd).to(w.dtype))
        mean._data.index_copy_(0, idx, new_mean)
        var._data.index_copy_(0, idx, new_var)


# -- Embedding with a row-sparse weight gradient ------------------------

class _SparseEmbedding(torch.autograd.Function):
    """weight[ids] whose weight gradient is a coalesced sparse COO
    tensor: the sorted unique valid ids and the cotangent rows
    scatter-added onto them, in the cotangent's dtype."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(*lookup_ids(ids, weight.shape[0]))
        ctx.table_shape = weight.shape
        return embedding(ids, weight)

    @staticmethod
    def backward(ctx, ct):
        ids, valid = ctx.saved_tensors
        ids, flat = ids.reshape(-1), ct.reshape(-1, ct.shape[-1])
        if not bool(valid.all()):
            keep = valid.reshape(-1)
            ids, flat = ids[keep], flat[keep]
        uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
        vals = torch.zeros((uniq.numel(), flat.shape[-1]), dtype=ct.dtype,
                           device=ct.device).index_add_(0, inv, flat)
        return None, torch.sparse_coo_tensor(
            uniq.unsqueeze(0), vals, ctx.table_shape, check_invariants=False,
            is_coalesced=True)


def sparse_embedding(x, weight):
    """weight[x] (NDArrays) whose recorded backward gives the weight a
    row-sparse gradient; out-of-range ids give NaN rows and no gradient
    row, as the dense `Embedding` op's rules have them."""
    return NDArray(_SparseEmbedding.apply(NDArray._raw(x),
                                          NDArray._raw(weight)))


def from_torch_sparse(g):
    """A RowSparseNDArray of a sparse COO gradient tensor."""
    g = g.coalesce()
    return RowSparseNDArray(g.values(), (g.indices()[0],), g.shape)
