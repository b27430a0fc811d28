"""Sparse storage, `row_sparse` and `csr` (counterpart of
`incubator_mxnet_tpu/ndarray/sparse.py`).

A sparse array is a struct of tensors on one device, as in the JAX
package, with int32 index tensors (JAX stores them so; a torch op that
needs int64 indices gets them widened at the call):

- `RowSparseNDArray`: `data` of shape (nnz_rows, *row_shape) and
  sorted, unique row `indices`.  It is what `Embedding(sparse_grad=True)`
  gives as its weight's gradient, and what the lazy optimizer updates
  take: `sgd_update_rsp`, `sgd_mom_update_rsp` and `adam_update_rsp`
  touch only the gradient's rows, so every other row keeps its weight
  and its optimizer state.
- `CSRNDArray`: 2-D compressed rows, `data` (nnz,), column `indices`
  (nnz,) and `indptr` (rows + 1,).  `dot` of a CSR array and a dense
  one (`transpose_a` too) gathers the dense rows each entry needs and
  adds them into the output rows (`index_add_`), as the JAX `dot` does
  with `.at[].add`.

Dense materialisation is explicit (`tostype("default")`); indexing and
assignment raise, and NDArray's dense methods do not apply, but
`astype`, `copyto`, `as_in_context`, `detach` (a dense array),
`wait_to_read` and `attach_grad` (a dense zero gradient) do, as in the
JAX package.  `+`, `-` and `*` of two row-sparse arrays stay row-sparse
over the union of their rows, a sparse array times a Python number stays
sparse, and any other mix is computed densely through the broadcast
ops, as the JAX package's `_binary` does.  Index discovery
(`cast_storage` to a sparse type, `retain`, the union) syncs with the
host.  `dot` records no gradient, as the JAX one does not.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype_32
from ..context import Context, as_device
from ..ops.shape import embedding, lookup_ids
from .ndarray import NDArray, array as _dense_array, _numpy_dtype_32

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "zeros", "empty", "array",
           "cast_storage", "retain", "dot", "add", "subtract", "multiply",
           "sgd_update_rsp", "sgd_mom_update_rsp", "adam_update_rsp",
           "sparse_embedding"]

_F32 = torch.float32
_IDX = torch.int32          # the JAX package's index dtype


class BaseSparseNDArray(NDArray):
    """Common behaviour of the sparse storage types: the dense slot
    `_data` stays None."""

    __slots__ = ("_sp_shape", "_sp_values", "_sp_aux", "_sp_grad")

    def __init__(self, values, aux, shape):
        self._data = None
        self._recorded = False
        self._sp_values = values
        self._sp_aux = tuple(aux)
        self._sp_shape = tuple(int(s) for s in shape)
        self._sp_grad = None

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

    def __len__(self):
        return self._sp_shape[0]

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def copy(self):
        return type(self)(self._sp_values.clone(),
                          tuple(a.clone() for a in self._sp_aux),
                          self._sp_shape)

    def _on(self, device):
        return type(self)(self._sp_values.to(device, copy=True),
                          tuple(a.to(device, copy=True)
                                for a in self._sp_aux), self._sp_shape)

    def astype(self, dtype, copy=True):
        """The same storage with the values cast (float64 and int64 as
        float32 and int32)."""
        dt = torch_dtype_32(dtype)
        if not copy and dt == self._sp_values.dtype:
            return self
        return type(self)(self._sp_values.to(dt), self._sp_aux,
                          self._sp_shape)

    def copyto(self, other):
        """A copy on Context `other`, or written into `other`: a sparse
        array takes this one's storage, a dense one its values."""
        if isinstance(other, Context):
            return self._on(other.torch_device)
        if isinstance(other, BaseSparseNDArray):
            other._sp_values = self._sp_values.clone()
            other._sp_aux = tuple(a.clone() for a in self._sp_aux)
            other._sp_shape = self._sp_shape
            return other
        if isinstance(other, NDArray):
            other._assign(self.tostype("default")._data)
            return other
        raise MXNetError(f"copyto: unsupported target {type(other)}")

    def as_in_context(self, ctx):
        return self._on(as_device(ctx))

    as_in_ctx = as_in_context

    def detach(self):
        """The dense values, cut from any graph."""
        return NDArray(self.tostype("default")._data.detach())

    def wait_to_read(self):
        if self._sp_values.is_cuda:
            torch.cuda.current_stream(self._sp_values.device).synchronize()

    def attach_grad(self, grad_req="write", stype=None):
        """A dense zero gradient buffer of this array's shape, as the
        JAX package gives a sparse array."""
        self._sp_grad = NDArray(torch.zeros(
            self._sp_shape, dtype=self._sp_values.dtype,
            device=self._sp_values.device))

    @property
    def grad(self):
        return self._sp_grad

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
            return NDArray(out.index_copy_(0, idx.long(), v))
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


class CSRNDArray(BaseSparseNDArray):
    """`csr`: 2-D compressed rows, values (nnz,), aux (indptr, indices)."""

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self):
        return NDArray(self._sp_aux[0])

    @property
    def indices(self):
        return NDArray(self._sp_aux[1])

    def _rows(self):
        """The row of each stored entry (nnz,)."""
        indptr = self._sp_aux[0].long()
        n = self._sp_shape[0]
        return torch.repeat_interleave(
            torch.arange(n, device=indptr.device), indptr[1:] - indptr[:-1],
            output_size=self._sp_values.shape[0])

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            v = self._sp_values
            out = torch.zeros(self._sp_shape, dtype=v.dtype, device=v.device)
            return NDArray(out.index_put_(
                (self._rows(), self._sp_aux[1].long()), v, accumulate=True))
        if stype == "row_sparse":
            return cast_storage(self.tostype("default"), "row_sparse")
        raise MXNetError(f"cannot convert csr to {stype!r}")

    def __add__(self, other):
        return add(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        return multiply(self, other)

    __rmul__ = __mul__


def _tensor(x, dtype=None, device=None):
    """A dense tensor of an NDArray, a tensor or array-like data (a numpy
    array's float64 and int64 become float32 and int32, as in the JAX
    package)."""
    if isinstance(x, BaseSparseNDArray):
        x = x.tostype("default")
    if isinstance(x, NDArray):
        x = x._data
    elif not isinstance(x, torch.Tensor):
        x = _np.asarray(x)
        x = torch.from_numpy(_np.array(x, dtype=_numpy_dtype_32(x.dtype)))
    return x.to(device=device, dtype=None if dtype is None
                else torch_dtype_32(dtype))


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from `(data, indices)` (rows sorted here) or
    from a dense source (its nonzero rows)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        if shape is None:
            raise MXNetError("row_sparse_array((data, indices)) needs shape=")
        dev = as_device(ctx)
        values = _tensor(arg1[0], dtype, dev)
        idx = _tensor(arg1[1], None, dev).to(_IDX)
        order = torch.argsort(idx, stable=True)
        return RowSparseNDArray(values[order], (idx[order],), shape)
    if isinstance(arg1, RowSparseNDArray):
        return arg1.copy()
    dense = arg1 if isinstance(arg1, NDArray) else \
        _dense_array(arg1, ctx=ctx, dtype=dtype)
    return cast_storage(dense, "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from `(data, indices, indptr)` or from a dense
    source (its nonzero entries)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        if shape is None:
            raise MXNetError("csr_matrix((data, indices, indptr)) needs "
                             "shape=")
        dev = as_device(ctx)
        return CSRNDArray(_tensor(arg1[0], dtype, dev),
                          (_tensor(arg1[2], None, dev).to(_IDX),
                           _tensor(arg1[1], None, dev).to(_IDX)), shape)
    if isinstance(arg1, CSRNDArray):
        return arg1.copy()
    dense = arg1 if isinstance(arg1, NDArray) else \
        _dense_array(arg1, ctx=ctx, dtype=dtype)
    return cast_storage(dense, "csr")


def zeros(stype, shape, ctx=None, dtype="float32"):
    """All-zero array of storage `stype` (no stored rows or entries)."""
    if isinstance(shape, int):
        shape = (shape,)
    dt, dev = torch_dtype_32(dtype), as_device(ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            (torch.zeros((0,), dtype=_IDX, device=dev),), shape)
    if stype == "csr":
        if len(shape) != 2:
            raise MXNetError("csr must be 2-D")
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          (torch.zeros((shape[0] + 1,), dtype=_IDX,
                                       device=dev),
                           torch.zeros((0,), dtype=_IDX, device=dev)), shape)
    if stype == "default":
        from .ndarray import zeros as _dense_zeros
        return _dense_zeros(shape, ctx, dtype=dtype)
    raise MXNetError(f"unknown stype {stype!r}")


empty = zeros


def array(source, ctx=None, dtype=None):
    """`nd.array` that keeps a sparse source's storage type (a scipy CSR
    matrix becomes a CSRNDArray)."""
    if isinstance(source, BaseSparseNDArray):
        out = source.copy() if ctx is None else source.as_in_context(ctx)
        return out if dtype is None else out.astype(dtype)
    if hasattr(source, "indptr") and hasattr(source, "indices"):
        return csr_matrix((source.data, source.indices, source.indptr),
                          shape=source.shape, ctx=ctx, dtype=dtype)
    return _dense_array(source, ctx=ctx, dtype=dtype)


def cast_storage(arr, stype):
    """`arr` in storage `stype`; to row_sparse keeps the rows with a
    nonzero entry, to csr the nonzero entries in row-major order."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if not isinstance(arr, NDArray):
        arr = _dense_array(arr)
    if stype == "default":
        return arr
    t = arr._data
    if stype == "row_sparse":
        flat = t.reshape(t.shape[0], -1) if t.ndim > 1 else t.reshape(-1, 1)
        rows = torch.nonzero(flat.ne(0).any(dim=1)).reshape(-1)
        return RowSparseNDArray(t.index_select(0, rows), (rows.to(_IDX),),
                                t.shape)
    if stype == "csr":
        if t.ndim != 2:
            raise MXNetError("csr must be 2-D")
        rows, cols = torch.nonzero(t, as_tuple=True)
        counts = torch.bincount(rows, minlength=t.shape[0])
        indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        return CSRNDArray(t[rows, cols], (indptr.to(_IDX), cols.to(_IDX)),
                          t.shape)
    raise MXNetError(f"unknown stype {stype!r}")


def retain(rsp, indices):
    """Only the rows of `indices` (sorted, unique); a row `rsp` lacks is
    zero."""
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    v, idx = rsp._sp_values, rsp._sp_aux[0]
    keep = torch.unique(_tensor(indices, None, v.device).to(_IDX))
    vals = torch.zeros((keep.numel(),) + tuple(rsp.shape[1:]), dtype=v.dtype,
                       device=v.device)
    if idx.numel():
        pos = torch.searchsorted(idx, keep).clamp_max(idx.numel() - 1)
        found = idx[pos] == keep
        vals[found] = v[pos[found]]
    return RowSparseNDArray(vals, (keep,), rsp.shape)


def _binary(op, name, a, b):
    sa, sb = isinstance(a, BaseSparseNDArray), isinstance(b, BaseSparseNDArray)
    if sa and sb and a.stype == b.stype == "row_sparse":
        if a.shape != b.shape:
            raise MXNetError("sparse elemwise: shape mismatch")
        union = torch.unique(torch.cat([a._sp_aux[0], b._sp_aux[0]]))
        ra, rb = retain(a, union), retain(b, union)
        return RowSparseNDArray(op(ra._sp_values, rb._sp_values), (union,),
                                a.shape)
    if sa and op is torch.mul and isinstance(b, (int, float)):
        return type(a)(a._sp_values * b, a._sp_aux, a.shape)
    from ..ops.registry import apply_op
    return apply_op(name, a.tostype("default") if sa else a,
                    b.tostype("default") if sb else b)


def add(a, b):
    return _binary(torch.add, "broadcast_add", a, b)


def subtract(a, b):
    return _binary(torch.sub, "broadcast_sub", a, b)


def multiply(a, b):
    return _binary(torch.mul, "broadcast_mul", a, b)


# -- sparse dot ---------------------------------------------------------

def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """`lhs` · `rhs` with at least one sparse operand, dense out.  CSR
    lhs: each stored entry scales the dense row it needs (rhs row
    `indices[j]`, or with `transpose_a` rhs row `row[j]`) and the
    products are added into their output rows; row-sparse lhs: its rows
    times rhs, the other rows 0; a sparse rhs is densified."""
    if transpose_b:
        raise MXNetError("sparse dot: transpose_b is not supported")
    with torch.no_grad():
        if isinstance(lhs, CSRNDArray):
            r = (rhs.tostype("default") if isinstance(rhs, BaseSparseNDArray)
                 else rhs)._data
            squeeze = r.ndim == 1
            if squeeze:
                r = r[:, None]
            v, rows = lhs._sp_values, lhs._rows()
            cols = lhs._sp_aux[1].long()
            nrows, ncols = lhs.shape
            src, dst, n = (rows, cols, ncols) if transpose_a \
                else (cols, rows, nrows)
            out = torch.zeros((n, r.shape[1]), dtype=v.dtype,
                              device=v.device)
            out.index_add_(0, dst, v[:, None] * r.index_select(0, src))
            return NDArray(out[:, 0] if squeeze else out)
        if isinstance(lhs, RowSparseNDArray):
            if transpose_a:
                raise MXNetError("dot(row_sparse.T, ...) is not supported")
            r = (rhs.tostype("default") if isinstance(rhs, BaseSparseNDArray)
                 else rhs)._data
            v = lhs._sp_values
            out = torch.zeros((lhs.shape[0], r.shape[1]), dtype=v.dtype,
                              device=v.device)
            return NDArray(out.index_copy_(0, lhs._sp_aux[0].long(), v @ r))
    if isinstance(rhs, BaseSparseNDArray):
        from ..ops.registry import apply_op
        return apply_op("dot", lhs, rhs.tostype("default"),
                        transpose_a=transpose_a)
    raise MXNetError("sparse.dot needs at least one sparse operand")


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
        w.index_copy_(0, idx.long(), (rows - lr * g).to(w.dtype))


def sgd_mom_update_rsp(weight, mom, grad, lr, momentum, wd, rescale_grad,
                       clip_gradient):
    idx, w, m = grad._sp_aux[0], weight._data, mom._data
    with torch.no_grad():
        rows = w.index_select(0, idx).to(_F32)
        g = _prep_rows(rows, grad._sp_values, rescale_grad, clip_gradient,
                       wd)
        new_m = momentum * m.index_select(0, idx) - lr * g
        w.index_copy_(0, idx.long(), (rows + new_m).to(w.dtype))
        m.index_copy_(0, idx.long(), new_m)


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
        idx = idx.long()
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
    return RowSparseNDArray(g.values(), (g.indices()[0].to(_IDX),), g.shape)
