"""Shape and indexing ops (counterpart of
`incubator_mxnet_tpu/ops/shape.py`): reshape with MXNet's special codes,
expand_dims, squeeze, swapaxes, transpose, concat, stack, split,
slice_axis, pick, Embedding, flatten, pad; broadcast_to/axis, slice
(with step), slice_like, flip, tile, repeat, take, gather_nd,
scatter_nd, one_hot, dot, batch_dot, linalg_gemm2, diag, _arange_like,
zeros_like, ones_like, shape_array, size_array, BlockGrad and
make_loss.  Views stay views (`broadcast_to` expands, `diag` of a
matrix is its diagonal view); `NDArray` copies one only when it or its
base is written."""
from __future__ import annotations

import torch

from .registry import register
from ..base import MXNetError, get_env, torch_dtype


def _mx_reshape(in_shape, spec):
    """MXNet reshape spec: 0=copy dim, -1=infer, -2=copy rest, -3=merge two,
    -4=split one into next two."""
    out = []
    i = 0  # index into in_shape
    j = 0
    spec = list(spec)
    while j < len(spec):
        s = spec[j]
        if s > 0:
            out.append(s)
            i += 1
        elif s == 0:
            out.append(in_shape[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(in_shape[i:])
            i = len(in_shape)
        elif s == -3:
            out.append(in_shape[i] * in_shape[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = in_shape[i] // d2
            if d2 == -1:
                d2 = in_shape[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            raise MXNetError(f"bad reshape spec value {s}")
        j += 1
    if out.count(-1) > 1:
        raise MXNetError("reshape can infer at most one dimension")
    return tuple(out)


@register("reshape", aliases=("Reshape",))
def reshape(data, *, shape=None, reverse=False):
    if reverse:
        tgt = _mx_reshape(tuple(data.shape)[::-1], tuple(shape)[::-1])[::-1]
    else:
        tgt = _mx_reshape(tuple(data.shape), shape)
    return data.reshape(tgt)


@register("expand_dims")
def expand_dims(data, *, axis):
    return data.unsqueeze(axis)


@register("transpose")
def transpose(data, *, axes=None):
    """The axes reversed, or permuted by `axes` (`jnp.transpose`)."""
    if axes is None:
        return data.permute(*reversed(range(data.ndim)))
    return data.permute(*axes)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, *, dim1=0, dim2=0):
    return data.transpose(dim1, dim2)


def _squeeze(data, axes):
    """`data` without `axes`, each of which must have size 1 (the JAX
    op's `jnp.squeeze` rule; torch would keep a longer axis quietly)."""
    axes = tuple(a % data.ndim for a in axes)
    longer = [a for a in axes if data.shape[a] != 1]
    if longer:
        raise MXNetError(f"squeeze: axes {longer} of shape "
                         f"{tuple(data.shape)} are not of size 1")
    return data.squeeze(axes)


@register("squeeze")
def squeeze(data, *, axis=None):
    """Drop every axis of size 1, or the axes `axis` (an int or a
    tuple), each of which must have size 1."""
    if axis is None:
        return data.squeeze()
    return _squeeze(data, (axis,) if isinstance(axis, int) else tuple(axis))


@register("concat", aliases=("Concat",))
def concat(*args, dim=1):
    return torch.cat(args, dim=dim)


@register("stack")
def stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register("split", aliases=("SliceChannel",))
def split(data, *, num_outputs, axis=1, squeeze_axis=False):
    """`num_outputs` equal parts along `axis` (a tuple, one part too);
    an axis they do not divide evenly raises, as `jnp.split` does.  With
    `squeeze_axis` each part drops `axis`, which must then be of size 1."""
    size = data.shape[axis]
    if size % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {size} does not "
                         f"divide into {num_outputs} equal parts")
    parts = torch.split(data, size // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [_squeeze(p, (axis,)) for p in parts]
    return tuple(parts)


@register("slice_axis")
def slice_axis(data, *, axis, begin=0, end=None):
    """data[begin:end] along `axis`, clamped to the axis like a Python
    slice (the JAX op's rule): an empty result where begin >= end."""
    idx = [slice(None)] * data.ndim
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("pick")
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    """data's element at `index` along `axis`, with the JAX op's rules
    (`jnp.take_along_axis`, which ignores `mode`): indices are truncated
    to integers, one in [-size, -1] counts from the end, and any other
    outside [0, size) gives `jnp`'s fill: NaN for float data, the least
    value of a signed integer type, the largest of an unsigned one, True
    for bool."""
    size = data.shape[axis]
    idx = index.to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    valid = ((idx >= 0) & (idx < size)).unsqueeze(axis)
    out = data.gather(axis, idx.clamp(0, size - 1).unsqueeze(axis))
    if data.is_floating_point():
        fill = float("nan")
    elif data.dtype == torch.bool:
        fill = True
    else:
        info = torch.iinfo(data.dtype)
        fill = info.max if info.min == 0 else info.min
    out = out.masked_fill(~valid, fill)
    return out if keepdims else out.squeeze(axis)


def lookup_ids(data, rows):
    """(ids as int64, mask of the valid ones) under `jnp.take`'s rules,
    as the JAX `Embedding` op has them: ids are truncated to integers
    (its int32 cast), an id in [-rows, -1] wraps to row rows + id, and
    any other id outside [0, rows) is no row."""
    ids = data.to(torch.int64)
    ids = torch.where(ids < 0, ids + rows, ids)
    return ids, (ids >= 0) & (ids < rows)


@register("Embedding")
def embedding(data, weight, *, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Row lookup under `lookup_ids`' rules: an id that is no row gives
    a row of `jnp.take`'s fill value (NaN; for integer weights the
    type's least value, signed, or its largest, unsigned; True for
    bool), where an unchecked lookup would fault the device.
    `sparse_grad` is taken and, as in the JAX op, changes nothing here
    (the layer gives the row-sparse gradient)."""
    rows = weight.shape[0]
    ids, valid = lookup_ids(data, rows)
    out = torch.nn.functional.embedding(ids.clamp(0, rows - 1), weight)
    return out.masked_fill(~valid.unsqueeze(-1), _take_fill(weight.dtype))


def _take_fill(dtype):
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register("flatten", aliases=("Flatten",))
def flatten(data):
    return data.reshape(data.shape[0], -1)


def _pad_index(n, before, after, mode, device):
    """Source indices along an axis of size n padded by (before, after):
    "edge" repeats the end cells, "reflect" mirrors about them without
    repeating them, as often as the width needs (numpy's rules)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


@register("pad", aliases=("Pad",))
def pad(data, *, mode="constant", pad_width=(), constant_value=0.0):
    """`pad_width` gives (before, after) for every axis from axis 0, the
    leading N and C too (MXNet's order; `F.pad` counts from the last
    axis back).  "constant" fills with `constant_value`; "edge" and
    "reflect" gather source cells along each padded axis, so they pad
    any axis, as `jnp.pad` does.  Any other mode raises."""
    if len(pad_width) < 2 * data.ndim:
        raise MXNetError(f"pad: pad_width {tuple(pad_width)} needs "
                         f"(before, after) for each of {data.ndim} axes")
    pw = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(data.ndim)]
    if mode == "constant":
        flat = [x for lo_hi in reversed(pw) for x in lo_hi]
        return torch.nn.functional.pad(data, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise MXNetError(f"pad mode {mode} unsupported")
    out = data
    for axis, (before, after) in enumerate(pw):
        if before or after:
            out = out.index_select(axis, _pad_index(
                data.shape[axis], before, after, mode, data.device))
    return out


# ------------------------------------------------------------------
# broadcasting, slicing, reordering
# ------------------------------------------------------------------
@register("broadcast_to")
def broadcast_to(data, *, shape):
    """`data` broadcast to `shape`; a 0 there keeps the data's size (the
    JAX op pairs `shape` with the data's dims from the left)."""
    return data.expand(tuple(t if t != 0 else s
                             for t, s in zip(shape, data.shape)))


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, *, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return data.expand(tuple(tgt))


def _sliced(data, key):
    from ..ndarray.ndarray import torch_index
    flips, key = torch_index(key, data.shape)
    return (data.flip(flips) if flips else data)[key]


@register("slice")
def slice_op(data, *, begin, end, step=None):
    """data[b0:e0:s0, b1:e1:s1, ...]; None is an open end, and a
    negative step walks backwards, as a Python slice."""
    step = step or (None,) * len(begin)
    return _sliced(data, tuple(slice(b, e, s)
                               for b, e, s in zip(begin, end, step)))


@register("slice_like")
def slice_like(data, shape_like, *, axes=()):
    """The leading part of `data` of `shape_like`'s size on `axes` (all
    of shape_like's axes when empty)."""
    axes = tuple(axes) if axes else tuple(range(shape_like.ndim))
    idx = [slice(None)] * data.ndim
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("flip", aliases=("reverse",))
def flip(data, *, axis):
    return data.flip((axis,) if isinstance(axis, int) else tuple(axis))


@register("tile")
def tile(data, *, reps):
    return data.tile(tuple(reps))


@register("repeat")
def repeat(data, *, repeats, axis=None):
    """Each element `repeats` times along `axis` (of the flattened data
    for None), as `jnp.repeat`."""
    return torch.repeat_interleave(data, repeats, dim=axis)


# ------------------------------------------------------------------
# gathers and scatters
# ------------------------------------------------------------------
_INT32_MAX = (1 << 31) - 1


def _guard_index_range(*dim_sizes):
    """Fail loudly (never wrap or clamp silently) when an index could
    pass int32 under the default 32-bit index policy;
    MXNET_INT64_TENSOR_SIZE=1 lifts it, as in the JAX package."""
    if not get_env("MXNET_INT64_TENSOR_SIZE", False, bool) and any(
            d > _INT32_MAX for d in dim_sizes):
        raise MXNetError(
            "array dimension exceeds the int32 index range; set "
            "MXNET_INT64_TENSOR_SIZE=1 to enable 64-bit indexing "
            "(large-tensor policy, docs/env_vars.md)")


@register("take")
def take(data, indices, *, axis=0, mode="clip"):
    """Slices of `data` along `axis` at `indices` (truncated to
    integers), in the index array's shape.  "clip" clamps an index to
    [0, size − 1], negative ones to 0; any other mode ("wrap", and
    "raise" too, as in the JAX op) takes it modulo the size."""
    axis = axis % data.ndim
    n = data.shape[axis]
    _guard_index_range(n)
    idx = indices.detach().to(torch.int64)
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx.remainder(n)
    out = data.index_select(axis, idx.reshape(-1))
    return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1:])


def _nd_index(indices):
    ids = indices.detach().to(torch.int64)
    return tuple(ids[i] for i in range(ids.shape[0]))


@register("gather_nd")
def gather_nd(data, indices):
    """data[indices[0], indices[1], ...]: indices (M, ...) address the
    first M axes."""
    _guard_index_range(*data.shape)
    return data[_nd_index(indices)]


@register("scatter_nd")
def scatter_nd(data, indices, *, shape):
    """Zeros of `shape` with `data` added at `indices` (M, ...); repeated
    positions add up, as the JAX op's `.at[].add`."""
    _guard_index_range(*shape)
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data, accumulate=True)


@register("one_hot")
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """A `depth`-wide row per index (truncated to an integer; one outside
    [0, depth) is all off), `on_value` at the index and `off_value`
    elsewhere: rows·(on − off) + off, whose dtype follows the JAX op's
    promotion (an integer `dtype` gives float32)."""
    ids = indices.detach().to(torch.int64)
    hot = (ids.unsqueeze(-1) == torch.arange(depth, device=ids.device)).to(
        torch_dtype(dtype))
    return hot * (on_value - off_value) + off_value


# ------------------------------------------------------------------
# products
# ------------------------------------------------------------------
def _reversed(t):
    return t.permute(*reversed(range(t.ndim)))


def _promoted(lhs, rhs):
    """Both operands in their promoted dtype, as `jnp.dot`/`matmul`
    promote before the product (torch's raise on mixed dtypes)."""
    if lhs.dtype == rhs.dtype:
        return lhs, rhs
    dt = torch.promote_types(lhs.dtype, rhs.dtype)
    return lhs.to(dt), rhs.to(dt)


@register("dot")
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of lhs against the FIRST axis of rhs
    (unlike numpy's for ndim > 2); `transpose_a`/`_b` reverse all axes."""
    lhs, rhs = _promoted(lhs, rhs)
    if transpose_a:
        lhs = _reversed(lhs)
    if transpose_b:
        rhs = _reversed(rhs)
    if lhs.ndim <= 2 and rhs.ndim <= 2:
        return torch.matmul(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.ndim - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    lhs, rhs = _promoted(lhs, rhs)
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("linalg_gemm2")
def linalg_gemm2(A, B, *, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    """alpha·op(A)·op(B) over the last two axes (`axis` is taken and, as
    in the JAX op, not used)."""
    if transpose_a:
        A = A.transpose(-1, -2)
    if transpose_b:
        B = B.transpose(-1, -2)
    return alpha * torch.matmul(A, B)


@register("diag")
def diag(data, *, k=0):
    """A 1-d input's diagonal matrix (offset k), else the k-th diagonal
    of the last two axes."""
    if data.ndim == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


# ------------------------------------------------------------------
# arrays made from an array's shape, and gradient control
# ------------------------------------------------------------------
@register("_arange_like")
def arange_like(data, *, axis=None, start=0.0, step=1.0):
    n = data.numel() if axis is None else data.shape[axis]
    return start + step * torch.arange(n, dtype=data.dtype,
                                       device=data.device)


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data.detach(),
                            memory_format=torch.contiguous_format)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data.detach(),
                           memory_format=torch.contiguous_format)


@register("shape_array")
def shape_array(data):
    """The shape as an int32 array: the JAX op asks for int64, which JAX
    stores as int32 without x64."""
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


@register("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32, device=data.device)


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data):
    return data.detach()


@register("make_loss", aliases=("MakeLoss",))
def make_loss(data, *, grad_scale=1.0, normalization="null"):
    """The data as it is: the JAX op takes `grad_scale` and
    `normalization` and applies neither."""
    return data
