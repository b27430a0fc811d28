"""Gluon utilities (counterpart of `incubator_mxnet_tpu/gluon/utils.py`):
`split_data`, `split_and_load`, `clip_global_norm`, `check_sha1`."""
from __future__ import annotations

import hashlib
import math
import warnings

import torch

from ..base import MXNetError
from ..ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """`num_slice` slices of `data` along `batch_axis`; the last takes
    the remainder unless `even_split` asks for equal slices."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"cannot split batch of {size} evenly into {num_slice} slices")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of the batch on each context of `ctx_list`; with one
    context, the whole batch on it.  Data that is not an NDArray is
    loaded onto the first context."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale `arrays` in place so that their joint L2 norm is at most
    `max_norm`; returns that norm before scaling, a float.  Each array's
    norm is taken as the `norm` op takes it (in float32, rounded to the
    array's dtype), and the joint norm from those in float32; the host
    waits once, for the joint norm."""
    norms = torch.stack([a.norm()._data.to(torch.float32) for a in arrays])
    total = math.sqrt(float((norms.double() ** 2).sum()))
    if check_isfinite and not math.isfinite(total):
        warnings.warn("nan or inf in clip_global_norm")
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return total


def check_sha1(filename, sha1_hash):
    """Whether the SHA-1 of file `filename` is hex digest `sha1_hash`."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            sha1.update(block)
    return sha1.hexdigest() == sha1_hash
