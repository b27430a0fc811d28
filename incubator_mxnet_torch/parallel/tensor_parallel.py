"""The layers' forward on tensor-parallel blocks (Megatron, explicit).

A parameter that a mesh trainer placed carries its `Sharding`
(`Parameter._shard`); the layers ask here how to run on the block:

- a Dense whose weight cuts dim 0 (column-parallel) computes its
  output columns; it keeps them when its parent says the next layer
  takes them (`SelfAttention`'s heads, an FFN's row-parallel second
  layer), else they are all-gathered (a fused qkv's head-aligned
  columns put back in q | k | v order);
- a Dense whose weight cuts dim 1 (row-parallel) takes its block of
  the input (or the block it is given), and its partial products are
  summed over the axis before the bias;
- an Embedding whose table cuts dim 0 (vocab-parallel) looks up the ids
  of its range, zeroes the rest, and the rows are summed over the axis.

Collectives follow `collectives`' convention, so the trainer's sum of
each parameter's gradient over its replicas gives the global gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import collectives as C
from .sharding import PartitionSpec, Sharding, is_fused_qkv

__all__ = ["cut_axis", "dense_forward", "embedding_forward"]


def cut_axis(sharding, dim, ndim=2):
    """The mesh axis cutting `dim` of a parameter (more than one rank),
    or None."""
    if sharding is None:
        return None
    e = sharding.full_spec(ndim)[dim]
    if e is None or sharding.mesh.axis_size(e) <= 1:
        return None
    return e


def dense_forward(layer, x, weight, bias):
    """`layer` (a gluon Dense) on a placed weight; x, weight, bias are
    torch tensors.  Returns the output before the activation."""
    sh = layer.weight._shard
    col, row = cut_axis(sh, 0), cut_axis(sh, 1)
    if layer._flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    if col and row:
        raise MXNetError(f"{layer.weight.name}: a weight cut on both dims "
                         f"is not supported")
    mesh = sh.mesh
    if col:
        b = bias
        if b is not None and b.shape[0] != weight.shape[0]:
            b = Sharding(mesh, PartitionSpec(col),
                         name=layer.bias.name).local_block(b)
        y = F.linear(x, weight, b)
        if getattr(layer, "_tp_keep_local", False):
            return y
        n = mesh.axis_size(col)
        y = C.allgather(y, col, axis=-1, mesh=mesh)
        if is_fused_qkv(layer.weight.name):
            c = weight.shape[0] // 3
            y = y.reshape(y.shape[:-1] + (n, 3, c)).transpose(-3, -2) \
                .reshape(y.shape)
        return y
    if row:
        n = mesh.axis_size(row)
        k = weight.shape[1]
        if x.shape[-1] == k * n:
            i = mesh.axis_index(row)
            x = x[..., i * k:(i + 1) * k]
        elif x.shape[-1] != k:
            raise MXNetError(f"{layer.weight.name}: input width "
                             f"{x.shape[-1]}, the row-parallel block takes "
                             f"{k} of {k * n}")
        if bias is not None and cut_axis(layer.bias._shard, 0, 1):
            raise MXNetError(f"{layer.bias.name}: a row-parallel layer's "
                             f"bias is not cut")
        y = C.allreduce(F.linear(x, weight), row, mesh=mesh)
        return y if bias is None else y + bias
    return F.linear(x, weight, bias)


def embedding_forward(layer, ids, weight):
    """`layer` (a gluon Embedding) with its table cut on dim 0 over an
    axis: ids is the float or integer tensor of row ids."""
    from ..ops.shape import lookup_ids, _take_fill
    sh = layer.weight._shard
    axis = cut_axis(sh, 0)
    mesh = sh.mesh
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    rows = weight.shape[0]
    full, valid = lookup_ids(ids, rows * n)
    lo = i * rows
    mine = valid & (full >= lo) & (full < lo + rows)
    out = F.embedding((full - lo).clamp(0, rows - 1), weight)
    out = torch.where(mine.unsqueeze(-1), out, 0.0).to(weight.dtype)
    out = C.allreduce(out, axis, mesh=mesh)
    return out.masked_fill(~valid.unsqueeze(-1), _take_fill(weight.dtype))
