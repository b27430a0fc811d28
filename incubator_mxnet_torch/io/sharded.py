"""Sharded data loading: each rank reads only its rows of the global
batch (counterpart of `incubator_mxnet_tpu/io/sharded.py`).

In the JAX package a host stages its rows on its devices and the global
`jax.Array` is stitched from the pieces.  Here a mesh device is a rank,
so a rank's rows are its local batch: `assemble_global` checks that
they are the rows the mesh gives this rank on the batch axis and
returns them on the rank's device as a `LocalBatch`, which
`ParallelTrainer` takes as its block (no rows move between ranks).

Two ways to get the local rows, as in the JAX package:

* ``ShardedDataIter(base)`` slices this rank's contiguous row block out
  of a global-batch iterator (every rank still reads the whole batch);
* shard at the source, ``ImageRecordIter(part_index=rank,
  num_parts=num_shards, batch_size=local_batch)``, and wrap it with
  ``ShardedDataIter(base, base_is_sharded=True)``.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, get_env
from ..ndarray import NDArray
from .io import DataIter, DataBatch, DataDesc

__all__ = ["ShardedDataIter", "shard_bounds", "data_shard_info",
           "assemble_global", "assemble_from_shards", "LocalBatch"]


class LocalBatch(NDArray):
    """This rank's rows of a global batch: `global_shape` is the whole
    batch's shape; `ParallelTrainer` takes it as its block."""
    _mesh_local = True


def data_shard_info(rank=None, num_shards=None):
    """This process's (rank, num_shards) for input sharding: the
    arguments, else the process group (after
    `parallel.init_distributed`), else ``MXNET_KV_LOCAL_RANK``/
    ``MXNET_KV_LOCAL_SIZE``, else ``DMLC_WORKER_RANK`` (or
    ``DMLC_RANK``)/``DMLC_NUM_WORKER``, else (0, 1)."""
    if rank is not None or num_shards is not None:
        ns = int(num_shards) if num_shards is not None else 1
        rk = int(rank) if rank is not None else 0
    else:
        from ..parallel.mesh import world
        size, me = world()
        if size > 1:
            rk, ns = me, size
        elif get_env("MXNET_KV_LOCAL_SIZE", None) is not None:
            ns = max(1, get_env("MXNET_KV_LOCAL_SIZE", 1, int))
            rk = get_env("MXNET_KV_LOCAL_RANK", 0, int)
        else:
            ns = max(1, get_env("DMLC_NUM_WORKER", 1, int))
            rk = get_env("DMLC_WORKER_RANK", get_env("DMLC_RANK", 0, int),
                         int)
    if not 0 <= rk < ns:
        raise MXNetError(f"data shard rank {rk} outside [0, {ns})")
    return rk, ns


def shard_bounds(global_batch, rank, num_shards):
    """[start, stop) rows of `rank`'s shard of a global batch: shards
    are contiguous, disjoint and cover it, in rank order."""
    global_batch = int(global_batch)
    if num_shards <= 0 or global_batch % num_shards != 0:
        raise MXNetError(
            f"global batch {global_batch} not divisible by "
            f"{num_shards} shards")
    per = global_batch // num_shards
    return rank * per, (rank + 1) * per


def _tensor(a):
    src = a.data if isinstance(a, NDArray) else a
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(_np.ascontiguousarray(src))
    return src


def _local(mesh, batch_axis, gshape, rows):
    """This rank's block of the global batch on the batch axis of
    `mesh`, from `rows(start, stop)`."""
    axis = batch_axis if batch_axis and batch_axis in mesh.axis_names \
        else None
    n = mesh.axis_size(axis) if axis else 1
    i = mesh.axis_index(axis) if axis else 0
    per = gshape[0] // n
    out = LocalBatch(rows(i * per, (i + 1) * per).to(mesh.device))
    out.global_shape = tuple(gshape)
    return out


def assemble_global(local, mesh, batch_axis="dp", rank=None,
                    num_shards=None):
    """This rank's local rows (`shard_bounds`' block for `rank`) as its
    block of the global batch over `mesh`'s `batch_axis`.  The mesh
    must give this rank exactly those rows."""
    rank, num_shards = data_shard_info(rank, num_shards)
    src = _tensor(local)
    n_local = src.shape[0]
    base = rank * n_local
    gshape = (n_local * num_shards,) + tuple(src.shape[1:])

    def rows(start, stop):
        if start < base or stop > base + n_local:
            raise MXNetError(
                f"device rows [{start}, {stop}) fall outside this "
                f"host's shard [{base}, {base + n_local}) — the mesh "
                "layout is not this rank's block along the batch axis "
                "(or rank/num_shards disagree with the mesh)")
        return src[start - base: stop - base]

    return _local(mesh, batch_axis, gshape, rows)


def assemble_from_shards(shards, mesh, batch_axis="dp"):
    """This rank's block of the batch the shards make together (the
    parity tests: the block equals the one `ParallelTrainer` cuts from
    the concatenated batch)."""
    srcs = [_tensor(s) for s in shards]
    for s in srcs[1:]:
        if s.shape != srcs[0].shape:
            raise MXNetError("assemble_from_shards: ragged shards")
    full = torch.cat(srcs, 0)
    return _local(mesh, batch_axis, tuple(full.shape),
                  lambda a, b: full[a:b])


class ShardedDataIter(DataIter):
    """Wrap any `DataIter` so each rank sees only its shard of the
    global batch, assembled into its block over the mesh.

    Parameters
    ----------
    base : DataIter of GLOBAL batches (or of this rank's, with
        ``base_is_sharded=True``).
    trainer : optional ParallelTrainer, for its mesh and batch axis.
    mesh / batch_axis : the alternative to `trainer`.
    rank / num_shards : explicit shard coordinates (default
        `data_shard_info`).
    base_is_sharded : `base` yields this rank's rows already.
    """

    def __init__(self, base, trainer=None, mesh=None, batch_axis=None,
                 rank=None, num_shards=None, base_is_sharded=False):
        self.base = base
        self.rank, self.num_shards = data_shard_info(rank, num_shards)
        self._pre_sharded = bool(base_is_sharded)
        if trainer is not None:
            mesh = mesh or trainer.mesh
            batch_axis = batch_axis or trainer.batch_axis
        self.mesh = mesh
        self.batch_axis = batch_axis or "dp"
        gb = int(base.batch_size)
        if self._pre_sharded:
            self._local_batch = gb
            gb = gb * self.num_shards
        else:
            lo, hi = shard_bounds(gb, self.rank, self.num_shards)
            self._bounds = (lo, hi)
            self._local_batch = hi - lo
        self.global_batch = gb
        super().__init__(self._local_batch)

    def _shrink(self, descs):
        return [DataDesc(d.name, (self._local_batch,) + tuple(
            d.shape[1:]), d.dtype, d.layout) for d in descs or []]

    @property
    def provide_data(self):
        if self._pre_sharded:
            return self.base.provide_data
        return self._shrink(self.base.provide_data)

    @property
    def provide_label(self):
        if self._pre_sharded:
            return self.base.provide_label
        return self._shrink(self.base.provide_label)

    def reset(self):
        self.base.reset()

    def _slice(self, arrays):
        lo, hi = self._bounds
        out = []
        for a in arrays or []:
            src = a.data if isinstance(a, NDArray) else a
            out.append(NDArray(src[lo:hi]) if isinstance(a, NDArray)
                       else src[lo:hi])
        return out

    def next(self):
        b = self.base.next()
        if self._pre_sharded:
            return b
        lo, hi = self._bounds
        # the global pad is the batch's tail [gb - pad, gb): each shard
        # reports the padded rows it holds
        pad = max(0, hi - max(lo, self.global_batch - (b.pad or 0)))
        return DataBatch(self._slice(b.data), self._slice(b.label),
                         pad=pad, index=b.index,
                         bucket_key=b.bucket_key)

    def assemble(self, arrays):
        """Local arrays → this rank's blocks (`LocalBatch`), ready for
        ``trainer.step``."""
        if self.mesh is None:
            raise MXNetError("ShardedDataIter.assemble needs a mesh "
                             "(pass trainer= or mesh=)")
        return [assemble_global(a, self.mesh, self.batch_axis,
                                rank=self.rank, num_shards=self.num_shards)
                for a in arrays]

    def next_global(self):
        """One global batch, as this rank's blocks."""
        b = self.next()
        return DataBatch(self.assemble(b.data),
                         self.assemble(b.label) if b.label else b.label,
                         pad=b.pad, index=b.index,
                         bucket_key=b.bucket_key)
