"""The in-process key-value stores (counterpart of
`incubator_mxnet_tpu/kvstore/base.py`).

`KVStore` is the API every store shares; `KVStoreLocal` ("local",
"device", "nccl", "tpu") keeps its values in this process.  A push of
several values for one key merges (sums) them; with an optimizer
installed by `set_optimizer` the merged value updates the stored weight,
else it replaces it.  A pull writes the stored value into every `out`
array.  With 2-bit compression the merged value is quantized to
{-threshold, 0, +threshold} and the error kept in a per-key residual.

The merge is a chain of `torch.add` in the order the values came; the
counters (`kvstore_push_bytes`, `kvstore_pull_bytes`,
`kvstore_allreduce_seconds`) and the "kv.push" tracing span carry the
JAX package's names.  `MembershipInfo` is a fleet's elasticity,
membership epoch, live count and this process's rank.
"""
from __future__ import annotations

import collections
import contextlib
import time as _time
import zlib

import numpy as _np
import torch

from ..base import MXNetError
from .. import telemetry as _telemetry
from .. import tracing as _tracing

__all__ = ["KVStore", "KVStoreLocal", "MembershipInfo"]

MembershipInfo = collections.namedtuple(
    "MembershipInfo", ("elastic", "epoch", "live", "rank"))

# keys hash into a fixed shard count so label cardinality stays bounded
_N_SHARDS = 16

_tm_push_bytes = _telemetry.counter(
    "kvstore_push_bytes",
    "Post-merge payload bytes pushed into the kvstore (the dist "
    "backend's wire bytes; local counts the same merged size)",
    ("shard",))
_tm_pull_bytes = _telemetry.counter(
    "kvstore_pull_bytes",
    "Bytes pulled out of the kvstore (delivered: payload size times "
    "the number of out arrays)", ("shard",))
_tm_allreduce = _telemetry.histogram(
    "kvstore_allreduce_seconds",
    "Merge/allreduce + server-update latency per push", ("shard",))


def _shard_of(k):
    """The telemetry shard of key `k`: an integer key modulo 16, any
    other key's crc32 modulo 16 (Python's str hash differs between
    processes).  A chunked wire key ("3@1") keeps its key's shard."""
    key = str(k).split("@", 1)[0]
    try:
        return str(int(key) % _N_SHARDS)
    except ValueError:
        return str(zlib.crc32(key.encode()) % _N_SHARDS)


def _nbytes(x):
    """Bytes of an array's dense payload (a row-sparse array's values
    and row ids)."""
    from ..ndarray.sparse import BaseSparseNDArray
    if isinstance(x, BaseSparseNDArray):
        return sum(int(t.numel()) * t.element_size()
                   for t in (x._sp_values,) + tuple(x._sp_aux))
    t = x._data if hasattr(x, "_data") else x
    return int(t.numel()) * t.element_size()


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _sum(tensors):
    """Left-to-right sum of `tensors` (the merge order is the order of
    the list)."""
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(total.device)
    return total


class KVStore:
    """The API every store shares (the JAX package's `KVStore`)."""

    def __init__(self, name):
        self._type = name
        self._updater = None
        self._optimizer = None
        self._compression = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def set_optimizer(self, optimizer):
        from .. import optimizer as opt
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        self._compression = dict(compression_params or {})

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer installed on this kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer installed on this kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        pass

    def membership(self):
        """The fleet as this store sees it: an in-process store is a
        fixed fleet of one."""
        return MembershipInfo(elastic=False, epoch=0, live=1,
                              rank=self.rank)

    def leave(self):
        """Leave an elastic fleet; a fixed fleet has nothing to leave."""

    def exchange_scope(self):
        """Pin one exchange id across the pushes inside the scope; the
        in-process stores have none."""
        return contextlib.nullcontext()

    def close(self):
        """Release the transport; the in-process stores have none."""

    def set_bucket_placement(self, placement):
        """Route bucket keys to servers; the in-process stores have
        none."""

    def set_placement_provider(self, provider):
        """Register the fleet -> placement map; the in-process stores
        have no fleet."""

    def stream_exchange(self):
        """A streamed exchange session (MXNET_KV_OVERLAP), or None: an
        in-process store has no wire to overlap."""
        return None

    # -- multi-key bulk ops: a loop per key here; `KVStoreDist` moves
    #    them as pipelined multi-key frames
    def push_multi(self, keys, values, priority=0):
        for k, v in zip(keys, values):
            self.push(k, v, priority)

    def pull_multi(self, keys, outs, priority=0):
        for k, o in zip(keys, outs):
            self.pull(k, out=o, priority=priority)

    def pushpull_multi(self, keys, values, outs=None, priority=0):
        self.push_multi(keys, values, priority)
        if outs is not None:
            self.pull_multi(keys, outs, priority)


def _deliver(o, t):
    """Write tensor `t` into out array `o`: a pull shell takes it as
    it is, an NDArray gets its values on its own device."""
    from ..ndarray import NDArray
    if isinstance(o, NDArray):
        o._assign(t.to(o._data.device))
    else:
        o._data = t


class KVStoreLocal(KVStore):
    def __init__(self, name="local"):
        super().__init__(name)
        self._store = {}
        self._residual = {}

    def init(self, key, value):
        keys, values = _key_value_pairs(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"key {k!r} already initialized")
            self._store[k] = _as_list(v)[0].copy()

    def _merge(self, vals, key=None):
        from ..ndarray import NDArray
        from ..ndarray.sparse import BaseSparseNDArray, add as _sp_add
        vals = _as_list(vals)
        if any(isinstance(v, BaseSparseNDArray) for v in vals):
            # row-sparse: the index-union sum stays sparse
            merged = vals[0]
            for v in vals[1:]:
                merged = _sp_add(merged, v)
            return merged
        if len(vals) == 1:
            merged = vals[0]
        else:
            with torch.no_grad():
                merged = NDArray(_sum([v._data for v in vals]))
        if self._compression and self._compression.get("type") == "2bit":
            resid = self._residual.get(key)
            merged, resid = _two_bit_roundtrip(
                merged, float(self._compression.get("threshold", 0.5)),
                resid)
            self._residual[key] = resid
        return merged

    def push(self, key, value, priority=0):
        from ..ndarray.sparse import BaseSparseNDArray
        keys, values = _key_value_pairs(key, value)
        for k, vals in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            tm = _telemetry.enabled()
            t0 = _time.perf_counter() if tm else 0.0
            with _tracing.span("kv.push"):
                merged = self._merge(vals, key=k)
                if tm:
                    shard = _shard_of(k)
                    _tm_push_bytes.labels(shard).inc(_nbytes(merged))
                if self._updater is not None:
                    self._updater(_int_key(k), merged, self._store[k])
                elif isinstance(merged, BaseSparseNDArray) and \
                        not isinstance(self._store[k], BaseSparseNDArray):
                    self._store[k] = merged.tostype("default")
                else:
                    self._store[k] = merged
            if tm:
                _tm_allreduce.labels(shard).observe(
                    _time.perf_counter() - t0)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        from ..ndarray.sparse import BaseSparseNDArray
        keys, outs = _key_value_pairs(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            src = self._store[k]
            if isinstance(src, BaseSparseNDArray):
                if ignore_sparse:
                    continue
                src = src.tostype("default")
            outs_l = _as_list(olist)
            for o in outs_l:
                _deliver(o, src._data)
            if _telemetry.enabled():
                _tm_pull_bytes.labels(_shard_of(k)).inc(
                    _nbytes(src) * len(outs_l))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Only the rows `row_ids` of each key, as a RowSparseNDArray
        (written into `out`, and returned)."""
        from ..ndarray.sparse import RowSparseNDArray, retain
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        keys, outs = _key_value_pairs(key, out)
        ids_list = row_ids if isinstance(row_ids, (list, tuple)) \
            else [row_ids] * len(keys)
        results = []
        for k, olist, ids in zip(keys, outs, ids_list):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            src = self._store[k]
            ids_np = _np.unique(_np.asarray(
                ids.asnumpy() if hasattr(ids, "asnumpy") else ids
            ).astype(_np.int64))
            if isinstance(src, RowSparseNDArray):
                res = retain(src, ids_np)
            else:
                idx = torch.as_tensor(ids_np, device=src._data.device)
                res = RowSparseNDArray(src._data[idx], (idx,), src.shape)
            for o in _as_list(olist):
                if o is None:
                    continue
                if isinstance(o, RowSparseNDArray):
                    o._sp_values, o._sp_aux = res._sp_values, res._sp_aux
                    o._sp_shape = res._sp_shape
                else:
                    _deliver(o, res.tostype("default")._data)
            results.append(res)
        return results if len(results) > 1 else results[0]

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)


def _int_key(k):
    """The integer identity of a key (lr_mult/wd_mult lookups): a chunked
    wire key ("3@1") keeps its key's identity; a string that is no
    integer maps to a stable non-negative int."""
    if isinstance(k, str) and "@" in k:
        k = k.split("@", 1)[0]
    try:
        return int(k)
    except (TypeError, ValueError):
        return zlib.crc32(str(k).encode()) % (1 << 30)


def _key_value_pairs(key, value):
    if isinstance(key, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(key) != len(value):
            raise MXNetError("key list and value list length mismatch")
        return list(key), list(value)
    return [key], [value]


def _two_bit_roundtrip(x, threshold, residual=None):
    """2-bit compression as the store applies it: x (+ the residual)
    quantized to {-threshold, 0, +threshold} (strictly past the
    threshold), the error returned as the new residual."""
    from ..ndarray import NDArray
    t = x._data
    with torch.no_grad():
        if residual is not None:
            t = t + residual._data
        pos = (t > threshold).to(t.dtype)
        neg = (t < -threshold).to(t.dtype)
        q = (pos - neg) * threshold
        return NDArray(q), NDArray(t - q)
