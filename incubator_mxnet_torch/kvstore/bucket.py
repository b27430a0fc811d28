"""Size-targeted gradient buckets for the kvstore exchange (counterpart
of `incubator_mxnet_tpu/kvstore/bucket.py`).

Exchanging one key per parameter costs one wire round trip per tensor,
~200 for BERT-base where most tensors are small.  The bucketer packs the
gradients into flat, size-targeted buckets (4 MiB by default,
``MXNET_KV_BUCKET_KB`` overrides) and the kvstore moves one flat array
per bucket.

The plan is a pure function of the ordered (key, shape, dtype) list and
the byte target, so every worker computes the same plan with no
coordination; each bucket's wire key (``__bucket__<bid>:<digest>``)
carries a digest of the plan, the same digest as the JAX package gives
for the same plan, so a worker of either package lands on the same
keys and a mismatched plan stalls cleanly instead of merging misaligned
buffers.  Buckets group by dtype; a parameter larger than the target
gets a bucket of its own.

Pack is one concatenation per bucket on the gradients' device, with the
1/batch scale (rounded to the bucket's dtype first, as the JAX pack
casts it) applied in place; unpack is one host-to-device copy and one
multi-tensor copy into the per-parameter arrays.  `BucketStream` posts
a bucket the moment its last gradient lands during backward
(``MXNET_KV_OVERLAP``).
"""
from __future__ import annotations

import hashlib
import time as _time

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from .. import health as _health
from .. import telemetry as _telemetry
from .. import tracing as _tracing

__all__ = ["Bucket", "build_plan", "bucket_target_bytes", "plan_digest",
           "GradientBucketer", "BucketStream", "DEFAULT_BUCKET_KB"]

DEFAULT_BUCKET_KB = 4096

# the wire-key namespace of bucket keys: the dist layer sends a bucket
# whole to one server (chunks of it would share one optimizer identity
# and advance its update count once per chunk)
BUCKET_KEY_PREFIX = "__bucket__"

_tm_fill = _telemetry.histogram(
    "kvstore_bucket_fill_ratio",
    "Bucket payload bytes over the MXNET_KV_BUCKET_KB target (>1 for "
    "single parameters larger than the target)",
    buckets=(0.125, 0.25, 0.5, 0.75, 0.9, 1.0, 1.5, 2.0, 4.0, 8.0))
_tm_buckets = _telemetry.gauge(
    "kvstore_gradient_buckets",
    "Buckets in the most recently built gradient bucket plan")
_tm_overlap = _telemetry.gauge(
    "kvstore_overlap_fraction",
    "Share of the last streamed exchange's wire time that ran during "
    "backward (MXNET_KV_OVERLAP; ~0 means the exchange waited for the "
    "whole backward pass, ~1 means it was fully hidden)")
_tm_ready = _telemetry.histogram(
    "kvstore_bucket_ready_seconds",
    "Per-bucket readiness latency under MXNET_KV_OVERLAP: time from "
    "the start of the backward sweep until the bucket's last gradient "
    "landed and its push was posted",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
             2.5, 5.0))

# itemsizes numpy alone cannot name: bfloat16's is 2, as the JAX
# package resolves it, and the plan's digest covers it
_ITEMSIZE = {"bfloat16": 2}


def bucket_target_bytes():
    """Byte target per bucket; 0 or less turns bucketing off.
    ``MXNET_KV_BUCKET_KB`` > the tuner's ``kv_bucket_kb`` > 4 MiB."""
    from .. import tuner as _tuner
    kb = _tuner.env_or_tuned("MXNET_KV_BUCKET_KB", "kv_bucket_kb",
                             DEFAULT_BUCKET_KB, int)
    return max(0, kb) * 1024


def dtype_str(dtype):
    """The plan's name of a dtype: a torch dtype (or "torch.x") by its
    bare name, anything else as `str` gives it (as the JAX plan does)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    s = str(dtype)
    return s[6:] if s.startswith("torch.") else s


class Bucket:
    """One flat bucket: a contiguous slice per member parameter."""

    __slots__ = ("bid", "wire_key", "indices", "keys", "shapes", "dtype",
                 "numels", "offsets", "size", "nbytes")

    def __init__(self, bid, wire_key, indices, keys, shapes, dtype,
                 numels, nbytes):
        self.bid = bid
        self.wire_key = wire_key
        self.indices = tuple(indices)
        self.keys = tuple(keys)
        self.shapes = tuple(tuple(s) for s in shapes)
        self.dtype = dtype
        self.numels = tuple(numels)
        offs, off = [], 0
        for n in numels:
            offs.append(off)
            off += n
        self.offsets = tuple(offs)
        self.size = off
        self.nbytes = nbytes

    def __repr__(self):
        return (f"Bucket({self.wire_key}, n={len(self.keys)}, "
                f"dtype={self.dtype}, elems={self.size})")


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _itemsize(dtype):
    if dtype in _ITEMSIZE:
        return _ITEMSIZE[dtype]
    try:
        return _np.dtype(dtype).itemsize
    except TypeError:
        return 4


def build_plan(items, target_bytes=None):
    """items: ordered [(key, shape, dtype)] -> [Bucket].

    Greedy size-targeted fill in item order within per-dtype groups
    (first-appearance order): a pure function of (items, target)."""
    if target_bytes is None:
        target_bytes = bucket_target_bytes()
    if target_bytes <= 0:
        raise MXNetError("bucketing disabled (MXNET_KV_BUCKET_KB <= 0)")
    items = [(k, tuple(shape), dtype_str(dtype))
             for k, shape, dtype in items]
    # the digest covers everything the fill depends on, each dtype's
    # itemsize included
    sizes = tuple(sorted({dt: _itemsize(dt) for _k, _s, dt
                          in items}.items()))
    digest = hashlib.sha1(
        repr((int(target_bytes), sizes, items)).encode()).hexdigest()[:8]
    groups = {}
    for pos, (k, shape, dtype) in enumerate(items):
        groups.setdefault(dtype, []).append((pos, k, shape, _numel(shape)))
    plan = []
    tm = _telemetry.enabled()
    for dtype, members in groups.items():
        isz = _itemsize(dtype)
        cur, cur_bytes = [], 0

        def close(cur, cur_bytes, dtype=dtype):
            bid = len(plan)
            plan.append(Bucket(
                bid, f"{BUCKET_KEY_PREFIX}{bid}:{digest}",
                [m[0] for m in cur], [m[1] for m in cur],
                [m[2] for m in cur], dtype, [m[3] for m in cur],
                cur_bytes))
            if tm:
                _tm_fill.observe(cur_bytes / target_bytes)

        for m in members:
            nbytes = m[3] * isz
            if cur and cur_bytes + nbytes > target_bytes:
                close(cur, cur_bytes)
                cur, cur_bytes = [], 0
            cur.append(m)
            cur_bytes += nbytes
        if cur:
            close(cur, cur_bytes)
    if tm:
        _tm_buckets.set(len(plan))
    return plan


def plan_digest(plan):
    """The 8-hex layout digest every wire key of one plan carries."""
    if not plan:
        return ""
    return plan[0].wire_key.rsplit(":", 1)[1]


class _PullShell:
    """Out slot of a bucket pull: carries shape and dtype and receives
    the pulled tensor as `_data` (no buffer is made for it)."""

    __slots__ = ("shape", "dtype", "_data")

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype
        self._data = None


def _scale_of(scale, dtype):
    """`scale` as a 0-d tensor of `dtype`, rounded through float32 as
    the JAX pack casts it."""
    return torch.tensor(float(scale), dtype=torch.float32).to(dtype)


def unpack_into(bucket, flat, outs):
    """Split tensor `flat` (any device) into `bucket`'s members and write
    them into `outs[j]` (NDArrays): one copy to the members' device and
    one multi-tensor copy."""
    dsts = [outs[j] for j in bucket.indices]
    dev = dsts[0]._data.device
    t = flat.to(dev)
    segs = [s.view(sh) for s, sh in zip(torch.split(t, bucket.numels),
                                        bucket.shapes)]
    fast, slow = [], []
    for d, s in zip(dsts, segs):
        if tuple(d._data.shape) == tuple(s.shape) \
                and d._data.dtype == s.dtype and d._data.device == dev:
            d._prepare_write()
            fast.append((d._data, s))
        else:
            slow.append((d, s))
    if fast:
        with torch.no_grad():
            torch._foreach_copy_([a for a, _ in fast],
                                 [b for _, b in fast])
    for d, s in slow:
        d._assign(s.clone())


class GradientBucketer:
    """Bucketed allreduce over any KVStore.

    `items` is the ordered [(key, shape, dtype)] description of the
    gradient set (the same on every worker); `allreduce` packs the live
    gradients into flat buckets, runs one pushpull per bucket (the dist
    store batches them into pipelined multi-key frames) and unpacks the
    merged buckets in place.
    """

    def __init__(self, kv, items, target_bytes=None):
        self.kv = kv
        self.plan = build_plan(items, target_bytes)
        self._inited = False
        # ZeRO: the byte-balanced placement of bucket keys on servers
        # (a pure function of the plan and the fleet)
        from . import zero as _zero
        if _zero.enabled() and getattr(kv, "_num_servers", 1) > 1:
            plan = self.plan
            kv.set_placement_provider(
                lambda fleet: _zero.placement_for_fleet(plan, fleet))

    def init(self, values):
        """Initialize the bucket keys from per-item values (the
        update-on-kvstore path: the server stores packed weights)."""
        for b in self.plan:
            self.kv.init(b.wire_key, self._pack_one(b, values))
        self._inited = True

    def _ensure_init(self):
        if self._inited:
            return
        from ..ndarray import NDArray
        for b in self.plan:
            try:
                self.kv.init(b.wire_key, NDArray(torch.zeros(
                    (b.size,), dtype=torch_dtype(b.dtype))))
            except MXNetError as e:
                # only the duplicate init of an identical plan is
                # tolerated; anything else must surface
                if "already initialized" not in str(e):
                    raise
        self._inited = True

    # -- pack / unpack -------------------------------------------------
    def _pack_one(self, bucket, values, scale=None):
        """One device's per-item arrays packed into the bucket's flat."""
        from ..ndarray import NDArray
        dt = torch_dtype(bucket.dtype)
        parts = []
        for j in bucket.indices:
            v = values[j]
            if getattr(v, "stype", "default") != "default":
                raise MXNetError(
                    f"cannot pack sparse array (item {j}) into a "
                    f"gradient bucket — keep the per-key path "
                    f"(MXNET_KV_BUCKET_KB=0) for sparse gradients")
            parts.append(v._data.detach().reshape(-1).to(dt))
        with torch.no_grad():
            flat = torch.cat(parts)
            if scale is not None:
                flat.mul_(_scale_of(scale, dt))
        return NDArray(flat)

    def _pack(self, bucket, values, scale=None):
        """values: per-item NDArray, or per-item list of per-device
        NDArrays; returns one flat NDArray (or a per-device list of
        flats for the kvstore to merge).  With MXNET_KV_HIERARCHY=1 the
        per-device flats are summed on the leading device first."""
        first = values[bucket.indices[0]]
        if isinstance(first, (list, tuple)):
            flats = [self._pack_one(
                bucket, {j: values[j][d] for j in bucket.indices}, scale)
                for d in range(len(first))]
            if len(flats) > 1:
                from . import hierarchy as _hier
                if _hier.enabled():
                    reduced = _hier.reduce_flats(flats)
                    if reduced is not None:
                        if _health.enabled():
                            _health.note_bucket(bucket.wire_key,
                                                reduced._data)
                        return reduced
            return flats
        out = self._pack_one(bucket, values, scale)
        if _health.enabled():
            _health.note_bucket(bucket.wire_key, out._data)
        return out

    def _unpack(self, bucket, flat, outs):
        unpack_into(bucket, flat._data, outs)

    # -- the exchange --------------------------------------------------
    def push(self, grads, scale=None):
        """Pack and push every bucket (the scale folded into the pack)."""
        self._ensure_init()
        keys = [b.wire_key for b in self.plan]
        with _tracing.span("bucket.pack", buckets=len(self.plan)):
            vals = [self._pack(b, grads, scale) for b in self.plan]
        self.kv.push_multi(keys, vals)

    def pull(self, outs):
        """Pull every bucket and unpack into the per-item `outs`."""
        keys = [b.wire_key for b in self.plan]
        flats = [_PullShell((b.size,), b.dtype) for b in self.plan]
        self.kv.pull_multi(keys, flats)
        with _tracing.span("bucket.unpack", buckets=len(self.plan)):
            for b, f in zip(self.plan, flats):
                self._unpack(b, f, outs)

    def resync(self, outs):
        """Refresh the per-item `outs` from the server's packed store."""
        self._inited = True
        self.pull(outs)

    def allreduce(self, grads, outs=None, scale=None):
        """Merged-sum exchange: pack, one pushpull per bucket, unpack.
        Writes back into `grads` unless `outs` is given.  With
        MXNET_KV_HIERARCHY=1 and several processes per host the
        exchange goes through the host's relay leader."""
        if outs is None:
            outs = grads
        from . import hierarchy as _hier
        relay = _hier.relay()
        if relay is not None:
            return relay.allreduce(self, grads, outs, scale)
        self._ensure_init()
        keys = [b.wire_key for b in self.plan]
        with _tracing.span("bucket.pack", buckets=len(self.plan)):
            vals = [self._pack(b, grads, scale) for b in self.plan]
        flats = [_PullShell((b.size,), b.dtype) for b in self.plan]
        self.kv.pushpull_multi(keys, vals, flats)
        with _tracing.span("bucket.unpack", buckets=len(self.plan)):
            for b, f in zip(self.plan, flats):
                self._unpack(b, f, outs)

    # -- streamed exchange (MXNET_KV_OVERLAP) --------------------------
    def stream(self, grad_of, scale=None):
        """A `BucketStream` for one step's exchange, or None when the
        kvstore has no streaming wire or the bucket keys are not
        initialized yet (the first step runs the plain exchange: its
        init may barrier, which must not happen inside backward).
        `grad_of(j)` returns item j's live gradient when it is ready."""
        if not self._inited:
            return None
        sess = self.kv.stream_exchange()
        if sess is None:
            return None
        return BucketStream(self, sess, grad_of, scale)


class BucketStream:
    """Readiness tracker for one streamed gradient exchange.

    `autograd.backward` calls :meth:`ready` per parameter as its
    gradient becomes final; the moment a bucket's last member lands the
    bucket is packed and its push and pull are posted, and
    :meth:`finish` blocks only for the stragglers before unpacking.  An
    exception inside a hook is kept and raised at the step boundary,
    never inside the user's `backward()`.
    """

    def __init__(self, bucketer, session, grad_of, scale=None):
        self.bucketer = bucketer
        self.session = session
        self.grad_of = grad_of
        self.scale = scale
        self._item_bucket = {}
        self._left = {}
        for pos, b in enumerate(bucketer.plan):
            self._left[pos] = set(b.indices)
            for j in b.indices:
                self._item_bucket[j] = pos
        self._posted = set()
        self._shells = {}
        self._t0 = None
        self._backwards = 0
        self._finished = False
        self.hook_seconds = 0.0
        self.overlap_fraction = None
        self._err = None

    def on_backward(self):
        """Start of a backward sweep.  A second sweep after buckets of
        the first were posted taints the stream: those buckets hold the
        first sweep's gradients."""
        if self._finished:
            return
        self._backwards += 1
        if self._t0 is None:
            self._t0 = _time.monotonic()
        if self._backwards > 1 and self._posted and self._err is None:
            self._err = MXNetError(
                "MXNET_KV_OVERLAP=1 streamed gradient buckets during "
                "an earlier backward() of this step; a second backward "
                "before step() would exchange stale gradients — use "
                "MXNET_KV_OVERLAP=0 for multi-backward (gradient "
                "accumulation) loops")
            self.session.abort()

    def _post_bucket(self, pos):
        """Pack and post one complete bucket: its push, then its pull on
        the same connection (the server answers a sync push only after
        its round applied, so the pull reads the reduced value)."""
        from ..ndarray.sparse import BaseSparseNDArray
        self._posted.add(pos)
        b = self.bucketer.plan[pos]
        vals = {i: self.grad_of(i) for i in b.indices}
        if any(isinstance(v, BaseSparseNDArray) for v in vals.values()):
            raise MXNetError(
                "a gradient turned row-sparse mid-run under "
                "MXNET_KV_OVERLAP=1 — the streamed exchange cannot "
                "fall back to the per-key path once buckets are "
                "posted; run sparse_grad models with "
                "MXNET_KV_OVERLAP=0")
        with _tracing.span("bucket.pack", buckets=1, streamed=True):
            flat = self.bucketer._pack(b, vals, self.scale)
        if self.session.post_push([b.wire_key], [flat]) is not None:
            if self._t0 is not None and _telemetry.enabled():
                _tm_ready.observe(_time.monotonic() - self._t0)
            shell = self._shells[pos] = _PullShell((b.size,), b.dtype)
            self.session.post_pull([b.wire_key], [shell])

    def ready(self, j):
        """Item j's gradient is final: post its bucket when j was the
        bucket's last outstanding member."""
        if self._err is not None or self.session.broken \
                or self._finished:
            return
        t0 = _time.perf_counter()
        try:
            pos = self._item_bucket.get(j)
            if pos is None:
                return
            left = self._left[pos]
            left.discard(j)
            if left or pos in self._posted:
                return
            self._post_bucket(pos)
            # collect acks and early pull replies while backward runs
            self.session.drain()
        except Exception as e:    # noqa: BLE001 — raised at finish()
            self._err = e if isinstance(e, MXNetError) else MXNetError(
                f"MXNET_KV_OVERLAP streamed-exchange hook failed "
                f"({type(e).__name__}: {e}); the step-boundary flush "
                f"re-raises")
        finally:
            self.hook_seconds += _time.perf_counter() - t0

    def finish(self, outs):
        """Post what never streamed, wait for every reply and unpack the
        merged buckets into `outs`; raises the kept error."""
        self._finished = True
        wire_in_backward = self.session.wire_seconds
        if self._err is not None:
            self.session.abort()
            raise self._err
        for pos in range(len(self.bucketer.plan)):
            if pos not in self._posted:
                self._post_bucket(pos)
        self.session.finish()
        total = self.session.wire_seconds
        self.overlap_fraction = (wire_in_backward / total
                                 if total > 0 else 0.0)
        if _telemetry.enabled():
            _tm_overlap.set(self.overlap_fraction)
        with _tracing.span("bucket.unpack",
                           buckets=len(self.bucketer.plan)):
            for pos, b in enumerate(self.bucketer.plan):
                self.bucketer._unpack(b, self._shells[pos], outs)

    def abort(self):
        """Abandon the stream."""
        self._finished = True
        self.session.abort()
