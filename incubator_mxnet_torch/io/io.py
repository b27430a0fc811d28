"""The DataIter protocol and the core iterators (counterpart of
`incubator_mxnet_tpu/io/io.py`).

Where batches are made.  An iterator makes its arrays in the current
context when `next()` runs: `gpu(0)` unless the caller is inside a
`with cpu():` scope (or another context), and without CUDA a `gpu(0)`
batch raises.  `PrefetchingIter` runs its wrapped iterators on a thread
of its own under the context that was current when it was made.
`DevicePrefetcher` pulls its source on its transfer threads under
`cpu()`, so a source that makes arrays in the current context (an
`NDArrayIter`, a `DataLoader`, a generator of `nd.array`) makes them on
the host, and the prefetcher copies each batch to the card itself.
"""
from __future__ import annotations

import queue as _queue
import threading
import time as _time
import warnings
from collections import namedtuple

import numpy as _np
import torch

from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..base import MXNetError, get_env
from ..context import Context, as_device, cpu, current_context
from ..ndarray import NDArray, array
from ..ndarray.ndarray import _numpy_dtype_32
from ..ndarray.sparse import BaseSparseNDArray
from ..random import np_rng as _frng

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "LibSVMIter", "DevicePrefetcher"]


_tm_batches = _telemetry.counter(
    "io_batches", "Batches produced by data iterators", ("iter",))
_tm_bytes = _telemetry.counter(
    "io_bytes", "Payload bytes produced by data iterators", ("iter",))
_tm_stall = _telemetry.histogram(
    "io_prefetch_stall_seconds",
    "Time the consumer blocked waiting on a prefetch queue", ("iter",))
_tm_h2d_seconds = _telemetry.histogram(
    "io_h2d_seconds",
    "Host->device staging time per batch (the copies' enqueue; with "
    "sync=True the full transfer)", ("iter",))
_tm_h2d_bytes = _telemetry.counter(
    "io_h2d_bytes_total", "Payload bytes staged host->device", ("iter",))
_tm_staging_depth = _telemetry.gauge(
    "io_staging_depth",
    "Batches currently resident in the device staging ring", ("iter",))
# hoisted children: the per-batch hot path pays one enabled() check +
# one observe, not a labels() resolution
_tm_stall_prefetch = _tm_stall.labels("PrefetchingIter")
_tm_stall_device = _tm_stall.labels("DevicePrefetcher")
_tm_h2d_seconds_device = _tm_h2d_seconds.labels("DevicePrefetcher")
_tm_h2d_bytes_device = _tm_h2d_bytes.labels("DevicePrefetcher")
_tm_staging_depth_device = _tm_staging_depth.labels("DevicePrefetcher")


def _nbytes(a):
    """Payload bytes of an NDArray, tensor or numpy array (0 for
    anything else)."""
    if isinstance(a, BaseSparseNDArray):
        return sum(t.numel() * t.element_size() for t in _tensors(a))
    t = a._data if isinstance(a, NDArray) else a
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(getattr(t, "nbytes", 0) or 0)


def _record_batch(kind, batch):
    if not _telemetry.enabled():
        return
    _tm_batches.labels(kind).inc()
    nbytes = sum(_nbytes(a) for a in (getattr(batch, "data", None) or [])) \
        + sum(_nbytes(a) for a in (getattr(batch, "label", None) or []))
    if nbytes:
        _tm_bytes.labels(kind).inc(nbytes)


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Named shape descriptor."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)


class DataBatch:
    """One batch: a data list and a label list."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __repr__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        return f"DataBatch: data shapes: {shapes}"


class DataIter:
    """Iterator protocol: reset/next/iter plus the provide_data and
    provide_label descriptors."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            batch = DataBatch(self.getdata(), self.getlabel(),
                              pad=self.getpad(), index=self.getindex())
            # _tm_label lets delegating wrappers (CSVIter) attribute
            # their inner iterator's batches to themselves
            _record_batch(getattr(self, "_tm_label",
                                  type(self).__name__), batch)
            return batch
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0

    def state(self):
        """A pickleable token of this iterator's position (cursor,
        shuffle order, RNG): `restore(state())` puts an iterator made
        the same way exactly where this one stands.  None for an
        iterator without position."""
        return None

    def restore(self, state):
        """Restore a position captured by `state()`.  None is a no-op;
        a token on an iterator that cannot seek raises, since resuming
        from the wrong position would change the run."""
        if state is not None:
            raise MXNetError(
                f"{type(self).__name__} cannot restore iterator state")


class NDArrayIter(DataIter):
    """Iterate numpy arrays or NDArrays (or dicts or lists of them).
    With `shuffle` and no `shuffle_seed`, the order follows
    `mx.random.seed` (the JAX package's draws fresh entropy there)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 shuffle_seed=None, last_batch_handle="pad",
                 data_name="data", label_name="softmax_label"):
        super().__init__(batch_size)
        self._data = _init_data(data, allow_empty=False,
                                default_name=data_name)
        self._label = _init_data(label, allow_empty=True,
                                 default_name=label_name)
        self._shuffle = shuffle
        # without a shuffle_seed the order's seed comes from the
        # framework's numpy RNG: fresh entropy, or `mx.random.seed`'s
        self._rng = _np.random.RandomState(
            shuffle_seed if shuffle_seed is not None
            else _frng().randint(2 ** 31))
        self._last_batch_handle = last_batch_handle
        self.num_data = self._data[0][1].shape[0]
        if self.num_data < batch_size:
            raise MXNetError("batch_size larger than dataset")
        self._idx = _np.arange(self.num_data)
        self.cursor = -batch_size
        if last_batch_handle == "discard":
            self._limit = self.num_data - self.num_data % batch_size
        else:
            self._limit = self.num_data
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:], a.dtype)
                for n, a in self._data]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:], a.dtype)
                for n, a in self._label]

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self._idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self._limit

    def _take(self, arrays):
        out = []
        for _name, a in arrays:
            sel = self._idx[self.cursor:self.cursor + self.batch_size]
            chunk = a[sel]
            if len(sel) < self.batch_size:   # pad: wrap from the start
                extra = self._idx[:self.batch_size - len(sel)]
                chunk = _np.concatenate([chunk, a[extra]], axis=0)
            out.append(array(chunk, dtype=chunk.dtype))
        return out

    def getdata(self):
        return self._take(self._data)

    def getlabel(self):
        return self._take(self._label)

    def getpad(self):
        overflow = self.cursor + self.batch_size - self._limit
        return max(0, overflow) if self._last_batch_handle == "pad" else 0

    def state(self):
        # the shuffled order and the RNG state both ride along: this
        # epoch replays, and every later reset() shuffles as the run
        # without the interruption would
        return {"kind": "NDArrayIter", "cursor": int(self.cursor),
                "idx": self._idx.copy(), "rng": self._rng.get_state()}

    def restore(self, state):
        if state is None:
            return
        self.cursor = int(state["cursor"])
        self._idx = _np.asarray(state["idx"]).copy()
        if state.get("rng") is not None:
            self._rng.set_state(state["rng"])


class ResizeIter(DataIter):
    """Truncate or loop another iterator to a fixed number of batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch

    def state(self):
        return {"kind": "ResizeIter", "cur": int(self.cur),
                "inner": self.data_iter.state()}

    def restore(self, state):
        if state is None:
            return
        self.cur = int(state["cur"])
        self.data_iter.restore(state["inner"])


class _PrefetchFailure:
    """Queue sentinel carrying a prefetch-thread exception to next()."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class PrefetchingIter(DataIter):
    """Batches of one or more iterators made ahead of the training loop
    on a thread, `prefetch_depth` deep, so that host work overlaps the
    step.  The wrapped iterators run under the context that was current
    when this one was made.  `MXNET_ENGINE_TYPE=NaiveEngine` makes the
    batches in `next()` instead, with no thread."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self._ctx = current_context()
        self._sync = get_env("MXNET_ENGINE_TYPE",
                             "ThreadedEngine") == "NaiveEngine"
        self._queue = _queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self._closed = False
        self._replay = []   # batches made before a state() capture,
        #                     delivered ahead of the queue on resume
        if not self._sync:
            self._start()

    @property
    def provide_data(self):
        return sum([i.provide_data for i in self.iters], [])

    @property
    def provide_label(self):
        return sum([i.provide_label for i in self.iters], [])

    def _start(self):
        # the worker closes over THIS epoch's queue and stop event: a
        # worker left behind by close()/reset() that unblocks later
        # puts into its own orphaned queue and exits on its own flag
        q, stop = self._queue, self._stop

        def work():
            with self._ctx:
                while not stop.is_set():
                    try:
                        item = self._produce()
                    except StopIteration:
                        q.put(None)
                        return
                    except BaseException as e:   # noqa: BLE001 — rethrown
                        # surfaces on the consumer's next(), instead of
                        # leaving it on an empty queue forever
                        q.put(_PrefetchFailure(e))
                        return
                    q.put(item)
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _produce(self):
        batches = [i.next() for i in self.iters]    # may StopIteration
        data = sum([b.data for b in batches], [])
        label = sum([(b.label or []) for b in batches], [])
        return DataBatch(data, label, pad=batches[0].pad)

    def _halt(self, timeout):
        """Stop the worker: set its flag, empty its queue, join it."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def _revive(self, ended):
        """A fresh queue and stop event, then a worker (or the end mark
        when the wrapped iterators are exhausted)."""
        self._queue = _queue.Queue(maxsize=self._queue.maxsize)
        self._stop = threading.Event()
        if ended:
            self._queue.put(None)
        else:
            self._start()

    def reset(self):
        self._replay = []
        if not self._sync:
            self._halt(timeout=5)
        for i in self.iters:
            i.reset()
        self._closed = False
        if not self._sync:
            self._revive(ended=False)

    def close(self):
        """Stop the prefetch thread mid-epoch and wait for it to exit.

        After close() returns the worker no longer reads the wrapped
        iterators, so the caller may tear them down.  A worker blocked
        in `queue.put` is freed by draining the queue; one blocked in a
        wrapped iterator's own next() cannot be interrupted, and after
        10 s it is abandoned with a warning.  reset() revives a closed
        iterator."""
        self._closed = True
        if self._sync or self._thread is None:
            return
        self._stop.set()
        deadline = _time.monotonic() + 10.0
        while self._thread.is_alive() and _time.monotonic() < deadline:
            try:
                self._queue.get_nowait()
            except _queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        if self._thread.is_alive():
            warnings.warn(
                "PrefetchingIter worker did not stop within 10s (blocked "
                "in the wrapped iterator?); do NOT tear down the wrapped "
                "iterators yet: a concurrent read could race them")

    def next(self):
        if self._closed:
            raise StopIteration
        if self._replay:
            return self._replay.pop(0)
        if self._sync:
            return self._produce()
        # batches are counted by the wrapped iterators' next(); the
        # stall is this layer's own signal, and with MXNET_TRACE=1 a
        # "prefetch_stall" span on the step timeline
        tm = _telemetry.enabled()
        t0 = _time.perf_counter() if tm else 0.0
        with _telemetry.timed(None, span="prefetch_stall"):
            item = self._queue.get()
        if tm:
            _tm_stall_prefetch.observe(_time.perf_counter() - t0)
        if item is None or isinstance(item, _PrefetchFailure):
            # terminal states are sticky: the worker has exited, so a
            # second next() raises again instead of blocking forever
            self._queue.put(item)
            if item is None:
                raise StopIteration
            raise item.exc
        return item

    def state(self):
        """Quiesce the worker and capture an exact resume token: the
        batches made but not consumed (at most the prefetch depth) ride
        along as numpy, with each wrapped iterator's own state."""
        pending = list(self._replay)
        if not self._sync and self._thread is not None:
            self._stop.set()
            deadline = _time.monotonic() + 10.0
            while self._thread.is_alive():
                if _time.monotonic() > deadline:
                    raise MXNetError(
                        "PrefetchingIter.state(): worker did not quiesce "
                        "within 10s (blocked in the wrapped iterator?)")
                try:
                    pending.append(self._queue.get(timeout=0.05))
                except _queue.Empty:
                    pass
                self._thread.join(timeout=0.05)
            try:
                while True:
                    pending.append(self._queue.get_nowait())
            except _queue.Empty:
                pass
        for item in pending:
            if isinstance(item, _PrefetchFailure):
                raise item.exc
        ended = any(item is None for item in pending)
        batches = [b for b in pending if b is not None]
        token = {
            "kind": "PrefetchingIter",
            "ended": ended,
            "pending": [([d.asnumpy() for d in b.data],
                         [l.asnumpy() for l in (b.label or [])],
                         b.pad) for b in batches],
            "inner": [i.state() for i in self.iters],
        }
        # the drained batches come back through the replay lane in
        # order; the worker resumes from the wrapped iterators
        self._replay = batches
        if not self._sync:
            self._revive(ended)
        return token

    def restore(self, state):
        if state is None:
            return
        if not self._sync:
            self._halt(timeout=5)
        for it, s in zip(self.iters, state["inner"]):
            it.restore(s)
        with self._ctx:
            self._replay = [DataBatch([array(d) for d in data],
                                      [array(l) for l in label], pad=pad)
                            for data, label, pad in state["pending"]]
        self._closed = False
        if not self._sync:
            self._revive(bool(state.get("ended")))


def _host_tensor(b):
    """The tensor of one source element: an NDArray's own, a tensor, or
    a numpy array (64-bit types as 32-bit ones, as the JAX package's
    device_put stores them)."""
    if isinstance(b, NDArray):
        return b._data
    if isinstance(b, torch.Tensor):
        return b
    a = _np.asarray(b)
    a = a.astype(_numpy_dtype_32(a.dtype), copy=False)
    return torch.from_numpy(_np.require(a, requirements=("C", "W")))


class DevicePrefetcher:
    """Host-to-device staging ring: transfer threads copy batches k+1 ..
    k+K onto the card while the step runs on batch k.

    Wraps any iterable of NDArray/tensor/numpy tuples and yields tuples
    of NDArrays on `ctx`'s device (default: the current context) or on
    `trainer.device` (a `ParallelTrainer`, whose step then finds them in
    place and copies nothing).  The source is pulled under `cpu()` (see
    the module docstring).

    On a CUDA destination each transfer thread owns a `torch.cuda.Stream`:
    a host source is page-locked (`pin_memory()`, a no-op for a pinned
    one, e.g. a `DataLoader(pin_memory=True)` batch), copied with
    `non_blocking=True` into a tensor allocated on that stream, and an
    event is recorded after the copies.  `__next__` makes the consumer's
    current stream wait on that event and calls `record_stream` on each
    tensor, so the caching allocator does not reuse its memory while the
    step still reads it.  A source already on the destination device
    passes through uncopied (so `donate`, which the JAX signature takes,
    has nothing to do here).

    `depth=K` keeps up to K batches per transfer thread staged (default
    `MXNET_IO_STAGING_DEPTH`, else the tuner's ``staging_depth``, else
    2).  Each staging records the h2d telemetry and, with tracing on, an
    ``io.h2d`` span in the step it feeds; the consumer's wait is
    ``io_prefetch_stall_seconds``.  `threads=N` stages up to N batches at
    once while keeping the source's order: each pull takes a position
    under the source lock, finished batches land in a bounded
    position-keyed reorder buffer, and the consumer pops positions in
    order.

    `sync=True` is the zero-copy contract for sources that hand out
    views into reusable buffers: a transfer thread waits until its
    copies have finished before it pulls again.  On a CPU destination,
    where the staged tensor would otherwise be the source's own memory,
    it is cloned.
    """

    def __init__(self, it, ctx=None, trainer=None, depth=None, threads=1,
                 sync=False, donate=False):
        self._dev = trainer.device if trainer is not None \
            else as_device(ctx)
        with cpu():
            self._it = iter(it)
        if depth is None:
            # MXNET_IO_STAGING_DEPTH > tuned.json "staging_depth" > 2
            from .. import tuner as _tuner
            depth = _tuner.env_or_tuned("MXNET_IO_STAGING_DEPTH",
                                        "staging_depth", 2, int)
        self._depth = max(1, int(depth))
        self._n = max(1, int(threads))
        self._sync = bool(sync)
        self._capacity = self._n * self._depth
        self._buf = {}          # position -> (staged tuple, event) | None
        #                         | exception
        self._cv = threading.Condition()
        self._src_lock = threading.Lock()
        self._src_idx = 0       # next source position to pull
        self._get_idx = 0       # next position the consumer pops
        self._stop = threading.Event()      # hard stop (abandon work)
        self._closing = threading.Event()   # graceful: drain in-flight
        self._done = False
        # step-root context the transfer threads parent their io.h2d
        # spans to (refreshed on every consumer pop)
        self._trace_ctx = _tracing.pending_step_context()
        self._workers = [threading.Thread(target=self._work, daemon=True,
                                          name=f"mx-io-stage-{i}")
                         for i in range(self._n)]
        for w in self._workers:
            w.start()

    def _put(self, b):
        """One source element on the destination device (runs under the
        transfer thread's stream on a CUDA destination)."""
        if isinstance(b, BaseSparseNDArray):
            return b.as_in_context(Context.from_device(self._dev))
        t = _host_tensor(b)
        if self._dev.type == "cpu":
            t = t.cpu()
            return NDArray(t.clone() if self._sync else t)
        if t.device == self._dev:
            return b if isinstance(b, NDArray) else NDArray(t)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        out = torch.empty(t.shape, dtype=t.dtype, device=self._dev)
        out.copy_(t, non_blocking=True)
        return NDArray(out)

    def _pull(self):
        """(position, batch | None at the end | Exception): the source
        is shared, so pulls serialize under a lock and each gets a
        unique position for ordered delivery."""
        with self._src_lock:
            j = self._src_idx
            self._src_idx += 1
            try:
                return j, next(self._it)
            except StopIteration:
                return j, None
            except Exception as e:              # surfaces in the consumer
                return j, e

    def _stage(self, item, stream):
        """One source batch on the destination; returns (placed tuple,
        event).  Runs on a transfer thread: the h2d telemetry and an
        ``io.h2d`` span parented to the consumer's step root."""
        tup = tuple(item) if isinstance(item, (tuple, list)) else (item,)
        tm = _telemetry.enabled()
        tid, sid = self._trace_ctx
        t0p = _time.perf_counter() if tm else 0.0
        t0m = _time.monotonic()
        event = None
        if stream is None:
            placed = tuple(self._put(b) for b in tup)
        else:
            with torch.cuda.stream(stream):
                placed = tuple(self._put(b) for b in tup)
                event = torch.cuda.Event()
                event.record(stream)
            if self._sync:
                # the copies must have read the host bytes before the
                # next pull can recycle their buffer
                event.synchronize()
        if tm or tid:
            nbytes = sum(_nbytes(b) for b in tup)
            if tm:
                _tm_h2d_seconds_device.observe(_time.perf_counter() - t0p)
                if nbytes:
                    _tm_h2d_bytes_device.inc(nbytes)
            if tid:
                _tracing.record_span("io.h2d", t0m, _time.monotonic(), tid,
                                     parent_id=sid,
                                     attrs={"bytes": nbytes,
                                            "sync": self._sync})
        return placed, event

    def _work(self):
        stream = torch.cuda.Stream(self._dev) \
            if self._dev.type == "cuda" else None
        with cpu():
            while not (self._stop.is_set() or self._closing.is_set()):
                j, item = self._pull()
                if item is None or isinstance(item, Exception):
                    self._put_item(j, item)
                    return
                try:
                    staged = self._stage(item, stream)
                except Exception as e:
                    self._put_item(j, e)
                    return
                self._put_item(j, staged)

    @staticmethod
    def _settle(item):
        """Wait out a staged batch's copies (they may still be reading
        host memory) before the batch is dropped."""
        if isinstance(item, tuple) and item[1] is not None:
            item[1].synchronize()

    def _put_item(self, pos, item):
        # bounded reorder buffer with stop-aware waits: a consumer that
        # walked away (no close(), buffer full) must not pin this thread
        with self._cv:
            while not (self._stop.is_set() or self._closing.is_set()) \
                    and pos - self._get_idx >= self._capacity:
                self._cv.wait(timeout=0.2)
            if self._stop.is_set():
                dropped = item
            else:
                # closing: deposit anyway (close() settles and drops it);
                # the excursion over capacity is at most the thread count
                dropped = None
                self._buf[pos] = item
                if _telemetry.enabled():
                    _tm_staging_depth_device.set(len(self._buf))
                self._cv.notify_all()
        if dropped is not None:
            # hard stop: nobody pops this, but its copies may be in
            # flight; settle outside the lock
            self._settle(dropped)

    def close(self):
        """Drain in-flight stagings, stop the workers, and release the
        source.  When close() returns (mid-epoch too), no transfer thread
        reads the source and every copy has finished, so the caller may
        tear the source down.  A worker blocked inside the source's own
        next() cannot be interrupted; after 10 s it is abandoned with a
        warning (the source is then NOT safe to tear down)."""
        self._closing.set()
        with self._cv:
            self._cv.notify_all()
        deadline = _time.monotonic() + 10.0
        for w in self._workers:
            w.join(timeout=max(0.0, deadline - _time.monotonic()))
        if any(w.is_alive() for w in self._workers):
            self._stop.set()
            with self._cv:
                self._cv.notify_all()
            for w in self._workers:
                w.join(timeout=2)
        with self._cv:
            leftovers = list(self._buf.values())
            self._buf.clear()
            self._done = True
            self._cv.notify_all()
        for item in leftovers:
            self._settle(item)
        if any(w.is_alive() for w in self._workers):
            warnings.warn(
                "DevicePrefetcher worker did not stop within 10s (blocked "
                "in the wrapped iterator?); do NOT close the underlying "
                "pipeline yet: a concurrent read could race it")

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        tm = _telemetry.enabled()
        t0 = _time.perf_counter() if tm else 0.0
        # refresh the step-root context the transfer threads attribute
        # io.h2d spans to (two tuple reads when tracing is off)
        self._trace_ctx = _tracing.pending_step_context()
        with self._cv:
            while self._get_idx not in self._buf:
                if self._stop.is_set() or self._closing.is_set() or (
                        not any(w.is_alive() for w in self._workers)):
                    # workers always deposit a terminal item before they
                    # exit, so this only trips after close()
                    self._done = True
                    raise StopIteration
                self._cv.wait(timeout=0.5)
            item = self._buf.pop(self._get_idx)
            self._get_idx += 1
            if tm:
                _tm_staging_depth_device.set(len(self._buf))
            self._cv.notify_all()
        if tm:
            _tm_stall_device.observe(_time.perf_counter() - t0)
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            # terminal: the worker has exited; a consumer that catches
            # this and goes on gets StopIteration, not a hang
            self._done = True
            raise item
        placed, event = item
        if event is not None:
            current = torch.cuda.current_stream(self._dev)
            current.wait_event(event)
            for p in placed:
                for t in _tensors(p):
                    if t.device.type == "cuda":
                        t.record_stream(current)
        return placed


def _tensors(a):
    if isinstance(a, BaseSparseNDArray):
        return (a._sp_values,) + tuple(a._sp_aux)
    return (a._data,)


class CSVIter(DataIter):
    """CSV reader: numpy parsing into an NDArrayIter."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype="float32", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                                ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = _np.zeros((data.shape[0],), dtype)
        self._inner = NDArrayIter(
            {data_name: data}, {label_name: label}, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard")
        self._inner._tm_label = "CSVIter"
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def state(self):
        token = self._inner.state()
        token["kind"] = "CSVIter"
        return token

    def restore(self, state):
        self._inner.restore(state)


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise MXNetError("data is required")
        return []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = {default_name: data}
    elif isinstance(data, (list, tuple)):
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, _np.asarray(v)))
    return out


class LibSVMIter(DataIter):
    """LibSVM reader giving CSR batches.  Line format: ``label idx:val
    idx:val`` with 0-based indices."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype="float32", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self._ncol = int(data_shape[0] if isinstance(
            data_shape, (tuple, list)) else data_shape)
        labels, vals, cols, indptr = [], [], [], [0]
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    cols.append(int(i))
                    vals.append(float(v))
                indptr.append(len(cols))
        self._data = (_np.asarray(vals, dtype), _np.asarray(cols, _np.int32),
                      _np.asarray(indptr, _np.int64))
        lshape = tuple(label_shape) if isinstance(
            label_shape, (tuple, list)) else (int(label_shape),)
        if label_libsvm is not None:
            lab = []
            with open(label_libsvm) as f:
                for line in f:
                    toks = line.split()
                    if toks:
                        lab.append([float(t) for t in toks])
            self._labels = _np.asarray(lab, dtype)
            if lshape != (1,):
                self._labels = self._labels.reshape((-1,) + lshape)
            else:
                self._labels = self._labels.reshape(-1)
        else:
            self._labels = _np.asarray(labels, dtype)
        if len(self._labels) != len(indptr) - 1:
            raise MXNetError(
                f"LibSVMIter: {len(self._labels)} label rows for "
                f"{len(indptr) - 1} data rows")
        self._n = len(self._labels)
        self._round = round_batch
        self.provide_data = [DataDesc(data_name,
                                      (batch_size, self._ncol), dtype)]
        lab_desc_shape = (batch_size,) if lshape == (1,) \
            else (batch_size,) + lshape
        self.provide_label = [DataDesc(label_name, lab_desc_shape, dtype)]
        self._cursor = 0

    def reset(self):
        self._cursor = 0

    def state(self):
        return {"kind": "LibSVMIter", "cursor": int(self._cursor)}

    def restore(self, state):
        if state is None:
            return
        self._cursor = int(state["cursor"])

    def next(self):
        from ..ndarray.sparse import csr_matrix
        if self._cursor >= self._n:
            raise StopIteration
        start = self._cursor
        stop = min(start + self.batch_size, self._n)
        pad = self.batch_size - (stop - start)
        self._cursor += self.batch_size
        vals, cols, indptr = self._data
        s, e = indptr[start], indptr[stop]
        bi = (indptr[start:stop + 1] - s).astype(_np.int64)
        if pad:
            if not self._round:
                raise StopIteration
            bi = _np.concatenate([bi, _np.full((pad,), bi[-1], _np.int64)])
        batch = csr_matrix((vals[s:e], cols[s:e], bi),
                           shape=(self.batch_size, self._ncol))
        lab = self._labels[start:stop]
        if pad:
            filler = _np.zeros((pad,) + lab.shape[1:], lab.dtype)
            lab = _np.concatenate([lab, filler])
        return DataBatch(data=[batch], label=[array(lab)], pad=pad)
