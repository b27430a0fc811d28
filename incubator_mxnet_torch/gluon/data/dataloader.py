"""DataLoader (counterpart of `incubator_mxnet_tpu/gluon/data/dataloader.py`).

Workers:

* ``num_workers=0``: items are loaded on a thread of the loader's own
  (or, with ``prefetch=0``, in the iterating thread).
* ``num_workers>0, thread_pool=True``: a thread pool.
* ``num_workers>0, thread_pool=False`` (the default): a pool of spawned
  processes, made once per loader; each worker makes a whole batch and
  hands it back through POSIX shared memory.  Spawn, not fork, because
  the parent holds CUDA and its threads.  The children never open the
  card: the parent sets ``CUDA_VISIBLE_DEVICES=""`` in the environment
  around the spawn, and each child sets it again in its initializer
  (for a worker respawned later).  A training script keeps its loader
  loop under ``if __name__ == "__main__":``, or passes
  ``thread_pool=True``.

Where batches are made.  Dataset items, transforms and `batchify_fn`
run under `cpu()` on the loader's threads and processes, so a dataset
that makes NDArrays in the current context makes them on the host and
no worker makes a tensor on the card.  `iter(loader)` takes the
caller's context (`gpu(0)` unless a `with` scope says otherwise, and
without CUDA it raises there) and places each finished batch on it
once.  With ``pin_memory=True`` (and CUDA on the machine) a batch is
first copied into page-locked memory (on the loader's thread, or as it
is read from shared memory) and sent with ``non_blocking=True``;
iterated under `cpu()` (as
`io.DevicePrefetcher` iterates its source), the loader yields the
page-locked host batch itself.  A batch's values and dtypes are the JAX
package's: float64 becomes float32 and int64 int32.
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as _np
import torch

from ...base import MXNetError
from ...context import as_device, cpu, current_context
from ...ndarray import NDArray, array
from ...ndarray.ndarray import _numpy_dtype_32
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def _is_namedtuple(cls):
    """Namedtuples are rebuilt positionally (cls(*children))."""
    return hasattr(cls, "_fields")


_PICKLABLE_CLS = {}


def _picklable_class(cls):
    """A namedtuple class crosses the worker-to-parent pickle boundary
    in the batch's layout, after the batch is in shared memory; an
    unpicklable one would fail late and leak the segment, so it is
    probed once and degrades to a plain tuple."""
    ok = _PICKLABLE_CLS.get(cls)
    if ok is None:
        try:
            ok = pickle.loads(pickle.dumps(cls)) is cls
        except (pickle.PicklingError, AttributeError, TypeError):
            ok = False
        _PICKLABLE_CLS[cls] = ok
        if not ok:
            warnings.warn(
                f"namedtuple class {cls.__qualname__} is not picklable "
                "(defined at call time or in a closure?); process-worker "
                "batches will be plain tuples: define the class at "
                "module level to keep the type", stacklevel=3)
    return ok


def default_batchify_fn(data):
    """Stack samples into a batch in the current context (the loader's
    workers run it under `cpu()`)."""
    if isinstance(data[0], NDArray):
        with torch.no_grad():
            return NDArray(torch.stack([d._data for d in data]))
    if isinstance(data[0], tuple):
        cols = [default_batchify_fn(list(x)) for x in zip(*data)]
        if _is_namedtuple(type(data[0])):
            return type(data[0])(*cols)
        return tuple(cols)
    return array(_np.asarray(data))


# -- process workers (module level: picklable under spawn) -------------

_WORKER = {}
_SHM_ALIGN = 64


def _mp_worker_init(payload_path):
    # a child never opens the card: CUDA_VISIBLE_DEVICES is empty before
    # torch could initialize CUDA (it does so lazily), also in a worker
    # respawned with the parent's environment; and the child's default
    # context is cpu() (pool tasks run on its main thread).  One torch
    # thread a worker: the workers already use the cores, and each
    # one's intra-op pool would oversubscribe them (torch's own
    # DataLoader workers do the same)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    cpu().__enter__()
    with open(payload_path, "rb") as f:     # written by the parent
        _WORKER["dataset"], _WORKER["batchify"] = pickle.load(f)


def _leaf_tensor(x):
    """A CPU tensor of one batch leaf (64-bit numpy types as 32-bit)."""
    if isinstance(x, NDArray):
        return x._data.detach().cpu()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    a = _np.asarray(x)
    return torch.from_numpy(_np.require(
        a.astype(_numpy_dtype_32(a.dtype), copy=False),
        requirements=("C", "W")))


def _np_view(t):
    """A numpy view of a contiguous CPU tensor (bfloat16 as int16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _mp_worker_batch(indices):
    """Make one batch and put it in POSIX shared memory.  Returns
    (shm name, [(shape, torch dtype, offset), ...], layout)."""
    from multiprocessing import resource_tracker, shared_memory
    items = [_WORKER["dataset"][i] for i in indices]
    leaves, spec = _flatten(_WORKER["batchify"](items))
    flat = [_leaf_tensor(x).contiguous() for x in leaves]
    metas, off = [], 0
    for t in flat:
        metas.append((tuple(t.shape), t.dtype, off))
        off += -(-t.numel() * t.element_size() // _SHM_ALIGN) * _SHM_ALIGN
    shm = shared_memory.SharedMemory(create=True, size=max(off, 1))
    try:
        for t, (shape, _dt, o) in zip(flat, metas):
            src = _np_view(t)
            dst = _np.ndarray(src.shape, src.dtype, buffer=shm.buf, offset=o)
            dst[...] = src
            del dst
        name = shm.name
    finally:
        shm.close()
    # the parent owns unlink; drop this child's resource-tracker claim
    # so that pool shutdown does not report a leaked segment
    resource_tracker.unregister("/" + name, "shared_memory")
    return name, metas, spec


def _flatten(tree):
    """The leaves of a dict/list/tuple tree and a layout that keeps the
    container types and dict keys."""
    if isinstance(tree, dict):
        flat, specs = [], []
        for k, v in tree.items():
            f, s = _flatten(v)
            flat.extend(f)
            specs.append(s)
        return flat, ("map", list(tree.keys()), specs)
    if isinstance(tree, (tuple, list)):
        flat, specs = [], []
        for t in tree:
            f, s = _flatten(t)
            flat.extend(f)
            specs.append(s)
        if _is_namedtuple(type(tree)) and _picklable_class(type(tree)):
            return flat, ("ntuple", type(tree), specs)
        return flat, ("seq", isinstance(tree, list), specs)
    return [tree], ("leaf",)


def _unflatten(spec, flat, pos=0):
    if spec[0] == "leaf":
        return flat[pos], pos + 1
    if spec[0] == "map":
        _, keys, specs = spec
        out = {}
        for k, s in zip(keys, specs):
            out[k], pos = _unflatten(s, flat, pos)
        return out, pos
    out = []
    for s in spec[2]:
        node, pos = _unflatten(s, flat, pos)
        out.append(node)
    if spec[0] == "ntuple":
        return spec[1](*out), pos
    return (out if spec[1] else tuple(out)), pos


def _read_shm_batch(result, pin):
    """The batch a worker staged, as NDArrays on the host (page-locked
    with `pin`); the segment is unlinked."""
    from multiprocessing import shared_memory
    name, metas, spec = result
    shm = shared_memory.SharedMemory(name=name)
    try:
        arrays = []
        for shape, dtype, off in metas:
            out = torch.empty(shape, dtype=dtype, pin_memory=pin)
            dst = _np_view(out)
            count = int(_np.prod(shape, dtype=_np.int64))
            view = _np.frombuffer(shm.buf, dtype=dst.dtype, count=count,
                                  offset=off)
            dst[...] = view.reshape(shape)
            # no view of the segment may outlive close()
            del view, dst
            arrays.append(NDArray(out))
        tree, _ = _unflatten(spec, arrays)
        return tree
    finally:
        shm.close()
        shm.unlink()


def _discard_shm_batch(result):
    """Unlink a staged batch without reading it (early-exit cleanup)."""
    from multiprocessing import shared_memory
    try:
        shm = shared_memory.SharedMemory(name=result[0])
    except FileNotFoundError:
        return
    shm.close()
    shm.unlink()


def _map_leaves(fn, tree):
    """`tree` with `fn` applied to each NDArray leaf."""
    if isinstance(tree, NDArray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map_leaves(fn, t) for t in tree]
        if _is_namedtuple(type(tree)):
            return type(tree)(*out)
        return type(tree)(out)
    return tree


def _pinned(a):
    return a if a._data.is_pinned() else NDArray(a._data.pin_memory())


def _enter_cpu():
    cpu().__enter__()


class DataLoader:
    """Loads batches of a dataset; see the module docstring for the
    workers and for where batches are placed."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise MXNetError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._thread_pool = thread_pool
        self._pin_memory = bool(pin_memory)
        self._timeout = timeout
        self._picklable = None
        self._pool = None
        self._orphans = []
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(1, num_workers))

    def __len__(self):
        return len(self._batch_sampler)

    def _load_batch(self, indices, pool, pin):
        """One batch on the host (the caller runs under `cpu()`)."""
        if pool is not None:
            items = list(pool.map(self._dataset.__getitem__, indices))
        else:
            items = [self._dataset[i] for i in indices]
        batch = self._batchify_fn(items)
        return _map_leaves(_pinned, batch) if pin else batch

    def _get_pool(self):
        """The spawned pool, made once per loader and kept across epochs:
        workers hold the dataset as it was when the pool was made (make
        a new DataLoader to see a dataset changed in place).

        The dataset and `batchify_fn` reach the workers through a
        temporary file that `close()` removes, not as the initializer's
        arguments: spawn writes those into a pipe that the child reads
        only after importing the main module (torch), so a payload over
        the pipe's buffer would block each worker's start until the one
        before had imported torch, and the workers would start one after
        another, seconds apart."""
        if self._pool is None:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            fd, self._payload = tempfile.mkstemp(prefix="mx-dataloader-",
                                                 suffix=".pkl")
            with os.fdopen(fd, "wb") as f:
                pickle.dump((self._dataset, self._batchify_fn), f)
            saved = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                self._pool = ctx.Pool(
                    self._num_workers, initializer=_mp_worker_init,
                    initargs=(self._payload,))
            except BaseException:
                os.unlink(self._payload)
                raise
            finally:
                if saved is None:
                    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = saved
        return self._pool

    def _iter_processes(self, pin):
        """Spawned workers, whole batches through shared memory.  The work
        in flight is `prefetch` batches at most (more would stage the
        epoch in /dev/shm when the step is the bottleneck); `timeout`
        bounds each wait; an early exit drains and unlinks what was
        already staged."""
        window = max(self._num_workers, self._prefetch, 1)
        pool = self._get_pool()
        self._sweep_orphans()
        pending = deque()
        try:
            for indices in self._batch_sampler:
                pending.append(pool.apply_async(_mp_worker_batch,
                                                (list(indices),)))
                if len(pending) >= window:
                    yield self._next_result(pending, pin)
            while pending:
                yield self._next_result(pending, pin)
        finally:
            # a batch still being made past the grace cannot be waited
            # for here (the worker stages it later): it is kept as an
            # orphan and swept at the next epoch or close()
            while pending:
                r = pending.popleft()
                try:
                    _discard_shm_batch(r.get(1.0 if self._pool else 0.1))
                except Exception:       # noqa: BLE001 — swept later
                    self._orphans.append(r)

    def _sweep_orphans(self):
        """Unlink the segments of batches abandoned while a worker was
        still making them."""
        still = []
        for r in self._orphans:
            try:
                _discard_shm_batch(r.get(0.001))
            except Exception:           # noqa: BLE001 — not ready or failed
                if not r.ready():
                    still.append(r)
        self._orphans = still

    def _next_result(self, pending, pin):
        import multiprocessing as mp
        try:
            # peek, don't pop: on timeout the result stays in `pending`
            # so the drain can still unlink its segment
            result = pending[0].get(self._timeout)
        except mp.TimeoutError:
            self.close()
            raise MXNetError(
                f"DataLoader worker produced no batch within "
                f"{self._timeout}s. Common causes: (1) the training "
                f"script is a file whose DataLoader loop is NOT under "
                f"`if __name__ == '__main__':`: spawned workers "
                f"re-import the main module and wedge; guard the entry "
                f"point or pass thread_pool=True; (2) a hung dataset "
                f"__getitem__: raise `timeout`.") from None
        pending.popleft()
        return _read_shm_batch(result, pin)

    def close(self):
        """Shut the worker pool down (also runs on garbage collection)."""
        if self._pool is not None:
            self._sweep_orphans()
            self._pool.terminate()
            self._pool.join()
            self._pool = None
            os.unlink(self._payload)
        self._sweep_orphans()

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self.close()

    def __iter__(self):
        dev = as_device(current_context())
        pin = self._pin_memory and torch.cuda.is_available()
        if self._num_workers > 0 and not self._thread_pool:
            # spawn needs a picklable dataset and batchify_fn; closures
            # fall back to thread workers (probed once per loader)
            if self._picklable is None:
                try:
                    pickle.dumps(self._dataset)
                    pickle.dumps(self._batchify_fn)
                    self._picklable = True
                except (pickle.PicklingError, AttributeError, TypeError):
                    self._picklable = False
                    warnings.warn(
                        "DataLoader: dataset/batchify_fn not picklable; "
                        "falling back to thread workers (pass "
                        "thread_pool=True to silence)")
            if self._picklable:
                return self._placed(self._iter_processes(pin), dev)
        return self._placed(self._iter_threads(pin), dev)

    @staticmethod
    def _placed(batches, dev):
        def put(a):
            return NDArray(a._data.to(dev, non_blocking=a._data.is_pinned()))
        try:
            for batch in batches:
                yield batch if dev.type == "cpu" else _map_leaves(put, batch)
        finally:
            batches.close()

    def _iter_threads(self, pin):
        pool = (ThreadPoolExecutor(self._num_workers,
                                   initializer=_enter_cpu)
                if self._num_workers > 0 else None)
        if self._prefetch == 0:
            try:
                for indices in self._batch_sampler:
                    with cpu():
                        batch = self._load_batch(indices, pool, pin)
                    yield batch
            finally:
                if pool:
                    pool.shutdown()
            return

        q = queue.Queue(maxsize=self._prefetch)
        sentinel = object()
        stop = threading.Event()

        def _put(item):
            # a bounded put that gives up when the consumer walked away
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with cpu():
                try:
                    for indices in self._batch_sampler:
                        if not _put(self._load_batch(indices, pool, pin)):
                            return
                except Exception as e:  # noqa: BLE001 — raised in consumer
                    _put(e)
                    return
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5)
            if pool:
                pool.shutdown(wait=False)
