"""Engine: async dependency scheduler + control surface (counterpart
of `incubator_mxnet_tpu/engine.py`; MXNet's ThreadedEngine/NaiveEngine
and `python/mxnet/engine.py`).

Two layers:

- DEVICE ordering: CUDA streams order the card's work, and PyTorch's
  caching allocator keeps a tensor's memory until the work reading it
  is done, so compute needs no second scheduler.
- HOST ordering: the parts of the framework that are not kernels
  (data-pipeline stages, checkpoint writes, Python callbacks) keep
  MXNet's var-dependency protocol.  That engine is C++
  (`csrc/engine.cc`, built into the port's host library by `_native`),
  bound here with ctypes: ``Engine.get().push(fn, const_vars,
  mut_vars)`` with shared readers / exclusive writers per var, worker
  threads, a synchronous NaiveEngine mode
  (``MXNET_ENGINE_TYPE=NaiveEngine``), and async errors captured and
  rethrown at `wait_for_var` / `wait_all`.

`wait_all()` drains the host engine and then synchronizes every card.
`set_bulk_size`/`bulk` keep MXNet's Python surface; nothing in the
port bulks ops, so they are metadata.
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import os
import threading
import time
import weakref

from . import telemetry as _telemetry
from .base import MXNetError, get_env

__all__ = ["set_bulk_size", "bulk", "wait_all", "engine_type",
           "set_engine_type", "Engine", "Var"]

_bulk_size = int(os.environ.get("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN", "15"))


def engine_type():
    return get_env("MXNET_ENGINE_TYPE", "ThreadedEngine")


def set_engine_type(name):
    if name not in ("ThreadedEngine", "ThreadedEnginePerDevice",
                    "NaiveEngine"):
        raise ValueError(f"unknown engine type {name!r}")
    os.environ["MXNET_ENGINE_TYPE"] = name
    Engine._reset()


def set_bulk_size(size):
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


@contextlib.contextmanager
def bulk(size):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def wait_all():
    """Drain the host dependency engine, then every card's queued
    work."""
    if Engine._instance is not None:
        Engine._instance.wait_all()
    from .ndarray.ndarray import waitall
    waitall()


# -- telemetry ----------------------------------------------------------
# Native eng_num_pending/eng_num_executed bridge into callback gauges;
# counts from engines that have been destroyed accumulate in _retired_*
# so the at-exit dump still carries the session totals.

_tm_pushed = _telemetry.counter(
    "engine_ops_pushed", "Ops pushed to the host dependency engine")
_tm_queue_wait = _telemetry.histogram(
    "engine_queue_wait_seconds",
    "Seconds between Engine.push and the op body starting", ("op",))
_tm_run = _telemetry.histogram(
    "engine_run_seconds", "Host-engine op body run time", ("op",))

# _retired_lock serializes gauge collection against Engine.destroy:
# the handle is retired (counters folded into _retired_executed, then
# cleared) under this lock, so a collector never calls into the native
# lib with a freed/NULL handle and never counts an engine twice.
_retired_lock = threading.Lock()
_retired_executed = 0


def _collect_pending():
    with _retired_lock:
        # no live engine = nothing queued (destroy drains first), so 0
        # is the truth, not a stale last-collected value
        return sum(e.num_pending for e in list(Engine._live) if e.handle)


def _collect_executed():
    with _retired_lock:
        return _retired_executed + sum(
            e.num_executed for e in list(Engine._live) if e.handle)


_telemetry.gauge(
    "engine_ops_pending",
    "Ops queued in the host dependency engine (native eng_num_pending)"
).set_function(_collect_pending)
_telemetry.gauge(
    "engine_ops_executed",
    "Ops executed by the host dependency engine (native "
    "eng_num_executed; includes destroyed engines)"
).set_function(_collect_executed)


# -- native library -----------------------------------------------------

_LIB = None

# fn(payload_id, complete_handle, skipped) — skipped=1 when a dependency
# failed: release the payload, don't run the body.
_ENG_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int)


def _native():
    global _LIB
    if _LIB is not None:
        return _LIB
    from ._native import library
    lib = library()
    if hasattr(lib, "_eng_bound"):
        return lib
    lib._eng_bound = True
    lib.eng_create.restype = ctypes.c_void_p
    lib.eng_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.eng_destroy.argtypes = [ctypes.c_void_p]
    lib.eng_new_var.restype = ctypes.c_void_p
    lib.eng_new_var.argtypes = [ctypes.c_void_p]
    lib.eng_delete_var.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.eng_push.restype = ctypes.c_int
    lib.eng_push.argtypes = [ctypes.c_void_p, _ENG_FN, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                             ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                             ctypes.c_int, ctypes.c_char_p]
    lib.eng_on_complete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.eng_wait_for_var.restype = ctypes.c_int
    lib.eng_wait_for_var.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_char_p, ctypes.c_int]
    lib.eng_wait_all.restype = ctypes.c_int
    lib.eng_wait_all.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int]
    lib.eng_num_pending.restype = ctypes.c_int64
    lib.eng_num_pending.argtypes = [ctypes.c_void_p]
    lib.eng_num_executed.restype = ctypes.c_uint64
    lib.eng_num_executed.argtypes = [ctypes.c_void_p]
    lib.eng_clear_var_error.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _LIB = lib
    return lib


class Var:
    """Engine variable: a dependency token holder (MXNet's ThreadedVar).

    Create via `Engine.get().new_var()`; pass in const_vars (shared
    read) or mut_vars (exclusive write) of `push`.
    """

    __slots__ = ("handle", "_engine")

    def __init__(self, handle, engine):
        self.handle = handle
        self._engine = engine


class Engine:
    """Host-side async dependency engine over csrc/engine.cc.

    push(fn, const_vars, mut_vars): `fn()` runs on a worker thread once
    every dependency is granted; reads are concurrent, writes exclusive
    and FIFO per var.  Exceptions raised by `fn` are captured and
    rethrown (as MXNetError) at wait_for_var / wait_all, MXNet's
    async-error contract.
    """

    _instance = None
    _lock = threading.Lock()
    _live = weakref.WeakSet()   # drained+destroyed at interpreter exit

    def __init__(self, num_workers=None, naive=None):
        lib = _native()
        if naive is None:
            naive = engine_type() == "NaiveEngine"
        if num_workers is None:
            num_workers = int(get_env("MXNET_CPU_WORKER_NTHREADS", "0")) \
                or min(8, os.cpu_count() or 4)
        self._lib = lib
        self.naive = bool(naive)
        self.handle = ctypes.c_void_p(
            lib.eng_create(num_workers, 1 if naive else 0))
        # Keep payload closures + the trampoline alive until completion.
        self._payloads = {}
        self._payload_lock = threading.Lock()
        self._next_id = 0
        self._trampoline = _ENG_FN(self._run)
        Engine._live.add(self)

    @classmethod
    def get(cls):
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def _reset(cls):
        with cls._lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            inst.wait_all()
            inst.destroy()

    def destroy(self):
        """Drain and free the native engine (joins worker threads)."""
        global _retired_executed
        # claim the handle atomically: concurrent destroy() calls and
        # gauge collectors both see None and leave it alone, so only
        # this thread drains/reads/frees it (no use-after-free).  The
        # already-executed count retires in the same critical section,
        # so a scrape during the drain below never sees this engine's
        # count vanish (only in-flight ops land after the drain).
        with _retired_lock:
            handle, self.handle = self.handle, None
            pre = self._lib.eng_num_executed(handle) if handle else 0
            _retired_executed += pre
        if handle:
            # drain so ops still in flight land in num_executed
            # (eng_destroy also drains, but by then the handle is
            # gone); captured async op errors are irrelevant here
            buf = ctypes.create_string_buffer(16)
            try:
                self._lib.eng_wait_all(handle, buf, 16)
            except Exception:
                pass
            with _retired_lock:
                _retired_executed += \
                    self._lib.eng_num_executed(handle) - pre
            self._lib.eng_destroy(handle)
        Engine._live.discard(self)

    # -- core API --------------------------------------------------------

    def new_var(self):
        return Var(ctypes.c_void_p(self._lib.eng_new_var(self.handle)),
                   self)

    def delete_var(self, var):
        self._lib.eng_delete_var(self.handle, var.handle)
        var.handle = None

    def _run(self, payload_id, complete, skipped):
        with self._payload_lock:
            fn, t_push, name = self._payloads.pop(payload_id)
        tm = t_push is not None    # telemetry was on at push time
        if tm:
            _tm_queue_wait.labels(name).observe(
                time.perf_counter() - t_push)
        err = None
        if not skipped:  # a failed dependency skips the body entirely
            t0 = time.perf_counter() if tm else 0.0
            try:
                fn()
            except BaseException as exc:  # captured, rethrown at sync
                # points; BaseException too — an escaping SystemExit
                # would wedge the var forever with no on_complete.
                err = f"{type(exc).__name__}: {exc}".encode()
            if tm:
                _tm_run.labels(name).observe(time.perf_counter() - t0)
        self._lib.eng_on_complete(ctypes.c_void_p(complete), err)

    def push(self, fn, const_vars=(), mut_vars=(), priority=0, name="op"):
        """Schedule `fn()` after its var dependencies clear."""
        if not self.handle:     # destroyed (or mid-destroy drain):
            # fail clean instead of handing NULL to the native lib
            raise MXNetError("engine has been destroyed")
        t_push = time.perf_counter() if _telemetry.enabled() else None
        with self._payload_lock:
            self._next_id += 1
            pid = self._next_id
            self._payloads[pid] = (fn, t_push, name)
        _tm_pushed.inc()
        n_c, n_m = len(const_vars), len(mut_vars)
        cv = (ctypes.c_void_p * max(n_c, 1))(
            *[v.handle for v in const_vars])
        mv = (ctypes.c_void_p * max(n_m, 1))(
            *[v.handle for v in mut_vars])
        self._lib.eng_push(self.handle, self._trampoline,
                           ctypes.c_void_p(pid), cv, n_c, mv, n_m,
                           priority, name.encode())

    def wait_for_var(self, var):
        buf = ctypes.create_string_buffer(1024)
        if self._lib.eng_wait_for_var(self.handle, var.handle, buf, 1024):
            self._lib.eng_clear_var_error(self.handle, var.handle)
            raise MXNetError(buf.value.decode(errors="replace"))

    def wait_all(self):
        buf = ctypes.create_string_buffer(1024)
        if self._lib.eng_wait_all(self.handle, buf, 1024):
            raise MXNetError(buf.value.decode(errors="replace"))

    @property
    def num_pending(self):
        return self._lib.eng_num_pending(self.handle)

    @property
    def num_executed(self):
        return self._lib.eng_num_executed(self.handle)


@atexit.register
def _drain_live_engines():
    """Join native worker threads before the interpreter finalizes: a
    worker invoking the ctypes trampoline during Py_Finalize would
    abort.  atexit runs while python callbacks can still execute, so
    pending ops drain cleanly."""
    for eng in list(Engine._live):
        try:
            eng.destroy()
        except Exception:
            pass
    Engine._instance = None
