"""Storage: pooled host-memory manager (counterpart of
`incubator_mxnet_tpu/storage.py`; MXNet's `Storage::Get()->Alloc/Free`
with size-bucketed free lists).

Device memory belongs to PyTorch's caching allocator.  What the
framework pools is host memory on the input path (RecordIO chunks,
decode scratch, batch staging before the copy to the card): the C++
pool of `csrc/storage.cc` (power-of-two buckets, 64-byte alignment,
stats, alloc/free events for the profiler's memory view), built into
the port's host library by `_native` and bound with ctypes.
`StorageHandle.asbuffer()` views a block as a numpy array so pipeline
stages write into pooled memory directly.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as _np

from .base import MXNetError

__all__ = ["Storage", "StorageHandle"]


def _native():
    from ._native import library
    lib = library()
    if hasattr(lib, "_sto_bound"):
        return lib
    lib._sto_bound = True
    lib.sto_create.restype = ctypes.c_void_p
    lib.sto_alloc.restype = ctypes.c_void_p
    lib.sto_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.sto_free.restype = ctypes.c_int
    lib.sto_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.sto_release_all.argtypes = [ctypes.c_void_p]
    lib.sto_destroy.argtypes = [ctypes.c_void_p]
    lib.sto_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.sto_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sto_profile_drain.restype = ctypes.c_int
    lib.sto_profile_drain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64)]
    return lib


class MemEvent(ctypes.Structure):
    """Mirror of csrc/storage.cc MemEvent (profile_memory events)."""
    _fields_ = [("t_us", ctypes.c_int64), ("size", ctypes.c_uint64),
                ("kind", ctypes.c_int32), ("reserved", ctypes.c_int32),
                ("allocated", ctypes.c_uint64), ("pooled", ctypes.c_uint64)]


class StorageHandle:
    """One pooled allocation (MXNet's Storage::Handle)."""

    __slots__ = ("ptr", "size", "_pool")

    def __init__(self, ptr, size, pool):
        self.ptr = ptr
        self.size = size
        self._pool = pool

    def asbuffer(self, dtype=_np.uint8, shape=None):
        """View the block as a numpy array (no copy)."""
        dtype = _np.dtype(dtype)
        count = self.size // dtype.itemsize
        buf = (ctypes.c_char * self.size).from_address(self.ptr)
        arr = _np.frombuffer(buf, dtype=dtype, count=count)
        return arr.reshape(shape) if shape is not None else arr

    def free(self):
        if self.ptr:
            self._pool._free(self)
            self.ptr = None


class Storage:
    """Process-wide pooled host allocator (MXNet's Storage::Get())."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._lib = lib = _native()
        self.handle = ctypes.c_void_p(lib.sto_create())

    @classmethod
    def get(cls):
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def alloc(self, size):
        ptr = self._lib.sto_alloc(self.handle, size)
        if not ptr:
            raise MemoryError(f"storage pool alloc of {size} bytes failed")
        return StorageHandle(ptr, int(size), self)

    def _free(self, h):
        self._lib.sto_free(self.handle, ctypes.c_void_p(h.ptr))

    def release_all(self):
        """Return pooled blocks to the OS (live blocks stay valid)."""
        self._lib.sto_release_all(self.handle)

    def stats(self):
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.sto_stats(self.handle, *[ctypes.byref(v) for v in vals])
        return {"bytes_allocated": vals[0].value,
                "bytes_pooled": vals[1].value,
                "alloc_calls": vals[2].value,
                "pool_hits": vals[3].value}

    def profile(self, enable):
        """Toggle alloc/free event capture (profiler profile_memory)."""
        self._lib.sto_profile(self.handle, 1 if enable else 0)

    def profile_drain(self, cap=65536):
        """Drain captured events.  Returns (events, native_now_us,
        dropped) — event timestamps are native steady-clock micros;
        rebase with `py_now - native_now`."""
        buf = (MemEvent * cap)()
        now = ctypes.c_int64()
        dropped = ctypes.c_uint64()
        n = self._lib.sto_profile_drain(self.handle, buf, cap,
                                        ctypes.byref(now),
                                        ctypes.byref(dropped))
        return list(buf[:n]), now.value, dropped.value
