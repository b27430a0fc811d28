"""Resource manager: temp workspace + random resources for operators
and pipelines (counterpart of `incubator_mxnet_tpu/resource.py`;
MXNet's `ResourceManager`, kTempSpace and kRandom).

- Device scratch belongs to PyTorch's caching allocator.
- Host scratch is pooled: `request_temp_space` hands out blocks of the
  storage pool (`storage.Storage`, `csrc/storage.cc`), so steady-state
  pipeline staging never hits the system allocator.  `ImageIter`'s
  batch staging goes through it.
- Randomness: `request_prng_key` returns the framework's
  `torch.Generator` for a device (`random.generator`), which
  `mx.random.seed` seeds; the JAX package returns a fresh key.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError

__all__ = ["Resource", "ResourceManager", "request_temp_space",
           "request_prng_key"]


class Resource:
    """One temp-space grant (MXNet's Resource of kTempSpace).  `space(shape, dtype)` returns a numpy view of pooled host
    memory; `release()` returns the block to the pool (also triggered
    by garbage collection).

    LIFETIME CONTRACT (MXNet's temp space is valid only during the
    op): every view returned by `space()` is
    valid ONLY until `release()` (or GC of this Resource).  The pool
    may hand the same block to a later `Storage.alloc`, so reading or
    writing a stale view races with the next owner.  Drop all views
    before releasing; never store them past the op that requested the
    grant."""

    def __init__(self, handle):
        self._handle = handle

    def space(self, shape, dtype=_np.float32):
        dtype = _np.dtype(dtype)
        need = int(_np.prod(shape)) * dtype.itemsize
        if self._handle is None or need > self._handle.size:
            raise MXNetError(
                f"temp space of {need} bytes exceeds the granted "
                f"{0 if self._handle is None else self._handle.size}")
        return self._handle.asbuffer(dtype=dtype,
                                     shape=None)[:need // dtype.itemsize] \
            .reshape(shape)

    def release(self):
        if self._handle is not None:
            self._handle.free()
            self._handle = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class ResourceManager:
    """Process-wide resource manager (MXNet's ResourceManager::Get())."""

    _instance = None

    @classmethod
    def get(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def request_temp_space(self, nbytes):
        """A pooled host scratch block of at least `nbytes`."""
        from .storage import Storage
        return Resource(Storage.get().alloc(int(nbytes)))

    def request_prng_key(self, ctx=None):
        """The framework's seeded `torch.Generator` for `ctx`'s device
        (the kRandom resource; default: the current context)."""
        from . import random as _random
        from .context import as_device
        return _random.generator(as_device(ctx))


def request_temp_space(nbytes):
    return ResourceManager.get().request_temp_space(nbytes)


def request_prng_key(ctx=None):
    return ResourceManager.get().request_prng_key(ctx)
