"""The threaded image-record pipeline (counterpart of
`incubator_mxnet_tpu/io/native_image.py`): the ctypes seam over
`csrc/image_pipeline.cc`, whose decode and augment run in C++ threads
that never hold the GIL and never touch CUDA.

The batch slots are tensors allocated here and handed to the pipeline at
creation; on a machine with CUDA they are page-locked, so the workers
write each batch straight into memory the card copies from, with no host
copy between decode and the transfer.  A slot stays the consumer's from
the `next_*` call that returns it until the following `next_*` or
`reset()`; `staging_ring` feeds the slot views to `DevicePrefetcher` in
its `sync` mode, whose transfer thread waits on the copy's event before
it pulls again, so no slot goes back to the workers while a copy may
still read it.
"""
from __future__ import annotations

import ctypes
import logging

import torch

from .. import _native
from ..base import MXNetError, get_env
from .io import DataBatch, DataDesc, DataIter

__all__ = ["NativeImagePipeline", "NativeImageRecordIter",
           "native_pipeline_available", "decode_workers"]


def decode_workers(requested=None, default=4):
    """Size of the decode pool: `requested`, else
    ``MXNET_IO_DECODE_WORKERS``, else `default`."""
    if requested:
        return max(1, int(requested))
    env = get_env("MXNET_IO_DECODE_WORKERS", None, int)
    if env:
        return max(1, int(env))
    return int(default)


def _fn(name, argtypes, restype=None):
    return _native.entry(name, argtypes, restype)


def _create():
    return _fn("imgpipe_create", [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)],
        ctypes.c_void_p)


def native_pipeline_available():
    """True once the host library is built and loaded (a failed build
    raises: the port has no other decoder to fall back to)."""
    _native.library()
    return True


class NativeImagePipeline:
    """Raw handle to the C++ pipeline.  `next_arrays()` gives numpy views
    of the current slot and `next_tensors()` tensor views; either is
    valid until the next `next_*()` or `reset()`, so a caller that keeps
    a batch copies it."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 preprocess_threads=None, prefetch=3, shuffle=False, seed=0,
                 part_index=0, num_parts=1, resize=0, rand_crop=False,
                 rand_mirror=False, mean=None, std=None, out_uint8=False,
                 label_width=1):
        create = _create()
        preprocess_threads = decode_workers(preprocess_threads)
        c, h, w = (int(v) for v in data_shape)
        n = int(batch_size)
        self.batch_size = n
        self.data_shape = (c, h, w)
        self.label_width = max(1, int(label_width))
        self.out_uint8 = bool(out_uint8)
        nslots = max(2, int(prefetch))
        pin = torch.cuda.is_available()
        shape, dtype = ((n, h, w, c), torch.uint8) if self.out_uint8 else \
            ((n, c, h, w), torch.float32)
        self._data = [torch.empty(shape, dtype=dtype, pin_memory=pin)
                      for _ in range(nslots)]
        self._label = [torch.empty((n, self.label_width),
                                   dtype=torch.float32, pin_memory=pin)
                       for _ in range(nslots)]
        data_p = (ctypes.c_void_p * nslots)(*[t.data_ptr()
                                              for t in self._data])
        label_p = (ctypes.c_void_p * nslots)(*[t.data_ptr()
                                               for t in self._label])

        def floats3(v):
            return None if v is None else \
                (ctypes.c_float * 3)(*[float(x) for x in v])
        mean_a, std_a = floats3(mean), floats3(std)
        self._h = create(
            str(path_imgrec).encode(), n, c, h, w, int(preprocess_threads),
            nslots, int(bool(shuffle)), int(seed), int(part_index),
            int(num_parts), int(resize), int(bool(rand_crop)),
            int(bool(rand_mirror)),
            ctypes.cast(mean_a, ctypes.POINTER(ctypes.c_float))
            if mean_a is not None else None,
            ctypes.cast(std_a, ctypes.POINTER(ctypes.c_float))
            if std_a is not None else None,
            int(self.out_uint8), self.label_width, data_p, label_p)
        if not self._h:
            raise MXNetError(f"cannot open record file {path_imgrec!r} "
                             f"(or data_shape {tuple(data_shape)} is not "
                             f"3-channel)")

    @property
    def num_batches(self):
        return _fn("imgpipe_num_batches", [ctypes.c_void_p],
                   ctypes.c_int64)(self._h)

    @property
    def decode_failures(self):
        return _fn("imgpipe_decode_failures", [ctypes.c_void_p],
                   ctypes.c_int64)(self._h)

    def _next_slot(self):
        if not self._h:
            raise MXNetError("the pipeline is closed")
        slot = ctypes.c_int()
        # the foreign call drops the GIL while it waits for the workers
        ok = _fn("imgpipe_next", [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int)],
                 ctypes.c_int)(self._h, ctypes.byref(slot))
        return slot.value if ok else None

    def next_tensors(self):
        """(data, label) tensor views of the next batch (page-locked on a
        CUDA machine), or None at the end of the epoch.  data is NCHW
        float32, or NHWC uint8 with `out_uint8`; label is (N, width)."""
        k = self._next_slot()
        return None if k is None else (self._data[k], self._label[k])

    def next_arrays(self):
        """As `next_tensors`, as numpy views."""
        out = self.next_tensors()
        return None if out is None else (out[0].numpy(), out[1].numpy())

    def reset(self):
        _fn("imgpipe_reset", [ctypes.c_void_p])(self._h)

    def close(self):
        if getattr(self, "_h", None):
            _fn("imgpipe_destroy", [ctypes.c_void_p])(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeImageRecordIter(DataIter):
    """DataIter over the native pipeline (the engine `ImageRecordIter`
    takes by default).  `next()` copies each batch into NDArrays in the
    current context."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        self._data_name = data_name
        self._label_name = label_name
        self._pipe = NativeImagePipeline(path_imgrec, data_shape,
                                         batch_size, **kwargs)
        self.data_shape = self._pipe.data_shape
        self.label_width = self._pipe.label_width
        self._warned_failures = 0

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        self._pipe.reset()

    def next(self):
        from ..ndarray import array
        out = self._pipe.next_arrays()
        if out is None:
            failures = self._pipe.decode_failures
            if failures > self._warned_failures:
                logging.getLogger(__name__).warning(
                    "%d corrupt or undecodable records were zero-filled "
                    "this epoch", failures - self._warned_failures)
                self._warned_failures = failures
            raise StopIteration
        data, label = out
        if self.label_width == 1:
            label = label[:, 0]
        return DataBatch([array(data)], [array(label)],
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def raw_batches(self, loop=False):
        """Zero-copy generator of ``(data, label)`` tensor views into the
        pipeline's slots.  A view is valid only until the next pull, so
        the consumer must have finished reading it by then: use
        `staging_ring`, or `DevicePrefetcher(..., threads=1, sync=True)`.
        ``loop=True`` resets at the end of each epoch."""
        while True:
            out = self._pipe.next_tensors()
            if out is None:
                if not loop:
                    return
                self._pipe.reset()
                continue
            data, label = out
            if self.label_width == 1:
                label = label[:, 0]
            yield data, label

    def staging_ring(self, trainer=None, ctx=None, depth=None, loop=False):
        """The record-to-card path: decode pool -> page-locked slot views
        -> `DevicePrefetcher` (``MXNET_IO_STAGING_DEPTH`` deep) ->
        NDArrays on the card, which a `ParallelTrainer` takes without a
        second copy.  Close the ring before this iterator."""
        from .io import DevicePrefetcher
        return DevicePrefetcher(self.raw_batches(loop=loop), ctx=ctx,
                                trainer=trainer, depth=depth, threads=1,
                                sync=True)

    def close(self):
        self._pipe.close()
