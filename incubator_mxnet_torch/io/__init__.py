"""Data IO: the DataIter protocol and the iterators (counterpart of
`incubator_mxnet_tpu/io/`): `NDArrayIter`, `ResizeIter`,
`PrefetchingIter`, `CSVIter`, `LibSVMIter` (CSR batches),
`DevicePrefetcher`, the host-to-card staging ring, and
`ImageRecordIter` over the threaded image-record pipeline
(`native_image`), and the sharded iterator of a mesh (`sharded`)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, CSVIter, LibSVMIter, DevicePrefetcher)
from .sharded import (ShardedDataIter, shard_bounds, data_shard_info,
                      assemble_global, assemble_from_shards, LocalBatch)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "DevicePrefetcher", "LibSVMIter",
           "ImageRecordIter", "ShardedDataIter", "shard_bounds",
           "data_shard_info", "assemble_global", "assemble_from_shards",
           "LocalBatch"]


def ImageRecordIter(path_imgrec=None, path_imgidx=None, data_shape=None,
                    batch_size=1, shuffle=False, rand_crop=False,
                    rand_mirror=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                    std_r=1.0, std_g=1.0, std_b=1.0, resize=0,
                    preprocess_threads=None, prefetch_buffer=2,
                    label_width=1, part_index=0, num_parts=1, seed=0,
                    **kwargs):
    """RecordIO image iterator with flat keyword arguments.

    The engine is the threaded record pipeline (`NativeImageRecordIter`,
    its pool sized by `preprocess_threads` or ``MXNET_IO_DECODE_WORKERS``)
    unless ``MXNET_NATIVE_IMAGE_PIPELINE=0`` or an option only `ImageIter`
    supports is given (color jitter, `rand_resize`, `aug_list`, an image
    list, a non-3-channel shape); then it is `ImageIter` behind a
    `PrefetchingIter` of depth `prefetch_buffer`.  The pipeline's host
    library is built at first use, and a failed build raises.  For the
    record-to-card path, call the native iterator's
    ``staging_ring(trainer=...)``."""
    import os as _os
    import numpy as _np
    from ..image import ImageIter
    from .io import PrefetchingIter
    from .native_image import NativeImageRecordIter, decode_workers
    preprocess_threads = decode_workers(preprocess_threads)
    mean = None
    if mean_r or mean_g or mean_b:
        mean = _np.array([mean_r, mean_g, mean_b], _np.float32)
    std = None
    if (std_r, std_g, std_b) != (1.0, 1.0, 1.0):
        std = _np.array([std_r, std_g, std_b], _np.float32)

    native = (
        path_imgrec is not None
        and _os.environ.get("MXNET_NATIVE_IMAGE_PIPELINE", "1") != "0"
        and data_shape is not None and data_shape[0] == 3
        and kwargs.get("aug_list") is None
        and not any(kwargs.get(k) for k in ("brightness", "contrast",
                                            "saturation", "rand_resize",
                                            "path_imglist", "path_root",
                                            "imglist")))
    if native:
        return NativeImageRecordIter(
            path_imgrec=path_imgrec, data_shape=tuple(data_shape),
            batch_size=batch_size, shuffle=shuffle, rand_crop=rand_crop,
            rand_mirror=rand_mirror, mean=mean, std=std, resize=resize,
            label_width=label_width, preprocess_threads=preprocess_threads,
            prefetch=max(2, int(prefetch_buffer) + 1),
            part_index=part_index, num_parts=num_parts, seed=seed,
            data_name=kwargs.get("data_name", "data"),
            label_name=kwargs.get("label_name", "softmax_label"))
    inner = ImageIter(batch_size=batch_size, data_shape=tuple(data_shape),
                      path_imgrec=path_imgrec, path_imgidx=path_imgidx,
                      shuffle=shuffle, rand_crop=rand_crop,
                      rand_mirror=rand_mirror, mean=mean, std=std,
                      resize=resize, label_width=label_width,
                      preprocess_threads=preprocess_threads,
                      part_index=part_index, num_parts=num_parts, seed=seed,
                      **kwargs)
    if prefetch_buffer and prefetch_buffer > 0:
        return PrefetchingIter(inner, prefetch_depth=int(prefetch_buffer))
    return inner
