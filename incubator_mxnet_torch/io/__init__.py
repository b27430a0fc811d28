"""Data IO: the DataIter protocol and the iterators (counterpart of
`incubator_mxnet_tpu/io/`): `NDArrayIter`, `ResizeIter`,
`PrefetchingIter`, `CSVIter`, `LibSVMIter` (CSR batches) and
`DevicePrefetcher`, the host-to-card staging ring.  `ImageRecordIter`
and the sharded iterators are not ported yet (ROADMAP.md)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, CSVIter, LibSVMIter, DevicePrefetcher)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "DevicePrefetcher", "LibSVMIter"]
