"""The key-value store (counterpart of `incubator_mxnet_tpu/kvstore/`).

`create` takes every name the JAX package takes.  "local", "device",
"nccl", "tpu" and the "local_allreduce_*" names are the in-process
`KVStoreLocal`; "horovod" is one too when no horovod is installed;
"dist_sync", "dist_async", "dist_sync_device" and "dist" are the
parameter server over TCP (`KVStoreDist`, a fixed fleet), with the
optimizer on the servers when a trainer ships it there.
"""
from .base import KVStore, KVStoreLocal, MembershipInfo
from .dist import KVStoreDist
from .bucket import Bucket, GradientBucketer, build_plan, \
    bucket_target_bytes
from . import zero

__all__ = ["create", "KVStore", "KVStoreLocal", "KVStoreDist",
           "Bucket", "GradientBucketer", "build_plan",
           "bucket_target_bytes", "MembershipInfo", "zero"]


def create(name="local"):
    """Create a KVStore by name."""
    name = name.lower()
    if name in ("local", "device", "nccl", "tpu",
                "local_allreduce_cpu", "local_allreduce_device"):
        return KVStoreLocal(name)
    if name == "horovod":
        try:
            import horovod.mxnet  # noqa: F401 — external package
        except ImportError:
            return KVStoreLocal("tpu")
        raise ValueError("horovod detected: drive training via "
                         "horovod.mxnet's DistributedOptimizer (DLPack "
                         "interop), not mx.kv.create")
    if name in ("dist_sync", "dist_async", "dist_sync_device", "dist"):
        return KVStoreDist(name)
    raise ValueError(f"unknown kvstore type {name!r}")
