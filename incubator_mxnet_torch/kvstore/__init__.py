"""The key-value store (counterpart of `incubator_mxnet_tpu/kvstore/`):
so far the ZeRO level (`zero.mode`) that `ParallelTrainer` reads and the
`MembershipInfo` record; the stores themselves come with the kvstore
slice (ROADMAP.md)."""
from .base import MembershipInfo
from . import zero

__all__ = ["MembershipInfo", "zero"]
