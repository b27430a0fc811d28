"""`MembershipInfo` (counterpart of `incubator_mxnet_tpu/kvstore/base.py`'s
record): a fleet's elasticity, membership epoch, live count and this
process's rank."""
from __future__ import annotations

import collections

__all__ = ["MembershipInfo"]

MembershipInfo = collections.namedtuple(
    "MembershipInfo", ("elastic", "epoch", "live", "rank"))
