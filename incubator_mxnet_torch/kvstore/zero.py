"""The ZeRO level (counterpart of `incubator_mxnet_tpu/kvstore/zero.py`'s
`mode`, `enabled` and `reduce_scatter`).  `ParallelTrainer` reads it
when no `zero=` is given; the kvstore's server placement comes with the
kvstore slice."""
from __future__ import annotations

from ..base import get_env

__all__ = ["enabled", "mode", "reduce_scatter"]


def mode():
    """The ``MXNET_KV_ZERO`` level: 0 (off), 1 (sharded optimizer
    state), 2 (and the gradients reduce-scattered).  Bare truthy values
    ("true", "yes", "on") parse as level 1."""
    raw = get_env("MXNET_KV_ZERO", "0", str).strip().lower()
    try:
        return max(0, int(raw))
    except ValueError:
        return 1 if raw in ("true", "yes", "on") else 0


def enabled():
    """Whether any ZeRO sharding (``MXNET_KV_ZERO`` >= 1) is on."""
    return mode() >= 1


def reduce_scatter():
    """Whether the ZeRO-2 reduce-scatter exchange is on."""
    return mode() >= 2
