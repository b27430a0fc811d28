"""Operators: plain functions on torch tensors, registered by name (the
`F` namespace of `hybrid_forward` is generated from the table).

The registry's API is re-exported as in the JAX package: `register`,
`get_op`, `list_ops` and `apply_op`.  The JAX package's `invoke` (its
dispatcher into jitted op bodies) has no counterpart here: a registered
op is a plain function, called through `apply_op`."""
from . import (registry, shape, nn, math, reduce, attention,  # noqa: F401
               random_ops, flash_attention, optim, sequence, rnn,
               extended, contrib, linalg, quantized)
from .registry import register, get_op, list_ops, apply_op  # noqa: F401
