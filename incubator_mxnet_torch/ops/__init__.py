"""Operators: plain functions on torch tensors, registered by name (the
`F` namespace of `hybrid_forward` is generated from the table)."""
from . import (registry, shape, nn, math, reduce, attention,  # noqa: F401
               random_ops, flash_attention, optim, sequence, rnn,
               extended, contrib, linalg, quantized)
