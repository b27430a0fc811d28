"""Operators: plain functions on torch tensors, registered by name (the
`F` namespace of `hybrid_forward` is generated from the table)."""
from . import (registry, shape, nn, math, attention,  # noqa: F401
               flash_attention, optim, sequence, rnn, contrib)
