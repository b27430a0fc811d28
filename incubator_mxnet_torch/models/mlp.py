"""Simple MLP (counterpart of `incubator_mxnet_tpu/models/mlp.py`): the
network of MXNet's custom-softmax examples, 784 -> 128 -> 64 -> 10."""
from __future__ import annotations

from ..gluon import nn

__all__ = ["MLP"]


class MLP(nn.HybridSequential):
    def __init__(self, hidden=(128, 64), classes=10, activation="relu",
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            for h in hidden:
                self.add(nn.Dense(h, activation=activation))
            self.add(nn.Dense(classes))
