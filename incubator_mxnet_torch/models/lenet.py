"""LeNet-5 for MNIST (counterpart of `incubator_mxnet_tpu/models/lenet.py`,
the model of `bench.py`'s `bench_lenet`)."""
from __future__ import annotations

from ..gluon import nn

__all__ = ["LeNet"]


class LeNet(nn.HybridSequential):
    def __init__(self, classes=10, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.add(
                nn.Conv2D(20, kernel_size=5, activation="tanh"),
                nn.MaxPool2D(pool_size=2, strides=2),
                nn.Conv2D(50, kernel_size=5, activation="tanh"),
                nn.MaxPool2D(pool_size=2, strides=2),
                nn.Flatten(),
                nn.Dense(500, activation="tanh"),
                nn.Dense(classes),
            )
