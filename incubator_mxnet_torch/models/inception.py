"""Inception v3 (counterpart of `incubator_mxnet_tpu/models/inception.py`).

Parallel branches concatenated on the channels, with factorized (1, 7)
/ (7, 1) and (1, 3) / (3, 1) kernels, each convolution behind
BatchNorm(epsilon=0.001) and ReLU.  A `_Branches` block registers its
branches as children `b0`, `b1`, ... and a `_SplitBranch` its shared
`stem` and its tails `t0`, `t1`, as the JAX blocks do, so the
structural parameter names (`features.16.b1.t0.0.0.weight`) match; the
plain lists they also keep register nothing."""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel_size, strides=1, padding=0):
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel_size=kernel_size, strides=strides,
                      padding=padding, use_bias=False),
            nn.BatchNorm(epsilon=0.001), nn.Activation("relu"))
    return seq


class _Branches(HybridBlock):
    """Every branch on the same input, concatenated on the channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.branches = branches
            for i, b in enumerate(branches):
                setattr(self, f"b{i}", b)

    def hybrid_forward(self, F, x):
        return F.concat(*[b(x) for b in self.branches], dim=1)


def _branch(*convs):
    seq = nn.HybridSequential(prefix="")
    for args in convs:
        if args == "pool_avg":
            seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
        elif args == "pool_max":
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        else:
            seq.add(_conv(*args))
    return seq


def _inception_a(pool_features):
    return _Branches([
        _branch((64, 1)),
        _branch((48, 1), (64, 5, 1, 2)),
        _branch((64, 1), (96, 3, 1, 1), (96, 3, 1, 1)),
        _branch("pool_avg", (pool_features, 1)),
    ])


def _inception_b():
    return _Branches([
        _branch((384, 3, 2)),
        _branch((64, 1), (96, 3, 1, 1), (96, 3, 2)),
        _branch("pool_max"),
    ])


def _inception_c(c7):
    return _Branches([
        _branch((192, 1)),
        _branch((c7, 1), (c7, (1, 7), 1, (0, 3)), (192, (7, 1), 1, (3, 0))),
        _branch((c7, 1), (c7, (7, 1), 1, (3, 0)), (c7, (1, 7), 1, (0, 3)),
                (c7, (7, 1), 1, (3, 0)), (192, (1, 7), 1, (0, 3))),
        _branch("pool_avg", (192, 1)),
    ])


def _inception_d():
    return _Branches([
        _branch((192, 1), (320, 3, 2)),
        _branch((192, 1), (192, (1, 7), 1, (0, 3)),
                (192, (7, 1), 1, (3, 0)), (192, 3, 2)),
        _branch("pool_max"),
    ])


class _SplitBranch(HybridBlock):
    """One `stem` feeding parallel tails, concatenated on the channels
    (the E block's fork into (1, 3) and (3, 1))."""

    def __init__(self, stem, tails, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.stem = stem
            self.tails = tails
            for i, t in enumerate(tails):
                setattr(self, f"t{i}", t)

    def hybrid_forward(self, F, x):
        h = self.stem(x)
        return F.concat(*[t(h) for t in self.tails], dim=1)


def _inception_e():
    def fork():
        return [_branch((384, (1, 3), 1, (0, 1))),
                _branch((384, (3, 1), 1, (1, 0)))]
    return _Branches([
        _branch((320, 1)),
        _SplitBranch(_branch((384, 1)), fork()),
        _SplitBranch(_branch((448, 1), (384, 3, 1, 1)), fork()),
        _branch("pool_avg", (192, 1)),
    ])


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(
                _conv(32, 3, 2), _conv(32, 3), _conv(64, 3, 1, 1),
                nn.MaxPool2D(pool_size=3, strides=2),
                _conv(80, 1), _conv(192, 3),
                nn.MaxPool2D(pool_size=3, strides=2),
                _inception_a(32), _inception_a(64), _inception_a(64),
                _inception_b(),
                _inception_c(128), _inception_c(160), _inception_c(160),
                _inception_c(192),
                _inception_d(),
                _inception_e(), _inception_e(),
                nn.GlobalAvgPool2D(), nn.Dropout(0.5), nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(**kwargs):
    return Inception3(**kwargs)
