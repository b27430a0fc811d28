"""Loss blocks (counterpart of `incubator_mxnet_tpu/gluon/loss.py`): the
`Loss` base, `L2Loss`, `L1Loss` and `SoftmaxCrossEntropyLoss`.  Each
returns one loss per sample (the mean over every axis but the batch
axis)."""
from __future__ import annotations

from .block import HybridBlock
from ..ndarray import NDArray
from ..ops.nn import sparse_softmax_ce

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(F, pred, label):
    if pred.shape != label.shape:
        return label.reshape(pred.shape)
    return label


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _batch_mean(self, F, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        if not axes:
            return loss
        return F.mean(loss, axis=axes)


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._batch_mean(F, loss)


class L1Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy with sparse or dense labels.  Sparse labels
    over the last axis of logits take `sparse_softmax_ce` (float32
    result, labels outside the classes clamped), the path the JAX
    package's traced training step takes; the other cases compose
    log_softmax with pick or a sum."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if (self._sparse_label and not self._from_logits
                and self._axis in (-1, pred.ndim - 1)):
            loss = NDArray(sparse_softmax_ce(pred._data, label._data))
        elif self._sparse_label:
            if not self._from_logits:
                pred = F.log_softmax(pred, axis=self._axis)
            loss = -F.pick(pred, label, axis=self._axis, keepdims=False)
        else:
            if not self._from_logits:
                pred = F.log_softmax(pred, axis=self._axis)
            label = _reshape_like(F, pred, label)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=False)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
