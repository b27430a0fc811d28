"""Loss blocks (counterpart of `incubator_mxnet_tpu/gluon/loss.py`): the
`Loss` base and every loss of the JAX package, in its formulas.  Most
return one loss per sample (the mean over every axis but the batch
axis); `CosineEmbeddingLoss`, `TripletLoss` and `CTCLoss` return theirs
without that mean, `PoissonNLLLoss` and `SDMLLoss` one scalar, as in
the JAX package."""
from __future__ import annotations

from .block import HybridBlock
import numpy as _np

from ..ndarray import NDArray, array as nd_array
from ..ops.nn import sparse_softmax_ce

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "CosineEmbeddingLoss", "TripletLoss", "CTCLoss",
           "PoissonNLLLoss", "SDMLLoss"]


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


def _softrelu_of_neg_abs(F, x):
    """log(1 + exp(−|x|)), the stable tail of the logistic losses."""
    return F.Activation(-F.abs(x), act_type="softrelu")


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, pred, label)
        if not self._from_sigmoid:
            # max(x, 0) − x·z + log(1 + exp(−|x|))
            loss = F.relu(pred) - pred * label + _softrelu_of_neg_abs(F, pred)
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label
                     + F.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class LogisticLoss(Loss):
    """Logistic loss of labels in {−1, 1} ("signed") or {0, 1}
    ("binary")."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + _softrelu_of_neg_abs(F, pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class CosineEmbeddingLoss(Loss):
    """1 − cos for label 1, max(0, cos − margin) otherwise, per sample."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        eps = 1e-12
        dot = F.sum(input1 * input2, axis=-1)
        n1 = F.sqrt(F.sum(F.square(input1), axis=-1) + eps)
        n2 = F.sqrt(F.sum(F.square(input2), axis=-1) + eps)
        cos = dot / (n1 * n2)
        label = label.reshape(cos.shape)
        loss = F.where(label == 1.0, 1 - cos, F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)


class TripletLoss(Loss):
    """max(0, margin + |a − p|² − |a − n|²) per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = _reshape_like(F, pred, positive)
        negative = _reshape_like(F, pred, negative)
        diff = F.square(pred - positive) - F.square(pred - negative)
        loss = F.sum(diff, axis=tuple(range(1, pred.ndim)))
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """The `CTCLoss` op with Gluon's conventions: pred (N, T, C) in the
    "NTC" layout (swapped to the op's TNC), labels padded with −1 and
    the blank the last class; label lengths default to the count of
    entries that are not −1."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if label_lengths is None:
            label_lengths = F.sum((label > -0.5).astype("float32"), axis=1)
        loss = F.CTCLoss(pred, label, pred_lengths, label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=True, blank_label="last")
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """exp(pred) − label·pred for a log-rate pred (`from_logits`), else
    pred − label·log(pred + ε), plus Stirling's term for labels above 1
    with `compute_full`; the mean over every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       epsilon=1e-08):
        label = _reshape_like(F, pred, label)
        if self._from_logits:
            loss = F.exp(pred) - label * pred
        else:
            loss = pred - label * F.log(pred + epsilon)
        if self._compute_full:
            stirling = label * F.log(label + epsilon) - label \
                + 0.5 * F.log(2.0 * 3.141592653589793 * (label + epsilon))
            loss = loss + F.where(label > 1.0, stirling, F.zeros_like(label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class SDMLLoss(Loss):
    """Smoothed deep metric learning over two batches whose rows pair
    up: cross entropy of the softmax of −distance against the identity
    smoothed by `smoothing_parameter`, averaged over the (n, n) matrix."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smooth = smoothing_parameter

    def hybrid_forward(self, F, x1, x2):
        n = x1.shape[0]
        d = F.norm(F.expand_dims(x1, axis=1) - F.expand_dims(x2, axis=0),
                   axis=2)
        eye = _np.eye(n, dtype=_np.float32)
        target = eye * (1 - self._smooth) + \
            (1 - eye) * self._smooth / max(n - 1, 1)
        logp = F.log_softmax(-d, axis=-1)
        return -F.mean(F.broadcast_mul(logp, nd_array(target,
                                                      ctx=x1.context)))
