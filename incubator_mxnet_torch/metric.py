"""Evaluation metrics (counterpart of `incubator_mxnet_tpu/metric.py`).

`update(labels, preds)` reads its arrays back to the host (`asnumpy`),
so it waits for the card; the metrics are computed in numpy, as in the
JAX package.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import NDArray
from .ndarray.ndarray import to_numpy

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE",
           "RMSE", "CrossEntropy", "Perplexity", "PearsonCorrelation",
           "Loss", "CompositeEvalMetric", "MCC", "create", "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    name = str(metric).lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy",
               "top_k_accuracy": "topkaccuracy", "top_k_acc": "topkaccuracy"}
    name = aliases.get(name, name)
    if name not in _REGISTRY:
        raise MXNetError(f"unknown metric {metric!r}")
    return _REGISTRY[name](*args, **kwargs)


def _as_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return _np.asarray(x)


def _listify(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            pred = _as_numpy(pred)
            label = _as_numpy(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").flat
            label = label.astype("int32").flat
            self.sum_metric += (_np.asarray(pred) == _np.asarray(label)).sum()
            self.num_inst += len(_np.asarray(label))


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.top_k = top_k
        self.name += f"_{top_k}"

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype("int32")
            topk = _np.argsort(-pred, axis=-1)[..., :self.top_k]
            self.sum_metric += (topk == label[..., None]).any(axis=-1).sum()
            self.num_inst += label.size


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype("int32").ravel()
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1)
            else:
                pred = (pred.ravel() > 0.5).astype("int32")
            pred = pred.astype("int32").ravel()
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += 1

    def get(self):
        prec = self._tp / max(self._tp + self._fp, 1)
        rec = self._tp / max(self._tp + self._fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_numpy(label), _as_numpy(pred)
            self.sum_metric += _np.abs(label.reshape(pred.shape) - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_numpy(label), _as_numpy(pred)
            self.sum_metric += ((label.reshape(pred.shape) - pred) ** 2).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(_np.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label).astype("int32").ravel()
            pred = _as_numpy(pred)
            prob = pred[_np.arange(label.size), label]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.size


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label).astype("int32").ravel()
            pred = _as_numpy(pred).reshape(-1, _as_numpy(pred).shape[-1])
            prob = pred[_np.arange(label.size), label]
            if self.ignore_label is not None:
                keep = label != self.ignore_label
                prob = prob[keep]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += prob.size

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(_np.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            self._labels.append(_as_numpy(label).ravel())
            self._preds.append(_as_numpy(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        l = _np.concatenate(self._labels)
        p = _np.concatenate(self._preds)
        return self.name, float(_np.corrcoef(l, p)[0, 1])


@register
class Loss(EvalMetric):
    """The mean of raw loss outputs."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _labels, preds):
        for pred in _listify(preds):
            pred = _as_numpy(pred)
            self.sum_metric += pred.sum()
            self.num_inst += pred.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(name, **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            val = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(val, tuple):
                s, n = val
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += val
                self.num_inst += 1


def np(feval, name="custom"):
    return CustomMetric(feval, name=name)


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, vals = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            vals.append(v)
        return names, vals


class MCC(EvalMetric):
    """Matthews correlation coefficient of a binary classification."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self.reset()

    def reset(self):
        super().reset()
        self._tp = self._tn = self._fp = self._fn = 0

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label).ravel().astype(_np.int64)
            pred = _as_numpy(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1).ravel()
            else:
                pred = (pred.ravel() > 0.5)
            pred = pred.astype(_np.int64)
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._tn += int(((pred == 0) & (label == 0)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += label.size

    def get(self):
        tp, tn, fp, fn = self._tp, self._tn, self._fp, self._fn
        denom = ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) ** 0.5
        val = 0.0 if denom == 0 else (tp * tn - fp * fn) / denom
        return self.name, float(val)
