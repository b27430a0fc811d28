"""Estimator: a fit loop with event handlers (counterpart of
`incubator_mxnet_tpu/gluon/contrib/estimator.py`): `Estimator.fit` and
`evaluate`, the event base classes, `LoggingHandler`,
`CheckpointHandler` and `EarlyStoppingHandler`.

A batch is `(data, label, ...)`: a DataLoader batch, a tuple from
`io.DevicePrefetcher`, or a list.  The arrays are used where they lie,
so the loader or prefetcher places them (a DataLoader iterated in the
default context gives batches on the card).  `fit` runs, per batch, the
forward and the loss under `autograd.record()`, `backward()`,
`trainer.step(batch_size)` and the training metric's update.
`EarlyStoppingHandler` and `CheckpointHandler(save_best=True)` read the
training metric at each epoch's end.
"""
from __future__ import annotations

import logging
import os
import time

from ... import autograd
from ... import metric as metric_mod
from ..trainer import Trainer

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "CheckpointHandler",
           "EarlyStoppingHandler", "LoggingHandler"]


class TrainBegin:
    def train_begin(self, estimator):
        pass


class TrainEnd:
    def train_end(self, estimator):
        pass


class EpochBegin:
    def epoch_begin(self, estimator):
        pass


class EpochEnd:
    def epoch_end(self, estimator):
        pass


class BatchBegin:
    def batch_begin(self, estimator):
        pass


class BatchEnd:
    def batch_end(self, estimator):
        pass


class LoggingHandler(TrainBegin, EpochEnd, BatchEnd):
    def __init__(self, log_interval=50):
        self.log_interval = log_interval
        self._batch = 0
        self._tic = None

    def train_begin(self, estimator):
        self._tic = time.time()

    def batch_end(self, estimator):
        self._batch += 1
        if self._batch % self.log_interval == 0:
            vals = estimator.train_metric.get_name_value()
            msg = " ".join(f"{n}={v:.4f}" for n, v in vals)
            logging.info("batch %d: %s", self._batch, msg)

    def epoch_end(self, estimator):
        vals = estimator.train_metric.get_name_value()
        msg = " ".join(f"{n}={v:.4f}" for n, v in vals)
        logging.info("epoch %d done (%.1fs): %s", estimator.current_epoch,
                     time.time() - self._tic, msg)


class CheckpointHandler(EpochEnd):
    def __init__(self, model_dir, model_prefix="model", save_best=False,
                 monitor=None, mode="max"):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.save_best = save_best
        self._best = None
        self._mode = mode

    def epoch_end(self, estimator):
        os.makedirs(self.model_dir, exist_ok=True)
        path = os.path.join(
            self.model_dir,
            f"{self.model_prefix}-epoch{estimator.current_epoch}")
        estimator.net.save_parameters(path + ".params")
        if self.save_best:
            _name, val = estimator.train_metric.get()
            better = (self._best is None
                      or (val > self._best if self._mode == "max"
                          else val < self._best))
            if better:
                self._best = val
                estimator.net.save_parameters(
                    os.path.join(self.model_dir,
                                 f"{self.model_prefix}-best.params"))


class EarlyStoppingHandler(EpochEnd):
    def __init__(self, monitor=None, min_delta=0, patience=0, mode="max"):
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self._best = None
        self._wait = 0

    def epoch_end(self, estimator):
        _name, val = estimator.train_metric.get()
        improved = (self._best is None
                    or (val > self._best + self.min_delta
                        if self.mode == "max"
                        else val < self._best - self.min_delta))
        if improved:
            self._best = val
            self._wait = 0
        else:
            self._wait += 1
            if self._wait > self.patience:
                estimator.stop_training = True


class Estimator:
    """Training harness: `fit` and `evaluate`."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None):
        self.net = net
        self.loss = loss
        self.train_metric = metric_mod.create(train_metrics or "accuracy")
        self.trainer = trainer or Trainer(net.collect_params(), "sgd",
                                          {"learning_rate": 0.01})
        self.context = context
        self.current_epoch = 0
        self.stop_training = False

    def evaluate(self, val_data, val_metric=None):
        m = metric_mod.create(val_metric or "accuracy")
        for batch in val_data:
            data, label = batch[0], batch[1]
            out = self.net(data)
            m.update([label], [out])
        return m.get_name_value()

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batches=None):
        handlers = event_handlers or [LoggingHandler()]

        def fire(kind):
            for h in handlers:
                if hasattr(h, kind):
                    getattr(h, kind)(self)

        fire("train_begin")
        for epoch in range(epochs):
            if self.stop_training:
                break
            self.current_epoch = epoch
            self.train_metric.reset()
            fire("epoch_begin")
            for i, batch in enumerate(train_data):
                if batches is not None and i >= batches:
                    break
                fire("batch_begin")
                data, label = batch[0], batch[1]
                with autograd.record():
                    out = self.net(data)
                    loss = self.loss(out, label)
                loss.backward()
                self.trainer.step(data.shape[0])
                self.train_metric.update([label], [out])
                fire("batch_end")
            fire("epoch_end")
        fire("train_end")
        return self
