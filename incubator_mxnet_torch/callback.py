"""Training callbacks (counterpart of `incubator_mxnet_tpu/callback.py`):
`Speedometer`, `log_train_metric` and `ProgressBar`.  A callback takes
one argument with `epoch`, `nbatch` and `eval_metric`, as the JAX
package's fit loops pass it.  `do_checkpoint` and `module_checkpoint`
need the Module API and are not ported yet (ROADMAP.md)."""
from __future__ import annotations

import json
import logging
import math
import socket
import sys
import time

from .base import get_env

__all__ = ["Speedometer", "log_train_metric", "ProgressBar"]


class Speedometer:
    """Log samples/sec every `frequent` batches.

    `emit_json=True` also emits one JSON record a log line, ``{"epoch",
    "batch", "samples_per_sec", "metrics", "time", "rank", "role",
    "host"}``, through logging and appended to `json_path` when given.
    ``MXNET_TELEMETRY_JSONL=path`` gives a default path and implies
    `emit_json`.  The port has no multi-process runtime yet, so `rank` is
    0 and `role` "process".
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True,
                 emit_json=False, json_path=None):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.json_path = json_path or get_env("MXNET_TELEMETRY_JSONL")
        self.emit_json = emit_json or bool(self.json_path)
        self.init = False
        self.tic = 0
        self.last_count = 0

    @staticmethod
    def _finite(v):
        v = float(v)
        return v if math.isfinite(v) else None   # strict-JSON safe

    def _emit(self, epoch, batch, speed, name_values):
        record = {"epoch": int(epoch), "batch": int(batch),
                  "samples_per_sec": self._finite(round(float(speed), 3)),
                  "metrics": {n: self._finite(v) for n, v in name_values},
                  "time": time.time(), "rank": 0, "role": "process",
                  "host": socket.gethostname()}
        line = json.dumps(record, sort_keys=True)
        logging.info("%s", line)
        if self.json_path:
            try:
                with open(self.json_path, "a") as f:
                    f.write(line + "\n")
            except OSError as e:
                # a logging side channel must never stop training
                logging.warning(
                    "Speedometer: cannot append to %s (%s); disabling "
                    "JSONL file output", self.json_path, e)
                self.json_path = None

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                # coarse clocks can tick 0 across fast windows
                speed = self.frequent * self.batch_size / \
                    max(time.time() - self.tic, 1e-9)
                nv = []
                if param.eval_metric is not None:
                    nv = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "\t".join(f"{n}={v:.6f}" for n, v in nv)
                    logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec\t%s", param.epoch, count,
                                 speed, msg)
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                if self.emit_json:
                    self._emit(param.epoch, count, speed, nv)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def log_train_metric(period, auto_reset=False):
    """A callback logging the training metric every `period` batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            nv = param.eval_metric.get_name_value()
            msg = "\t".join(f"{n}={v:.6f}" for n, v in nv)
            logging.info("Iter[%d] Batch[%d] Train-%s", param.epoch,
                         param.nbatch, msg)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class ProgressBar:
    """A text progress bar of `nbatch` against `total`, on stdout."""

    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        count = param.nbatch
        filled = int(round(self.length * count / float(self.total)))
        pct = round(100.0 * count / float(self.total), 1)
        bar = "=" * filled + "-" * (self.length - filled)
        sys.stdout.write(f"[{bar}] {pct}%\r")
        sys.stdout.flush()
