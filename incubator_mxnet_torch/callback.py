"""Training callbacks (counterpart of `incubator_mxnet_tpu/callback.py`):
`Speedometer`, `log_train_metric` and `ProgressBar`, whose one argument
has `epoch`, `nbatch` and `eval_metric`, as the JAX package's fit loops
pass it; and the epoch-end `do_checkpoint`/`module_checkpoint`, which
take (epoch, symbol, arg_params, aux_params)."""
from __future__ import annotations

import json
import logging
import math
import sys
import time

from .base import get_env
from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = ["Speedometer", "log_train_metric", "ProgressBar",
           "do_checkpoint", "module_checkpoint"]


_tm_speed = _telemetry.gauge(
    "speedometer_samples_per_sec", "Last Speedometer throughput reading")
_tm_samples = _telemetry.counter(
    "speedometer_samples", "Samples processed through Speedometer windows")


class Speedometer:
    """Log samples/sec every `frequent` batches.

    `emit_json=True` also emits one JSON record a log line, ``{"epoch",
    "batch", "samples_per_sec", "metrics", "time", "rank", "role",
    "host"}``, through logging and appended to `json_path` when given.
    ``MXNET_TELEMETRY_JSONL=path`` gives a default path and implies
    `emit_json`.  `rank`, `role` and `host` are the process identity
    (`introspect.process_identity`).  The record also carries, when
    there, the newest step's ``trace_id`` (tracing on), the goodput
    ledger's ``goodput``, ``mfu``, ``hbm_peak_bytes`` and dominant
    ``loss_bucket``, and the health ledger's ``grad_norm``,
    ``nonfinite`` and ``audit_ok``.  Each reading sets the gauge
    ``speedometer_samples_per_sec`` and adds to ``speedometer_samples``.
    `tools/parse_log.py` reads the records.
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
        from . import goodput as _goodput
        from . import health as _hl
        from . import introspect as _introspect
        ident = _introspect.process_identity()
        record = {"epoch": int(epoch), "batch": int(batch),
                  "samples_per_sec": self._finite(round(float(speed), 3)),
                  "metrics": {n: self._finite(v) for n, v in name_values},
                  "time": time.time(), "rank": ident["rank"],
                  "role": ident["role"], "host": ident["host"]}
        tid = _tracing.last_trace_id()
        if tid:
            # join key against the span timeline: the newest completed
            # step's trace id
            record["trace_id"] = _tracing.format_id(tid)
        led = _goodput.last_record()
        if led is not None:
            for field in ("goodput", "mfu"):
                if led.get(field) is not None:
                    record[field] = round(led[field], 4)
            if led.get("hbm_peak_bytes"):
                record["hbm_peak_bytes"] = int(led["hbm_peak_bytes"])
            buckets = led.get("buckets")
            if buckets and not led.get("untraced"):
                loss = {b: s for b, s in buckets.items() if b != "compute"}
                if loss:
                    record["loss_bucket"] = max(loss, key=loss.get)
        hrec = _hl.last_record()
        if hrec is not None:
            if hrec.get("grad_norm") is not None:
                record["grad_norm"] = self._finite(hrec["grad_norm"])
            if hrec.get("nonfinite") is not None:
                record["nonfinite"] = int(hrec["nonfinite"])
            if hrec.get("audit_ok") is not None:
                record["audit_ok"] = bool(hrec["audit_ok"])
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
                _tm_speed.set(speed)
                _tm_samples.inc(self.frequent * self.batch_size)
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


def do_checkpoint(prefix, period=1):
    """Epoch-end callback that writes prefix-symbol.json and
    prefix-NNNN.params every `period` epochs (`Module.fit`'s
    `epoch_end_callback`)."""
    from .module.module import save_checkpoint

    def _callback(epoch, sym, arg_params, aux_params):
        if (epoch + 1) % period == 0:
            save_checkpoint(prefix, epoch + 1, sym, arg_params, aux_params)
            logging.info("Saved checkpoint to \"%s-%04d.params\"",
                         prefix, epoch + 1)
    return _callback


module_checkpoint = do_checkpoint


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
