"""Monitor: per-tensor statistics for debugging training (counterpart
of `incubator_mxnet_tpu/monitor.py`).  Installed on a Module or an
Executor, it collects a statistic of every matched argument and output
every `interval` batches (`tic`/`toc`); the default statistic is
mean(|x|) in float32, as the JAX package's `health.monitor_stats`
computes it.
"""
from __future__ import annotations

import logging
import re

from .ndarray import NDArray

__all__ = ["Monitor"]


def _abs_mean(arr):
    """mean(|x|) in float32, as a Python float."""
    import torch
    return float(arr._data.detach().to(torch.float32).abs().mean())


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        # stat_func=None selects the default mean(|x|); a custom one
        # is called with each matched NDArray
        self.stat_func = stat_func
        self.interval = interval
        self.pattern = re.compile(pattern)
        self.sort = sort
        self.queue = []
        self.step = 0
        self.activated = False
        self._modules = []

    def install(self, module_or_exec):
        """Attach to a Module (or bare Executor)."""
        self._modules.append(module_or_exec)

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def _matched(self):
        for m in self._modules:
            execs = getattr(m, "_execs", None) or [m]
            for ex in execs:
                d = dict(getattr(ex, "arg_dict", {}))
                d.update({f"output{i}": o
                          for i, o in enumerate(getattr(ex, "outputs", []))})
                for name, arr in d.items():
                    if isinstance(arr, NDArray) and self.pattern.match(name):
                        yield name, arr

    def _collect(self):
        pairs = list(self._matched())
        if not pairs:
            return
        if self.stat_func is None:
            for name, arr in pairs:
                self.queue.append((self.step, name, _abs_mean(arr)))
        else:
            for name, arr in pairs:
                self.queue.append((self.step, name, self.stat_func(arr)))

    def toc(self):
        if not self.activated:
            return []
        self._collect()
        self.activated = False
        res = []
        for step, name, stat in self.queue:
            val = stat.asnumpy() if isinstance(stat, NDArray) else stat
            res.append((step, name, val))
        if self.sort:
            res.sort(key=lambda r: r[1])
        self.queue = []
        return res

    def toc_print(self):
        for step, name, val in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, str(val))
