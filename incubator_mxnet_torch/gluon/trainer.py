"""Trainer: applies an optimizer to a set of Parameters on one device.

Counterpart of `incubator_mxnet_tpu/gluon/trainer.py` (`step`,
`allreduce_grads`, `update`, `learning_rate`/`set_learning_rate`,
`save_states`/`load_states`, and the fused update).  `step(batch_size)`
scales the gradients by 1/batch_size and updates every parameter whose
`grad_req` is not "null".

SGD and Adam without a learning-rate schedule take the fused update:
one multi-tensor pass (`torch._foreach_*`, `ops/optim.py`) over every
parameter, which gives the same bits as the per-key `Updater` path the
other cases take (`MXNET_FUSED_TRAINER=0` forces the per-key path).
A row-sparse gradient anywhere (`Embedding(sparse_grad=True)`) sends
the step down the per-key path, where SGD and Adam update only its
rows.  Weights are updated in place.

The kvstore is "device", "local" or None: one device, nothing to
reduce.  The distributed and NCCL kvstores, gradient compression and
update-on-kvstore wait for the multi-GPU slice and raise.

The runtime planes ride `step` as in the JAX package: `introspect`'s
`begin_step`/`end_step` (the flight recorder's step events, with the
ledger's breakdown), a "step" tracing span (autograd's "forward" and
"backward" spans of the caller's loop join its trace, the update is a
"compute" span), the trainer's `goodput.StepLedger` over the window
[previous step end, this step end], with ``MXNET_HEALTH=1`` the
`health` ledger (the gradients' and weights' stats after the update,
one host sync) and the fault plan (``nan_grad`` poisons a gradient at
the step's start, ``bitflip_weight`` flips a weight bit at its end),
and `profiling.step_boundary`.  Live trainers report under the debugz
statusz section "trainer".
"""
from __future__ import annotations

import itertools
import pickle
import time
import weakref

import torch

from .. import goodput as _goodput
from .. import health as _health
from .. import introspect as _introspect
from .. import profiling as _profiling
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..base import MXNetError, get_env
from .. import optimizer as opt
from ..convert import host_tensor
from ..ndarray import NDArray
from ..optimizer.optimizer import _state_to_numpy
from ..ops.optim import sgd_multi, adam_multi
from .parameter import ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")

_tm_step_time = _telemetry.histogram(
    "step_time_seconds", "gluon.Trainer.step wall time (host-side)")
_trainer_seq = itertools.count()        # flight-event / ledger labels
_live_trainers = weakref.WeakSet()


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                "params must be a ParameterDict or list of Parameter")
        if kvstore not in _LOCAL_KVSTORES:
            raise MXNetError(
                f"kvstore {kvstore!r} is not ported yet: this Trainer runs "
                f"on one device (kvstore 'device', 'local' or None)")
        if compression_params is not None or update_on_kvstore:
            raise MXNetError("gradient compression and update_on_kvstore "
                             "need a distributed kvstore, not ported yet")
        self._all_params = list(params)
        self._params = [p for p in params if p.grad_req != "null"]
        self._kvstore_type = kvstore
        self._optimizer = opt.create(optimizer, **(optimizer_params or {}))
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states = [None] * len(self._params)
        self._states_created = [False] * len(self._params)
        self._allow_fused = get_env("MXNET_FUSED_TRAINER", True, bool)
        # the planes (the module docstring); the health ledger is made
        # at the first step with MXNET_HEALTH on
        _introspect.ensure_debugz(role="worker")
        _introspect.maybe_install_postmortem()
        self._introspect_label = f"trainer{next(_trainer_seq)}"
        self._ledger = _goodput.StepLedger(self._introspect_label)
        self._health = None
        self._step_count = 0
        self._last_step_end = None
        _live_trainers.add(self)
        _introspect.register_statusz("trainer", _trainers_statusz)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    # ------------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients (nothing to do on one device) and apply
        one update, the gradients scaled by 1/batch_size; then the step
        boundary of the planes (the module docstring)."""
        n = self._step_count
        self._step_count = n + 1
        _introspect.begin_step(n, trainer=self._introspect_label)
        last = self._last_step_end
        compute = (time.monotonic() - last) if last is not None else None
        win0 = last if last is not None else time.monotonic()
        if _health.enabled():
            self._health_pre_step(n)
        t0 = time.perf_counter()
        try:
            with _tracing.step_span(metric=_tm_step_time):
                self._optimizer.rescale_grad = 1.0 / batch_size
                self.allreduce_grads()
                with _tracing.span("compute"):
                    self._update(ignore_stale_grad)
        finally:
            self._last_step_end = time.monotonic()
        rec = self._ledger.on_step(win0, self._last_step_end,
                                   trace_id=_tracing.last_trace_id())
        _introspect.end_step(n, time.perf_counter() - t0,
                             compute_seconds=compute,
                             trainer=self._introspect_label, ledger=rec)
        # health before the profiling boundary: an anomaly this step
        # arms its autocapture window in time to open at this boundary
        if _health.enabled():
            self._health_post_step(n)
        _profiling.step_boundary(label=self._introspect_label)

    def note_flops(self, flops_per_step):
        """The FLOPs of one iteration of the caller's loop (forward,
        backward and update, e.g. from `goodput.count_flops`): the
        ledger's MFU numerator.  The trainer runs only the update, so it
        cannot count the rest itself."""
        self._ledger.note_flops(flops_per_step)

    # -- numerics & model health ---------------------------------------
    def _health_pre_step(self, n):
        """The ``nan_grad`` fault: one gradient element set to NaN at
        the step's start, so it flows through the real update and
        stats."""
        if "nan_grad" not in _health.fault_actions(n):
            return
        for p in self._params:
            g = p._data.grad
            if g is not None and not g.is_sparse:
                with torch.no_grad():
                    g[(0,) * g.ndim] = float("nan")
                break

    def _health_post_step(self, n):
        """The step's numerics into the health ledger: the gradients'
        stats scaled by 1/batch_size as the update saw them, and the
        weights' (after the ``bitflip_weight`` fault, if planned)."""
        if self._health is None:
            self._health = _health.ledger(self._introspect_label)
        if "bitflip_weight" in _health.fault_actions(n):
            self._bitflip_weight()
        scale = float(self._optimizer.rescale_grad or 1.0)
        gs = _health.tensor_stats(
            [p._data.grad for p in self._params
             if p._data.grad is not None and not p._data.grad.is_sparse])
        ws = _health.tensor_stats([p._data for p in self._params])
        self._health.on_step(step=n, grad_sumsq=gs["sumsq"] * scale * scale,
                             nonfinite=gs["nonfinite"],
                             weight_sumsq=ws["sumsq"])

    def _bitflip_weight(self):
        """Flip the lowest mantissa bit of the first weight element (the
        low byte, little-endian): a silent corruption that is never a
        NaN or an Inf."""
        w = self._params[0]._data
        with torch.no_grad():
            b = w.reshape(-1)[:1].view(torch.uint8)
            b[0] = b[0] ^ 1

    @staticmethod
    def _statusz_of(tr):
        led = tr._ledger.summary()["window"]
        out = {"kvstore": tr._kvstore_type,
               "goodput": {"fraction": led["goodput_fraction"],
                           "mfu": led["mfu"]},
               "params": len(tr._params), "steps": tr._step_count}
        if _health.enabled() and tr._health is not None:
            out["health"] = tr._health.summary()
        return out

    def allreduce_grads(self):
        """One device holds every gradient whole: nothing to reduce."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = 1.0 / batch_size
        self._update(ignore_stale_grad)

    def _ensure_states(self):
        for i, p in enumerate(self._params):
            if not self._states_created[i]:
                self._states[i] = self._optimizer.create_state(i, p.data())
                self._states_created[i] = True

    def _update(self, ignore_stale_grad=False):
        kind = type(self._optimizer).__name__.lower()
        self._ensure_states()
        any_sparse = any(p._data.grad is not None and p._data.grad.is_sparse
                         for p in self._params)
        if (self._allow_fused and not any_sparse and kind in ("sgd", "adam")
                and self._optimizer.lr_scheduler is None):
            self._fused_update(kind)
            return
        for i, p in enumerate(self._params):
            self._optimizer.update_multi_precision(i, p.data(), p.grad(),
                                                   self._states[i])

    def _fused_update(self, kind):
        """All parameters in one multi-tensor pass, with the per-key
        path's learning rate, weight decay and step count per index."""
        o = self._optimizer
        n = len(self._params)
        for i in range(n):
            o._update_count(i)
        weights = [p._data for p in self._params]
        grads = [p.grad()._data for p in self._params]
        lrs = [o._get_lr(i) for i in range(n)]
        common = dict(wds=[o._get_wd(i) for i in range(n)],
                      rescale=o.rescale_grad, clip=o._clip())
        with torch.no_grad():
            if kind == "sgd":
                moms = None if o.momentum == 0.0 else \
                    [s._data for s in self._states]
                new = sgd_multi(weights, grads, moms, lrs=lrs,
                                momentum=o.momentum, **common)
            else:
                lrs = [o.corrected_lr(lr, o._index_update_count[i])
                       for i, lr in enumerate(lrs)]
                new = adam_multi(weights, grads,
                                 [s[0]._data for s in self._states],
                                 [s[1]._data for s in self._states],
                                 lrs=lrs, beta1=o.beta1, beta2=o.beta2,
                                 epsilon=o.epsilon, **common)
            torch._foreach_copy_(weights, new)

    # -- state checkpointing -------------------------------------------
    def save_states(self, fname):
        self._ensure_states()
        o = self._optimizer
        payload = {
            "num_update": o.num_update,
            "index_update_count": dict(o._index_update_count),
            "states": [_state_to_numpy(s) for s in self._states]}
        with open(fname, "wb") as f:
            pickle.dump(payload, f)

    def load_states(self, fname):
        """Read a file of `save_states`, or of the JAX package's Trainer:
        its per-key form (`"states"`) or, from its fused SGD and Adam
        update, `"fused"` (SGD: a list of momenta; Adam: the lists
        (means, variances))."""
        with open(fname, "rb") as f:
            payload = pickle.load(f)
        num_update = payload.get("num_update", 0)
        if "fused" in payload:
            from ..convert import optimizer_states_from_jax
            optimizer_states_from_jax(self, payload["fused"], num_update)
            return
        self.set_states(payload["states"], num_update,
                        payload.get("index_update_count"))

    def set_states(self, states, num_update, index_update_count=None):
        """Install per-parameter optimizer states (numpy: None, an array,
        or a tuple of arrays and None, in parameter order) and the step
        count, each state on its parameter's device, in float32 (DCASGD's
        in the parameter's dtype)."""
        if len(states) != len(self._params):
            raise MXNetError(f"{len(states)} optimizer states for "
                             f"{len(self._params)} parameters")
        o = self._optimizer
        o.num_update = int(num_update)
        o._index_update_count = dict(index_update_count) \
            if index_update_count is not None else \
            {i: int(num_update) for i in range(len(self._params))}
        own_dtype = isinstance(o, opt.DCASGD)

        def put(x, p):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(put(v, p) for v in x)
            return NDArray(host_tensor(x).to(
                device=p._data.device,
                dtype=p._data.dtype if own_dtype else torch.float32))
        out = [put(s, p) for p, s in zip(self._params, states)]
        self._states = out
        self._states_created = [True] * len(out)


def _trainers_statusz():
    """The ``/-/statusz`` "trainer" section over every live trainer: one
    trainer's report, or a list of them."""
    trs = sorted(_live_trainers, key=id)
    if not trs:
        return {"gone": True}
    if len(trs) == 1:
        return Trainer._statusz_of(trs[0])
    return {"count": len(trs),
            "trainers": [Trainer._statusz_of(t) for t in trs]}
