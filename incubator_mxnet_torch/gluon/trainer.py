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
"""
from __future__ import annotations

import pickle

import torch

from ..base import MXNetError, get_env
from .. import optimizer as opt
from ..convert import host_tensor
from ..ndarray import NDArray
from ..optimizer.optimizer import _state_to_numpy
from ..ops.optim import sgd_multi, adam_multi
from .parameter import ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


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
        one update, the gradients scaled by 1/batch_size."""
        self._optimizer.rescale_grad = 1.0 / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

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
