"""Optimizers (counterpart of `incubator_mxnet_tpu/optimizer/optimizer.py`):
`register`/`create`, the `Optimizer` base with its learning-rate
schedule and lr/wd multipliers, `SGD`, `Adam` (bias correction folded
into lr), and the per-key `Updater`.

`update(index, weight, grad, state)` keeps the MXNet API.  It runs the
update pass of `ops/optim.py` and writes the new values into the weight
and state tensors in place (the JAX package rebinds immutable arrays);
weights keep their dtype, states are float32.  The other optimizers of
the JAX package (NAG, AdaGrad, RMSProp, AdaDelta, Ftrl, Signum, LAMB,
DCASGD) are not ported yet.
"""
from __future__ import annotations

import math
import pickle

import numpy as _np
import torch

from ..base import MXNetError
from ..ndarray import NDArray, zeros, array
from ..ops.optim import sgd_multi, adam_multi

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register", "ELEMENTWISE_OPTS"]

#: Optimizers whose update is purely elementwise: applying them to a flat
#: view equals applying them per parameter (`Updater.update_flat`).
ELEMENTWISE_OPTS = ("sgd", "adam")

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise MXNetError(f"unknown optimizer {name!r}") from None


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult, self.wd_mult = {}, {}

    # -- schedule / multipliers ------------------------------------------
    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _mult(self, index, table, attr):
        param = self.param_dict.get(index)
        if param is not None:
            return getattr(param, attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _clip(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0

    # -- state / update ----------------------------------------------------
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _f32_zeros(weight):
    return zeros(weight.shape, weight.context, dtype="float32")


def _write(weight, new):
    """Round the float32 result `new` into `weight` in place."""
    with torch.no_grad():
        weight._data.copy_(new)


@register
class SGD(Optimizer):
    """SGD with optional momentum (the JAX package's `sgd_update` /
    `sgd_mom_update`)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _f32_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            (new,) = sgd_multi(
                [weight._data], [grad._data],
                None if state is None else [state._data],
                lrs=self._get_lr(index), momentum=self.momentum,
                wds=self._get_wd(index), rescale=self.rescale_grad,
                clip=self._clip())
        _write(weight, new)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into lr, as MXNet does."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _f32_zeros(weight), _f32_zeros(weight)

    def corrected_lr(self, lr, t):
        """lr with Adam's bias correction for step t folded in."""
        return lr * (math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        with torch.no_grad():
            (new,) = adam_multi(
                [weight._data], [grad._data], [mean._data], [var._data],
                lrs=self.corrected_lr(self._get_lr(index), t),
                beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                wds=self._get_wd(index), rescale=self.rescale_grad,
                clip=self._clip())
        _write(weight, new)


def _state_to_numpy(v):
    if isinstance(v, tuple):
        return tuple(s.asnumpy() for s in v)
    return v.asnumpy() if isinstance(v, NDArray) else v


def _state_from_numpy(v, ctx):
    if isinstance(v, tuple):
        return tuple(array(s, ctx=ctx) for s in v)
    return array(v, ctx=ctx) if isinstance(v, _np.ndarray) else v


class Updater:
    """Applies an optimizer keyed by integer index, keeping one state
    slot per key."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight, state_key=None):
        """`index` is the parameter's identity (lr_mult/wd_mult lookups);
        `state_key` (default: index) keys the state slot."""
        skey = index if state_key is None else state_key
        if skey not in self.states:
            self.states[skey] = self.optimizer.create_state(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[skey])

    def update_flat(self, index, grad, weight, state_key=None):
        """Apply the optimizer to one flat shard (a 1-d weight and grad)
        in one pass, with the state slots of the per-key path.  Returns
        False for an optimizer whose update is not elementwise."""
        if type(self.optimizer).__name__.lower() not in ELEMENTWISE_OPTS:
            return False
        self(index, NDArray(grad._data.reshape(-1)),
             NDArray(weight._data.reshape(-1)), state_key)
        return True

    def get_states(self, dump_optimizer=False):
        return pickle.dumps({k: _state_to_numpy(v)
                             for k, v in self.states.items()})

    def set_states(self, states, ctx=None):
        """Load `get_states` output onto `ctx` (default: the current
        context)."""
        self.states = {k: _state_from_numpy(v, ctx)
                       for k, v in pickle.loads(states).items()}


def get_updater(optimizer):
    return Updater(optimizer)
