"""Carry weights and optimizer states from the JAX package into the port.

`params_from_jax(block, arrays)` takes {structural name: numpy array},
the mapping `net._collect_params_with_prefix()` gives in the JAX package
(the key set of its `save_parameters`), and loads it into the port
block built the same way.  The Dense weight is (units, in_units) on
both sides, so nothing is transposed.  A missing, extra or mis-shaped
name raises.

`optimizer_states_from_jax(trainer, states, num_update)` installs a JAX
trainer's optimizer states and step count into the port's trainer of
the same kind, so that the port's next step is the JAX package's next
step.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["params_from_jax", "optimizer_states_from_jax", "host_tensor"]


def host_tensor(arr):
    """A CPU tensor of a host array (an `ml_dtypes` bfloat16 one too)."""
    arr = _np.array(arr)                    # a writable host copy
    if arr.dtype.name == "bfloat16":        # ml_dtypes: carry the bits
        return torch.from_numpy(arr.view(_np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(block, arrays, ctx=None):
    """Load {structural name: array} into `block`; uninitialized (deferred)
    parameters are created on their pending init's device, else `ctx`."""
    params = block._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"params_from_jax: missing {missing}, extra {extra}")
    for name, p in params.items():
        shape = tuple(_np.shape(arrays[name]))
        if p.shape is not None and (len(p.shape) != len(shape) or any(
                s != 0 and s != n for s, n in zip(p.shape, shape))):
            raise MXNetError(f"params_from_jax: {name} has shape {shape}, "
                             f"the block expects {p.shape}")
    # a parameter a mesh trainer placed keeps its block of the global
    # (JAX) layout, the head-aligned one of a fused qkv included
    placed = {n for n, p in params.items() if p._shard is not None}
    with torch.no_grad():
        for n in placed:
            p = params[n]
            p._data.copy_(p._shard.local_block(host_tensor(arrays[n]))
                          .to(p._data.device, p._data.dtype))
    rest = {k: host_tensor(v) for k, v in arrays.items() if k not in placed}
    if rest:
        block.load_dict(rest, ctx=ctx, source="params_from_jax",
                        **({"allow_missing": True} if placed else {}))


def _numpy_tree(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy_tree(v) for v in x)
    return _np.asarray(x, dtype=_np.float32)


def optimizer_states_from_jax(trainer, states, num_update):
    """Install JAX optimizer states (numpy or anything `numpy.asarray`
    takes) and the step count `num_update` into a port trainer.

    - `parallel.ParallelTrainer`: the JAX ParallelTrainer's `_states`, one
      entry per trained parameter in `collect_params` order (an array for
      SGD, (mean, var) for Adam), and its `num_update`.
    - `gluon.Trainer`: the JAX Trainer's per-key `_states` (a list of
      None, an array or a tuple per parameter, for any of the ten
      optimizers: DCASGD's is (momentum or None, previous weight)), or
      its fused state (SGD: a list of arrays; Adam: the tuple (means,
      variances) of two lists), and its optimizer's `num_update`.
    """
    from .gluon.trainer import Trainer
    from .parallel.trainer import ParallelTrainer
    states = _numpy_tree(states)
    if isinstance(trainer, ParallelTrainer):
        trainer.set_states(list(states), num_update)
    elif isinstance(trainer, Trainer):
        if isinstance(states, tuple) and len(states) == 2 and all(
                isinstance(s, list) for s in states):
            states = list(zip(*states))          # fused Adam (m, v) lists
        if type(trainer.optimizer).__name__ == "SGD" and \
                trainer.optimizer.momentum == 0.0:
            states = [None] * len(states)        # fused SGD keeps zeros
        trainer.set_states(list(states), num_update)
    else:
        raise MXNetError(f"optimizer_states_from_jax: not a port trainer: "
                         f"{type(trainer).__name__}")
