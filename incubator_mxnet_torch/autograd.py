"""autograd: MXNet's recording scopes and backward on torch autograd.

Counterpart of `incubator_mxnet_tpu/autograd.py` (`record`, `pause`,
`train_mode`, `predict_mode`, `is_recording`, `is_training`,
`set_recording`, `set_training`, `backward`, `grad`).  Two flags, kept
per thread as in MXNet:

- recording: NDArray ops and blocks called on NDArrays keep a graph only
  inside `record()` (`grad_scope()` turns torch's grad mode on or off to
  match).  Outside it no graph is kept, even for arrays that carry a
  gradient buffer.  Blocks called on torch tensors follow torch's own
  grad mode.
- training: read by Dropout and by attention dropout; `record()` turns
  it on unless asked otherwise, `pause()` turns it off.

`backward` honours each leaf's `grad_req`: "write" overwrites the
gradient of every leaf the sweep reaches (the buffer is zeroed before
the sweep, then torch accumulates into it), "add" accumulates across
backward calls.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "grad_scope"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(flag):
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag):
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


def grad_scope():
    """torch's grad mode set to whether autograd records (a context
    manager): NDArray ops run under it."""
    return torch.set_grad_enabled(_STATE.recording)


class _Scope:
    def __init__(self, recording, training):
        self._recording = recording
        self._training = training

    def __enter__(self):
        self._prev_r = (_STATE.recording if self._recording is None
                        else set_recording(self._recording))
        self._prev_t = (_STATE.training if self._training is None
                        else set_training(self._training))
        return self

    def __exit__(self, *exc):
        set_recording(self._prev_r)
        set_training(self._prev_t)
        return False


def record(train_mode=True):
    """Scope in which executed ops are recorded for differentiation."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def _tensors(arrays):
    from .ndarray import NDArray
    if isinstance(arrays, (NDArray, torch.Tensor)):
        arrays = [arrays]
    return [a._data if isinstance(a, NDArray) else a for a in arrays]


def _reachable_leaves(roots):
    """Leaf tensors whose gradient a sweep from `roots` accumulates."""
    leaves, seen = [], set()
    stack = [r.grad_fn for r in roots if r.grad_fn is not None]
    stack += [r for r in roots if r.grad_fn is None and r.requires_grad]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            continue
        if node in seen:
            continue
        seen.add(node)
        var = getattr(node, "variable", None)     # AccumulateGrad
        if var is not None:
            leaves.append(var)
            continue
        stack.extend(fn for fn, _ in node.next_functions if fn is not None)
    return leaves


def _head_grads(heads, head_grads):
    if head_grads is None:
        return [None] * len(heads)
    grads = _tensors(head_grads)
    if len(grads) != len(heads):
        raise MXNetError("heads and head_grads length mismatch")
    return grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Reverse sweep from `heads` (NDArrays recorded under `record()`);
    gradients land in the leaves' `.grad` per their `grad_req`.  A head
    that no gradient-taking input reaches writes nothing."""
    from .ndarray import NDArray
    if isinstance(heads, (NDArray, torch.Tensor)):
        heads = [heads]
    pairs = []
    for h, g in zip(heads, _head_grads(heads, head_grads)):
        t = h._data if isinstance(h, NDArray) else h
        if t.requires_grad:
            pairs.append((t, torch.ones_like(t) if g is None
                          else g.to(t.dtype)))
        elif not (getattr(h, "_recorded", False) or t.grad is not None):
            raise MXNetError(
                "cannot differentiate a head that was not produced by a "
                "recorded op and has no grad attached")
    # A head recorded from inputs that take no gradient (or a "null"
    # leaf) has nothing to write: the JAX sweep passes over it.
    if not pairs:
        return
    heads, grads = map(list, zip(*pairs))
    with torch.no_grad():
        for leaf in _reachable_leaves(heads):
            if getattr(leaf, "_grad_req", "write") == "write" and \
                    leaf.grad is not None:
                leaf.grad.zero_()
    with torch.enable_grad():
        torch.autograd.backward(heads, grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of `heads` with respect to `variables`, returned as
    NDArrays; the variables' own gradient buffers are untouched.  With
    `create_graph` the result is itself recorded (higher-order
    gradients)."""
    from .ndarray import NDArray
    single = isinstance(variables, (NDArray, torch.Tensor))
    heads = _tensors(heads)
    var_list = _tensors(variables)
    grads = _head_grads(heads, head_grads)
    with torch.enable_grad():
        out = torch.autograd.grad(
            heads, var_list,
            [torch.ones_like(h) if g is None else g.to(h.dtype)
             for h, g in zip(heads, grads)],
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
    if any(g is None for g in out):
        raise MXNetError("autograd.grad: a variable is unreachable from "
                         "the heads (no gradient path)")
    out = [NDArray(g) for g in out]
    return out[0] if single else out
