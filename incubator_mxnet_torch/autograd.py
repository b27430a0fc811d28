"""autograd: MXNet's recording scopes and backward on torch autograd.

Counterpart of `incubator_mxnet_tpu/autograd.py` (`record`, `pause`,
`train_mode`, `predict_mode`, `is_recording`, `is_training`,
`set_recording`, `set_training`, `backward`, `grad`, `mark_variables`,
`Function`).  Two flags, kept per thread as in MXNet:

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
backward calls.  A "write" leaf whose gradient is row-sparse (a
`grad_stype="row_sparse"` Parameter) has its buffer dropped instead, so
a sparse cotangent from `Embedding(sparse_grad=True)` becomes its whole
gradient, as the JAX package's first write replaces the buffer; a
dense cotangent in the same sweep, or a later "add", makes it dense.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "grad_scope", "mark_variables", "Function"]


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
            req = getattr(leaf, "_grad_req", "write")
            sparse = getattr(leaf, "_grad_stype", "default") == "row_sparse"
            if req == "write" and leaf.grad is not None:
                if sparse:
                    leaf.grad = None
                else:
                    leaf.grad.zero_()
            elif req == "add" and sparse and leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)    # accumulate densely
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


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of `variables` a leaf whose gradient buffer is
    the matching NDArray of `gradients` (the same storage: a backward
    writes into it), with its `grad_req` ("null": no gradient)."""
    from .ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        t = var._data.detach()
        t.requires_grad_(req != "null")
        if req != "null":
            if tuple(g.shape) != tuple(t.shape):
                raise MXNetError(f"mark_variables: gradient of shape "
                                 f"{tuple(g.shape)} for a variable of "
                                 f"shape {tuple(t.shape)}")
            t.grad = g._data
        t._grad_req = req
        var._data = t


class _FunctionNode(torch.autograd.Function):
    """Runs a user `Function`'s forward and backward as one node of
    torch's graph."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        from .ndarray import NDArray
        ctx.fn, ctx.n_in = fn, len(inputs)
        with pause():
            outputs = fn.forward(*[NDArray(x) if isinstance(
                x, torch.Tensor) else x for x in inputs])
        fn._returned_tuple = isinstance(outputs, (tuple, list))
        outs = outputs if fn._returned_tuple else (outputs,)
        return tuple(o._data if isinstance(o, NDArray) else o for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray import NDArray
        with pause():
            in_grads = ctx.fn.backward(*[NDArray(g) for g in out_grads])
        if not isinstance(in_grads, (tuple, list)):
            in_grads = [in_grads]
        if len(in_grads) != ctx.n_in:
            raise MXNetError(
                f"{type(ctx.fn).__name__}.backward returned "
                f"{len(in_grads)} grads for {ctx.n_in} inputs")
        return (None,) + tuple(g._data if isinstance(g, NDArray) else g
                               for g in in_grads)


class Function:
    """A user-defined differentiable function: subclass it with
    `forward(self, *inputs)` and `backward(self, *output_grads)`, both
    on NDArrays, and call an instance once per use.  Inside `record()`
    it is one node of the graph, on `torch.autograd.Function`: its
    backward receives a gradient for every output (zeros for an unused
    one) and returns one for every input.  `save_for_backward(*arrays)`
    keeps arrays for the backward as `saved_tensors`.  Neither forward
    nor backward is itself recorded."""

    def __init__(self):
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _FunctionNode.apply(self, *[
                x._data if isinstance(x, NDArray) else x for x in inputs])
        outs = tuple(NDArray(o) for o in outs)
        return outs if self._returned_tuple else outs[0]
