"""ParallelTrainer: the fused training step on one device.

Counterpart of `incubator_mxnet_tpu/parallel/trainer.py`
`ParallelTrainer` (`__init__`, `step`, `run_steps`, `num_update`, the
`_sgd_update`/`_adam_update` rules and `_build_step`'s semantics).  One
step runs, in train mode under `autograd.record()`:

    loss = mean(loss_fn(block(*inputs), label)) in float32
    grads = d loss / d params whose grad_req is not "null"
    update, in float32 with float32 optimizer states, each weight
    rounded back to its dtype (in place)

with t = `num_update` after the increment as Adam's step.  The JAX
package compiles the step into one XLA program; here it runs eagerly,
and `run_steps(k, ...)` is k such steps on the same batch (a CUDA graph
of the step is later work).

One device only: the mesh is `default_mesh()`'s (gpu(0) unless the
caller passes a mesh on `cpu()`).  Model-parallel `rules`, sequence
sharding (`seq_axis`), ZeRO (`zero`), pipeline and tensor-parallel
meshes raise until the multi-GPU slice.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError
from ..ndarray import NDArray
from ..ops.optim import sgd_multi, adam_multi
from .mesh import Mesh, default_mesh

__all__ = ["ParallelTrainer"]


class ParallelTrainer:
    """Fused train step for a gluon block.

    Parameters
    ----------
    block : HybridBlock, initialized (deferred shapes are resolved by the
        first step).
    loss : callable (out NDArray, label NDArray) -> NDArray; the mean is
        taken in float32.
    optimizer : 'sgd' | 'adam'
    optimizer_params : learning_rate / momentum / beta1 / beta2 /
        epsilon / wd
    mesh : a one-device `Mesh` (default: `default_mesh()`)
    """

    def __init__(self, block, loss, optimizer="sgd", optimizer_params=None,
                 mesh=None, mesh_shape=None, rules=None, batch_axis="dp",
                 seq_axis=None, seq_dim=1, zero=None, pp_axis="pp",
                 tp_axis="tp", n_micro=None):
        if mesh is not None and mesh_shape is not None:
            raise MXNetError("pass mesh OR mesh_shape, not both")
        if mesh_shape is not None and _np.prod(
                [int(s) for s in (mesh_shape.values()
                                  if isinstance(mesh_shape, dict)
                                  else mesh_shape)]) != 1:
            raise MXNetError(f"mesh_shape {mesh_shape}: meshes over several "
                             f"devices are not ported yet")
        if rules is not None or seq_axis is not None or zero:
            raise MXNetError(
                "ParallelTrainer: model-parallel rules, sequence sharding "
                "and ZeRO need the multi-GPU slice, not ported yet")
        self.mesh = mesh if mesh is not None else default_mesh()
        if not isinstance(self.mesh, Mesh):
            raise MXNetError(f"ParallelTrainer: mesh must be a "
                             f"parallel.Mesh, got {type(self.mesh).__name__}")
        self.block = block
        self.loss = loss
        self.kind = optimizer
        if optimizer not in ("sgd", "adam"):
            raise MXNetError("ParallelTrainer supports sgd/adam; use "
                             "gluon.Trainer for the rest")
        op = dict(optimizer_params or {})
        self.lr = float(op.get("learning_rate", 0.01))
        self.momentum = float(op.get("momentum", 0.0))
        self.beta1 = float(op.get("beta1", 0.9))
        self.beta2 = float(op.get("beta2", 0.999))
        self.eps = float(op.get("epsilon", 1e-8))
        self.wd = float(op.get("wd", 0.0))
        self.params = None
        self._wrt = None
        self._states = None
        self.num_update = 0

    @property
    def device(self):
        return self.mesh.device

    # ------------------------------------------------------------------
    def _ensure_ready(self, inputs):
        """Collect the parameters at the first step; a deferred shape is
        resolved by one forward outside any recorded graph."""
        if self.params is not None:
            return
        if any(p._data is None for p in self.block.collect_params().values()):
            with autograd.pause(), torch.no_grad():
                self.block(*inputs)
        self._collect()

    def _collect(self):
        params = list(self.block.collect_params().values())
        for p in params:
            p._check_initialized()
            if p._data.device != self.device:
                raise MXNetError(
                    f"parameter {p.name} lies on {p._data.device}, the "
                    f"mesh on {self.device}")
        self.params = params
        self._wrt = [i for i, p in enumerate(params) if p.grad_req != "null"]

    def _place(self, a):
        t = a._data if isinstance(a, NDArray) else a
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(_np.ascontiguousarray(t))
        return NDArray(t.to(self.device))

    def _init_states(self):
        def z(i):
            return torch.zeros(self.params[i].shape, dtype=torch.float32,
                               device=self.device)
        if self.kind == "adam":
            self._states = [(z(i), z(i)) for i in self._wrt]
        elif self.momentum != 0.0:
            self._states = [z(i) for i in self._wrt]
        else:
            self._states = [None for _ in self._wrt]

    def _prepare(self, batch):
        if len(batch) < 2:
            raise MXNetError("a batch is (input..., label)")
        arrays = [self._place(a) for a in batch]
        self._ensure_ready(arrays[:-1])
        if self._states is None:
            self._init_states()
        return arrays[:-1], arrays[-1]

    def _one_step(self, inputs, label, t):
        """Forward, loss, backward and update; returns the float32 mean
        loss (a 0-d tensor on the device)."""
        weights = [self.params[i]._data for i in self._wrt]
        with torch.enable_grad(), autograd.record():
            out = self.block(*inputs)
            l = self.loss(out if isinstance(out, NDArray) else NDArray(out),
                          label)
            lval = (l._data if isinstance(l, NDArray) else l).to(
                torch.float32).mean()
        grads = torch.autograd.grad(lval, weights, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(weights, grads)]
        with torch.no_grad():
            if self.kind == "sgd":
                moms = None if self.momentum == 0.0 else self._states
                new = sgd_multi(weights, grads, moms, lrs=self.lr,
                                momentum=self.momentum, wds=self.wd)
            else:
                corr = math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
                new = adam_multi(weights, grads,
                                 [s[0] for s in self._states],
                                 [s[1] for s in self._states],
                                 lrs=self.lr * corr, beta1=self.beta1,
                                 beta2=self.beta2, epsilon=self.eps,
                                 wds=self.wd)
            torch._foreach_copy_(weights, new)
        return lval.detach()

    # ------------------------------------------------------------------
    def step(self, *batch):
        """One train step.  batch = (input..., label).  Returns the
        (scalar NDArray) mean loss."""
        inputs, label = self._prepare(batch)
        self.num_update += 1
        return NDArray(self._one_step(inputs, label, float(self.num_update)))

    def run_steps(self, k, *batch):
        """k train steps on the same batch; returns the last step's mean
        loss.  Adam's step runs from `num_update + 1` as in one step."""
        inputs, label = self._prepare(batch)
        t = float(self.num_update + 1)
        self.num_update += k
        lval = None
        for i in range(k):
            lval = self._one_step(inputs, label, t + i)
        return NDArray(lval)

    def set_states(self, states, num_update):
        """Install optimizer states (numpy, one entry per parameter whose
        grad_req is not "null", in `collect_params` order: an array for
        SGD, (mean, var) for Adam) and the step count.  The parameters
        must be initialized."""
        if self.params is None:
            self._collect()
        if len(states) != len(self._wrt):
            raise MXNetError(f"{len(states)} optimizer states for "
                             f"{len(self._wrt)} trained parameters")

        def put(x, i):
            x = torch.from_numpy(_np.array(x, dtype=_np.float32))
            if tuple(x.shape) != tuple(self.params[i].shape):
                raise MXNetError(
                    f"state of {self.params[i].name} has shape "
                    f"{tuple(x.shape)}, the parameter {self.params[i].shape}")
            return x.to(self.device)
        if self.kind == "adam":
            self._states = [(put(s[0], i), put(s[1], i))
                            for s, i in zip(states, self._wrt)]
        elif self.momentum != 0.0:
            self._states = [put(s, i) for s, i in zip(states, self._wrt)]
        else:
            self._states = [None for _ in self._wrt]
        self.num_update = int(num_update)
