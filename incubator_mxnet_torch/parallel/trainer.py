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

A row-sparse-gradient table (`Embedding(sparse_grad=True)`) takes the
lazy row update, as in the JAX package: the forward records the ids it
looks up (`gluon.block.record_rows`), and only those rows of the weight
and its optimizer state are updated, duplicates included (they gather
the same values and write the same results), while the ids number
fewer than two thirds of the table's rows.  A table also read outside
its Embedding (a tied decoder) takes the dense update.  `lazy_params`
names the tables the last step updated lazily.

`save_checkpoint`/`load_checkpoint` write and read the parameters, the
optimizer states and the step count in the JAX package's sharded
format (`parallel/checkpoint.py`), under the same structural keys
(`param:{i}`, `state:{j}:m`, `state:{j}:v`), so checkpoints cross
between the packages.  `param_bytes()` and `optimizer_state_bytes()`
give (total, largest on one device): one device holds it all.

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
from ..gluon.block import record_rows
from ..ndarray import NDArray
from ..ops.shape import lookup_ids
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
        self.lazy_params = []

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

    def _update(self, weights, grads, states, t):
        """The optimizer's rule over lists; states (float32) are updated
        in place.  Returns the new weights in float32."""
        if self.kind == "sgd":
            moms = None if self.momentum == 0.0 else states
            return sgd_multi(weights, grads, moms, lrs=self.lr,
                             momentum=self.momentum, wds=self.wd)
        corr = math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        return adam_multi(weights, grads, [s[0] for s in states],
                          [s[1] for s in states], lrs=self.lr * corr,
                          beta1=self.beta1, beta2=self.beta2,
                          epsilon=self.eps, wds=self.wd)

    def _lazy_rows_update(self, w, s, g, rows, t):
        """Update only `rows` of weight `w` and its state `s`: gather
        them, apply the rule, scatter them back.  Every other row keeps
        its weight and its state (no moment decay)."""
        g_rows, w_rows = g.index_select(0, rows), w.index_select(0, rows)
        full = () if s is None else s if isinstance(s, tuple) else (s,)
        part = tuple(x.index_select(0, rows) for x in full)
        s_rows = part if isinstance(s, tuple) else (part[0] if part
                                                     else None)
        (new,) = self._update([w_rows], [g_rows], [s_rows], t)
        w.index_copy_(0, rows, new.to(w.dtype))
        for x, x_rows in zip(full, part):
            x.index_copy_(0, rows, x_rows)

    def _lazy_rows(self, i, rows_out):
        """The valid row ids of table `i` to update lazily, or None for
        the dense update.  An id outside the table touches no row: it is
        replaced by a valid id of the batch (the same row's update
        again), which needs no host sync."""
        rows, p = rows_out.get(i), self.params[i]
        if rows is None or p._trace_reads > p._rows_lookups:
            return None
        n = p.shape[0]
        if not rows.numel() * 3 < n * 2:
            return None
        ids, valid = lookup_ids(rows, n)
        first = ids[valid.to(torch.int8).argmax()]
        return torch.where(valid, ids, first).clamp(0, n - 1)

    def _one_step(self, inputs, label, t):
        """Forward, loss, backward and update; returns the float32 mean
        loss (a 0-d tensor on the device)."""
        weights = [self.params[i]._data for i in self._wrt]
        with torch.enable_grad(), autograd.record(), \
                record_rows(self.params, {}) as rows_out:
            out = self.block(*inputs)
            l = self.loss(out if isinstance(out, NDArray) else NDArray(out),
                          label)
            lval = (l._data if isinstance(l, NDArray) else l).to(
                torch.float32).mean()
        grads = torch.autograd.grad(lval, weights, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(weights, grads)]
        lazy = {j: self._lazy_rows(i, rows_out)
                for j, i in enumerate(self._wrt) if i in rows_out}
        lazy = {j: r for j, r in lazy.items() if r is not None}
        self.lazy_params = [self.params[self._wrt[j]].name for j in lazy]
        dense = [j for j in range(len(weights)) if j not in lazy]
        with torch.no_grad():
            ws = [weights[j] for j in dense]
            new = self._update(ws, [grads[j] for j in dense],
                               [self._states[j] for j in dense], t)
            torch._foreach_copy_(ws, new)
            for j, rows in lazy.items():
                self._lazy_rows_update(weights[j], self._states[j], grads[j],
                                       rows, t)
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

    # -- byte reports and checkpoints -----------------------------------
    @staticmethod
    def _tree_bytes(tensors):
        total = sum(t.numel() * t.element_size() for t in tensors)
        return total, total

    def param_bytes(self):
        """(total bytes, largest on one device) of the parameters."""
        if self.params is None:
            return 0, 0
        return self._tree_bytes([p._data for p in self.params])

    def optimizer_state_bytes(self):
        """(total bytes, largest on one device) of the optimizer states."""
        if self._states is None:
            return 0, 0
        return self._tree_bytes([x for s in self._states for x in (
            s if isinstance(s, tuple) else (s,)) if x is not None])

    def _state_tree(self):
        """{structural key: tensor} of the parameters and optimizer
        states, the JAX package's keys: `param:{i}` over every
        parameter, `state:{j}:m` (and `:v` for Adam) over the trained
        ones.  SGD without momentum writes zeros for `m`, which the JAX
        package keeps."""
        tree = {f"param:{i}": p._data for i, p in enumerate(self.params)}
        for j, (i, s) in enumerate(zip(self._wrt, self._states)):
            if self.kind == "adam":
                tree[f"state:{j}:m"], tree[f"state:{j}:v"] = s
            else:
                tree[f"state:{j}:m"] = s if s is not None else torch.zeros(
                    self.params[i].shape, dtype=torch.float32,
                    device=self.device)
        return tree

    def save_checkpoint(self, directory):
        """Write the parameters, optimizer states and step count to
        `directory` (`parallel/checkpoint.py`'s format)."""
        from .checkpoint import save_sharded
        if self.params is None:
            raise MXNetError("save_checkpoint: trainer has not run yet")
        if self._states is None:
            self._init_states()
        return save_sharded(
            directory, self._state_tree(), step=self.num_update,
            extra={"optimizer": self.kind,
                   "param_names": [p.name for p in self.params]})

    def load_checkpoint(self, directory):
        """Restore parameters, optimizer states and the step count from
        either package's `save_checkpoint`, after checking the
        optimizer kind, that every key is there and every parameter's
        shape.  Returns the manifest."""
        from .checkpoint import load_sharded, read_manifest
        if self.params is None:
            self._collect()
        if self._states is None:
            self._init_states()
        manifest = read_manifest(directory)
        if manifest["extra"].get("optimizer", self.kind) != self.kind:
            raise MXNetError("load_checkpoint: optimizer kind mismatch")
        tree = self._state_tree()
        saved = manifest["arrays"]
        missing = [k for k in tree if k not in saved]
        if missing:
            raise MXNetError(
                f"load_checkpoint: checkpoint lacks {missing[:4]}... "
                f"({len(saved)} arrays saved, {len(tree)} needed) — "
                "different model or optimizer?")
        for i, p in enumerate(self.params):
            want = tuple(saved[f"param:{i}"]["shape"])
            if tuple(p.shape) != want:
                raise MXNetError(
                    f"load_checkpoint: param {i} ({p.name}) has shape "
                    f"{tuple(p.shape)} but checkpoint has {want}")
        arrays, manifest = load_sharded(directory, set(tree), manifest)
        with torch.no_grad():
            for k, t in tree.items():
                t.copy_(arrays[k])
        self.num_update = int(manifest["step"])
        return manifest

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
