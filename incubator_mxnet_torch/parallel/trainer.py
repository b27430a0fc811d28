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

The runtime planes ride the step as in the JAX package: each trainer
owns a `goodput.StepLedger` (the window [previous step end, this step
end], its buckets from the step's spans, MFU from the FLOPs counted on
the first step of each signature, the card's memory peak), a
`health.HealthLedger` while ``MXNET_HEALTH=1`` (the step's numerics
stats taken on the device and read in one host sync), and
`profiling.step_boundary` after each `step` and each `run_steps(k)`.
A `step` is a "step" tracing span with a "compute" span inside.  With
``MXNET_GOODPUT=0``, ``MXNET_HEALTH`` unset and no profiling window,
each plane costs one flag check a step.  Live trainers report under
the debugz statusz section "ptrainer".

One device only: the mesh is `default_mesh()`'s (gpu(0) unless the
caller passes a mesh on `cpu()`).  Model-parallel `rules`, sequence
sharding (`seq_axis`), ZeRO (`zero`), pipeline and tensor-parallel
meshes raise until the multi-GPU slice.
"""
from __future__ import annotations

import itertools
import math
import time
import weakref

import numpy as _np
import torch

from .. import autograd
from .. import goodput as _goodput
from .. import health as _health
from .. import introspect as _introspect
from .. import profiling as _profiling
from .. import tracing as _tracing
from ..base import MXNetError
from ..gluon.block import record_rows
from ..gluon.parameter import bound_data
from ..ndarray import NDArray
from ..ops.shape import lookup_ids
from ..ops.optim import sgd_multi, adam_multi
from .mesh import Mesh, default_mesh

__all__ = ["ParallelTrainer"]

_ptrainer_seq = itertools.count()       # goodput/health ledger labels
_live_ptrainers = weakref.WeakSet()


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
        # the planes: the goodput ledger (its peak is one card's), the
        # health ledger made at the first step with MXNET_HEALTH on
        self._ledger = _goodput.StepLedger(
            f"ptrainer{next(_ptrainer_seq)}", devices=[self.device])
        self._ledger_anchor = None
        self._health = None
        _live_ptrainers.add(self)
        _introspect.register_statusz("ptrainer", _ptrainers_statusz)

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
        in place.  Returns the new weights in float32.  `t` is a number,
        or a float32 tensor of one value in the traced step, whose
        Adam correction takes the same float64 arithmetic and is rounded
        once to float32, as a Python number is where it meets a float32
        state."""
        if self.kind == "sgd":
            moms = None if self.momentum == 0.0 else states
            return sgd_multi(weights, grads, moms, lrs=self.lr,
                             momentum=self.momentum, wds=self.wd)
        if isinstance(t, torch.Tensor):
            t = t.to(torch.float64).reshape(())
            lr = (self.lr * (torch.sqrt(1 - self.beta2 ** t)
                             / (1 - self.beta1 ** t))).to(torch.float32)
        else:
            lr = self.lr * (math.sqrt(1 - self.beta2 ** t)
                            / (1 - self.beta1 ** t))
        return adam_multi(weights, grads, [s[0] for s in states],
                          [s[1] for s in states], lrs=lr,
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

    def _loss_grads(self, weights, inputs, label):
        """The float32 mean loss and its gradients with respect to
        `weights`, and the rows each table looked up."""
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
        return lval, grads, rows_out

    def _one_step(self, inputs, label, t, health=False):
        """Forward, loss, backward and update; returns the float32 mean
        loss (a 0-d tensor on the device), or with `health` the step's
        numerics stats (`health.traced_step_stats`: a dict of 0-d
        tensors, the loss among them; no host sync)."""
        weights = [self.params[i]._data for i in self._wrt]
        lval, grads, rows_out = self._loss_grads(weights, inputs, label)
        old = _health.snapshot(weights) if health else None
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
            if health:
                return _health.traced_step_stats(lval, grads, weights, old)
        return lval.detach()

    def _signature(self, inputs, label, health, k=1):
        """What a step's FLOP count depends on: the batch's shapes and
        dtypes, the health flag and the steps a call runs."""
        return (k, health) + tuple((tuple(a.shape), str(a.dtype))
                                   for a in (*inputs, label))

    def _health_feed(self, stats, step):
        """Read the step's stats in one host sync, feed the numerics
        ledger; returns the loss tensor."""
        if self._health is None:
            self._health = _health.ledger(self._ledger.label)
        vals = _health.host_step_stats(stats)
        self._health.on_step(step=step, loss=vals["loss"],
                             grad_sumsq=vals["grad_sumsq"],
                             nonfinite=int(vals["nonfinite"]),
                             weight_sumsq=vals["weight_sumsq"],
                             update_sumsq=vals["update_sumsq"])
        return stats["loss"]

    def _boundary(self, win0, steps=1):
        """The step boundary: the ledger's window, then the profiling
        window's hook (one flag check when idle)."""
        self._ledger_anchor = time.monotonic()
        self._ledger.on_step(win0, self._ledger_anchor, steps=steps,
                             trace_id=_tracing.last_trace_id())
        _profiling.step_boundary(label=self._ledger.label, steps=steps)

    # ------------------------------------------------------------------
    def step(self, *batch):
        """One train step.  batch = (input..., label).  Returns the
        (scalar NDArray) mean loss."""
        return self._train(batch, 1)

    def run_steps(self, k, *batch):
        """k train steps on the same batch; returns the last step's mean
        loss.  Adam's step runs from `num_update + 1` as in one step.
        The planes see one boundary of k steps, as the JAX package's one
        dispatch; with health on, the last step's stats are fed, its
        nonfinite count summed over the k steps."""
        return self._train(batch, k)

    def _train(self, batch, k):
        """k steps in a "step" span and one "compute" span, then the
        step boundary.  The FLOPs are counted on the first step of a
        signature not seen yet (goodput on) and spread over k steps."""
        win0 = self._ledger_anchor
        if win0 is None:
            win0 = time.monotonic()
        with _tracing.step_span(steps=k):
            inputs, label = self._prepare(batch)
            t = float(self.num_update + 1)
            self.num_update += k
            hbit = _health.enabled()
            sig = self._signature(inputs, label, hbit, k)

            def run(t0, n, out=None):
                for i in range(n):
                    cur = self._one_step(inputs, label, t0 + i, hbit)
                    if hbit and out is not None:
                        cur = dict(cur, nonfinite=cur["nonfinite"]
                                   + out["nonfinite"])
                    out = cur
                return out
            with _tracing.span("compute", steps=k):
                if _goodput.enabled() and \
                        not self._ledger.has_signature(sig):
                    out, flops = _goodput.count_flops(run, t, 1)
                    out = run(t + 1, k - 1, out)
                    self._ledger.set_executable(sig, {"flops": flops * k},
                                                steps_per_call=k)
                else:
                    if _goodput.enabled():
                        self._ledger.use_signature(sig)
                    out = run(t, k)
            if hbit:
                out = self._health_feed(out, self.num_update)
        self._boundary(win0, steps=k)
        return NDArray(out)

    def state_shapes(self):
        """The shape of each float32 optimizer state in the flat order
        of `functional_step`: one momentum a trained parameter for SGD
        (zeros without momentum), m then v of each for Adam."""
        per = 2 if self.kind == "adam" else 1
        return [tuple(self.params[i].shape) for i in self._wrt
                for _ in range(per)]

    def functional_step(self, *batch):
        """The dense step as a pure function of tensors, for tracing
        (`deploy.export_training`):

            step(params..., states..., t, input..., label)
                -> (loss (1,), params'..., states'...)

        params are every parameter in `collect_params` order, states as
        `state_shapes()` gives them, t a float32 tensor (1,) holding the
        step number (1 for the first step).  The arithmetic is
        `step`'s; the lazy row update is not taken.  `batch` (input...,
        label) finishes a deferred initialization first.  While the step
        runs, each `Parameter._data` is the given tensor."""
        self._prepare(batch)
        params, wrt = self.params, self._wrt
        n, ns = len(params), len(self.state_shapes())

        def step(*flat):
            ps = list(flat[:n])
            st = [s.clone() for s in flat[n:n + ns]]
            t = flat[n + ns]
            rest = [NDArray(x) for x in flat[n + ns + 1:]]
            ws = [ps[i].detach().requires_grad_(True) for i in wrt]
            for i, w in zip(wrt, ws):
                ps[i] = w
            with bound_data(params, ps):
                lval, grads, _ = self._loss_grads(ws, rest[:-1], rest[-1])
            states = list(zip(st[::2], st[1::2])) if self.kind == "adam" \
                else st
            with torch.no_grad():
                new = self._update([w.detach() for w in ws], grads, states,
                                   t)
            out = [x.detach() for x in ps]
            for i, w in zip(wrt, new):
                out[i] = w.to(out[i].dtype)
            return (lval.detach().reshape(1), *out, *st)
        return step

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


def _ptrainer_statusz_of(tr):
    led = tr._ledger.summary()["window"]
    report = {"device": str(tr.device), "steps": tr.num_update,
              "optimizer": tr.kind,
              "goodput": {"fraction": led["goodput_fraction"],
                          "mfu": led["mfu"]}}
    if _health.enabled() and tr._health is not None:
        report["health"] = tr._health.summary()
    return report


def _ptrainers_statusz():
    """The ``/-/statusz`` "ptrainer" section over every live
    ParallelTrainer: one trainer's report, or a list of them."""
    trs = sorted(_live_ptrainers, key=id)
    if not trs:
        return {"gone": True}
    if len(trs) == 1:
        return _ptrainer_statusz_of(trs[0])
    return {"count": len(trs),
            "trainers": [_ptrainer_statusz_of(t) for t in trs]}
