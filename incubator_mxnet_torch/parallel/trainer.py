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

Over a mesh of several ranks (`parallel.make_mesh`, one process a
device) each rank runs the same step on its blocks, as the JAX
package's one program runs on its devices (resolution of the mesh in
the JAX order: `mesh`, `mesh_shape`, ``MXNET_MESH_SHAPE``, `mesh_scope`,
all ranks on 'dp'):

- placement: each parameter's block per `rules` (`TRANSFORMER_RULES`
  when a tp or pp axis of more than one rank is active and no rules are
  given; replicated without rules), which the layers run on
  (`parallel.tensor_parallel`: column-parallel weights keep their
  output block, row-parallel outputs are summed over tp, the
  vocab-parallel embedding sums its rows); every rank must build and
  initialize the block alike, which placement checks by a digest;
- the batch: each array given whole on every rank is cut to this
  rank's rows on `batch_axis` and its `seq_dim` on `seq_axis` (then
  under `sequence_parallel_scope`, so attention runs the ring); an
  `io.sharded` batch is this rank's block already and passes through;
- `pipeline_scope` when a parameter is staged over pp (the GPipe
  schedule, `n_micro` microbatches: argument, ``MXNET_PP_MICROBATCH``,
  the tuner, 4), with the bubble carved in the goodput ledger and
  synthetic ``pp.stage`` spans drawn on the step's trace;
- the gradients: each parameter's summed over the ranks holding the
  same block (one bucket a set of axes and dtype) over the mesh size,
  so the loss keeps the JAX program's global-batch mean; the returned
  loss is the mean over the ranks;
- ZeRO (`zero=`, else ``kvstore.zero.mode()``): level 1 keeps each
  optimizer state's block cut once more over the data axis
  (`zero_state_spec`), each rank updates that block and the weights are
  all-gathered; level 2 reduce-scatters those gradients in place of the
  all-reduce.  Level 1's update is elementwise, so it is bit for bit
  the plain data-parallel step;
- checkpoints: each rank writes the blocks it holds first among their
  replicas under the JAX manifest's keys, and a checkpoint written by
  any number of processes loads into any mesh;
- `param_bytes`/`optimizer_state_bytes` give (total, the largest one
  rank holds), `membership` the fixed SPMD fleet, the statusz section
  the mesh, and `health.replica_digests` audits the dp replicas.
"""
from __future__ import annotations

import contextlib
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
from . import collectives as C
from .mesh import Mesh, current_mesh, default_mesh, mesh_from_shape
from .pipeline import bubble_fraction, pipeline_scope
from .ring_attention import sequence_parallel_scope
from .sharding import (PartitionSpec, Sharding, TRANSFORMER_RULES,
                       zero_state_spec)

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
    mesh : a `Mesh` (default: `mesh_shape` → ``MXNET_MESH_SHAPE`` →
        the `mesh_scope` mesh → `default_mesh()`)
    mesh_shape : (dp, tp, pp) sizes or any `parse_mesh_shape` form
    rules : ParamRules of the model-parallel layouts (default
        `TRANSFORMER_RULES` on a mesh with a tp or pp axis of more than
        one rank, else replicated)
    batch_axis : the mesh axis of every input's batch dim
    seq_axis, seq_dim : the axis and dim of the sequence (ring attention)
    zero : the ZeRO level over the data axis (None → MXNET_KV_ZERO)
    pp_axis, tp_axis : the pipeline and tensor axes (active when their
        size is over 1)
    n_micro : GPipe microbatches (None → MXNET_PP_MICROBATCH → the tuner
        → 4)
    """

    def __init__(self, block, loss, optimizer="sgd", optimizer_params=None,
                 mesh=None, mesh_shape=None, rules=None, batch_axis="dp",
                 seq_axis=None, seq_dim=1, zero=None, pp_axis="pp",
                 tp_axis="tp", n_micro=None):
        if mesh is None:
            mesh = mesh_from_shape(mesh_shape)
        elif mesh_shape is not None:
            raise MXNetError("pass mesh OR mesh_shape, not both")
        self.mesh = mesh or current_mesh() or default_mesh()
        if not isinstance(self.mesh, Mesh):
            raise MXNetError(f"ParallelTrainer: mesh must be a "
                             f"parallel.Mesh, got {type(self.mesh).__name__}")
        shape = self.mesh.shape
        self.tp_axis = tp_axis if tp_axis in shape and shape[tp_axis] > 1 \
            else None
        self.pp_axis = pp_axis if pp_axis in shape and shape[pp_axis] > 1 \
            else None
        if rules is None and (self.tp_axis or self.pp_axis):
            rules = TRANSFORMER_RULES
        self.rules = rules
        from .. import tuner as _tuner
        self.n_micro = max(1, int(n_micro)) if n_micro is not None \
            else max(1, _tuner.env_or_tuned(
                "MXNET_PP_MICROBATCH", "n_micro", 4, int))
        self.batch_axis = batch_axis if batch_axis in shape else None
        self.seq_axis = seq_axis if seq_axis and seq_axis in shape else None
        self.seq_dim = seq_dim
        from ..kvstore import zero as _kvzero
        self.zero_level = _kvzero.mode() if zero is None \
            else max(0, int(zero))
        self.zero = self.zero_level >= 1
        if self.rules is not None and not self.distributed:
            self.rules = None       # one device: every block is whole
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
        self._shardings = None
        self._state_shardings = None
        self._bytes = {}
        self.num_update = 0
        self.lazy_params = []
        self._pp_active = False
        # the planes: the goodput ledger (its peak scales with the
        # mesh), the health ledger made at the first step with
        # MXNET_HEALTH on
        self._ledger = _goodput.StepLedger(
            f"ptrainer{next(_ptrainer_seq)}", devices=[self.device])
        self._ledger.device_count = self.mesh.size
        self._ledger_anchor = None
        self._health = None
        _live_ptrainers.add(self)
        _introspect.register_statusz("ptrainer", _ptrainers_statusz)

    @property
    def distributed(self):
        """Whether the mesh spans a process group."""
        return self.mesh.transport is not None

    @property
    def membership(self):
        """The fleet (`kvstore.MembershipInfo`): an SPMD mesh is a fixed
        fleet, never elastic, epoch 0, the process count live."""
        from ..kvstore import MembershipInfo
        return MembershipInfo(elastic=False, epoch=0,
                              live=self.mesh.world_size,
                              rank=self.mesh.rank)

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
        if self.distributed:
            self._place_params()

    # -- placement over the mesh ----------------------------------------
    def _param_sharding(self, i):
        p = self.params[i]
        if self.rules is None or i not in set(self._wrt):
            return Sharding(self.mesh, PartitionSpec(), name=p.name)
        return self.rules.sharding_for(p.name, tuple(p.shape), self.mesh)

    def _state_sharding(self, j):
        """Optimizer-state sharding of trained parameter j: its own,
        with ZeRO's cut of one more dim over the data axis."""
        i = self._wrt[j]
        sh = self._shardings[i]
        ax = self.batch_axis
        if not self.zero or not ax or self.mesh.shape[ax] <= 1:
            return sh
        spec = zero_state_spec(sh.spec, tuple(self.params[i].shape),
                               self.mesh, axis=ax)
        dims = [d for d, (a, b) in enumerate(zip(
            spec, sh.full_spec(len(spec)))) if a == ax and b != ax]
        if not dims:
            return sh
        return Sharding(self.mesh, sh.spec, name=sh.name, zero_dim=dims[0],
                        zero_axis=ax)

    def _place_params(self):
        """Keep each parameter's block (the ranks must hold the same
        full parameters first: a digest of them is compared)."""
        from .. import health as _h
        mesh = self.mesh
        digest = _h.checksum([p._data for p in self.params])
        every = C._all_gather(mesh, mesh.axis_names, torch.tensor(
            [digest & 0x7FFFFFFFFFFFFFFF], device=self.device), 0)
        if len(set(every.cpu().tolist())) != 1:
            raise MXNetError(
                "ParallelTrainer: the ranks' parameters differ before "
                "placement; build and initialize the block alike on every "
                "rank (the same seed, or the same loaded weights)")
        self._shardings = [self._param_sharding(i)
                           for i in range(len(self.params))]
        for p, sh in zip(self.params, self._shardings):
            p._set_tensor(sh.local_block(p._data.detach()).clone())
            p._shard = sh
        self._state_shardings = [self._state_sharding(j)
                                 for j in range(len(self._wrt))]
        self._pp_active = bool(self.pp_axis) and any(
            self.pp_axis in sh.axes() for sh in self._shardings)
        if self._pp_active:
            self._ledger.set_pipeline(self.mesh.shape[self.pp_axis],
                                      self.n_micro)
        self._bytes["param"] = self._mesh_bytes(
            [p._data for p in self.params],
            [tuple(p.shape) for p in self.params])

    def _mesh_bytes(self, local, shapes):
        """(total bytes of the global arrays, the most one rank holds):
        one max over the mesh at a step, when every rank is there."""
        total = sum(int(_np.prod(s)) * t.element_size()
                    for t, s in zip(local, shapes))
        mine = sum(t.numel() * t.element_size() for t in local)
        if self.distributed and not self.mesh.trivial(self.mesh.axis_names):
            mine = int(C._all_reduce(
                self.mesh, self.mesh.axis_names,
                torch.tensor([mine], dtype=torch.float64,
                             device=self.device), "max").item())
        return total, mine

    def _place(self, a):
        t = a._data if isinstance(a, NDArray) else a
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(_np.ascontiguousarray(t))
        if not self.distributed or getattr(a, "_mesh_local", False):
            # one device, or an io.sharded batch: this rank's block
            return NDArray(t.to(self.device))
        return NDArray(self._batch_sharding(t).local_block(t).to(
            self.device))

    def _batch_sharding(self, t):
        spec = [None] * t.ndim
        if self.batch_axis and t.ndim:
            spec[0] = self.batch_axis
        if self.seq_axis and t.ndim > self.seq_dim:
            spec[self.seq_dim] = self.seq_axis
        return Sharding(self.mesh, PartitionSpec(*spec))

    def _init_states(self):
        def z(j):
            i = self._wrt[j]
            shape = tuple(self.params[i]._data.shape)
            if self._state_shardings is not None:
                shape = self._state_shardings[j].local_shape(
                    tuple(self.params[i].shape))
            return torch.zeros(shape, dtype=torch.float32,
                               device=self.device)
        n = len(self._wrt)
        if self.kind == "adam":
            self._states = [(z(j), z(j)) for j in range(n)]
        elif self.momentum != 0.0:
            self._states = [z(j) for j in range(n)]
        else:
            self._states = [None for _ in range(n)]
        if self.distributed:
            flat, shapes = [], []
            for i, s in zip(self._wrt, self._states):
                for x in (s if isinstance(s, tuple) else (s,)):
                    if x is not None:
                        flat.append(x)
                        shapes.append(tuple(self.params[i].shape))
            self._bytes["state"] = self._mesh_bytes(flat, shapes)

    def _prepare(self, batch):
        if len(batch) < 2:
            raise MXNetError("a batch is (input..., label)")
        arrays = [self._place(a) for a in batch]
        self._ensure_ready(arrays[:-1])
        if self._states is None:
            self._init_states()
        return arrays[:-1], arrays[-1]

    def _scopes(self):
        """The step's scopes: the mesh bound for the collectives, the
        ring over `seq_axis`, the pipeline over `pp_axis`."""
        st = contextlib.ExitStack()
        if self.distributed:
            st.enter_context(C.bind_mesh(self.mesh))
            if self.seq_axis:
                st.enter_context(sequence_parallel_scope(
                    self.mesh, self.seq_axis, self.batch_axis or "dp"))
            if self._pp_active:
                st.enter_context(pipeline_scope(
                    self.mesh, self.pp_axis, n_micro=self.n_micro,
                    tp_axis=self.tp_axis or "tp",
                    batch_axis=self.batch_axis or "dp"))
        return st

    def _reduce_grads(self, grads):
        """Each gradient summed over the ranks holding the same block,
        over the mesh size; under ZeRO-2 a gradient whose state is cut
        over the data axis comes back as that block, reduce-scattered.
        One collective a set of axes and dtype."""
        mesh, ax = self.mesh, self.batch_axis
        out = list(grads)
        buckets, scatter = {}, {}
        for j, i in enumerate(self._wrt):
            reps = self._shardings[i].replica_axes()
            zsh = self._state_shardings[j]
            if self.zero_level >= 2 and zsh.zero_dim is not None:
                reps = tuple(a for a in reps if a != ax)
                scatter.setdefault(grads[j].dtype, []).append(j)
            if not mesh.trivial(reps):
                buckets.setdefault((reps, grads[j].dtype), []).append(j)
        for (reps, _), js in buckets.items():
            flat = C._all_reduce(mesh, reps, torch.cat(
                [out[j].reshape(-1) for j in js]))
            for j, piece in zip(js, flat.split([out[j].numel()
                                                for j in js])):
                out[j] = piece.view_as(out[j])
        n = mesh.axis_size(ax) if ax else 1
        for js in scatter.values():
            rows = [out[j].movedim(self._state_shardings[j].zero_dim, 0)
                    .reshape(n, -1) for j in js]
            got = C._reduce_scatter(mesh, ax, torch.cat(rows, 1), 0) \
                if not mesh.trivial(ax) else torch.cat(rows, 1)
            for j, piece in zip(js, got.split([r.shape[1] for r in rows],
                                              1)):
                d = self._state_shardings[j].zero_dim
                moved = out[j].movedim(d, 0)
                out[j] = piece.reshape((moved.shape[0] // n,)
                                       + tuple(moved.shape[1:])) \
                    .movedim(0, d)
        scale = 1.0 / mesh.size
        return [g * scale if mesh.size > 1 else g for g in out]

    def _zero_block(self, j, t):
        """The ZeRO block of trained parameter j's local tensor `t`."""
        sh = self._state_shardings[j]
        n = self.mesh.axis_size(sh.zero_axis)
        b = t.shape[sh.zero_dim] // n
        return t.narrow(sh.zero_dim, self.mesh.axis_index(sh.zero_axis) * b,
                        b)

    def _gather_zero(self, js, blocks, weights):
        """All-gather the updated ZeRO blocks over the data axis into the
        weights, one collective a dtype."""
        mesh, ax = self.mesh, self.batch_axis
        n = mesh.axis_size(ax)
        by_dtype = {}
        for j, b in zip(js, blocks):
            by_dtype.setdefault(b.dtype, []).append((j, b))
        for items in by_dtype.values():
            rows = [b.movedim(self._state_shardings[j].zero_dim, 0)
                    .reshape(1, -1) for j, b in items]
            flat = torch.cat(rows, 1)
            got = C._all_gather(mesh, ax, flat, 0) \
                if not mesh.trivial(ax) else flat
            for (j, b), piece in zip(items, got.split(
                    [r.shape[1] for r in rows], 1)):
                d = self._state_shardings[j].zero_dim
                moved = b.movedim(d, 0)
                full = piece.reshape((n * moved.shape[0],)
                                     + tuple(moved.shape[1:])).movedim(0, d)
                weights[j].copy_(full)

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
        again), which needs no host sync.  Over a mesh the ids of every
        data rank are gathered, as their gradients are summed."""
        rows, p = rows_out.get(i), self.params[i]
        if rows is None or p._trace_reads > p._rows_lookups or \
                self.rules is not None or \
                (self.distributed and self.zero):
            # a table cut by rules, or whose state ZeRO cuts, takes the
            # dense update
            return None
        if self.distributed and self.batch_axis and \
                not self.mesh.trivial(self.batch_axis):
            rows = C._all_gather(self.mesh, self.batch_axis,
                                 rows.reshape(-1), 0)
        n = p.shape[0]
        if not rows.numel() * 3 < n * 2:
            return None
        ids, valid = lookup_ids(rows, n)
        first = ids[valid.to(torch.int8).argmax()]
        return torch.where(valid, ids, first).clamp(0, n - 1)

    def _loss_grads(self, weights, inputs, label):
        """The float32 mean loss and its gradients with respect to
        `weights`, and the rows each table looked up."""
        with self._scopes(), torch.enable_grad(), autograd.record(), \
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

    def _mean_loss(self, lval):
        """The loss averaged over the mesh's ranks."""
        mesh = self.mesh
        if mesh.trivial(mesh.axis_names):
            return lval.detach()
        total = C._all_reduce(mesh, mesh.axis_names, lval.detach())
        return total / mesh.size if mesh.size > 1 else total

    def _one_step(self, inputs, label, t, health=False):
        """Forward, loss, backward and update; returns the float32 mean
        loss (a 0-d tensor on the device), or with `health` the step's
        numerics stats (`health.traced_step_stats`: a dict of 0-d
        tensors, the loss among them; no host sync)."""
        weights = [self.params[i]._data for i in self._wrt]
        lval, grads, rows_out = self._loss_grads(weights, inputs, label)
        if self.distributed:
            grads = self._reduce_grads(grads)
            lval = self._mean_loss(lval)
        old = _health.snapshot(weights) if health else None
        lazy = {j: self._lazy_rows(i, rows_out)
                for j, i in enumerate(self._wrt) if i in rows_out}
        lazy = {j: r for j, r in lazy.items() if r is not None}
        self.lazy_params = [self.params[self._wrt[j]].name for j in lazy]
        dense = [j for j in range(len(weights)) if j not in lazy]
        zero = [j for j in dense if self._state_shardings is not None
                and self._state_shardings[j].zero_dim is not None]
        dense = [j for j in dense if j not in set(zero)]
        with torch.no_grad():
            ws = [weights[j] for j in dense]
            new = self._update(ws, [grads[j] for j in dense],
                               [self._states[j] for j in dense], t)
            torch._foreach_copy_(ws, new)
            if zero:
                # ZeRO: this rank's block of each, then the weights
                # all-gathered over the data axis.  The blocks are made
                # contiguous: the update's multi-tensor kernels then take
                # them as they take whole weights, so each element's
                # arithmetic is the replicated update's bit for bit
                blocks = [self._zero_block(j, weights[j]).contiguous()
                          for j in zero]
                gblocks = [(grads[j] if self.zero_level >= 2
                            else self._zero_block(j, grads[j])).contiguous()
                           for j in zero]
                new = self._update(blocks, gblocks,
                                   [self._states[j] for j in zero], t)
                self._gather_zero(zero, [n.to(b.dtype) for n, b in
                                         zip(new, blocks)], weights)
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
            self._health = _health.ledger(
                self._ledger.label,
                rank=self.mesh.rank if self.distributed else None)
        vals = _health.host_step_stats(stats)
        self._health.on_step(step=step, loss=vals["loss"],
                             grad_sumsq=vals["grad_sumsq"],
                             nonfinite=int(vals["nonfinite"]),
                             weight_sumsq=vals["weight_sumsq"],
                             update_sumsq=vals["update_sumsq"])
        if self.distributed and self.batch_axis and \
                self._health.audit_due(step):
            # the dp replicas' weight digests compared (every rank
            # reaches this step together)
            digests = _health.replica_digests(
                [p._data for p in self.params], self.mesh, self.batch_axis)
            if digests and len(digests) >= 2:
                self._health.note_audit(step, "dp", digests,
                                        expected=len(digests))
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
            t_c0 = time.monotonic()
            with _tracing.span("compute", steps=k):
                if _goodput.enabled() and \
                        not self._ledger.has_signature(sig):
                    out, flops = _goodput.count_flops(run, t, 1)
                    out = run(t + 1, k - 1, out)
                    self._ledger.set_executable(
                        sig, {"flops": self._mesh_flops(flops) * k},
                        steps_per_call=k)
                else:
                    if _goodput.enabled():
                        self._ledger.use_signature(sig)
                    out = run(t, k)
            self._record_pp_stage_spans(t_c0, time.monotonic(), steps=k)
            if hbit:
                out = self._health_feed(out, self.num_update)
        self._boundary(win0, steps=k)
        return NDArray(out)

    def _mesh_flops(self, flops):
        """The step's FLOPs over the mesh: every rank's count summed, as
        the JAX package's cost analysis counts the global program."""
        if not self.distributed or self.mesh.trivial(self.mesh.axis_names):
            return flops
        return float(C._all_reduce(
            self.mesh, self.mesh.axis_names,
            torch.tensor([float(flops)], dtype=torch.float64,
                         device=self.device)).item())

    # drawing every step of a large run_steps(k) would flood the span
    # ring; past this many spans the schedule is drawn once, coarse
    _PP_SPAN_CAP = 128

    def _record_pp_stage_spans(self, t0, t1, steps=1):
        """Synthetic ``pp.stage`` spans subdividing the compute window
        by the GPipe schedule (slot = step window / (n_micro + pp - 1);
        stage i busy in slots [i, i + n_micro)), marked ``synthetic``:
        the schedule's shape drawn on the measured wall, as the JAX
        package draws it."""
        if not self._pp_active or not _tracing.enabled():
            return
        tid, sid = _tracing.current()
        if not tid:
            return
        pp = int(self.mesh.shape[self.pp_axis])
        steps = max(1, int(steps))
        coarse = steps * pp > self._PP_SPAN_CAP
        reps = 1 if coarse else steps
        step_w = max(0.0, (t1 - t0)) / reps
        slot_w = step_w / (self.n_micro + pp - 1)
        attrs = {"n_micro": self.n_micro, "steps": steps,
                 "synthetic": True,
                 "bubble_fraction": round(
                     bubble_fraction(pp, self.n_micro), 6)}
        if coarse:
            attrs["coarse"] = True
        for r in range(reps):
            s0 = t0 + r * step_w
            for i in range(pp):
                _tracing.record_span(
                    "pp.stage", s0 + i * slot_w,
                    s0 + (i + self.n_micro) * slot_w, tid, sid,
                    attrs=dict(attrs, stage=i))

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
        runs, each `Parameter._data` is the given tensor.  One device
        only."""
        if self.distributed:
            raise MXNetError("functional_step: a step over a mesh of "
                             "ranks has no one-function form")
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
        """(total bytes, the most one rank holds) of the parameters."""
        if self.params is None:
            return 0, 0
        if "param" in self._bytes:
            return self._bytes["param"]
        return self._tree_bytes([p._data for p in self.params])

    def optimizer_state_bytes(self):
        """(total bytes, the most one rank holds) of the optimizer
        states."""
        if self._states is None:
            return 0, 0
        if "state" in self._bytes:
            return self._bytes["state"]
        return self._tree_bytes([x for s in self._states for x in (
            s if isinstance(s, tuple) else (s,)) if x is not None])

    def mesh_report(self):
        """The statusz payload: the mesh's shape, the active axes, the
        pipeline, the ZeRO level and the bytes."""
        pb_total, pb_dev = self.param_bytes()
        sb_total, sb_dev = self.optimizer_state_bytes()
        pp = None
        if self._pp_active:
            n = int(self.mesh.shape[self.pp_axis])
            pp = {"axis": self.pp_axis, "stages": n, "n_micro": self.n_micro,
                  "bubble_fraction": round(bubble_fraction(
                      n, self.n_micro), 6)}
        return {"mesh": dict(self.mesh.shape), "devices": self.mesh.size,
                "transport": self.mesh.transport,
                "batch_axis": self.batch_axis, "tp_axis": self.tp_axis,
                "seq_axis": self.seq_axis, "pp": pp,
                "zero_level": self.zero_level,
                "param_bytes": {"total": pb_total, "max_per_device": pb_dev},
                "state_bytes": {"total": sb_total, "max_per_device": sb_dev}}

    def gather_params(self):
        """Every parameter whole, in `collect_params` order (over a mesh
        a collective: every rank calls it and gets them all)."""
        if self.params is None:
            return []
        if not self.distributed:
            return [p._data.detach().clone() for p in self.params]
        return [sh.gather(p._data.detach(), tuple(p.shape))
                for p, sh in zip(self.params, self._shardings)]

    def _state_tree(self):
        """{structural key: tensor} of the parameters and optimizer
        states (this rank's blocks), the JAX package's keys: `param:{i}`
        over every parameter, `state:{j}:m` (and `:v` for Adam) over the
        trained ones.  SGD without momentum writes zeros for `m`, which
        the JAX package keeps."""
        tree = {f"param:{i}": p._data for i, p in enumerate(self.params)}
        for j, (i, s) in enumerate(zip(self._wrt, self._states)):
            if self.kind == "adam":
                tree[f"state:{j}:m"], tree[f"state:{j}:v"] = s
            else:
                tree[f"state:{j}:m"] = s if s is not None else torch.zeros(
                    self._state_shardings[j].local_shape(
                        tuple(self.params[i].shape))
                    if self._state_shardings is not None
                    else self.params[i].shape,
                    dtype=torch.float32, device=self.device)
        return tree

    def _tree_sharding(self, key):
        """The sharding of `_state_tree()`'s `key`, None on one device."""
        if self._shardings is None:
            return None
        kind, idx = key.split(":")[:2]
        return self._shardings[int(idx)] if kind == "param" \
            else self._state_shardings[int(idx)]

    def _global_shape(self, key):
        kind, idx = key.split(":")[:2]
        i = int(idx) if kind == "param" else self._wrt[int(idx)]
        return tuple(self.params[i].shape)

    def save_checkpoint(self, directory):
        """Write the parameters, optimizer states and step count to
        `directory` (`parallel/checkpoint.py`'s format): over a mesh each
        rank writes its blocks (every rank calls this)."""
        from .checkpoint import save_sharded
        if self.params is None:
            raise MXNetError("save_checkpoint: trainer has not run yet")
        if self._states is None:
            self._init_states()
        tree = self._state_tree()
        extra = {"optimizer": self.kind,
                 "param_names": [p.name for p in self.params]}
        if not self.distributed:
            return save_sharded(directory, tree, step=self.num_update,
                                extra=extra)
        return save_sharded(
            directory, tree, step=self.num_update, extra=extra,
            shardings={k: (self._tree_sharding(k), self._global_shape(k))
                       for k in tree}, mesh=self.mesh)

    def load_checkpoint(self, directory):
        """Restore parameters, optimizer states and the step count from
        either package's `save_checkpoint`, written by any number of
        processes, after checking the optimizer kind, that every key is
        there and every parameter's shape.  Returns the manifest."""
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
                sh = self._tree_sharding(k)
                full = arrays[k]
                t.copy_(sh.local_block(full) if sh is not None else full)
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

        def put(x, j):
            i = self._wrt[j]
            x = torch.from_numpy(_np.array(x, dtype=_np.float32))
            if tuple(x.shape) != tuple(self.params[i].shape):
                raise MXNetError(
                    f"state of {self.params[i].name} has shape "
                    f"{tuple(x.shape)}, the parameter {self.params[i].shape}")
            if self._state_shardings is not None:
                x = self._state_shardings[j].local_block(x)
            return x.to(self.device)
        if self.kind == "adam":
            self._states = [(put(s[0], j), put(s[1], j))
                            for j, s in enumerate(states)]
        elif self.momentum != 0.0:
            self._states = [put(s, j) for j, s in enumerate(states)]
        else:
            self._states = [None for _ in self._wrt]
        self.num_update = int(num_update)


def _ptrainer_statusz_of(tr):
    led = tr._ledger.summary()["window"]
    report = tr.mesh_report()
    report.update({"device": str(tr.device), "steps": tr.num_update,
                   "optimizer": tr.kind,
                   "goodput": {"fraction": led["goodput_fraction"],
                               "mfu": led["mfu"]}})
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
