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

The kvstore.  "device", "local" or None: one device, nothing to reduce.
"dist_sync", "dist_async" and "dist_sync_device" are the parameter
server (`kvstore.KVStoreDist`, a fixed fleet), and "tpu" and "nccl" an
in-process store, as the JAX package creates them.  With a dist store
the optimizer runs on the servers by default (`update_on_kvstore`):
`step` pushes the gradients scaled by 1/batch_size, bucketed
(`kvstore.bucket`) when the optimizer is elementwise with uniform
multipliers, and pulls the updated weights; with
`update_on_kvstore=False` the gradients are summed over the workers
(bucketed, or per key) and each worker updates.  ``MXNET_KV_OVERLAP=1``
streams each bucket during the next backward (`autograd`'s grad-ready
watch); the host relay (``MXNET_KV_HIERARCHY``, `kvstore.hierarchy`)
keeps the update on the workers unless ``MXNET_KV_ZERO=2``.
`compression_params` set the dist store's 2-bit wire compression.  A
transport error ends the step with one clean error.

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

# the kvstore names the trainer creates a store for, as the JAX package
_KV_NAMES = ("dist_sync", "dist_async", "dist_sync_device", "tpu", "nccl")

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
        from ..kvstore.dist import check_fixed_fleet
        check_fixed_fleet()
        self._all_params = list(params)
        self._params = [p for p in params if p.grad_req != "null"]
        self._kvstore_type = kvstore
        self._optimizer = opt.create(optimizer, **(optimizer_params or {}))
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states = [None] * len(self._params)
        self._states_created = [False] * len(self._params)
        self._allow_fused = get_env("MXNET_FUSED_TRAINER", True, bool)
        self._kv = None
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = False
        self._bucketer = None       # allreduce-path GradientBucketer
        self._kv_bucketer = None    # update-on-kvstore-path bucketer
        if kvstore in _KV_NAMES:
            from .. import kvstore as kvs
            self._kv = kvs.create(kvstore)
            if compression_params:
                self._kv.set_gradient_compression(compression_params)
        if self._update_on_kvstore is None:
            self._update_on_kvstore = bool(
                self._kv is not None and kvstore.startswith("dist"))
        from ..kvstore import hierarchy as _hier
        from ..kvstore import zero as _kvzero
        if self._update_on_kvstore and _hier.relay() is not None \
                and not _kvzero.reduce_scatter():
            # the host relay exchanges merged gradients; the update
            # stays on the workers unless ZeRO-2's reduce-scatter
            # carries it
            if update_on_kvstore:
                raise MXNetError(
                    "update_on_kvstore=True is not supported with the "
                    "hierarchical host relay (MXNET_KV_HIERARCHY with "
                    "MXNET_KV_LOCAL_SIZE > 1) unless MXNET_KV_ZERO=2 "
                    "(the reduce-scatter exchange) — pass "
                    "update_on_kvstore=False")
            self._update_on_kvstore = False
        # MXNET_KV_OVERLAP: after each step a BucketStream is armed so
        # the next backward posts each bucket as its last gradient lands
        self._overlap = get_env("MXNET_KV_OVERLAP", False, bool)
        self._stream = None
        self._last_overlap = None
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

    @property
    def membership(self):
        """The fleet as last observed (`kvstore.MembershipInfo`): a fixed
        fleet of one without a dist kvstore."""
        if self._kv is not None:
            return self._kv.membership()
        from ..kvstore.base import MembershipInfo
        return MembershipInfo(elastic=False, epoch=0, live=1, rank=0)

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
        # a streamed exchange ran inside the gap (during backward): its
        # metered hook time is wire, not compute
        overlap_wire = (self._stream.hook_seconds
                        if self._stream is not None else None)
        if compute is not None and overlap_wire:
            compute = max(0.0, compute - overlap_wire)
        win0 = last if last is not None else time.monotonic()
        if _health.enabled():
            self._health_pre_step(n)
        t0 = time.perf_counter()
        try:
            with _tracing.step_span(metric=_tm_step_time):
                self._step_impl(batch_size, ignore_stale_grad)
        finally:
            self._last_step_end = time.monotonic()
        rec = self._ledger.on_step(win0, self._last_step_end,
                                   trace_id=_tracing.last_trace_id())
        _introspect.end_step(n, time.perf_counter() - t0,
                             compute_seconds=compute,
                             overlap_wire_seconds=overlap_wire,
                             trainer=self._introspect_label, ledger=rec)
        # health before the profiling boundary: an anomaly this step
        # arms its autocapture window in time to open at this boundary
        if _health.enabled():
            self._health_post_step(n)
        _profiling.step_boundary(label=self._introspect_label)
        # arm the next step's streamed exchange
        self._arm_overlap()

    def _step_impl(self, batch_size, ignore_stale_grad):
        self._optimizer.rescale_grad = 1.0 / batch_size
        if self._kv is not None and self._update_on_kvstore:
            self._kv_step()
            return
        self._allreduce_grads()
        with _tracing.span("compute"):
            self._update(ignore_stale_grad)

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
        # the cross-worker divergence audit over the dist kvstore
        live = self.membership.live or 1
        if self._health.audit_due(n) and live >= 2 \
                and hasattr(self._kv, "audit_exchange"):
            digest = _health.checksum([p._data for p in self._params])
            try:
                maps = self._kv.audit_exchange(n, digest) or {}
            except Exception:   # noqa: BLE001 — the audit is advisory
                maps = {}
            for aid in sorted(maps):
                self._health.note_audit(aid, "workers", maps[aid],
                                        expected=live)

    def _bitflip_weight(self):
        """Flip the lowest mantissa bit of the first weight element (the
        low byte, little-endian): a silent corruption that is never a
        NaN or an Inf."""
        w = self._params[0]._data
        with torch.no_grad():
            b = w.reshape(-1)[:1].view(torch.uint8)
            b[0] = b[0] ^ 1

    def _resident_state_bytes(self):
        """Worker-resident optimizer-state bytes: zero on the
        update-on-kvstore path (the servers hold the state)."""
        total = 0
        for st in self._states:
            for x in (st if isinstance(st, tuple) else (st,)):
                if isinstance(x, NDArray):
                    total += x._data.numel() * x._data.element_size()
        return total

    @staticmethod
    def _statusz_of(tr):
        led = tr._ledger.summary()["window"]
        m = tr.membership
        out = {"kvstore": tr._kvstore_type,
               "goodput": {"fraction": led["goodput_fraction"],
                           "mfu": led["mfu"]},
               "update_on_kvstore": bool(tr._update_on_kvstore),
               "params": len(tr._params), "steps": tr._step_count,
               "optimizer_state_bytes": tr._resident_state_bytes(),
               "overlap": {"enabled": bool(tr._overlap),
                           "armed": tr._stream is not None,
                           "last_fraction": tr._last_overlap},
               "membership": {"elastic": bool(m.elastic),
                              "epoch": m.epoch, "live": m.live,
                              "rank": m.rank}}
        if _health.enabled() and tr._health is not None:
            out["health"] = tr._health.summary()
        return out

    # -- the kvstore exchange --------------------------------------------
    def allreduce_grads(self):
        """Sum the gradients over the dist workers (nothing to do on one
        device or a fixed fleet of one)."""
        self._allreduce_grads()

    def _exchange(self, fn):
        """Run one kvstore exchange under one exchange scope; a
        transport error becomes one clean error."""
        with self._kv.exchange_scope():
            try:
                return fn()
            except (ConnectionError, OSError) as e:
                raise _kv_step_error(e) from e

    def _allreduce_grads(self):
        from ..kvstore import hierarchy as _hier
        relay = _hier.relay()
        if self._kv is None and relay is None:
            return
        if relay is None and getattr(self._kv, "num_workers", 1) <= 1:
            return
        grads = [p.grad() for p in self._params]
        bucketer = self._grad_bucketer()
        # a stream armed for the update-on-kvstore path pulls weights
        stream = None if self._update_on_kvstore else self._take_stream()

        def exchange():
            if stream is not None:
                stream.finish(grads)
                self._last_overlap = stream.overlap_fraction
            elif bucketer is not None and not any(
                    g.stype != "default" for g in grads):
                bucketer.allreduce(grads)
            else:
                for i, g in enumerate(grads):
                    self._kv.pushpull(i, g, out=g)

        if relay is not None and not relay.is_leader:
            try:
                return exchange()
            except (ConnectionError, OSError) as e:
                raise _kv_step_error(e) from e
        self._exchange(exchange)

    def _kv_step(self):
        """The update-on-kvstore step: push the gradients scaled by
        1/batch_size, pull the servers' updated weights."""
        self._init_kv_params()
        scale = self._optimizer.rescale_grad
        stream = self._take_stream()
        if stream is not None and stream.scale != scale:
            # the streamed pushes already carry the last step's scale
            stream.abort()
            raise MXNetError(
                f"MXNET_KV_OVERLAP=1 streamed this step's gradients "
                f"scaled by {stream.scale!r} but step() was called with "
                f"scale {scale!r} — the overlapped update-on-kvstore "
                f"path needs a constant batch size; use "
                f"MXNET_KV_OVERLAP=0 for variable batches")
        weights = [p.data() for p in self._params]

        def exchange():
            if stream is not None:
                stream.finish(weights)
                self._last_overlap = stream.overlap_fraction
            elif self._kv_bucketer is not None:
                from ..kvstore import hierarchy as _hier
                relay = _hier.relay()
                grads = [p.grad() for p in self._params]
                if relay is not None:
                    relay.update_exchange(self._kv_bucketer, grads,
                                          weights, scale)
                else:
                    self._kv_bucketer.push(grads, scale=scale)
                    self._kv_bucketer.pull(weights)
            else:
                idx = list(range(len(self._params)))
                self._kv.push_multi(
                    idx, [p.grad() * scale for p in self._params])
                self._kv.pull_multi(idx, weights)

        self._exchange(exchange)

    # -- streamed exchange (MXNET_KV_OVERLAP) --------------------------
    def _take_stream(self):
        """Detach the armed stream (one-shot) and drop the watch."""
        stream, self._stream = self._stream, None
        if stream is not None:
            from .. import autograd as _ag
            _ag.unwatch_grad_ready()
        return stream

    def _arm_overlap(self):
        """Arm the next step's streamed exchange over a wire that
        exists, with bucket keys already initialized."""
        if not self._overlap or self._kv is None \
                or self._stream is not None:
            return
        from ..kvstore import hierarchy as _hier
        if _hier.relay() is not None:
            return
        if self._update_on_kvstore:
            bucketer = self._kv_bucketer
            if bucketer is None or not self._kv_initialized:
                return
            scale = self._optimizer.rescale_grad
        else:
            if getattr(self._kv, "num_workers", 1) <= 1:
                return
            bucketer = self._grad_bucketer()
            if bucketer is None or not bucketer._inited:
                return
            scale = None
        stream = bucketer.stream(lambda j: self._params[j].grad(), scale)
        if stream is None:
            return
        from .. import autograd as _ag
        _ag.watch_grad_ready([p._data for p in self._params],
                             stream.ready, on_backward=stream.on_backward)
        self._stream = stream

    # -- gradient buckets ----------------------------------------------
    def _bucket_items(self):
        """[(index, shape, dtype)] typed by the gradient's dtype (the
        weight's before the first backward)."""
        from ..kvstore.bucket import dtype_str
        items = []
        for i, p in enumerate(self._params):
            g = p._data.grad
            dt = dtype_str((g if g is not None else p._data).dtype)
            items.append((i, tuple(p.shape), dt))
        return tuple(items)

    def _grad_bucketer(self):
        """The allreduce path's bucketer; None when bucketing is off or
        a gradient is sparse."""
        if self._bucketer is False:
            return None
        if self._bucketer is None:
            self._bucketer = self._make_bucketer() or False
        return self._bucketer or None

    def _make_bucketer(self):
        from ..kvstore.bucket import GradientBucketer, bucket_target_bytes
        if bucket_target_bytes() <= 0 or not self._params:
            return None
        if any(p._data.grad is not None and p._data.grad.is_sparse
               for p in self._params):
            return None
        return GradientBucketer(self._kv, self._bucket_items())

    def _uniform_multipliers(self):
        """A flat bucket takes one lr and wd: only without per-parameter
        multipliers."""
        o = self._optimizer
        return (not o.lr_mult and not o.wd_mult and all(
            getattr(p, "lr_mult", 1.0) == 1.0
            and getattr(p, "wd_mult", 1.0) == 1.0 for p in self._params))

    def _step_bucketable(self):
        if not self._uniform_multipliers():
            return False
        if type(self._optimizer).__name__.lower() \
                not in opt.ELEMENTWISE_OPTS:
            return False
        return all(p._data.grad is None
                   or p._data.grad.dtype == p._data.dtype
                   for p in self._params)

    def _ship_optimizer(self):
        """The optimizer, without its parameters and with rescale 1
        (workers scale before pushing), pickled to the servers."""
        import copy
        pd, self._optimizer.param_dict = self._optimizer.param_dict, {}
        try:
            o = copy.deepcopy(self._optimizer)
        finally:
            self._optimizer.param_dict = pd
        o.rescale_grad = 1.0
        self._kv.set_optimizer(o)

    def _init_kv_params(self):
        if self._kv_initialized or self._kv is None:
            return
        if self._update_on_kvstore and self._step_bucketable():
            self._kv_bucketer = self._make_bucketer()
        from ..kvstore import zero as _zero
        if self._update_on_kvstore and self._kv_bucketer is None \
                and _zero.enabled():
            raise MXNetError(
                "MXNET_KV_ZERO needs the bucketed update-on-kvstore "
                "path, which this config cannot use: it requires an "
                "elementwise optimizer "
                f"({', '.join(opt.ELEMENTWISE_OPTS)}), uniform "
                "lr_mult/wd_mult, matching weight/grad dtypes, dense "
                "gradients, and MXNET_KV_BUCKET_KB > 0 — adjust the "
                "config or unset MXNET_KV_ZERO")
        from ..kvstore import hierarchy as _hier
        relay = _hier.relay()
        if relay is not None and not relay.is_leader \
                and self._update_on_kvstore:
            # a ZeRO-2 relay member: the leader initializes the servers
            self._kv_initialized = True
            return
        if self._kv_bucketer is not None:
            self._kv_bucketer.init([p.data() for p in self._params])
        else:
            for i, p in enumerate(self._params):
                self._kv.init(i, p.data())
        if self._update_on_kvstore:
            self._ship_optimizer()
        self._kv_initialized = True

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


def _kv_step_error(e):
    """A transport error escaping the kvstore exchange: one clean error
    (the fixed fleet has no retry layer; ROADMAP item 10b)."""
    return MXNetError(
        f"kvstore gradient exchange failed after retry exhaustion "
        f"(see MXNET_KV_MAX_RETRIES / MXNET_KV_BACKOFF_MS): {e}")


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
