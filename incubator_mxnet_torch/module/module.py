"""Module: bind a Symbol and train it (counterpart of
`incubator_mxnet_tpu/module/module.py`).

Each bound context gets one `Executor`, which interprets the graph on
that device and takes torch autograd for the backward.  The default
context is the current one (gpu(0) unless a `with cpu():` scope says
otherwise).  Several contexts split the batch and sum the gradients on
update; the parameters are NDArrays shared by the executors.  The
optimizer updates on this process for every kvstore whose name does not
start with "dist" ("local", "device", "nccl", None, ...), as the JAX
Module does; a `dist*` kvstore raises: the parameter server drives
`gluon.Trainer`, and Module over it is ROADMAP item 10c.
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import NDArray, zeros, concat
from .. import initializer as init_mod
from .. import optimizer as opt_mod
from .base_module import BaseModule

__all__ = ["Module", "save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """prefix-symbol.json + prefix-NNNN.params (ref: model.py
    save_checkpoint [U])."""
    from ..ndarray import save as nd_save
    if symbol is not None:
        with open(f"{prefix}-symbol.json", "w") as f:
            f.write(symbol.tojson())
    payload = {f"arg:{k}": v for k, v in arg_params.items()}
    payload.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd_save(f"{prefix}-{epoch:04d}.params", payload)


def load_checkpoint(prefix, epoch):
    from ..symbol import load as sym_load
    from ..ndarray import load as nd_load
    symbol = sym_load(f"{prefix}-symbol.json")
    loaded = nd_load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        kind, name = k.split(":", 1)
        (arg_params if kind == "arg" else aux_params)[name] = v
    return symbol, arg_params, aux_params


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=None, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        self._context = list(context)
        self._fixed_param_names = set(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        input_names = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._execs = []
        self._slices = []
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._updater = None
        self._data_shapes = None
        self._label_shapes = None
        self._inputs_need_grad = False

    # ------------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def label_names(self):
        return list(self._label_names)

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        data_shapes = _norm_shapes(data_shapes, self._data_names)
        label_shapes = _norm_shapes(label_shapes, self._label_names) \
            if label_shapes else []
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._inputs_need_grad = inputs_need_grad
        self.for_training = for_training

        shape_hints = {n: s for n, s in data_shapes + label_shapes}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shape_hints)
        arg_names = self._symbol.list_arguments()
        shape_of = dict(zip(arg_names, arg_shapes))
        aux_shape_of = dict(zip(self._aux_names, aux_shapes))

        if shared_module is not None:
            # BucketingModule path: share parameter/grad/aux arrays
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self._grad_arrays = shared_module._grad_arrays
        else:
            self._arg_params = {n: zeros(shape_of[n], ctx=self._context[0])
                                for n in self._param_names}
            self._aux_params = {n: zeros(aux_shape_of[n],
                                         ctx=self._context[0])
                                for n in self._aux_names}
            self._grad_arrays = {
                n: zeros(shape_of[n], ctx=self._context[0])
                for n in self._param_names
                if for_training and n not in self._fixed_param_names}

        n_dev = len(self._context)
        batch = data_shapes[0][1][0]
        if batch % n_dev:
            raise MXNetError(
                f"batch size {batch} not divisible by {n_dev} contexts")
        step = batch // n_dev
        self._slices = [slice(i * step, (i + 1) * step) for i in range(n_dev)]

        from ..executor import Executor
        self._execs = []
        for i, ctx in enumerate(self._context):
            args = dict(self._arg_params)
            for name, shp in data_shapes + label_shapes:
                args[name] = zeros((step,) + tuple(shp[1:]), ctx=ctx)
            grad_req_dict = {}
            for n in arg_names:
                if n in self._grad_arrays:
                    grad_req_dict[n] = grad_req
                elif inputs_need_grad and n in self._data_names:
                    grad_req_dict[n] = "write"
                else:
                    grad_req_dict[n] = "null"
            grads = {n: zeros(args[n].shape if n in args else shape_of[n],
                              ctx=ctx)
                     for n, r in grad_req_dict.items() if r != "null"}
            ex = Executor(self._symbol, ctx=ctx, args=args,
                          args_grad=grads, grad_req=grad_req_dict,
                          aux_states=dict(self._aux_params))
            self._execs.append(ex)
        self.binded = True

    # ------------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("init_params: call bind first")
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        elif isinstance(initializer, str):
            initializer = init_mod.create(initializer)
        for name, arr in self._arg_params.items():
            if arg_params is not None and name in arg_params:
                _set(arr, arg_params[name])
            else:
                if arg_params is not None and not allow_missing:
                    raise MXNetError(f"init_params: missing {name}")
                _init(initializer, name, arr)
        for name, arr in self._aux_params.items():
            if aux_params is not None and name in aux_params:
                _set(arr, aux_params[name])
            else:
                _init(initializer, name, arr)
        self.params_initialized = True

    def get_params(self):
        return ({k: v.copy() for k, v in self._arg_params.items()},
                {k: v.copy() for k, v in self._aux_params.items()})

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params and self._data_shapes:
                # ref: Module.init_optimizer defaults rescale_grad to
                # 1/batch_size [U]
                optimizer_params["rescale_grad"] = \
                    1.0 / self._data_shapes[0][1][0]
            optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer = optimizer
        idx2name = {i: n for i, n in enumerate(sorted(self._grad_arrays))}
        optimizer.param_idx2name = idx2name
        self._updater = opt_mod.get_updater(optimizer)
        kv_name = kvstore if isinstance(kvstore, str) or kvstore is None \
            else getattr(kvstore, "type", str(kvstore))
        if kv_name is not None and kv_name.startswith("dist"):
            raise MXNetError(
                f"kvstore {kv_name!r}: Module over the parameter server is "
                "not ported yet (ROADMAP item 10c); use kvstore='local', "
                "or gluon.Trainer(..., kvstore='dist_sync')")
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        datas = data_batch.data
        labels = data_batch.label or []
        for ex, sl in zip(self._execs, self._slices):
            feed = {}
            for name, arr in zip(self._data_names, datas):
                feed[name] = arr[sl] if len(self._execs) > 1 else arr
            for name, arr in zip(self._label_names, labels):
                feed[name] = arr[sl] if len(self._execs) > 1 else arr
            ex.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        for ex in self._execs:
            ex.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        if len(self._execs) == 1 or not merge_multi_context:
            return list(self._execs[0].outputs)
        n_out = len(self._execs[0].outputs)
        return [concat(*[ex.outputs[i] for ex in self._execs], dim=0)
                for i in range(n_out)]

    def get_input_grads(self, merge_multi_context=True):
        if not self._inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        grads = []
        for name in self._data_names:
            per_dev = [ex.grad_dict[name] for ex in self._execs]
            grads.append(per_dev[0] if len(per_dev) == 1
                         else concat(*per_dev, dim=0))
        return grads

    def update(self):
        if self._updater is None:
            raise MXNetError("init_optimizer first")
        names = sorted(self._grad_arrays)
        for i, name in enumerate(names):
            grads = [ex.grad_dict[name] for ex in self._execs
                     if name in ex.grad_dict]
            total = grads[0]
            for g in grads[1:]:
                total = total + g
            self._updater(i, total, self._arg_params[name])

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        arg_p, aux_p = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_p, aux_p)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        mod = Module(symbol, **kwargs)
        mod._preloaded = (arg_params, aux_params)
        mod._preloaded_states = f"{prefix}-{epoch:04d}.states" \
            if load_optimizer_states else None
        return mod

    def _maybe_load_preloaded(self):
        if getattr(self, "_preloaded", None) is not None:
            arg_params, aux_params = self._preloaded
            self.init_params(arg_params=arg_params, aux_params=aux_params,
                             allow_missing=False, force_init=True)
            self._preloaded = None

    def fit(self, train_data, **kwargs):
        if getattr(self, "_preloaded", None) is not None and \
                kwargs.get("arg_params") is None:
            kwargs["arg_params"] = self._preloaded[0]
            kwargs["aux_params"] = self._preloaded[1]
            kwargs.setdefault("allow_missing", False)
            self._preloaded = None
        return super().fit(train_data, **kwargs)


def _set(arr, value):
    """Write `value` (an NDArray or tensor) into parameter array `arr`
    on its device; the array takes `value`'s dtype (a bfloat16
    checkpoint binds bfloat16 parameters), as the JAX Module rebinds
    it."""
    t = value._data if isinstance(value, NDArray) else value
    arr._assign(t.to(device=arr._data.device))


def _init(initializer, name, arr):
    """Fill `arr` with `initializer` as it fills a parameter `name`: in
    float32, then cast to the array's dtype."""
    import torch
    t = torch.zeros(arr.shape, dtype=torch.float32, device=arr._data.device)
    initializer(init_mod.InitDesc(name), t)
    arr._assign(t.to(arr._data.dtype))


def _norm_shapes(shapes, names):
    """Accept [(name, shape)] or DataDesc-like or plain shapes."""
    out = []
    if shapes is None:
        return out
    for i, s in enumerate(shapes):
        if isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], str):
            out.append((s[0], tuple(s[1])))
        elif hasattr(s, "name") and hasattr(s, "shape"):
            out.append((s.name, tuple(s.shape)))
        else:
            out.append((names[i], tuple(s)))
    return out
