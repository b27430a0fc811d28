"""Legacy FeedForward model API (counterpart of
`incubator_mxnet_tpu/model.py`): the pre-Module training façade that
0.x-era scripts use, a thin veneer over `mod.Module`, and the
checkpoint pair `save_checkpoint`/`load_checkpoint`."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Symbol JSON + params file pair (ref: model.save_checkpoint [U])."""
    from .ndarray import save as nd_save
    symbol.save(f"{prefix}-symbol.json")
    payload = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    payload.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    nd_save(f"{prefix}-{epoch:04d}.params", payload)
    return f"{prefix}-symbol.json", f"{prefix}-{epoch:04d}.params"


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) from a checkpoint pair."""
    from .symbol import load as sym_load
    from .ndarray import load as nd_load
    sym = sym_load(f"{prefix}-symbol.json")
    loaded = nd_load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return sym, arg_params, aux_params


class FeedForward:
    """Deprecated-in-reference but present training façade: fit/predict
    over a Symbol (ref: model.FeedForward [U])."""

    def __init__(self, symbol, ctx=None, num_epoch=None, optimizer="sgd",
                 initializer=None, arg_params=None, aux_params=None,
                 begin_epoch=0, **optimizer_params):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.optimizer_params = {
            k: v for k, v in optimizer_params.items()
            if k in ("learning_rate", "momentum", "wd", "clip_gradient")}
        self._module = None

    # -- training ----------------------------------------------------------
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            batch_end_callback=None, epoch_end_callback=None, logger=None):
        from .module import Module
        from . import io as mx_io
        train_iter = X if not hasattr(X, "shape") else \
            mx_io.NDArrayIter(X, y, batch_size=min(128, X.shape[0]))
        label_names = tuple(n for n in self.symbol.list_arguments()
                            if n.endswith("label")) or ("softmax_label",)
        self._module = Module(self.symbol, data_names=("data",),
                              label_names=label_names, context=self.ctx,
                              logger=logger)
        self._module.fit(
            train_iter, eval_data=eval_data, eval_metric=eval_metric,
            optimizer=self.optimizer, optimizer_params=self.optimizer_params,
            initializer=self.initializer,
            arg_params=self.arg_params, aux_params=self.aux_params,
            begin_epoch=self.begin_epoch,
            num_epoch=self.num_epoch or 1,
            batch_end_callback=batch_end_callback,
            epoch_end_callback=epoch_end_callback)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    @classmethod
    def create(cls, symbol, X, y=None, **kwargs):
        """Construct AND fit in one call (ref: FeedForward.create [U])."""
        return cls(symbol, **kwargs).fit(X, y)

    # -- inference ---------------------------------------------------------
    def predict(self, X, num_batch=None):
        import numpy as _np
        from . import io as mx_io
        from .ndarray import zeros as nd_zeros
        if self.arg_params is None:
            if self._module is not None:
                self.arg_params, self.aux_params = self._module.get_params()
            else:
                raise MXNetError("FeedForward: fit (or load) before predict")
        data_iter = X if not hasattr(X, "shape") else \
            mx_io.NDArrayIter(X, batch_size=min(128, X.shape[0]))
        label_names = [n for n in self.symbol.list_arguments()
                       if n.endswith("label")]
        binds = dict(self.arg_params)
        binds.update(self.aux_params or {})
        outs = []
        data_iter.reset()
        for i, batch in enumerate(data_iter):
            if num_batch is not None and i >= num_batch:
                break
            data = batch.data[0]
            b = dict(binds, data=data)
            for ln in label_names:   # outputs ignore label VALUES
                b.setdefault(ln, nd_zeros((data.shape[0],),
                                          ctx=data.context))
            out = self.symbol.eval_with(b)
            out = out[0] if isinstance(out, list) else out
            outs.append(out.asnumpy())
        return _np.concatenate(outs, axis=0)

    def score(self, X, eval_metric="acc"):
        from . import metric as metric_mod
        m = metric_mod.create(eval_metric) if isinstance(eval_metric, str) \
            else eval_metric
        return self._module.score(X, m)

    # -- checkpointing -----------------------------------------------------
    def save(self, prefix, epoch=None):
        if self.arg_params is None and self._module is not None:
            self.arg_params, self.aux_params = self._module.get_params()
        return save_checkpoint(prefix, epoch if epoch is not None
                               else (self.num_epoch or 0), self.symbol,
                               self.arg_params, self.aux_params)

    @classmethod
    def load(cls, prefix, epoch, ctx=None, **kwargs):
        sym, args, aux = load_checkpoint(prefix, epoch)
        return cls(sym, ctx=ctx, arg_params=args, aux_params=aux,
                   begin_epoch=epoch, **kwargs)
