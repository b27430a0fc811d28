"""BucketingModule: per-sequence-length executors sharing one weight
set (counterpart of `incubator_mxnet_tpu/module/bucketing_module.py`).
Each bucket key gets its own Module bound to the same parameter,
gradient and auxiliary arrays and the same optimizer, so switching
buckets is a dict lookup, not a rebind."""
from __future__ import annotations

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=None,
                 context=None, fixed_param_names=None, state_names=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key is required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._init_args = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    # ------------------------------------------------------------------
    def _gen_module(self, bucket_key, data_shapes, label_shapes,
                    shared_module=None):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(sym, data_names=data_names, label_names=label_names,
                     logger=self.logger, context=self._context,
                     fixed_param_names=self._fixed_param_names)
        mod.bind(data_shapes, label_shapes,
                 for_training=self.for_training,
                 shared_module=shared_module)
        return mod

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        mod = self._gen_module(self._default_bucket_key, data_shapes,
                               label_shapes)
        self._buckets[self._default_bucket_key] = mod
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        if not self.binded:
            raise MXNetError("switch_bucket: call bind first")
        if bucket_key not in self._buckets:
            master = self._buckets[self._default_bucket_key]
            self._buckets[bucket_key] = self._gen_module(
                bucket_key, data_shapes, label_shapes, shared_module=master)
            self._buckets[bucket_key].params_initialized = True
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # -- delegate everything to the current bucket's module -------------
    def init_params(self, **kwargs):
        self._curr_module.init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        self._curr_module.init_optimizer(**kwargs)
        self._shared_optimizer = (self._curr_module._optimizer,
                                  self._curr_module._updater)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", self._default_bucket_key)
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        if not self._curr_module.optimizer_initialized and \
                self.optimizer_initialized:
            self._curr_module._optimizer, self._curr_module._updater = \
                self._shared_optimizer
            self._curr_module.optimizer_initialized = True
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_params(self):
        return self._curr_module.get_params()

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)
