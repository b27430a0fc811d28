"""Module: the legacy symbolic training API (counterpart of
`incubator_mxnet_tpu/module/`): `BaseModule.fit`/`score`/`predict`,
`Module` (bind → init_params → init_optimizer →
forward/backward/update) and `BucketingModule` (one executor per
sequence-length bucket, the parameters shared)."""
from .base_module import BaseModule
from .module import Module, load_checkpoint, save_checkpoint
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule", "load_checkpoint",
           "save_checkpoint"]
