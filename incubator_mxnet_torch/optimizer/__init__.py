"""Optimizers and learning-rate schedulers (counterpart of
`incubator_mxnet_tpu/optimizer/`): SGD and Adam so far."""
from . import lr_scheduler
from .optimizer import (Optimizer, SGD, Adam, Updater, get_updater, create,
                        register, ELEMENTWISE_OPTS)

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register", "ELEMENTWISE_OPTS", "lr_scheduler"]
