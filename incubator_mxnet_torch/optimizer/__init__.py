"""Optimizers and learning-rate schedulers (counterpart of
`incubator_mxnet_tpu/optimizer/`): the ten optimizers of its registry."""
from . import lr_scheduler
from .optimizer import (Optimizer, SGD, NAG, Adam, AdaGrad, RMSProp,
                        AdaDelta, Ftrl, Signum, LAMB, DCASGD, Updater,
                        get_updater, create, register, ELEMENTWISE_OPTS)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "Signum", "LAMB", "DCASGD", "Updater",
           "get_updater", "create", "register", "ELEMENTWISE_OPTS",
           "lr_scheduler"]
