"""Gluon: Blocks, Parameters, layers, losses and the Trainer on
`torch.nn.Module`."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock
from . import nn
from . import loss
from .trainer import Trainer
