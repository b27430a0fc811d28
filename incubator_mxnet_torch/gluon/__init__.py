"""Gluon: Blocks, Parameters, layers, recurrent layers and cells, the
contrib layers and Estimator, losses, utilities and the Trainer on
`torch.nn.Module`, and `data` (datasets, samplers, the DataLoader, the
vision datasets and transforms)."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import loss
from .trainer import Trainer
from . import utils
from .utils import split_and_load
from . import rnn
from . import contrib
from . import data
