"""Parallel training (counterpart of `incubator_mxnet_tpu/parallel/`): the
fused `ParallelTrainer` step on a one-device mesh so far, and the
sharded checkpoint files."""
from .mesh import Mesh, default_mesh
from .trainer import ParallelTrainer
from .checkpoint import save_sharded, load_sharded

__all__ = ["Mesh", "default_mesh", "ParallelTrainer", "save_sharded",
           "load_sharded"]
