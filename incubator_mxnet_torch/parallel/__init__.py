"""Parallel training (counterpart of `incubator_mxnet_tpu/parallel/`): the
fused `ParallelTrainer` step on a one-device mesh so far."""
from .mesh import Mesh, default_mesh
from .trainer import ParallelTrainer

__all__ = ["Mesh", "default_mesh", "ParallelTrainer"]
