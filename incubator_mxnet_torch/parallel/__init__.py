"""Parallelism over meshes of ranks (counterpart of
`incubator_mxnet_tpu/parallel/`).

One process a mesh device, joined by `init_distributed` (NCCL on the
card, gloo on the CPU, or the ``"host"`` transport for ranks that share
one card); each rank holds its blocks and the collectives stand where
the JAX program has them:

- data parallel: the batch cut over 'dp', gradients summed over it;
- tensor parallel: weights cut over 'tp' by the Megatron rules
  (`sharding.py`), the layers' partial sums over 'tp';
- sequence parallel: ring attention over 'sp' (`ring_attention.py`);
- pipeline parallel: the GPipe schedule over 'pp' (`pipeline.py`);
- expert parallel: experts over 'ep', tokens by all-to-all (`moe.py`).
"""
from .mesh import (Mesh, make_mesh, auto_axes, default_mesh, current_mesh,
                   init_distributed, mesh_from_shape, parse_mesh_shape,
                   mesh_scope, MESH_AXES)
from . import collectives
from .ring_attention import ring_attention, sequence_parallel_scope
from .sharding import (named_sharding, shard_params, replicate, ParamRules,
                       MEGATRON_RULES, TRANSFORMER_RULES, PartitionSpec)
from .trainer import ParallelTrainer
from .checkpoint import save_sharded, load_sharded
from .pipeline import (PipelineStage, pipeline_step, pipeline_scope,
                       current_pipeline, GPipeStack, bubble_fraction)
from .moe import MoELayer, moe_apply

__all__ = ["Mesh", "make_mesh", "auto_axes", "default_mesh", "current_mesh",
           "init_distributed", "mesh_from_shape", "parse_mesh_shape",
           "mesh_scope", "MESH_AXES", "collectives", "ring_attention",
           "sequence_parallel_scope", "named_sharding", "shard_params",
           "replicate", "ParamRules", "MEGATRON_RULES", "TRANSFORMER_RULES",
           "PartitionSpec", "ParallelTrainer", "save_sharded",
           "load_sharded", "PipelineStage", "pipeline_step",
           "pipeline_scope", "current_pipeline", "GPipeStack",
           "bubble_fraction", "MoELayer", "moe_apply"]
