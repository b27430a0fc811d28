"""incubator_mxnet_torch: the MXNet 1.x API of `incubator_mxnet_tpu`,
ported to PyTorch and hand-written CUDA kernels for an NVIDIA H100.

It keeps the JAX package's module names and layout, so each module's
counterpart is easy to find, and imports nothing of JAX or of the JAX
package.  Entry points run on `gpu(0)` (the CUDA card) unless the caller
asks for `cpu()`; without CUDA they raise instead of carrying on on the
CPU.

It serves and trains BERT and trains ResNet v1/v1b: Gluon blocks on
`torch.nn.Module` (Dense, LayerNorm, Conv2D, BatchNorm, pooling), the
BERT and ResNet models, `deploy.export_serving`/`load_serving` and the
`serving.ServingRuntime` front end; `autograd`, the losses, SGD and
Adam, `gluon.Trainer` and `parallel.ParallelTrainer` on one device.
Data comes in through `io` (the iterators and `DevicePrefetcher`, the
host-to-card staging ring), `gluon.data` (datasets, the DataLoader with
thread or process workers) and `recordio`; `metric`, `callback` and
`gluon.contrib.estimator` are the training-loop helpers, and `image`
holds the array helpers of the transforms.
The symbolic and legacy API: `sym` (Symbol graphs over the same op
registry, `-symbol.json` files), `executor`, `mod` (Module,
BucketingModule), `model` (FeedForward), `rnn` (the symbolic cells),
`amp`, `monitor`, `viz`, `subgraph` and `contrib` (control flow);
`HybridBlock.export` and `gluon.SymbolBlock`.  `mxnet_alias` puts the
package under the name `mxnet` (`python -m incubator_mxnet_torch.run
SCRIPT` runs a stock example on it).
The runtime planes account for a step: `goodput` (the step ledger's
wall-clock buckets, MFU, the card's memory peak), `health` (numerics
stats, anomalies, the fault plan), `profiling` and `profiler` (device
timelines from torch.profiler), `compile_cache` (AOTInductor packages
kept across exports), `tuner` (winner files), with `engine` and
`storage` (the host dependency engine and pooled host memory, C++ in
`csrc/`), `resource`, `runtime` (`Features`) and `test_utils`; both
trainers, `io`, `callback.Speedometer` and serving's debugz pages read
them.
Attention runs in the CUDA kernels of `ops/flash_attention.py`;
`tools.bottleneck_bwd` is the ResNet bottleneck's fused BN backward in
two CUDA kernels (`python -m incubator_mxnet_torch.tools.bottleneck_bwd`).
"""
from .base import MXNetError, get_env
from .context import Context, cpu, gpu, current_context, num_gpus
from . import random
from .random import seed
from . import autograd
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import initializer
from . import initializer as init
from . import optimizer
from .optimizer import lr_scheduler
from . import gluon
from . import parallel
from . import kvstore
from . import kvstore as kv
from . import models
from . import rtc
from . import operator
from . import io
from . import recordio
from . import metric
from . import callback
from . import image
from . import telemetry
from . import tracing
from . import introspect
from . import goodput
from . import health
from . import profiling
from . import profiler
from . import compile_cache
from . import tuner
from . import engine
from . import storage
from . import resource
from . import runtime
from . import test_utils
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import executor
from . import module
from . import module as mod
from .module import Module
from . import model
from . import rnn
from . import amp
from . import monitor
from . import visualization
from . import visualization as viz
from . import subgraph
from . import contrib

ndarray._install_control_flow()

__version__ = "0.1.0"
