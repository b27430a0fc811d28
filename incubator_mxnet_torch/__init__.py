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
from . import models
from . import rtc
from . import operator
from . import io
from . import recordio
from . import metric
from . import callback
from . import image

__version__ = "0.1.0"
