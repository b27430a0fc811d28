"""Vision model zoo: `get_model` over the registry of `models/`, the
route `bench.py`'s `bench_resnet50` takes to its model, and the model
classes under the JAX package's names."""
from ....models import get_model
from ....models.lenet import LeNet  # noqa: F401
from ....models.mlp import MLP  # noqa: F401
from ....models.resnet import *  # noqa: F401,F403
