"""Vision model zoo: `get_model` over the registry of `models/`, the
route `bench.py`'s `bench_resnet50` takes to its model."""
from ....models import get_model
from ....models.resnet import *  # noqa: F401,F403
