"""Framework RNG state: one `torch.Generator` per device.

PyTorch counterpart of `incubator_mxnet_tpu/random.py`.  `seed(n)`
reseeds every device's generator; initializers draw from the generator
of the device they fill, so `seed(n)` reproduces an initialization.
`np_rng()` is the framework's numpy `RandomState`, which the data
transforms draw from; `seed(n)` re-creates it from `n`, as the JAX
package does, so both packages give the same crops, flips and jitters
after the same seed.  The user's global torch and numpy RNGs stay
untouched.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

__all__ = ["seed", "generator", "np_rng"]

_lock = threading.Lock()
_seed = None
_generators = {}
_np_rng = None


def seed(seed_state):
    """Seed the framework RNG of every device and the framework's numpy
    RandomState."""
    global _seed, _np_rng
    with _lock:
        _seed = int(seed_state)
        _generators.clear()
        _np_rng = _np.random.RandomState(_seed)


def np_rng():
    """The framework's numpy RandomState (unseeded: from fresh entropy)."""
    global _np_rng
    with _lock:
        if _np_rng is None:
            _np_rng = _np.random.RandomState()
        return _np_rng


def generator(device):
    """The framework's `torch.Generator` for `device`, created on first
    use from the last `seed()` (unseeded: from fresh entropy)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            if _seed is None:
                gen.seed()
            else:
                gen.manual_seed(_seed)
            _generators[device] = gen
        return gen
