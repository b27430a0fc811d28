"""Runtime feature detection (counterpart of
`incubator_mxnet_tpu/runtime.py`; MXNet's `runtime.Features` over
MXLibInfoFeatures).

The JAX package's feature names stay where they apply, with their
answer here (no TPU, no XLA); the card's own features are added:
``CUDA`` (a card is visible), ``CUDNN``, ``NVCC`` (the CUDA compiler the
hand kernels are built with at first use), one ``KERNEL_<NAME>`` per
hand-kernel library already built on disk (`_kernels.SOURCES`),
``HOST_NATIVE`` (the port's host C++ library of JPEG codec, RecordIO,
record pipeline, engine and storage pool, built on disk) and ``C_ABI`` (the framework-free
libmxtorch_infer of `_native.build_native` built on disk).
"""
from __future__ import annotations

import os

__all__ = ["Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _detect():
    import torch
    from . import _kernels, _native
    cuda = torch.cuda.is_available()
    feats = {
        "TPU": False,
        "XLA": False,
        "CPU": True,
        "CUDA": cuda,
        "CUDNN": bool(cuda and torch.backends.cudnn.is_available()),
        "NVCC": _has_nvcc(),
        "MKLDNN": bool(torch.backends.mkldnn.is_available()),
        "OPENCV": False,        # the port decodes with its own codec
        "HOST_NATIVE": _host_native(),
        "DIST_KVSTORE": False,  # the distributed kvstore is not ported
        "PROFILER": True,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": True,
    }
    feats["RECORDIO_NATIVE"] = feats["HOST_NATIVE"]
    for name in _kernels.SOURCES:
        feats[f"KERNEL_{name.upper()}"] = os.path.exists(
            _kernels._target(name)[1])
    feats["C_ABI"] = os.path.exists(
        os.path.join(_native.native_dir(), "libmxtorch_infer.so"))
    return feats


def _has_nvcc():
    from . import _kernels
    try:
        _kernels._nvcc()
        return True
    except Exception:   # noqa: BLE001 — a probe must not raise
        return False


def _host_native():
    from . import _native
    return os.path.exists(_native._target())


class Features(dict):
    def __init__(self):
        super().__init__({k: Feature(k, v) for k, v in _detect().items()})

    def is_enabled(self, name):
        feat = self.get(name.upper())
        return bool(feat and feat.enabled)

    def __repr__(self):
        return str(list(self.values()))


def feature_list():
    return list(Features().values())
