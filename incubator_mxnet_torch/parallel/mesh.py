"""Device meshes (counterpart of `incubator_mxnet_tpu/parallel/mesh.py`).

The port runs on one device so far: `default_mesh()` is a one-device
'dp' mesh on the current context (gpu(0) unless a `with cpu():` scope or
`ctx=` says otherwise).  Meshes over several cards (a torch
`DeviceMesh`, NCCL collectives) come with the multi-GPU slice; asking
for one raises until then.
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import as_device

__all__ = ["Mesh", "default_mesh"]


class Mesh:
    """A mesh of one device (`device`, a `torch.device`) with the single
    axis 'dp'."""

    def __init__(self, device):
        self.device = device

    def __repr__(self):
        return f"Mesh(dp=1, device={self.device})"


def default_mesh(n_devices=None, ctx=None):
    """A one-device 'dp' mesh on `ctx` (default: the current context)."""
    if n_devices not in (None, 1):
        raise MXNetError(
            f"default_mesh({n_devices}): meshes over several devices come "
            f"with the multi-GPU slice, not ported yet")
    return Mesh(as_device(ctx))
