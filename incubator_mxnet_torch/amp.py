"""AMP: automatic mixed precision (counterpart of
`incubator_mxnet_tpu/amp.py`).

While `init(target_dtype)` holds, the registry's eager dispatch casts
the floating inputs of the matmul-class ops (`TARGET_DTYPE_OPS`) to the
target dtype and those of the numerically sensitive ones (`FP32_OPS`)
to float32 (`policy_for`).  bfloat16 keeps float32's exponent range, so
loss scaling is optional there; `LossScaler` and `scale_loss` serve
float16.  The symbolic executor interprets its graph without the
policy, as the JAX package's does.
"""
from __future__ import annotations

import threading

from .base import MXNetError
from .ops import registry as _registry

__all__ = ["init", "disable", "init_trainer", "scale_loss", "unscale",
           "LossScaler", "convert_model", "amp_active", "policy_for",
           "TARGET_DTYPE_OPS", "FP32_OPS"]

# the matmul-class ops: run in the reduced dtype
TARGET_DTYPE_OPS = {
    "FullyConnected", "Convolution", "Deconvolution", "dot", "batch_dot",
    "multi_head_attention", "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt", "RNN",
}
# Embedding is left out: its float-encoded indices would lose integer
# precision above 256 in bfloat16.  Numerically sensitive: float32.
FP32_OPS = {
    "softmax", "log_softmax", "SoftmaxOutput", "norm", "LayerNorm",
    "BatchNorm", "InstanceNorm", "mean", "sum", "exp", "log",
}

_state = threading.local()


def amp_active():
    return getattr(_state, "cfg", None)


def _context_provider():
    """(token, None): the amp state a cached graph would be keyed by,
    as the JAX registry's context providers give it."""
    cfg = amp_active()
    if cfg is None:
        return None, None
    return ("amp", cfg["dtype"]), None


def policy_for(op_name):
    """The dtype amp casts `op_name`'s floating inputs to, or None."""
    cfg = amp_active()
    if cfg is None:
        return None
    if op_name in TARGET_DTYPE_OPS:
        return cfg["dtype"]
    if op_name in FP32_OPS:
        return "float32"
    return None


def init(target_dtype="bfloat16"):
    """Enable amp for this thread's eager op calls."""
    if target_dtype not in ("bfloat16", "float16"):
        raise MXNetError("target_dtype must be bfloat16 or float16")
    _state.cfg = {"dtype": target_dtype}
    _registry.amp_policy = policy_for


def disable():
    _state.cfg = None
    _registry.amp_policy = None


def init_trainer(trainer):
    """Attach dynamic loss scaling to a Trainer (float16 mode; bfloat16
    does not need it, but the API is honoured)."""
    trainer._amp_loss_scaler = LossScaler()
    return trainer


class LossScaler:
    """Dynamic loss scaler: halves the scale on an overflow, doubles it
    after `scale_window` steps without one."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        import numpy as _np
        for p in params:
            g = p.grad() if callable(getattr(p, "grad", None)) else p
            if not _np.isfinite(g.asnumpy().astype(_np.float32)).all():
                return True
        return False

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale *= self._factor
                self._unskipped = 0


class _ScaleLoss:
    def __init__(self, loss, trainer):
        self.trainer = trainer
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        self.scale = scaler.loss_scale if scaler else 1.0
        self.loss = loss * self.scale if self.scale != 1.0 else loss

    def __enter__(self):
        return self.loss

    def __exit__(self, *a):
        if self.scale != 1.0:
            self.trainer._optimizer.rescale_grad /= self.scale
        return False


def scale_loss(loss, trainer):
    """`with amp.scale_loss(loss, trainer) as scaled: scaled.backward()`"""
    return _ScaleLoss(loss, trainer)


def unscale(trainer):
    """Taken for the reference's API: `scale_loss` already divides the
    trainer's `rescale_grad` by the scale."""


def convert_model(block, target_dtype="bfloat16"):
    """Cast a block's parameters to the target dtype."""
    block.cast(target_dtype)
    return block
