"""contrib namespace (counterpart of `incubator_mxnet_tpu/contrib/`):
`amp` and the control-flow operators `foreach`, `while_loop` and
`cond`.  `quantization` and `onnx` are not ported yet: they come with
the int8 ops (ROADMAP item 12)."""
from .. import amp
from .control_flow import foreach, while_loop, cond

__all__ = ["amp", "foreach", "while_loop", "cond"]
