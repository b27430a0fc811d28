"""contrib namespace (counterpart of `incubator_mxnet_tpu/contrib/`):
`amp`, the control-flow operators `foreach`, `while_loop` and `cond`,
post-training int8 `quantization` and ONNX export/import (`onnx`, on
the hand-rolled wire codec `onnx_proto`)."""
from .. import amp
from .control_flow import foreach, while_loop, cond
from . import quantization, onnx, onnx_proto

__all__ = ["amp", "foreach", "while_loop", "cond", "quantization", "onnx",
           "onnx_proto"]
