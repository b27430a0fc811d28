"""Inputs for each core op: the port's copy of the repository's op-sweep
input builder (`tests/test_op_sweep.py`'s `_build_case` and `SPEC`), in
numpy, for the ops of `ops/math.py`, `ops/reduce.py`, `ops/shape.py`,
`ops/nn.py` and `ops/attention.py`.

`build_case(name)` seeds one RandomState with the crc32 of the op's
first registered name and draws the inputs in the sweep's order, so the
arrays are the sweep's own (a test holds the two builders together);
`chip_smoke.py` runs every op on them on the card and on the CPU.  An op
without an entry takes float32 inputs uniform in [0.5, 1.5) of shape
(2, 3, 4), one per required input.
"""
from __future__ import annotations

import inspect
import zlib

import numpy as np

from ..ops import registry

__all__ = ["CORE_MODULES", "core_names", "canonical_name", "build_case"]

CORE_MODULES = ("math", "reduce", "shape", "nn", "attention")

_RNG = np.random.RandomState(7)


def X(shape, lo=0.5, hi=1.5, dtype=np.float32):
    return _RNG.uniform(lo, hi, shape).astype(dtype)


def I(shape, hi, dtype=np.float32):
    return _RNG.randint(0, hi, shape).astype(dtype)


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _tie_free_pair():
    """Two broadcastable arrays with |a - b| >= 0.05 everywhere."""
    a = _RNG.uniform(0.5, 1.5, (2, 3, 4)).astype(np.float32)
    b = _RNG.uniform(0.5, 1.5, (1, 3, 4)).astype(np.float32)
    near = np.abs(a - b) < 0.05
    a = np.where(near, b + np.where(a >= b, 0.1, -0.1), a).astype(np.float32)
    return [a, b]


# name: (inputs, attributes)
SPEC = {
    "_index": (lambda: [X((4, 6))],
               {"key_spec": ("__tuple__", ("__slice__", 1, 3, None),
                             ("__slice__", None, None, 2))}),
    "_fancy_index": (lambda: [X((4, 6)), I((3,), 4, np.int32)],
                     {"key_spec": ("__tuple__", ("__arr__", 0),
                                   ("__slice__", None, None, None))}),
    "BatchNorm": (lambda: [X((2, 3, 4, 4)), X((3,)), X((3,)), X((3,)),
                           X((3,))], {}),
    "Convolution": (lambda: [X((2, 3, 5, 5)), X((4, 3, 3, 3)), X((4,))],
                    {"kernel": (3, 3), "num_filter": 4}),
    "Deconvolution": (lambda: [X((2, 3, 5, 5)), X((3, 4, 3, 3))],
                      {"kernel": (3, 3), "num_filter": 4}),
    "FullyConnected": (lambda: [X((2, 12)), X((4, 12)), X((4,))],
                       {"num_hidden": 4}),
    "GroupNorm": (lambda: [X((2, 4, 5, 5)), X((4,)), X((4,))],
                  {"num_groups": 2}),
    "InstanceNorm": (lambda: [X((2, 3, 4, 4)), X((3,)), X((3,))], {}),
    "LayerNorm": (lambda: [X((2, 3, 4)), X((4,)), X((4,))], {}),
    "RMSNorm": (lambda: [X((2, 3, 4)), X((4,))], {}),
    "_contrib_interleaved_matmul_selfatt_qk": (
        lambda: [X((4, 2, 18))], {"heads": 2}),
    "_contrib_interleaved_matmul_selfatt_valatt": (
        lambda: [X((4, 2, 18)), _softmax(X((4, 4, 4)), -1)],
        {"heads": 2}),
    "_contrib_interleaved_matmul_encdec_qk": (
        lambda: [X((4, 2, 6)), X((5, 2, 12))], {"heads": 2}),
    "_contrib_interleaved_matmul_encdec_valatt": (
        lambda: [X((5, 2, 12)), _softmax(X((4, 4, 5)), -1)],
        {"heads": 2}),
    "batch_dot": (lambda: [X((2, 3, 4)), X((2, 4, 5))], {}),
    "broadcast_to": (lambda: [X((1, 3, 1))], {"shape": (2, 3, 4)}),
    "cast": (lambda: [X((2, 3))], {"dtype": "float16"}),
    "concat": (lambda: [X((2, 3, 4)), X((2, 3, 4))], {"dim": 1}),
    "dot": (lambda: [X((3, 4)), X((4, 5))], {}),
    "expand_dims": (lambda: [X((2, 3))], {"axis": 1}),
    "flip": (lambda: [X((2, 3, 4))], {"axis": 1}),
    "linalg_gemm2": (lambda: [X((2, 3, 4)), X((2, 4, 5))], {}),
    "multi_head_attention": (
        lambda: [X((2, 4, 8)), X((2, 4, 8)), X((2, 4, 8))],
        {"num_heads": 2}),
    "one_hot": (lambda: [I((4,), 5)], {"depth": 5}),
    "pad": (lambda: [X((1, 2, 3, 3))],
            {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)},),
    "pick": (lambda: [X((3, 4)), I((3,), 4)], {}),
    "repeat": (lambda: [X((2, 3))], {"repeats": 2}),
    "reshape": (lambda: [X((2, 3, 4))], {"shape": (4, 6)}),
    "scatter_nd": (lambda: [X((3,)), I((1, 3), 5)], {"shape": (5,)}),
    "slice": (lambda: [X((2, 3, 4))],
              {"begin": (0, 1, 0), "end": (2, 3, 3)}),
    "slice_axis": (lambda: [X((2, 3, 4))],
                   {"axis": 1, "begin": 0, "end": 2}),
    "softmax_cross_entropy": (lambda: [X((4, 5)), I((4,), 5)], {}),
    "split": (lambda: [X((2, 4, 3))], {"num_outputs": 2, "axis": 1}),
    "stack": (lambda: [X((2, 3)), X((2, 3))], {"axis": 0}),
    "tile": (lambda: [X((2, 3))], {"reps": (2, 1)}),
    "SoftmaxOutput": (lambda: [X((4, 5)), I((4,), 5)], {}),
    "BlockGrad": (lambda: [X((2, 3))], {}),
    "Embedding": (lambda: [I((4,), 5), X((5, 3))],
                  {"input_dim": 5, "output_dim": 3}),
    "broadcast_maximum": (_tie_free_pair, {}),
    "broadcast_minimum": (_tie_free_pair, {}),
    "arccos": (lambda: [X((2, 3), -0.8, 0.8)], {}),
    "arcsin": (lambda: [X((2, 3), -0.8, 0.8)], {}),
    "arctanh": (lambda: [X((2, 3), -0.8, 0.8)], {}),
    "arccosh": (lambda: [X((2, 3), 1.5, 2.5)], {}),
    "erfinv": (lambda: [X((2, 3), -0.5, 0.5)], {}),
}
for _s in ("_scalar_add", "_scalar_sub", "_scalar_mul", "_scalar_div",
           "_scalar_mod", "_scalar_power", "_scalar_maximum",
           "_scalar_minimum", "_scalar_equal", "_scalar_not_equal",
           "_scalar_greater", "_scalar_greater_equal", "_scalar_lesser",
           "_scalar_lesser_equal"):
    SPEC[_s] = (lambda: [X((2, 3))], {"scalar": 1.5})


def core_names():
    """Every name the port registers from the five core op modules."""
    return sorted(n for n in registry.list_ops()
                  if registry.get_op(n).__module__.rsplit(".", 1)[-1]
                  in CORE_MODULES)


def canonical_name(name):
    """The op's first registered name, as the sweep keys ops: the name
    its inputs are drawn for."""
    impl = registry.get_op(name)
    return next(n for n, op in registry._REGISTRY.items() if op is impl)


def _required_arity(impl):
    return sum(1 for p in inspect.signature(impl).parameters.values()
               if p.kind == p.POSITIONAL_OR_KEYWORD
               and p.default is p.empty)


def build_case(name):
    """(numpy inputs, attributes) for op `name`."""
    canon = canonical_name(name)
    _RNG.seed(zlib.crc32(canon.encode()) & 0x7FFFFFFF)
    if canon in SPEC:
        make, attrs = SPEC[canon]
        return make(), dict(attrs)
    n = _required_arity(registry.get_op(canon))
    return [X((2, 3, 4)) for _ in range(n)], {}
