"""Inputs for each op: the port's copy of the repository's op-sweep
input builder (`tests/test_op_sweep.py`'s `_build_case` and `SPEC`), in
numpy, for the core ops (`ops/math.py`, `ops/reduce.py`,
`ops/shape.py`, `ops/nn.py`, `ops/attention.py`) and the rest of the
registry (`ops/extended.py`, `ops/contrib.py`, `ops/linalg.py`).

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

__all__ = ["CORE_MODULES", "REST_MODULES", "core_names", "rest_names",
           "canonical_name", "build_case", "BF16_SKIP"]

CORE_MODULES = ("math", "reduce", "shape", "nn", "attention")
REST_MODULES = ("extended", "contrib", "linalg")

# ops the sweep runs in float32 only (its `bf16=False`): the
# factorizations (upstream registers them for float32 and float64
# only), CTC, the SSD decode and boolean_mask
BF16_SKIP = frozenset({"linalg_gelqf", "linalg_inverse", "linalg_potrf",
                       "linalg_slogdet", "linalg_syevd", "CTCLoss",
                       "_contrib_MultiBoxDetection", "_contrib_boolean_mask"})

_RNG = np.random.RandomState(7)


def X(shape, lo=0.5, hi=1.5, dtype=np.float32):
    return _RNG.uniform(lo, hi, shape).astype(dtype)


def I(shape, hi, dtype=np.float32):
    return _RNG.randint(0, hi, shape).astype(dtype)


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def SPD(*batch_n):
    """Symmetric positive definite (batch..., n, n)."""
    *b, n = batch_n
    a = _RNG.randn(*b, n, n).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) + 2 * np.eye(n, dtype=np.float32)


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
SPEC.update({
    "AdaptiveAvgPooling2D": (lambda: [X((2, 3, 8, 8))], {"output_size": 2}),
    "BilinearResize2D": (lambda: [X((2, 3, 8, 8))],
                         {"height": 4, "width": 4}),
    "BilinearSampler": (lambda: [X((2, 3, 6, 6)),
                                 X((2, 2, 4, 4), -0.9, 0.9)], {}),
    "CTCLoss": (lambda: [X((4, 2, 5)), I((2, 2), 4) + 1], {}),
    "Correlation": (lambda: [X((2, 3, 6, 6)), X((2, 3, 6, 6))],
                    {"kernel_size": 1, "max_displacement": 2,
                     "pad_size": 2}),
    "Crop": (lambda: [X((2, 3, 8, 8))], {"h_w": (4, 4), "center_crop": True}),
    "GridGenerator": (lambda: [X((2, 6))], {"target_shape": (4, 4)}),
    "LRN": (lambda: [X((2, 3, 5, 5))], {}),
    "ROIAlign": (lambda: [X((1, 3, 8, 8)),
                          np.array([[0, 1, 1, 6, 6], [0, 0, 0, 4, 4]],
                                   np.float32)],
                 {"pooled_size": (2, 2)}),
    "ROIPooling": (lambda: [X((1, 3, 8, 8)),
                            np.array([[0, 1, 1, 6, 6]], np.float32)],
                   {"pooled_size": (2, 2)}),
    "SpatialTransformer": (lambda: [X((1, 3, 8, 8)),
                                    np.array([[1, 0, 0, 0, 1, 0]],
                                             np.float32)],
                           {"target_shape": (4, 4)}),
    "UpSampling": (lambda: [X((2, 3, 4, 4))], {"scale": 2}),
    "_contrib_DeformableConvolution": (
        lambda: [X((1, 3, 6, 6)), X((1, 18, 4, 4), -0.1, 0.1),
                 X((4, 3, 3, 3)), X((4,))],
        {"kernel": (3, 3), "num_filter": 4}),
    "_contrib_MultiBoxDetection": (
        lambda: [_softmax(X((1, 2, 4)), 1), X((1, 16), -0.1, 0.1),
                 X((1, 4, 4), 0.1, 0.9)], {}),
    "_contrib_MultiBoxPrior": (lambda: [X((1, 3, 8, 8))],
                               {"sizes": (0.5,), "ratios": (1.0,)}),
    "_contrib_boolean_mask": (
        lambda: [X((4, 3)), np.array([1, 0, 1, 1], np.float32)], {}),
    "batch_take": (lambda: [X((3, 4)), I((3,), 4)], {}),
    "col2im": (lambda: [X((1, 12, 9))],
               {"output_size": (4, 4), "kernel": (2, 2)}),
    "depth_to_space": (lambda: [X((1, 4, 3, 3))], {"block_size": 2}),
    "fill_element_0index": (lambda: [X((2, 3)), X((2,)), I((2,), 3)], {}),
    "im2col": (lambda: [X((1, 3, 6, 6))], {"kernel": (2, 2)}),
    "index_add": (lambda: [X((4, 3)), I((2,), 4), X((2, 3))], {}),
    "index_copy": (lambda: [X((4, 3)), I((2,), 4), X((2, 3))], {}),
    "khatri_rao": (lambda: [X((3, 2)), X((4, 2))], {}),
    "linalg_det": (lambda: [SPD(2, 3)], {}),
    "linalg_gelqf": (lambda: [X((2, 3, 4))], {}),
    "linalg_extracttrian": (lambda: [SPD(2, 3)], {}),
    "linalg_gemm": (lambda: [X((2, 3, 4)), X((2, 4, 5)), X((2, 3, 5))], {}),
    "linalg_inverse": (lambda: [SPD(2, 3)], {}),
    "linalg_maketrian": (lambda: [X((2, 6))], {}),
    "linalg_potrf": (lambda: [SPD(2, 3)], {}),
    "linalg_potri": (lambda: [SPD(2, 3)], {}),
    "linalg_slogdet": (lambda: [SPD(2, 3)], {}),
    "linalg_syevd": (lambda: [SPD(2, 3)], {}),
    "linalg_trmm": (lambda: [SPD(3), X((3, 4))], {}),
    "linalg_trsm": (lambda: [SPD(3), X((3, 4))], {}),
    "multi_sgd_update": (
        lambda: [X((2, 3)), X((2, 3)), X((4,)), X((4,))],
        {"lrs": (0.1, 0.1), "wds": (0.0, 0.0), "num_weights": 2}),
    "multi_sgd_mom_update": (
        lambda: [X((2, 3)), X((2, 3)), X((2, 3)), X((4,)), X((4,)),
                 X((4,))],
        {"lrs": (0.1, 0.1), "wds": (0.0, 0.0), "momentum": 0.9,
         "num_weights": 2}),
    "ravel_multi_index": (lambda: [I((2, 3), 4)], {"shape": (4, 4)}),
    "space_to_depth": (lambda: [X((1, 3, 4, 4))], {"block_size": 2}),
    "unravel_index": (lambda: [I((3,), 12)], {"shape": (3, 4)}),
    "amp_multicast": (lambda: [X((2, 3)), X((2, 3))], {"num_outputs": 2}),
    "SVMOutput": (lambda: [X((4, 5)), I((4,), 5)], {}),
})
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


def rest_names():
    """Every name the port registers from `ops/extended.py`,
    `ops/contrib.py` and `ops/linalg.py`."""
    return sorted(n for n in registry.list_ops()
                  if registry.get_op(n).__module__.rsplit(".", 1)[-1]
                  in REST_MODULES)


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
