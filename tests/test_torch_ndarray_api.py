"""The port's NDArray surface and `nd` namespace against the JAX
package's: operators, methods, conversions, creation functions, the
`nd.contrib` namespace and the DLPack hand-off.

Each case is one expression run on both packages from the same numpy
inputs on the CPU; values and dtypes must agree.  Tolerance: rtol 1e-6
with atol 1e-6 of the largest value for float32 results (the same
float32 arithmetic); integer, bool and exactly representable results
are compared exactly by the same check.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import nd
from incubator_mxnet_torch.ops import registry as TR

RNG = np.random.RandomState(21)
A = RNG.uniform(0.5, 2.0, (2, 3)).astype(np.float32)
B = RNG.uniform(0.5, 2.0, (2, 3)).astype(np.float32)
M = RNG.uniform(-1.0, 1.0, (3, 4)).astype(np.float32)
I = np.array([[3, 1, 4], [1, 5, 2]], np.int32)
IDX = np.array([2, 0, 1], np.float32)


def _inputs(pkg):
    ctx = pkg.cpu()
    return {k: pkg.nd.array(v, ctx=ctx, dtype=v.dtype)
            for k, v in (("a", A), ("b", B), ("m", M), ("i", I),
                         ("idx", IDX))}


CASES = {
    "pow": lambda x: x["a"] ** x["b"],
    "rpow": lambda x: 2.0 ** x["a"],
    "mod": lambda x: x["a"] % x["b"],
    "rmod": lambda x: 5.0 % x["a"],
    "int_mod": lambda x: x["i"] % 3,
    "int_pow": lambda x: x["i"] ** 2,
    "matmul": lambda x: x["a"] @ x["m"],
    "abs_builtin": lambda x: abs(-x["a"]),
    "neg": lambda x: -x["i"],
    "sub_int_float": lambda x: x["i"] - x["a"],
    "div_int_int": lambda x: x["i"] / x["i"],
    "cmp_mixed": lambda x: x["i"] > x["a"],
    "eq_ndarray": lambda x: x["a"] == x["a"],
    "T": lambda x: x["m"].T,
    "copy": lambda x: x["a"].copy(),
    "reshape_like": lambda x: x["a"].reshape_like(x["m"][:, :2]),
    "transpose_axes": lambda x: x["m"].expand_dims(0).transpose((2, 0, 1)),
    "flatten": lambda x: x["m"].reshape((3, 2, 2)).flatten(),
    "broadcast_to": lambda x: x["a"][0:1].broadcast_to((4, 3)),
    "broadcast_like": lambda x: x["a"][:, 0:1].broadcast_like(x["a"]),
    "max": lambda x: x["m"].max(axis=1),
    "min_keepdims": lambda x: x["m"].min(axis=0, keepdims=True),
    "prod": lambda x: x["a"].prod(),
    "prod_list_axis": lambda x: x["m"].prod(axis=[0, 1]),
    "sum_list_axis": lambda x: x["m"].sum(axis=[1]),
    "argmax": lambda x: x["m"].argmax(axis=1),
    "argmin": lambda x: x["m"].argmin(),
    "abs": lambda x: x["m"].abs(),
    "sqrt": lambda x: x["a"].sqrt(),
    "square": lambda x: x["m"].square(),
    "exp": lambda x: x["m"].exp(),
    "log": lambda x: x["a"].log(),
    "softmax": lambda x: x["m"].softmax(axis=0),
    "log_softmax": lambda x: x["m"].log_softmax(),
    "take": lambda x: x["m"].take(x["idx"]),
    "take_wrap": lambda x: x["m"].take(x["idx"] + 2, axis=1, mode="wrap"),
    "one_hot": lambda x: x["idx"].one_hot(4),
    "one_hot_values": lambda x: x["idx"].one_hot(3, on_value=2.0,
                                                 off_value=-1.0),
    "flip": lambda x: x["m"].flip(axis=1),
    "tile": lambda x: x["a"].tile((2, 1)),
    "repeat": lambda x: x["a"].repeat(2, axis=0),
    "repeat_flat": lambda x: x["i"].repeat(2),
    "pad": lambda x: x["a"].reshape((1, 1, 2, 3)).pad(
        mode="constant", pad_width=(0, 0, 0, 0, 1, 1, 2, 0),
        constant_value=3.0),
    "dot": lambda x: x["a"].dot(x["m"]),
    "norm": lambda x: x["m"].norm(axis=[1]),
    "clip": lambda x: x["m"].clip(-0.5, 0.5),
    "astype_int": lambda x: x["m"].astype("int32"),
    "astype_bf16": lambda x: x["m"].astype("bfloat16"),
    "iter": lambda x: list(x["m"])[1],
    "getitem_neg": lambda x: x["m"][::-1, 1],
    "copyto_ndarray": lambda x: x["a"].copyto(x["b"]),
    "copyto_ctx": lambda x: x["a"].copyto(x["a"].context),
    "as_in_ctx": lambda x: x["a"].as_in_ctx(x["a"].ctx),
}


def _result(v):
    """(numpy values, dtype name) of an NDArray result."""
    return np.asarray(v.asnumpy()).astype(np.float64), str(v.dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ndarray_expression_matches_jax(case):
    outs = [_result(CASES[case](_inputs(pkg))) for pkg in (mxj, mx)]
    (ref, rdt), (got, gdt) = outs
    assert gdt == rdt, (case, gdt, rdt)
    assert got.shape == ref.shape
    scale = np.abs(ref).max(initial=0.0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("conv", ["float", "int", "tolist", "item",
                                  "asscalar", "len", "bool"])
def test_conversions_match_jax(conv):
    """`float()`, `int()`, `tolist`, `item`, `asscalar`, `len`, `bool`:
    the same Python or numpy values and types."""
    fns = {"float": lambda a, m: float(a), "int": lambda a, m: int(a),
           "tolist": lambda a, m: m.tolist(), "item": lambda a, m: a.item(),
           "asscalar": lambda a, m: a.asscalar(),
           "len": lambda a, m: len(m), "bool": lambda a, m: bool(a)}
    got = []
    for pkg in (mxj, mx):
        a = pkg.nd.array(np.array([2.75], np.float32), ctx=pkg.cpu())
        m = pkg.nd.array(M, ctx=pkg.cpu())
        got.append(fns[conv](a, m))
    assert type(got[1]) is type(got[0])
    assert got[1] == got[0]


CREATION = {
    "ones": lambda nd, c: nd.ones((2, 3), ctx=c),
    "ones_int": lambda nd, c: nd.ones(4, ctx=c, dtype="int32"),
    "full": lambda nd, c: nd.full((2, 2), 7.5, ctx=c),
    "full_bf16": lambda nd, c: nd.full((3,), 0.1, ctx=c, dtype="bfloat16"),
    "empty": lambda nd, c: nd.empty((2, 1), ctx=c),
    "zeros_int_shape": lambda nd, c: nd.zeros(3, ctx=c, dtype="uint8"),
    "arange": lambda nd, c: nd.arange(0.5, 3.2, 0.7, ctx=c),
    "arange_repeat": lambda nd, c: nd.arange(4, repeat=3, ctx=c),
    "arange_int": lambda nd, c: nd.arange(2, 9, 2, ctx=c, dtype="int32"),
    "linspace": lambda nd, c: nd.linspace(-1, 1, 7, ctx=c),
    "linspace_open": lambda nd, c: nd.linspace(0, 1, 4, endpoint=False,
                                               ctx=c),
    "eye": lambda nd, c: nd.eye(3, ctx=c),
    "eye_rect": lambda nd, c: nd.eye(2, 4, 1, ctx=c, dtype="int32"),
    "zeros_like": lambda nd, c: nd.ndarray.zeros_like(
        nd.array(I, ctx=c, dtype="int32"), dtype="float32"),
    "ones_like": lambda nd, c: nd.ndarray.ones_like(nd.array(A, ctx=c),
                                                    ctx=c),
}


@pytest.mark.parametrize("case", sorted(CREATION))
def test_creation_matches_jax(case):
    """The creation functions, with the JAX package's default dtype
    (float32) and its handling of extra keyword arguments (taken and
    ignored by the `zeros_like`/`ones_like` of `ndarray.ndarray`)."""
    outs = [_result(CREATION[case](pkg.nd, pkg.cpu())) for pkg in (mxj, mx)]
    (ref, rdt), (got, gdt) = outs
    assert gdt == rdt
    np.testing.assert_array_equal(got, ref)


def test_from_numpy_copies_and_waitall():
    src = np.arange(6, dtype=np.int64).reshape(2, 3)
    with mx.cpu():
        a = nd.from_numpy(src)
    ref = mxj.nd.from_numpy(src)
    assert a.dtype == ref.dtype == np.int32
    src[0, 0] = 99
    np.testing.assert_array_equal(a.asnumpy(), ref.asnumpy())
    nd.waitall()
    mxj.nd.waitall()


def test_reshape_method_honours_reverse():
    """The port's `reshape` method passes `reverse=` to the op, as the
    JAX op `nd.reshape(..., reverse=True)` and MXNet do; the JAX method
    drops it (a reference fact, ROADMAP.md)."""
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    with mx.cpu():
        got = nd.array(x).reshape((-1, 0), reverse=True)
    ref = mxj.nd.reshape(mxj.nd.array(x, ctx=mxj.cpu()), shape=(-1, 0),
                         reverse=True)
    assert got.shape == ref.shape == (6, 4)
    np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


def test_contrib_namespace_has_every_contrib_op():
    """`nd.contrib.<name>` for every registered `_contrib_<name>` of the
    port, CTC's aliases among them, each the same op."""
    names = [n[len("_contrib_"):] for n in TR.list_ops()
             if n.startswith("_contrib_")]
    assert {"CTCLoss", "ctc_loss", "interleaved_matmul_selfatt_qk",
            "interleaved_matmul_encdec_valatt"} <= set(names)
    for n in names:
        assert getattr(nd.contrib, n).__name__ == f"_contrib_{n}"
    jax_names = {n for n in dir(mxj.nd.contrib) if not n.startswith("_")}
    assert {"CTCLoss", "interleaved_matmul_selfatt_qk"} <= jax_names


def test_row_sparse_and_namespaces_at_the_top_of_nd():
    assert nd.RowSparseNDArray is nd.sparse.RowSparseNDArray
    for name in ("random", "contrib", "sparse", "from_dlpack",
                 "to_dlpack_for_read", "to_dlpack_for_write", "waitall",
                 "from_numpy", "ones", "full", "empty", "arange",
                 "linspace", "eye"):
        assert hasattr(nd, name) and hasattr(mxj.nd, name), name


def test_dlpack_round_trip_shares_memory():
    """`to_dlpack_for_read` hands out the storage (no copy) and
    `from_dlpack` takes it back; `to_dlpack_for_write`'s writes land in
    the array and not in a view of it made before (the JAX package
    raises there: its buffers cannot be written)."""
    with mx.cpu():
        a = nd.array(A)
        t = torch.utils.dlpack.from_dlpack(nd.to_dlpack_for_read(a))
        assert t.data_ptr() == a.data.data_ptr()
        back = nd.from_dlpack(torch.arange(4.0))
        np.testing.assert_array_equal(back.asnumpy(), [0, 1, 2, 3])
        view = a[0]
        w = torch.utils.dlpack.from_dlpack(nd.to_dlpack_for_write(a))
        w.fill_(3.0)
        np.testing.assert_array_equal(a.asnumpy(), np.full((2, 3), 3.0))
        np.testing.assert_array_equal(view.asnumpy(), A[0])
    np.testing.assert_array_equal(
        mxj.nd.from_dlpack(np.arange(3.0, dtype=np.float32)).asnumpy(),
        nd.from_dlpack(np.arange(3.0, dtype=np.float32)).asnumpy())
    with pytest.raises(mxj.MXNetError):
        mxj.nd.to_dlpack_for_write(mxj.nd.array(A, ctx=mxj.cpu()))


@pytest.mark.parametrize("name,kw", [
    ("broadcast_add", {}), ("elemwise_sub", {}), ("maximum", {}),
    ("power", {}), ("_plus_scalar", {"scalar": 2}),
    ("_maximum_scalar", {"scalar": 1.25})])
def test_out_argument_writes_into_the_array(name, kw):
    """`out=` writes the result into the given array (its holders see it,
    its views keep their values), as the JAX package rebinds it."""
    got = []
    for pkg in (mxj, mx):
        x = _inputs(pkg)
        out = pkg.nd.zeros((2, 3), ctx=pkg.cpu())
        args = (x["a"],) if kw else (x["a"], x["b"])
        res = getattr(pkg.nd, name)(*args, out=out, **kw)
        assert res is out
        got.append(out.asnumpy())
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6)
    with mx.cpu():
        out = nd.zeros((2, 3))
        view = out[1]
        nd.broadcast_add(nd.array(A), nd.array(B), out=out)
        np.testing.assert_array_equal(view.asnumpy(), np.zeros(3))
