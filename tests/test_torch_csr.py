"""The CSR half of `nd.sparse` against the JAX package's on the CPU:
`CSRNDArray` from (data, indices, indptr), from a dense array and from a
scipy CSR matrix, its members, `cast_storage` both ways, `zeros` /
`empty`, `dot` of CSR and dense with and without `transpose_a` (also a
1-D right side), row-sparse and dense-times-sparse `dot`, and `add` /
`multiply` as the JAX `_binary` defines them.

Tolerances, with their reasons: storage (values, indices, indptr) and
densified arrays exact (copies and gathers); `dot` rtol 1e-6 with atol
1e-6 of the largest value (the same float32 products added into each
output row in another order).
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as mxj

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import nd


def _dense(rng, shape=(6, 9), density=0.3):
    a = rng.randn(*shape).astype(np.float32)
    a[rng.rand(*shape) > density] = 0
    return a


def _np(a):
    return np.asarray(a.asnumpy()).astype(np.float64)


def _close(got, ref, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=1e-6,
        atol=1e-6 * max(np.abs(ref).max(initial=0), 1e-30), err_msg=what)


def _storage_equal(got, ref):
    assert got.stype == ref.stype == "csr"
    assert got.shape == ref.shape
    for attr in ("data", "indices", "indptr"):
        g, r = getattr(got, attr), getattr(ref, attr)
        assert g.dtype == r.dtype, (attr, g.dtype, r.dtype)
        np.testing.assert_array_equal(g.asnumpy(), r.asnumpy(), err_msg=attr)


def test_csr_from_dense_and_triple_matches_jax():
    a = _dense(np.random.RandomState(0))
    with mx.cpu():
        got = nd.sparse.csr_matrix(a)
    ref = mxj.nd.sparse.csr_matrix(a)
    _storage_equal(got, ref)
    assert isinstance(got, nd.CSRNDArray)
    triple = (ref.data.asnumpy(), ref.indices.asnumpy(), ref.indptr.asnumpy())
    with mx.cpu():
        got2 = nd.sparse.csr_matrix(triple, shape=a.shape)
    _storage_equal(got2, mxj.nd.sparse.csr_matrix(triple, shape=a.shape))
    np.testing.assert_array_equal(got2.asnumpy(), a)
    np.testing.assert_array_equal(got2.tostype("default").asnumpy(), a)


def test_cast_storage_both_ways():
    a = _dense(np.random.RandomState(1))
    with mx.cpu():
        x = nd.array(a)
        csr = nd.sparse.cast_storage(x, "csr")
        back = nd.sparse.cast_storage(csr, "default")
        rsp = csr.tostype("row_sparse")
        via = x.tostype("csr")
    ref = mxj.nd.sparse.cast_storage(mxj.nd.array(a), "csr")
    _storage_equal(csr, ref)
    _storage_equal(via, ref)
    np.testing.assert_array_equal(back.asnumpy(), a)
    assert rsp.stype == "row_sparse"
    np.testing.assert_array_equal(rsp.asnumpy(), a)
    np.testing.assert_array_equal(
        rsp.indices.asnumpy(),
        mxj.nd.sparse.cast_storage(ref, "row_sparse").indices.asnumpy())


def test_scipy_source_zeros_and_empty():
    a = _dense(np.random.RandomState(2))
    m = sp.csr_matrix(a)
    with mx.cpu():
        got = nd.sparse.array(m)
        z = nd.sparse.zeros("csr", (3, 4))
        e = nd.sparse.empty("csr", (3, 4))
        again = nd.sparse.array(got)
    _storage_equal(got, mxj.nd.sparse.array(m))
    _storage_equal(z, mxj.nd.sparse.zeros("csr", (3, 4)))
    _storage_equal(e, mxj.nd.sparse.empty("csr", (3, 4)))
    _storage_equal(again, got)
    with pytest.raises(mx.MXNetError):
        nd.sparse.zeros("csr", (2, 3, 4), ctx=mx.cpu())


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("rhs_ndim", [2, 1])
def test_csr_dot_matches_jax(transpose_a, rhs_ndim):
    rng = np.random.RandomState(3)
    a = _dense(rng, (7, 11), 0.25)
    rows = a.shape[0] if transpose_a else a.shape[1]
    w = rng.randn(*((rows, 5) if rhs_ndim == 2 else (rows,))) \
        .astype(np.float32)
    with mx.cpu():
        got = nd.sparse.dot(nd.sparse.csr_matrix(a), nd.array(w),
                            transpose_a=transpose_a)
    ref = mxj.nd.sparse.dot(mxj.nd.sparse.csr_matrix(a), mxj.nd.array(w),
                            transpose_a=transpose_a)
    _close(got, ref, f"dot transpose_a={transpose_a}")
    np.testing.assert_allclose(_np(got), (a.T if transpose_a else a) @ w,
                               rtol=1e-5, atol=1e-5)


def test_csr_dot_with_empty_and_repeated_rows():
    """Rows with no entry give zero rows; a column met in many rows adds
    them all (transpose_a)."""
    a = np.zeros((5, 4), np.float32)
    a[1, 2], a[3, 2], a[4, 2], a[4, 0] = 1.5, -2.0, 0.5, 3.0
    w = np.arange(20, dtype=np.float32).reshape(5, 4) / 7
    with mx.cpu():
        got = nd.sparse.dot(nd.sparse.csr_matrix(a), nd.array(w[:4]))
        got_t = nd.sparse.dot(nd.sparse.csr_matrix(a), nd.array(w),
                              transpose_a=True)
    np.testing.assert_allclose(got.asnumpy(), a @ w[:4], rtol=1e-6)
    np.testing.assert_allclose(got_t.asnumpy(), a.T @ w, rtol=1e-6)


def test_rsp_and_dense_dot_match_jax():
    rng = np.random.RandomState(4)
    a = _dense(rng, (6, 4), 0.5)
    a[2] = 0
    w = rng.randn(4, 3).astype(np.float32)
    m = rng.randn(5, 6).astype(np.float32)
    with mx.cpu():
        rsp = nd.sparse.row_sparse_array(a)
        got = nd.sparse.dot(rsp, nd.array(w))
        got2 = nd.sparse.dot(nd.array(m), nd.sparse.csr_matrix(a))
    jrsp = mxj.nd.sparse.row_sparse_array(a)
    _close(got, mxj.nd.sparse.dot(jrsp, mxj.nd.array(w)), "rsp dot")
    _close(got2, mxj.nd.sparse.dot(mxj.nd.array(m),
                                   mxj.nd.sparse.csr_matrix(a)), "dns dot")
    with pytest.raises(mx.MXNetError):
        nd.sparse.dot(nd.sparse.csr_matrix(a, ctx=mx.cpu()),
                      nd.array(w.T, ctx=mx.cpu()), transpose_b=True)
    with pytest.raises(mx.MXNetError):
        nd.sparse.dot(nd.array(m, ctx=mx.cpu()), nd.array(a, ctx=mx.cpu()))


def test_add_and_multiply_follow_jax():
    """csr + csr and csr * dense are dense; csr * number stays csr."""
    rng = np.random.RandomState(5)
    a, b = _dense(rng), _dense(rng)
    d = rng.randn(*a.shape).astype(np.float32)
    with mx.cpu():
        ca, cb = nd.sparse.csr_matrix(a), nd.sparse.csr_matrix(b)
        outs = {"csr+csr": ca + cb, "csr*dense": ca * nd.array(d),
                "csr*2": ca * 2.0, "add": nd.sparse.add(ca, nd.array(d)),
                "multiply": nd.sparse.multiply(ca, cb)}
    ja, jb = mxj.nd.sparse.csr_matrix(a), mxj.nd.sparse.csr_matrix(b)
    refs = {"csr+csr": ja + jb, "csr*dense": ja * mxj.nd.array(d),
            "csr*2": ja * 2.0, "add": mxj.nd.sparse.add(ja, mxj.nd.array(d)),
            "multiply": mxj.nd.sparse.multiply(ja, jb)}
    for k in outs:
        assert outs[k].stype == refs[k].stype, k
        np.testing.assert_array_equal(outs[k].asnumpy(), refs[k].asnumpy(),
                                      err_msg=k)


def test_csr_members_match_jax():
    """astype keeps csr, copyto a context copies, detach is dense,
    wait_to_read and attach_grad return None; int64 indices are stored
    as int32."""
    a = _dense(np.random.RandomState(6))
    with mx.cpu():
        x = nd.sparse.csr_matrix(a)
    j = mxj.nd.sparse.csr_matrix(a)
    for got, ref in ((x.astype("float16"), j.astype("float16")),
                     (x.copyto(mx.cpu()), j.copyto(mxj.cpu())),
                     (x.as_in_context(mx.cpu()), j.as_in_context(mxj.cpu()))):
        assert type(got).__name__ == type(ref).__name__ == "CSRNDArray"
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    assert type(x.detach()).__name__ == "NDArray"
    np.testing.assert_array_equal(x.detach().asnumpy(), a)
    assert x.wait_to_read() is None and j.wait_to_read() is None
    assert x.attach_grad() is None
    np.testing.assert_array_equal(x.grad.asnumpy(), np.zeros_like(a))
    assert len(x) == a.shape[0]
    with mx.cpu():
        y = nd.sparse.csr_matrix((a[a != 0], np.nonzero(a)[1].astype(np.int64),
                                  np.r_[0, np.cumsum((a != 0).sum(1))]),
                                 shape=a.shape)
    assert y.indices.dtype == np.int32 and y.indptr.dtype == np.int32
    np.testing.assert_array_equal(y.asnumpy(), a)
    with pytest.raises(mx.MXNetError):
        x[0]
