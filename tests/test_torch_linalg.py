"""The port's `ops/linalg.py` against the JAX package's on the CPU,
beyond the sweep's one case per op (`test_torch_ops_rest.py`): each
op's attributes (transposes, sides, triangles, offsets, `axis`),
forward and gradients, and the decompositions' invariants, which hold
whatever signs a LAPACK or cuSOLVER build picks: A = L·Q with Q·Qᵀ = I
(gelqf), Uᵀ·diag(Λ)·U = A with U·Uᵀ = I (syevd), L·Lᵀ = A (potrf) and
potri(L)·A = I.

Tolerance, with its reason: values, gradients and invariants within
1e-6 of the largest value (rtol and atol; float32 LAPACK and BLAS on
both sides, the same arithmetic in another blocking order, and the
round-off of a 4 x 4 or 5 x 5 factorization).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as mxj

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import nd

TOL = 1e-6


def _np(a):
    return np.asarray(a.asnumpy()).astype(np.float64)


def _close(got, ref, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=TOL,
        atol=TOL * max(np.abs(ref).max(initial=0), 1e-30), err_msg=what)


def _spd(rng, *batch_n):
    *b, n = batch_n
    a = rng.randn(*b, n, n).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + 2 * np.eye(n)).astype(np.float32)


def _run(pkg, name, arrays, kw, grad=True):
    """Outputs and the gradients of every input for seeded cotangents."""
    with pkg.cpu():
        xs = [pkg.nd.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, name)(*xs, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if not grad:
        return outs, []
    rng = np.random.RandomState(9)
    cts = [pkg.nd.array(rng.randn(*o.shape).astype(np.float32),
                        ctx=pkg.cpu()) for o in outs]
    pkg.autograd.backward(outs, cts)
    return outs, [x.grad for x in xs]


def _inputs(kind, rng):
    return {
        "spd": lambda: [_spd(rng, 2, 4)],
        "gemm": lambda: [rng.randn(2, 3, 4), rng.randn(2, 4, 5),
                         rng.randn(2, 3, 5)],
        "gemm_t": lambda: [rng.randn(2, 4, 3), rng.randn(2, 5, 4),
                           rng.randn(2, 3, 5)],
        "gemm_axis": lambda: [rng.randn(3, 2, 4), rng.randn(4, 2, 5),
                              rng.randn(3, 2, 5)],
        "tri": lambda: [_spd(rng, 4), rng.randn(4, 3)],
        "tri_right": lambda: [_spd(rng, 4), rng.randn(3, 4)],
        "rect": lambda: [rng.randn(2, 3, 5)],
        "vec": lambda: [rng.randn(2, 4)],
        "packed": lambda: [rng.randn(2, 10)],
        "packed_off": lambda: [rng.randn(2, 6)],
    }[kind]()


CASES = [
    ("linalg_gemm", "gemm", dict(alpha=0.5, beta=2.0)),
    ("linalg_gemm", "gemm_t", dict(transpose_a=True, transpose_b=True)),
    ("linalg_gemm", "gemm_axis", dict(axis=0)),
    ("linalg_syrk", "rect", dict()),
    ("linalg_syrk", "rect", dict(transpose=True, alpha=0.3)),
    ("linalg_trmm", "tri", dict()),
    ("linalg_trmm", "tri", dict(transpose=True, lower=False, alpha=2.0)),
    ("linalg_trmm", "tri_right", dict(rightside=True)),
    ("linalg_trsm", "tri", dict()),
    ("linalg_trsm", "tri", dict(transpose=True)),
    ("linalg_trsm", "tri", dict(lower=False, alpha=0.5)),
    ("linalg_trsm", "tri_right", dict(rightside=True)),
    ("linalg_trsm", "tri_right", dict(rightside=True, transpose=True,
                                      lower=False)),
    ("linalg_extractdiag", "spd", dict(offset=1)),
    ("linalg_extractdiag", "spd", dict(offset=-2)),
    ("linalg_makediag", "vec", dict(offset=2)),
    ("linalg_makediag", "vec", dict(offset=-1)),
    ("linalg_extracttrian", "spd", dict(lower=False)),
    ("linalg_extracttrian", "spd", dict(offset=-1)),
    ("linalg_extracttrian", "spd", dict(offset=1, lower=False)),
    ("linalg_maketrian", "packed", dict(lower=False)),
    ("linalg_maketrian", "packed_off", dict(offset=-1)),
    ("linalg_maketrian", "packed_off", dict(offset=1, lower=False)),
    ("linalg_sumlogdiag", "spd", dict()),
    ("linalg_potrf", "spd", dict()),
    ("linalg_det", "spd", dict()),
    ("linalg_inverse", "spd", dict()),
    ("linalg_slogdet", "spd", dict()),
]


@pytest.mark.parametrize("name,kind,kw", CASES,
                         ids=[f"{n}-{k}-{i}" for i, (n, k, _)
                              in enumerate(CASES)])
def test_values_and_gradients_match_jax(name, kind, kw):
    arrays = [np.asarray(a, np.float32)
              for a in _inputs(kind, np.random.RandomState(1))]
    got, got_g = _run(mx, name, arrays, kw)
    ref, ref_g = _run(mxj, name, arrays, kw)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, f"{name} {kw} output {i}")
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        _close(g, r, f"{name} {kw} gradient of input {i}")


def test_potri_of_potrf_inverts():
    a = _spd(np.random.RandomState(2), 3, 5)
    with mx.cpu():
        L = nd.linalg_potrf(nd.array(a))
        inv = nd.linalg_potri(L).asnumpy()
    np.testing.assert_allclose(L.asnumpy() @ np.swapaxes(L.asnumpy(), -1, -2),
                               a, rtol=0, atol=TOL * np.abs(a).max())
    np.testing.assert_allclose(inv @ a, np.broadcast_to(np.eye(5), a.shape),
                               rtol=0, atol=TOL * np.abs(a).max())
    ref = mxj.nd.linalg_potri(mxj.nd.array(L.asnumpy())).asnumpy()
    np.testing.assert_allclose(inv, ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(3, 5), (2, 4, 6), (4, 4)])
def test_gelqf_invariants_and_order(shape):
    """(L, Q) — not upstream's (Q, L) — with A = L·Q, Q·Qᵀ = I and L
    lower triangular; equal to the JAX op's up to the signs of Q's rows
    (and L's columns)."""
    a = np.random.RandomState(3).randn(*shape).astype(np.float32)
    with mx.cpu():
        L, Q = (o.asnumpy() for o in nd.linalg_gelqf(nd.array(a)))
    m = shape[-2]
    assert L.shape == shape[:-1] + (m,) and Q.shape == shape
    scale = np.abs(a).max()
    np.testing.assert_allclose(L @ Q, a, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(Q @ np.swapaxes(Q, -1, -2),
                               np.broadcast_to(np.eye(m), L.shape),
                               rtol=0, atol=TOL)
    assert np.abs(np.triu(L, 1)).max() == 0
    rL, rQ = (o.asnumpy() for o in mxj.nd.linalg_gelqf(mxj.nd.array(a)))
    sign = np.sign(np.sum(Q * rQ, axis=-1, keepdims=True))
    np.testing.assert_allclose(Q * sign, rQ, rtol=0, atol=TOL)
    np.testing.assert_allclose(L * np.swapaxes(sign, -1, -2), rL, rtol=0,
                               atol=TOL * scale)


@pytest.mark.parametrize("n", [3, 5])
def test_syevd_invariants(n):
    """(U, Λ) with the eigenvectors as rows: Uᵀ·diag(Λ)·U = A, U·Uᵀ = I,
    Λ ascending and the JAX op's; each row ±1 times the JAX row."""
    a = _spd(np.random.RandomState(4), 2, n)
    with mx.cpu():
        U, lam = (o.asnumpy() for o in nd.linalg_syevd(nd.array(a)))
    scale = np.abs(a).max()
    rec = np.swapaxes(U, -1, -2) @ (lam[..., :, None] * U)
    np.testing.assert_allclose(rec, a, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(U @ np.swapaxes(U, -1, -2),
                               np.broadcast_to(np.eye(n), a.shape), rtol=0,
                               atol=TOL)
    assert (np.diff(lam, axis=-1) >= 0).all()
    rU, rlam = (o.asnumpy() for o in mxj.nd.linalg_syevd(mxj.nd.array(a)))
    np.testing.assert_allclose(lam, rlam, rtol=TOL, atol=TOL * scale)
    dots = np.abs(np.sum(U * rU, axis=-1))
    np.testing.assert_allclose(dots, np.ones_like(dots), rtol=0, atol=TOL)


def test_factorizations_of_bfloat16_run_in_float32():
    """det, potri and trsm of bfloat16 data: computed in float32,
    rounded once to bfloat16."""
    a = _spd(np.random.RandomState(5), 2, 3)
    with mx.cpu():
        x = nd.array(a).astype("bfloat16")
        det = nd.linalg_det(x)
    want = torch.linalg.det(torch.from_numpy(a).to(torch.bfloat16)
                            .float()).to(torch.bfloat16).float().numpy()
    assert det.dtype == "bfloat16"
    np.testing.assert_array_equal(det.asnumpy(), want)


def test_extracttrian_of_non_square_raises():
    with mx.cpu():
        with pytest.raises(mx.MXNetError):
            nd.linalg_extracttrian(nd.ones((2, 3, 4)))
