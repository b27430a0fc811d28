"""Linear-algebra ops (counterpart of `incubator_mxnet_tpu/ops/linalg.py`):
gemm, syrk, potrf/potri, trmm/trsm, sumlogdiag, extractdiag/makediag,
extracttrian/maketrian, det/slogdet/inverse, gelqf and syevd, each under
its `linalg_*` name and the `_linalg_*` alias, on `torch.linalg`
(LAPACK on the CPU, cuSOLVER and cuBLAS on the card), with torch
autograd for the gradients.

The JAX package's layouts are kept, also where they are not upstream
MXNet's: `linalg_gelqf` returns (L, Q) with A = L·Q and Q orthonormal
rows, and `linalg_syevd` returns (U, Λ) with the eigenvectors as the
rows of U (A = Uᵀ·diag(Λ)·U).  Decompositions are fixed only up to the
signs of Q's rows and U's rows, which LAPACK and cuSOLVER may choose
differently.  `det`, `potri` and `trsm` of bfloat16 or float16 data
run in float32 and round once (torch's solvers take neither type).
"""
from __future__ import annotations

import functools
import math

import numpy as _np
import torch

from ..base import MXNetError
from .registry import register


def _t(x, flag):
    return x.transpose(-1, -2) if flag else x


def _in_float32(fn):
    """`fn` run in float32 on half-precision inputs, its result rounded
    back to their dtype."""
    @functools.wraps(fn)        # the signature the registry reads
    def impl(*args, **kwargs):
        dt = args[0].dtype
        if dt not in (torch.bfloat16, torch.float16):
            return fn(*args, **kwargs)
        return fn(*[a.to(torch.float32) for a in args], **kwargs).to(dt)
    return impl


@register("linalg_gemm", aliases=("_linalg_gemm",))
def linalg_gemm(A, B, C, *, transpose_a=False, transpose_b=False,
                alpha=1.0, beta=1.0, axis=-2):
    """alpha · op(A) · op(B) + beta · C; `axis` locates the matrices' row
    dimension."""
    if axis not in (-2, A.ndim - 2):
        A, B, C = (torch.movedim(m, axis, -2) for m in (A, B, C))
        out = alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
            + beta * C
        return torch.movedim(out, -2, axis)
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
        + beta * C


@register("linalg_syrk", aliases=("_linalg_syrk",))
def linalg_syrk(A, *, transpose=False, alpha=1.0):
    At = A.transpose(-1, -2)
    return alpha * (torch.matmul(At, A) if transpose else torch.matmul(A, At))


@register("linalg_potrf", aliases=("_linalg_potrf",))
def linalg_potrf(A):
    """Cholesky A = L·Lᵀ → L (lower)."""
    return torch.linalg.cholesky(A)


@register("linalg_potri", aliases=("_linalg_potri",))
@_in_float32
def linalg_potri(A):
    """From a Cholesky factor L: (L·Lᵀ)⁻¹."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype,
                    device=A.device).expand(A.shape)
    Linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(Linv.transpose(-1, -2), Linv)


@register("linalg_trmm", aliases=("_linalg_trmm",))
def linalg_trmm(A, B, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """alpha · op(A) · B (B · op(A) with `rightside`), reading only A's
    declared triangle."""
    At = _t(torch.tril(A) if lower else torch.triu(A), transpose)
    out = torch.matmul(B, At) if rightside else torch.matmul(At, B)
    return alpha * out


@register("linalg_trsm", aliases=("_linalg_trsm",))
@_in_float32
def linalg_trsm(A, B, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """X with op(A) · X = alpha · B (X · op(A) = alpha · B with
    `rightside`), A triangular."""
    opA = _t(A, transpose)
    return torch.linalg.solve_triangular(
        opA, alpha * B, upper=lower == transpose, left=not rightside)


@register("linalg_sumlogdiag", aliases=("_linalg_sumlogdiag",))
def linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_extractdiag", aliases=("_linalg_extractdiag",))
def linalg_extractdiag(A, *, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag", aliases=("_linalg_makediag",))
def linalg_makediag(A, *, offset=0):
    return torch.diag_embed(A, offset=offset)


def _tri_indices(n, offset, lower, device):
    return (torch.tril_indices(n, n, offset, device=device) if lower
            else torch.triu_indices(n, n, offset, device=device))


@register("linalg_extracttrian", aliases=("_linalg_extracttrian",))
def linalg_extracttrian(A, *, offset=0, lower=True):
    """The (lower or upper) triangle packed into a vector, walked row by
    row."""
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise MXNetError(
            f"linalg_extracttrian: input must be [..., n, n], got "
            f"{tuple(A.shape)}")
    rows, cols = _tri_indices(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


def _tri_len(n, k, lower):
    return len(_np.tril_indices(n, k=k)[0] if lower
               else _np.triu_indices(n, k=k)[0])


@register("linalg_maketrian", aliases=("_linalg_maketrian",))
def linalg_maketrian(A, *, offset=0, lower=True):
    """The packed triangle unpacked into a square matrix, zeros
    elsewhere."""
    m = A.shape[-1]
    if offset == 0:
        n = (math.isqrt(8 * m + 1) - 1) // 2
    else:
        n = 1
        while _tri_len(n, offset, lower) < m:
            n += 1
    rows, cols = _tri_indices(n, offset, lower, A.device)
    out = A.new_zeros(tuple(A.shape[:-1]) + (n, n))
    out[..., rows, cols] = A
    return out


@register("linalg_det", aliases=("_linalg_det", "det"))
@_in_float32
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet", aliases=("_linalg_slogdet", "slogdet"))
def linalg_slogdet(A):
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


@register("linalg_inverse", aliases=("_linalg_inverse", "inverse"))
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("linalg_gelqf", aliases=("_linalg_gelqf",))
def linalg_gelqf(A):
    """LQ factorization A = L·Q, Q with orthonormal rows → (L, Q)."""
    q, r = torch.linalg.qr(A.transpose(-1, -2))
    return r.transpose(-1, -2), q.transpose(-1, -2)


@register("linalg_syevd", aliases=("_linalg_syevd",))
def linalg_syevd(A):
    """Symmetric eigendecomposition → (U, Λ), A = Uᵀ·diag(Λ)·U, the
    eigenvectors as rows, the eigenvalues ascending."""
    w, v = torch.linalg.eigh(A)
    return v.transpose(-1, -2), w
