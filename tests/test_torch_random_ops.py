"""The port's sampling ops (`ops/random_ops.py`, `nd.random`).

The streams come from torch generators, not JAX's threefry, so they are
held to the JAX ops by distribution: a Kolmogorov-Smirnov test (or a
chi-square test for the discrete ones) of 20000 draws at a fixed seed
against the distribution the JAX op samples, at significance 1e-3 (a
correct sampler fails one seed in a thousand, and the seed is fixed);
shapes and dtypes against the JAX ops'; the same seed giving the same
stream twice; `out=` and `ctx=`.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import incubator_mxnet_tpu as mxj

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import nd
from incubator_mxnet_torch.ops import registry as TR

N = 20000
ALPHA = 1e-3

CONTINUOUS = {
    "uniform": (dict(low=-1.0, high=3.0),
                stats.uniform(loc=-1.0, scale=4.0).cdf),
    "normal": (dict(loc=0.5, scale=2.0), stats.norm(0.5, 2.0).cdf),
    "gamma": (dict(alpha=2.5, beta=1.5), stats.gamma(2.5, scale=1.5).cdf),
    "gamma_small_alpha": (dict(alpha=0.5, beta=1.0), stats.gamma(0.5).cdf),
    "exponential": (dict(lam=4.0), stats.expon(scale=0.25).cdf),
}


def _draw(fn, seed=7, **kw):
    mx.random.seed(seed)
    return fn(shape=(N,), ctx=mx.cpu(), **kw).asnumpy().astype(np.float64)


@pytest.mark.parametrize("case", sorted(CONTINUOUS))
def test_continuous_distribution(case):
    kw, cdf = CONTINUOUS[case]
    name = case.split("_")[0]
    x = _draw(getattr(nd.random, name), **kw)
    assert stats.kstest(x, cdf).pvalue > ALPHA


@pytest.mark.parametrize("name,kw,pmf,support", [
    ("poisson", dict(lam=3.0), stats.poisson(3.0).pmf, 12),
    ("randint", dict(low=2, high=9), lambda k: np.where(
        (k >= 2) & (k < 9), 1 / 7, 0.0), 12),
    ("bernoulli", dict(p=0.3), stats.bernoulli(0.3).pmf, 2)])
def test_discrete_distribution(name, kw, pmf, support):
    """Chi-square of the counts of 0..support-1, the last bin holding
    the tail."""
    x = _draw(getattr(nd.random, name), **kw).astype(np.int64)
    k = np.arange(support)
    expected = pmf(k) * N
    expected[-1] += N - expected.sum()
    counts = np.bincount(np.minimum(x, support - 1), minlength=support)
    keep = expected > 0
    assert counts[~keep].sum() == 0
    assert stats.chisquare(counts[keep], expected[keep]).pvalue > ALPHA


def test_multinomial_frequencies():
    """`sample_multinomial` rows of probabilities: draws per row and
    their frequencies (chi-square), the output shape rows x draws."""
    p = np.array([[0.1, 0.6, 0.3], [0.5, 0.0, 0.5]], np.float32)
    mx.random.seed(3)
    with mx.cpu():
        out = nd.random.multinomial(nd.array(p), shape=(N,))
    assert out.shape == (2, N) and out.dtype == np.int32
    for row in range(2):
        counts = np.bincount(out.asnumpy()[row], minlength=3)
        keep = p[row] > 0
        assert counts[~keep].sum() == 0
        assert stats.chisquare(counts[keep], p[row][keep] * N).pvalue > ALPHA


def test_shuffle_is_a_permutation_of_rows():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    mx.random.seed(4)
    with mx.cpu():
        out = nd.random.shuffle(nd.array(x)).asnumpy()
    assert not np.array_equal(out, x)
    np.testing.assert_array_equal(np.sort(out[:, 0]), x[:, 0])
    np.testing.assert_array_equal(out[:, 1], out[:, 0] + 1)


OPS = {
    "_random_uniform": {}, "_random_normal": {}, "_random_gamma": {},
    "_random_exponential": {}, "_random_poisson": {},
    "_random_randint": {"low": 0, "high": 5}, "_sample_bernoulli": {},
}


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_shape_and_dtype_match_jax(name, dtype):
    """The registered op's output shape and dtype (its default, or the
    one asked for) are the JAX op's; randint's dtype is an integer
    type, so it is asked for int32 there."""
    kw = dict(OPS[name], shape=(3, 4))
    if dtype is not None:
        kw["dtype"] = "int32" if name == "_random_randint" else dtype
    ref = getattr(mxj.nd, name)(**kw)
    got = TR.apply_op(name, ctx=mx.cpu(), **kw)
    assert got.shape == ref.shape == (3, 4)
    assert got.dtype == ref.dtype


@pytest.mark.parametrize("name", sorted(OPS) + ["_shuffle",
                                                "_sample_multinomial"])
def test_same_seed_same_stream(name):
    """seed(n) twice gives the same draws; another seed others."""
    def run(seed):
        mx.random.seed(seed)
        with mx.cpu():
            if name == "_shuffle":
                return nd.shuffle(nd.arange(50)).asnumpy()
            if name == "_sample_multinomial":
                return nd.sample_multinomial(nd.array([0.2, 0.3, 0.5]),
                                             shape=(50,)).asnumpy()
            return getattr(nd, name)(shape=(50,), **OPS[name]).asnumpy()
    a, b, c = run(11), run(11), run(12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_out_and_ctx_and_positional():
    """`nd.random.*` take MXNet's positional parameters, `ctx=` for the
    device and `out=` to write into an array."""
    mx.random.seed(1)
    out = nd.zeros((2, 3), ctx=mx.cpu())
    res = nd.random.uniform(5.0, 6.0, shape=(2, 3), ctx=mx.cpu(), out=out)
    assert res is out and out.context == mx.cpu()
    assert ((out.asnumpy() >= 5.0) & (out.asnumpy() < 6.0)).all()
    n = nd.random.normal(10.0, 0.001, shape=(4,), ctx=mx.cpu())
    assert np.allclose(n.asnumpy(), 10.0, atol=0.01)
    r = nd.random.randn(2, 5, ctx=mx.cpu())
    assert r.shape == (2, 5) and r.dtype == np.float32
    with mx.cpu():
        u = nd.uniform(shape=(3,))
    assert u.context == mx.cpu()
    assert isinstance(nd.random.seed, type(test_out_and_ctx_and_positional))


def test_default_context_is_the_card():
    """Without `ctx=` a draw lands on the current context, gpu(0), which
    raises on a machine without CUDA instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        nd.random.uniform(shape=(2,))
