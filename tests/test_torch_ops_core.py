"""The port's core op registry against the JAX package's: every name
registered by the JAX `ops/math.py`, `ops/reduce.py`, `ops/shape.py`,
`ops/nn.py` and `ops/attention.py` (aliases too), forward and backward,
plus the closed-world check that every name of those five files and of
`ops/random_ops.py` is registered in the port.

Inputs are `tests/test_op_sweep.py`'s `_build_case`/`SPEC` (numpy from a
per-op crc32 seed), handed to both packages; an alias takes its op's
case.  The backward is MXNet's autograd in both packages (`record()`,
`backward` with a seeded normal cotangent per float output) where the
JAX `OpDef.differentiable` says so and the op draws no random numbers;
every float input takes a gradient.  `argsort`/`topk` ties would follow
the JAX order (stable sorts); the sweep's inputs are tie-free.

Tolerances, with their reasons:

- float32 forward and gradients: rtol 1e-6 with atol 1e-6 of the
  largest reference value (the same float32 arithmetic, reordered
  sums; `TOL_F32` widens gammaln, whose polynomial differs);
- bfloat16 forward: 1 bf16 ulp (rtol 2^-8, atol 2^-8 of the largest
  value), each side rounding once (`TOL_BF16`: GroupNorm, which rounds
  four times); integer and bool outputs exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (the JAX package needs jax loaded)
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.ops import registry as JR

import incubator_mxnet_torch as mx  # noqa: F401
from incubator_mxnet_torch import autograd
from incubator_mxnet_torch.ndarray import NDArray
from incubator_mxnet_torch.ops import registry as TR

from test_op_sweep import _build_case, UNIQUE

CORE_FILES = ("math", "reduce", "shape", "nn", "attention")
ALL_FILES = CORE_FILES + ("random_ops",)


def _names(files):
    return sorted(n for n, op in JR._REGISTRY.items()
                  if op.impl.__module__.rsplit(".", 1)[-1] in files)


# the sweep's name for each op (its first registered name)
_CANONICAL = {id(op): n for n, op in UNIQUE.items()}
NAMES = _names(CORE_FILES)

# widened float32 tolerances: (rtol, atol of the largest value)
TOL_F32 = {
    # XLA and torch evaluate lgamma with different polynomials: a few
    # float32 ulps near its zeros
    "gammaln": (1e-5, 1e-6),
}

# widened bfloat16 tolerances, as above
TOL_BF16 = {
    # normalizes in bfloat16 through four rounded steps (mean, variance,
    # rsqrt, scale) that the packages round in their own order: 4 ulps
    "GroupNorm": (2 ** -6, 2 ** -6),
}


def _case(name):
    canon = _CANONICAL[id(JR.get_op(name))]
    args, kwargs, _ = _build_case(canon)
    return [a.asnumpy() for a in args], kwargs


def _jax_run(name, arrays, kwargs):
    out = getattr(mxj.nd, name)(*[mxj.nd.array(a, dtype=a.dtype)
                                  for a in arrays], **kwargs)
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _port(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return NDArray(t if dtype is None else t.to(dtype))


def _port_run(name, arrays, kwargs):
    out = TR.apply_op(name, *[_port(a) for a in arrays], **kwargs)
    return list(out) if isinstance(out, tuple) else [out]


def _f64(a):
    return np.asarray(a.asnumpy()).astype(np.float64)


def _close(got, ref, rtol, atol_of_max, what):
    ref64, got64 = _f64(ref), _f64(got)
    assert got64.shape == ref64.shape, (what, got64.shape, ref64.shape)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got64, ref64, err_msg=what)
        return
    scale = np.abs(ref64[np.isfinite(ref64)]).max(initial=0.0)
    np.testing.assert_allclose(got64, ref64, rtol=rtol,
                               atol=atol_of_max * max(scale, 1e-30),
                               err_msg=what)


def test_every_name_of_the_six_files_is_registered():
    """Closed world: a name the JAX package registers in one of the six
    files and the port does not is a failure, listed."""
    missing = [n for n in _names(ALL_FILES) if n not in TR._REGISTRY]
    assert not missing, missing


@pytest.mark.parametrize("name", NAMES)
def test_forward_float32_matches_jax(name):
    arrays, kwargs = _case(name)
    ref = _jax_run(name, arrays, kwargs)
    got = _port_run(name, arrays, kwargs)
    assert len(got) == len(ref)
    rtol, atol = TOL_F32.get(name, (1e-6, 1e-6))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype, (name, i, g.dtype, r.dtype)
        _close(g, r, rtol, atol, f"{name} output {i}")


@pytest.mark.parametrize("name", NAMES)
def test_forward_bfloat16_matches_jax(name):
    """float32 inputs as bfloat16 (integer inputs as they are), where
    the sweep runs the op in bfloat16."""
    canon = _CANONICAL[id(JR.get_op(name))]
    if _build_case(canon)[2].get("bf16", True) is False:
        pytest.skip("the sweep runs this op in float32 only")
    arrays, kwargs = _case(name)
    ref = getattr(mxj.nd, name)(*[
        mxj.nd.array(a).astype("bfloat16") if a.dtype == np.float32
        else mxj.nd.array(a, dtype=a.dtype) for a in arrays], **kwargs)
    got = TR.apply_op(name, *[
        _port(a, torch.bfloat16) if a.dtype == np.float32 else _port(a)
        for a in arrays], **kwargs)
    ref = list(ref) if isinstance(ref, (tuple, list)) else [ref]
    got = list(got) if isinstance(got, tuple) else [got]
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype, (name, i, g.dtype, r.dtype)
        rtol, atol = TOL_BF16.get(name, (2 ** -8, 2 ** -8))
        _close(g, r, rtol, atol, f"{name} bf16 output {i}")


def _grad_names():
    out = []
    for n in NAMES:
        op = JR.get_op(n)
        if op.differentiable and not op.needs_rng and not op.no_jit:
            out.append(n)
    return out


def _backward(pkg, ag, name, arrays, kwargs, cts):
    xs = [pkg.nd.array(a, ctx=pkg.cpu(), dtype=a.dtype) for a in arrays]
    for x, a in zip(xs, arrays):
        if a.dtype.kind == "f":
            x.attach_grad()
    with ag.record():
        out = getattr(pkg.nd, name)(*xs, **kwargs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    heads = [o for o in outs if o.dtype.kind == "f"]
    if not heads:
        return None
    ag.backward(heads, [pkg.nd.array(c, ctx=pkg.cpu(), dtype=h.dtype)
                        for h, c in zip(heads, cts)])
    return [x.grad for x, a in zip(xs, arrays) if a.dtype.kind == "f"]


@pytest.mark.parametrize("name", _grad_names())
def test_backward_float32_matches_jax(name):
    """The gradient of every float input for a seeded cotangent."""
    arrays, kwargs = _case(name)
    outs = [r for r in _jax_run(name, arrays, kwargs) if r.dtype.kind == "f"]
    rng = np.random.RandomState(5)
    cts = [np.asarray(rng.randn(*o.shape), np.float32) for o in outs]
    ref = _backward(mxj, jag, name, arrays, kwargs, cts)
    if ref is None:
        pytest.skip("no float output to differentiate")
    got = _backward(mx, autograd, name, arrays, kwargs, cts)
    rtol, atol = TOL_F32.get(name, (1e-6, 1e-6))
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, rtol, atol, f"{name} gradient of input {i}")


def test_port_case_builder_is_the_sweeps():
    """`tools.op_cases`, the port's copy of the sweep's input builder
    that `chip_smoke.py` uses, draws the sweep's arrays and attributes
    for every core name (the probabilities it makes with numpy's
    softmax within 1e-6 of the JAX package's)."""
    from incubator_mxnet_torch.tools import op_cases
    assert set(op_cases.core_names()) >= set(NAMES)
    for name in NAMES:
        want, want_kw = _case(name)
        got, got_kw = op_cases.build_case(name)
        assert got_kw == want_kw, name
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
