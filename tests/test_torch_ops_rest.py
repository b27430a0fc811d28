"""The rest of the port's op registry against the JAX package's: every
name registered by the JAX `ops/extended.py`, `ops/contrib_ops.py` and
`ops/linalg.py` (aliases too), forward in float32 and bfloat16 and
backward, plus the closed-world check that each of those names is
registered in the port and that `tools.op_cases` builds the sweep's
inputs for them.

Inputs are `tests/test_op_sweep.py`'s `_build_case`/`SPEC` (numpy from a
per-op crc32 seed), handed to both packages; an alias takes its op's
case.  The backward is MXNet's autograd in both packages (`record()`,
`backward` with a seeded normal cotangent per float output) where the
JAX `OpDef.differentiable` says so; every float input takes a gradient.

Tolerances, with their reasons:

- float32 forward and gradients: rtol 1e-6 with atol 1e-6 of the
  largest reference value (the same float32 arithmetic, reordered
  sums; LAPACK, the FFT and digamma's polynomial stay within it at
  these sizes);
- bfloat16 forward: 1 bf16 ulp (rtol 2^-8, atol 2^-8 of the largest
  value), each side rounding once; integer and bool outputs exact.
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

REST_FILES = ("extended", "contrib_ops", "linalg")


def _names(files):
    return sorted(n for n, op in JR._REGISTRY.items()
                  if op.impl.__module__.rsplit(".", 1)[-1] in files)


_CANONICAL = {id(op): n for n, op in UNIQUE.items()}
NAMES = _names(REST_FILES)

F32 = (1e-6, 1e-6)          # (rtol, atol of the largest value)
BF16 = (2 ** -8, 2 ** -8)


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


def test_every_name_of_the_three_files_is_registered():
    """Closed world: a name the JAX package registers in one of the
    three files and the port does not is a failure, listed."""
    missing = [n for n in NAMES if n not in TR._REGISTRY]
    assert not missing, missing


def test_only_quantized_names_are_missing():
    """The port registers every JAX op name but `ops/quantized.py`'s,
    and its `nd` has every public JAX `nd` name but those."""
    quant = set(_names(("quantized",)))
    assert set(JR._REGISTRY) - set(TR._REGISTRY) == quant
    public = {n for n in dir(mxj.nd) if not n.startswith("_")
              or n in JR._REGISTRY}
    assert public - set(dir(mx.nd)) == quant


@pytest.mark.parametrize("name", NAMES)
def test_forward_float32_matches_jax(name):
    arrays, kwargs = _case(name)
    ref = _jax_run(name, arrays, kwargs)
    got = _port_run(name, arrays, kwargs)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype, (name, i, g.dtype, r.dtype)
        _close(g, r, *F32, f"{name} output {i}")


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
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype, (name, i, g.dtype, r.dtype)
        _close(g, r, *BF16, f"{name} bf16 output {i}")


def _grad_names():
    return [n for n in NAMES if JR.get_op(n).differentiable
            and not JR.get_op(n).needs_rng and not JR.get_op(n).no_jit]


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
    got = _backward(mx, autograd, name, arrays, kwargs, cts)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, *F32, f"{name} gradient of input {i}")


def test_port_case_builder_is_the_sweeps():
    """`tools.op_cases` draws the sweep's arrays and attributes for
    every name of the three files, and skips bfloat16 where the sweep
    does."""
    from incubator_mxnet_torch.tools import op_cases
    assert set(op_cases.rest_names()) >= set(NAMES)
    for name in NAMES:
        want, want_kw = _case(name)
        got, got_kw = op_cases.build_case(name)
        assert got_kw == want_kw, name
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        canon = _CANONICAL[id(JR.get_op(name))]
        assert (canon in op_cases.BF16_SKIP) == (
            _build_case(canon)[2].get("bf16", True) is False), name
