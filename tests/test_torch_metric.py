"""The port's `metric` against the JAX package's on the CPU: every metric
on the same seeded inputs (as NDArrays, numpy arrays and torch tensors,
in one update and in several), `create` with names, aliases, lists and
callables, `register`, `np`, `CompositeEvalMetric` and `reset`.

Tolerance: 1e-6 relative.  Both packages compute in numpy from the same
values; the port's inputs come back through torch, which changes
nothing, so most agree exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as mxj

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import metric, nd

RTOL = 1e-6


def _inputs(rng, kind):
    n, c = 12, 5
    if kind == "class":
        p = rng.rand(n, c).astype(np.float32)
        return rng.randint(0, c, n).astype(np.float32), \
            p / p.sum(1, keepdims=True)
    if kind == "binary":
        return rng.randint(0, 2, n).astype(np.float32), \
            rng.rand(n).astype(np.float32)
    if kind == "binary2":
        return rng.randint(0, 2, n).astype(np.float32), \
            rng.rand(n, 2).astype(np.float32)
    if kind == "seq":
        p = rng.rand(3, 4, c).astype(np.float32)
        return rng.randint(0, c, (3, 4)).astype(np.float32), \
            p / p.sum(-1, keepdims=True)
    return rng.randn(n, 2).astype(np.float32), \
        rng.randn(n, 2).astype(np.float32)


CASES = {
    "acc": ("class", {}),
    "Accuracy-axis": ("seq", {"axis": -1}),
    "top_k_accuracy": ("class", {"top_k": 3}),
    "f1": ("binary", {}),
    "F1-2col": ("binary2", {}),
    "mae": ("regress", {}),
    "mse": ("regress", {}),
    "rmse": ("regress", {}),
    "ce": ("class", {}),
    "perplexity": ("seq", {}),
    "Perplexity-ignore": ("seq", {"ignore_label": 2}),
    "pearsoncorrelation": ("regress", {}),
    "loss": ("regress", {}),
    "MCC": ("binary", {}),
    "MCC-2col": ("binary2", {}),
}


def _make(pkg, name, kw):
    base = name.split("-")[0]
    if "-" in name or base[0].isupper():
        return getattr(pkg.metric, base)(**kw)
    return pkg.metric.create(base, **kw)


@pytest.mark.parametrize("as_", ["ndarray", "numpy", "tensor"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_jax(name, as_):
    kind, kw = CASES[name]
    rng = np.random.RandomState(len(name))
    batches = [_inputs(rng, kind) for _ in range(3)]
    got, ref = _make(mx, name, kw), _make(mxj, name, kw)
    assert type(got).__name__ == type(ref).__name__
    for label, pred in batches:
        if as_ == "ndarray":
            with mx.cpu():
                gl, gp = nd.array(label), nd.array(pred)
        elif as_ == "tensor":
            gl, gp = torch.from_numpy(label), torch.from_numpy(pred)
        else:
            gl, gp = label, pred
        got.update([gl], [gp])
        ref.update([mxj.nd.array(label)], [mxj.nd.array(pred)])
        (gn, gv), (rn, rv) = got.get(), ref.get()
        assert gn == rn
        np.testing.assert_allclose(gv, rv, rtol=RTOL)
    (gn, gv), = got.get_name_value()
    (rn, rv), = ref.get_name_value()
    assert gn == rn
    np.testing.assert_allclose(gv, rv, rtol=RTOL)
    got.reset()
    ref.reset()
    assert np.isnan(got.get()[1]) == np.isnan(ref.get()[1])


def test_create_register_np_and_composite_match_jax():
    rng = np.random.RandomState(0)
    label, pred = _inputs(rng, "class")

    def feval(lab, p):
        return float((p.argmax(1) == lab).sum()), lab.size

    got = metric.create(["acc", "ce", feval])
    ref = mxj.metric.create(["acc", "ce", feval])
    assert isinstance(got, metric.CompositeEvalMetric)
    for _ in range(2):
        got.update([label], [pred])
        ref.update([label], [pred])
    (gn, gv), (rn, rv) = got.get(), ref.get()
    assert gn == rn
    np.testing.assert_allclose(gv, rv, rtol=RTOL)
    assert str(got).startswith("EvalMetric: {")
    single = metric.np(lambda lab, p: float(np.abs(p).mean()), name="m")
    jsingle = mxj.metric.np(lambda lab, p: float(np.abs(p).mean()), name="m")
    single.update([label], [pred])
    jsingle.update([label], [pred])
    assert single.get() == pytest.approx(jsingle.get())
    acc = metric.Accuracy()
    assert metric.create(acc) is acc
    with pytest.raises(mx.MXNetError, match="unknown metric"):
        metric.create("nope")

    @metric.register
    class Half(metric.EvalMetric):
        def __init__(self, name="half"):
            super().__init__(name)

        def update(self, labels, preds):
            self.sum_metric += 0.5
            self.num_inst += 1
    h = metric.create("half")
    h.update(None, None)
    assert h.get() == ("half", 0.5)
