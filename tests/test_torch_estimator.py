"""The port's `gluon.contrib.estimator` and `callback` against the JAX
package's on the CPU: `Estimator.fit` of a small MLP from the JAX
weights (`convert.params_from_jax`) through a DataLoader, with the same
weights after one epoch, the same training metric after each epoch and
the same epoch at which `EarlyStoppingHandler` stops; `evaluate`;
`CheckpointHandler`'s files; `LoggingHandler`'s lines; `Speedometer`'s
text lines and JSONL keys, `log_train_metric` and `ProgressBar`.

Tolerances: weights 1e-5 of their largest value after one epoch (the
same float32 products and updates, added in another order); training
metrics (accuracies) exactly.
"""
import collections
import json
import logging
import re

import numpy as np

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.contrib import estimator as jest

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import callback, convert, metric
from incubator_mxnet_torch.gluon import data
from incubator_mxnet_torch.gluon.contrib import estimator as est

WEIGHT_RTOL = 1e-5
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=6),
            pkg.gluon.nn.Dense(3, in_units=16))
    return net


def _nets():
    mxj.random.seed(1)
    ref = _mlp(mxj)
    ref.initialize(mxj.init.Xavier())
    weights = {k: v.data().asnumpy()
               for k, v in ref._collect_params_with_prefix().items()}
    got = _mlp(mx)
    got.initialize(ctx=mx.cpu())
    convert.params_from_jax(got, weights, ctx=mx.cpu())
    return got, ref


def _data(n=96, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(3, 6) * 2
    y = rng.randint(0, 3, n)
    return (centers[y] + rng.randn(n, 6)).astype(np.float32), y


def _estimators(train_metrics="acc"):
    got, ref = _nets()
    g = est.Estimator(got, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                      train_metrics=train_metrics,
                      trainer=mx.gluon.Trainer(got.collect_params(), "sgd",
                                               SGD))
    r = jest.Estimator(ref, mxj.gluon.loss.SoftmaxCrossEntropyLoss(),
                       train_metrics=train_metrics,
                       trainer=mxj.gluon.Trainer(ref.collect_params(), "sgd",
                                                 SGD))
    return g, r


def _loaders(x, y, batch=8):
    return (data.DataLoader(data.ArrayDataset(x, y), batch),
            mxj.gluon.data.DataLoader(mxj.gluon.data.ArrayDataset(x, y),
                                      batch))


class _Recorder:
    def __init__(self):
        self.values = []

    def epoch_end(self, estimator):
        self.values.append(estimator.train_metric.get()[1])


def test_fit_one_epoch_gives_the_jax_weights():
    x, y = _data()
    g, r = _estimators()
    gl, rl = _loaders(x, y)
    with mx.cpu():
        g.fit(gl, epochs=1, event_handlers=[])
    r.fit(rl, epochs=1, event_handlers=[])
    got = {k: p.data().asnumpy()
           for k, p in g.net._collect_params_with_prefix().items()}
    for k, p in r.net._collect_params_with_prefix().items():
        ref = p.data().asnumpy()
        np.testing.assert_allclose(got[k], ref, rtol=0,
                                   atol=WEIGHT_RTOL * np.abs(ref).max(),
                                   err_msg=k)
    assert g.train_metric.get() == r.train_metric.get()
    xv, yv = _data(48, seed=1)
    gv, rv = _loaders(xv, yv)
    with mx.cpu():
        got_eval = g.evaluate(gv)
    assert got_eval == r.evaluate(rv)


def test_early_stopping_stops_at_the_jax_epoch():
    x, y = _data()
    g, r = _estimators()
    gl, rl = _loaders(x, y)
    grec, rrec = _Recorder(), _Recorder()
    with mx.cpu():
        g.fit(gl, epochs=30, event_handlers=[
            est.EarlyStoppingHandler(patience=1), grec])
    r.fit(rl, epochs=30, event_handlers=[
        jest.EarlyStoppingHandler(patience=1), rrec])
    assert g.stop_training and r.stop_training
    assert g.current_epoch == r.current_epoch < 29
    assert grec.values == rrec.values


def test_checkpoint_and_logging_handlers(tmp_path, caplog):
    x, y = _data()
    g, _ = _estimators()
    gl, _ = _loaders(x, y)
    caplog.set_level(logging.INFO)
    with mx.cpu():
        g.fit(gl, epochs=2, batches=6, event_handlers=[
            est.LoggingHandler(log_interval=4),
            est.CheckpointHandler(str(tmp_path), "mlp", save_best=True)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["mlp-best.params", "mlp-epoch0.params",
                     "mlp-epoch1.params"]
    lines = [r.getMessage() for r in caplog.records]
    assert any(re.fullmatch(r"batch 4: accuracy=\d\.\d{4}", m)
               for m in lines), lines
    assert sum(m.startswith("epoch ") and " done (" in m
               for m in lines) == 2
    fresh = _mlp(mx)
    fresh.load_parameters(str(tmp_path / "mlp-epoch1.params"), ctx=mx.cpu())
    with mx.cpu():
        xb = mx.nd.array(x[:8])
        np.testing.assert_array_equal(fresh(xb).asnumpy(),
                                      g.net(xb).asnumpy())
    # the JAX package reads the port's checkpoint
    ref = _mlp(mxj)
    ref.load_parameters(str(tmp_path / "mlp-epoch1.params"))
    np.testing.assert_allclose(ref(mxj.nd.array(x[:8])).asnumpy(),
                               g.net(xb).asnumpy(), rtol=1e-5, atol=1e-5)


# -- callbacks -------------------------------------------------------------

Param = collections.namedtuple("Param", ["epoch", "nbatch", "eval_metric"])


def _drive(cb, m):
    for nbatch in range(7):
        if m is not None:
            m.update([np.array([0.0, 1.0])], [np.array([[0.9, 0.1],
                                                        [0.2, 0.8]])])
        cb(Param(1, nbatch, m))


def _speed_free(lines):
    return [re.sub(r"Speed: [0-9.]+", "Speed: S", m) for m in lines]


def test_speedometer_lines_and_jsonl_keys(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    path = tmp_path / "speed.jsonl"
    _drive(callback.Speedometer(4, frequent=2, emit_json=True,
                                json_path=str(path)), metric.Accuracy())
    got = [r.getMessage() for r in caplog.records]
    caplog.clear()
    _drive(mxj.callback.Speedometer(4, frequent=2), mxj.metric.Accuracy())
    ref = [r.getMessage() for r in caplog.records]
    assert _speed_free([m for m in got if not m.startswith("{")]) == \
        _speed_free(ref)
    assert len(ref) == 3 and ref[0].startswith("Epoch[1] Batch [2]\tSpeed:")
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [json.loads(m) for m in got if m.startswith("{")] == records
    assert [r["batch"] for r in records] == [2, 4, 6]
    for r in records:
        assert set(r) == {"epoch", "batch", "samples_per_sec", "metrics",
                          "time", "rank", "role", "host"}
        assert r["rank"] == 0 and r["role"] == "process"
        assert r["metrics"] == {"accuracy": 1.0}
        assert r["samples_per_sec"] > 0
    caplog.clear()
    _drive(callback.Speedometer(4, frequent=3), None)
    assert all(m.startswith("Iter[1] Batch [") for m in
               (r.getMessage() for r in caplog.records))


def test_speedometer_env_path_implies_json(tmp_path, monkeypatch):
    path = tmp_path / "env.jsonl"
    monkeypatch.setenv("MXNET_TELEMETRY_JSONL", str(path))
    sp = callback.Speedometer(2, frequent=1)
    assert sp.emit_json
    _drive(sp, metric.Accuracy())
    assert len(path.read_text().splitlines()) == 6


def test_log_train_metric_and_progress_bar(caplog, capsys):
    caplog.set_level(logging.INFO)
    _drive(callback.log_train_metric(3), metric.Accuracy())
    got = [r.getMessage() for r in caplog.records]
    caplog.clear()
    _drive(mxj.callback.log_train_metric(3), mxj.metric.Accuracy())
    assert got == [r.getMessage() for r in caplog.records]
    assert got[0] == "Iter[1] Batch[0] Train-accuracy=1.000000"
    callback.ProgressBar(4, length=8)(Param(0, 2, None))
    mxj.callback.ProgressBar(4, length=8)(Param(0, 2, None))
    out = capsys.readouterr().out.split("\r")
    assert out[0] == out[1] == "[====----] 50.0%"
