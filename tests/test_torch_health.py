"""The numerics and model-health plane of the port
(`incubator_mxnet_torch/health.py`) against the JAX package's
(`incubator_mxnet_tpu/health.py`).

- `checksum`: bit for bit, for float32 and bfloat16 arrays with NaN and
  Inf, whole digests of several arrays (the 32-bit fold runs in int64 in
  the port; torch has no uint32 arithmetic);
- `tensor_stats`, `traced_step_stats` and `update_sumsq` on the same
  float32 arrays — the gradients and weights of one `bert_tiny` step,
  weights carried by `convert.params_from_jax`: 1e-6 relative (float32
  sums in another order; the nonfinite counts exactly); `monitor_stats`
  (per-tensor means) 1e-5 (see the test);
- the `HealthLedger`: the same anomalies at the same steps for the same
  loss and gradient sequences, the same records and audit verdicts,
  exactly;
- the fault plan's parse: the same actions, exactly;
- both trainers of the port with ``MXNET_HEALTH`` on: records with the
  JAX records' keys; a ``nan_grad`` step counts its NaN and records the
  anomaly.
"""
import math

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import health as jhealth
from incubator_mxnet_tpu import introspect as jins
from incubator_mxnet_tpu.models.bert import (
    get_bert_model as jax_get_bert_model, BERTClassifier as JaxClassifier)

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import (autograd, gluon, health, introspect, nd,
                                   parallel)
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.models import get_model
from incubator_mxnet_torch.tools.parse_log import EwmaBand

VOCAB, T, N = 50, 16, 4
STATS_RTOL = 1e-6
MEAN_RTOL = 1e-5

_ENV = ("MXNET_HEALTH_FAULT_PLAN", "MXNET_HEALTH_AUDIT_STEPS",
        "MXNET_HEALTH_AUTOCAPTURE", "MXNET_HEALTH_COOLDOWN")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for h, ins in ((health, introspect), (jhealth, jins)):
        h._reset_for_tests()
        ins._reset_for_tests()
        h.set_enabled(True)
    yield
    for h, ins in ((health, introspect), (jhealth, jins)):
        h.set_enabled(False)
        h._reset_for_tests()
        ins._reset_for_tests()


# -- checksum: bit for bit ------------------------------------------------

def _arrays(seed, dtype, specials):
    rng = np.random.RandomState(seed)
    out = [rng.randn(1000).astype(np.float32),
           rng.randn(33, 17).astype(np.float32),
           (rng.randn(4, 5, 6) * 1e-30).astype(np.float32),
           np.zeros((7,), np.float32)]
    if specials:
        out[0][[3, 7, 9, 500]] = [np.nan, np.inf, -np.inf, -0.0]
        out[1][0, 0] = np.float32(np.nan) * -1
    return [a.astype(dtype) for a in out]


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("specials", [False, True],
                         ids=["finite", "nan_inf"])
@pytest.mark.parametrize("seed", [0, 1])
def test_checksum_bit_for_bit(dtype, specials, seed):
    arrs = _arrays(seed, dtype, specials)
    tor = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
           if dtype is ml_dtypes.bfloat16 else torch.from_numpy(a)
           for a in arrs]
    got = health.checksum(tor)
    assert got == jhealth.checksum([jnp.asarray(a) for a in arrs])
    for one, t in zip(arrs, tor):
        assert health.checksum([t]) == jhealth.checksum([jnp.asarray(one)])


def test_checksum_is_position_and_bit_sensitive():
    a = np.arange(16, dtype=np.float32)
    b = a.copy()
    b[[2, 5]] = b[[5, 2]]
    c = a.copy()
    c.view(np.uint8)[0] ^= 1
    digests = {health.checksum([torch.from_numpy(x)]) for x in (a, b, c)}
    assert len(digests) == 3
    for x in (a, b, c):
        assert health.checksum([torch.from_numpy(x)]) == \
            jhealth.checksum([jnp.asarray(x)])
    assert health.combine_digest(12345, 678) == \
        jhealth.combine_digest(12345, 678)


# -- the stats on one bert_tiny step's tensors ---------------------------

def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, VOCAB, (N, T)).astype(np.float32),
            rng.randint(0, 2, (N, T)).astype(np.float32),
            rng.randint(0, 2, N).astype(np.float32))


def _weights(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _pair():
    mxj.random.seed(0)
    jnet = JaxClassifier(jax_get_bert_model("bert_tiny", vocab_size=VOCAB,
                                            max_length=T, dropout=0.0),
                         num_classes=2, dropout=0.0)
    jnet.initialize(mxj.init.Normal(0.02), ctx=mxj.cpu())
    tok, typ, _ = _batch()
    jnet(mxj.nd.array(tok, ctx=mxj.cpu()), mxj.nd.array(typ, ctx=mxj.cpu()))
    tnet = get_model("bert_classifier", model_name="bert_tiny",
                     num_classes=2, dropout=0.0, vocab_size=VOCAB,
                     max_length=T)
    tnet.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    params_from_jax(tnet, _weights(jnet))
    return jnet, tnet


@pytest.fixture(scope="module")
def bert_step():
    """(loss, grads, new weights, old weights) of one float32 bert_tiny
    SGD step of the port, as numpy, weights from the JAX package."""
    _, tnet = _pair()
    params = list(tnet.collect_params().values())
    old = [p.data().asnumpy().copy() for p in params]
    with mx.cpu():
        tok, typ, y = (nd.array(a) for a in _batch())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = loss_fn(tnet(tok, typ), y).mean()
    loss.backward()
    grads = [p.grad().asnumpy().copy() for p in params]
    grads[0].reshape(-1)[0] = np.nan       # one poisoned element
    new = [w - 0.1 * np.nan_to_num(g) for w, g in zip(old, grads)]
    return float(loss.asscalar()), grads, new, old


def test_tensor_stats_match_jax(bert_step):
    _, grads, new, _ = bert_step
    for arrays in (grads, new):
        got = health.tensor_stats([torch.from_numpy(a) for a in arrays])
        ref = jhealth.tensor_stats([jnp.asarray(a) for a in arrays])
        assert got["nonfinite"] == ref["nonfinite"]
        np.testing.assert_allclose(got["sumsq"], ref["sumsq"],
                                   rtol=STATS_RTOL)
    assert health.tensor_stats([torch.from_numpy(grads[0])])[
        "nonfinite"] == 1


def test_traced_step_stats_match_jax(bert_step):
    loss, grads, new, old = bert_step
    got = health.host_step_stats(health.traced_step_stats(
        torch.tensor(loss), [torch.from_numpy(g) for g in grads],
        [torch.from_numpy(w) for w in new],
        [torch.from_numpy(w) for w in old]))
    ref = jhealth.traced_step_stats(
        jnp.float32(loss), [jnp.asarray(g) for g in grads],
        [jnp.asarray(w) for w in new], [jnp.asarray(w) for w in old])
    assert list(got) == list(health.STEP_STAT_KEYS) == \
        list(jhealth.STEP_STAT_KEYS)
    for k in health.STEP_STAT_KEYS:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=STATS_RTOL,
                                   err_msg=k)
    assert got["nonfinite"] == 1.0


def test_update_sumsq_and_monitor_stats_match_jax(bert_step):
    _, _, new, old = bert_step
    got = health.update_sumsq([torch.from_numpy(w) for w in new],
                              [torch.from_numpy(w) for w in old])
    ref = jhealth.update_sumsq([jnp.asarray(w) for w in new],
                               [jnp.asarray(w) for w in old])
    np.testing.assert_allclose(got, ref, rtol=STATS_RTOL)
    # mean(|w|): the JAX package sums each tensor of up to 16,384
    # elements in one float32 segment sum, the port pairwise; float32
    # rounding over n terms is ~sqrt(n) 2^-24, 8e-6 at n = 16,384
    np.testing.assert_allclose(
        health.monitor_stats([torch.from_numpy(w) for w in old]),
        jhealth.monitor_stats([jnp.asarray(w) for w in old]),
        rtol=MEAN_RTOL)


def test_replica_digests_need_two_replicas():
    assert health.replica_digests([torch.ones(3)],
                                  parallel.default_mesh(ctx=mx.cpu()),
                                  "dp") is None


# -- the ledger: same sequences, same anomalies --------------------------

NAN = float("nan")
SEQUENCES = {
    "loss_spike": [dict(loss=1.0)] * 6 + [dict(loss=10.0)]
    + [dict(loss=1.0)] * 3,
    "nan_loss": [dict(loss=1.0)] * 6 + [dict(loss=NAN), dict(loss=1.0)],
    "grad_spike": [dict(grad_sumsq=1.0, nonfinite=0)] * 6
    + [dict(grad_sumsq=100.0, nonfinite=0)],
    "nonfinite_cooldown": [dict(grad_sumsq=1.0, nonfinite=3)] * 20,
    "grad_nan": [dict(grad_sumsq=1.0, nonfinite=0)] * 3
    + [dict(grad_sumsq=NAN, nonfinite=0)],
    "full_records": [dict(loss=0.5 + 0.01 * i, grad_sumsq=4.0 + i,
                          nonfinite=0, weight_sumsq=9.0,
                          update_sumsq=0.0009) for i in range(8)],
}


def _anomalies(h, ins, seq, cooldown):
    led = h.ledger("seq", rank=0)
    recs = [led.on_step(step=i, **kw) for i, kw in enumerate(seq)]
    evs = [(e["anomaly"], e["step"]) for e in ins.flight_events()
           if e["kind"] == "numerics_anomaly"]
    return evs, recs, led.summary()["ewma"], led.anomalies


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_ledger_anomalies_match_jax(name, monkeypatch):
    monkeypatch.setenv("MXNET_HEALTH_COOLDOWN", "4")
    got = _anomalies(health, introspect, SEQUENCES[name], 4)
    ref = _anomalies(jhealth, jins, SEQUENCES[name], 4)
    assert got[0] == ref[0]
    assert got[2] == ref[2] and got[3] == ref[3]
    for a, b in zip(got[1], ref[1]):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], float) and math.isnan(a[k]):
                assert math.isnan(b[k])
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("digests,expected", [
    ({0: 1, 1: 1, 2: 1}, None), ({0: 1, 1: 2, 2: 1}, None),
    ({0: 1, 1: 2}, None), ({0: 1, 1: 1}, 3)])
def test_audit_verdicts_match_jax(digests, expected):
    got = health.ledger("a").note_audit(64, "dp", digests, expected)
    ref = jhealth.ledger("a").note_audit(64, "dp", digests, expected)
    assert got == ref


@pytest.mark.parametrize("values", [
    [1.0] * 6 + [10.0, 1.0], [1.0, 2.0, 1.5, 50.0, 1.2],
    list(np.linspace(1, 3, 12)) + [30.0]])
def test_ewma_band_matches_jax(values):
    a, b = EwmaBand(band=4.0, rel_floor=0.5), \
        jhealth.EwmaBand(band=4.0, rel_floor=0.5)
    assert [a.update(v) for v in values] == [b.update(v) for v in values]
    assert a.ewma == b.ewma and a.ewvar == b.ewvar


@pytest.mark.parametrize("plan", [
    "nan_grad:5@1,bitflip_weight:16@1,nan_grad:7", "nan_grad:2",
    " bitflip_weight:3 , junk, nan_grad:x@1, nan_grad:4@0", ""])
def test_fault_plan_matches_jax(plan, monkeypatch):
    monkeypatch.setenv("MXNET_HEALTH_FAULT_PLAN", plan)
    health._reset_for_tests()
    jhealth._reset_for_tests()
    for step in range(20):
        for rank in (None, 0, 1, 3):
            assert health.fault_actions(step, rank) == \
                jhealth.fault_actions(step, rank)


def test_numericz_keys_match_jax():
    held = [health.ledger("z"), jhealth.ledger("z")]   # weak registries
    for led in held:
        led.on_step(step=0, loss=1.0)
    got, ref = health.numericz(), jhealth.numericz()
    assert set(got) == set(ref)
    assert set(got["trainers"][0]) == set(ref["trainers"][0])


# -- the trainers with MXNET_HEALTH on -----------------------------------

def _dense_loop(tr, net, steps):
    with mx.cpu():
        x = nd.array(np.random.RandomState(0).randn(8, 4)
                     .astype(np.float32))
        y = nd.array(np.ones((8, 1), np.float32))
    loss_fn = gluon.loss.L2Loss()
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(batch_size=8)


def _dense(seed=0):
    mx.random.seed(seed)
    net = gluon.nn.Dense(1, in_units=4)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    return net, gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05})


def test_gluon_trainer_feeds_the_ledger_with_the_jax_keys():
    net, tr = _dense()
    _dense_loop(tr, net, 3)
    led = tr._health
    assert led is not None and led.steps == 3 and led.anomalies == 0
    rec = led.summary()["last"]
    assert rec["nonfinite"] == 0
    assert rec["grad_norm"] > 0 and rec["weight_norm"] > 0
    jled = jhealth.ledger("ref")
    jrec = jled.on_step(step=2, grad_sumsq=1.0, nonfinite=0,
                        weight_sumsq=1.0)
    assert set(rec) == set(jrec)


def test_nan_grad_fault_counts_and_records_the_anomaly(monkeypatch):
    monkeypatch.setenv("MXNET_HEALTH_FAULT_PLAN", "nan_grad:2")
    health._reset_for_tests()
    net, tr = _dense()
    _dense_loop(tr, net, 4)
    recs = list(tr._health._records)
    assert [r["nonfinite"] for r in recs[:2]] == [0, 0]
    assert recs[2]["nonfinite"] >= 1
    ev = tr._health.last_anomaly
    assert ev["anomaly"] == "nonfinite" and ev["step"] == 2


def test_bitflip_weight_fault_changes_the_digest(monkeypatch):
    monkeypatch.setenv("MXNET_HEALTH_FAULT_PLAN", "bitflip_weight:1")
    health._reset_for_tests()
    net, tr = _dense()
    _dense_loop(tr, net, 1)
    before = net.weight.data().asnumpy().copy()
    _dense_loop(tr, net, 1)
    after = net.weight.data().asnumpy()
    assert np.isfinite(after).all()
    assert before.reshape(-1)[0] != after.reshape(-1)[0]


def test_parallel_trainer_records_with_the_jax_keys():
    net, _ = _dense()
    tr = parallel.ParallelTrainer(net, gluon.loss.L2Loss(), "sgd",
                                  {"learning_rate": 0.05},
                                  mesh=parallel.default_mesh(ctx=mx.cpu()))
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y = np.ones((8, 1), np.float32)
    for _ in range(2):
        tr.step(x, y)
    tr.run_steps(3, x, y)
    rec = tr._health.summary()["last"]
    jrec = jhealth.ledger("ref").on_step(
        step=5, loss=1.0, grad_sumsq=1.0, nonfinite=0, weight_sumsq=1.0,
        update_sumsq=0.1)
    assert set(rec) == set(jrec)
    assert rec["step"] == 5 and tr._health.steps == 3
    assert rec["update_ratio"] > 0


def test_health_off_leaves_the_trainers_inert():
    health.set_enabled(False)
    net, tr = _dense()
    _dense_loop(tr, net, 1)
    assert tr._health is None and health.last_record() is None
