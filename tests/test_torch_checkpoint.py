"""`ParallelTrainer` checkpoints and byte reports in the port against the
JAX package, and the slice as a whole: a narrow BERT with a sparse word
embedding trained by both packages' `ParallelTrainer`, then by LAMB
through `gluon.Trainer`.

Inputs and weights are made with numpy from a seed (the JAX weights go
into the port through `convert.params_from_jax`).  Tolerances:

- checkpoints written by one package and read by the other: bitwise,
  bfloat16 included (the same bytes);
- byte reports: exact;
- the narrow BERT's losses and weights after 3 Adam steps (lazy rows)
  and 3 LAMB steps, float32: rtol 1e-5, atol 1e-5 of the largest
  weight (2 layers of float32 sums in another order; Adam and LAMB
  normalise the update, so a last-bit difference in a gradient near 0
  still moves its weight by a fraction of lr = 1e-3).
"""
import json
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT, \
    BERTClassifier as JaxClassifier

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd, parallel as par
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.models.bert import BERTModel, BERTClassifier
from incubator_mxnet_torch.parallel import checkpoint as tck

X = np.random.RandomState(0).randn(4, 5).astype(np.float32)
Y = np.random.RandomState(1).randint(0, 3, 4).astype(np.float32)


def _weights(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _bits(t):
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jax_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _nets(dtype, units=6, seed=0):
    mxj.random.seed(seed)
    jnet = mxj.gluon.nn.HybridSequential()
    with jnet.name_scope():
        jnet.add(mxj.gluon.nn.Dense(units, activation="relu", in_units=5),
                 mxj.gluon.nn.Dense(3, in_units=units))
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    tnet = gluon.nn.HybridSequential()
    with tnet.name_scope():
        tnet.add(gluon.nn.Dense(units, activation="relu", in_units=5),
                 gluon.nn.Dense(3, in_units=units))
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    params_from_jax(tnet, _weights(jnet))
    jnet.cast(dtype)
    tnet.cast(dtype)
    return jnet, tnet


def _trainers(jnet, tnet, kind):
    jl = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tl = gluon.loss.SoftmaxCrossEntropyLoss()
    opt = {"learning_rate": 0.05, "momentum": 0.9} if kind == "sgd" \
        else {"learning_rate": 0.01}
    jtr = jpar.ParallelTrainer(jnet, lambda o, y: jl(o.astype("float32"), y),
                               optimizer=kind, optimizer_params=opt,
                               mesh=jpar.default_mesh(1))
    ttr = par.ParallelTrainer(tnet, lambda o, y: tl(o.astype("float32"), y),
                              optimizer=kind, optimizer_params=opt,
                              mesh=par.default_mesh(ctx=mx.cpu()))
    return jtr, ttr


def _dtype(tr):
    return str(next(iter(tr.block.collect_params().values())).dtype)


def _jax_step(jtr, n=1):
    x = mxj.nd.array(X, ctx=mxj.cpu()).astype(_dtype(jtr))
    for _ in range(n):
        jtr.step(x, mxj.nd.array(Y, ctx=mxj.cpu()))


def _port_step(ttr, n=1):
    x = nd.array(X, ctx=mx.cpu()).astype(_dtype(ttr))
    for _ in range(n):
        ttr.step(x, nd.array(Y, ctx=mx.cpu()))


def _same_state(jtr, ttr):
    """Parameters, states and step count bitwise equal."""
    jt, tt = jtr._state_tree(), ttr._state_tree()
    assert sorted(jt) == sorted(tt)
    for k in jt:
        np.testing.assert_array_equal(_bits(tt[k]), _jax_bits(jt[k]),
                                      err_msg=k)
    assert jtr.num_update == ttr.num_update


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_loads_in_jax(tmp_path, kind, dtype):
    jnet, tnet = _nets(dtype)
    jtr, ttr = _trainers(jnet, tnet, kind)
    _port_step(ttr, 3)
    ttr.save_checkpoint(str(tmp_path))
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert manifest["extra"]["optimizer"] == kind
    assert manifest["step"] == 3
    _jax_step(jtr)
    jtr.load_checkpoint(str(tmp_path))
    _same_state(jtr, ttr)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_in_port(tmp_path, kind, dtype):
    jnet, tnet = _nets(dtype)
    jtr, ttr = _trainers(jnet, tnet, kind)
    _jax_step(jtr, 3)
    jtr.save_checkpoint(str(tmp_path))
    got = ttr.load_checkpoint(str(tmp_path))
    assert got["step"] == 3
    _same_state(jtr, ttr)
    assert ttr.params[0].data().dtype == dtype


def test_checkpoint_resumes_the_same_steps(tmp_path):
    """A trainer restored from a checkpoint takes the same next step,
    bit for bit, as the one that wrote it."""
    _, tr_a = _trainers(*_nets("bfloat16"), "adam")
    _port_step(tr_a, 2)
    tr_a.save_checkpoint(str(tmp_path))
    _, tr_b = _trainers(*_nets("bfloat16", seed=1), "adam")
    _port_step(tr_b)
    tr_b.load_checkpoint(str(tmp_path))
    x = nd.array(X, ctx=mx.cpu()).astype("bfloat16")
    la = tr_a.step(x, nd.array(Y, ctx=mx.cpu()))
    lb = tr_b.step(x, nd.array(Y, ctx=mx.cpu()))
    assert la.asscalar() == lb.asscalar()
    for k, t in tr_a._state_tree().items():
        np.testing.assert_array_equal(_bits(tr_b._state_tree()[k]), _bits(t))


def test_wrong_model_or_optimizer_is_rejected(tmp_path):
    jnet, tnet = _nets("float32")
    _, ttr = _trainers(jnet, tnet, "adam")
    _port_step(ttr)
    ttr.save_checkpoint(str(tmp_path))
    _, wrong_shape = _trainers(*_nets("float32", units=7), "adam")
    with pytest.raises(mx.MXNetError, match="has shape"):
        wrong_shape.load_checkpoint(str(tmp_path))
    _, sgd = _trainers(*_nets("float32"), "sgd")
    with pytest.raises(mx.MXNetError, match="optimizer kind mismatch"):
        sgd.load_checkpoint(str(tmp_path))
    bigger = gluon.nn.HybridSequential()
    with bigger.name_scope():
        bigger.add(gluon.nn.Dense(6, in_units=5), gluon.nn.Dense(3, in_units=6),
                   gluon.nn.Dense(2, in_units=3))
    bigger.initialize(ctx=mx.cpu())
    tr = par.ParallelTrainer(bigger, lambda o, y: o, optimizer="adam",
                             mesh=par.default_mesh(ctx=mx.cpu()))
    with pytest.raises(mx.MXNetError, match="lacks"):
        tr.load_checkpoint(str(tmp_path))


def test_corrupt_shard_is_rejected_naming_its_file(tmp_path):
    jnet, tnet = _nets("float32")
    jtr, ttr = _trainers(jnet, tnet, "sgd")
    _port_step(ttr)
    ttr.save_checkpoint(str(tmp_path))
    shard = tmp_path / "shards-00000.npz"
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    for tr in (ttr, jtr):
        with pytest.raises(mxj.base.MXNetError if tr is jtr else
                           mx.MXNetError, match="shards-00000.npz"):
            tr.load_checkpoint(str(tmp_path))


def test_sharded_files_load_as_written(tmp_path):
    """`save_sharded`/`load_sharded` alone: 0-d, bool and bf16 arrays and
    an array the JAX package split into two shards."""
    arrays = {"s": torch.tensor(3.5), "m": torch.tensor([[True, False]]),
              "h": torch.randn(3, 4).to(torch.bfloat16)}
    tck.save_sharded(str(tmp_path), arrays, step=7, extra={"k": 1})
    got, man = tck.load_sharded(str(tmp_path))
    assert man["step"] == 7 and man["extra"] == {"k": 1}
    for k, t in arrays.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape
        np.testing.assert_array_equal(_bits(got[k]), _bits(t))
    with np.load(tmp_path / "shards-00000.npz") as z:
        payload = {k: z[k] for k in z.files}
    rows = _bits(arrays["h"]).view(np.uint8).reshape(3, 8)
    del payload["h##0:3,0:4"]
    payload["h##0:1,0:4"] = rows[:1].reshape(-1)
    payload["h##1:3,0:4"] = rows[1:].reshape(-1)
    np.savez(tmp_path / "shards-00000.npz", **payload)
    man.pop("shard_sha256")
    (tmp_path / "manifest.json").write_text(json.dumps(man))
    got, _ = tck.load_sharded(str(tmp_path), {"h"})
    np.testing.assert_array_equal(_bits(got["h"]), _bits(arrays["h"]))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_byte_reports_match_jax(kind):
    jnet, tnet = _nets("bfloat16")
    jtr, ttr = _trainers(jnet, tnet, kind)
    _jax_step(jtr)
    _port_step(ttr)
    assert ttr.param_bytes() == jtr.param_bytes() == (
        2 * (5 * 6 + 6 + 6 * 3 + 3),) * 2
    assert ttr.optimizer_state_bytes() == jtr.optimizer_state_bytes()


# ------------------------------------------------------ the whole slice
VOCAB, T, B = 500, 16, 4
SLICE_TOL = dict(rtol=1e-5)


def _narrow_bert(pkg, sparse):
    bert_cls, clf_cls = (JaxBERT, JaxClassifier) if pkg is mxj else \
        (BERTModel, BERTClassifier)
    bert = bert_cls(VOCAB, units=64, hidden_size=256, num_layers=2,
                    num_heads=2, max_length=T, dropout=0.0,
                    sparse_embed=sparse)
    return clf_cls(bert, num_classes=2, dropout=0.0)


def _slice_batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, VOCAB, (B, T)).astype(np.float32),
            rng.randint(0, 2, (B, T)).astype(np.float32),
            rng.randint(0, 2, B).astype(np.float32))


def _close_all(got, ref):
    scale = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5 * scale,
                                   err_msg=k, **SLICE_TOL)


def test_narrow_bert_sparse_embedding_then_lamb_matches_jax():
    """3 `ParallelTrainer` Adam steps with the sparse word embedding
    (the lazy row update in both packages), then 3 LAMB iterations of
    `gluon.Trainer` on dense twins holding those weights."""
    tok, typ, lab = _slice_batch()
    mxj.random.seed(0)
    jnet = _narrow_bert(mxj, True)
    jnet.initialize(mxj.init.Normal(0.02), ctx=mxj.cpu())
    jd = [mxj.nd.array(a, ctx=mxj.cpu()) for a in (tok, typ, lab)]
    jnet(*jd[:2])
    tnet = _narrow_bert(mx, True)
    tnet.initialize(mx.init.Normal(0.02), ctx=mx.cpu())
    params_from_jax(tnet, _weights(jnet))
    with mx.cpu():
        td = [nd.array(a) for a in (tok, typ, lab)]
    jl, tl = mxj.gluon.loss.SoftmaxCrossEntropyLoss(), \
        gluon.loss.SoftmaxCrossEntropyLoss()
    opt = {"learning_rate": 1e-3}
    jtr = jpar.ParallelTrainer(jnet, lambda o, y: jl(o, y), optimizer="adam",
                               optimizer_params=opt, mesh=jpar.default_mesh(1))
    ttr = par.ParallelTrainer(tnet, lambda o, y: tl(o, y), optimizer="adam",
                              optimizer_params=opt,
                              mesh=par.default_mesh(ctx=mx.cpu()))
    jloss = [float(jtr.step(*jd).asnumpy()) for _ in range(3)]
    tloss = [ttr.step(*td).asscalar() for _ in range(3)]
    assert ttr.lazy_params == [tnet.bert.word_embed.weight.name]
    np.testing.assert_allclose(tloss, jloss, **SLICE_TOL)
    _close_all(_weights(tnet), _weights(jnet))
    untouched = np.setdiff1d(np.arange(VOCAB), tok.astype(np.int64))
    w0 = _weights(jnet)["bert.word_embed.weight"]
    np.testing.assert_array_equal(
        _weights(tnet)["bert.word_embed.weight"][untouched], w0[untouched])

    # LAMB through gluon.Trainer (it takes no row-sparse gradient) on
    # dense twins holding the trained weights
    jnet2, tnet2 = _narrow_bert(mxj, False), _narrow_bert(mx, False)
    jnet2.initialize(ctx=mxj.cpu())
    jnet2(*jd[:2])
    tnet2.initialize(ctx=mx.cpu())
    tnet2(*td[:2])
    for k, p in jnet2._collect_params_with_prefix().items():
        p.set_data(jnet._collect_params_with_prefix()[k].data())
    for k, p in tnet2._collect_params_with_prefix().items():
        p.set_data(tnet._collect_params_with_prefix()[k].data())
    lamb = {"learning_rate": 1e-3, "wd": 0.01}
    jt2 = mxj.gluon.Trainer(jnet2.collect_params(), "lamb", dict(lamb))
    tt2 = gluon.Trainer(tnet2.collect_params(), "lamb", dict(lamb))
    jloss, tloss = [], []
    for _ in range(3):
        with mxj.autograd.record():
            l = jl(jnet2(*jd[:2]), jd[2])
        l.backward()
        jt2.step(B)
        jloss.append(float(l.asnumpy().mean()))
        with autograd.record():
            l = tl(tnet2(*td[:2]), td[2])
        l.backward()
        tt2.step(B)
        tloss.append(float(l.asnumpy().mean()))
    np.testing.assert_allclose(tloss, jloss, **SLICE_TOL)
    _close_all(_weights(tnet2), _weights(jnet2))
