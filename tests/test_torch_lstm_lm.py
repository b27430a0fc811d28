"""The PTB LSTM language model in the port against the JAX package on the
CPU: parameter names both ways, five `ParallelTrainer` SGD steps, and
the word-LM example's imperative loop with the hidden state carried.

A narrow model (vocabulary 50, embedding and hidden 16, 2 layers, batch
4 x 5 tokens) with the JAX package's weights copied into the port.
Dropout is 0 on both sides: the port's draws are not the JAX bits.
Tolerances, with their reasons:

- float32: losses rtol 1e-5, weights rtol 1e-4 and atol 1e-5 of each
  weight's largest value — the same
  arithmetic, sums (the products, the softmax, the recurrent matrix's
  gradient over the steps) in another order, grown over five steps at
  lr 1.0;
- bfloat16: losses rtol 1e-3, weights two bf16 steps (rtol 2^-7, atol
  2^-7 of each weight's largest value) — the JAX scan sums the recurrent
  matrix's gradient in bfloat16 and the port in float32, so a weight can
  land a step away after an update;
- the example's loop in bfloat16: losses one bf16 step (rtol 2^-7),
  weights and states atol 2^-5 of each one's largest value (measured
  2%, the decoder's bias) — the JAX package's eager loss on bf16 logits
  is log_softmax and pick in bfloat16, whose gradients round each
  softmax - onehot to bfloat16 before the sums; the port's is the fused
  float32 cross-entropy (the JAX package's traced one).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.gluon import rnn as jrnn
from incubator_mxnet_tpu.models.lstm_lm import LSTMLanguageModel as JLM

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import autograd, gluon, nd, parallel
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.gluon import nn, rnn
from incubator_mxnet_torch.models import LSTMLanguageModel, get_model

V, E, H, L, B, T = 50, 16, 16, 2, 4, 5
LOSS_TOL = {"float32": dict(rtol=1e-5, atol=0),
            "bfloat16": dict(rtol=1e-3, atol=0)}
# the JAX package's eager loss on bf16 logits (the example's loop) is
# log_softmax and pick in bfloat16; its fused float32 CE runs only in a
# traced step, the port's in both
EAGER_BF16_LOSS_TOL = dict(rtol=2 ** -7, atol=0)
EAGER_BF16_WEIGHT_TOL = dict(rtol=2 ** -7, atol_of_max=2 ** -5)
WEIGHT_TOL = {"float32": dict(rtol=1e-4, atol_of_max=1e-5),
              "bfloat16": dict(rtol=2 ** -7, atol_of_max=2 ** -7)}
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "example", "gluon",
                       "word_language_model", "train.py")


def _weights(block):
    return {k: v.data().asnumpy().astype(np.float32)
            for k, v in block._collect_params_with_prefix().items()}


def _close_weights(tnet, jnet, tol):
    got, ref = _weights(tnet), _weights(jnet)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(
            got[k], ref[k], rtol=tol["rtol"],
            atol=tol["atol_of_max"] * np.abs(ref[k]).max(), err_msg=k)


def _example_module():
    """The word-LM example (JAX package) loaded from its file, unchanged."""
    spec = importlib.util.spec_from_file_location("word_lm_train", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class RNNModel(gluon.Block):
    """The example's `RNNModel` written against the port."""

    def __init__(self, vocab_size, num_embed, num_hidden, num_layers,
                 dropout=0.2, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, num_embed)
            self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                input_size=num_embed)
            self.decoder = nn.Dense(vocab_size, in_units=num_hidden,
                                    flatten=False)
            self.num_hidden = num_hidden

    def forward(self, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        decoded = self.decoder(output)
        return decoded, hidden

    def begin_state(self, *args, **kwargs):
        return self.rnn.begin_state(*args, **kwargs)


# ------------------------------------------------------------------ names
def _bigru(mod):
    return mod.GRU(7, 2, bidirectional=True, layout="NTC")


def _cell_stack(mod):
    s = mod.SequentialRNNCell()
    s.add(mod.LSTMCell(6))
    s.add(mod.ResidualCell(mod.GRUCell(6)))
    s.add(mod.RNNCell(5))
    return s


def _run(block, x, ndmod, ctx):
    arr = ndmod.array(x, ctx=ctx)
    if isinstance(block, (rnn.SequentialRNNCell, jrnn.SequentialRNNCell)):
        return block.unroll(x.shape[1], arr, merge_outputs=True)[0]
    return block(arr)


BLOCKS = {
    "lstm_lm": (lambda: JLM(V, E, H, L, dropout=0.0),
                lambda: LSTMLanguageModel(V, E, H, L, dropout=0.0),
                lambda rng: rng.randint(0, V, (B, T)).astype(np.float32)),
    "bigru": (lambda: _bigru(jrnn), lambda: _bigru(rnn),
              lambda rng: rng.randn(B, T, 5).astype(np.float32)),
    "cell_stack": (lambda: _cell_stack(jrnn), lambda: _cell_stack(rnn),
                   lambda rng: rng.randn(B, T, 6).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_params_from_jax_covers_every_name_both_ways(name, tmp_path):
    """Every structural name and shape, JAX into the port through
    `params_from_jax` and the port into the JAX package through a
    parameter file; then the same outputs."""
    make_j, make_t, data = BLOCKS[name]
    x = data(np.random.RandomState(0))
    mxj.random.seed(0)
    jb = make_j()
    jb.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    jout = _run(jb, x, mxj.nd, mxj.cpu())
    tb = make_t()
    tb.initialize(mx.init.Xavier(), ctx=mx.cpu())
    jw = _weights(jb)
    assert list(tb._collect_params_with_prefix()) == list(jw)
    params_from_jax(tb, jw)
    tw = _weights(tb)
    for k in jw:
        np.testing.assert_array_equal(tw[k], jw[k], k)
    np.testing.assert_allclose(_run(tb, x, nd, mx.cpu()).asnumpy(),
                               jout.asnumpy(), rtol=1e-5, atol=1e-6)
    # the other way: the port's weights, changed, into a fresh JAX block
    for p in tb.collect_params().values():
        p.set_data(p.data() * 0.5)
    path = str(tmp_path / "port.params")
    tb.save_parameters(path)
    jb2 = make_j()
    jb2.load_parameters(path, ctx=mxj.cpu())
    back = _weights(jb2)
    assert list(back) == list(jw)
    for k in jw:
        np.testing.assert_array_equal(back[k], jw[k] * 0.5, k)


def test_lstm_lm_names_init_and_devices(monkeypatch):
    """`rnn0_parameters` under the model's prefix, cuDNN's
    Uniform(hidden ** -0.5) for it under a global Xavier (Xavier for the
    embedding and decoder), the registry name, and no CUDA: the default
    context raises."""
    net = LSTMLanguageModel(1000, 64, 100, 2, dropout=0.0)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    names = [p.name for p in net.collect_params().values()]
    assert names[1].endswith("_rnn0_parameters")
    w = net.rnn.parameters_.data().asnumpy()
    assert 0.99 * 100 ** -0.5 < np.abs(w).max() <= 100 ** -0.5
    xavier = np.sqrt(3.0 / ((1000 + 64) / 2))
    enc = net.encoder.weight.data().asnumpy()
    assert 0.99 * xavier < np.abs(enc).max() <= xavier
    jnet = JLM(1000, 64, 100, 2, dropout=0.0)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    jw = jnet.rnn.parameters_.data().asnumpy()
    assert jnet.rnn.parameters_.name.endswith("_rnn0_parameters")
    assert w.shape == jw.shape
    assert abs(np.abs(w).max() - np.abs(jw).max()) < 1e-3
    assert isinstance(get_model("lstm_lm", vocab_size=10, embed_dim=4,
                                hidden=4, layers=1), LSTMLanguageModel)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        LSTMLanguageModel(10, 4, 4, 1).initialize()
    with pytest.raises(mx.MXNetError, match="CUDA is not available"):
        parallel.ParallelTrainer(net, lambda o, y: o, "sgd")


# ------------------------------------------------------------- training
def _lm_pair(dtype):
    """JAX and port LSTMLanguageModel with the same Xavier weights, cast."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (B, T)).astype(np.float32)
    y = rng.randint(0, V, (B, T)).astype(np.float32)
    mxj.random.seed(0)
    jnet = JLM(V, E, H, L, dropout=0.0)
    jnet.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    jnet.cast(dtype)
    tnet = LSTMLanguageModel(V, E, H, L, dropout=0.0)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    tnet.cast(dtype)
    params_from_jax(tnet, _weights(jnet) if dtype == "float32" else
                    {k: v.data().asnumpy() for k, v in
                     jnet._collect_params_with_prefix().items()})
    return jnet, tnet, x, y


@DTYPES
def test_lstm_lm_parallel_trainer_trajectory_matches_jax(dtype):
    """`bench_lstm`'s trainer (SGD lr 1.0, SoftmaxCrossEntropyLoss on the
    (B, T, V) logits): 2 `step`s then `run_steps(3)`, every loss and
    the final weights."""
    jnet, tnet, x, y = _lm_pair(dtype)
    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    opt = {"learning_rate": 1.0}
    jtr = jpar.ParallelTrainer(jnet, lambda o, l: jloss(o, l), "sgd", opt,
                               mesh=jpar.default_mesh(1))
    ttr = parallel.ParallelTrainer(
        tnet, lambda o, l: tloss(o, l), "sgd", opt,
        mesh=parallel.default_mesh(ctx=mx.cpu()))
    jd = [mxj.nd.array(a, ctx=mxj.cpu()) for a in (x, y)]
    with mx.cpu():
        td = [nd.array(a) for a in (x, y)]
    jl = [float(jtr.step(*jd).asnumpy()) for _ in range(2)]
    tl = [ttr.step(*td).asscalar() for _ in range(2)]
    jl.append(float(jtr.run_steps(3, *jd).asnumpy()))
    tl.append(ttr.run_steps(3, *td).asscalar())
    np.testing.assert_allclose(tl, jl, **LOSS_TOL[dtype])
    assert tl[-1] < tl[0] and ttr.num_update == 5
    _close_weights(tnet, jnet, WEIGHT_TOL[dtype])


@DTYPES
def test_word_lm_example_loop_matches_jax(dtype):
    """The example's loop (`train.py:97-157`) over five batches of its
    synthetic corpus: TNC, the hidden state carried and detached, a
    `gluon.Trainer` SGD at lr 1.0 with `clip_gradient` 0.25 (in bfloat16
    on a 1-D bf16 parameter beside the embedding's dense gradient); the
    JAX side is the example's own `RNNModel` and helpers.  Every loss,
    the carried state and the final weights."""
    ex = _example_module()
    bptt, batch = 5, B
    corpus = ex.synthetic_corpus(V, n=batch * (5 * bptt + 1), seed=0)
    data = ex.batchify(corpus, batch)
    mxj.random.seed(0)
    jm = ex.RNNModel(V, E, H, L, dropout=0.0)
    jm.initialize(mxj.init.Xavier(), ctx=mxj.cpu())
    jm.cast(dtype)
    tm = RNNModel(V, E, H, L, dropout=0.0)
    tm.initialize(mx.init.Xavier(), ctx=mx.cpu())
    tm.cast(dtype)
    params_from_jax(tm, {k: v.data().asnumpy() for k, v in
                         jm._collect_params_with_prefix().items()})
    opt = {"learning_rate": 1.0, "clip_gradient": 0.25}
    jtr = mxj.gluon.Trainer(jm.collect_params(), "sgd", opt)
    ttr = gluon.Trainer(tm.collect_params(), "sgd", opt)
    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    jh = jm.begin_state(func=mxj.nd.zeros, batch_size=batch, ctx=mxj.cpu())
    th = tm.begin_state(func=nd.zeros, batch_size=batch, ctx=mx.cpu())
    jl, tl = [], []
    for i in range(0, data.shape[0] - 1, bptt):
        jx, jy = ex.get_batch(data, i, bptt, mxj.cpu())
        with mx.cpu():
            tx, ty = (nd.array(a.asnumpy()) for a in (jx, jy))
        jh, th = ex.detach(jh), [h.detach() for h in th]
        with jag.record():
            out, jh = jm(jx, jh)
            loss = jloss(out.reshape(-1, out.shape[-1]),
                         jy.reshape(-1)).mean()
        loss.backward()
        jtr.step(1)
        jl.append(float(loss.asnumpy()))
        with autograd.record():
            out, th = tm(tx, th)
            loss = tloss(out.reshape(-1, out.shape[-1]),
                         ty.reshape(-1)).mean()
        loss.backward()
        ttr.step(1)
        tl.append(float(loss.asnumpy()))
    assert len(tl) == 5
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(tl, jl, **(EAGER_BF16_LOSS_TOL if bf16
                                          else LOSS_TOL[dtype]))
    assert tl[-1] < tl[0]
    tol = EAGER_BF16_WEIGHT_TOL if bf16 else WEIGHT_TOL[dtype]
    for a, b in zip(th, jh):
        ref = b.asnumpy().astype(np.float32)
        np.testing.assert_allclose(
            a.asnumpy().astype(np.float32), ref, rtol=tol["rtol"],
            atol=tol["atol_of_max"] * np.abs(ref).max())
    _close_weights(tm, jm, tol)


def test_lstm_lm_trains_with_dropout():
    """p = 0.5 in the embedding, between the LSTM's layers and before the
    decoder: the train step draws masks, the loss is finite and falls;
    predict mode draws nothing (two forwards agree)."""
    mx.random.seed(0)
    net = LSTMLanguageModel(V, E, H, L, dropout=0.5)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = parallel.ParallelTrainer(net, lambda o, l: tloss(o, l), "sgd",
                                  {"learning_rate": 1.0},
                                  mesh=parallel.default_mesh(ctx=mx.cpu()))
    rng = np.random.RandomState(1)
    with mx.cpu():
        x = nd.array(rng.randint(0, V, (8, T)).astype(np.float32))
        y = nd.array(rng.randint(0, V, (8, T)).astype(np.float32))
    losses = [tr.step(x, y).asscalar() for _ in range(8)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    with autograd.predict_mode():
        a, b = net(x).asnumpy(), net(x).asnumpy()
    np.testing.assert_array_equal(a, b)
