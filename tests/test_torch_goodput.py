"""The goodput ledger of the port (`incubator_mxnet_torch/goodput.py`)
against the JAX package's (`incubator_mxnet_tpu/goodput.py`).

- `classify` on the same synthetic span sets: the same buckets, exactly
  (the rules are the JAX package's, pure Python on floats);
- the ledger's arithmetic (untraced MFU, k-step FLOPs, the memory
  watermark event) on the same inputs: the same records, exactly;
- the records of three `ParallelTrainer` steps of `bert_tiny` (weights
  by `convert.params_from_jax`): the same record keys and summary keys
  from both packages' ledgers;
- the FLOPs the port counts for one such step: the analytic count of the
  step's products, exactly (integers), and once per signature;
- the four debugz pages of the planes answering JSON through the port's
  debugz server, each with the JAX page's keys.
"""
import json
import time
import urllib.request

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import goodput as jgp
from incubator_mxnet_tpu import introspect as jins
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu import tracing as jtracing
from incubator_mxnet_tpu.models.bert import (
    get_bert_model as jax_get_bert_model, BERTClassifier as JaxClassifier)

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import (autograd, gluon, goodput, introspect,
                                   nd, parallel, telemetry, tracing)
from incubator_mxnet_torch.convert import params_from_jax
from incubator_mxnet_torch.models import get_model

VOCAB, T, N = 50, 16, 4


@pytest.fixture(autouse=True)
def _clean():
    for gp, ins in ((goodput, introspect), (jgp, jins)):
        gp._reset_for_tests()
        ins._reset_for_tests()
        gp.set_enabled(True)
        gp.set_peak_tflops(None)
    yield
    for gp, ins, tr in ((goodput, introspect, tracing),
                        (jgp, jins, jtracing)):
        gp.set_enabled(True)
        gp.set_peak_tflops(None)
        gp._reset_for_tests()
        ins._reset_for_tests()
        tr.set_enabled(False)
        tr.reset()


# -- classify: exact, on the JAX package's synthetic span sets ----------

SPAN_SETS = {
    "disjoint": ([("forward", 0.0, 0.5), ("backward", 1.0, 2.0),
                  ("io.h2d", 3.0, 3.5), ("wire.push_multi", 4.0, 6.0)],
                 0.0, 10.0),
    "nested_wire": ([("wire.push_multi", 1.0, 5.0), ("wire.frame", 1.5, 2.5),
                     ("wire.frame", 3.0, 4.0)], 0.0, 6.0),
    "wire_under_backward": ([("backward", 0.0, 4.0),
                             ("wire.push_multi", 0.5, 3.5)], 0.0, 4.0),
    "partial_overlap": ([("backward", 0.0, 2.0),
                         ("wire.pull_multi", 1.0, 5.0)], 0.0, 5.0),
    "input_minus_compute": ([("forward", 0.0, 2.0), ("io.h2d", 1.0, 3.0),
                             ("prefetch_stall", 3.5, 4.0)], 0.0, 5.0),
    "empty": ([], 2.0, 7.0),
    "clipped": ([("forward", -5.0, 1.0), ("wire.push", 9.0, 20.0)],
                0.0, 10.0),
    "straggler_tail": ([("wire.pull_multi", 0.0, 6.0),
                        ("server.round_close", 0.0, 6.0,
                         {"straggler": True, "straggler_wait_s": 2.0})],
                       0.0, 6.0),
    "not_straggler": ([("server.round_close", 0.0, 3.0,
                        {"straggler": False})], 0.0, 4.0),
    "straggler_no_attr": ([("server.round_close", 0.0, 30.0,
                            {"straggler": True})], 0.0, 30.0),
    "recovery_checkpoint": ([("recovery.reconnect", 0.0, 2.0),
                             ("wire.push", 0.5, 1.5),
                             ("checkpoint.save", 3.0, 4.0)], 0.0, 5.0),
    "compute_span_and_h2d": ([("compute", 0.1, 0.9), ("io.h2d", 0.0, 0.3),
                              ("kv.push", 0.85, 1.0)], 0.0, 1.0),
    "empty_window": ([("forward", 0.0, 1.0)], 1.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(SPAN_SETS))
def test_classify_matches_jax_exactly(case):
    spans, t0, t1 = SPAN_SETS[case]
    got = goodput.classify(spans, t0, t1)
    assert got == jgp.classify(spans, t0, t1)
    assert list(got) == list(goodput.BUCKETS) == list(jgp.BUCKETS)
    if t1 > t0:
        assert sum(got.values()) == pytest.approx(t1 - t0, rel=1e-12)


def test_classify_accepts_the_ports_span_objects():
    tracing.reset()
    tracing.set_enabled(True)
    with tracing.step_span():
        with tracing.span("forward"):
            time.sleep(0.01)
    tracing.set_enabled(False)
    sp = [s for s in tracing.spans() if s.name == "forward"]
    assert sp
    b = goodput.classify(sp, sp[0].t0 - 0.005, sp[0].t1 + 0.005)
    assert b["compute"] == pytest.approx(sp[0].duration, rel=1e-6)


# -- the ledger's arithmetic: same inputs, same records -------------------

def _no_memory(devs):
    return []


def _record_pair(fn):
    """fn(goodput module, ledger) on both packages; the two records."""
    out = []
    for gp in (goodput, jgp):
        led = gp.StepLedger("t-parity", memory_fn=_no_memory)
        out.append(fn(gp, led))
    return out


def test_untraced_record_and_mfu_match_jax():
    def run(gp, led):
        gp.set_peak_tflops(100.0)
        led.note_flops(1e12)
        rec = led.on_step(0.0, 0.5)
        return rec, led.summary()["window"]
    (rec, win), (jrec, jwin) = _record_pair(run)
    assert rec["mfu"] == pytest.approx(0.02)
    assert {k: v for k, v in rec.items() if k != "trainer"} == \
        {k: v for k, v in jrec.items() if k != "trainer"}
    assert win == jwin


def test_multi_step_flops_match_jax():
    def run(gp, led):
        gp.set_peak_tflops(1.0)
        led.set_executable("sig", {"flops": 4e9}, steps_per_call=4)
        return led.on_step(0.0, 1.0, steps=4)
    rec, jrec = _record_pair(run)
    assert rec["mfu"] == jrec["mfu"] == pytest.approx(4e-3)
    assert rec["flops"] == jrec["flops"]


def test_disabled_ledger_is_a_flag_check():
    for gp in (goodput, jgp):
        gp.set_enabled(False)
        led = gp.StepLedger("t-off", memory_fn=_no_memory)
        assert led.on_step(0.0, 1.0) is None
        assert led.summary()["window"]["steps"] == 0
        assert gp.last_record() is None


def test_hbm_watermark_events_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_HBM_WATERMARK_FRAC", "0.10")
    peaks = [1000, 1050, 1200, 1200]

    def run(gp, led):
        evs = []
        ins = introspect if gp is goodput else jins
        for i, peak in enumerate(peaks):
            led._memory_fn = lambda devs, p=peak: [
                {"device": "cuda:0", "bytes_in_use": 10,
                 "peak_bytes_in_use": p, "bytes_limit": 10000}]
            led.on_step(0.1 * i, 0.1 * (i + 1))
            evs.append(len([e for e in ins.flight_events()
                            if e.get("kind") == "hbm_watermark"]))
        return evs, led.summary()["hbm"]
    got, ref = _record_pair(run)
    assert got == ref == ([0, 0, 1, 1], {"cuda:0": 1200})
    assert telemetry.REGISTRY.value("hbm_peak_bytes", device="cuda:0") \
        == 1200


def test_peak_table_env_and_override(monkeypatch):
    assert goodput.peak_tflops_of("NVIDIA H100 80GB HBM3") == 989.0
    assert goodput.peak_tflops_of("NVIDIA H100 PCIe") == 756.0
    assert goodput.peak_tflops_of("NVIDIA A100-SXM4-80GB") == 312.0
    assert goodput.peak_tflops_of("TPU v5 lite") is None
    assert goodput.peak_flops() is None         # the CPU: no peak
    monkeypatch.setenv("MXNET_PEAK_TFLOPS", "2.0")
    assert goodput.peak_flops() == pytest.approx(2e12)
    assert goodput.peak_flops(device_count=4) == pytest.approx(8e12)
    monkeypatch.delenv("MXNET_PEAK_TFLOPS")
    goodput.set_peak_tflops(1.5)
    assert goodput.peak_flops() == pytest.approx(1.5e12)


def test_device_memory_is_empty_without_a_card():
    assert goodput.device_memory() == []
    led = goodput.StepLedger("t-cpu")
    rec = led.on_step(0.0, 0.1)
    assert rec["hbm_peak_bytes"] is None and led._mem_dead


# -- both packages' ParallelTrainer on bert_tiny -------------------------

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


def _trainers():
    jnet, tnet = _pair()
    jloss = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jpar.ParallelTrainer(jnet, lambda o, y: jloss(o, y), "adam",
                               {"learning_rate": 1e-3},
                               mesh=jpar.default_mesh(1))
    ttr = parallel.ParallelTrainer(tnet, lambda o, y: tloss(o, y), "adam",
                                   {"learning_rate": 1e-3},
                                   mesh=parallel.default_mesh(ctx=mx.cpu()))
    with mx.cpu():
        tdata = [nd.array(a) for a in _batch()]
    return (jtr, [mxj.nd.array(a, ctx=mxj.cpu()) for a in _batch()]), \
        (ttr, tdata), tnet


@pytest.mark.parametrize("tracing_on", [False, True])
def test_parallel_trainer_ledger_records_match_jax(tracing_on):
    (jtr, jd), (ttr, td), _ = _trainers()
    for tr in (tracing, jtracing):
        tr.reset()
        tr.set_enabled(tracing_on)
    for _ in range(3):
        jtr.step(*jd)
        ttr.step(*td)
    rec, jrec = goodput.last_record(), jgp.last_record()
    assert set(rec) == set(jrec)
    assert rec["untraced"] == jrec["untraced"] == (not tracing_on)
    assert rec["step"] == jrec["step"] == 2
    if tracing_on:
        assert set(rec["buckets"]) == set(jrec["buckets"])
        assert rec["buckets"]["compute"] > 0
        assert sum(rec["buckets"].values()) == pytest.approx(
            rec["wall_seconds"], rel=1e-9)
    summ, jsumm = ttr._ledger.summary(), jtr._ledger.summary()
    assert set(summ) - {"hbm"} == set(jsumm) - {"hbm"}
    assert set(summ["window"]) == set(jsumm["window"])
    assert summ["window"]["steps"] == jsumm["window"]["steps"] == 3
    # one signature, counted once, on the first step
    assert len(summ["executables"]) == 1
    assert summ["executables"][0]["flops"] > 0


def test_counted_flops_once_per_signature(monkeypatch):
    (_, _), (ttr, td), _ = _trainers()
    calls = []
    real = goodput.count_flops

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(goodput, "count_flops", counting)
    ttr.step(*td)
    ttr.step(*td)
    assert len(calls) == 1
    ttr.run_steps(2, *td)
    assert len(calls) == 2
    single = ttr._ledger._execs[ttr._signature(
        td[:-1], td[-1], False)]["flops"]
    multi = ttr._ledger._execs[ttr._signature(
        td[:-1], td[-1], False, 2)]
    assert multi["flops"] == 2 * single
    assert multi["flops_per_step"] == single


def bert_step_flops(n, t, layers, units, hidden, classes):
    """FLOPs of one BERT classifier train step at batch n, length t: 2 x
    the multiply-adds of each product, three times (the forward, then the
    weight and the input gradient, or for attention the gradients of
    both operands).  Per layer: qkv (3E), proj (E), ffn_1 and ffn_2 (F)
    over n t rows; QK^T and PV over n t^2 pairs of width E; then the
    pooler and the classifier over n rows."""
    per_layer = 2 * n * t * units * (4 * units + 2 * hidden) \
        + 4 * n * t * t * units
    head = 2 * n * units * (units + classes)
    return 3 * (layers * per_layer + head)


def test_counted_flops_are_the_analytic_count():
    """One bert_tiny step's counted FLOPs equal the analytic count of its
    products, exactly (integers)."""
    (_, _), (ttr, td), _ = _trainers()
    ttr.step(*td)
    counted = next(iter(ttr._ledger._execs.values()))["flops"]
    assert counted == bert_step_flops(N, T, layers=2, units=128,
                                      hidden=512, classes=2)


# -- the debugz pages --------------------------------------------------

@pytest.fixture
def debugz():
    srv = introspect.start_debugz(0)
    yield f"http://127.0.0.1:{int(srv)}"
    srv.close()


@pytest.mark.parametrize("page", ["goodputz", "numericz", "profilez",
                                  "tunerz"])
def test_planes_pages_answer_json_with_the_jax_keys(debugz, page):
    net = gluon.nn.Dense(1, in_units=4)
    net.initialize(mx.init.Constant(0.0), ctx=mx.cpu())
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    with mx.cpu():
        x = nd.array(np.ones((8, 4), np.float32))
        y = nd.array(np.ones((8, 1), np.float32))
    with autograd.record():
        loss = gluon.loss.L2Loss()(net(x), y)
    loss.backward()
    tr.step(batch_size=8)
    with urllib.request.urlopen(f"{debugz}/-/{page}", timeout=10) as r:
        assert r.status == 200
        got = json.loads(r.read())
    code, ref = jins.debugz_payload(f"/-/{page}")
    assert code == 200
    assert set(got) == set(ref)
    if page == "goodputz":
        assert got["buckets"] == list(jgp.BUCKETS)
        labels = [t["label"] for t in got["trainers"]]
        assert tr._ledger.label in labels
    assert f"/-/{page}" in introspect.DEBUGZ_PATHS


# -- the hand kernels' FLOPs: the formulas against the plain versions -----

def _plain_flops(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


@pytest.fixture
def fake_launches(monkeypatch):
    """The ctypes entry points replaced by ones that return success, so
    a wrapper's launch path (and its FLOP count) runs on CPU tensors;
    the outputs are not computed."""
    from incubator_mxnet_torch.ops import flash_attention as fa
    from incubator_mxnet_torch.tools import bottleneck_bwd as bnb
    monkeypatch.setattr(fa, "_entry", lambda *a, **k: (lambda *args: 0))
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(bnb, "entry", lambda lib, name, *a: (
        (lambda *args: 1) if name.endswith("groups")
        else (lambda *args: 0)))
    monkeypatch.setattr(bnb, "_stream", lambda t: 0)
    monkeypatch.setattr(bnb, "_device_args",
                        lambda name, dy, x, w, vecs: [dy, x, w, *vecs])
    yield fa, bnb
    fa.reset_launch_counts()
    bnb.reset_launch_counts()


def _kernel_cases(fa, bnb):
    import torch
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)
    bh, tq, tk, d = 3, 256, 384, 64
    q, do = rnd(bh, tq, d), rnd(bh, tq, d)
    k, v = rnd(bh, tk, d), rnd(bh, tk, d)
    lengths = torch.full((bh,), tk, dtype=torch.int32)
    o, lse = fa.flash_fwd_reference(q, k, v, lengths, 0.125, False, 128, 128)
    delta = (o * do).sum(-1, keepdim=True)
    bwd = (q, k, v, do, lse, delta, lengths, 0.125, False, 128, 128)
    B, T, H = 2, 128, 3
    qb, kb, vb, dob = (rnd(B, T, H, d) for _ in range(4))
    lb = torch.full((B,), T, dtype=torch.int32)
    ob, pb = fa.flash_short_bthd_reference(qb, kb, vb, lb, 0.125, False,
                                           True)
    deltab = (dob * ob).sum(-1).transpose(1, 2).contiguous()
    M, C, K = 256, 64, 128
    dy, x = rnd(M, K).bfloat16(), rnd(M, C).bfloat16()
    w, m, inv = (rnd(C, K) * 0.05).bfloat16(), rnd(K), torch.rand(K) + 0.5
    gamma = torch.rand(K) + 0.5
    s1, s2 = bnb.bottleneck_reduce_reference(dy, x, w, m, inv)
    return {
        "flash_fwd": (
            lambda: fa._launch_fwd(q, k, v, lengths, 0.125, False, 128,
                                   128),
            lambda: fa.flash_fwd_reference(q, k, v, lengths, 0.125, False,
                                           128, 128)),
        "flash_bwd_dq": (lambda: fa._launch_bwd("flash_bwd_dq", 1, *bwd),
                         lambda: fa.flash_bwd_dq_reference(*bwd)),
        "flash_bwd_dkv": (lambda: fa._launch_bwd("flash_bwd_dkv", 2, *bwd),
                          lambda: fa.flash_bwd_dkv_reference(*bwd)),
        "flash_short_bthd_fwd": (
            lambda: fa._launch_short(qb, kb, vb, lb, 0.125, False, False,
                                     "flash_short_bthd_fwd"),
            lambda: fa.flash_short_bthd_reference(qb, kb, vb, lb, 0.125,
                                                  False)),
        "flash_short_bthd_fwd_train": (
            lambda: fa._launch_short(qb, kb, vb, lb, 0.125, False, True,
                                     "flash_short_bthd_fwd_train"),
            lambda: fa.flash_short_bthd_reference(qb, kb, vb, lb, 0.125,
                                                  False, True)),
        "flash_short_bthd_bwd": (
            lambda: fa._launch_short_bthd_bwd(qb, kb, vb, dob, deltab, pb,
                                              0.125),
            lambda: fa.flash_short_bthd_bwd_reference(qb, kb, vb, dob,
                                                      deltab, pb, 0.125)),
        "bottleneck_bwd_reduce": (
            lambda: bnb._launch_reduce(dy, x, w, m, inv),
            lambda: bnb.bottleneck_reduce_reference(dy, x, w, m, inv)),
        "bottleneck_bwd_apply": (
            lambda: bnb._launch_apply(dy, x, w, m, inv, gamma, s1, s2),
            lambda: bnb.bottleneck_apply_reference(dy, x, w, m, inv, gamma,
                                                   s1, s2)),
    }


@pytest.mark.parametrize("name", [
    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_short_bthd_fwd",
    "flash_short_bthd_fwd_train", "flash_short_bthd_bwd",
    "bottleneck_bwd_reduce", "bottleneck_bwd_apply"])
def test_ctypes_kernels_count_their_plain_versions_flops(name,
                                                         fake_launches):
    """Rows 2-6 and 8 launch through ctypes, which torch's counter cannot
    see; each wrapper adds its own count at launch: the count torch gives
    the kernel's plain version on the same inputs, exactly."""
    from incubator_mxnet_torch import _kernels
    fa, bnb = fake_launches
    launch, plain = _kernel_cases(fa, bnb)[name]
    with _kernels.counting_flops() as acc:
        launch()
    assert acc[0] == _plain_flops(plain) > 0


@pytest.mark.parametrize("save_p", [False, True])
def test_registered_short_ops_count_their_plain_versions_flops(save_p):
    """Rows 1 and 1b are registered ops: torch's counter counts them by
    their formula (fake CUDA tensors here), as many FLOPs as the plain
    version's two products."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from incubator_mxnet_torch.ops import flash_attention as fa
    bh, t, d = 24, 128, 64
    op = getattr(torch.ops.mxnet_torch,
                 "flash_short_fwd_train" if save_p else "flash_short_fwd")
    with FakeTensorMode():
        q = torch.empty(bh, t, d, dtype=torch.bfloat16, device="cuda")
        lengths = torch.empty(bh, dtype=torch.int32, device="cuda")
        with FlopCounterMode(display=False) as fc:
            op(q, q, q, lengths, 0.125, False)
    q = torch.randn(bh, t, d)
    plain = _plain_flops(fa.flash_short_reference, q, q, q,
                         torch.full((bh,), t, dtype=torch.int32), 0.125,
                         False, save_p)
    assert fc.get_total_flops() == plain == 4 * bh * t * t * d
