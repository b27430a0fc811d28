"""The port's kvstore against the JAX package: the in-process stores,
2-bit compression, the dist store over one and two servers (threads of
this process on loopback), and the wire between the packages.

Mirrors `tests/test_kvstore.py`, `tests/test_gradient_compression.py` and
`tests/test_kvstore_multiserver.py` case for case, each scenario run
through both packages where the JAX package can run it, plus the wire
tests: a port worker against a JAX server and a JAX worker against a
port server (float32, bfloat16, bucketed, compressed, two servers), the
stored values equal bit for bit, and the bytes of a recorded frame
sequence equal between the packages.  Tolerances:

- merges, pulls, 2-bit codes and the wire: bit for bit (the same float
  adds in the same order; bfloat16 adds round once, as ml_dtypes does);
- a server-side SGD step: rtol 1e-6 (the same float32 formula);
- a Trainer trained 3 steps over the dist store from the same weights:
  rtol 1e-6, atol 1e-7 (the same float32 update on both sides).
"""
import os
import socket
import subprocess
import sys
import textwrap
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.kvstore import dist as jdist
from incubator_mxnet_tpu.kvstore import gradient_compression as jgc

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import nd, kvstore
from incubator_mxnet_torch.base import MXNetError
from incubator_mxnet_torch.kvstore import dist as tdist
from incubator_mxnet_torch.kvstore import gradient_compression as tgc
from incubator_mxnet_torch.kvstore.bucket import GradientBucketer

from _torch_kv_cases import (free_port, make_kv, run_ranks, run_workers,
                             start_servers, stop)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _a(x):
    return nd.array(np.asarray(x, np.float32), ctx=mx.cpu())


def _j(x):
    return jnd.array(np.asarray(x, np.float32))


# ---------------------------------------------------------------------
# the in-process stores (tests/test_kvstore.py)
# ---------------------------------------------------------------------

def _local_sequence(m, arr):
    kv = m.kvstore.create("local")
    kv.init(3, arr(np.ones((2, 3))))
    out = arr(np.zeros((2, 3)))
    kv.pull(3, out=out)
    first = out.asnumpy().copy()
    kv.push(3, arr(np.full((2, 3), 5.0)))
    kv.pull(3, out=out)
    return first, out.asnumpy()


def test_local_init_push_pull():
    got, ref = _local_sequence(mx, _a), _local_sequence(jmx, _j)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[1], 5.0)


def test_local_multi_device_reduce():
    outs = []
    for m, arr in ((mx, _a), (jmx, _j)):
        kv = m.kvstore.create("device")
        kv.init("w", arr(np.zeros(4)))
        kv.push("w", [arr(np.full(4, float(i))) for i in range(4)])
        out = arr(np.zeros(4))
        kv.pull("w", out=out)
        outs.append(out.asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], 6.0)


def test_list_keys_and_multiple_outs():
    kv = kvstore.create("tpu")
    kv.init([1, 2], [_a(np.ones(2)), _a(np.full(2, 2.0))])
    o1, o2 = _a(np.zeros(2)), _a(np.zeros(2))
    kv.pull([1, 2], out=[o1, o2])
    np.testing.assert_array_equal(o1.asnumpy(), 1.0)
    np.testing.assert_array_equal(o2.asnumpy(), 2.0)
    outs = [_a(np.zeros(2)), _a(np.zeros(2))]
    kv.pull(1, out=outs)
    for o in outs:
        np.testing.assert_array_equal(o.asnumpy(), 1.0)


def test_server_side_optimizer():
    outs = []
    for m, arr in ((mx, _a), (jmx, _j)):
        kv = m.kvstore.create("local")
        kv.init(0, arr(np.ones(3)))
        kv.set_optimizer(m.optimizer.SGD(learning_rate=0.1,
                                         rescale_grad=1.0))
        kv.push(0, arr(np.ones(3)))
        out = arr(np.zeros(3))
        kv.pull(0, out=out)
        outs.append(out.asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], **OPT_TOL)
    np.testing.assert_allclose(outs[0], 0.9, rtol=1e-6)


def test_gradient_compression_2bit_with_residual():
    outs = []
    for m, arr in ((mx, _a), (jmx, _j)):
        kv = m.kvstore.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 1.0})
        kv.init("g", arr(np.zeros(4)))
        v = [arr(np.full(4, 0.3)), arr(np.full(4, 0.3))]
        seen = []
        for _ in range(2):
            kv.push("g", v)
            out = arr(np.zeros(4))
            kv.pull("g", out=out)
            seen.append(out.asnumpy())
        outs.append(seen)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][0], 0.0)
    np.testing.assert_array_equal(outs[0][1], 1.0)


_WORKER_SCRIPT = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import incubator_mxnet_torch as mx
    from incubator_mxnet_torch import nd, kvstore

    with mx.cpu():
        kv = kvstore.create(os.environ["TEST_KV_TYPE"])
        rank, nw = kv.rank, kv.num_workers
        assert nw == 3, nw
        kv.init("w", nd.zeros((4,)))
        kv.pushpull("w", nd.full((4,), float(rank + 1)))
        out = nd.zeros((4,))
        kv.pull("w", out=out)
        np.testing.assert_array_equal(out.asnumpy(), 6.0)
        from incubator_mxnet_torch import optimizer as opt
        kv.init("v", nd.ones((2,)))
        kv.set_optimizer(opt.SGD(learning_rate=0.1, rescale_grad=1.0))
        kv.push("v", nd.full((2,), 1.0 / 3))
        kv.barrier()
        out2 = nd.zeros((2,))
        kv.pull("v", out=out2)
        np.testing.assert_allclose(out2.asnumpy(), 0.9, rtol=1e-5)
        print("worker", rank, "OK")
""")


@pytest.mark.parametrize("mode", ["dist_sync"])
def test_dist_kvstore_multiprocess(tmp_path, mode):
    """Three port worker processes against a port server (a thread of
    this process)."""
    port = free_port()
    ready = threading.Event()
    threading.Thread(target=tdist.run_server,
                     kwargs=dict(port=port, num_workers=3, sync=True,
                                 ready_event=ready), daemon=True).start()
    assert ready.wait(10)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER_SCRIPT.format(repo=REPO))
    env = dict(os.environ, DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_WORKER="3",
               TEST_KV_TYPE=mode, MXNET_KVSTORE_TIMEOUT="60")
    env.pop("MXNET_KVSTORE_SERVER_ADDRS", None)
    env.pop("DMLC_NUM_SERVER", None)
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env=dict(env, DMLC_WORKER_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(3)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()


def _dense_trained(m, arr, net, monkeypatch, pkg):
    """3 SGD steps of `net` with kvstore="dist_sync" against a server of
    `pkg` (one worker)."""
    srvs = start_servers(monkeypatch, 1, 1, pkg=pkg)
    tr = m.gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1}, kvstore="dist_sync")
    loss_fn = m.gluon.loss.L2Loss()
    x, y = arr(np.ones((2, 3))), arr(np.zeros((2, 4)))
    for _ in range(3):
        with m.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        tr.step(2)
    w = net.weight.data().asnumpy().copy()
    stop(srvs, [tr._kv])
    return w, tr


def test_trainer_with_dist_kvstore_singleworker(monkeypatch):
    """Trainer + update_on_kvstore against a real server, the port's
    trainer on a port server and the JAX trainer on a JAX server, from
    the same weights."""
    from incubator_mxnet_torch.convert import params_from_jax
    jnet = jmx.gluon.nn.Dense(4, in_units=3)
    jnet.initialize()
    tnet = mx.gluon.nn.Dense(4, in_units=3)
    tnet.initialize(ctx=mx.cpu())
    params_from_jax(tnet, {k: v.data().asnumpy() for k, v in
                           jnet._collect_params_with_prefix().items()})
    w0 = tnet.weight.data().asnumpy().copy()
    with mx.cpu():
        got, tr = _dense_trained(mx, _a, tnet, monkeypatch, "torch")
    ref, _ = _dense_trained(jmx, _j, jnet, monkeypatch, "jax")
    assert tr._update_on_kvstore and tr._kv_bucketer is not None
    assert not np.allclose(w0, got)
    np.testing.assert_allclose(got, ref, **OPT_TOL)


def test_dist_sync_stall_detection(monkeypatch):
    """A missing worker fails the live worker's push with a clean
    "stalled" error after MXNET_KVSTORE_TIMEOUT."""
    srvs = start_servers(monkeypatch, 1, 2, timeout=2)
    kv = make_kv(0)
    with mx.cpu(), pytest.raises(MXNetError, match="stalled"):
        kv.push("w", nd.ones((4,)))
    stop(srvs, [kv])


def test_horovod_kvstore_alias():
    kv = mx.kv.create("horovod")
    assert kv.type == jmx.kv.create("horovod").type == "tpu"
    a = _a(np.ones(4))
    kv.init("x", a)
    out = _a(np.zeros(4))
    kv.push("x", a)
    kv.pull("x", out=out)
    assert np.isfinite(out.asnumpy()).all()


# ---------------------------------------------------------------------
# 2-bit compression (tests/test_gradient_compression.py)
# ---------------------------------------------------------------------

def test_quantize_thresholds():
    g = np.array([0.7, -0.7, 0.3, -0.3, 0.0, 2.0], np.float32)
    tc, jc = tgc.GradientCompression(threshold=0.5), \
        jgc.GradientCompression(threshold=0.5)
    packed = tc.compress("k", torch.from_numpy(g))
    assert packed.tobytes() == jc.compress("k", g).tobytes()
    out = tc.decompress(packed, g.shape)
    np.testing.assert_array_equal(out, [0.5, -0.5, 0.0, 0.0, 0.0, 0.5])
    np.testing.assert_array_equal(tc.residual("k"), jc.residual("k"))


def test_wire_size_is_16x_smaller():
    g = np.random.RandomState(0).randn(1024).astype(np.float32)
    gc = tgc.GradientCompression(threshold=0.5)
    body = tgc.wire_body(gc, "k", torch.from_numpy(g))
    assert body == jgc.wire_body(jgc.GradientCompression(threshold=0.5),
                                 "k", g)
    assert len(body) - 9 == g.nbytes // 16      # [thr][ndim][shape] head


def test_residual_preserves_signal_over_rounds():
    gc = tgc.GradientCompression(threshold=0.5)
    g = np.full((8,), 0.2, np.float32)
    total = np.zeros_like(g)
    for _ in range(50):
        total += gc.decompress(gc.compress("k", g), g.shape)
    np.testing.assert_allclose(total + gc.residual("k"), 50 * g, atol=1e-5)
    assert float(total.mean()) > 0.8 * 50 * 0.2


def test_odd_sizes_roundtrip():
    gc = tgc.GradientCompression(threshold=1.0)
    for n in (1, 3, 5, 7, 17):
        g = np.linspace(-2, 2, n).astype(np.float32)
        body = tgc.wire_body(gc, f"k{n}", g)
        out = tdist._decode_cmp(body).numpy()
        ref = np.where(g >= 1.0, 1.0, np.where(g <= -1.0, -1.0, 0.0))
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, jdist._decode_cmp(body))


def test_bad_params_rejected():
    with pytest.raises(MXNetError):
        tgc.GradientCompression(type="1bit")
    with pytest.raises(MXNetError):
        tgc.GradientCompression(threshold=0.0)


def test_dist_kvstore_with_compression(monkeypatch):
    """Two workers push through a compressed dist_sync round: the server
    stores the quantized sum."""
    srvs = start_servers(monkeypatch, 1, 2)
    results = {}

    def worker(rank):
        kv = make_kv(rank)
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("w", _a(np.zeros(4)))
        kv.push("w", _a([0.7, -0.7, 0.1, 0.0]))
        out = _a(np.zeros(4))
        kv.pull("w", out=out)
        results[rank] = out.asnumpy()
        kv.close()

    run_ranks(worker)
    stop(srvs)
    for r in range(2):
        np.testing.assert_array_equal(results[r], [1.0, -1.0, 0.0, 0.0])


# ---------------------------------------------------------------------
# two servers (tests/test_kvstore_multiserver.py)
# ---------------------------------------------------------------------

@pytest.fixture
def cluster(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "64")
    srvs = start_servers(monkeypatch, 2, 2)
    made = []

    def make_worker(rank):
        kv = make_kv(rank)
        made.append(kv)
        return kv

    yield make_worker
    stop(srvs, made)


def test_small_key_roundtrip(cluster):
    results = {}

    def worker(rank):
        kv = cluster(rank)
        kv.init("w", _a(np.zeros((4, 3))))
        kv.push("w", _a(np.full((4, 3), 1.0 + rank)))
        out = _a(np.zeros((4, 3)))
        kv.barrier()
        kv.pull("w", out=out)
        results[rank] = out.asnumpy()

    run_ranks(worker)
    for r in (0, 1):
        np.testing.assert_array_equal(results[r], np.full((4, 3), 3.0))


def test_big_array_sharded_across_servers(cluster):
    base = np.arange(200, dtype=np.float32).reshape(10, 20)
    results = {}

    def worker(rank):
        kv = cluster(rank)
        kv.init("big", _a(np.zeros((10, 20))))
        kv.push("big", _a(base * (rank + 1)))
        out = _a(np.zeros((10, 20)))
        kv.barrier()
        kv.pull("big", out=out)
        results[rank] = out.asnumpy()

    run_ranks(worker)
    np.testing.assert_array_equal(results[0], base * 3.0)
    np.testing.assert_array_equal(results[1], base * 3.0)
    plan = cluster(0)._chunk_plan("big", 200)
    assert len(plan) == 2 and {srv for _, srv, _ in plan} == {0, 1}


def test_chunk_plan_caps_message_bytes_any_dtype(cluster, monkeypatch):
    """The ~1 GiB cap at the worst-case 8-byte itemsize, the same plan
    as the JAX worker's."""
    kv = cluster(0)
    jkv = jdist.KVStoreDist("dist_sync")
    big = 1 << 30
    plan = kv._chunk_plan("w", big)
    n = len(plan)
    assert n >= 8 and -(-big // n) * 8 <= (1 << 30)
    assert plan == kv._chunk_plan("w", big) == jkv._chunk_plan("w", big)
    jkv.close()


def test_big_array_with_compression(cluster):
    results = {}

    def worker(rank):
        kv = cluster(rank)
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("g", _a(np.zeros((16, 16))))
        kv.push("g", _a(np.full((16, 16), 0.7 if rank == 0 else -0.9)))
        out = _a(np.zeros((16, 16)))
        kv.barrier()
        kv.pull("g", out=out)
        results[rank] = out.asnumpy()

    run_ranks(worker)
    np.testing.assert_array_equal(results[0], np.zeros((16, 16)))


def test_server_side_optimizer_on_sharded_key(cluster):
    results = {}

    def worker(rank):
        kv = cluster(rank)
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
        kv.init("w", _a(np.ones((12, 10))))
        kv.push("w", _a(np.ones((12, 10))))
        out = _a(np.zeros((12, 10)))
        kv.barrier()
        kv.pull("w", out=out)
        results[rank] = out.asnumpy()

    run_ranks(worker)
    np.testing.assert_allclose(results[0], np.zeros((12, 10)), atol=1e-6)
    np.testing.assert_array_equal(results[0], results[1])


def test_launcher_two_servers_two_workers(tmp_path):
    """End to end through the port's launcher: real processes."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""
        import numpy as np
        import incubator_mxnet_torch as mx
        from incubator_mxnet_torch import nd
        with mx.cpu():
            kv = mx.kv.create("dist_sync")
            assert kv.num_workers == 2
            base = np.arange(200, dtype=np.float32).reshape(10, 20)
            kv.init("big", nd.zeros((10, 20)))
            kv.push("big", nd.array(base))
            out = nd.zeros((10, 20))
            kv.barrier()
            kv.pull("big", out=out)
            np.testing.assert_array_equal(out.asnumpy(), base * 2.0)
            print("WORKER_OK", kv.rank)
    """))
    env = dict(os.environ, MXNET_KVSTORE_BIGARRAY_BOUND="64",
               MXNET_KVSTORE_TIMEOUT="30")
    for k in ("DMLC_NUM_SERVER", "DMLC_NUM_WORKER", "DMLC_PS_ROOT_PORT",
              "MXNET_KVSTORE_SERVER_ADDRS"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "incubator_mxnet_torch.tools.launch", "-n",
         "2", "-s", "2", "--", sys.executable, str(script)], cwd=REPO,
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("WORKER_OK") == 2, r.stdout + r.stderr


def test_chunk_keys_keep_int_identity():
    from incubator_mxnet_torch.kvstore.base import _int_key
    from incubator_mxnet_tpu.kvstore.base import _int_key as jkey
    for k in ("3@1", "3", 7, 12):
        assert _int_key(k) == jkey(k)
    assert _int_key("3@1") == 3
    assert _int_key("w@0") == _int_key("w@1") == _int_key("w")


def test_updater_state_key_separates_chunks():
    from incubator_mxnet_torch import optimizer as opt
    u = opt.get_updater(opt.SGD(learning_rate=0.1, momentum=0.9))
    w0, w1 = _a(np.zeros(5)), _a(np.zeros(3))
    u(3, _a(np.ones(5)), w0, state_key="3@0")
    u(3, _a(np.ones(3)), w1, state_key="3@2")
    assert "3@0" in u.states and "3@2" in u.states
    np.testing.assert_allclose(w0.asnumpy(), np.full(5, -0.1), atol=1e-6)
    np.testing.assert_allclose(w1.asnumpy(), np.full(3, -0.1), atol=1e-6)


def test_dist_async_multiserver(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "64")
    srvs = start_servers(monkeypatch, 2, 1, sync=False)
    kv = make_kv(0, name="dist_async")
    base = np.arange(200, dtype=np.float32).reshape(10, 20)
    with mx.cpu():
        kv.init("w", _a(np.zeros((10, 20))))
        kv.push("w", _a(base))
        out = _a(np.zeros((10, 20)))
        kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), base)
    stop(srvs, [kv])


def test_dist_async_staleness_bound(monkeypatch):
    """A pull after one's own async push reads its own update, or both
    workers'; at the end every push applied exactly once."""
    srvs = start_servers(monkeypatch, 1, 2, sync=False)
    lr, grads = 0.5, {0: np.full((4, 8), 1.0, np.float32),
                      1: np.full((4, 8), 2.0, np.float32)}
    observed, kvs = {}, {}
    both_live = threading.Barrier(2)

    def worker(rank):
        kv = kvs[rank] = make_kv(rank, name="dist_async")
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=lr))
        kv.init("w", _a(np.zeros((4, 8))))
        both_live.wait(30)
        kv.push("w", _a(grads[rank]))
        out = _a(np.zeros((4, 8)))
        kv.pull("w", out=out)
        observed[rank] = out.asnumpy().copy()

    run_ranks(worker)
    for rank in (0, 1):
        got = observed[rank]
        assert np.allclose(got, -lr * grads[rank], atol=1e-5) or \
            np.allclose(got, -lr * (grads[0] + grads[1]), atol=1e-5)
    final = _a(np.zeros((4, 8)))
    with mx.cpu():
        kvs[0].pull("w", out=final)
    np.testing.assert_allclose(final.asnumpy(),
                               -lr * (grads[0] + grads[1]), atol=1e-5)
    stop(srvs, kvs.values())


def test_dist_async_survives_worker_death(monkeypatch):
    srvs = start_servers(monkeypatch, 1, 2, sync=False, timeout=60,
                         optimizer=mx.optimizer.SGD(learning_rate=1.0))
    survivor, doomed = make_kv(0, name="dist_async"), \
        make_kv(1, name="dist_async")
    with mx.cpu():
        t = threading.Thread(target=lambda: doomed.init(
            "w", _a(np.zeros((4, 8)))))
        t.start()
        survivor.init("w", _a(np.zeros((4, 8))))
        t.join(60)
        assert not t.is_alive()
        doomed.push("w", _a(np.ones((4, 8))))
        for s in doomed._socks.values():
            s.close()
        raw = socket.create_connection(("127.0.0.1", srvs[0].port),
                                       timeout=5)
        raw.sendall(b"\x01\x00")
        raw.close()
        for _ in range(3):
            survivor.push("w", _a(np.full((4, 8), 2.0)))
        out = _a(np.zeros((4, 8)))
        survivor.pull("w", out=out)
    np.testing.assert_allclose(out.asnumpy(), np.full((4, 8), -7.0),
                               atol=1e-5)
    stop(srvs, [survivor])


# ---------------------------------------------------------------------
# the wire between the packages
# ---------------------------------------------------------------------

WIRE_CASES = ("float32", "bfloat16", "bucketed", "compressed",
              "two-servers")


def _wire_grads(rank, case):
    rng = np.random.RandomState(10 + rank)
    return [rng.randn(*sh).astype(np.float32)
            for sh in ((6, 5), (40,), (3, 3))]


def _jax_arr(g, dtype):
    import jax.numpy as jnp
    return jnd.NDArray(jnp.asarray(g.astype(ml_dtypes.bfloat16)
                                   if dtype == "bfloat16" else g))


def _torch_arr(g, dtype):
    return nd.NDArray(torch.from_numpy(g).to(getattr(torch, dtype)))


def _wire_worker(pkg, rank, case, results):
    """One worker of a wire case: init, push its gradients, pull."""
    kv = make_kv(rank, pkg=pkg)
    dtype = "bfloat16" if case == "bfloat16" else "float32"
    arr = _jax_arr if pkg == "jax" else _torch_arr
    gs = [arr(g, dtype) for g in _wire_grads(rank, case)]
    if case == "compressed":
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    if case == "bucketed":
        items = [(i, tuple(g.shape), dtype) for i, g in enumerate(gs)]
        mod = GradientBucketer if pkg == "torch" else \
            __import__("incubator_mxnet_tpu.kvstore.bucket",
                       fromlist=["x"]).GradientBucketer
        b = mod(kv, items, target_bytes=256)
        b.allreduce(gs)
        results[pkg] = [_host(g) for g in gs]
    else:
        for i, g in enumerate(gs):
            kv.init(i, arr(np.zeros(g.shape, np.float32), dtype))
        for i, g in enumerate(gs):
            kv.push(i, g)
        kv.barrier()
        outs = [arr(np.zeros(g.shape, np.float32), dtype) for g in gs]
        for i, o in enumerate(outs):
            kv.pull(i, out=o)
        results[pkg] = [_host(o) for o in outs]
    kv.close()


def _host(a):
    """The bytes-exact host form of an NDArray of either package."""
    d = a._data
    if isinstance(d, torch.Tensor):
        return d.float().numpy() if d.dtype == torch.bfloat16 \
            else d.numpy().copy()
    return np.asarray(d).astype(np.float32)


def _expected(case):
    g0, g1 = _wire_grads(0, case), _wire_grads(1, case)
    if case == "bfloat16":
        return [(a.astype(ml_dtypes.bfloat16) + b.astype(ml_dtypes.bfloat16))
                .astype(np.float32) for a, b in zip(g0, g1)]
    if case == "compressed":
        def q(x):
            return np.where(x >= 0.5, 0.5, np.where(x <= -0.5, -0.5, 0.0))
        return [(q(a) + q(b)).astype(np.float32) for a, b in zip(g0, g1)]
    return [a + b for a, b in zip(g0, g1)]


@pytest.mark.parametrize("server", ["jax", "torch"])
@pytest.mark.parametrize("case", WIRE_CASES)
def test_wire_port_and_jax_workers_share_a_server(monkeypatch, server,
                                                  case):
    """Rank 0 is a port worker, rank 1 a JAX worker, against a server of
    `server`'s package: both pull the same bits, the bits of the sum,
    and the server stores them."""
    if case == "two-servers":
        monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "16")
    srvs = start_servers(monkeypatch, 2 if case == "two-servers" else 1,
                         2, pkg=server)
    results = {}
    run_workers([lambda: _wire_worker("torch", 0, case, results),
                 lambda: _wire_worker("jax", 1, case, results)])
    want = _expected(case)
    for got in (results["torch"], results["jax"]):
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes()
    if case != "bucketed":
        stored = {}
        for s in srvs:
            for k, v in s.store.items():
                stored[k] = _host(v)
        key = "0" if case != "two-servers" else "1@0"
        flat = want[0] if case != "two-servers" else want[1].reshape(-1)
        got = stored[key].reshape(-1)
        assert got.tobytes() == flat[:got.size].tobytes()
    stop(srvs)


def _record_frames(pkg, monkeypatch):
    """The frames one worker of `pkg` sends in a fixed session (init,
    push, pull, push_multi, pull_multi, a compressed push, barrier),
    the hello's session token blanked."""
    mod = {"torch": tdist, "jax": jdist}[pkg]
    srvs = start_servers(monkeypatch, 1, 1, pkg=pkg)
    sent = []
    real, real_hs = mod._send_msg, mod._send_msg_hs

    def rec(sock, op, key=b"", payload=b"", seq=0, epoch=0, xid=0,
            trace=None, **kw):
        sent.append(bytes(mod._frame_header(op, key, payload, seq, epoch,
                                            xid, trace)) + bytes(payload))
        return real(sock, op, key, payload, seq=seq, epoch=epoch, xid=xid,
                    trace=trace, **kw)

    def rec_hs(sock, op, key=b"", payload=b"", seq=0):
        sent.append(b"HELLO" + bytes(payload[:12]))
        return real_hs(sock, op, key, payload, seq)

    monkeypatch.setattr(mod, "_send_msg", rec)
    monkeypatch.setattr(mod, "_send_msg_hs", rec_hs)
    kv = make_kv(0, pkg=pkg)
    a = (lambda x: _torch_arr(x, "float32")) if pkg == "torch" else \
        (lambda x: _jax_arr(x, "float32"))
    b16 = (lambda x: _torch_arr(x, "bfloat16")) if pkg == "torch" else \
        (lambda x: _jax_arr(x, "bfloat16"))
    g = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    kv.init("w", a(np.zeros((3, 4), np.float32)))
    kv.push("w", a(g))
    kv.pull("w", out=a(np.zeros((3, 4), np.float32)))
    kv.init("h", b16(np.zeros(5, np.float32)))
    kv.push_multi(["h"], [b16(np.linspace(-1, 1, 5).astype(np.float32))])
    kv.pull_multi(["h"], [b16(np.zeros(5, np.float32))])
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.25})
    kv.push("w", a(g))
    kv.barrier()
    monkeypatch.setattr(mod, "_send_msg", real)
    monkeypatch.setattr(mod, "_send_msg_hs", real_hs)
    stop(srvs, [kv])
    return sent


def test_wire_recorded_frames_are_identical(monkeypatch):
    """The bytes of one worker session's frames, port against JAX."""
    got = _record_frames("torch", monkeypatch)
    ref = _record_frames("jax", monkeypatch)
    assert len(got) == len(ref) > 8
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g == r, (i, g[:64], r[:64])


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "int32", "uint8", "int8", "int64"])
def test_wire_pack_array_bytes(dtype):
    """`_pack_array` of each wire dtype: the JAX package's bytes, and
    back to the same values."""
    x = (np.arange(24).reshape(2, 3, 4) - 7).astype(np.float32) / 3
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    jx = x.astype(npdt)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    assert tdist._pack_array(t) == jdist._pack_array(jx)
    back = tdist._unpack_array(jdist._pack_array(jx))
    assert back.dtype == t.dtype and torch.equal(back, t)


@pytest.mark.parametrize("knob,value", [
    ("MXNET_KV_ELASTIC", "1"), ("MXNET_KV_SNAPSHOT_DIR", "/tmp/snap"),
    ("MXNET_KV_FAULT_PLAN", "send:3"), ("MXNET_KV_STRAGGLER_MS", "500"),
    ("MXNET_CKPT_DIR", "/tmp/ck"), ("MXNET_CKPT_EVERY_STEPS", "10"),
    ("MXNET_CONTROLLER", "1")])
def test_item_10b_knob_raises(monkeypatch, knob, value):
    """Each knob of ROADMAP item 10b raises, naming the item, in the
    store, the server and the trainer."""
    monkeypatch.setenv(knob, value)
    with pytest.raises(MXNetError, match="item 10b"):
        tdist.KVStoreDist("dist_sync")
    with pytest.raises(MXNetError, match="item 10b"):
        tdist._Server(0, 1)
    p = mx.gluon.Parameter("w", shape=(2,))
    p.initialize(ctx=mx.cpu())
    with pytest.raises(MXNetError, match="item 10b"):
        mx.gluon.Trainer([p], "sgd", kvstore="device")
