"""The port's `io` against the JAX package's on the CPU: every iterator's
batches, pads, descriptors and `state`/`restore` round trips (tokens
cross between the packages), `PrefetchingIter` over several iterators,
with a failing source, `close()` and the NaiveEngine mode, `CSVIter`,
`LibSVMIter`'s CSR batches, and `DevicePrefetcher`'s ordering, errors
and `close()` (the cases of tests/test_io_extras.py).

Tolerances: none.  The iterators copy and gather, so every batch, pad,
CSR member and dtype is held exactly equal.
"""
import itertools
import pickle
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401
import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import io as jio

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import io, nd


def _arrays(batch):
    return [a.asnumpy() for a in batch.data], \
        [a.asnumpy() for a in (batch.label or [])]


def _same_batches(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.pad == r.pad
        (gd, gl), (rd, rl) = _arrays(g), _arrays(r)
        for a, b in zip(gd + gl, rd + rl):
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)


def _data(seed=0, n=10):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 2),                      # float64
            rng.randint(0, 5, n),                    # int64
            rng.rand(n).astype(np.float32))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarrayiter_batches_match_jax(handle, shuffle):
    x, y, w = _data()
    kw = dict(batch_size=4, shuffle=shuffle, shuffle_seed=5,
              last_batch_handle=handle)
    with mx.cpu():
        got = io.NDArrayIter(x, y, **kw)
        ref = jio.NDArrayIter(x, y, **kw)
        assert got.provide_data == ref.provide_data
        assert got.provide_label == ref.provide_label
        for _ in range(2):                   # two epochs: reset reshuffles
            _same_batches(got, ref)
            got.reset()
            ref.reset()
        # dicts and lists of arrays name their entries the same way
        got = io.NDArrayIter({"a": x, "b": w}, [y, w], **kw)
        ref = jio.NDArrayIter({"a": x, "b": w}, [y, w], **kw)
        assert got.provide_data == ref.provide_data
        assert got.provide_label == ref.provide_label
        _same_batches(got, ref)


def _drain(it, n):
    return [it.next().data[0].asnumpy() for _ in range(n)]


def test_ndarrayiter_state_crosses_between_packages():
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    with mx.cpu():
        it = io.NDArrayIter(data, batch_size=4, shuffle=True,
                            shuffle_seed=3)
        ref = jio.NDArrayIter(data, batch_size=4, shuffle=True,
                              shuffle_seed=3)
        _drain(it, 2)
        _drain(ref, 2)
        token = pickle.loads(pickle.dumps(it.state()))
        want = _drain(ref, 3)
        ref.reset()
        want_next = _drain(ref, 2)
        for start in (io.NDArrayIter, jio.NDArrayIter):
            other = start(data, batch_size=4, shuffle=True, shuffle_seed=99)
            other.restore(token)
            for w, g in zip(want, _drain(other, 3)):
                np.testing.assert_array_equal(w, g)
            other.reset()    # the RNG state rode along: same next epoch
            for w, g in zip(want_next, _drain(other, 2)):
                np.testing.assert_array_equal(w, g)
        # a JAX token restores the port's iterator too
        it2 = io.NDArrayIter(data, batch_size=4, shuffle=True)
        ref2 = jio.NDArrayIter(data, batch_size=4, shuffle=True,
                               shuffle_seed=3)
        _drain(ref2, 1)
        it2.restore(ref2.state())
        for w, g in zip(_drain(ref2, 4), _drain(it2, 4)):
            np.testing.assert_array_equal(w, g)


def test_resize_iter_matches_jax_and_round_trips():
    data = np.arange(16, dtype=np.float32).reshape(8, 2)
    with mx.cpu():
        got = io.ResizeIter(io.NDArrayIter(data, batch_size=3), size=5)
        ref = jio.ResizeIter(jio.NDArrayIter(data, batch_size=3), size=5)
        _same_batches(got, ref)
        got.reset()
        _drain(got, 2)
        token = got.state()
        want = _drain(got, 3)
        again = io.ResizeIter(io.NDArrayIter(data, batch_size=3), size=5)
        again.restore(token)
        for w, g in zip(want, _drain(again, 3)):
            np.testing.assert_array_equal(w, g)
        with pytest.raises(StopIteration):
            again.next()


def test_stateless_iterator_refuses_a_token():
    base = io.DataIter(batch_size=2)
    assert base.state() is None
    base.restore(None)
    with pytest.raises(mx.MXNetError, match="cannot restore"):
        base.restore({"cursor": 1})


def test_prefetching_iter_two_iterators_match_jax():
    x, y, w = _data(1, 12)
    with mx.cpu():
        got = io.PrefetchingIter([io.NDArrayIter(x, y, 4),
                                  io.NDArrayIter({"w": w}, None, 4)])
        ref = jio.PrefetchingIter([jio.NDArrayIter(x, y, 4),
                                   jio.NDArrayIter({"w": w}, None, 4)])
        assert got.provide_data == ref.provide_data
        assert got.provide_label == ref.provide_label
        _same_batches(got, ref)
        with pytest.raises(StopIteration):
            got.next()
        got.reset()
        ref.reset()
        _same_batches(got, ref)
        got.close()


def test_prefetching_iter_runs_in_its_makers_context():
    """The worker thread has no scope of its own: it makes the batches
    in the context current when the iterator was made."""
    data = np.arange(8, dtype=np.float32).reshape(4, 2)
    with mx.cpu():
        it = io.PrefetchingIter(io.NDArrayIter(data, batch_size=2))
    assert it.next().data[0].context == mx.cpu()
    it.close()


def test_prefetching_iter_state_carries_pending_batches():
    data = np.arange(48, dtype=np.float32).reshape(24, 2)
    with mx.cpu():
        it = io.PrefetchingIter(io.NDArrayIter(data, batch_size=4))
        it.next()
        token = it.state()
        want = _drain(it, 5)
        for make in (io, jio):           # the JAX iterator takes it too
            other = make.PrefetchingIter(make.NDArrayIter(data, batch_size=4))
            other.restore(token)
            for w, g in zip(want, _drain(other, 5)):
                np.testing.assert_array_equal(w, g)
            other.close()
        it.close()


class _FailingIter(io.DataIter):
    """Two good batches, then the source fails."""

    def __init__(self):
        super().__init__(batch_size=2)
        self.n = 0

    provide_data = [io.DataDesc("data", (2, 3))]
    provide_label = [io.DataDesc("softmax_label", (2,))]

    def next(self):
        self.n += 1
        if self.n > 2:
            raise OSError("record file truncated")
        return io.DataBatch([nd.array(np.full((2, 3), float(self.n),
                                              np.float32))],
                            [nd.array(np.zeros(2, np.float32))], pad=0)

    def reset(self):
        self.n = 0


def test_prefetching_iter_rethrows_worker_exception():
    with mx.cpu():
        it = io.PrefetchingIter(_FailingIter())
    got = [it.next(), it.next()]
    assert [b.data[0].asnumpy()[0, 0] for b in got] == [1.0, 2.0]
    result = {}

    def consume():
        try:
            it.next()
        except OSError as e:
            result["exc"] = e

    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "consumer hung instead of seeing the error"
    assert "record file truncated" in str(result["exc"])
    with pytest.raises(OSError):            # terminal states are sticky
        it.next()
    it.reset()                              # reset() revives it
    np.testing.assert_array_equal(it.next().data[0].asnumpy(),
                                  np.full((2, 3), 1.0, np.float32))
    it.close()


def test_prefetching_iter_close_and_naive_engine(monkeypatch):
    data = np.arange(64, dtype=np.float32).reshape(32, 2)
    with mx.cpu():
        it = io.PrefetchingIter(io.NDArrayIter(data, batch_size=2),
                                prefetch_depth=1)
        it.next()
        it.close()
        assert not it._thread.is_alive()
        with pytest.raises(StopIteration):
            it.next()
        monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
        sync = io.PrefetchingIter(io.NDArrayIter(data, batch_size=4))
        assert sync._thread is None
        ref = jio.PrefetchingIter(jio.NDArrayIter(data, batch_size=4))
        assert ref._thread is None
        _same_batches(sync, ref)


def _write_csv(path, rows):
    path.write_text("\n".join(",".join(f"{v:.6g}" for v in r)
                              for r in rows) + "\n")


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    rng = np.random.RandomState(2)
    _write_csv(tmp_path / "d.csv", rng.randn(7, 6))
    _write_csv(tmp_path / "l.csv", rng.randint(0, 3, (7, 1)))
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=3,
              round_batch=round_batch)
    with mx.cpu():
        got, ref = io.CSVIter(**kw), jio.CSVIter(**kw)
        assert got.provide_data == ref.provide_data
        assert got.provide_label == ref.provide_label
        _same_batches(got, ref)
        got.reset()
        got.next()
        token = got.state()
        assert token["kind"] == "CSVIter"
        other = io.CSVIter(**kw)
        other.restore(token)
        ref.reset()
        ref.next()
        _same_batches(other, ref)
        # without a label file the labels are zeros
        kw.pop("label_csv")
        _same_batches(io.CSVIter(**kw), jio.CSVIter(**kw))


def _csr_equal(got, ref):
    assert got.stype == ref.stype == "csr"
    assert got.shape == ref.shape
    for attr in ("data", "indices", "indptr"):
        g, r = getattr(got, attr).asnumpy(), getattr(ref, attr).asnumpy()
        assert g.dtype == r.dtype, attr
        np.testing.assert_array_equal(g, r, err_msg=attr)
    np.testing.assert_array_equal(got.tostype("default").asnumpy(),
                                  ref.tostype("default").asnumpy())


def _write_libsvm(path, rng, rows, cols, nnz):
    lines = []
    for _ in range(rows):
        idx = np.sort(rng.choice(cols, nnz, replace=False))
        lines.append(f"{rng.randint(0, 2)} " + " ".join(
            f"{i}:{rng.randn():.5f}" for i in idx))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("round_batch", [True, False])
def test_libsvm_iter_matches_jax(tmp_path, round_batch):
    rng = np.random.RandomState(4)
    _write_libsvm(tmp_path / "d.libsvm", rng, 11, 50, 6)
    (tmp_path / "l.libsvm").write_text(
        "\n".join(f"{i % 3} {i % 2}" for i in range(11)) + "\n")
    kw = dict(data_libsvm=str(tmp_path / "d.libsvm"), data_shape=(50,),
              batch_size=4, round_batch=round_batch)
    for extra in ({}, {"label_libsvm": str(tmp_path / "l.libsvm"),
                       "label_shape": (2,)}):
        with mx.cpu():
            got = io.LibSVMIter(**kw, **extra)
            ref = jio.LibSVMIter(**kw, **extra)
            assert got.provide_data == ref.provide_data
            assert got.provide_label == ref.provide_label
            n = 0
            for g, r in itertools.zip_longest(got, ref):
                assert g is not None and r is not None
                assert g.pad == r.pad
                _csr_equal(g.data[0], r.data[0])
                np.testing.assert_array_equal(g.label[0].asnumpy(),
                                              r.label[0].asnumpy())
                n += 1
            assert n == (3 if round_batch else 2)
            got.reset()
            got.next()
            again = io.LibSVMIter(**kw, **extra)
            again.restore(got.state())
            _csr_equal(again.next().data[0], got.next().data[0])


def test_device_prefetcher_stages_csr_batches(tmp_path):
    """A LibSVMIter's CSR batches pass through the prefetcher whole."""
    _write_libsvm(tmp_path / "d.libsvm", np.random.RandomState(6), 9, 40, 5)
    kw = dict(data_libsvm=str(tmp_path / "d.libsvm"), data_shape=(40,),
              batch_size=4)
    with mx.cpu():
        ref = list(io.LibSVMIter(**kw))
    got = list(io.DevicePrefetcher(
        ((b.data[0], b.label[0]) for b in io.LibSVMIter(**kw)),
        ctx=mx.cpu(), threads=2))
    assert len(got) == len(ref) == 3
    for (csr, label), r in zip(got, ref):
        _csr_equal(csr, r.data[0])
        np.testing.assert_array_equal(label.asnumpy(), r.label[0].asnumpy())


def test_libsvm_label_count_mismatch_raises(tmp_path):
    d = tmp_path / "d.libsvm"
    d.write_text("1 0:1.0\n0 1:2.0\n")
    lab = tmp_path / "l.libsvm"
    lab.write_text("1\n")
    with pytest.raises(mx.MXNetError, match="label rows"):
        io.LibSVMIter(data_libsvm=str(d), data_shape=(4,),
                      label_libsvm=str(lab), batch_size=1)


def test_databatch_and_datadesc():
    d = io.DataDesc("data", [2, 3])
    assert d == mxj.io.DataDesc("data", [2, 3])
    assert d.shape == (2, 3) and d.layout == "NCHW"
    with mx.cpu():
        b = io.DataBatch([nd.zeros((2, 3))], pad=1)
    assert "(2, 3)" in repr(b) and b.pad == 1 and b.label is None


# -- DevicePrefetcher -----------------------------------------------------

def test_device_prefetcher_round_trip_and_errors():
    def gen():
        for i in range(5):
            yield (nd.array(np.full((4, 3), float(i), np.float32)),
                   np.ones(4) * i)

    out = list(io.DevicePrefetcher(gen(), ctx=mx.cpu()))
    assert len(out) == 5
    for i, (x, y) in enumerate(out):
        np.testing.assert_array_equal(x.asnumpy(), np.full((4, 3), float(i)))
        np.testing.assert_array_equal(y.asnumpy(), np.ones(4) * i)
        assert y.dtype == np.float32        # float64 staged as float32
        assert x.context == mx.cpu()

    def bad():
        yield nd.array(np.ones((2, 2), np.float32))
        raise RuntimeError("decode failed")

    it = io.DevicePrefetcher(bad(), ctx=mx.cpu())
    (first,) = next(it)                     # a single item comes as a tuple
    assert first.shape == (2, 2)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    with pytest.raises(StopIteration):      # terminal, not a hang
        next(it)


def test_device_prefetcher_close_stops_worker():
    def endless():
        for i in itertools.count():
            yield nd.array(np.full((2,), float(i), np.float32))

    it = io.DevicePrefetcher(endless(), ctx=mx.cpu(), depth=2)
    next(it)
    it.close()
    assert not any(w.is_alive() for w in it._workers)
    with pytest.raises(StopIteration):
        next(it)


@pytest.mark.parametrize("threads", [2, 3])
def test_device_prefetcher_multistream_preserves_order(threads):
    def gen(n):
        for i in range(n):
            yield (nd.array(np.full((4,), float(i), np.float32)),)

    for n in (0, 1, 7, 12):
        out = list(io.DevicePrefetcher(gen(n), ctx=mx.cpu(), depth=2,
                                       threads=threads))
        assert [float(x.asnumpy()[0]) for (x,) in out] == \
            [float(i) for i in range(n)]

    def bad():
        yield (nd.array(np.ones((2,), np.float32)),)
        yield (nd.array(np.ones((2,), np.float32)),)
        raise RuntimeError("decode failed")

    it = io.DevicePrefetcher(bad(), ctx=mx.cpu(), threads=threads)
    next(it)
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    it.close()


def test_device_prefetcher_order_matches_jax_over_an_iterator():
    """Over an NDArrayIter (pulled under cpu() on the transfer threads)
    with threads=3, the staged batches are the JAX prefetcher's."""
    x, y, _ = _data(3, 30)
    with mx.cpu():
        src = [(b.data[0], b.label[0]) for b in
               io.NDArrayIter(x, y, 4, shuffle=True, shuffle_seed=1)]
        ref = list(jio.DevicePrefetcher(
            ((b.data[0], b.label[0]) for b in
             jio.NDArrayIter(x, y, 4, shuffle=True, shuffle_seed=1)),
            ctx=mxj.cpu(), threads=3))
    got = list(io.DevicePrefetcher(iter(src), ctx=mx.cpu(), threads=3))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_device_prefetcher_sync_clones_on_a_cpu_destination():
    """The zero-copy contract: with sync=True a reused source buffer is
    cloned on a CPU destination; without it the host tensor passes."""
    slot = torch.zeros(3)

    def reuse():
        for i in range(3):
            slot.fill_(float(i))
            yield (slot,)

    got = [x.asnumpy()[0] for (x,) in io.DevicePrefetcher(
        reuse(), ctx=mx.cpu(), sync=True)]
    assert got == [0.0, 1.0, 2.0]
    (x,), = list(io.DevicePrefetcher(iter([(slot,)]), ctx=mx.cpu()))
    assert x.data.data_ptr() == slot.data_ptr()


def test_device_prefetcher_places_on_the_trainers_device():
    net = mx.gluon.nn.Dense(2)
    net.initialize(ctx=mx.cpu())
    tr = mx.parallel.ParallelTrainer(
        net, mx.gluon.loss.L2Loss(), "sgd",
        mesh=mx.parallel.default_mesh(ctx=mx.cpu()))
    batches = [(np.ones((4, 3)), np.zeros((4, 2))) for _ in range(2)]
    losses = [tr.step(x, y).asscalar()
              for x, y in io.DevicePrefetcher(iter(batches), trainer=tr)]
    assert len(losses) == 2 and np.isfinite(losses).all()
