"""The port's sharded input (`incubator_mxnet_torch/io/sharded.py`) and
the staging ring, against the JAX package: `tests/test_io_sharded.py`
case for case, and the sharded batches over a world of 4 real ranks (a
gloo group of 4 spawned processes, one for the file), where each rank's
rows are its block of the trainer's batch.

Tolerances: shard bounds, slices, pads, assembled blocks and the ring's
order: exact; a trainer fed `LocalBatch`es against the same trainer fed
the whole batch: bit for bit (the same rows reach the same ranks); the
two decode engines: the same pixels (one codec behind both here; the
JAX test allows 4 levels between its two JPEG decoders).
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import io as jio

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import nd, io as mio, parallel as par

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_world import World  # noqa: E402


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def _one_mesh(axes=None):
    return par.Mesh(torch.device("cpu"), axes or {"dp": 1})


# ---------------------------------------------------------------- shards

def test_shard_bounds_disjoint_and_covering():
    for gb, ns in [(64, 1), (64, 2), (64, 8), (96, 3)]:
        seen = np.zeros(gb, bool)
        prev_stop = 0
        for r in range(ns):
            lo, hi = mio.shard_bounds(gb, r, ns)
            assert (lo, hi) == jio.shard_bounds(gb, r, ns)
            assert lo == prev_stop
            assert not seen[lo:hi].any()
            seen[lo:hi] = True
            prev_stop = hi
        assert seen.all()


def test_shard_bounds_indivisible_raises():
    with pytest.raises(mx.MXNetError, match="not divisible"):
        mio.shard_bounds(65, 0, 2)


def test_data_shard_info_env_fallback(monkeypatch):
    monkeypatch.setenv("MXNET_KV_LOCAL_SIZE", "4")
    monkeypatch.setenv("MXNET_KV_LOCAL_RANK", "2")
    assert mio.data_shard_info() == jio.data_shard_info() == (2, 4)
    assert mio.data_shard_info(rank=1, num_shards=3) == (1, 3)
    with pytest.raises(mx.MXNetError, match="outside"):
        mio.data_shard_info(rank=3, num_shards=3)


def test_data_shard_info_dmlc_fallback(monkeypatch):
    """Without the kvstore's local vars, the launcher's DMLC_* ones."""
    monkeypatch.delenv("MXNET_KV_LOCAL_SIZE", raising=False)
    monkeypatch.delenv("MXNET_KV_LOCAL_RANK", raising=False)
    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    monkeypatch.setenv("DMLC_WORKER_RANK", "1")
    assert mio.data_shard_info() == (1, 3)
    monkeypatch.delenv("DMLC_WORKER_RANK")
    monkeypatch.setenv("DMLC_RANK", "2")
    assert mio.data_shard_info() == (2, 3)
    monkeypatch.delenv("DMLC_NUM_WORKER")
    monkeypatch.delenv("DMLC_RANK")
    assert mio.data_shard_info() == (0, 1)


def test_sharded_iter_slices_global_batches():
    full = np.arange(32 * 3, dtype=np.float32).reshape(32, 3)
    labels = np.arange(32, dtype=np.float32)
    pieces = []
    with mx.cpu():
        for r in range(4):
            base = mio.NDArrayIter(full, labels, batch_size=32)
            it = mio.ShardedDataIter(base, rank=r, num_shards=4)
            jit = jio.ShardedDataIter(jio.NDArrayIter(full, labels,
                                                      batch_size=32),
                                      rank=r, num_shards=4)
            assert it.batch_size == jit.batch_size == 8
            assert it.global_batch == 32
            assert it.provide_data[0].shape == (8, 3)
            b, jb = it.next(), jit.next()
            np.testing.assert_array_equal(b.data[0].asnumpy(),
                                          jb.data[0].asnumpy())
            pieces.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    np.testing.assert_array_equal(
        np.concatenate([p[0] for p in pieces]), full)
    np.testing.assert_array_equal(
        np.concatenate([p[1] for p in pieces]), labels)


def test_sharded_iter_pad_is_per_shard():
    full = np.arange(40, dtype=np.float32).reshape(40, 1)
    pads, jpads = {}, {}
    with mx.cpu():
        for r in range(4):
            it = mio.ShardedDataIter(
                mio.NDArrayIter(full, np.zeros(40, np.float32),
                                batch_size=32, last_batch_handle="pad"),
                rank=r, num_shards=4)
            jit = jio.ShardedDataIter(
                jio.NDArrayIter(full, np.zeros(40, np.float32),
                                batch_size=32, last_batch_handle="pad"),
                rank=r, num_shards=4)
            it.next()
            jit.next()
            pads[r], jpads[r] = it.next().pad, jit.next().pad
    assert pads == jpads == {0: 0, 1: 8, 2: 8, 3: 8}, (pads, jpads)


def test_sharded_iter_pre_sharded_base_passthrough():
    local = np.full((8, 2), 3.0, np.float32)
    with mx.cpu():
        base = mio.NDArrayIter(local, np.zeros(8, np.float32), batch_size=8)
        it = mio.ShardedDataIter(base, rank=1, num_shards=4,
                                 base_is_sharded=True)
        assert it.batch_size == 8
        assert it.global_batch == 32
        np.testing.assert_array_equal(it.next().data[0].asnumpy(), local)


# ------------------------------------------------------------- assembly

def test_assembled_block_equals_the_trainers_cut(world):
    """Per-rank assembly from any number of shards is bit for bit the
    block the trainer cuts from the whole batch, on every rank."""
    full = np.random.RandomState(7).rand(48, 5).astype(np.float32)
    got = world.run("assemble_blocks", full, {"dp": 4})
    for r, blocks in enumerate(got):
        want = full[r * 12:(r + 1) * 12]
        for ns, (block, gshape) in blocks.items():
            assert gshape == (48, 5)
            assert block.tobytes() == want.tobytes(), ns


def test_assemble_global_single_shard_roundtrip():
    full = np.arange(16 * 2, dtype=np.float32).reshape(16, 2)
    g = mio.assemble_global(full, _one_mesh(), "dp", rank=0, num_shards=1)
    assert isinstance(g, mio.LocalBatch)
    assert np.array_equal(g.asnumpy(), full)
    assert g.global_shape == (16, 2)


def test_assemble_global_rejects_uncovered_rows(world):
    """A rank whose mesh block is not its shard gets a clean error, not
    another rank's rows: one device holding all rows given rank 1 of 2,
    and each rank of a dp = 4 mesh claiming to be shard 0 of 4 but
    rank 0."""
    local = np.zeros((8, 2), np.float32)
    with pytest.raises(mx.MXNetError, match="outside this"):
        mio.assemble_global(local, _one_mesh(), "dp", rank=1, num_shards=2)
    msgs = world.run("assemble_wrong_rank", local, {"dp": 4})
    assert msgs[0] is None
    assert all("outside this" in m for m in msgs[1:])


def test_trainer_place_batch_passes_assembled_arrays_through():
    """A `LocalBatch` is the trainer's block already: placement keeps
    its rows, and a step consumes it."""
    with mx.cpu():
        net = mx.gluon.nn.Dense(4)
        net.initialize()
        loss = mx.gluon.loss.L2Loss()
        tr = par.ParallelTrainer(net, lambda o, y: loss(o, y),
                                 mesh=par.default_mesh(ctx=mx.cpu()))
        x = np.random.RandomState(0).rand(16, 3).astype(np.float32)
        y = np.zeros((16, 4), np.float32)
        gx = mio.assemble_global(x, tr.mesh, tr.batch_axis, rank=0,
                                 num_shards=1)
        gy = mio.assemble_global(y, tr.mesh, tr.batch_axis, rank=0,
                                 num_shards=1)
        placed = tr._place(gx)
        assert placed.data.data_ptr() == gx.data.data_ptr()
        l = tr.step(gx, gy)
    assert np.isfinite(float(l.asnumpy()))


def test_sharded_iter_feeds_a_dp_trainer(world):
    """ShardedDataIter's per-rank batches through a dp = 4 trainer give
    the losses and weights of the same trainer fed the whole batch."""
    rng = np.random.RandomState(5)
    x = rng.randn(32, 6).astype(np.float32)
    y = rng.randint(0, 3, 32).astype(np.float32)
    got = world.run("sharded_train", x, y, {"dp": 4})
    for r in got:
        assert r["local_batch"] == 8 and r["global_batch"] == 32
        assert r["losses_sharded"] == r["losses_whole"]
        for a, b in zip(r["params_sharded"], r["params_whole"]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------- staging ring depth K

def test_device_prefetcher_depth_k_preserves_order():
    def gen(n):
        for i in range(n):
            yield (nd.array(np.full((4, 2), float(i), np.float32),
                            ctx=mx.cpu()),)

    for depth in (3, 4):
        for threads in (1, 2, 3):
            out = list(mio.DevicePrefetcher(gen(17), ctx=mx.cpu(),
                                            depth=depth, threads=threads))
            assert len(out) == 17
            got = [float(x.asnumpy()[0, 0]) for (x,) in out]
            assert got == [float(i) for i in range(17)], \
                (depth, threads, got)


def test_device_prefetcher_env_depth(monkeypatch):
    monkeypatch.setenv("MXNET_IO_STAGING_DEPTH", "5")
    ring = mio.DevicePrefetcher(iter(()), ctx=mx.cpu())
    jring = jio.DevicePrefetcher(iter(()), ctx=mxj.cpu())
    assert ring._depth == jring._depth == 5
    ring.close()
    jring.close()


def test_device_prefetcher_close_mid_batch_drains_before_source():
    """close() on a mid-epoch ring lets in-flight copies finish, stops
    every transfer thread, and only then returns."""
    class CountingSource:
        def __init__(self):
            self.lock = threading.Lock()
            self.readers = 0
            self.reads_after_close = 0
            self.closed = False
            self.n = 0

        def __iter__(self):
            return self

        def __next__(self):
            with self.lock:
                if self.closed:
                    self.reads_after_close += 1
                self.readers += 1
            time.sleep(0.01)
            with self.lock:
                self.readers -= 1
                self.n += 1
            return (nd.array(np.full((64, 8), float(self.n), np.float32),
                             ctx=mx.cpu()),)

    src = CountingSource()
    ring = mio.DevicePrefetcher(src, ctx=mx.cpu(), depth=3, threads=2)
    next(ring)
    next(ring)
    ring.close()
    assert not any(w.is_alive() for w in ring._workers)
    with pytest.raises(StopIteration):
        next(ring)
    src.closed = True
    time.sleep(0.05)
    assert src.reads_after_close == 0


def test_device_prefetcher_close_settles_staged_buffers():
    def gen():
        for i in range(10):
            yield (nd.array(np.full((8,), float(i), np.float32),
                            ctx=mx.cpu()),)

    ring = mio.DevicePrefetcher(gen(), ctx=mx.cpu(), depth=4, threads=2)
    next(ring)
    ring.close()
    assert ring._buf == {}
    assert not any(w.is_alive() for w in ring._workers)


def test_prefetching_iter_close_mid_epoch():
    data = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    with mx.cpu():
        it = mio.PrefetchingIter(mio.NDArrayIter(data, batch_size=4),
                                 prefetch_depth=2)
        it.next()
        it.close()
        assert it._thread is None or not it._thread.is_alive()
        with pytest.raises(StopIteration):
            it.next()
        it.reset()
        b = it.next()
        assert b.data[0].shape == (4, 3)
        it.close()


# --------------------------------------------------- native vs python

def _decode_shard(tmp_path_factory):
    from incubator_mxnet_torch.recordio import MXRecordIO, IRHeader, pack_img
    root = tmp_path_factory.mktemp("io_sharded_rec")
    path = str(root / "data.rec")
    rng = np.random.RandomState(3)
    rec = MXRecordIO(path, "w")
    for i in range(16):
        img = rng.randint(0, 255, (24, 24, 3), dtype=np.uint8)
        rec.write(pack_img(IRHeader(0, float(i), i, 0), img, quality=95))
    rec.close()
    return path


def test_native_vs_python_decode_pixel_parity(tmp_path_factory,
                                              monkeypatch):
    path = _decode_shard(tmp_path_factory)

    def drain(engine):
        monkeypatch.setenv("MXNET_NATIVE_IMAGE_PIPELINE", engine)
        with mx.cpu():
            it = mio.ImageRecordIter(path_imgrec=path,
                                     data_shape=(3, 24, 24), batch_size=8,
                                     shuffle=False, preprocess_threads=2)
            data, labels = [], []
            try:
                while True:
                    b = it.next()
                    data.append(b.data[0].asnumpy())
                    labels.append(b.label[0].asnumpy())
            except StopIteration:
                pass
        return np.concatenate(data), np.concatenate(labels)

    nat_d, nat_l = drain("1")
    py_d, py_l = drain("0")
    assert nat_d.shape == py_d.shape == (16, 3, 24, 24)
    np.testing.assert_array_equal(nat_l, py_l)
    assert np.abs(nat_d - py_d).max() <= 4.0


def test_decode_workers_env(monkeypatch):
    from incubator_mxnet_torch.io.native_image import decode_workers
    monkeypatch.delenv("MXNET_IO_DECODE_WORKERS", raising=False)
    assert decode_workers(None) == 4
    assert decode_workers(3) == 3
    monkeypatch.setenv("MXNET_IO_DECODE_WORKERS", "7")
    assert decode_workers(None) == 7
    assert decode_workers(2) == 2


def test_staged_ring_matches_unstaged_native(tmp_path_factory):
    from incubator_mxnet_torch.io.native_image import NativeImageRecordIter
    path = _decode_shard(tmp_path_factory)
    with mx.cpu():
        it = NativeImageRecordIter(path, (3, 24, 24), 8,
                                   preprocess_threads=2)
        ref = []
        try:
            while True:
                b = it.next()
                ref.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        except StopIteration:
            pass
        it.reset()
        ring = it.staging_ring(ctx=mx.cpu(), depth=3)
        got = [(x.asnumpy(), y.asnumpy()) for x, y in ring]
        ring.close()
        it.close()
    assert len(got) == len(ref) == 2
    for (rd, rl), (gd, gl) in zip(ref, got):
        np.testing.assert_array_equal(rd, gd)
        np.testing.assert_array_equal(rl, gl)
