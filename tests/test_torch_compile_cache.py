"""The persistent compile cache of the port
(`incubator_mxnet_torch/compile_cache.py`), which keeps `deploy`'s
AOTInductor packages, against the JAX package's cache
(`incubator_mxnet_tpu/compile_cache.py`), which keeps XLA executables.

- a tiny block's CPU export (`export_serving(..., platforms=("cpu",))`):
  a miss that compiles and stores the package, then a second export of
  the same block into another directory that is a hit, compiles nothing
  and writes the same bytes;
- two concurrent writers of one key leave one whole entry;
- eviction under `max_bytes()`: the same entries leave as in the JAX
  package's cache, oldest first, the newest kept;
- a changed backend token (another torch or card) is a miss;
- a corrupt entry is a miss and is removed;
- `stats()`/`cachez()` carry the JAX package's keys.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj  # noqa: F401 — package init
from incubator_mxnet_tpu import compile_cache as jcc

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import compile_cache as cc
from incubator_mxnet_torch import deploy
from incubator_mxnet_torch.models import get_model


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(d))
    monkeypatch.delenv("MXNET_COMPILE_CACHE_MAX_MB", raising=False)
    cc._reset_for_tests()
    yield d
    cc._reset_for_tests()


def _mlp(seed):
    mx.random.seed(seed)
    net = get_model("mlp", hidden=(32,), classes=10)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = np.random.RandomState(7).randn(4, 16).astype(np.float32)
    with mx.cpu():
        net(mx.nd.array(x))
    return net, [x]


def test_export_miss_then_bit_identical_hit(cache_dir, tmp_path,
                                            monkeypatch):
    net, xs = _mlp(0)
    s0 = cc.stats()
    deploy.export_serving(net, xs, str(tmp_path / "a"), platforms=("cpu",))
    s1 = cc.stats()
    assert s1["misses"] == s0["misses"] + 1 and s1["puts"] == s0["puts"] + 1
    assert s1["entries"] == 1 and s1["compile_seconds"] > 0
    # another block of the same architecture (other weights): weights are
    # inputs of the exported program, so the key is the same
    other, _ = _mlp(1)
    import torch._inductor

    def no_compile(*a, **k):
        raise AssertionError("a cache hit must compile nothing")
    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package",
                        no_compile)
    deploy.export_serving(other, xs, str(tmp_path / "b"),
                          platforms=("cpu",))
    s2 = cc.stats()
    assert s2["hits"] == s1["hits"] + 1
    assert s2["compile_seconds"] == s1["compile_seconds"]
    a = (tmp_path / "a" / "model_native_cpu.pt2").read_bytes()
    b = (tmp_path / "b" / "model_native_cpu.pt2").read_bytes()
    assert a == b and len(a) > 0
    deploy.validate_artifact(str(tmp_path / "b"))


def test_concurrent_writers_same_key(cache_dir):
    key = "k" * 64
    blobs = [bytes([i]) * 200_000 for i in range(2)]
    errors = []

    def writer(blob):
        try:
            for _ in range(20):
                assert cc.put(key, blob, stats={"n": 1})
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)
    ths = [threading.Thread(target=writer, args=(b,)) for b in blobs]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    hit = cc.get(key)
    assert hit is not None and hit[0] in blobs
    assert hit[1] == {"n": 1, "cache": "hit"}
    assert [n for n in os.listdir(cache_dir)] == [key + ".cce"]


def _fill(d, sizes):
    """Entries of `sizes` bytes in cache dir `d`, each older than the
    next (mtimes 1000, 1001, ...)."""
    d.mkdir(exist_ok=True)
    for i, n in enumerate(sizes):
        path = d / f"{i:064d}.cce"
        path.write_bytes(b"x" * n)
        os.utime(path, (1000.0 + i, 1000.0 + i))
    return str(d / f"{len(sizes) - 1:064d}.cce")


@pytest.mark.parametrize("sizes", [
    [200_000, 150_000, 100_000, 250_000],
    [100_000] * 8,
    [600_000, 10_000, 20_000],
    [10_000, 20_000, 600_000]])
def test_eviction_under_max_bytes_matches_jax(sizes, tmp_path,
                                              monkeypatch):
    """One directory of entries over a 0.5 MB cap, evicted by each
    package's cache, the newest entry the one just written: the same
    survivors (oldest out first; the newest kept unless it alone is
    over the cap)."""
    monkeypatch.setenv("MXNET_COMPILE_CACHE_MAX_MB", str(0.5))
    assert cc.max_bytes() == jcc.max_bytes() == 512 * 1024
    left = []
    for mod, name in ((cc, "port"), (jcc, "jax")):
        d = tmp_path / name
        newest = _fill(d, sizes)
        monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(d))
        mod._evict(keep=newest)
        left.append(sorted(p.name for p in d.iterdir()))
    assert left[0] == left[1]
    assert sum(sizes) <= cc.max_bytes() or len(left[0]) < len(sizes)


def test_put_evicts_over_the_cap(cache_dir, monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_MAX_MB", str(0.5))
    before = cc.stats()["evictions"]
    for i in range(4):
        assert cc.put(f"{i:064d}", b"x" * 200_000)
    assert cc.stats()["evictions"] > before
    assert cc.total_bytes() <= cc.max_bytes()
    assert cc.get(f"{3:064d}") is not None


def test_changed_backend_token_is_a_miss(cache_dir, monkeypatch):
    net, xs = _mlp(0)
    from incubator_mxnet_torch.deploy import _Traced
    with torch.no_grad():
        prog = torch.export.export(_Traced(lambda x: (x * 2 + 1,)),
                                   (torch.ones(3, 4),))
    k1 = cc.cache_key(prog, extra={"package": "p.pt2"})
    assert k1 == cc.cache_key(prog, extra={"package": "p.pt2"})
    cc.put(k1, b"package-bytes")
    assert cc.get(k1)[0] == b"package-bytes"
    real = cc.backend_token()
    monkeypatch.setattr(cc, "backend_token",
                        lambda: dict(real, torch="0.0.0"))
    k2 = cc.cache_key(prog, extra={"package": "p.pt2"})
    assert k2 != k1 and cc.get(k2) is None
    monkeypatch.setattr(cc, "backend_token",
                        lambda: dict(real, device_kind="NVIDIA H100"))
    assert cc.cache_key(prog, extra={"package": "p.pt2"}) != k1
    # another program or another extra: other keys
    with torch.no_grad():
        other = torch.export.export(_Traced(lambda x: (x * 3 + 1,)),
                                    (torch.ones(3, 4),))
    monkeypatch.setattr(cc, "backend_token", lambda: real)
    assert cc.cache_key(other, extra={"package": "p.pt2"}) != k1
    assert cc.cache_key(prog, extra={"package": "q.pt2"}) != k1


def test_corrupt_entry_is_a_miss_and_removed(cache_dir):
    key = "c" * 64
    cc.put(key, b"y" * 1000)
    path = cache_dir / (key + ".cce")
    data = path.read_bytes()
    path.write_bytes(data[:-10])
    misses = cc.stats()["misses"]
    assert cc.get(key) is None
    assert not path.exists() and cc.stats()["misses"] == misses + 1


def test_disabled_cache_is_inert(monkeypatch):
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    assert not cc.enabled() and cc.get("x" * 64) is None
    assert not cc.put("x" * 64, b"z") and cc.entry_count() == 0


def test_stats_and_cachez_carry_the_jax_keys(cache_dir):
    assert set(cc.stats()) == set(jcc.stats())
    z = cc.cachez()
    assert set(z) - {"backend"} == set(jcc.stats())
    assert set(z["backend"]) == {"format", "torch", "cuda", "device_kind",
                                 "capability"}
    assert z["backend"]["format"] == cc.FORMAT_VERSION
    assert time.time() > 0
