"""The host runtime of the port against the JAX package's: the
dependency engine and the storage pool (`incubator_mxnet_torch/engine.py`,
`storage.py` on the port's own copies `csrc/engine.cc`, `csrc/storage.cc`,
built into the host library by `_native`), `resource`, `runtime`,
`test_utils`, and the tools `parse_log`, `fleetz` and `diagnose`.

- the same execution order for the same dependent pushes: with
  ``NaiveEngine`` the whole log, exactly; with worker threads the order
  every var imposes (FIFO writes, reads between their writes), exactly;
- an async error rethrown at `wait_for_var` and `wait_all`, dependents
  skipped, as in the JAX package's engine;
- the pool: reuse, 64-byte alignment, stats with the JAX pool's keys;
- `parse_log` and `fleetz` on the same logs and snapshots: the same
  tables and reports, exactly (the JAX tools loaded by path);
- `check_consistency` over two contexts, `Features` with the JAX
  package's names where they apply.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import engine as jengine
from incubator_mxnet_tpu import runtime as jruntime
from incubator_mxnet_tpu.storage import Storage as JStorage

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import engine, resource, runtime, test_utils
from incubator_mxnet_torch.base import MXNetError
from incubator_mxnet_torch.storage import Storage
from incubator_mxnet_torch.tools import fleetz, parse_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the engine ---------------------------------------------------------

def _program(seed, nvars=5, nops=60):
    """A seeded random program: (reads, writes) var indices per op."""
    rng = np.random.RandomState(seed)
    prog = []
    for _ in range(nops):
        w = sorted(set(rng.choice(nvars, rng.randint(0, 3), replace=False)
                       .tolist()))
        r = sorted(set(rng.choice(nvars, rng.randint(0, 3), replace=False)
                       .tolist()) - set(w))
        prog.append((r, w))
    return prog


def _run(Engine, prog, naive, nvars=5):
    eng = Engine(num_workers=4, naive=naive)
    vars_ = [eng.new_var() for _ in range(nvars)]
    log, lock = [], threading.Lock()

    def op(i):
        with lock:
            log.append(i)
    for i, (r, w) in enumerate(prog):
        eng.push(lambda i=i: op(i), const_vars=[vars_[j] for j in r],
                 mut_vars=[vars_[j] for j in w])
    eng.wait_all()
    for v in vars_:
        eng.delete_var(v)
    eng.destroy()
    return log


def _var_orders(prog, log, nvars=5):
    """For each var, the order its writes ran in, and for each read the
    count of that var's writes before it: what the protocol fixes."""
    pos = {op: k for k, op in enumerate(log)}
    out = []
    for v in range(nvars):
        writes = [i for i, (_, w) in enumerate(prog) if v in w]
        reads = [i for i, (r, _) in enumerate(prog) if v in r]
        out.append((sorted(writes, key=pos.get),
                    {i: sum(pos[w] < pos[i] for w in writes)
                     for i in reads}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_naive_engine_runs_in_push_order_as_jax(seed):
    prog = _program(seed)
    got = _run(engine.Engine, prog, naive=True)
    assert got == _run(jengine.Engine, prog, naive=True)
    assert got == list(range(len(prog)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_threaded_engine_keeps_the_var_order_of_jax(seed):
    prog = _program(seed)
    got = _run(engine.Engine, prog, naive=False)
    ref = _run(jengine.Engine, prog, naive=False)
    assert sorted(got) == sorted(ref) == list(range(len(prog)))
    want = _var_orders(prog, list(range(len(prog))))
    assert _var_orders(prog, got) == _var_orders(prog, ref) == want


def test_async_error_at_wait_for_var_as_jax():
    msgs = []
    for Engine, Err in ((engine.Engine, MXNetError),
                        (jengine.Engine, mxj.base.MXNetError)):
        eng = Engine(num_workers=2, naive=False)
        v, w = eng.new_var(), eng.new_var()
        ran = []
        eng.push(lambda: 1 / 0, mut_vars=[v])          # no raise here
        eng.push(lambda: ran.append(1), const_vars=[v], mut_vars=[w])
        with pytest.raises(Err) as e:
            eng.wait_for_var(w)
        msgs.append(str(e.value))
        assert ran == []                    # the dependent was skipped
        with pytest.raises(Err):
            eng.wait_all()
        eng.wait_all()                      # drained once
        assert eng._payloads == {}
        eng.destroy()
    assert msgs[0] == msgs[1] and "ZeroDivisionError" in msgs[0]


def test_engine_type_bulk_and_wait_all(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert engine.engine_type() == jengine.engine_type() == "NaiveEngine"
    with pytest.raises(ValueError):
        engine.set_engine_type("BogusEngine")
    prev = engine.set_bulk_size(30)
    with engine.bulk(5):
        assert engine._bulk_size == 5
    assert engine.set_bulk_size(prev) == 30
    engine.wait_all()


def test_rmw_stress_loses_no_update():
    eng = engine.Engine(num_workers=8, naive=False)
    nvars = 6
    vars_ = [eng.new_var() for _ in range(nvars)]
    cells = [[0] for _ in range(nvars)]
    rng = np.random.RandomState(0)
    expected = [0] * nvars
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(400):
            i, j = int(rng.randint(nvars)), int(rng.randint(nvars))
            expected[i] += 1

            def rmw(c=cells[i]):
                x = c[0]
                c[0] = x + 1
            eng.push(rmw, mut_vars=[vars_[i]],
                     const_vars=[vars_[j]] if j != i else [])
        eng.wait_all()
    finally:
        sys.setswitchinterval(switch)
    assert [c[0] for c in cells] == expected
    eng.destroy()


# -- storage, resource ---------------------------------------------------

def test_storage_pool_reuse_alignment_and_stats():
    s = Storage()
    h1 = s.alloc(1 << 20)
    h1.asbuffer(np.float32)[:16] = np.arange(16, dtype=np.float32)
    ptr = h1.ptr
    h1.free()
    h2 = s.alloc(1 << 20)
    assert h2.ptr == ptr and s.stats()["pool_hits"] >= 1
    hs = [s.alloc(n) for n in (1, 63, 64, 1000, 4096)]
    assert all(h.ptr % 64 == 0 for h in hs)
    for h in hs + [h2]:
        h.free()
    assert set(s.stats()) == set(JStorage().stats())
    s.release_all()
    assert s.stats()["bytes_pooled"] == 0


def test_storage_profile_events():
    s = Storage()
    s.profile(True)
    h = s.alloc(4096)
    h.free()
    events, now, dropped = s.profile_drain()
    s.profile(False)
    assert len(events) >= 2 and dropped == 0 and now > 0
    assert {e.kind for e in events} >= {2}          # a free


def test_resource_temp_space_and_generator():
    r = resource.request_temp_space(4 * 6)
    view = r.space((2, 3), np.float32)
    view[:] = 7
    assert float(view.sum()) == 42.0
    with pytest.raises(MXNetError):
        r.space((100,), np.float32)
    r.release()
    mx.random.seed(3)
    a = resource.request_prng_key(mx.cpu())
    import torch
    x = torch.rand(4, generator=a)
    mx.random.seed(3)
    from incubator_mxnet_torch import random as _random
    _random._generators.clear()
    b = resource.request_prng_key(mx.cpu())
    assert torch.equal(x, torch.rand(4, generator=b))


# -- runtime, test_utils ------------------------------------------------

def test_features_keep_the_jax_names():
    feats = runtime.Features()
    jfeats = jruntime.Features()
    shared = set(jfeats) - {"BLAS_XLA"}
    assert shared <= set(feats)
    assert not feats.is_enabled("TPU") and not feats.is_enabled("XLA")
    assert feats.is_enabled("cpu") and feats.is_enabled("PROFILER")
    assert feats.is_enabled("CUDA") == (mx.context.num_gpus() > 0)
    for name in ("NVCC", "C_ABI", "HOST_NATIVE", "KERNEL_FLASH_SHORT_FWD"):
        assert name in feats
    assert [f.name for f in runtime.feature_list()] == list(feats)


def test_check_consistency_over_two_contexts():
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                name="fc")
    results = test_utils.check_consistency(
        sym, [{"ctx": mx.cpu(), "data": (3, 5)},
              {"ctx": mx.cpu(), "data": (3, 5),
               "type_dict": {"data": np.float32}}])
    assert len(results) == 2
    one = np.ones(3, np.float32)
    test_utils.assert_almost_equal(one, one + np.float32(1e-6))
    with pytest.raises(AssertionError):
        test_utils.assert_almost_equal(one, one * 2)
    assert test_utils.almost_equal(np.zeros(2), np.zeros(2))


# -- the tools ----------------------------------------------------------

LOG = """\
INFO:root:Epoch[0] Batch [50]\tSpeed: 1000.00 samples/sec\taccuracy=0.2
INFO:root:Epoch[0] Batch [100]\tSpeed: 2000.00 samples/sec\taccuracy=0.25
INFO:root:Epoch[0] Train-accuracy=0.250000
INFO:root:Epoch[0] Time cost=12.500
INFO:root:Epoch[0] Validation-accuracy=0.300000
INFO:root:Epoch[1] Batch [50]\tSpeed: 1800.00 samples/sec\taccuracy=0.5
INFO:root:Epoch[1] Train-accuracy=0.500000
INFO:root:Epoch[1] Validation-accuracy=0.550000
"""


def _jsonl(n=8):
    out = []
    for i in range(n):
        for rank in (0, 1, 2):
            out.append(json.dumps({
                "epoch": i // 4, "batch": i, "rank": rank,
                "samples_per_sec": 100.0 if rank or i != 5 else 10.0,
                "metrics": {"accuracy": 0.1 * i},
                "trace_id": f"{i:016x}", "goodput": 0.6, "mfu": 0.3,
                "hbm_peak_bytes": 1234, "grad_norm": 1.5,
                "nonfinite": 0, "audit_ok": rank != 2,
                "loss_bucket": "input_stall" if rank == 1
                else "wire_exposed"}))
    return out


@pytest.mark.parametrize("fmt", ["markdown", "csv", "table"])
def test_parse_log_matches_jax(fmt):
    jpl = _jax_tool("parse_log")
    for lines in (LOG.splitlines(), _jsonl()):
        got, ref = parse_log.parse_log(lines), jpl.parse_log(lines)
        assert got == ref
        assert parse_log.format_rows(*got, fmt) == \
            jpl.format_rows(*ref, fmt)
    recs = [json.loads(line) for line in _jsonl()]
    assert parse_log.rank_report(iter(recs)) == \
        jpl.rank_report(iter(recs))


def test_parse_log_cli(tmp_path):
    p = tmp_path / "train.log"
    p.write_text(LOG)
    out = subprocess.run(
        [sys.executable, "-m", "incubator_mxnet_torch.tools.parse_log",
         str(p), "--format", "csv"], capture_output=True, text=True,
        check=True, cwd=REPO, timeout=300)
    assert "0.55" in out.stdout


def _snap(rank, compute, stall, role="worker"):
    return {
        "endpoint": f"e{rank}",
        "statusz": {"role": role, "rank": rank, "host": "h",
                    "pid": 100 + rank,
                    "trainer": {"membership": {"epoch": 0}}},
        "metricz": {"metrics": {}},
        "flightz": {"events": [
            {"kind": "step", "step": i, "seconds": 0.1 + 0.05 * rank,
             "compute_seconds": 0.08 + 0.04 * rank} for i in range(8)]},
        "tracez": {},
        "goodputz": {"trainers": [
            {"label": "trainer0", "steps": 8,
             "window": {"wall_seconds": 4.0, "traced_wall_seconds": 4.0,
                        "buckets": {"compute": compute,
                                    "input_stall": stall}}}]},
        "numericz": {"trainers": [
            {"label": "trainer0", "rank": rank, "anomalies": rank,
             "last": {"nonfinite": rank}, "last_audit": None}]},
    }


@pytest.mark.parametrize("snaps", [
    [_snap(0, 3.5, 0.5), _snap(1, 2.0, 2.0)],
    [_snap(0, 3.5, 0.5), _snap(1, 3.4, 0.6), _snap(2, 1.0, 3.0)],
    [{"endpoint": "dead:1", "error": "ConnectionRefusedError"},
     _snap(0, 3.0, 1.0)]])
def test_fleetz_report_matches_jax(snaps):
    """The JAX report less what the distributed parameter server
    feeds (membership and ownership epochs, wire counters,
    checkpointz), which the port leaves out until it has that
    server."""
    jfz = _jax_tool("fleetz")
    got = fleetz.derive_health(json.loads(json.dumps(snaps)))
    ref = jfz.derive_health(json.loads(json.dumps(snaps)))
    got["generated_unix_time"] = ref["generated_unix_time"]   # a clock
    dist = ("membership", "ownership", "wire_anomalies", "checkpoints")
    assert ref["membership"]["consistent"] and not ref["wire_anomalies"] \
        and not ref["checkpoints"] and not ref["ownership"]["epochs"]
    want = {k: v for k, v in ref.items() if k not in dist}
    want["processes"] = [{k: v for k, v in p.items() if k != "epoch"}
                         for p in ref["processes"]]
    assert got == want
    text = [re.sub(r" epoch=\S+", "", line)
            for line in jfz.render_text(ref).splitlines()
            if not line.startswith("  membership: ")]
    assert fleetz.render_text(got).splitlines() == text
    assert not set(dist) & set(got)


def test_fleetz_scrapes_the_ports_pages():
    from incubator_mxnet_torch import introspect
    srv = introspect.start_debugz(0)
    try:
        snap = fleetz.scrape(f"127.0.0.1:{int(srv)}")
    finally:
        srv.close()
    assert "error" not in snap
    for page in ("statusz", "metricz", "flightz", "tracez", "goodputz",
                 "numericz", "tunerz"):
        assert "error" not in snap[page], page


def test_diagnose_runs():
    out = subprocess.run(
        [sys.executable, "-m", "incubator_mxnet_torch.tools.diagnose"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    for section in ("Platform Info", "Device Info", "Profiling",
                    "Training health", "Compile cache / Tuner"):
        assert section in out.stdout
    assert "cpu  : 512x512 matmul OK" in out.stdout
