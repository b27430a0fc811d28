"""The profiling plane of the port (`incubator_mxnet_torch/profiling.py`,
`profiler.py`) against the JAX package's (`incubator_mxnet_tpu/
profiling.py`).

- the pure functions, exactly, on the same inputs: `_parse_steps_spec`,
  `classify`, `is_container`, `aggregate_ops` (the same events of both
  packages' `DeviceEvent`), `measure_bubble`, `cross_checks`;
- `parse_trace` on synthetic torch.profiler chrome traces: kernels as
  device ops, copies as DMA windows, each card's busy intervals as its
  program wall, CPU ops as the device lanes of a trace without CUDA, and
  a trace with kernel launches but no kernel event reported as lost
  (device time None, not 0 ms);
- real captures on the CPU driven by step boundaries: the armed window,
  ``MXNET_PROFILE_STEPS=k:n`` through `ParallelTrainer`, `/-/profilez`
  arming and ``?view=trace``, the merged timeline on the tracing axis;
- `profiler`'s MXNet API: `set_config`/`set_state`/`dump`/`dumps`,
  scopes, counters and markers, ``profile_device=True`` through the
  capture, ``profile_memory=True`` through the storage pool.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj  # noqa: F401 — package init
from incubator_mxnet_tpu import profiling as jprof

import incubator_mxnet_torch as mx
from incubator_mxnet_torch import (gluon, introspect, parallel, profiler,
                                   profiling, tracing)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_PROFILE_STEPS", raising=False)
    for m in (profiling, jprof, introspect):
        m._reset_for_tests()
    yield
    profiling._reset_for_tests()
    introspect._reset_for_tests()
    tracing.set_enabled(False)
    tracing.reset()


# -- the pure functions, exactly ------------------------------------------

@pytest.mark.parametrize("spec", ["3:4", "5", "", None, "x:y", "3:0",
                                  "-1:2", "0:1", "7:"])
def test_parse_steps_spec_matches_jax(spec):
    assert profiling._parse_steps_spec(spec) == jprof._parse_steps_spec(spec)


NAMES = ["all-reduce.1", "reduce-scatter.2", "copy-start.3", "dot.4",
         "fusion.5", "custom-call.9", "%while.3", "jit_step", "42",
         "aten::convolution", "transpose.1", "loop_fusion", "pallas_call",
         "einsum", "psum"]

# CUDA kernel names as the card's traces give them (and top-level ATen
# ops, a capture without a card), each with its class; the JAX package
# classes every one of them "other"
CUDA_NAMES = {
    "aten::mm": "matmul", "aten::addmm": "matmul",
    "aten::copy_": "aten", "ampere_bf16_gemm": "matmul",
    "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN": "matmul",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_"
    "256x128>": "matmul",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8": "matmul",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float>": "matmul",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc": "conv",
    "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16>":
        "conv",
    "void fft2d_r2c_32x32<float, false, 1u, false>(float2*)": "conv",
    "void short_fwd_tma<true>(Params)": "custom-call",
    "fwd_tma(FwdMaps, int const*, float*, int, int, FaGeo)": "custom-call",
    "bnb_apply_tma(ApplyMaps, float const*)": "custom-call",
    "(anonymous namespace)::igemm_wgmma((anonymous namespace)::"
    "DenseMaps)": "custom-call",
    "Memcpy HtoD (Pageable)": "copy/offload",
    "Memset (Device)": "copy/offload",
    "ncclAllReduce": "collective",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "BinaryFunctor>": "aten",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
    "at::native::TensorListMetadata<4>>": "aten",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>":
        "aten",
    "Activity Buffer Request": "other",
}


@pytest.mark.parametrize("name", NAMES)
def test_classify_and_containers_match_jax(name):
    assert profiling.classify(name) == jprof.classify(name)
    assert profiling.is_container(name) == jprof.is_container(name)


@pytest.mark.parametrize("name", sorted(CUDA_NAMES))
def test_classify_cuda_kernel_names(name):
    assert profiling.classify(name) == CUDA_NAMES[name]
    assert jprof.classify(name) == "other"
    assert profiling.is_container(name) == jprof.is_container(name)


def _events(mod):
    E = mod.DeviceEvent
    return [E("fusion.1", 0, 100_000, "/device:CUDA:0", "s7", "op"),
            E("fusion.1", 200_000, 100_000, "/device:CUDA:0", "s7", "op"),
            E("%while.3", 0, 400_000, "/device:CUDA:0", "s7", "op"),
            E("all-reduce.7", 100_000, 50_000, "/device:CUDA:0", "s7",
              "op"),
            E("dot.2", 300_000, 70_000, "/device:CUDA:0", "s7", "op"),
            E("whole", 0, 400_000, "/device:CUDA:0", "Busy", "module"),
            E("Memcpy HtoD", 0, 30_000, "/device:CUDA:0", "copies",
              "async")]


@pytest.mark.parametrize("steps", [None, 1, 2, 3])
@pytest.mark.parametrize("top", [1, 40])
def test_aggregate_ops_matches_jax(steps, top):
    assert profiling.aggregate_ops(_events(profiling), steps=steps,
                                   top=top) == \
        jprof.aggregate_ops(_events(jprof), steps=steps, top=top)


def _gpipe(pp, n_micro):
    return {i: [(float(i), float(i + n_micro))] for i in range(pp)}, \
        (0.0, float(n_micro + pp - 1))


BUBBLES = [_gpipe(2, 4), _gpipe(4, 4), _gpipe(4, 8),
           ({0: [(0.0, 2.0), (1.0, 3.0)], 1: [(1.0, 4.0)]}, (0.0, 4.0)),
           ({}, (0.0, 1.0)), ({0: [(0, 1)]}, (1.0, 1.0)),
           ({0: [(-1.0, 0.5), (0.7, 9.0)], 2: [(0.2, 0.3)]}, (0.0, 1.0))]


@pytest.mark.parametrize("i", range(len(BUBBLES)))
def test_measure_bubble_matches_jax(i):
    ivs, window = BUBBLES[i]
    assert profiling.measure_bubble(ivs, window) == \
        jprof.measure_bubble(ivs, window)


CHECKS = [({"pp_bubble_fraction": 0.21, "overlap_fraction": 0.80,
            "mfu": 0.33},
           {"pp_bubble_fraction": 0.20, "overlap_fraction": 0.78,
            "mfu": 0.30}),
          ({"pp_bubble_fraction": 0.40, "mfu": 0.2},
           {"pp_bubble_fraction": 0.20, "mfu": 0.5}),
          ({"mfu": 0.3}, {"pp_bubble_fraction": 0.2}),
          ({"overlap_fraction": 0.0}, {"overlap_fraction": 0.5}),
          ({"mfu": 0.0}, {"mfu": 0.0})]


@pytest.mark.parametrize("i", range(len(CHECKS)))
@pytest.mark.parametrize("tol", [0.15, 0.5])
def test_cross_checks_match_jax(i, tol):
    m, a = CHECKS[i]
    assert profiling.cross_checks(m, a, tol=tol) == \
        jprof.cross_checks(m, a, tol=tol)


# -- parse_trace on synthetic chrome traces -------------------------------

def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": args.pop("tid", 7), "args": args}


def _cuda_doc(with_kernels=True):
    evs = [_x(profiling.ANCHOR_START, "user_annotation", 1000.0, 1.0),
           _x("aten::mm", "cpu_op", 1010.0, 20.0),
           _x("cudaLaunchKernel", "cuda_runtime", 1012.0, 3.0),
           _x("cudaLaunchKernel", "cuda_runtime", 1020.0, 3.0),
           _x("cudaMemcpyAsync", "cuda_runtime", 1030.0, 2.0),
           _x(profiling.ANCHOR_STOP, "user_annotation", 1100.0, 1.0)]
    if with_kernels:
        evs += [_x("ampere_bf16_gemm", "kernel", 1015.0, 10.0, device=0,
                   tid=20),
                _x("void short_fwd_tma<true>(P)", "kernel", 1022.0, 20.0,
                   device=0, tid=20),
                _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1032.0,
                   4.0, device=0, tid=21)]
    return {"traceEvents": evs}


def test_parse_trace_reads_kernels_copies_and_busy_windows():
    got = profiling.parse_trace(_cuda_doc())
    assert got["cuda"] and got["kernel_events"] == 2
    assert got["launch_calls"] == 2
    assert got["anchors"] == {profiling.ANCHOR_START: 1000.0,
                              profiling.ANCHOR_STOP: 1100.0}
    by_kind = {}
    for e in got["events"]:
        by_kind.setdefault(e.kind, []).append((e.name, e.start_ns,
                                               e.dur_ns))
    assert by_kind["op"] == [("ampere_bf16_gemm", 15_000, 10_000),
                             ("void short_fwd_tma<true>(P)", 22_000,
                              20_000)]
    assert by_kind["async"] == [("Memcpy HtoD (Pinned -> Device)", 32_000,
                                 4_000)]
    # the card's busy wall: [15, 42] us merged from both kernels
    assert by_kind["module"] == [("device busy", 15_000, 27_000)]
    ops = profiling.aggregate_ops(got["events"], steps=1)
    assert ops["module_wall_ms"] == pytest.approx(0.027)
    assert ops["op_busy_ms"] == pytest.approx(0.030)


def test_parse_trace_takes_top_level_cpu_ops_without_cuda():
    doc = {"traceEvents": [
        _x("aten::linear", "cpu_op", 0.0, 50.0),
        _x("aten::addmm", "cpu_op", 5.0, 40.0),        # nested: dropped
        _x("aten::relu", "cpu_op", 60.0, 5.0),
        _x("aten::add", "cpu_op", 60.0, 5.0, tid=8)]}
    got = profiling.parse_trace(doc)
    assert not got["cuda"] and got["kernel_events"] == 0
    assert [(e.name, e.plane) for e in got["events"]] == [
        ("aten::linear", "/host:CPU"), ("aten::relu", "/host:CPU"),
        ("aten::add", "/host:CPU")]


def test_lost_kernel_events_are_reported_not_zero():
    got = profiling.parse_trace(_cuda_doc(with_kernels=False))
    now = time.monotonic()
    res = profiling.CaptureResult(
        got["events"], [], mono_start=now - 1.0, mono_stop=now,
        mono_origin=now - 1.0, anchor_skew_ms=0.1,
        launch_calls=got["launch_calls"],
        kernel_events=got["kernel_events"], wrapper_launches=0, cuda=True)
    assert res.events_lost
    rep = profiling.build_report(res, steps=2)
    dev = rep["device"]
    assert dev["events_lost"] and dev["launch_calls"] == 2
    assert dev["op_busy_ms"] is None and dev["module_wall_ms"] is None
    assert "op_busy_ms_per_step" not in dev and "note" in dev
    assert rep["mfu"]["measured"] is None
    assert not any(m["metric"].startswith("profile_device_busy")
                   for m in rep["metrics"])
    # a trace that kept its kernels is not lost
    got = profiling.parse_trace(_cuda_doc())
    res.kernel_events = got["kernel_events"]
    assert not res.events_lost


# -- real captures on the CPU ---------------------------------------------

def _step():
    a = torch.randn(64, 64)
    return lambda: (a @ a).sum().item()


def test_armed_window_aligns_to_step_boundaries():
    step = _step()
    st = profiling.arm(steps=2)
    assert st["mode"] == "steps"
    for _ in range(3):
        step()
        profiling.step_boundary(label="t")
    rep = profiling.last_report()
    assert rep is not None and rep["window"]["steps"] == 2
    assert rep["device"]["event_count"] >= 2
    assert not rep["device"]["events_lost"]
    assert rep["window"]["anchor_skew_ms"] < 50.0
    assert {o["name"] for o in rep["top_ops"]} >= {"aten::matmul"}
    assert profiling.armed() is None
    profiling.step_boundary(label="t")
    assert profiling.profilez("")["capture_seq"] == 1


def test_env_window_through_parallel_trainer(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_PROFILE_STEPS", "2:2")
    monkeypatch.setenv("MXNET_PROFILE_DIR", str(tmp_path))
    profiling._reset_for_tests()
    net = gluon.nn.Dense(8, in_units=16)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    tr = parallel.ParallelTrainer(net, gluon.loss.L2Loss(), "sgd",
                                  mesh=parallel.default_mesh(ctx=mx.cpu()))
    x = np.ones((4, 16), np.float32)
    y = np.zeros((4, 8), np.float32)
    for _ in range(3):
        tr.step(x, y)
    assert profiling.last_report() is None       # window still open
    tr.run_steps(2, x, y)
    rep = profiling.last_report()
    assert rep["window"]["source"] == "env"
    assert rep["window"]["steps"] == 3           # one step + run_steps(2)
    assert rep["label"] == tr._ledger.label
    assert os.path.exists(rep["paths"]["report"])
    assert rep["paths"]["report"].startswith(str(tmp_path))
    assert os.path.exists(rep["paths"]["torch_trace"])
    assert any("addmm" in o["name"] or "mm" in o["name"]
               for o in rep["top_ops"])
    assert profiling.profilez("")["capture_seq"] == 1


def test_profilez_arm_status_and_trace_view(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_PROFILE_DIR", str(tmp_path))
    tracing.set_enabled(True)
    step = _step()
    out = profiling.profilez("steps=1&label=hb")
    assert out["armed"]["steps"] == 1
    assert "error" in profiling.profilez("steps=3")
    for _ in range(2):
        with tracing.step_span():
            step()
        profiling.step_boundary()
    st = profiling.profilez("")
    assert st["capture_seq"] == 1 and st["armed"] is None
    rep = st["last_report"]
    assert rep["label"] == "hb"
    with open(rep["paths"]["trace"]) as f:
        doc = json.load(f)
    dev = [e for e in doc["traceEvents"] if e.get("cat") == "device"]
    assert dev and all(e["tid"] >= 10000 for e in dev)
    assert doc["otherData"]["device_event_count"] == len(dev)
    view = profiling.profilez("view=trace")
    assert view["traceEvents"]
    names = [m["metric"] for m in rep["metrics"]]
    assert "profile_device_busy_ms_per_step" in names
    code, payload = introspect.debugz_payload("/-/profilez?steps=zero")
    assert code == 200 and "error" in payload


def test_duration_window_closes_on_poll():
    step = _step()
    out = profiling.profilez("duration_ms=50")
    assert out["armed"]["mode"] == "duration"
    assert profiling.profilez("")["active"] is True
    step()
    time.sleep(0.08)
    st = profiling.profilez("")
    assert st["capture_seq"] == 1 and st["armed"] is None
    assert st["last_report"]["device"]["event_count"] >= 1


def test_idle_step_boundary_is_a_flag_check():
    assert profiling._watch is False
    profiling.step_boundary(label="idle")
    assert profiling.profilez("")["steps_seen"] == 0


def test_start_capture_refuses_while_window_armed():
    profiling.arm(steps=2)
    with pytest.raises(RuntimeError):
        profiling.start_capture()
    profiling.disarm()


def test_device_events_land_on_the_tracing_axis():
    step = _step()
    t0 = time.monotonic()
    _, res = profiling.capture(step)
    t1 = time.monotonic()
    lo, hi = tracing.export_ts_us(t0), tracing.export_ts_us(t1)
    slack = 1e3 * (res.anchor_skew_ms + 5.0)
    for ev in res.events:
        assert lo - slack <= profiling.event_ts_us(res, ev) <= hi + slack


# -- profiler: MXNet's API -----------------------------------------------

def test_profiler_api_dump_and_dumps(tmp_path):
    fname = str(tmp_path / "profile.json")
    profiler.set_config(filename=fname, profile_device=True,
                        profile_memory=True)
    profiler.set_state("run")
    with profiler.scope("my_scope"):
        (torch.randn(32, 32) @ torch.randn(32, 32)).sum().item()
    task = profiler.Task("my_task")
    task.start()
    task.stop()
    c = profiler.Counter("my_counter", value=1)
    c.increment(2)
    profiler.Marker("my_marker").mark()
    from incubator_mxnet_torch.storage import Storage
    h = Storage.get().alloc(4096)
    h.free()
    profiler.set_state("stop")
    profiler.dump()
    with open(fname) as f:
        doc = json.load(f)
    cats = {e.get("cat") for e in doc["traceEvents"]}
    assert {"custom", "task", "device", "memory"} <= cats
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"my_scope", "my_task", "my_counter", "my_marker",
            "host_pool"} <= names
    assert c.value == 3
    table = profiler.dumps(reset=True)
    assert "my_scope" in table and "Calls" in table
    profiler.set_config(filename=fname)
