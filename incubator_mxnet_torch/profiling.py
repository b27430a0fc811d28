"""Device-timeline profiling plane (counterpart of
`incubator_mxnet_tpu/profiling.py`): on-demand torch.profiler capture,
merged host+device Perfetto export, measured-vs-analytic cross-checks.

* **Capture** -- `torch.profiler` sessions (CPU and, with a card, CUDA
  activities) armed around exact trainer step boundaries: the
  ``/-/profilez?steps=N`` (or ``?duration_ms=M``) debugz page and the
  ``MXNET_PROFILE_STEPS=k:n`` window (skip k steps, capture n).  Idle
  cost is one module-flag check per step.
* **One parse** -- the session's exported chrome trace is read by
  :func:`parse_trace`: CUDA kernels are the device's "op" lanes, its
  memcpy/memset the "async" (DMA) lanes, and each card's merged busy
  intervals the "module" windows (the device program wall the JAX
  package reads from XLA's module lines).  A capture without a card
  takes the top-level CPU ops as the device lanes, as the JAX package
  does with XLA's CPU thread pools.  ``profiler.set_config(
  profile_device=True)`` routes through the same session.
* **Lost events** -- torch.profiler has been seen to record no kernel
  event of some traced calls on the card.  A capture whose trace holds
  kernel launches (the CUDA runtime's launch calls, or the port's
  wrapper launch counts) but no kernel event says so (``events_lost``)
  in its report and in profilez, and reports its device time as None,
  never as 0 ms.
* **Merged timeline** -- two `record_function` anchors, bracketed by
  monotonic clock reads at the session's start and end, map the
  trace's clock onto `tracing`'s export axis (:func:`event_ts_us`),
  with the worst-case skew measured per capture (``anchor_skew_ms``).
* **Report** -- per-kernel top-k time, class split, measured overlap,
  pipeline bubble and h2d occupancy, measured MFU (the ledger's FLOPs
  over the device busy wall), and the cross-checks against the
  analytic side (:func:`cross_checks`; disagreement past 15% is
  flagged in the report and as a ``profile_disagreement`` flight
  event).
"""
from __future__ import annotations

import glob
import json
import os
import re
import tempfile
import threading
import time
import urllib.parse

from .base import get_env
from . import tracing as _tracing
from . import introspect as _introspect

__all__ = [
    "parse_trace", "device_events", "DeviceEvent", "classify",
    "is_container", "capture_supported",
    "start_capture", "stop_capture", "capture", "CaptureResult",
    "arm", "disarm", "armed", "step_boundary",
    "event_ts_us", "merged_chrome", "aggregate_ops", "build_report",
    "measure_bubble", "cross_checks", "CROSS_CHECK_TOLERANCE",
    "profilez", "last_report", "last_trace",
]

# measured-vs-analytic disagreement past this relative fraction is
# flagged in the report and as a profile_disagreement flight event
CROSS_CHECK_TOLERANCE = 0.15


# ----------------------------------------------------------------------
# torch.profiler chrome-trace parsing
# ----------------------------------------------------------------------

ANCHOR_START = "mxnet::profile_anchor_start"
ANCHOR_STOP = "mxnet::profile_anchor_stop"
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                 "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel")


class DeviceEvent:
    """One device-timeline event: SESSION-relative start, duration,
    and the (plane, line) lane it rendered on."""

    __slots__ = ("name", "start_ns", "dur_ns", "plane", "line", "kind")

    def __init__(self, name, start_ns, dur_ns, plane, line, kind):
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.plane = plane
        self.line = line
        self.kind = kind

    def __repr__(self):
        return (f"DeviceEvent({self.name!r}, kind={self.kind}, "
                f"dur={self.dur_ns / 1e6:.3f}ms)")


def _top_level(events):
    """The events no other event of their (pid, tid) lane contains —
    leaf time without double-booking nested ops."""
    by_lane = {}
    for e in events:
        by_lane.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for lane in by_lane.values():
        lane.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        end = None
        for e in lane:
            t0 = float(e["ts"])
            if end is None or t0 >= end:
                out.append(e)
                end = t0 + float(e["dur"])
    return out


def parse_trace(doc):
    """Read a torch.profiler chrome trace (the dict
    ``export_chrome_trace`` writes) into ``{"events": [DeviceEvent],
    "anchors": {name: ts_us}, "launch_calls": int, "kernel_events":
    int, "cuda": bool}``.  Event times are nanoseconds from the start
    anchor (or the trace's first event without one).  Kernels are "op"
    events on their card's plane, memcpy/memset "async", each card's
    merged kernel-busy intervals "module"; a trace with no CUDA
    activity at all takes its top-level CPU ops as the device's "op"
    events."""
    raw = [e for e in doc.get("traceEvents", ())
           if isinstance(e, dict) and e.get("ph") == "X"
           and "ts" in e and "dur" in e]
    anchors = {}
    for e in raw:
        if e.get("name") in (ANCHOR_START, ANCHOR_STOP):
            anchors.setdefault(e["name"], float(e["ts"]))
    base = anchors.get(ANCHOR_START,
                       min((float(e["ts"]) for e in raw), default=0.0))
    cats = [str(e.get("cat", "")).lower() for e in raw]
    launches = sum(1 for e, c in zip(raw, cats) if c == "cuda_runtime"
                   and str(e.get("name", "")).startswith(_LAUNCH_CALLS))
    cuda = any(c in ("kernel", "gpu_memcpy", "gpu_memset", "cuda_runtime",
                     "cuda_driver") for c in cats)

    def ev(e, plane, line, kind):
        return DeviceEvent(str(e.get("name", "")),
                           int(round((float(e["ts"]) - base) * 1e3)),
                           int(round(float(e["dur"]) * 1e3)), plane, line,
                           kind)
    out, busy = [], {}
    n_kernels = 0
    for e, c in zip(raw, cats):
        if float(e["dur"]) <= 0:
            continue
        dev = (e.get("args") or {}).get("device", 0)
        plane = f"/device:CUDA:{dev}"
        if c == "kernel":
            n_kernels += 1
            out.append(ev(e, plane, f"stream {e.get('tid')}", "op"))
            busy.setdefault(plane, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        elif c in ("gpu_memcpy", "gpu_memset"):
            out.append(ev(e, plane, "Async copies", "async"))
    for plane, ivs in busy.items():
        for lo, hi in _tracing.merge_intervals(ivs):
            out.append(DeviceEvent("device busy",
                                   int(round((lo - base) * 1e3)),
                                   int(round((hi - lo) * 1e3)), plane,
                                   "Busy", "module"))
    if not cuda:
        cpu_ops = [e for e, c in zip(raw, cats)
                   if c == "cpu_op" and float(e["dur"]) > 0]
        out += [ev(e, "/host:CPU", "CPU ops", "op")
                for e in _top_level(cpu_ops)]
    out.sort(key=lambda x: x.start_ns)
    return {"events": out, "anchors": anchors, "launch_calls": launches,
            "kernel_events": n_kernels, "cuda": cuda}


def device_events(parsed):
    """The `DeviceEvent`s of a :func:`parse_trace` result."""
    return list(parsed["events"])


# ----------------------------------------------------------------------
# op classification (shared with tools/profile_step.py)
# ----------------------------------------------------------------------

def is_container(name):
    """True for events that CONTAIN other ops (while-loops, jit_
    wrappers) — counting them double-books their children's time."""
    n = name.lstrip("%")
    return (n.startswith(("while", "jit_", "fori_loop"))
            or n.split(" ")[0].rstrip(".0123456789").rstrip("%") == ""
            or n.isdigit())


# the port's hand-written kernels (csrc/*.cu), by function name
_HAND_KERNELS = frozenset((
    "short_fwd_tma", "short_fwd_fma", "fwd_tma", "fwd_fma", "bwd_dq_tma",
    "bwd_dq_fma", "bwd_dkv_tma", "bwd_dkv_fma", "bthd_bwd_tma",
    "bthd_bwd_dq_fma", "bthd_bwd_dkv_fma", "bnb_reduce", "bnb_apply",
    "bnb_reduce_tma", "bnb_apply_tma", "sum_partials", "igemm_kernel",
    "igemm_wgmma", "amax_kernel", "quantize_kernel",
    "quantize_nhwc_kernel"))


def classify(name):
    """Coarse op class for the report's split: collective / copy /
    conv / matmul / custom-call / fusion / aten / other.  XLA's HLO
    names first, by the JAX package's rules; then the CUDA kernel
    names the card's trace holds (`_classify_cuda`)."""
    cls = _classify_xla(name)
    return _classify_cuda(name) if cls == "other" else cls


def _classify_cuda(name):
    """The class of a CUDA kernel (or, on a capture without a card, a
    top-level ATen op) by its name: NCCL -> collective; memcpy and
    memset -> copy/offload; the port's hand kernels -> custom-call;
    cuDNN and its FFT/implicit-GEMM convolutions -> conv; cuBLAS,
    cuBLASLt's nvjet, CUTLASS and xmma products -> matmul; the rest of
    PyTorch's own kernels (ATen's elementwise, reductions, norms,
    softmax, indexing, the optimizers' multi-tensor updates, CUB's
    sorts) -> aten."""
    n = name.lower()
    if "nccl" in n:
        return "collective"
    if "memcpy" in n or "memset" in n:
        return "copy/offload"
    if not _HAND_KERNELS.isdisjoint(re.findall(r"[a-z_][a-z0-9_]*", n)):
        return "custom-call"
    if "cudnn" in n or "fprop" in n or "dgrad" in n or "wgrad" in n \
            or "implicit_gemm" in n or "implicit_convolve" in n \
            or "fft2d" in n or "winograd" in n:
        return "conv"
    if "gemm" in n or "gemv" in n or "cublas" in n or "cutlass" in n \
            or "xmma" in n or n.startswith("nvjet") \
            or n in ("aten::mm", "aten::addmm", "aten::bmm",
                     "aten::baddbmm", "aten::linear"):
        return "matmul"
    if "at::native::" in n or "cub::" in n or n.startswith("aten::"):
        return "aten"
    return "other"


def _classify_xla(name):
    """The JAX package's rules, for XLA's HLO op names."""
    n = name.lower()
    if "all-reduce" in n or "all-gather" in n or "reduce-scatter" in n \
            or "all-to-all" in n or "collective" in n or "psum" in n:
        return "collective"
    if n.startswith(("copy", "transpose")) or ".copy" in n \
            or "copy-start" in n or "copy-done" in n:
        return "copy/offload"
    if "dynamic-update-slice" in n and "host" in n:
        return "copy/offload"
    if "conv" in n:
        return "conv"
    if "dot" in n or "matmul" in n or "einsum" in n:
        return "matmul"
    if "custom-call" in n or "pallas" in n or "mosaic" in n:
        return "custom-call"
    if n.startswith(("fusion", "loop_", "input_", "output_")) \
            or "fusion" in n:
        return "fusion"
    return "other"


# ----------------------------------------------------------------------
# capture sessions
# ----------------------------------------------------------------------

class CaptureResult:
    """One finished capture: the parsed device events plus the clock
    anchors that map them onto the tracing export axis, and what the
    trace says about lost kernel events."""

    __slots__ = ("events", "trace_paths", "mono_start", "mono_stop",
                 "mono_origin", "anchor_skew_ms", "launch_calls",
                 "kernel_events", "wrapper_launches", "cuda")

    def __init__(self, events, trace_paths, mono_start, mono_stop,
                 mono_origin, anchor_skew_ms, launch_calls=0,
                 kernel_events=0, wrapper_launches=0, cuda=False):
        self.events = events
        self.trace_paths = trace_paths
        self.mono_start = mono_start
        self.mono_stop = mono_stop
        self.mono_origin = mono_origin
        self.anchor_skew_ms = anchor_skew_ms
        self.launch_calls = launch_calls
        self.kernel_events = kernel_events
        self.wrapper_launches = wrapper_launches
        self.cuda = cuda

    @property
    def window_seconds(self):
        return max(0.0, self.mono_stop - self.mono_start)

    @property
    def events_lost(self):
        """True when the card launched kernels in the window (runtime
        launch calls or wrapper launch counts) but the trace holds no
        kernel event."""
        return bool(self.kernel_events == 0
                    and (self.launch_calls or self.wrapper_launches))


def capture_supported():
    """True when torch.profiler can start a session here."""
    try:
        import torch.profiler
        return callable(getattr(torch.profiler, "profile", None))
    except Exception:       # noqa: BLE001 — a probe must not raise
        return False


def _wrapper_launches():
    """Sum of the hand kernels' wrapper launch counts, over the kernel
    modules this process imported."""
    import sys
    total = 0
    for mod in ("incubator_mxnet_torch.ops.flash_attention",
                "incubator_mxnet_torch.ops.quantized",
                "incubator_mxnet_torch.tools.bottleneck_bwd"):
        m = sys.modules.get(mod)
        counts = getattr(m, "launch_counts", None) if m else None
        if counts:
            total += sum(counts.values())
    return total


_state_lock = threading.Lock()
_session = None             # {"dir", "prof", "m_lo", "m_hi", ...}


def _anchor(name):
    """A host annotation bracketed by two monotonic reads: its trace
    time lies between them."""
    import torch.profiler
    lo = time.monotonic()
    with torch.profiler.record_function(name):
        pass
    return lo, time.monotonic()


def _start_session_locked(trace_dir=None):
    """Start a torch.profiler session (CUDA activity when a card is
    present) and record its start anchor.  Caller holds
    ``_state_lock``."""
    global _session
    if _session is not None:
        raise RuntimeError("a profiler capture is already active")
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    d = trace_dir or tempfile.mkdtemp(prefix="mxnet_torch_trace_")
    prof = profile(activities=acts)
    if cuda:
        torch.cuda.synchronize()
    prof.start()
    m_lo, m_hi = _anchor(ANCHOR_START)
    _session = {"dir": d, "prof": prof, "m_lo": m_lo, "m_hi": m_hi,
                "cuda": cuda, "launches0": _wrapper_launches()}
    return _session


def _stop_session_locked():
    """Stop the active session, export and parse its chrome trace into
    a `CaptureResult`.  Caller holds ``_state_lock``."""
    global _session
    s = _session
    _session = None
    if s is None:
        return None
    import torch
    if s["cuda"]:
        torch.cuda.synchronize()
    e_lo, e_hi = _anchor(ANCHOR_STOP)
    s["prof"].stop()
    launches = _wrapper_launches() - s["launches0"]
    os.makedirs(s["dir"], exist_ok=True)
    path = os.path.join(s["dir"], f"trace-{os.getpid()}-"
                                  f"{int(time.time() * 1e3)}.json")
    s["prof"].export_chrome_trace(path)
    with open(path) as f:
        parsed = parse_trace(json.load(f))
    a = parsed["anchors"]
    start_mid = (s["m_lo"] + s["m_hi"]) / 2.0
    if ANCHOR_START in a and ANCHOR_STOP in a:
        # the trace's own length between the anchors against the
        # monotonic one: their difference, plus the brackets' half
        # widths, bounds the mapping's error
        traced = (a[ANCHOR_STOP] - a[ANCHOR_START]) / 1e6
        mono = (e_lo + e_hi) / 2.0 - start_mid
        skew_ms = (abs(mono - traced) + (s["m_hi"] - s["m_lo"]) / 2.0
                   + (e_hi - e_lo) / 2.0) * 1e3
    else:
        skew_ms = (s["m_hi"] - s["m_lo"]) * 1e3
    return CaptureResult(
        parsed["events"], [path], mono_start=s["m_hi"], mono_stop=e_lo,
        mono_origin=start_mid, anchor_skew_ms=skew_ms,
        launch_calls=parsed["launch_calls"],
        kernel_events=parsed["kernel_events"],
        wrapper_launches=launches, cuda=s["cuda"])


def start_capture(trace_dir=None):
    """Begin a capture session (raises if one is active OR a profilez
    window is armed — the armed window owns the next session, and a
    foreign trace started under it would be adopted and terminated by
    the window's step counting).  Returns an opaque token for
    symmetry; end it with :func:`stop_capture`."""
    with _state_lock:
        if _armed is not None:
            raise RuntimeError(
                "a profilez capture window is armed; its session "
                "starts at the next step boundary")
        return _start_session_locked(trace_dir)


def stop_capture():
    """End the active session; returns a `CaptureResult` (or None when
    nothing was active)."""
    with _state_lock:
        return _stop_session_locked()


def capture(fn, trace_dir=None):
    """Trace one call of `fn`: ``(fn_result, CaptureResult)``."""
    start_capture(trace_dir)
    try:
        out = fn()
    finally:
        res = stop_capture()
    return out, res


# ----------------------------------------------------------------------
# armed windows (endpoint + env), driven by trainer step boundaries
# ----------------------------------------------------------------------

def _parse_steps_spec(val):
    """``MXNET_PROFILE_STEPS``: ``k:n`` (skip k steps — warmup /
    compile — then capture n) or bare ``n`` (capture the first n)."""
    if not val:
        return None
    try:
        if ":" in val:
            k, n = val.split(":", 1)
            k, n = int(k), int(n)
        else:
            k, n = 0, int(val)
        if n <= 0 or k < 0:
            return None
        return (k, n)
    except ValueError:
        return None


_env_spec = _parse_steps_spec(get_env("MXNET_PROFILE_STEPS", None))
_env_done = False
_armed = None               # {"mode", "steps"/"duration_s", ...}
_watch = _env_spec is not None   # ONE flag check on the idle step path
_steps_seen = 0
_capture_seq = 0
_last_report = None
_last_trace_doc = None


def arm(steps=None, duration_ms=None, label=None, on_finish=None):
    """Arm a capture window.  ``steps=N`` starts at the next trainer
    step boundary and stops N boundaries later.  ``duration_ms=M``
    starts immediately and stops at the first boundary (or profilez
    poll) past the deadline.  BOTH together start immediately and
    close on whichever comes first — N step boundaries or the
    deadline — which is what a fleet capture over mixed process
    classes needs: workers close after N steps, a stepless kvstore
    server or serving replica still closes (with whatever device work
    its window saw) at the deadline instead of wedging the fleet.
    ``on_finish`` (programmatic callers — the health plane's
    anomaly-armed captures) is invoked once with the finished
    report dict (which carries ``paths.report`` on success or
    ``error``); it never propagates exceptions and never appears in
    the returned/armed state (those dicts get json-dumped).
    Returns the armed-state dict, or an ``{"error": ...}`` dict
    (already armed / capture unsupported) — the HTTP-friendly
    contract."""
    global _armed, _watch
    if not capture_supported():
        return {"error": "torch.profiler capture unavailable on this "
                         "build"}
    with _state_lock:
        if _armed is not None or _session is not None:
            return {"error": "a capture is already armed or active",
                    "armed": dict(_armed) if _armed else None}
        n = None
        if steps is not None:
            n = int(steps)
            if n <= 0:
                return {"error": f"steps must be positive, got {n}"}
        if duration_ms is not None:
            dur = float(duration_ms)
            if dur <= 0:
                return {"error": f"duration_ms must be positive, "
                                 f"got {dur}"}
            _armed = {"mode": "duration", "duration_s": dur / 1e3,
                      "captured_steps": 0, "label": label,
                      "source": label or "endpoint",
                      "requested_unix": time.time()}
            if n is not None:
                _armed["max_steps"] = n
            try:
                _start_session_locked()
            except Exception as e:  # noqa: BLE001 — HTTP-safe error,
                _armed = None       # e.g. a foreign profiler active
                return {"error": f"cannot start capture: "
                                 f"{type(e).__name__}: {e}"}
            _armed["deadline_mono"] = _session["m_hi"] + dur / 1e3
        elif n is not None:
            _armed = {"mode": "steps", "steps": n, "captured_steps": 0,
                      "label": label, "source": label or "endpoint",
                      "requested_unix": time.time()}
        else:
            return {"error": "pass steps or duration_ms"}
        if on_finish is not None:
            _armed["on_finish"] = on_finish
        _watch = True
        return {k: v for k, v in _armed.items() if k != "on_finish"}


def disarm():
    """Cancel an armed-but-not-finished window (an active session is
    stopped and DISCARDED).  Returns True when something was armed."""
    global _armed, _watch
    with _state_lock:
        was = _armed is not None or _session is not None
        _armed = None
        if _session is not None:
            try:
                _stop_session_locked()
            except Exception:   # noqa: BLE001 — cancel must not raise
                pass
        _watch = _env_spec is not None and not _env_done
    return was


def armed():
    """The armed-window dict (or None) — observability for profilez."""
    with _state_lock:
        return {k: v for k, v in _armed.items()
                if k != "on_finish"} if _armed else None


def step_boundary(label=None, steps=1):
    """Trainer hook, called at every step (or multi-step dispatch)
    boundary.  Idle cost is this ONE module-flag check; when a window
    is armed it starts/advances/finishes the capture here, so the
    trace aligns exactly with step boundaries."""
    if not _watch:
        return
    _step_boundary_slow(label, steps)


def _step_boundary_slow(label, steps):
    global _steps_seen, _armed, _env_done, _watch
    finished = None
    res = None
    with _state_lock:
        _steps_seen += max(1, int(steps))
        if _armed is None and _env_spec is not None and not _env_done \
                and _session is None:
            skip, n = _env_spec
            if _steps_seen >= skip:
                _env_done = True
                _armed = {"mode": "steps", "steps": n,
                          "captured_steps": 0, "label": label,
                          "source": "env",
                          "requested_unix": time.time()}
        a = _armed
        if a is None:
            _watch = (_env_spec is not None and not _env_done) \
                or _session is not None
            return
        if _session is None:
            try:
                _start_session_locked()
            except Exception:   # noqa: BLE001 — profiling must never
                _armed = None   # take down the training step
                _watch = _env_spec is not None and not _env_done
                return
            return
        a["captured_steps"] += max(1, int(steps))
        if a["mode"] == "steps":
            done = a["captured_steps"] >= a["steps"]
        else:
            done = time.monotonic() >= a["deadline_mono"] or (
                a.get("max_steps") is not None
                and a["captured_steps"] >= a["max_steps"])
        if done:
            finished = a
            _armed = None
            _watch = _env_spec is not None and not _env_done
            try:
                res = _stop_session_locked()
            except Exception:   # noqa: BLE001
                res = None
    # post-processing runs OUTSIDE the lock: building + writing the
    # merged doc can take seconds on a large capture, and a profilez
    # poll (or a co-resident trainer's boundary) must not block on it
    if finished is not None and res is not None:
        _finish_capture(res, finished)


def _maybe_finish_idle():
    """Close an expired duration-mode window from a profilez poll — a
    serving process with no training steps still finishes its
    capture."""
    global _armed, _watch
    res = None
    a = None
    with _state_lock:
        a = _armed
        if a is None or a["mode"] != "duration" or _session is None:
            return
        if time.monotonic() < a["deadline_mono"]:
            return
        _armed = None
        _watch = _env_spec is not None and not _env_done
        try:
            res = _stop_session_locked()
        except Exception:       # noqa: BLE001
            return
    if res is not None:
        _finish_capture(res, a)


# ----------------------------------------------------------------------
# anchoring + merged Perfetto export
# ----------------------------------------------------------------------

def event_ts_us(res, ev):
    """A device event's timestamp on tracing's wall-clock export axis
    (microseconds) — the SAME axis `tracing.to_chrome` plots host
    spans on, so one Perfetto load shows both."""
    return _tracing.export_ts_us(res.mono_origin + ev.start_ns / 1e9)


def _lane_label(ev):
    plane = ev.plane.split(" ")[0].replace("/device:", "")
    return f"dev:{plane}/{ev.line}"


def merged_chrome(res, margin=0.25):
    """One Chrome-trace dict: the host spans tracing recorded around
    the capture window (± `margin` seconds) plus the device lanes,
    re-anchored onto the shared time axis.  Device lanes render as
    extra threads (tid >= 10000) of this process's pid."""
    spans = _tracing.spans_between(res.mono_start - margin,
                                   res.mono_stop + margin)
    doc = _tracing.to_chrome(spans_iter=spans)
    pid = os.getpid()
    events = doc["traceEvents"]
    lanes = {}
    for ev in res.events:
        lane = _lane_label(ev)
        tid = lanes.get(lane)
        if tid is None:
            tid = lanes[lane] = 10000 + len(lanes)
        events.append({
            "ph": "X", "cat": "device", "name": ev.name, "pid": pid,
            "tid": tid,
            "ts": round(event_ts_us(res, ev), 3),
            "dur": round(max(ev.dur_ns / 1e3, 0.001), 3),
            "args": {"kind": ev.kind, "class": classify(ev.name)}})
    for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": lane}})
    doc["otherData"]["device_event_count"] = len(res.events)
    doc["otherData"]["anchor_skew_ms"] = round(res.anchor_skew_ms, 3)
    return doc


# ----------------------------------------------------------------------
# report: top-k ops, class split, overlap, bubble, h2d occupancy
# ----------------------------------------------------------------------

def aggregate_ops(events, steps=None, top=40):
    """Per-op totals over LEAF device events: ``{"top_ops",
    "class_ms", "op_busy_ms", "module_wall_ms", "async_ms"}`` (each
    also ``*_per_step`` when `steps` is known)."""
    agg = {}
    per_class = {}
    module_ns = async_ns = 0
    module_planes = set()
    for ev in events:
        if ev.kind == "module":
            module_ns += ev.dur_ns
            module_planes.add(ev.plane)
            continue
        if ev.kind == "async":
            async_ns += ev.dur_ns
            continue
        if is_container(ev.name):
            continue
        agg[ev.name] = agg.get(ev.name, 0) + ev.dur_ns
        cls = classify(ev.name)
        per_class[cls] = per_class.get(cls, 0) + ev.dur_ns
    total_ns = sum(agg.values())
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    out = {
        "op_busy_ms": round(total_ns / 1e6, 3),
        "module_wall_ms": round(module_ns / 1e6, 3),
        # devices run the SPMD program CONCURRENTLY: the summed module
        # wall divides by this to recover the per-device program wall
        "module_plane_count": len(module_planes),
        "async_ms": round(async_ns / 1e6, 3),
        "class_ms": {k: round(v / 1e6, 3) for k, v in sorted(
            per_class.items(), key=lambda kv: -kv[1])},
        "top_ops": [
            {"name": n, "total_ms": round(ns / 1e6, 3),
             "pct": round(100.0 * ns / total_ns, 1) if total_ns else 0,
             "class": classify(n)} for n, ns in rows],
    }
    if steps:
        out["op_busy_ms_per_step"] = round(total_ns / 1e6 / steps, 3)
        out["module_wall_ms_per_step"] = round(
            module_ns / 1e6 / steps, 3)
        for r in out["top_ops"]:
            r["ms_per_step"] = round(r["total_ms"] / steps, 3)
    return out


def _leaf_intervals(events, want=None, exclude=()):
    """(start_s, end_s) session-relative intervals of leaf op events,
    optionally filtered to / away from op classes."""
    ivs = []
    for ev in events:
        if ev.kind != "op" or is_container(ev.name):
            continue
        cls = classify(ev.name)
        if want is not None and cls not in want:
            continue
        if cls in exclude:
            continue
        ivs.append((ev.start_ns / 1e9, (ev.start_ns + ev.dur_ns) / 1e9))
    return ivs


def _measured_overlap(events):
    """Fraction of device COLLECTIVE time hidden behind other device
    compute: |collective ∩ non-collective-compute| / |collective| —
    the measured counterpart of `tracing.overlap_fraction`'s host-span
    proxy.  None when the capture saw no collectives."""
    coll = _leaf_intervals(events, want={"collective"})
    if not coll:
        return None
    comp = _leaf_intervals(events,
                           exclude=("collective", "copy/offload"))
    total, covered = _tracing.coverage(coll, comp)
    return covered / total if total > 0 else None


def _h2d_occupancy(events, window_s):
    """Fraction of the capture window the host↔device link was busy:
    merged copy/offload-class + async-DMA-window intervals over the
    window.  The direct evidence for ROADMAP item 3's input-pipeline
    gap — a starved chip shows low compute AND low h2d occupancy; a
    saturated link shows occupancy near 1."""
    ivs = _leaf_intervals(events, want={"copy/offload"})
    for ev in events:
        if ev.kind == "async":
            ivs.append((ev.start_ns / 1e9,
                        (ev.start_ns + ev.dur_ns) / 1e9))
    if not ivs or window_s <= 0:
        return None, 0.0
    merged = _tracing.merge_intervals(ivs)
    busy = sum(hi - lo for lo, hi in merged)
    return min(1.0, busy / window_s), busy


def measure_bubble(stage_intervals, window):
    """Measured pipeline bubble from per-stage busy intervals:
    ``mean over stages of (window − merged busy) / window`` — the
    device-GAP share of the pipelined window.  For a clean GPipe
    schedule (stage i busy slots [i, i+n_micro) of n_micro+pp−1) this
    reproduces the analytic ``(pp−1)/(n_micro+pp−1)`` exactly; real
    timelines measure the TRUE fill/drain + jitter.  `stage_intervals`
    maps stage → [(t0, t1), ...]; `window` is (lo, hi) on the same
    clock.  None when the window is empty."""
    lo, hi = window
    span = hi - lo
    if span <= 0 or not stage_intervals:
        return None
    gaps = []
    for _, ivs in sorted(stage_intervals.items()):
        clipped = [(max(lo, a), min(hi, b)) for a, b in ivs
                   if b > lo and a < hi]
        busy = sum(b - a for a, b in
                   _tracing.merge_intervals(clipped))
        gaps.append(max(0.0, span - busy) / span)
    return sum(gaps) / len(gaps)


# ----------------------------------------------------------------------
# cross-check engine
# ----------------------------------------------------------------------

def cross_checks(measured, analytic, tol=CROSS_CHECK_TOLERANCE):
    """Compare measured vs analytic for every key both sides carry
    (``pp_bubble_fraction``, ``overlap_fraction``, ``mfu``).  Pure —
    tests feed synthetic values.  Relative disagreement is
    ``|m − a| / max(|m|, |a|)`` (symmetric, sane near zero);
    ``ok=False`` past `tol`."""
    out = []
    for check in ("pp_bubble_fraction", "overlap_fraction", "mfu"):
        m = measured.get(check)
        a = analytic.get(check)
        if m is None or a is None:
            continue
        denom = max(abs(m), abs(a), 1e-9)
        rel = abs(m - a) / denom
        out.append({"check": check, "measured": round(float(m), 6),
                    "analytic": round(float(a), 6),
                    "rel_disagreement": round(rel, 4),
                    "ok": rel <= tol})
    return out


def _analytic_view(res, steps):
    """The accounting stack's CLAIMS for the capture window: the
    dominant ledger's pp_bubble carve and MFU, and the span-interval
    overlap fraction — what the cross-checks grade the measurement
    against."""
    out = {}
    led = None
    try:
        from . import goodput as _goodput
        leds = _goodput.ledgers()
        led = max(leds, key=lambda l: l.steps) if leds else None
    except Exception:       # noqa: BLE001 — report must not raise
        pass
    if led is not None:
        frac = led.pp_bubble_fraction()
        if frac:
            out["pp_bubble_fraction"] = frac
        win = led.summary()["window"]
        if win.get("mfu") is not None:
            out["mfu"] = win["mfu"]
    wire, comp = [], []
    for sp in _tracing.spans_between(res.mono_start, res.mono_stop):
        if sp.name.startswith(("wire.", "bucket.", "kv.")):
            wire.append(sp)
        elif sp.name in ("forward", "backward", "compute"):
            comp.append(sp)
    if wire:
        out["overlap_fraction"] = _tracing.overlap_fraction(wire, comp)
    return out, led


def _measured_mfu(led, steps, module_wall_ms, module_planes):
    """Measured MFU: the ledger's counted FLOPs over the DEVICE busy
    wall (each card's merged kernel intervals, the "module" events of
    `parse_trace`) instead of the host wall — None without such
    windows (a CPU capture, lost kernel events) or a known peak.  The
    per-step wall is the summed wall over (planes x steps)."""
    if led is None or not steps or module_wall_ms <= 0:
        return None
    flops = led.flops_per_step()
    if not flops:
        return None
    try:
        from . import goodput as _goodput
        peak = _goodput.peak_flops(led.device_count)
    except Exception:       # noqa: BLE001
        return None
    if not peak:
        return None
    wall_s = module_wall_ms / 1e3 / max(1, module_planes) / steps
    return flops / wall_s / peak


def build_report(res, steps=None, label=None, top=40,
                 tol=CROSS_CHECK_TOLERANCE):
    """The structured attribution report for one capture: top-k ops,
    class split, measured overlap / h2d occupancy, measured MFU, the
    measured-vs-analytic cross-checks, and metric records.
    Disagreements past `tol` land in ``disagreements`` AND fire
    ``profile_disagreement`` flight events."""
    window_s = res.window_seconds
    ops = aggregate_ops(res.events, steps=steps, top=top)
    overlap = _measured_overlap(res.events)
    occupancy, h2d_busy_s = _h2d_occupancy(res.events, window_s)
    # no trainer of the port pipelines (multi-GPU slice): no measured
    # bubble and no analytic carve to hold it against
    bubble = None
    analytic, led = _analytic_view(res, steps)
    measured = {"overlap_fraction": overlap,
                "pp_bubble_fraction": bubble,
                "mfu": None if res.events_lost else _measured_mfu(
                    led, steps, ops["module_wall_ms"],
                    ops["module_plane_count"])}
    checks = cross_checks(measured, analytic, tol=tol)
    disagreements = [c["check"] for c in checks if not c["ok"]]
    for c in checks:
        if not c["ok"]:
            _introspect.flight("profile_disagreement", label=label,
                               **{k: c[k] for k in
                                  ("check", "measured", "analytic",
                                   "rel_disagreement")})
    report = {
        "version": 1,
        "identity": _introspect.process_identity(),
        "unix_time": time.time(),
        "label": label,
        "window": {"steps": steps, "wall_seconds": round(window_s, 6),
                   "anchor_skew_ms": round(res.anchor_skew_ms, 3)},
        "device": {"event_count": len(res.events),
                   "kernel_events": res.kernel_events,
                   "launch_calls": res.launch_calls,
                   "wrapper_launches": res.wrapper_launches,
                   "events_lost": res.events_lost,
                   "op_busy_ms": (None if res.events_lost
                                  else ops["op_busy_ms"]),
                   "module_wall_ms": (None if res.events_lost
                                      else ops["module_wall_ms"]),
                   "async_ms": ops["async_ms"]},
        "class_ms": ops["class_ms"],
        "top_ops": ops["top_ops"],
        "h2d": {"occupancy_fraction": (round(occupancy, 4)
                                       if occupancy is not None
                                       else None),
                "busy_ms": round(h2d_busy_s * 1e3, 3)},
        "overlap": {"measured_fraction": overlap,
                    "analytic_fraction":
                        analytic.get("overlap_fraction")},
        "pp": None,
        "mfu": {"measured": measured["mfu"],
                "analytic": analytic.get("mfu")},
        "cross_checks": checks,
        "disagreements": disagreements,
    }
    if steps and not res.events_lost:
        report["device"]["op_busy_ms_per_step"] = \
            ops["op_busy_ms_per_step"]
        report["device"]["module_wall_ms_per_step"] = \
            ops["module_wall_ms_per_step"]
    if res.events_lost:
        report["device"]["note"] = (
            "the trace holds kernel launches but no kernel event "
            "(torch.profiler lost them): device time not measured")
    report["metrics"] = _metric_records(report)
    return report


def _metric_records(report):
    """``{"metric", "value"}`` records of the report, the JAX package's
    names: per-step device busy (lower is better), measured overlap,
    measured bubble, h2d occupancy (informative only)."""
    out = []
    busy = report["device"].get("op_busy_ms_per_step")
    if busy is not None:
        out.append({"metric": "profile_device_busy_ms_per_step",
                    "value": busy})
    elif report["device"]["op_busy_ms"]:
        # step count unknown (a capture around a whole run): the total
        out.append({"metric": "profile_device_busy_ms",
                    "value": report["device"]["op_busy_ms"]})
    if report["overlap"]["measured_fraction"] is not None:
        out.append({"metric": "profile_collective_overlap_fraction",
                    "value": round(
                        report["overlap"]["measured_fraction"], 4)})
    if report["pp"]:
        out.append({"metric": "profile_pp_bubble_fraction",
                    "value": report["pp"]["measured_bubble_fraction"]})
    if report["h2d"]["occupancy_fraction"] is not None:
        out.append({"metric": "profile_h2d_occupancy",
                    "value": report["h2d"]["occupancy_fraction"]})
    return out


# ----------------------------------------------------------------------
# finished-capture bookkeeping + the profilez endpoint
# ----------------------------------------------------------------------

def _output_dir():
    d = os.environ.get("MXNET_PROFILE_DIR") \
        or os.environ.get("MXNET_TRACE_DIR")
    if not d:
        d = tempfile.mkdtemp(prefix="mxnet_profile_")
    os.makedirs(d, exist_ok=True)
    return d


def _label():
    return os.environ.get(
        "MXNET_TRACE_LABEL",
        os.environ.get("DMLC_ROLE", "process"))


def _write_json(path, doc):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def _finish_capture(res, armed_spec):
    """Post-process one finished window: build the merged timeline +
    report, write both into the profile dir, and publish them for
    profilez / diagnose.  Runs OUTSIDE ``_state_lock`` (the session
    and armed state are already cleared, so at most one finisher
    exists at a time); only the final publication touches the shared
    fields, under a short lock.  Never raises."""
    global _last_report, _last_trace_doc, _capture_seq
    final = None
    try:
        steps = armed_spec.get("captured_steps") or None
        label = armed_spec.get("label")
        trace_doc = merged_chrome(res)
        report = build_report(res, steps=steps, label=label)
        report["window"]["mode"] = armed_spec.get("mode")
        report["window"]["source"] = armed_spec.get("source")
        d = _output_dir()
        base = f"{_label()}-{os.getpid()}"
        report["paths"] = {
            "trace": _write_json(
                os.path.join(d, f"profile-{base}.trace.json"),
                trace_doc),
            "report": None,     # filled below (path self-reference)
            "torch_trace": res.trace_paths[-1] if res.trace_paths
            else None,
        }
        report["paths"]["report"] = os.path.join(
            d, f"profile_report-{base}.json")
        _write_json(report["paths"]["report"], report)
        with _state_lock:
            _last_report = report
            _last_trace_doc = trace_doc
            _capture_seq += 1
        _introspect.flight(
            "profile_capture", steps=steps, label=label,
            device_events=len(res.events),
            disagreements=report["disagreements"],
            report=report["paths"]["report"])
        final = report
    except Exception as e:      # noqa: BLE001 — a capture that cannot
        # post-process must not take down the step that closed it.
        # The stale trace doc is cleared too: a ?view=trace reader
        # must get this capture's error, not the previous capture's
        # timeline masquerading as the new one.
        final = {"error": f"{type(e).__name__}: {e}",
                 "unix_time": time.time()}
        with _state_lock:
            _last_report = final
            _last_trace_doc = None
            _capture_seq += 1
    cb = armed_spec.get("on_finish")
    if cb is not None:
        try:    # the arming caller's hook (anomaly-armed captures
            cb(final)   # attach the report to their flight record)
        except Exception:   # noqa: BLE001 — never fails the step
            pass


def last_report():
    """The newest finished capture's report (or None)."""
    return _last_report


def last_trace():
    """The newest finished capture's merged Chrome-trace dict (or
    None) — what ``/-/profilez?view=trace`` serves and fleetz
    merges."""
    return _last_trace_doc


def profilez(query=""):
    """The ``/-/profilez`` debugz payload.  ``?steps=N`` /
    ``?duration_ms=M`` arm a window (optionally ``&label=...``);
    ``?view=trace`` returns the last merged timeline; no args returns
    status + the last report.  Rides the debugz plane's loopback /
    ``MXNET_DEBUGZ_EXPOSE`` gate like every other endpoint."""
    q = urllib.parse.parse_qs(query or "")

    def _one(key):
        v = q.get(key)
        return v[0] if v else None

    if _one("view") == "trace":
        doc = last_trace()
        return doc if doc is not None \
            else {"error": "no finished capture yet"}
    if _one("steps") is not None or _one("duration_ms") is not None:
        try:
            steps = _one("steps")
            dur = _one("duration_ms")
            out = arm(steps=int(steps) if steps is not None else None,
                      duration_ms=float(dur) if dur is not None
                      else None,
                      label=_one("label"))
        except (TypeError, ValueError) as e:
            out = {"error": f"bad profilez query: {e}"}
        if "error" in out:
            return {"armed": None, "capture_seq": _capture_seq, **out}
        return {"armed": out, "capture_seq": _capture_seq}
    _maybe_finish_idle()
    rep = last_report()
    return {
        "identity": _introspect.process_identity(),
        "supported": capture_supported(),
        "tracing_enabled": _tracing.enabled(),
        "armed": armed(),
        "active": _session is not None,
        "capture_seq": _capture_seq,
        "steps_seen": _steps_seen,
        "env_window": ({"skip": _env_spec[0], "steps": _env_spec[1],
                        "done": _env_done}
                       if _env_spec else None),
        "last_report": rep,
    }


def _reset_for_tests():
    global _armed, _session, _watch, _steps_seen, _capture_seq, \
        _last_report, _last_trace_doc, _env_spec, _env_done
    with _state_lock:
        if _session is not None:
            try:
                _stop_session_locked()
            except Exception:   # noqa: BLE001
                pass
        _armed = None
        _steps_seen = 0
        _capture_seq = 0
        _last_report = None
        _last_trace_doc = None
        _env_spec = _parse_steps_spec(
            get_env("MXNET_PROFILE_STEPS", None))
        _env_done = False
        _watch = _env_spec is not None
