"""Profiler: operator/event capture -> chrome://tracing JSON + aggregate
table (counterpart of `incubator_mxnet_tpu/profiler.py`, MXNet's
`profiler` API).

`set_config`, `set_state('run'|'stop')`, `pause`/`resume`, `dump()`,
`dumps()` (the aggregate table), `scope`, `Task`/`Frame`, `Counter`
and `Marker`.  With `profile_device=True` the run goes through the one
capture of `profiling` (a torch.profiler session with the card's CUDA
activity): stopping merges its kernels and copies into `dump()`'s
timeline.  With `profile_memory=True` the host storage pool
(`storage.Storage`, `csrc/storage.cc`) records its allocations and
frees, and `dump()` draws them as a memory timeline.
``MXNET_PROFILER_AUTOSTART=1`` starts the profiler at import.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict

from .base import get_env
from . import telemetry as _telemetry

__all__ = ["set_config", "set_state", "pause", "resume", "dump", "dumps",
           "scope", "Task", "Frame", "Counter", "Marker", "record_event"]

_lock = threading.Lock()
_state = {"running": False, "filename": "profile.json",
          "aggregate": True, "profile_device": False, "device_trace": None}
_events = []
_agg = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])  # count,total,min,max
_t0 = time.perf_counter()
_t0_mono = time.monotonic()     # device-event re-anchor base: maps a
#                                 profiling.CaptureResult's monotonic
#                                 origin onto this module's event clock


def _now_us():
    return (time.perf_counter() - _t0) * 1e6


def set_config(profile_all=False, profile_symbolic=True,
               profile_imperative=True, profile_memory=False,
               profile_api=False, filename="profile.json",
               aggregate_stats=True, profile_device=False, **kwargs):
    _state["filename"] = filename
    _state["aggregate"] = aggregate_stats
    _state["profile_device"] = profile_device or profile_all
    _state["profile_memory"] = profile_memory or profile_all


def _storage_pool():
    """The native host pool, or None where the host library cannot be
    built."""
    try:
        from .storage import Storage
        return Storage.get()
    except Exception:
        return None


def set_state(state="stop"):
    if state == "run":
        _state["running"] = True
        if _state["profile_device"]:
            # the one capture of profiling.py: stop merges its parsed
            # device events into dump()'s timeline
            try:
                from . import profiling as _profiling
                d = os.path.splitext(_state["filename"])[0] + "_torch"
                _profiling.start_capture(trace_dir=d)
                _state["device_trace"] = d
            except Exception:
                _state["device_trace"] = None
        if _state.get("profile_memory"):
            pool = _storage_pool()
            if pool is not None:
                pool.profile(True)
                _state["mem_pool"] = pool
    else:
        if _state.get("profile_memory"):
            _drain_memory_events()
            if _state.get("mem_pool") is not None:
                _state["mem_pool"].profile(False)
                _state["mem_pool"] = None
        _state["running"] = False
        if _state.get("device_trace"):
            try:
                from . import profiling as _profiling
                res = _profiling.stop_capture()
            except Exception:
                res = None
            if res is not None:
                _merge_device_events(res)
            _state["device_trace"] = None


def _merge_device_events(res):
    """Fold a finished device capture into the chrome-trace event
    list: device lanes as pid 1 threads, timestamps mapped from the
    capture's monotonic origin onto this module's event clock, so the
    host events and the card's kernels share `dump()`'s one time
    axis."""
    from . import profiling as _profiling
    base_us = (res.mono_origin - _t0_mono) * 1e6
    lanes = {}
    with _lock:
        for ev in res.events:
            lane = f"{ev.plane.split(' ')[0]}/{ev.line}"
            tid = lanes.get(lane)
            if tid is None:
                tid = lanes[lane] = len(lanes)
            _events.append({"name": ev.name, "cat": "device",
                            "ph": "X",
                            "ts": base_us + ev.start_ns / 1e3,
                            "dur": max(ev.dur_ns / 1e3, 0.001),
                            "pid": 1, "tid": tid,
                            "args": {"kind": ev.kind,
                                     "class":
                                         _profiling.classify(ev.name)}})
        for lane, tid in lanes.items():
            _events.append({"ph": "M", "pid": 1, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": lane}})
        if lanes:
            _events.append({"ph": "M", "pid": 1,
                            "name": "process_name",
                            "args": {"name": "device"}})


_MEM_KIND = {0: "pool_alloc", 1: "os_alloc", 2: "free"}


def _drain_memory_events():
    """Native pool alloc/free events -> chrome-trace memory timeline."""
    pool = _state.get("mem_pool")
    if pool is None:
        return
    try:
        events, native_now, dropped = pool.profile_drain()
    except Exception:
        events, dropped = [], 0
    offset = _now_us() - native_now if events else 0
    with _lock:
        for e in events:
            ts = e.t_us + offset
            _events.append({"name": "host_pool", "cat": "memory",
                            "ph": "C", "ts": ts, "pid": 0, "tid": 0,
                            "args": {"allocated": e.allocated,
                                     "pooled": e.pooled}})
            _events.append({"name":
                            f"mem_{_MEM_KIND.get(e.kind, '?')}",
                            "cat": "memory", "ph": "i", "ts": ts,
                            "pid": 0, "tid": 0, "s": "t",
                            "args": {"bytes": e.size}})
        if dropped:
            _events.append({"name": "mem_events_dropped",
                            "cat": "memory", "ph": "i",
                            "ts": _now_us(), "pid": 0, "tid": 0,
                            "s": "p", "args": {"count": dropped}})


def pause():
    _state["running"] = False


def resume():
    _state["running"] = True


def is_running():
    return _state["running"]


def record_event(name, start_us, dur_us, category="operator", args=None):
    """One complete event (ph='X'): the engine's ops, `scope`s."""
    if not _state["running"]:
        return
    with _lock:
        _events.append({"name": name, "cat": category, "ph": "X",
                        "ts": start_us, "dur": dur_us, "pid": 0,
                        "tid": threading.get_ident() % 1000,
                        "args": args or {}})
        a = _agg[name]
        a[0] += 1
        a[1] += dur_us
        a[2] = min(a[2], dur_us)
        a[3] = max(a[3], dur_us)


class scope:
    """`with profiler.scope('name'):` custom span."""

    def __init__(self, name, category="custom"):
        self.name = name
        self.category = category

    def __enter__(self):
        self._start = _now_us()
        return self

    def __exit__(self, *a):
        record_event(self.name, self._start, _now_us() - self._start,
                     self.category)
        return False


class Task(scope):
    def __init__(self, name, domain=None):
        super().__init__(name, "task")

    def start(self):
        self.__enter__()

    def stop(self):
        self.__exit__()


Frame = Task


_counter_gauge = _telemetry.gauge(
    "profiler_counter", "profiler.Counter current value (bridged so the "
    "chrome-trace and metrics views agree)", ("name",))


class Counter:
    """Custom counter.  Updates are atomic:
    the read-modify-write in increment/decrement holds a PER-COUNTER
    lock for the whole update — engine worker threads increment
    concurrently, and an unlocked `self.value +=` would lose counts;
    a per-instance lock keeps distinct counters from contending with
    each other (and with event recording) on the module lock.  Values
    mirror into the telemetry registry (`profiler_counter{name=...}`)
    in update order."""

    def __init__(self, name, domain=None, value=0):
        self.name = name
        self.value = value
        self._vlock = threading.Lock()
        self._gauge = _counter_gauge.labels(name)
        self._gauge.set(value)   # views agree from construction on

    def _record(self, v):
        """Called under _vlock with the post-update value."""
        if _state["running"]:
            with _lock:
                _events.append({"name": self.name, "ph": "C",
                                "ts": _now_us(), "pid": 0,
                                "args": {"value": v}})

    def set_value(self, v):
        with self._vlock:
            self.value = v
            # mirror under the same lock: two racing updates must not
            # publish their gauge values in the opposite order
            self._gauge.set(v)
            self._record(v)

    def increment(self, delta=1):
        with self._vlock:
            self.value += delta
            self._gauge.set(self.value)
            self._record(self.value)

    def decrement(self, delta=1):
        self.increment(-delta)


def Marker(name, domain=None):
    class _M:
        def mark(self, scope_="process"):
            if _state["running"]:
                with _lock:
                    _events.append({"name": name, "ph": "i",
                                    "ts": _now_us(), "pid": 0, "s": "p"})
    return _M()


def dump(finished=True):
    """Write chrome://tracing JSON (MXNet's MXDumpProfile)."""
    _drain_memory_events()
    with _lock:
        payload = {"traceEvents": list(_events),
                   "displayTimeUnit": "ms"}
        with open(_state["filename"], "w") as f:
            json.dump(payload, f)
        if finished:
            _events.clear()


def dumps(reset=False):
    """Aggregate per-op table (MXNet's MXAggregateProfileStatsPrint)."""
    with _lock:
        lines = [f"{'Name':<40}{'Calls':>8}{'Total(us)':>14}"
                 f"{'Min(us)':>12}{'Max(us)':>12}{'Avg(us)':>12}"]
        for name, (cnt, tot, mn, mx) in sorted(
                _agg.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{name:<40}{cnt:>8}{tot:>14.1f}{mn:>12.1f}"
                         f"{mx:>12.1f}{tot / max(cnt, 1):>12.1f}")
        if reset:
            _agg.clear()
        return "\n".join(lines)


if get_env("MXNET_PROFILER_AUTOSTART", False, bool):
    set_state("run")
