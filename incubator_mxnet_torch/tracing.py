"""Distributed step tracing: low-overhead spans with Perfetto export
(counterpart of `incubator_mxnet_tpu/tracing.py`).

`telemetry.py` answers "how long did allreduce take" in
aggregate; this module answers *when* — which bucket's push waited
behind which ack, whether the wire ran during backward or after it,
which hop ate a serving deadline.  Spans are recorded into per-thread
ring buffers (no locks on the hot path, bounded memory) against the
monotonic clock, carry (trace id, span id, parent id) links plus
key/value attributes, and export as Chrome-trace / Perfetto JSON
(`dump()`, or automatically at exit with ``MXNET_TRACE_DIR`` set).

Span model
----------

* A **trace** is one logical unit of work — a training step, a serving
  request — identified by a 64-bit trace id.  Every span carries its
  trace id, so spans from several processes (worker, server) group
  into one timeline.
* A **span** is a named [t0, t1) interval with a parent link.  Spans
  nest lexically through :func:`span` (a context manager keeping a
  per-thread stack) or explicitly through :func:`record` /
  :func:`record_span` (for intervals measured by hand, e.g. a server
  merge that must be recorded only when it was fresh).
* The per-thread **pending step context** ties the pre-step spans
  (forward, backward — opened before ``Trainer.step`` runs) to the
  step span: root spans parent to a pre-allocated step-root id, and
  :func:`step_span` *uses* that id, then rotates the pending context
  so the next forward starts a fresh trace.
* **Remote contexts**: a frame arriving over the kvstore wire carries
  (trace id, parent span id); the server enters them with
  :func:`attach` so its merge/barrier/round-close spans join the
  worker's trace.

Overhead: with ``MXNET_TRACE=0`` (the default) every entry point is
one flag check returning a shared no-op; with tracing on, a span is
two clock reads plus a tuple append into a preallocated ring.
``MXNET_TRACE_SAMPLE`` (0.0–1.0) samples whole traces: an unsampled
trace propagates a non-recording context so its children — local and
remote — skip recording too.

Telemetry bridge: ``span(name, metric=h)`` also observes the elapsed
seconds into the given `telemetry` histogram/counter (and falls back
to plain `telemetry.timed` when tracing is off), so the span timeline
and the aggregate histograms can never disagree about what was
measured.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import random
import threading
import time
import weakref

from .base import get_env
from . import telemetry as _telemetry

__all__ = ["enabled", "set_enabled", "set_sample", "span", "step_span",
           "attach", "record_span", "record", "wire_context", "recording",
           "current", "last_trace_id", "pending_step_context", "new_id",
           "format_id", "parse_id",
           "spans", "spans_between", "reset", "to_chrome", "dump",
           "recent_traces", "export_ts_us",
           "coverage", "overlap_fraction", "merge_intervals", "Span"]

_enabled = get_env("MXNET_TRACE", False, bool)
_sample = min(1.0, max(0.0, get_env("MXNET_TRACE_SAMPLE", 1.0, float)))
_RING_CAP = max(256, get_env("MXNET_TRACE_BUFFER", 65536, int))

# Export-time clock alignment: spans are timed on the monotonic clock
# (immune to NTP steps mid-run), and the (epoch, monotonic) anchor pair
# taken at import maps them onto the wall clock so worker and server
# processes on one host land on a shared Perfetto time axis.
_ANCHOR_EPOCH_US = time.time_ns() / 1000.0
_ANCHOR_MONO = time.monotonic()

# 64-bit ids, unique across processes without coordination: a random
# per-process prefix over a cheap in-process counter (itertools.count
# is atomic under the GIL — no lock on the id hot path).
_ID_BASE = (int.from_bytes(os.urandom(4), "little") or 1) << 32
_id_counter = itertools.count(1)
_sample_rng = random.Random(int.from_bytes(os.urandom(8), "little"))


def new_id():
    """Fresh 64-bit id (always available, even with tracing off — the
    serving front end assigns X-Trace-Id unconditionally)."""
    return _ID_BASE | (next(_id_counter) & 0xFFFFFFFF)


def format_id(i):
    """Canonical wire/header spelling of an id: 16 lowercase hex."""
    return f"{i & 0xFFFFFFFFFFFFFFFF:016x}"


def parse_id(s):
    """Inverse of :func:`format_id`; returns 0 for anything that is not
    1–16 hex chars (callers keep the original string as an attribute)."""
    try:
        s = str(s).strip()
        if not 1 <= len(s) <= 16:
            return 0
        return int(s, 16)
    except (TypeError, ValueError):
        return 0


def enabled():
    return _enabled


def set_enabled(on):
    """Flip recording globally (export always works)."""
    global _enabled
    _enabled = bool(on)


def set_sample(p):
    """Set the per-trace sampling probability (tests / embedders)."""
    global _sample
    _sample = min(1.0, max(0.0, float(p)))


class Span:
    """One completed span (immutable once recorded)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "thread", "attrs")

    def __init__(self, name, trace_id, span_id, parent_id, t0, t1,
                 thread, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = t1
        self.thread = thread
        self.attrs = attrs

    @property
    def duration(self):
        return self.t1 - self.t0

    def __repr__(self):
        return (f"Span({self.name!r}, trace={format_id(self.trace_id)}, "
                f"dur={self.duration * 1e3:.3f}ms)")


class _Ring:
    """Fixed-capacity span ring for ONE thread: only its owner appends
    (no lock on the hot path); collectors snapshot under the registry
    lock, tolerating a concurrent append (worst case: one span is seen
    twice or not yet — both fine for an observability dump)."""

    __slots__ = ("buf", "idx", "total", "thread", "_tref")

    def __init__(self, thread):
        self.buf = []
        self.idx = 0
        self.total = 0
        self.thread = thread.name
        self._tref = weakref.ref(thread)

    def dead(self):
        t = self._tref()
        return t is None or not t.is_alive()

    def append(self, sp):
        self.total += 1
        if len(self.buf) < _RING_CAP:
            self.buf.append(sp)
        else:
            self.buf[self.idx] = sp
            self.idx = (self.idx + 1) % _RING_CAP

    def snapshot(self):
        return self.buf[self.idx:] + self.buf[:self.idx]


class _ThreadState:
    __slots__ = ("ring", "stack", "pending", "last_trace")

    def __init__(self, thread):
        self.ring = _Ring(thread)
        self.stack = []          # [(trace_id, span_id, recording)]
        self.pending = None      # (trace_id, step_root_span_id, recording)
        self.last_trace = 0


_tls = threading.local()
_reg_lock = threading.Lock()
_rings = []                      # every thread's ring (dead ones too —
#                                  their spans still belong in the dump)
_MAX_RINGS = 4096                # connection-churn backstop: a server
#                                  spawns one handler thread per client
#                                  connection, and a long-lived traced
#                                  process must not grow its registry
#                                  forever — dead rings are pruned,
#                                  empty ones first
_last_trace_global = 0           # newest completed step trace, any thread


def _state():
    st = getattr(_tls, "st", None)
    if st is None:
        st = _tls.st = _ThreadState(threading.current_thread())
        with _reg_lock:
            if len(_rings) >= _MAX_RINGS:
                keep = [r for r in _rings if not r.dead() or r.buf]
                while len(keep) >= _MAX_RINGS:
                    # still over: oldest dead-with-spans rings go too
                    # (their spans are lost; memory stays bounded)
                    idx = next((i for i, r in enumerate(keep)
                                if r.dead()), None)
                    if idx is None:
                        break
                    keep.pop(idx)
                _rings[:] = keep
            _rings.append(st.ring)
    return st


def _pending(st):
    """The thread's pending step context, creating it (and drawing the
    sampling decision for the whole trace) on first use."""
    p = st.pending
    if p is None:
        rec = _enabled and (_sample >= 1.0
                            or _sample_rng.random() < _sample)
        p = st.pending = (new_id(), new_id(), rec)
    return p


class _Noop:
    """Shared disabled-path context manager: one allocation ever."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        pass


_NOOP = _Noop()


class _SpanCtx:
    __slots__ = ("name", "metric", "attrs", "_st", "_tid", "_sid",
                 "_rec", "_t0", "_tm0")

    def __init__(self, name, metric, attrs):
        self.name = name
        self.metric = metric
        self.attrs = attrs

    def set(self, key, value):
        self.attrs[key] = value

    def __enter__(self):
        st = self._st = _state()
        if st.stack:
            tid, psid, rec = st.stack[-1]
        else:
            tid, psid, rec = _pending(st)
        self._tid = tid
        self._rec = rec
        self._sid = new_id() if rec else 0
        st.stack.append((tid, self._sid, rec))
        if self.metric is not None:
            self._tm0 = time.perf_counter()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        st = self._st
        st.stack.pop()
        if self._rec:
            # after the pop, the stack top (or the pending step root)
            # is exactly the context this span was pushed under
            parent = st.stack[-1][1] if st.stack else (
                st.pending[1] if st.pending else 0)
            st.ring.append(Span(self.name, self._tid, self._sid, parent,
                                self._t0, t1, st.ring.thread, self.attrs))
        if self.metric is not None:
            m = self.metric
            secs = time.perf_counter() - self._tm0
            if hasattr(m, "observe"):
                m.observe(secs)
            else:
                m.inc(secs)
        return False


class _StepCtx(_SpanCtx):
    """The step span: uses the pending step-root id as its own span id
    (forward/backward spans already parented to it), then rotates the
    pending context so the next forward opens a fresh trace."""

    __slots__ = ()

    def __enter__(self):
        st = self._st = _state()
        tid, sid, rec = _pending(st)
        self._tid, self._sid, self._rec = tid, sid, rec
        st.stack.append((tid, sid, rec))
        if self.metric is not None:
            self._tm0 = time.perf_counter()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        st = self._st
        t1 = time.monotonic()
        st.stack.pop()
        if self._rec:
            st.ring.append(Span(self.name, self._tid, self._sid, 0,
                                self._t0, t1, st.ring.thread, self.attrs))
            # only SAMPLED steps publish their trace id: an unsampled
            # trace exists in no dump, and stamping it into Speedometer
            # JSONL would hand operators a join key that resolves to
            # nothing
            st.last_trace = self._tid
            global _last_trace_global
            _last_trace_global = self._tid
        st.pending = None
        if self.metric is not None:
            m = self.metric
            secs = time.perf_counter() - self._tm0
            if hasattr(m, "observe"):
                m.observe(secs)
            else:
                m.inc(secs)
        return False


class _AttachCtx:
    """Enter a REMOTE (trace id, parent span id) context — the server
    side of wire propagation.  Children record iff tracing is on here
    AND the remote trace id is non-zero (the sender was tracing and
    sampled this trace)."""

    __slots__ = ("_st", "_tid", "_sid")

    def __init__(self, trace_id, parent_span_id):
        self._tid = trace_id
        self._sid = parent_span_id

    def __enter__(self):
        st = self._st = _state()
        st.stack.append((self._tid, self._sid, bool(self._tid)))
        return self

    def __exit__(self, *exc):
        self._st.stack.pop()
        return False


def span(name, metric=None, **attrs):
    """Context manager recording one span under the current context.

    `metric` (optional): a `telemetry` Histogram/Counter (family or
    child) observing the elapsed seconds — the telemetry bridge.  With
    tracing off this degrades to exactly `telemetry.timed(metric)` (or
    a shared no-op when there is no metric either)."""
    if not _enabled:
        return _telemetry.timed(metric) if metric is not None else _NOOP
    return _SpanCtx(name, metric, attrs)


def step_span(metric=None, **attrs):
    """The per-step root span (``gluon.Trainer.step``): adopts the
    pending step context — so this step's earlier forward/backward
    spans are its children — and rotates it on exit."""
    if not _enabled:
        return _telemetry.timed(metric) if metric is not None else _NOOP
    return _StepCtx("step", metric, attrs)


def attach(trace_id, parent_span_id):
    """Adopt a remote wire context (server side).  No-op when tracing
    is off or the frame carried no context."""
    if not _enabled or not trace_id:
        return _NOOP
    return _AttachCtx(trace_id, parent_span_id)


def recording():
    """True when the current thread context would record a span —
    callers use it to skip measurement work (clock reads, attr dicts)
    on the disabled/unsampled path."""
    if not _enabled:
        return False
    st = _state()
    if st.stack:
        return st.stack[-1][2]
    return False


def current():
    """(trace_id, span_id) of the innermost recording context, or
    (0, 0).  Unlike :func:`wire_context` this never consults the
    pending step context — it reflects only explicitly opened spans."""
    if not _enabled:
        return (0, 0)
    st = _state()
    if st.stack and st.stack[-1][2]:
        return st.stack[-1][:2]
    return (0, 0)


# wire_context is the frame-stamping helper: identical to current()
# today, named separately so the transport reads as intent (and so a
# future decision to stamp pending-step context needs one change).
wire_context = current


def pending_step_context():
    """(trace_id, step_root_span_id) of THIS thread's pending step
    context — the ids the next :func:`step_span` will adopt — or
    (0, 0) when tracing is off or the trace is unsampled.  The cross-
    THREAD attribution hook: a helper thread working on a step's
    behalf (e.g. an io staging thread `device_put`-ing the next batch)
    captures this on the consumer thread and records its spans into
    the step trace via :func:`record_span`, so the Perfetto timeline
    shows the helper's work overlapping the step it feeds."""
    if not _enabled:
        return (0, 0)
    st = _state()
    tid, sid, rec = _pending(st)
    return (tid, sid) if rec else (0, 0)


def last_trace_id():
    """Trace id of the newest completed step on this thread (falling
    back to any thread) — what `Speedometer` stamps into its JSONL
    records so logs join the trace timeline."""
    if not _enabled:
        return 0
    st = getattr(_tls, "st", None)
    if st is not None and st.last_trace:
        return st.last_trace
    return _last_trace_global


def record(name, t0, attrs=None, t1=None):
    """Explicitly record a span [t0, t1 or now) under the CURRENT
    context (monotonic-clock seconds).  Used where the record decision
    postdates the interval — e.g. a server merge recorded only when the
    contribution was fresh."""
    if not _enabled:
        return
    st = _state()
    if not st.stack:
        return
    tid, psid, rec = st.stack[-1]
    if not rec:
        return
    st.ring.append(Span(name, tid, new_id(), psid, t0,
                        time.monotonic() if t1 is None else t1,
                        st.ring.thread, attrs or {}))


def record_span(name, t0, t1, trace_id, parent_id=0, attrs=None,
                span_id=None):
    """Explicitly record a span into a GIVEN trace, independent of the
    thread context — the serving pipeline records queue-wait/model-call
    spans for each coalesced request's own trace this way.  `span_id`
    lets the caller pre-allocate the id (children recorded earlier can
    already parent to it)."""
    if not _enabled or not trace_id:
        return
    st = _state()
    st.ring.append(Span(name, trace_id, span_id or new_id(), parent_id,
                        t0, t1, st.ring.thread, attrs or {}))


# -- collection / export ------------------------------------------------

def spans():
    """Snapshot of every recorded span, oldest-first."""
    with _reg_lock:
        rings = list(_rings)
    out = []
    for r in rings:
        out.extend(r.snapshot())
    out.sort(key=lambda s: s.t0)
    return out


def spans_between(t0, t1=None, slack=0.5):
    """Spans overlapping the monotonic window ``[t0, t1]`` (`t1`
    defaults to now), sorted by start.  Unlike :func:`spans` this is
    O(spans in the window), not O(ring): each ring is walked
    newest-first and abandoned once it yields a span that ended more
    than `slack` seconds before `t0` — rings are append-ordered by
    span END time, with `slack` absorbing the bounded reordering of
    :func:`record_span` backfills (a helper thread recording a span
    it finished slightly earlier).  This is what lets a per-step
    reader classify every step without rescanning the whole buffer.
    """
    if t1 is None:
        t1 = time.monotonic()
    cutoff = t0 - slack
    with _reg_lock:
        rings = list(_rings)
    out = []
    for r in rings:
        for sp in reversed(r.snapshot()):
            if sp.t1 < cutoff:
                break
            if sp.t1 >= t0 and sp.t0 <= t1:
                out.append(sp)
    out.sort(key=lambda s: s.t0)
    return out


def reset():
    """Drop all recorded spans and per-thread contexts (tests)."""
    global _last_trace_global
    with _reg_lock:
        for r in _rings:
            r.buf = []
            r.idx = 0
            r.total = 0
    st = getattr(_tls, "st", None)
    if st is not None:
        st.stack = []
        st.pending = None
        st.last_trace = 0
    _last_trace_global = 0


def _label():
    """This process's timeline label: role + pid (DMLC_ROLE for dist
    kvstore processes, overridable via MXNET_TRACE_LABEL)."""
    return get_env(
        "MXNET_TRACE_LABEL",
        get_env("DMLC_ROLE", "process"))


def _ts_us(t_mono):
    return (t_mono - _ANCHOR_MONO) * 1e6 + _ANCHOR_EPOCH_US


def export_ts_us(t_mono):
    """Map a monotonic-clock second onto the wall-clock EXPORT axis
    every Chrome-trace event in this process uses (microseconds).
    The public anchor for other timelines joining the same Perfetto
    axis — a device profile re-anchored through this cannot drift
    apart from the host spans."""
    return _ts_us(t_mono)


def to_chrome(spans_iter=None):
    """Chrome-trace ("Trace Event Format") dict, loadable by Perfetto
    and chrome://tracing.  Spans are complete ("X") events on
    (pid, thread) lanes; ids/links travel in ``args``.  `spans_iter`
    restricts the export to a given span subset (a capture window,
    say); default is every recorded span."""
    pid = os.getpid()
    events = [{"ph": "M", "pid": pid, "name": "process_name",
               "args": {"name": f"{_label()}:{pid}"}}]
    threads = {}
    for sp in (spans() if spans_iter is None else spans_iter):
        tid = threads.setdefault(sp.thread, len(threads) + 1)
        args = {"trace_id": format_id(sp.trace_id),
                "span_id": format_id(sp.span_id)}
        if sp.parent_id:
            args["parent_id"] = format_id(sp.parent_id)
        args.update(sp.attrs)
        events.append({
            "ph": "X", "cat": "mxnet", "name": sp.name, "pid": pid,
            "tid": tid,
            "ts": round(_ts_us(sp.t0), 3),
            "dur": round(max(sp.duration * 1e6, 0.001), 3),
            "args": args})
    for name, tid in threads.items():
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"label": _label(), "pid": pid,
                          "anchor_unix_us": _ANCHOR_EPOCH_US}}


def dump(path=None):
    """Write the Chrome-trace JSON to `path`, or (default) into
    ``MXNET_TRACE_DIR`` as ``trace-<label>-<pid>.json``.  Returns the
    path written, or None when there is nowhere to write."""
    if path is None:
        d = get_env("MXNET_TRACE_DIR")
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace-{_label()}-{os.getpid()}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(to_chrome(), f)
    os.replace(tmp, path)
    return path


def recent_traces(limit=20):
    """Newest `limit` traces as summary dicts (the serving
    ``/-/debug/traces`` payload): trace id, wall span, span count, and
    the spans themselves (name, offsets, duration, attrs)."""
    by_trace = {}
    for sp in spans():
        by_trace.setdefault(sp.trace_id, []).append(sp)
    traces = sorted(by_trace.items(),
                    key=lambda kv: max(s.t1 for s in kv[1]))[-limit:]
    out = []
    for tid, sps in reversed(traces):
        t0 = min(s.t0 for s in sps)
        t1 = max(s.t1 for s in sps)
        out.append({
            "trace_id": format_id(tid),
            "duration_ms": round((t1 - t0) * 1e3, 3),
            "span_count": len(sps),
            "spans": [{"name": s.name,
                       "start_ms": round((s.t0 - t0) * 1e3, 3),
                       "duration_ms": round(s.duration * 1e3, 3),
                       "span_id": format_id(s.span_id),
                       "parent_id": format_id(s.parent_id)
                       if s.parent_id else None,
                       "attrs": s.attrs}
                      for s in sorted(sps, key=lambda s: s.t0)]})
    return out


# -- interval arithmetic (overlap attribution) --------------------------

def merge_intervals(ivs):
    """Sorted, disjoint union of (lo, hi) intervals.  EVERY interval
    measurement in this module goes through this first: a span list
    routinely contains overlapping same-thread intervals — nested
    ``wire.frame`` under ``wire.push_multi``, a retried pull inside its
    parent — and summing raw durations would silently double-count them
    (tests/test_torch_tracing.py pins the nested/duplicated cases)."""
    ivs = sorted(ivs)
    out = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


_merge_intervals = merge_intervals      # pre-PR-12 internal spelling


def coverage(spans_a, spans_b):
    """(total_a, covered): summed length of the merged `spans_a`
    intervals, and how much of it is covered by the merged `spans_b`
    intervals.  Inputs: iterables of Span or (t0, t1) pairs; both
    sides are interval-MERGED before measuring, so overlapping inputs
    (nested ``wire.frame`` under ``wire.push_multi``) never inflate
    either side."""
    def ivs(xs):
        return _merge_intervals(
            [(x.t0, x.t1) if isinstance(x, Span) else (x[0], x[1])
             for x in xs])
    a, b = ivs(spans_a), ivs(spans_b)
    total = sum(hi - lo for lo, hi in a)
    covered = 0.0
    j = 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            covered += min(hi, b[k][1]) - max(lo, b[k][0])
            k += 1
    return total, covered


def overlap_fraction(wire_spans, compute_spans):
    """Fraction of wire time hidden behind compute: |wire ∩ compute| /
    |wire| (0.0 when no wire time).  The `tools/bench_allreduce.py`
    grading metric of a data-parallel step — today's sequential exchange
    scores ~0; a DDP-style streaming bucketer should push it toward 1."""
    total, covered = coverage(wire_spans, compute_spans)
    return covered / total if total > 0 else 0.0


def _atexit_dump():
    # routed through introspect's single-shot guard: the crash hooks
    # (SIGTERM / uncaught exception) dump first when they fire, and a
    # clean exit dumps exactly once
    from . import introspect
    introspect.dump_traces_once()


if get_env("MXNET_TRACE_DIR"):
    atexit.register(_atexit_dump)
