"""The port's span recorder (incubator_mxnet_torch/tracing.py) against
the JAX package's: the same ids from the same strings, and the same
`recent_traces` payload from the same explicitly timed spans (exact:
both modules round the same floats); then `tests/test_tracing.py`'s
cases on the port's module (ring buffers, context propagation,
sampling, the step-trace rotation, the telemetry bridge, Chrome-trace
export, and overlap arithmetic)."""
import json
import os
import threading
import time

import pytest

from incubator_mxnet_tpu import tracing as jtracing
from incubator_mxnet_torch import telemetry, tracing


@pytest.fixture
def traced():
    """Tracing on with a clean slate; always restored off+empty so no
    other test inherits spans or a half-open context."""
    tracing.reset()
    tracing.set_enabled(True)
    tracing.set_sample(1.0)
    yield
    tracing.set_enabled(False)
    tracing.reset()


@pytest.mark.parametrize("text", [
    "0", "1", "00000000deadbeef", "DEADBEEF", "  feedface  ", "f" * 16,
    "f" * 17, "", "zz-not-hex", "12ab-", "0x1f", "-1", "+5", None, 17])
def test_parse_id_equals_the_jax_packages(text):
    assert tracing.parse_id(text) == jtracing.parse_id(text)


@pytest.mark.parametrize("value", [0, 1, 0xdeadbeef, 2 ** 64 - 1, 2 ** 64,
                                   2 ** 70 + 3, -1])
def test_format_id_equals_the_jax_packages(value):
    assert tracing.format_id(value) == jtracing.format_id(value)


def _timed_spans(tr):
    """Three traces of explicitly timed and identified spans."""
    tr.reset()
    tr.set_enabled(True)
    try:
        base = 1000.0
        for k, tid in enumerate((0x11, 0xabc, 0xfeed0001)):
            root = 0x500 + k
            t = base + k
            tr.record_span("serve.queue_wait", t, t + 0.0125, tid, root,
                           span_id=root + 0x10)
            tr.record_span("serve.batch_coalesce", t + 0.0125, t + 0.02,
                           tid, root, span_id=root + 0x20)
            tr.record_span("serve.model_call", t + 0.02, t + 0.05, tid,
                           root, {"batch_rows": 3 + k},
                           span_id=root + 0x30)
            tr.record_span("serve.request", t, t + 0.0625, tid, 0,
                           {"status": 200, "path": "/predict"},
                           span_id=root)
        return tr.recent_traces(2), tr.recent_traces()
    finally:
        tr.set_enabled(False)
        tr.reset()


def test_recent_traces_equal_the_jax_packages():
    got, want = _timed_spans(tracing), _timed_spans(jtracing)
    assert got == want
    assert [t["trace_id"] for t in got[1]] == \
        ["00000000feed0001", "0000000000000abc", "0000000000000011"]


def _by_name(name):
    return [s for s in tracing.spans() if s.name == name]


def test_disabled_by_default_is_noop_singleton():
    assert not tracing.enabled()        # MXNET_TRACE unset in tests
    a = tracing.span("x")
    b = tracing.span("y", key=1)
    assert a is b                       # shared no-op: zero allocation
    with a:
        pass
    assert tracing.wire_context() == (0, 0)
    assert not tracing.recording()
    tracing.record("x", 0.0)            # no context: silently dropped
    assert tracing.spans() == []


def test_span_nesting_links_parents_and_shares_trace(traced):
    with tracing.span("outer") as o:
        o.set("k", "v")
        with tracing.span("inner"):
            pass
    outer, = _by_name("outer")
    inner, = _by_name("inner")
    assert inner.trace_id == outer.trace_id
    assert inner.parent_id == outer.span_id
    assert outer.attrs == {"k": "v"}
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1


def test_step_span_adopts_forward_and_rotates_trace(traced):
    with tracing.span("forward"):
        pass
    with tracing.step_span():
        with tracing.span("wire.push"):
            pass
    fwd, = _by_name("forward")
    step, = _by_name("step")
    wire, = _by_name("wire.push")
    # pre-step spans are CHILDREN of the step span (pre-allocated root)
    assert fwd.trace_id == step.trace_id
    assert fwd.parent_id == step.span_id
    assert wire.parent_id == step.span_id
    assert tracing.last_trace_id() == step.trace_id
    # rotation: the next forward starts a fresh trace
    with tracing.span("forward"):
        pass
    f2 = _by_name("forward")[-1]
    assert f2.trace_id != step.trace_id


def test_sampling_zero_records_nothing_and_propagates(traced):
    tracing.set_sample(0.0)
    with tracing.step_span():
        assert not tracing.recording()
        assert tracing.wire_context() == (0, 0)
        with tracing.span("child"):
            pass
        tracing.record("explicit", time.monotonic())
    assert tracing.spans() == []
    # an unsampled step must not publish a join key that resolves to
    # nothing in the dump
    assert tracing.last_trace_id() == 0


def test_attach_joins_remote_trace(traced):
    t0 = time.monotonic()
    with tracing.attach(0xabc123, 0xdef456):
        assert tracing.recording()
        tracing.record("server.merge", t0, {"key": "w"})
    sp, = _by_name("server.merge")
    assert sp.trace_id == 0xabc123
    assert sp.parent_id == 0xdef456
    assert sp.attrs["key"] == "w"
    # a zero trace id (untraced sender) attaches as a no-op
    with tracing.attach(0, 7):
        assert not tracing.recording()


def test_record_span_explicit_trace_and_preallocated_id(traced):
    root = tracing.new_id()
    now = time.monotonic()
    tracing.record_span("serve.queue_wait", now - 0.2, now - 0.1,
                        0x77, root)
    tracing.record_span("serve.request", now - 0.2, now, 0x77, 0,
                        span_id=root)
    qw, = _by_name("serve.queue_wait")
    rq, = _by_name("serve.request")
    assert qw.parent_id == rq.span_id == root
    assert qw.trace_id == rq.trace_id == 0x77


def test_telemetry_bridge_span_metric(traced):
    h = telemetry.histogram("tt_tracing_bridge_seconds", "t")
    with tracing.span("timed", metric=h):
        pass
    assert h.count == 1
    assert len(_by_name("timed")) == 1
    # tracing OFF: span(metric=...) degrades to telemetry.timed
    tracing.set_enabled(False)
    with tracing.span("timed", metric=h):
        pass
    assert h.count == 2
    assert len(_by_name("timed")) == 1


def test_timed_span_kwarg_bridge(traced):
    h = telemetry.histogram("tt_tracing_bridge_timed_seconds", "t")
    with telemetry.timed(h, span="prefetch"):
        pass
    assert h.count == 1
    assert len(_by_name("prefetch")) == 1


def test_ring_buffer_wraps_bounded(traced, monkeypatch):
    monkeypatch.setattr(tracing, "_RING_CAP", 8)
    tracing.reset()
    for i in range(25):
        with tracing.span(f"s{i}"):
            pass
    sps = tracing.spans()
    assert len(sps) == 8
    assert sps[-1].name == "s24"        # newest kept, oldest evicted


def test_threads_record_into_separate_rings(traced):
    def work():
        with tracing.span("worker-side"):
            pass

    t = threading.Thread(target=work)
    t.start()
    t.join()
    with tracing.span("main-side"):
        pass
    names = {s.name for s in tracing.spans()}
    assert {"worker-side", "main-side"} <= names


def test_chrome_export_and_dump(traced, tmp_path):
    with tracing.step_span():
        with tracing.span("wire.push", key="w"):
            pass
    doc = tracing.to_chrome()
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(evs) == 2
    for e in evs:
        assert set(("name", "pid", "tid", "ts", "dur", "args")) <= set(e)
        assert e["dur"] > 0
        int(e["args"]["trace_id"], 16)      # hex ids
    wire = next(e for e in evs if e["name"] == "wire.push")
    step = next(e for e in evs if e["name"] == "step")
    assert wire["args"]["parent_id"] == step["args"]["span_id"]
    assert wire["args"]["key"] == "w"
    path = tracing.dump(str(tmp_path / "t.json"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def test_dump_into_trace_dir(traced, tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_DIR", str(tmp_path))
    with tracing.span("x"):
        pass
    path = tracing.dump()
    assert path and os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith("trace-")
    with open(path) as f:
        json.load(f)


def test_recent_traces_groups_and_orders(traced):
    for _ in range(3):
        with tracing.step_span():
            with tracing.span("wire.push"):
                pass
    out = tracing.recent_traces(2)
    assert len(out) == 2
    assert out[0]["span_count"] == 2
    names = [s["name"] for s in out[0]["spans"]]
    assert names == ["step", "wire.push"]


def test_id_roundtrip_and_garbage():
    i = tracing.new_id()
    assert tracing.parse_id(tracing.format_id(i)) == i
    assert tracing.parse_id("zz-not-hex") == 0
    assert tracing.parse_id("a" * 40) == 0
    assert tracing.parse_id(None) == 0
    assert tracing.new_id() != i


def test_coverage_and_overlap_fraction():
    wire = [(1.0, 3.0), (4.0, 6.0)]
    bwd = [(0.0, 2.0), (4.5, 5.0)]
    total, covered = tracing.coverage(wire, bwd)
    assert total == pytest.approx(4.0)
    assert covered == pytest.approx(1.5)
    assert tracing.overlap_fraction(wire, bwd) == pytest.approx(1.5 / 4)
    assert tracing.overlap_fraction([], bwd) == 0.0
    # overlapping input intervals merge before measuring
    assert tracing.coverage([(0, 2), (1, 3)], [(0, 3)]) == (3.0, 3.0)


def test_overlap_merges_nested_same_thread_intervals():
    """A span list with overlapping
    same-thread intervals — nested wire.frame under wire.push_multi —
    must NOT double-count on either side of the fraction.  Raw
    duration summation would report |wire| = 4 + 1 + 1 = 6 here and a
    fraction of 3/6; the merged measurement is 4 and 3/4."""
    wire = [(1.0, 5.0),            # wire.push_multi
            (1.5, 2.5), (3.0, 4.0)]    # nested wire.frame spans
    bwd = [(0.0, 4.0)]
    total, covered = tracing.coverage(wire, bwd)
    assert total == pytest.approx(4.0)          # merged, not 6.0
    assert covered == pytest.approx(3.0)
    assert tracing.overlap_fraction(wire, bwd) == pytest.approx(0.75)
    # duplicated identical intervals likewise merge
    assert tracing.coverage([(0, 2), (0, 2), (0, 2)], [(0, 1)]) \
        == (2.0, 1.0)
    # the covering side merges too: duplicated compute spans must not
    # inflate coverage past the wire interval itself
    total, covered = tracing.coverage([(0, 4)],
                                      [(0, 3), (1, 3), (2, 3)])
    assert covered == pytest.approx(3.0)


def test_merge_intervals_public():
    assert tracing.merge_intervals([(3, 4), (0, 2), (1, 2.5)]) \
        == [(0, 2.5), (3, 4)]
    assert tracing.merge_intervals([]) == []


def test_spans_between_windows(traced):
    t_before = time.monotonic()
    with tracing.step_span():
        with tracing.span("early"):
            time.sleep(0.005)
        time.sleep(0.02)
        mid = time.monotonic()
        with tracing.span("late"):
            time.sleep(0.005)
    t_after = time.monotonic()
    names = {s.name for s in tracing.spans_between(t_before, t_after)}
    assert {"early", "late", "step"} <= names
    # a window opening after `early` closed excludes it
    names = {s.name for s in tracing.spans_between(mid, t_after)}
    assert "late" in names and "early" not in names
    # an empty future window sees nothing
    assert tracing.spans_between(t_after + 60.0, t_after + 61.0) == []


def test_disabled_span_overhead_is_flag_check():
    t0 = time.perf_counter()
    n = 20000
    for _ in range(n):
        with tracing.span("hot"):
            pass
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 50e-6, f"disabled span cost {per_call * 1e6:.1f}us"
