"""The port's telemetry against the JAX package's.

One scripted sequence of calls (labelled counters, a gauge and a gauge
function, histograms with default and custom buckets, label values that
need escaping, non-finite samples, a reset) goes into a fresh `Registry`
of each package: the Prometheus exposition text must be equal character
for character and the snapshots equal as objects.  No tolerance: the
two modules do the same float arithmetic on the same values.  The rest
mirror `tests/test_telemetry.py` on the port's module.
"""
import json
import os
import threading
import urllib.request

import pytest

from incubator_mxnet_tpu import telemetry as jtm
from incubator_mxnet_torch import telemetry
from incubator_mxnet_torch.base import MXNetError


def _script(tm):
    reg = tm.Registry()
    c = reg.counter("req", "requests \"by\" path\nand code",
                    ("path", "code"))
    c.labels(path="/a", code=200).inc()
    c.labels("/a", "200").inc(2.5)
    c.labels(path='/q"u\\o\nte', code=500).inc(7)
    g = reg.gauge("depth", "queue depth")
    g.set(3)
    g.inc(2)
    g.dec(0.5)
    fg = reg.gauge("fn_gauge", "from a function", ("who",))
    fg.labels(who="x").set_function(lambda: 41.25)
    nan = reg.gauge("odd", "non-finite", ("k",))
    nan.labels(k="nan").set(float("nan"))
    nan.labels(k="inf").set(float("inf"))
    nan.labels(k="-inf").set(float("-inf"))
    h = reg.histogram("lat_seconds", "latency", ("route",))
    for v in (0.0004, 0.003, 0.003, 0.2, 1.5, 42.0):
        h.labels(route="r").observe(v)
    hb = reg.histogram("rows", "rows per call",
                       buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
    for v in (1, 3, 8, 100, 300):
        hb.observe(v)
    big = reg.counter("big", "large values")
    big.inc(1e16)
    big.inc(0.125)
    gone = reg.counter("gone", "reset below")
    gone.inc(5)
    texts = [reg.prometheus_text()]
    reg.reset()
    c.labels(path="/b", code=404).inc()
    texts.append(reg.prometheus_text())
    return texts, reg.snapshot()


def test_exposition_text_equals_the_jax_packages():
    got_text, got_snap = _script(telemetry)
    want_text, want_snap = _script(jtm)
    assert got_text == want_text
    assert json.dumps(got_snap, sort_keys=True) == \
        json.dumps(want_snap, sort_keys=True)


def test_default_buckets_and_names_equal_the_jax_packages():
    assert telemetry.DEFAULT_BUCKETS == jtm.DEFAULT_BUCKETS
    assert sorted(telemetry.__all__) == sorted(jtm.__all__)


def test_counter_labels_and_values():
    c = telemetry.counter("tt_requests", "reqs", ("path", "code"))
    c.labels(path="/a", code=200).inc()
    c.labels("/a", "200").inc(2)
    c.labels(path="/b", code=500).inc(5)
    assert telemetry.REGISTRY.value("tt_requests", path="/a", code=200) == 3
    assert telemetry.REGISTRY.value("tt_requests", path="/b", code=500) == 5
    assert telemetry.REGISTRY.value("tt_requests", path="/c", code=0) is None
    with pytest.raises(MXNetError):
        c.labels(path="/a").inc()
    with pytest.raises(MXNetError):
        c.labels(path="/a", code=1, extra=2).inc()
    with pytest.raises(MXNetError):
        c.labels(path="/a", code=1).inc(-1)


def test_registry_idempotent_and_type_checked():
    a = telemetry.counter("tt_idem", "x", ("l",))
    assert telemetry.counter("tt_idem", "x", ("l",)) is a
    with pytest.raises(MXNetError):
        telemetry.gauge("tt_idem", "x", ("l",))
    with pytest.raises(MXNetError):
        telemetry.counter("tt_idem", "x", ("other",))
    with pytest.raises(MXNetError):
        telemetry.counter("bad name!")


def test_gauge_set_function_caches_last_value():
    g = telemetry.gauge("tt_cb_gauge", "cb")
    state = {"v": 7.0, "alive": True}

    def read():
        if not state["alive"]:
            raise RuntimeError("gone")
        return state["v"]

    g.set_function(read)
    assert g.value == 7.0
    state["v"] = 9.0
    assert g.value == 9.0
    state["alive"] = False
    assert g.value == 9.0


def test_histogram_buckets_cumulative():
    h = telemetry.histogram("tt_lat_seconds", "lat",
                            buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 2.0):
        h.observe(v)
    snap = telemetry.snapshot()["tt_lat_seconds"]["values"][0]
    assert snap["count"] == 5
    assert abs(snap["sum"] - 2.605) < 1e-9
    assert snap["buckets"] == {"0.01": 1, "0.1": 3, "1": 4, "+Inf": 5}


def test_counter_thread_safety():
    child = telemetry.counter("tt_concurrent", "n", ("who",)).labels(
        who="w")

    def work():
        for _ in range(2000):
            child.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert child.value == 16000


def test_timed_helper_and_disabled_switch():
    h = telemetry.histogram("tt_timed_seconds", "t")
    with telemetry.timed(h) as t:
        pass
    assert h.count == 1 and t.elapsed >= 0.0
    c = telemetry.counter("tt_timed_total_seconds", "t")
    with telemetry.timed(c):
        pass
    assert c.value > 0.0
    with telemetry.timed(None):
        pass
    off = telemetry.counter("tt_switch", "s")
    telemetry.set_enabled(False)
    try:
        off.inc(3)
        with pytest.raises(MXNetError):
            off.inc(-1)             # validated before the switch
    finally:
        telemetry.set_enabled(True)
    assert off.value == 0 and telemetry.enabled()


def test_http_server_handle_closes_and_frees_port():
    telemetry.counter("tt_http_served", "n").inc(3)
    srv = telemetry.start_http_server(0)
    assert int(srv) == srv.port > 0
    assert f"{srv}" == str(srv) == str(srv.port)
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read()
    assert b"tt_http_served_total 3" in body
    srv.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=2)
    srv2 = telemetry.start_http_server(srv.port)
    assert srv2.port == srv.port
    srv2.close()


def test_dump_writes_identity_stamped_snapshot(tmp_path, monkeypatch):
    telemetry.counter("tt_dumped", "d").inc(4)
    path = str(tmp_path / "snap.json")
    assert telemetry.dump(path) == path
    payload = json.load(open(path))
    assert payload["metrics"]["tt_dumped"]["values"][0]["value"] == 4
    assert payload["pid"] == os.getpid()
    assert {"role", "rank", "host", "unix_time"} <= set(payload)
    monkeypatch.setenv("MXNET_TELEMETRY_DUMP", str(tmp_path / "env.json"))
    assert telemetry.dump() == str(tmp_path / "env.json")
