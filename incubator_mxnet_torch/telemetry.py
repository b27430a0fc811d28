"""Runtime telemetry: a process-wide registry of labeled
Counter/Gauge/Histogram instruments with Prometheus text-format and
JSON-snapshot exposition (counterpart of
`incubator_mxnet_tpu/telemetry.py`; the port keeps its own copy, and for
the same sequence of calls its exposition text is the JAX package's,
character for character).

Instruments record under a per-child lock (a dict lookup + float add
when enabled, one flag check when `MXNET_TELEMETRY=0`), and exposition
only pays at collection time.  Wired through serving: `deploy.py`
(request count and latency per artifact), `serving.py` (admission,
breaker, reload, batching) and `router.py` (attempts, ejections,
deploys).

Exposition:

- ``prometheus_text()``: Prometheus text format (``_total`` counter
  naming, label escaping, cumulative histogram buckets).
- ``snapshot()``: plain-dict JSON view; ``dump(path)`` writes it.
  ``MXNET_TELEMETRY_DUMP=path`` dumps automatically at interpreter exit.
- ``start_http_server(port)``: minimal ``/metrics`` endpoint for a
  Prometheus scraper (daemon thread, stdlib only); returns a
  `MetricsServer` handle whose ``.close()`` releases the port.
- ``timed(metric)``: context manager observing elapsed seconds into a
  histogram (or adding them to a counter).
"""
from __future__ import annotations

import atexit
import bisect
import json
import math
import os
import threading
import time

from .base import MXNetError, get_env

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "timed", "snapshot",
           "prometheus_text", "dump", "reset", "enabled", "set_enabled",
           "start_http_server", "MetricsServer", "DEFAULT_BUCKETS"]

# Latency-oriented default buckets (seconds), prometheus-client style.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_enabled = get_env("MXNET_TELEMETRY", True, bool)


def enabled():
    return _enabled


def set_enabled(on):
    """Flip recording globally (exposition always works)."""
    global _enabled
    _enabled = bool(on)


def _escape_label(v):
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(v):
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v):
    """Prometheus float rendering: integers without the trailing .0;
    non-finite values use the format's +Inf/-Inf/NaN spellings (one bad
    sample must not make the whole exposition raise)."""
    f = float(v)
    if not math.isfinite(f):
        return "NaN" if f != f else ("+Inf" if f > 0 else "-Inf")
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# -- instrument children (one per label-value combination) --------------

class _Child:
    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def inc(self, amount=1):
        # validate BEFORE the enabled gate so a bad call site fails the
        # same way whether or not MXNET_TELEMETRY=0
        if amount < 0:
            raise MXNetError("counters can only increase")
        if not _enabled:
            return
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class _GaugeChild(_Child):
    __slots__ = ("_value", "_fn")

    def __init__(self):
        super().__init__()
        self._value = 0.0
        self._fn = None

    def set(self, v):
        if not _enabled:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, amount=1):
        if not _enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    def set_function(self, fn):
        """Callback-backed gauge: `fn()` is called at collection time.
        If it raises, the last successfully collected value is kept —
        so a gauge backed by a since-destroyed native object still
        reports its final reading in an at-exit dump."""
        self._fn = fn

    @property
    def value(self):
        fn = self._fn
        if fn is not None:
            try:
                v = float(fn())
            except Exception:
                with self._lock:
                    return self._value
            with self._lock:
                self._value = v
            return v
        with self._lock:
            return self._value


class _HistogramChild(_Child):
    __slots__ = ("_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets):
        super().__init__()
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)   # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        if not _enabled:
            return
        v = float(v)
        i = bisect.bisect_left(self._buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def time(self):
        return timed(self)

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def _collect(self):
        with self._lock:
            return list(self._counts), self._sum, self._count


# -- metric families ----------------------------------------------------

class _Family:
    """One named metric with a fixed label-name tuple; children are
    created lazily per label-value combination.  A label-less family
    proxies the recording API of its single child."""

    kind = "untyped"

    def __init__(self, name, help, labelnames=()):
        if not name or not all(c.isalnum() or c in "_:" for c in name):
            raise MXNetError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children = {}
        self._lock = threading.Lock()

    def labels(self, *args, **kwargs):
        if args and kwargs:
            raise MXNetError("pass label values positionally OR by name")
        if kwargs:
            try:
                values = tuple(str(kwargs[n]) for n in self.labelnames)
            except KeyError as e:
                raise MXNetError(
                    f"{self.name}: missing label {e.args[0]!r} "
                    f"(labelnames={self.labelnames})") from None
            if len(kwargs) != len(self.labelnames):
                raise MXNetError(
                    f"{self.name}: unexpected labels "
                    f"{sorted(set(kwargs) - set(self.labelnames))}")
        else:
            if len(args) != len(self.labelnames):
                raise MXNetError(
                    f"{self.name}: expected {len(self.labelnames)} label "
                    f"values, got {len(args)}")
            values = tuple(str(a) for a in args)
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._new_child())
        return child

    def _unlabeled(self):
        return self.labels()

    def _new_child(self):
        raise NotImplementedError

    def _collect(self):
        """[(labelvalues, child)] sorted for deterministic exposition."""
        with self._lock:
            items = sorted(self._children.items())
        return items


class Counter(_Family):
    """Monotonic counter; rendered with a ``_total`` suffix."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount=1):
        self._unlabeled().inc(amount)

    @property
    def value(self):
        return self._unlabeled().value


class Gauge(_Family):
    """Point-in-time value; supports callback-backed collection."""

    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v):
        self._unlabeled().set(v)

    def inc(self, amount=1):
        self._unlabeled().inc(amount)

    def dec(self, amount=1):
        self._unlabeled().dec(amount)

    def set_function(self, fn):
        self._unlabeled().set_function(fn)

    @property
    def value(self):
        return self._unlabeled().value


class Histogram(_Family):
    """Cumulative-bucket histogram (prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise MXNetError("histogram needs at least one bucket")
        self.buckets = b

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v):
        self._unlabeled().observe(v)

    def time(self):
        return timed(self._unlabeled())

    @property
    def count(self):
        return self._unlabeled().count

    @property
    def sum(self):
        return self._unlabeled().sum


class timed:
    """``with telemetry.timed(metric):`` — observes elapsed seconds.

    `metric` is a Histogram (family or child) or a Counter (family or
    child, seconds are added); `None` is accepted and makes the block a
    no-op, so call sites can hold optional instruments.

    `span` (optional, str): also record the interval as a tracing span
    of that name when `incubator_mxnet_torch.tracing` is enabled — the
    histogram→timeline half of the telemetry/tracing bridge (the other
    half is ``tracing.span(name, metric=h)``).  Imported lazily so this
    module stays importable first.
    """

    __slots__ = ("_metric", "_t0", "elapsed", "_span")

    def __init__(self, metric, span=None):
        self._metric = metric
        self.elapsed = 0.0
        self._span = None
        if span is not None:
            from . import tracing
            if tracing.enabled():
                self._span = tracing.span(span)

    def __enter__(self):
        if self._span is not None:
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        m = self._metric
        if m is not None:
            if hasattr(m, "observe"):
                m.observe(self.elapsed)
            else:
                m.inc(self.elapsed)
        if self._span is not None:
            self._span.__exit__(*exc)
        return False


# -- registry -----------------------------------------------------------

class Registry:
    """Name → family map.  Re-registering an existing name returns the
    existing family when the declaration matches, so modules can declare
    their instruments idempotently at import."""

    def __init__(self):
        self._families = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or \
                        fam.labelnames != tuple(labelnames):
                    raise MXNetError(
                        f"metric {name!r} already registered as "
                        f"{type(fam).__name__}{fam.labelnames}")
                buckets = kwargs.get("buckets")
                if buckets is not None and fam.buckets != tuple(
                        sorted(float(x) for x in buckets)):
                    raise MXNetError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.buckets}")
                return fam
            fam = cls(name, help, labelnames, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._families.get(name)

    def reset(self):
        """Drop every registered family (tests).  Module-level
        instrument handles created before the reset keep working but no
        longer appear in exposition."""
        with self._lock:
            self._families.clear()

    def _collect(self):
        with self._lock:
            fams = sorted(self._families.items())
        return fams

    # -- exposition ----------------------------------------------------

    def snapshot(self):
        """JSON-ready dict: name → {type, help, values:[...]}.

        Counter/gauge values: {"labels": {..}, "value": v}; histogram
        values: {"labels": {..}, "count": n, "sum": s, "buckets":
        {"0.005": c, ..., "+Inf": n}} with CUMULATIVE bucket counts.
        """
        out = {}
        for name, fam in self._collect():
            values = []
            for labelvalues, child in fam._collect():
                labels = dict(zip(fam.labelnames, labelvalues))
                if fam.kind == "histogram":
                    counts, total, n = child._collect()
                    cum, acc = {}, 0
                    for ub, c in zip(fam.buckets, counts):
                        acc += c
                        cum[_fmt(ub)] = acc
                    cum["+Inf"] = n
                    values.append({"labels": labels, "count": n,
                                   "sum": total, "buckets": cum})
                else:
                    values.append({"labels": labels,
                                   "value": child.value})
            out[name] = {"type": fam.kind, "help": fam.help,
                         "values": values}
        return out

    def prometheus_text(self):
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for name, fam in self._collect():
            suffix = "_total" if fam.kind == "counter" and \
                not name.endswith("_total") else ""
            lines.append(f"# HELP {name}{suffix} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name}{suffix} {fam.kind}")
            for labelvalues, child in fam._collect():
                pairs = [f'{n}="{_escape_label(v)}"' for n, v in
                         zip(fam.labelnames, labelvalues)]
                base = ",".join(pairs)
                if fam.kind == "histogram":
                    counts, total, n = child._collect()
                    acc = 0
                    for ub, c in zip(fam.buckets, counts):
                        acc += c
                        le = ([f'le="{_fmt(ub)}"'] if not pairs else
                              pairs + [f'le="{_fmt(ub)}"'])
                        lines.append(
                            f"{name}_bucket{{{','.join(le)}}} {acc}")
                    inf = pairs + ['le="+Inf"']
                    lines.append(f"{name}_bucket{{{','.join(inf)}}} {n}")
                    lbl = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{lbl} {_fmt(total)}")
                    lines.append(f"{name}_count{lbl} {n}")
                else:
                    lbl = f"{{{base}}}" if base else ""
                    lines.append(
                        f"{name}{suffix}{lbl} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def value(self, metric, /, **labels):
        """Convenience accessor for tests/tools: current value of a
        counter/gauge child — observation count for a histogram child —
        or None when the metric/child is absent.  (`metric` is
        positional-only so a label may itself be called "name".)"""
        fam = self.get(metric)
        if fam is None:
            return None
        try:
            key = tuple(str(labels[n]) for n in fam.labelnames)
        except KeyError:
            return None
        child = fam._children.get(key)
        if child is None:
            return None
        return child.count if fam.kind == "histogram" else child.value


REGISTRY = Registry()


def counter(name, help="", labelnames=()):
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def snapshot():
    return REGISTRY.snapshot()


def prometheus_text():
    return REGISTRY.prometheus_text()


def reset():
    REGISTRY.reset()


def dump(path=None):
    """Write the JSON snapshot to `path` (default:
    ``MXNET_TELEMETRY_DUMP``).  Returns the path written, or None.

    The payload is stamped with the process identity (role/rank/host)
    so multi-process dist runs dump JOINABLE files instead of
    anonymous pid-keyed ones."""
    path = path or get_env("MXNET_TELEMETRY_DUMP")
    if not path:
        return None
    from . import introspect
    ident = introspect.process_identity()
    payload = {"version": 1, "pid": os.getpid(),
               "role": ident["role"], "rank": ident["rank"],
               "host": ident["host"],
               "unix_time": time.time(), "metrics": snapshot()}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


# -- /metrics HTTP endpoint --------------------------------------------

_http_server = None


class MetricsServer:
    """Handle returned by `start_http_server`.

    `.port` is the bound port; `.close()` shuts the listener down and
    joins the serving thread so the port is actually released (the old
    daemon-thread-only server leaked the port across restarts in
    tests).  Usable as a context manager, and coerces to the port via
    ``int()`` for call sites that treated the return value as a number.
    """

    def __init__(self, srv, thread):
        self._srv = srv
        self._thread = thread
        self.port = srv.server_address[1]

    def close(self):
        srv, self._srv = self._srv, None
        if srv is None:
            return
        srv.shutdown()
        srv.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __int__(self):
        return self.port

    __index__ = __int__

    def __str__(self):
        # callers of the old int-returning API interpolated the port
        # into URLs; str()/f-strings must keep yielding the number
        return str(self.port)

    def __format__(self, spec):
        return format(self.port, spec)

    def __repr__(self):
        state = "closed" if self._srv is None else "open"
        return f"<MetricsServer port={self.port} {state}>"


def start_http_server(port, addr="127.0.0.1"):
    """Serve ``prometheus_text()`` at http://addr:port/metrics from a
    daemon thread (stdlib only).  Binds with ``SO_REUSEADDR`` and
    returns a `MetricsServer` handle whose ``.close()`` releases the
    port.  (A serving runtime front end exposes ``/metrics`` on its own
    listener — see `incubator_mxnet_torch.serving` — so one process needs
    at most one of these.)"""
    global _http_server
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # keep the scraper out of stderr
            pass

    class _Server(ThreadingHTTPServer):
        allow_reuse_address = 1     # restart fast over a TIME_WAIT port
        daemon_threads = True

    if _http_server is not None:
        # one scrape endpoint per process: replacing the listener must
        # shut the old one down, not leak its thread + bound socket
        _http_server.close()
        _http_server = None
    srv = _Server((addr, port), _Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True,
                              name="mx-telemetry-http")
    thread.start()
    _http_server = MetricsServer(srv, thread)
    return _http_server


def _atexit_dump():
    # the crash hooks (introspect.install_postmortem: SIGTERM /
    # uncaught exception) dump through the same single-shot guard, so
    # a crash path that already wrote the file makes this a no-op and
    # a clean exit writes it exactly once
    from . import introspect
    introspect.dump_telemetry_once()


if get_env("MXNET_TELEMETRY_DUMP"):
    atexit.register(_atexit_dump)
