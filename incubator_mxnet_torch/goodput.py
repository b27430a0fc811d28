"""Goodput ledger and device-memory accounting (counterpart of
`incubator_mxnet_tpu/goodput.py`).

When a step is slow, this module says how many of its milliseconds
were compute, input stall, checkpoint, recovery, straggler wait or
exposed wire, and what fraction of the card's peak rate the step ran
at.  Three pieces, one `StepLedger` per trainer:

* **Wall-clock ledger** -- at every step boundary the inter-step
  interval ``[previous step end, this step end]`` is classified into
  disjoint buckets from the spans `tracing` recorded (`classify`: the
  JAX package's rules unchanged).  Each bucket takes only the wall the
  higher-priority buckets left, so the buckets sum to the wall.

  ========== =========================================================
  bucket      source spans (highest attribution priority first)
  ========== =========================================================
  compute     ``forward`` / ``backward`` / ``compute``
  input_stall ``io.*`` (h2d staging) / ``prefetch_stall``
  checkpoint  ``checkpoint.*``
  recovery    ``recovery.*`` / ``reconnect``
  straggler_wait  ``server.round_close`` / ``server.barrier_close``
              closed with ``straggler=True`` (its ``straggler_wait_s``)
  wire_exposed  ``wire.*`` / ``bucket.*`` / ``kv.*`` not covered above
  other       the uncovered remainder
  ========== =========================================================

* **Live MFU** -- a step's FLOPs are counted once per step signature
  (`count_flops`): torch's ``FlopCounterMode`` counts the dispatched
  ops (matmuls, convolutions, attention), a registered formula counts
  the hand kernels that are custom ops (rows 1 and 1b,
  `ops/flash_attention.py`), and the ctypes wrappers of the other
  kernels add their own per-launch counts (`_kernels.add_flops`),
  which the counter cannot see.  MFU is those FLOPs over the step wall
  and the card's peak (``MXNET_PEAK_TFLOPS`` > `set_peak_tflops` > the
  device-name table of NVIDIA's dense bf16 peaks; None on the CPU).

* **Device-memory accounting** -- the card's live bytes and the
  process's allocation peak (`device_memory` reads
  ``torch.cuda.memory_stats`` and ``mem_get_info``; it resets nothing,
  so a caller's own ``max_memory_allocated`` readings keep their
  meaning), and an ``hbm_watermark`` flight event whenever the peak
  jumps more than ``MXNET_HBM_WATERMARK_FRAC`` (default 10%) over the
  previous watermark.

Exports: telemetry (``goodput_fraction``,
``step_breakdown_seconds{bucket=...}``, ``mfu``, ``hbm_bytes_in_use``,
``hbm_peak_bytes``), the ``/-/goodputz`` debugz page, and the ledger
fields folded into the step flight events (`introspect.end_step`).

``MXNET_GOODPUT=0`` reduces every entry point to one flag check.  With
tracing off (``MXNET_TRACE=0``, the default) the ledger keeps the wall,
MFU and memory; the record is marked ``untraced`` and its buckets stay
empty.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref

from .base import get_env
from . import telemetry as _telemetry
from . import tracing as _tracing
from . import introspect as _introspect

__all__ = ["BUCKETS", "enabled", "set_enabled", "classify",
           "StepLedger", "ledgers", "goodputz", "last_record",
           "peak_flops", "peak_tflops_of", "set_peak_tflops",
           "count_flops", "device_memory", "watermark_fraction"]

# presentation order (goodputz, fleetz); attribution priority is
# _PRIORITY below.  `pp_bubble` is carved out of `compute` after
# classification when the owning trainer declares a pipeline
# (:meth:`StepLedger.set_pipeline`; no trainer of the port has one
# until the multi-GPU slice): the fill/drain slots run inside the
# step, so the ledger bills their theoretical share of the compute
# window.
BUCKETS = ("compute", "pp_bubble", "input_stall", "wire_exposed",
           "straggler_wait", "checkpoint", "recovery", "other")

_enabled = get_env("MXNET_GOODPUT", True, bool)
_WINDOW = max(8, get_env("MXNET_GOODPUT_WINDOW", 64, int))


def enabled():
    return _enabled


def set_enabled(on):
    """Flip the ledger globally (tests / embedders)."""
    global _enabled
    _enabled = bool(on)


def watermark_fraction():
    """Relative peak-HBM jump that fires an ``hbm_watermark`` flight
    event (``MXNET_HBM_WATERMARK_FRAC``, default 0.10).  Read per
    event so tests can flip the env between steps."""
    try:
        return max(0.0, float(get_env("MXNET_HBM_WATERMARK_FRAC",
                                      0.10, float)))
    except (TypeError, ValueError):
        return 0.10


# -- telemetry instruments ---------------------------------------------

_tm_goodput = _telemetry.gauge(
    "goodput_fraction",
    "Compute share of the step wall (rolling per-trainer window)",
    ("trainer",))
_tm_breakdown = _telemetry.histogram(
    "step_breakdown_seconds",
    "Per-step wall-clock seconds attributed to each ledger bucket",
    ("trainer", "bucket"))
_tm_mfu = _telemetry.gauge(
    "mfu", "Model-FLOPs utilization of the peak chip rate, live",
    ("trainer",))
_tm_hbm_live = _telemetry.gauge(
    "hbm_bytes_in_use", "Device memory live bytes at the last step "
    "boundary", ("device",))
_tm_hbm_peak = _telemetry.gauge(
    "hbm_peak_bytes", "Device memory peak-allocation watermark",
    ("device",))


# -- span classification -----------------------------------------------

_COMPUTE = {"forward", "backward", "compute"}
_INPUT = {"prefetch_stall"}
_INPUT_PREFIX = ("io.",)
_WIRE_PREFIX = ("wire.", "bucket.", "kv.")
_CHECKPOINT_PREFIX = ("checkpoint.",)
_RECOVERY = {"reconnect"}
_RECOVERY_PREFIX = ("recovery.",)
_STRAGGLER = {"server.round_close", "server.barrier_close"}

# attribution priority: each class takes only the wall the classes
# before it left uncovered.  compute first (goodput is its share);
# input before wire so a staging h2d that also rode a socket is an
# input problem; checkpoint/recovery before wire so a recovery
# re-pull's wire.pull spans bill as recovery; straggler before wire so
# the tail of a straggler-closed round comes out of the exposed-wire
# share it physically overlaps.
_PRIORITY = ("compute", "input_stall", "checkpoint", "recovery",
             "straggler_wait", "wire_exposed")


def _span_fields(sp):
    """(name, t0, t1, attrs) from a tracing.Span or a (name, t0, t1[,
    attrs]) tuple — tests feed synthetic tuples."""
    if isinstance(sp, (tuple, list)):
        name, s0, s1 = sp[0], float(sp[1]), float(sp[2])
        attrs = sp[3] if len(sp) > 3 and isinstance(sp[3], dict) else {}
        return name, s0, s1, attrs
    return sp.name, sp.t0, sp.t1, (sp.attrs or {})


def _class_of(name):
    if name in _COMPUTE:
        return "compute"
    if name in _INPUT or name.startswith(_INPUT_PREFIX):
        return "input_stall"
    if name.startswith(_CHECKPOINT_PREFIX):
        return "checkpoint"
    if name in _RECOVERY or name.startswith(_RECOVERY_PREFIX):
        return "recovery"
    if name in _STRAGGLER:
        return "straggler_wait"
    if name.startswith(_WIRE_PREFIX):
        return "wire_exposed"
    return None


def _subtract(ivs, covers):
    """`ivs` minus `covers` (both merged, sorted interval lists)."""
    out = []
    j = 0
    for lo, hi in ivs:
        cur = lo
        while j < len(covers) and covers[j][1] <= cur:
            j += 1
        k = j
        while k < len(covers) and covers[k][0] < hi:
            c0, c1 = covers[k]
            if c0 > cur:
                out.append((cur, c0))
            cur = max(cur, c1)
            if c1 >= hi:
                break
            k += 1
        if cur < hi:
            out.append((cur, hi))
    return out


def classify(spans, t0, t1):
    """Classify the wall-clock window ``[t0, t1]`` into the ledger
    BUCKETS from an iterable of spans (tracing.Span objects or
    ``(name, t0, t1[, attrs])`` tuples).  Pure — tests feed synthetic
    span sets.  Guarantees: every span interval is clipped to the
    window and MERGED with its class (overlapping same-thread
    intervals — nested ``wire.frame`` under ``wire.push_multi`` —
    never double-bill); each class takes only the wall not already
    attributed to a higher-priority class (_PRIORITY); the buckets
    plus ``other`` sum to exactly ``t1 - t0``.

    A straggler-closed ``server.round_close`` span bills only its tail
    past the last contribution (its ``straggler_wait_s`` attr) — the
    round's earlier life is ordinary merge wait; a close without the
    attr (or closed full) contributes nothing to ``straggler_wait``.
    """
    wall = max(0.0, float(t1) - float(t0))
    out = {b: 0.0 for b in BUCKETS}
    if wall <= 0.0:
        return out
    by_class = {}
    for sp in spans:
        name, s0, s1, attrs = _span_fields(sp)
        cls = _class_of(name)
        if cls is None:
            continue
        if cls == "straggler_wait":
            # ONLY the tail past the last contribution is straggler
            # cost; a close without the attr (e.g. the first round
            # after a server snapshot-restore, whose last-contribution
            # anchor did not survive) must contribute nothing rather
            # than billing the whole round's open-to-close interval
            wait = attrs.get("straggler_wait_s")
            if not attrs.get("straggler") or wait is None:
                continue
            s0 = max(s0, s1 - float(wait))
        lo, hi = max(s0, t0), min(s1, t1)
        if hi > lo:
            by_class.setdefault(cls, []).append((lo, hi))
    covered = []
    for cls in _PRIORITY:
        ivs = _tracing.merge_intervals(by_class.get(cls, ()))
        if not ivs:
            continue
        fresh = _subtract(ivs, covered)
        out[cls] = sum(hi - lo for lo, hi in fresh)
        covered = _tracing.merge_intervals(covered + ivs)
    out["other"] = max(0.0, wall - sum(hi - lo for lo, hi in covered))
    return out


# -- MFU: peak rate + per-signature FLOPs --------------------------------

# NVIDIA's dense (no sparsity) bf16 tensor-core peak, TFLOP/s, by a
# substring of `torch.cuda.get_device_name()`, most specific first
# (the data sheets of each product).
_PEAK_BF16_TFLOPS = (
    ("h100 pcie", 756.0),
    ("h100 nvl", 835.0),
    ("h100", 989.0),        # SXM, "NVIDIA H100 80GB HBM3"
    ("h200", 989.0),
    ("h800", 989.0),
    ("a100", 312.0),
    ("l40s", 362.0),
)

_peak_override = None       # set_peak_tflops


def set_peak_tflops(tflops):
    """Pin the per-card peak (TFLOP/s) the MFU denominator uses; None
    restores the device-name table."""
    global _peak_override
    _peak_override = float(tflops) if tflops else None


def peak_tflops_of(name):
    """The table's dense bf16 peak for a device name, or None."""
    name = str(name).lower()
    for sub, tf in _PEAK_BF16_TFLOPS:
        if sub in name:
            return tf
    return None


def peak_flops(device_count=1):
    """Peak FLOP/s across `device_count` cards, or None when unknown
    (the CPU, an unlisted card).  Order: ``MXNET_PEAK_TFLOPS``,
    :func:`set_peak_tflops`, the device-name table."""
    env = get_env("MXNET_PEAK_TFLOPS", None)
    if env:
        try:
            return float(env) * 1e12 * max(1, device_count)
        except (TypeError, ValueError):
            pass
    if _peak_override is not None:
        return _peak_override * 1e12 * max(1, device_count)
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        tf = peak_tflops_of(torch.cuda.get_device_name(0))
    except Exception:       # noqa: BLE001 — accounting must not raise
        return None
    return tf * 1e12 * max(1, device_count) if tf else None


def count_flops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counting its FLOPs: torch's
    ``FlopCounterMode`` over the dispatched ops (the registered formula
    of rows 1 and 1b among them) plus the per-launch counts the ctypes
    kernels add (`_kernels.add_flops`).  Returns ``(result, flops)``.
    The counter costs a Python call per op, so a trainer counts the
    first step of each signature only."""
    from torch.utils.flop_counter import FlopCounterMode
    from . import _kernels
    with _kernels.counting_flops() as acc, \
            FlopCounterMode(display=False) as fc:
        out = fn(*args, **kwargs)
    return out, float(fc.get_total_flops() + acc[0])


# -- device memory ------------------------------------------------------

_total_bytes = {}


def _card_bytes(d):
    """A card's memory size (``mem_get_info``, asked once a card)."""
    if d not in _total_bytes:
        import torch
        _total_bytes[d] = int(torch.cuda.mem_get_info(d)[1])
    return _total_bytes[d]


def device_memory(devices=None):
    """Per-card memory rows ``{"device", "bytes_in_use",
    "peak_bytes_in_use", "bytes_limit"}`` from the caching allocator
    (``torch.cuda.memory_stats``, host-side counters; the limit is the
    card's total from ``mem_get_info``, read once).  The peak is the
    process's allocation peak, as the JAX package's
    ``peak_bytes_in_use``: nothing is reset here.  Empty without CUDA,
    or for `devices` that are not CUDA devices."""
    try:
        import torch
        if not torch.cuda.is_available():
            return []
        if devices is None:
            devices = [torch.device("cuda", 0)]
        out = []
        for d in devices:
            d = torch.device(d)
            if d.type != "cuda":
                continue
            ms = torch.cuda.memory_stats(d)
            out.append({"device": f"cuda:{d.index or 0}",
                        "bytes_in_use": ms.get("allocated_bytes.all.current",
                                               0),
                        "peak_bytes_in_use": ms.get(
                            "allocated_bytes.all.peak", 0),
                        "bytes_limit": _card_bytes(d)})
        return out
    except Exception:   # noqa: BLE001 — accounting must not raise
        return []


# -- the ledger ---------------------------------------------------------

_reg_lock = threading.Lock()
_ledgers = weakref.WeakValueDictionary()    # label -> StepLedger
_last = None                                # newest on_step record


class StepLedger:
    """Per-trainer goodput ledger.  The owning trainer calls
    :meth:`on_step` with the monotonic window of each completed step;
    everything else (classification, MFU, HBM sampling, telemetry,
    the goodputz registry) happens here.  With ``MXNET_GOODPUT=0``
    every call is one flag check."""

    def __init__(self, label, devices=None, memory_fn=None):
        self.label = str(label)
        self.steps = 0
        self.untraced_steps = 0
        self._records = collections.deque(maxlen=_WINDOW)
        self._execs = {}            # signature -> stats dict
        self._cur_sig = None
        self._flops_per_step = None
        self._last_peak = {}        # device -> peak watermark bytes
        self._devices = devices
        self._memory_fn = memory_fn or device_memory
        self._mem_dead = False      # backend has no memory stats
        self._pp_bubble_frac = 0.0  # set_pipeline (GPipe trainers)
        self.device_count = 1
        if devices is not None:
            try:
                self.device_count = max(1, len(devices))
            except TypeError:
                pass
        with _reg_lock:
            _ledgers[self.label] = self

    # -- compiled-signature bookkeeping (MFU) --------------------------
    def has_signature(self, signature):
        return signature in self._execs

    def set_executable(self, signature, stats, steps_per_call=1):
        """Record one step signature's counted FLOPs (``stats``:
        ``{"flops": ...}`` from :func:`count_flops`; may be empty).
        `steps_per_call` spreads a multi-step executable's FLOPs over
        the steps one dispatch runs (`run_steps`)."""
        stats = dict(stats or {})
        stats["steps_per_call"] = max(1, int(steps_per_call))
        if "flops" in stats:
            stats["flops_per_step"] = stats["flops"] / \
                stats["steps_per_call"]
        self._execs[signature] = stats
        self.use_signature(signature)

    def use_signature(self, signature):
        """Select the signature the next steps run under (a signature
        already counted)."""
        self._cur_sig = signature
        self._flops_per_step = (self._execs.get(signature) or {}).get(
            "flops_per_step")

    def flops_per_step(self):
        """FLOPs the current signature attributes to one step, or None
        — the MFU numerator, public for the profiling plane's
        measured-vs-analytic cross-check."""
        return self._flops_per_step

    def note_flops(self, flops_per_step):
        """Direct FLOPs hint for step paths the ledger's owner does not
        run itself (the imperative gluon Trainer, whose forward and
        backward run in the caller's code)."""
        self._flops_per_step = float(flops_per_step) \
            if flops_per_step else None

    # -- pipeline bubble -----------------------------------------------
    def set_pipeline(self, pp, n_micro):
        """Declare the owning trainer's GPipe schedule: subsequent
        traced steps carve the theoretical fill/drain bubble —
        ``(pp−1)/(n_micro+pp−1)`` of the compute bucket — into
        ``pp_bubble``.  Pass pp<=1 (or call with changed values) to
        clear/update."""
        pp = max(1, int(pp))
        n_micro = max(1, int(n_micro))
        self._pp_bubble_frac = (pp - 1) / float(n_micro + pp - 1) \
            if pp > 1 else 0.0

    def pp_bubble_fraction(self):
        """The analytic fill/drain share this ledger carves
        (``(pp−1)/(n_micro+pp−1)``, 0.0 without a pipeline) — what the
        profiling plane's measured device-gap bubble is checked
        against."""
        return self._pp_bubble_frac

    # -- memory --------------------------------------------------------
    def _sample_memory(self):
        """Sample device memory, update gauges/watermarks, fire the
        ``hbm_watermark`` flight event on a configured jump.  Returns
        (live_bytes_max, peak_bytes_max) or (None, None)."""
        if self._mem_dead:
            return None, None
        rows = self._memory_fn(self._devices) or []
        if not rows:
            self._mem_dead = self._memory_fn is device_memory
            return None, None
        live_max = peak_max = None
        frac = watermark_fraction()
        for row in rows:
            dev = row.get("device", "?")
            live = row.get("bytes_in_use")
            peak = row.get("peak_bytes_in_use")
            if _telemetry.enabled():
                if live is not None:
                    _tm_hbm_live.labels(dev).set(live)
                if peak is not None:
                    _tm_hbm_peak.labels(dev).set(peak)
            if live is not None:
                live_max = max(live_max or 0, live)
            if peak is None:
                continue
            peak_max = max(peak_max or 0, peak)
            prev = self._last_peak.get(dev)
            if prev is not None and prev > 0 and \
                    peak > prev * (1.0 + frac):
                _introspect.flight(
                    "hbm_watermark", trainer=self.label, device=dev,
                    peak_bytes=int(peak), prev_peak_bytes=int(prev),
                    step=self.steps,
                    limit_bytes=row.get("bytes_limit"))
            if prev is None or peak > prev:
                self._last_peak[dev] = peak
        return live_max, peak_max

    # -- the step boundary ---------------------------------------------
    def on_step(self, t0, t1, steps=1, trace_id=None):
        """Account one completed step whose inter-step window is
        ``[t0, t1]`` (monotonic seconds; `steps` > 1 for a multi-step
        dispatch).  Returns the ledger record, or None when disabled.
        """
        if not _enabled:
            return None
        global _last
        wall = max(0.0, float(t1) - float(t0))
        self.steps += int(steps)
        buckets = None
        if _tracing.enabled() and trace_id and wall > 0.0:
            spans = [sp for sp in _tracing.spans_between(t0, t1)
                     if sp.trace_id == trace_id]
            if spans:
                buckets = classify(spans, t0, t1)
                if buckets["compute"] > 0.0 and self._pp_bubble_frac:
                    # the GPipe fill/drain slots live INSIDE the
                    # step; attribute their theoretical share
                    # rather than booking the bubble as useful compute
                    bubble = buckets["compute"] * self._pp_bubble_frac
                    buckets["pp_bubble"] += bubble
                    buckets["compute"] -= bubble
        untraced = buckets is None
        if untraced:
            self.untraced_steps += int(steps)
        goodput = None if untraced or wall <= 0.0 \
            else buckets["compute"] / wall
        mfu = None
        flops = self._flops_per_step
        if flops and wall > 0.0:
            peak = peak_flops(self.device_count)
            if peak:
                mfu = flops * steps / wall / peak
        live_bytes, peak_bytes = self._sample_memory()
        rec = {"step": self.steps - 1, "steps": int(steps),
               "wall_seconds": wall, "untraced": untraced,
               "buckets": buckets, "goodput": goodput, "mfu": mfu,
               "flops": (flops * steps) if flops else None,
               "hbm_bytes_in_use": live_bytes,
               "hbm_peak_bytes": peak_bytes,
               "trainer": self.label}
        self._records.append(rec)
        _last = rec
        if _telemetry.enabled():
            if goodput is not None:
                _tm_goodput.labels(self.label).set(goodput)
            if mfu is not None:
                _tm_mfu.labels(self.label).set(mfu)
            if buckets is not None:
                for b, secs in buckets.items():
                    if secs > 0.0:
                        _tm_breakdown.labels(self.label, b).observe(
                            secs)
        return rec

    def reset_window(self):
        """Drop the rolling window (a warm-up's end)."""
        self._records.clear()

    # -- rolling summary (goodputz / fleetz) ----------------------------
    def summary(self):
        recs = list(self._records)
        wall = sum(r["wall_seconds"] for r in recs)
        traced = [r for r in recs if not r["untraced"]]
        twall = sum(r["wall_seconds"] for r in traced)
        buckets = {b: 0.0 for b in BUCKETS}
        for r in traced:
            for b, secs in r["buckets"].items():
                buckets[b] += secs
        mfus = [r["mfu"] for r in recs if r["mfu"] is not None]
        out = {
            "label": self.label,
            "steps": self.steps,
            "window": {
                "steps": sum(r["steps"] for r in recs),
                "wall_seconds": round(wall, 6),
                "traced_wall_seconds": round(twall, 6),
                "untraced_steps": sum(r["steps"] for r in recs
                                      if r["untraced"]),
                "buckets": {b: round(s, 6)
                            for b, s in buckets.items()},
                "goodput_fraction": (round(buckets["compute"] / twall,
                                           6) if twall > 0 else None),
                "mfu": (round(sum(mfus) / len(mfus), 6)
                        if mfus else None),
            },
            "hbm": {dev: int(peak)
                    for dev, peak in sorted(self._last_peak.items())},
            "executables": [
                {"signature": repr(sig),
                 **{k: v for k, v in st.items()}}
                for sig, st in list(self._execs.items())],
        }
        if recs:
            last = dict(recs[-1])
            if last["buckets"] is not None:
                last["buckets"] = {b: round(s, 6) for b, s in
                                   last["buckets"].items()}
            for k in ("wall_seconds", "goodput", "mfu"):
                if last.get(k) is not None:
                    last[k] = round(last[k], 6)
            out["last_step"] = last
        return out


def ledgers():
    """Live ledgers, label-sorted (a GC'd trainer's ledger drops
    out)."""
    with _reg_lock:
        items = sorted(_ledgers.items())
    return [led for _, led in items]


def last_record():
    """The newest :meth:`StepLedger.on_step` record in this process —
    what `Speedometer` stamps into its JSONL lines."""
    return _last


def goodputz():
    """The ``/-/goodputz`` debugz payload."""
    return {"identity": _introspect.process_identity(),
            "enabled": _enabled,
            "tracing_enabled": _tracing.enabled(),
            "buckets": list(BUCKETS),
            "window_size": _WINDOW,
            "trainers": [led.summary() for led in ledgers()]}


def _reset_for_tests():
    global _last
    _last = None
    with _reg_lock:
        _ledgers.clear()
