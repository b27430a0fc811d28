#!/usr/bin/env python
"""Parse training logs into a per-epoch table (counterpart of the JAX
package's `tools/parse_log.py`, MXNet's `tools/parse_log.py`).

Understands the classic fit-loop/Speedometer line formats this framework
emits (identical to the reference's):

    Epoch[12] Batch [620]  Speed: 1997.40 samples/sec  accuracy=0.615434
    Epoch[12] Train-accuracy=0.615434
    Epoch[12] Time cost=812.091
    Epoch[12] Validation-accuracy=0.650625

and the structured JSONL records `Speedometer(emit_json=True)` emits
(possibly embedded in a logging prefix):

    {"batch": 620, "epoch": 12, "metrics": {"accuracy": 0.615434},
     "samples_per_sec": 1997.4, "time": 1700000000.0, "rank": 0,
     "role": "worker", "host": "h3", "trace_id": "a1b2c3d4e5f60708"}

When records carry a ``trace_id`` (tracing was on — docs/tracing.md),
the per-epoch table gains a ``trace`` column with the epoch's last
step-trace id, joining the log line to the dumped Perfetto timeline.
Records from a goodput-ledger process (docs/observability.md "Goodput
ledger") additionally grow ``goodput`` / ``mfu`` / ``hbm_peak_bytes``
columns, and the rank report compares each rank's dominant loss
bucket against the fleet mode.

When records carry a ``rank`` (a dist run — every process appends to
its own MXNET_TELEMETRY_JSONL, or the streams are concatenated), the
report additionally GROUPS BY RANK: per-rank mean throughput, plus
per-rank step-time outliers beyond an EWMA band (a step whose implied
seconds/sample exceeds the rank's running EWMA by ``--band`` EW
standard deviations — chronic stragglers and stall spikes pop out
without eyeballing interleaved logs; docs/observability.md).

Usage: python -m incubator_mxnet_torch.tools.parse_log LOGFILE [--format markdown|csv|table]
                                         [--band B]
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict

_SPEED = re.compile(
    r"Epoch\[(\d+)\].*Speed:\s*([\d.]+)\s*samples/sec")
_TRAIN = re.compile(r"Epoch\[(\d+)\]\s+Train-([\w-]+)=([\d.eE+-]+)")
_VAL = re.compile(r"Epoch\[(\d+)\]\s+Validation-([\w-]+)=([\d.eE+-]+)")
_TIME = re.compile(r"Epoch\[(\d+)\]\s+Time cost=([\d.]+)")


def _try_jsonl(line):
    """Speedometer emit_json record, or None.  Tolerates logging
    prefixes ('INFO:root:{...}') by parsing from the first brace."""
    i = line.find("{")
    if i < 0:
        return None
    try:
        rec = json.loads(line[i:])
    except ValueError:
        return None
    if isinstance(rec, dict) and "epoch" in rec and "batch" in rec:
        return rec
    return None


def parse_log(lines):
    """Returns (rows, metric_names): rows keyed by epoch with
    train/val metrics, mean speed and time cost."""
    speeds = defaultdict(list)
    rows = defaultdict(dict)
    metrics = []

    def note(name):
        if name not in metrics:
            metrics.append(name)

    for line in lines:
        rec = _try_jsonl(line)
        if rec is not None:
            # tolerate malformed fields the same way the regex path
            # tolerates non-matching lines: skip, don't abort the file
            try:
                ep = int(rec["epoch"])
            except (TypeError, ValueError):
                continue
            try:
                speeds[ep].append(float(rec["samples_per_sec"]))
            except (KeyError, TypeError, ValueError):
                pass
            for name, val in (rec.get("metrics") or {}).items():
                try:
                    rows[ep][f"train-{name}"] = float(val)
                except (TypeError, ValueError):
                    continue
                note(f"train-{name}")
            tid = rec.get("trace_id")
            if isinstance(tid, str) and tid:
                # last step trace of the epoch: the join key into the
                # MXNET_TRACE_DIR timeline dump
                rows[ep]["trace"] = tid
                note("trace")
            # goodput-ledger columns (the per-Trainer ledger rides the
            # Speedometer record — docs/observability.md): the epoch's
            # last reading wins, like the trace id
            for name in ("goodput", "mfu", "hbm_peak_bytes"):
                try:
                    rows[ep][name] = float(rec[name])
                except (KeyError, TypeError, ValueError):
                    continue
                note(name)
            # numerics-health columns (MXNET_HEALTH=1 rides the same
            # record — docs/observability.md "Numerics & model
            # health"); audit_ok floats bools (False -> 0.0) so a
            # diverged epoch reads as audit_ok=0
            for name in ("grad_norm", "nonfinite", "audit_ok"):
                try:
                    rows[ep][name] = float(rec[name])
                except (KeyError, TypeError, ValueError):
                    continue
                note(name)
            continue
        m = _SPEED.search(line)
        if m:
            speeds[int(m.group(1))].append(float(m.group(2)))
        m = _TRAIN.search(line)
        if m:
            rows[int(m.group(1))][f"train-{m.group(2)}"] = float(m.group(3))
            note(f"train-{m.group(2)}")
        m = _VAL.search(line)
        if m:
            rows[int(m.group(1))][f"val-{m.group(2)}"] = float(m.group(3))
            note(f"val-{m.group(2)}")
        m = _TIME.search(line)
        if m:
            rows[int(m.group(1))]["time"] = float(m.group(2))
    for ep, sp in speeds.items():
        rows[ep]["speed"] = sum(sp) / len(sp)
    cols = metrics + ["speed", "time"]
    return dict(sorted(rows.items())), cols


def parse_records(lines):
    """Every structured JSONL record in the log, in order — a
    GENERATOR (the stream behind :func:`rank_report`, which
    accumulates O(ranks + outliers), not O(lines))."""
    for line in lines:
        rec = _try_jsonl(line)
        if rec is not None:
            yield rec


class EwmaBand:
    """Incremental EWMA outlier band — the ONE implementation behind
    :func:`ewma_outliers` and :func:`rank_report`.

    The band is ``ewma + max(band * ew_std, rel_floor * ewma)``: the
    EW standard deviation catches spikes against a stable baseline,
    and the relative floor keeps a near-zero-variance series (tight
    synthetic steps) from flagging measurement jitter.  Flagged
    values do NOT fold into the EWMA — a straggler must not drag the
    band up after itself.  The first value seeds the mean unflagged."""

    def __init__(self, alpha=0.3, band=3.0, rel_floor=0.25):
        self.alpha = alpha
        self.band = band
        self.rel_floor = rel_floor
        self.ewma = None
        self.ewvar = 0.0

    def update(self, v):
        """Feed one value; returns True when it is an outlier."""
        v = float(v)
        if self.ewma is None:
            self.ewma = v
            return False
        thresh = self.ewma + max(self.band * self.ewvar ** 0.5,
                                 self.rel_floor * self.ewma)
        if v > thresh:
            return True
        d = v - self.ewma
        self.ewma += self.alpha * d
        self.ewvar = (1.0 - self.alpha) * (self.ewvar
                                           + self.alpha * d * d)
        return False


def ewma_outliers(values, alpha=0.3, band=3.0, rel_floor=0.25):
    """Indices of `values` beyond the running :class:`EwmaBand`."""
    bd = EwmaBand(alpha=alpha, band=band, rel_floor=rel_floor)
    return [i for i, v in enumerate(values) if bd.update(v)]


def rank_report(records, band=3.0, alpha=0.3, rel_floor=0.25):
    """Group JSONL records by ``rank`` and flag per-rank step-time
    outliers beyond the :class:`EwmaBand` — streaming: per-rank state
    is the band plus the flagged points, so a hundreds-of-MB
    concatenated dist log never materializes.

    Step time proxy: ``1 / samples_per_sec`` (seconds per sample) —
    batch size cancels out of the outlier test.  Returns ``{rank:
    {"samples", "mean_samples_per_sec", "role", "host",
    "outliers": [{"epoch", "batch", "sec_per_sample", "index"}]}}``,
    or {} when no record carries a rank.

    Records carrying the goodput-ledger ``loss_bucket`` column
    additionally yield a per-rank dominant loss bucket; a rank whose
    dominant bucket differs from the FLEET MODE is flagged
    (``divergent_loss_bucket``) — "everyone loses to exposed wire but
    rank 3 loses to input stall" is a per-worker problem, not a fleet
    one (docs/observability.md "Goodput ledger")."""
    state = {}
    for rec in records:
        rank = rec.get("rank")
        if rank is None:
            continue
        try:
            rank = int(rank)
            sps = float(rec.get("samples_per_sec"))
        except (TypeError, ValueError):
            continue
        if sps <= 0:
            continue
        st = state.get(rank)
        if st is None:
            st = state[rank] = {"n": 0, "sum_sps": 0.0,
                                "role": rec.get("role"),
                                "host": rec.get("host"),
                                "band": EwmaBand(alpha=alpha,
                                                 band=band,
                                                 rel_floor=rel_floor),
                                "buckets": defaultdict(int),
                                "outliers": []}
        t = 1.0 / sps
        i = st["n"]
        st["n"] += 1
        st["sum_sps"] += sps
        lb = rec.get("loss_bucket")
        if isinstance(lb, str) and lb:
            st["buckets"][lb] += 1
        # a single audit_ok=False record marks the rank for the whole
        # report: divergence is not a thing that un-happens
        if rec.get("audit_ok") is False:
            st["audit_diverged"] = True
        if st["band"].update(t):
            st["outliers"].append(
                {"index": i, "epoch": rec.get("epoch"),
                 "batch": rec.get("batch"),
                 "sec_per_sample": round(t, 9)})
    dominant = {rank: max(st["buckets"], key=st["buckets"].get)
                for rank, st in state.items() if st["buckets"]}
    mode = None
    if dominant:
        counts = defaultdict(int)
        for b in dominant.values():
            counts[b] += 1
        mode = max(sorted(counts), key=counts.get)
    out = {}
    for rank, st in sorted(state.items()):
        row = {"samples": st["n"],
               "mean_samples_per_sec": round(
                   st["sum_sps"] / st["n"], 3),
               "role": st["role"], "host": st["host"],
               "outliers": st["outliers"]}
        lb = dominant.get(rank)
        if lb is not None:
            row["loss_bucket"] = lb
            row["divergent_loss_bucket"] = bool(
                mode is not None and lb != mode
                and len(dominant) >= 2)
        if st.get("audit_diverged"):
            # the numerics divergence audit named this rank
            # (docs/observability.md "Numerics & model health")
            row["audit_diverged"] = True
        out[rank] = row
    return out


def format_rank_report(report):
    lines = ["per-rank (EWMA step-time band):"]
    for rank, info in report.items():
        flags = info["outliers"]
        where = ", ".join(f"epoch {o['epoch']} batch {o['batch']}"
                          for o in flags) if flags else "none"
        extra = ""
        if info.get("loss_bucket"):
            extra = f"; loses to {info['loss_bucket']}"
            if info.get("divergent_loss_bucket"):
                extra += " (DIVERGES from fleet mode)"
        if info.get("audit_diverged"):
            extra += "; AUDIT DIVERGED (weights differ from fleet)"
        lines.append(
            f"  rank {rank} ({info.get('role') or '?'}@"
            f"{info.get('host') or '?'}): "
            f"{info['mean_samples_per_sec']:.6g} samples/sec over "
            f"{info['samples']} windows; outliers: {where}{extra}")
    return "\n".join(lines)


def _cell(row, c):
    if c not in row:
        return "-"
    v = row[c]
    return v if isinstance(v, str) else f"{v:.6g}"


def format_rows(rows, cols, fmt="table"):
    header = ["epoch"] + cols
    body = [[str(ep)] + [_cell(row, c) for c in cols]
            for ep, row in rows.items()]
    if fmt == "csv":
        return "\n".join(",".join(r) for r in [header] + body)
    if fmt == "markdown":
        lines = ["| " + " | ".join(header) + " |",
                 "|" + "|".join("---" for _ in header) + "|"]
        lines += ["| " + " | ".join(r) + " |" for r in body]
        return "\n".join(lines)
    widths = [max(len(r[i]) for r in [header] + body)
              for i in range(len(header))]
    out = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    out += ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in body]
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logfile")
    ap.add_argument("--format", default="table",
                    choices=("table", "markdown", "csv"))
    ap.add_argument("--band", type=float, default=3.0,
                    help="EWMA band width (EW standard deviations) "
                         "for per-rank step-time outlier flags")
    args = ap.parse_args(argv)
    # two streaming passes, not readlines(): a concatenated dist-run
    # JSONL log can run to hundreds of MB
    with open(args.logfile) as f:
        rows, cols = parse_log(f)
    if not rows:
        print("no epoch records found", file=sys.stderr)
        return 1
    print(format_rows(rows, cols, args.format))
    with open(args.logfile) as f:
        report = rank_report(parse_records(f), band=args.band)
    if report:
        # csv/markdown stdout is a machine-readable contract — the
        # prose rank report must not corrupt it; it goes to stderr
        # there instead
        out = sys.stdout if args.format == "table" else sys.stderr
        print(file=out)
        print(format_rank_report(report), file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
