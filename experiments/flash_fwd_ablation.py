"""Ablations of the streaming attention forward kernel (row 2,
`fwd_tma`), on the card: each builds a copy of
`incubator_mxnet_torch/csrc/flash_fwd.cu` with one design choice undone
or one part of the work removed, and times it beside the kernel as it
is, at BERT-base's T = 2048 shapes.

    python3 experiments/flash_fwd_ablation.py [--json OUT] [--only ...]

A measurement script, not part of the package: each ablation is a set
of exact text substitutions on the kernel's source as it stood when the
ablation was written, and raises when the source no longer holds that
text (built by `short_fwd_ablation.build_variants`).  The timing
(`time_ms`), the shapes and the tolerances are chip_smoke.py's.
Ablations:

- ``no_turns``: the consumer warpgroups issue their products whenever
  they are ready, without taking turns;
- ``two_consumers``: two consumer warpgroups and 128-row work tiles
  instead of three and 192 (with 232 registers a consumer thread
  instead of 160);
- ``serial_softmax``: a consumer waits for p·v of step j-1 before the
  softmax of step j, which then no longer runs under it;
- ``two_stages``, ``three_stages``: a k/v ring of 2 or 3 stages
  instead of 4;
- ``precise_exp``: CUDA's expf instead of ex2.approx (the same results
  within the tolerances);
- ``always_mask``: `fa_score` on every key step, not only on the steps
  that need a mask (the same results bit for bit);
- ``no_exp``: the softmax without its exp (wrong results: what the exp
  costs);
- ``no_v_loads``: k loaded, v not (wrong results: what half the k/v
  stream from L2 costs);
- ``no_math``: neither product nor exp (wrong results: the floor that
  the loads, the stores and the rest of the softmax set).

Each variant's device time (mean of 20 back-to-back launches, CUDA
events) in bf16, d = 64, every kv_length T = 2048, at BH = 4*12 (the
training step's shape) non-causal and causal and at BH = 16*12 (the
serving forward's), in turns with the kernel as built from the source;
and, for the variants that keep the results, the largest error against
the plain version at BH = 48 with kv_length random, 0 and T among them.
"""
import argparse
import ctypes
import json
import os
import sys
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)
from chip_smoke import (  # noqa: E402
    ATOL, D, HEADS, LONG_CAPACITY, LONG_T, LONG_TRAIN_BATCH, LSE_ATOL,
    card_line, time_ms)
from incubator_mxnet_torch import _kernels  # noqa: E402
from incubator_mxnet_torch.ops import flash_attention as fa  # noqa: E402
from short_fwd_ablation import build_variants  # noqa: E402

ATOL = ATOL[torch.bfloat16]
BLOCKS = (512, 1024)

_SRC = os.path.join(_kernels._CSRC, "flash_fwd.cu")

_NO_EXP = [("fa_exp(sc[4 * nt + e] - mx0)", "(sc[4 * nt + e] - mx0)"),
           ("fa_exp(sc[4 * nt + 2 + e] - mx1)",
            "(sc[4 * nt + 2 + e] - mx1)")]

# name: (substitutions, keeps the results)
ABLATIONS = {
    "no_turns": ([("if (c == NC - 1) pair_arrive(SCHED);", ""),
                  ("if (c == 0) pair_sync(SCHED);", ""),
                  ("pair_sync(SCHED + c);", ";"),
                  ("pair_arrive(SCHED + (c + 1) % NC);", ";")], True),
    "serial_softmax": ([("      wgmma_wait<1>();\n",
                         "      wgmma_wait<0>();\n")], True),
    "two_stages": ([("constexpr int STAGES = 4;",
                     "constexpr int STAGES = 2;")], True),
    "three_stages": ([("constexpr int STAGES = 4;",
                       "constexpr int STAGES = 3;")], True),
    "precise_exp": ([("  float y;\n  asm(", "  return expf(x);\n  float y;\n"
                      "  asm(")], True),
    "always_mask": ([("return len == 0 || c0 + BK > lim ||",
                      "return true || c0 + BK > lim ||")], True),
    "no_exp": (_NO_EXP, False),
    "two_consumers": ([("constexpr int NC = 3;", "constexpr int NC = 2;"),
                       ("constexpr int PRODUCER_REGS = 24;",
                        "constexpr int PRODUCER_REGS = 40;"),
                       ("constexpr int CONSUMER_REGS = 160;",
                        "constexpr int CONSUMER_REGS = 232;")], True),
    "no_v_loads": ([("mbar_expect_tx(&full[s], STAGE);",
                     "mbar_expect_tx(&full[s], KV);"),
                    ("          tma_load(st + KV,",
                     "          if (0) tma_load(st + KV,")], False),
    "no_math": (_NO_EXP + [
        ("    wgmma_m64n128k16_ss(sc,", "    if (0) wgmma_m64n128k16_ss(sc,"),
        ("    wgmma_m64n64k16_rs(oc,", "    if (0) wgmma_m64n64k16_rs(oc,")],
        False),
}


def _use(path):
    """Route the wrappers' `flash_fwd` entry to the library at `path`
    (None: the kernel as built from the source)."""
    _kernels._entries.pop("flash_fwd", None)
    if path is None:
        return
    fn = ctypes.CDLL(path).flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _kernels._entries["flash_fwd"] = fn


def _inputs(gen, batch, random_lengths):
    bh = batch * HEADS
    q, k, v = (torch.randn(bh, LONG_T, D, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    if random_lengths:
        per_row = torch.randint(0, LONG_T + 1, (batch,), generator=gen,
                                device="cuda", dtype=torch.int32)
        per_row[0], per_row[1] = 0, LONG_T
        lengths = per_row.repeat_interleave(HEADS)
    else:
        lengths = torch.full((bh,), LONG_T, dtype=torch.int32,
                             device="cuda")
    return q, k, v, lengths


def _max_err(x, causal):
    o, lse = fa.flash_fwd(*x, D ** -0.5, causal, *BLOCKS)
    ro, rlse = fa.flash_fwd_reference(*x, D ** -0.5, causal, *BLOCKS)
    live = x[3] > 0
    o_err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse[live] - rlse[live]).abs().max().item()
    if not (o_err <= ATOL and lse_err <= LSE_ATOL
            and torch.all(lse[~live] == -1e30)):
        raise AssertionError(f"disagrees with the plain version: o {o_err}, "
                             f"lse {lse_err}")
    return o_err


def measure(names=tuple(ABLATIONS), rounds=2, seed=0):
    """{variant: {"train_ms": [...], "train_causal_ms": [...],
    "serve_ms": [...], "max_abs_err": ...}}, the kernel as built
    ("kernel") first in every round."""
    t0 = time.time()
    built = build_variants(_SRC, {n: ABLATIONS[n][0] for n in names})
    print(f"[flash_fwd_ablation] built {len(built)} variants in "
          f"{time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    check = _inputs(gen, LONG_TRAIN_BATCH, True)
    train = _inputs(gen, LONG_TRAIN_BATCH, False)
    serve = _inputs(gen, LONG_CAPACITY, False)
    scale = D ** -0.5
    out = {}
    for _ in range(rounds):
        for name in ("kernel", *names):
            _use(built.get(name))
            rec = out.setdefault(name, {
                "train_ms": [], "train_causal_ms": [], "serve_ms": []})
            if "max_abs_err" not in rec and (name == "kernel"
                                             or ABLATIONS[name][1]):
                rec["max_abs_err"] = max(_max_err(check, c)
                                         for c in (False, True))
            for key, x, causal in (("train_ms", train, False),
                                   ("train_causal_ms", train, True),
                                   ("serve_ms", serve, False)):
                rec[key].append(time_ms(lambda: fa.flash_fwd(
                    *x, scale, causal, *BLOCKS)))
            print(f"[flash_fwd_ablation] {name}: "
                  + ", ".join(f"{k} {v[-1]:.4f}" for k, v in rec.items()
                              if k.endswith("_ms")), flush=True)
    _use(None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the records to this file")
    ap.add_argument("--only", nargs="*", choices=sorted(ABLATIONS),
                    help="these ablations only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_ablation: needs a CUDA card")
    card = card_line()
    recs = measure(tuple(args.only or ABLATIONS))

    def ms(xs):
        return " ".join(f"{m:.4f}" for m in xs)
    for name, r in recs.items():
        err = r.get("max_abs_err")
        print(f"[flash_fwd_ablation] {name}: BH={LONG_TRAIN_BATCH * HEADS} "
              f"{ms(r['train_ms'])} ms, causal {ms(r['train_causal_ms'])} "
              f"ms; BH={LONG_CAPACITY * HEADS} {ms(r['serve_ms'])} ms; "
              + ("results changed by design" if err is None
                 else f"max|err| {err:.3e}") + f" ({card})", flush=True)
    line = {"card": card, "records": recs}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
