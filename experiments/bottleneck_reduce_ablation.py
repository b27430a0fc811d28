"""Ablations of the bottleneck backward's persistent reduce kernel (row 8a,
`bnb_reduce_tma`), on the card: each builds a copy of
`incubator_mxnet_torch/csrc/bottleneck_bwd.cu` with one design choice
undone or one part of the work removed, and times the reduce pass beside
the kernel as it is, at ResNet-50 stage 1's two shapes.

    python3 experiments/bottleneck_reduce_ablation.py [--json OUT] [--only ...]

A measurement script, not part of the package: each ablation is a set
of exact text substitutions on the kernel's source as it stood when the
ablation was written, and raises when the source no longer holds that
text (built by `short_fwd_ablation.build_variants`).  The timing
(`time_ms`), the shapes, the inputs and the tolerance are chip_smoke.py's.
Ablations:

- ``single_stage``: one ring stage a consumer instead of two: a
  consumer's next tile is loaded only once it has given its last one
  back, so its loads no longer overlap its own math (the same results
  bit for bit);
- ``one_consumer``: one consumer warpgroup takes every tile of its
  block, its four stages in turn, instead of two in turns (the same
  results, summed in another order);
- ``two_sums``: the partials of s1 and s2 summed by two launches, as
  before this kernel, instead of one over the (G, 2K) partial (the same
  results bit for bit);
- ``pr5_kernel``: the pass as it was before this kernel, `bnb_reduce`
  (a block a K tile, x staged once per K tile and W every row tile,
  mma.sync, groups sized by occupancy) with its two sums (the same
  results, summed in another order);
- ``no_math``: neither the products nor the sums of dy and dy·zh (wrong
  results: the floor that the loads, the ring's handshakes and the
  partial sums set).

Each variant's device time (mean of 20 back-to-back launches of the
wrapper, CUDA events; it includes the fixed-order sum of the partials)
at M = 256*56*56 rows, 64 -> 256 and 256 -> 64, bf16, in turns with the
kernel as built from the source; and, for the variants that keep the
results, the mean relative error of s1 and s2 against the plain version
(BNB_RTOL).
"""
import argparse
import ctypes
import json
import os
import sys

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)
from chip_smoke import (  # noqa: E402
    BNB_RTOL, BNB_SHAPES, _bnb_inputs, _rel, card_line, time_ms)
from incubator_mxnet_torch import _kernels  # noqa: E402
from incubator_mxnet_torch.tools import bottleneck_bwd as bnb  # noqa: E402
from short_fwd_ablation import build_variants  # noqa: E402

_SRC = os.path.join(_kernels._CSRC, "bottleneck_bwd.cu")
SHAPES = ("stage 1", "stage 1 reversed")

_ONE_SUM = "err = launch_sum(part, groups, 2LL * K, 2LL * K, K, s1, s2, st);"
_TWO_SUMS = ("err = launch_sum(part, groups, K, 2LL * K, K, s1, nullptr, "
             "st);\n  if (err == cudaSuccess) err = launch_sum(part + K, "
             "groups, K, 2LL * K, K, s2, nullptr, st);")
# name: (substitutions, keeps the results)
ABLATIONS = {
    "single_stage": ([("constexpr int RING = 4;",
                       "constexpr int RING = 2;")], True),
    "one_consumer": ([("constexpr int CONSUMERS = 2;",
                       "constexpr int CONSUMERS = 1;")], True),
    "two_sums": ([(_ONE_SUM, _TWO_SUMS)], True),
    "pr5_kernel": ([("  if (nc == 1) {\n    err = launch_reduce_tma<1, 4>",
                     "  if (false) {\n    err = launch_reduce_tma<1, 4>"),
                    ("  } else if (nc == 4) {\n    err = launch_reduce_tma",
                     "  } else if (false) {\n    err = launch_reduce_tma"),
                    ("  if (nc > 0) return persistent_grid(geo.nM);",
                     "  if (pass == 1 && nc > 0) return "
                     "persistent_grid(geo.nM);"),
                    (_ONE_SUM, _TWO_SUMS)], True),
    "no_math": ([("wgmma_m64n64k16_ss<0, 1>(zc,",
                  "if (0) wgmma_m64n64k16_ss<0, 1>(zc,"),
                 ("      for (int j = 0; j < 8; ++j) {\n"
                  "        const float2 mm =",
                  "      for (int j = 0; j < 0; ++j) {\n"
                  "        const float2 mm =")], False),
}
# the entry points the wrapper takes from the library, with their types
ENTRIES = {"bottleneck_bwd_groups": [ctypes.c_int] * 4,
           "bottleneck_bwd_reduce": [ctypes.c_void_p] * 8
           + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


def _use(path):
    """Route the wrapper's reduce entries to the library at `path` (None:
    the kernel as built from the source)."""
    for name in ENTRIES:
        _kernels._entries.pop(name, None)
    if path is None:
        return
    lib = ctypes.CDLL(path)
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _kernels._entries[name] = fn


def measure(names=tuple(ABLATIONS), rounds=2, seed=5):
    """{variant: {shape: {"ms": [...], "rel_err": ...}}}, the kernel as
    built ("kernel") first in every round."""
    built = build_variants(_SRC, {n: ABLATIONS[n][0] for n in names})
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = {}
    for what in SHAPES:
        x, w, _gamma, _beta, dy, m, inv = _bnb_inputs(gen, *BNB_SHAPES[what])
        args = (dy, x, w, m, inv)
        cases[what] = (args, bnb.bottleneck_reduce_reference(*args))
    out = {}
    for _ in range(rounds):
        for name in ("kernel", *names):
            _use(built.get(name))
            rec = out.setdefault(name, {what: {"ms": []} for what in SHAPES})
            for what, (args, ref) in cases.items():
                r = rec[what]
                if "rel_err" not in r and (name == "kernel"
                                           or ABLATIONS[name][1]):
                    got = bnb.bottleneck_bwd_reduce(*args)
                    errs = [_rel(a, b) for a, b in zip(ref, got)]
                    if not max(errs) <= BNB_RTOL:
                        raise AssertionError(f"{name} at {what} disagrees "
                                             f"with the plain version: "
                                             f"{errs}")
                    r["rel_err"] = max(errs)
                r["ms"].append(time_ms(
                    lambda: bnb.bottleneck_bwd_reduce(*args)))
            print(f"[bottleneck_reduce_ablation] {name}: "
                  + ", ".join(f"{what} {r['ms'][-1]:.4f} ms"
                              for what, r in rec.items()), flush=True)
    _use(None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the records to this file")
    ap.add_argument("--only", nargs="*", choices=sorted(ABLATIONS),
                    help="these ablations only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bottleneck_reduce_ablation: needs a CUDA card")
    card = card_line()
    recs = measure(tuple(args.only or ABLATIONS))
    for name, rec in recs.items():
        for what, r in rec.items():
            err = r.get("rel_err")
            M, C, K = BNB_SHAPES[what]
            print(f"[bottleneck_reduce_ablation] {name}: {what} M={M} C={C} "
                  f"K={K} {' '.join(f'{m:.4f}' for m in r['ms'])} ms, "
                  + ("results changed by design" if err is None
                     else f"mean rel err {err:.3e}") + f" ({card})",
                  flush=True)
    line = {"card": card, "records": recs}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
