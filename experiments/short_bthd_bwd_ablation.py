"""Ablations of the BTHD short attention backward's persistent kernel
(row 6, `bthd_bwd_tma`), on the card: each builds a copy of
`incubator_mxnet_torch/csrc/flash_short_bthd_bwd.cu` with one design
choice undone or one part of the work removed, and times it beside the
kernel as it is, at BERT-base's training shape on the BTHD route.

    python3 experiments/short_bthd_bwd_ablation.py [--json OUT] [--only ...]

A measurement script, not part of the package: each ablation is a set
of exact text substitutions on the kernel's source as it stood when the
ablation was written, and raises when the source no longer holds that
text (built by `short_fwd_ablation.build_variants`).  The timing
(`time_ms`), the shapes, the inputs and the tolerance are chip_smoke.py's.
Ablations:

- ``single_stage``: one stage instead of two: the next batch-head's
  loads start only once the last one's stores have read the stage, so
  no load overlaps any math (the same results bit for bit);
- ``producer_warp``: the producer a single warp (288 threads) and no
  `setmaxnreg`, so that every thread keeps the registers ptxas gives a
  288-thread block (the same results);
- ``two_blocks_nonpersistent``: the launch shape of the kernel this one
  replaced, one block of 256 threads a batch-head and two blocks an SM
  (`__launch_bounds__(256, 2)`: the two consumer warpgroups alone, in at
  most 128 registers a thread, no `setmaxnreg`), each block with one
  stage that its first warp loads before the math, so that the other
  block's work fills an SM's gaps instead of the next batch-head's loads
  (the same results);
- ``no_math``: neither product nor ds (wrong results: the floor that the
  loads and stores set).

Each variant's device time (mean of 20 back-to-back launches, CUDA
events) at B = 60, T = 128, H = 12, d = 64, bf16, q, k, v views of one
(B, T, 3E) buffer, kv_length random with 0 and T among them, non-causal,
in turns with the kernel as built from the source; and, for the variants
that keep the results, the largest error of dq, dk, dv against the
plain version relative to the largest reference value (GRAD_RTOL),
causal and not.
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
    D, GRAD_RTOL, HEADS, T, TRAIN_BATCH, _bthd_inputs, card_line, time_ms)
from incubator_mxnet_torch import _kernels  # noqa: E402
from incubator_mxnet_torch.ops import flash_attention as fa  # noqa: E402
from short_fwd_ablation import build_variants  # noqa: E402

GRAD_RTOL = GRAD_RTOL[torch.bfloat16]
_SRC = os.path.join(_kernels._CSRC, "flash_short_bthd_bwd.cu")

_NO_STAGES = [("constexpr int STAGES = 2;", "constexpr int STAGES = 1;")]
# name: (substitutions, keeps the results)
ABLATIONS = {
    "single_stage": (_NO_STAGES, True),
    "producer_warp": ([
        ("constexpr int THREADS = 384;", "constexpr int THREADS = 288;"),
        ('asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" '
         '::"n"(PRODUCER_REGS));', ""),
        ('asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" '
         '::"n"(CONSUMER_REGS));', "")], True),
    "two_blocks_nonpersistent": (_NO_STAGES + [
        ("constexpr int THREADS = 384;", "constexpr int THREADS = 256;"),
        ("__launch_bounds__(bt::THREADS, 1)",
         "__launch_bounds__(bt::THREADS, 2)"),
        ('asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" '
         '::"n"(PRODUCER_REGS));', ""),
        ('asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" '
         '::"n"(CONSUMER_REGS));', ""),
        ("bthd_bwd_tma<<<persistent_grid(bh), THREADS",
         "bthd_bwd_tma<<<bh, THREADS"),
        ("    mbar_wait(&full[s], (i / STAGES) & 1);",
         "    if (tid < 32)\n      bthd_load(maps, ring + s * STAGE, dls + s * N, "
         "delta, bh, heads,\n                &full[s], tid);\n"
         "    mbar_wait(&full[s], (i / STAGES) & 1);")], True),
    "no_math": ([("wgmma_m64n128k16_ss(dp,", "if (0) wgmma_m64n128k16_ss(dp,"),
                 ("wgmma_m64n64k16_rs(dv,", "if (0) wgmma_m64n64k16_rs(dv,"),
                 ("wgmma_m64n64k16_rs(dk,", "if (0) wgmma_m64n64k16_rs(dk,"),
                 ("wgmma_m64n64k16_ss<0, 1>(dq,",
                  "if (0) wgmma_m64n64k16_ss<0, 1>(dq,"),
                 ("    bthd_ds(pa, da,", "    if (0) bthd_ds(pa, da,")],
                False),
}


def _use(path):
    """Route the wrapper's `flash_short_bthd_bwd` entry to the library at
    `path` (None: the kernel as built from the source)."""
    _kernels._entries.pop("flash_short_bthd_bwd", None)
    if path is None:
        return
    fn = ctypes.CDLL(path).flash_short_bthd_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_int,
                                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _kernels._entries["flash_short_bthd_bwd"] = fn


def _args(gen, causal):
    """Row 6's arguments at the training shape, from the plain forward's
    o and p."""
    _buf, q, k, v, do, lengths = _bthd_inputs(gen, TRAIN_BATCH,
                                              torch.bfloat16)
    scale = D ** -0.5
    o, p = fa.flash_short_bthd_reference(q, k, v, lengths, scale, causal,
                                         save_p=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, delta, p, scale


def _max_rel_err(args):
    got = fa.flash_short_bthd_bwd(*args)
    ref = fa.flash_short_bthd_bwd_reference(*args)
    errs = [((a.float() - b.float()).abs().max()
             / b.float().abs().max()).item() for a, b in zip(got, ref)]
    if not max(errs) <= GRAD_RTOL:
        raise AssertionError(f"disagrees with the plain version: {errs}")
    return max(errs)


def measure(names=tuple(ABLATIONS), rounds=2, seed=3):
    """{variant: {"ms": [...], "max_rel_err": ...}}, the kernel as built
    ("kernel") first in every round."""
    built = build_variants(_SRC, {n: ABLATIONS[n][0] for n in names})
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = {causal: _args(gen, causal) for causal in (False, True)}
    out = {}
    for _ in range(rounds):
        for name in ("kernel", *names):
            _use(built.get(name))
            rec = out.setdefault(name, {"ms": []})
            if "max_rel_err" not in rec and (name == "kernel"
                                             or ABLATIONS[name][1]):
                rec["max_rel_err"] = max(_max_rel_err(a)
                                         for a in cases.values())
            args = cases[False]
            rec["ms"].append(time_ms(lambda: fa.flash_short_bthd_bwd(*args)))
            print(f"[short_bthd_bwd_ablation] {name}: {rec['ms'][-1]:.4f} ms",
                  flush=True)
    _use(None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the records to this file")
    ap.add_argument("--only", nargs="*", choices=sorted(ABLATIONS),
                    help="these ablations only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("short_bthd_bwd_ablation: needs a CUDA card")
    card = card_line()
    recs = measure(tuple(args.only or ABLATIONS))
    for name, r in recs.items():
        err = r.get("max_rel_err")
        print(f"[short_bthd_bwd_ablation] {name}: B={TRAIN_BATCH} T={T} "
              f"H={HEADS} d={D} {' '.join(f'{m:.4f}' for m in r['ms'])} ms, "
              + ("results changed by design" if err is None
                 else f"max|err|/max|ref| {err:.3e}") + f" ({card})",
              flush=True)
    line = {"card": card, "records": recs}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
