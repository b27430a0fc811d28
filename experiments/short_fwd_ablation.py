"""Ablations of the short attention forward kernel (rows 1, 1b, 5), on
the card: each builds a copy of
`incubator_mxnet_torch/csrc/flash_short_fwd.cu` with one design choice
undone or one part of the work removed, and times it beside the kernel
as it is, at BERT-base's shapes.

    python3 experiments/short_fwd_ablation.py [--json OUT] [--only ...]

A measurement script, not part of the package: each ablation is a set
of exact text substitutions on the kernel's source as it stood when the
ablation was written, and raises when the source no longer holds that
text.  The timing (`time_ms`), the shapes and the tolerances are
chip_smoke.py's.  Ablations:

- ``ieee_division``: p = x / l by CUDA's own division instead of
  `quotient` (same results; its operand check sends zero numerators to
  a slow subroutine);
- ``lockstep``: both consumers on every batch-head, consumer c on its
  half c, instead of alternate batch-heads, both halves each;
- ``two_stages``: a ring of 2 batch-head stages instead of 3;
- ``no_exp``: the softmax without its exp (wrong results: what the exp
  costs);
- ``no_math``: neither product nor exp (wrong results: the floor the
  loads, stores and the rest of the softmax set).

Each variant's device time (mean of 20 back-to-back launches, CUDA
events) at BH = 128*12 (the inference form, row 1) and BH = 60*12 (the
training form, row 1b), bf16, T = 128, d = 64, non-causal, in turns
with the kernel as built from the source, and for the variants that
keep the results, the largest error against the plain version.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import (  # noqa: E402
    ATOL, BH_BATCH as SERVE_BATCH, HEADS, P_ATOL, TRAIN_BATCH, D, T,
    card_line, time_ms)
from incubator_mxnet_torch import _kernels  # noqa: E402
from incubator_mxnet_torch.ops import flash_attention as fa  # noqa: E402

ATOL, P_ATOL = ATOL[torch.bfloat16], P_ATOL[torch.bfloat16]

_SRC = os.path.join(_kernels._CSRC, "flash_short_fwd.cu")
_OUT = os.path.join(_kernels.BUILD_DIR, "ablation")

# name: (substitutions, keeps the results)
ABLATIONS = {
    "ieee_division": ([("  const float q = x * inv;\n"
                        "  return fmaf(fmaf(-l, q, x), inv, q);",
                        "  return x / l;")], True),
    "lockstep": ([("for (int i = c, bh = blockIdx.x + c * gridDim.x;"
                   " bh < bh_total;\n       i += 2, bh += 2 * gridDim.x)",
                   "for (int i = 0, bh = blockIdx.x; bh < bh_total;\n"
                   "       i += 1, bh += gridDim.x)"),
                  ("for (int hf = 0; hf < 2; ++hf)",
                   "for (int hf = c; hf == c; ++hf)"),
                  ("if (lead && hf == 1) mbar_arrive", "if (lead) mbar_arrive"),
                  ("mbar_init(&empty[s], 1);", "mbar_init(&empty[s], 2);")],
                 True),
    "two_stages": ([("constexpr int STAGES = 3;",
                     "constexpr int STAGES = 2;")], True),
    "no_exp": ([("expf(sc[4 * nt + e] - m0)", "(sc[4 * nt + e] - m0)"),
                ("expf(sc[4 * nt + 2 + e] - m1)",
                 "(sc[4 * nt + 2 + e] - m1)")], False),
    "no_math": ([("expf(sc[4 * nt + e] - m0)", "(sc[4 * nt + e] - m0)"),
                 ("expf(sc[4 * nt + 2 + e] - m1)",
                  "(sc[4 * nt + 2 + e] - m1)"),
                 ("        wgmma_m64n128k16_ss(", "        if (0)"
                  " wgmma_m64n128k16_ss("),
                 ("        wgmma_m64n64k16_rs(", "        if (0)"
                  " wgmma_m64n64k16_rs(")], False),
}


def variant_source(path, subs):
    """The text of the kernel source at `path` with the substitutions
    `subs` made, its `#include "x.cuh"` lines pointing into csrc/."""
    with open(path) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"ablation no longer matches the source: "
                               f"{old!r}")
        src = src.replace(old, new)
    return re.sub(r'#include "(\w+\.cuh)"',
                  lambda m: f'#include "{_kernels._CSRC}/{m.group(1)}"', src)


def build_variants(path, variants):
    """{name: path of the built library} for `variants` ({name:
    substitutions}) of the kernel source at `path`, one nvcc each, all
    started together."""
    os.makedirs(_OUT, exist_ok=True)
    stem = os.path.splitext(os.path.basename(path))[0]
    procs = {}
    for name, subs in variants.items():
        cu = os.path.join(_OUT, f"{stem}-{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(path, subs))
        so = os.path.join(_OUT, f"lib{stem}-{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        built[name] = so
    return built


def build(names):
    """{name: path of the built library} for the ablations `names`."""
    return build_variants(_SRC, {n: ABLATIONS[n][0] for n in names})


def _use(path):
    """Route the wrappers' `flash_short_fwd` entry to the library at
    `path` (None: the kernel as built from the source)."""
    _kernels._entries.pop("flash_short_fwd", None)
    if path is None:
        return
    fn = ctypes.CDLL(path).flash_short_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _kernels._entries["flash_short_fwd"] = fn


def _inputs(gen, batch):
    bh = batch * HEADS
    q, k, v = (torch.randn(bh, T, D, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lengths = torch.randint(0, T + 1, (batch,), generator=gen,
                            device="cuda", dtype=torch.int32)
    lengths[0], lengths[1] = 0, T
    return q, k, v, lengths.repeat_interleave(HEADS)


def measure(names=tuple(ABLATIONS), rounds=2, seed=0):
    """{variant: {"serve_ms": [...], "train_ms": [...], "max_abs_err":
    ...}}, the kernel as built ("kernel") first in every round."""
    built = build(names)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    serve, train = _inputs(gen, SERVE_BATCH), _inputs(gen, TRAIN_BATCH)
    scale = D ** -0.5
    out = {}
    for _ in range(rounds):
        for name in ("kernel", *names):
            _use(built.get(name))
            rec = out.setdefault(name, {"serve_ms": [], "train_ms": []})
            if "max_abs_err" not in rec and (name == "kernel"
                                             or ABLATIONS[name][1]):
                o = fa.flash_short_fwd(*serve, scale, False)
                to, tp = fa.flash_short_fwd_train(*train, scale, False)
                ro = fa.flash_short_reference(*serve, scale, False)
                rto, rtp = fa.flash_short_reference(*train, scale, False,
                                                    save_p=True)
                errs = [(a.float() - b.float()).abs().max().item()
                        for a, b in ((o, ro), (to, rto), (tp, rtp))]
                if not (max(errs[:2]) <= ATOL and errs[2] <= P_ATOL):
                    raise AssertionError(f"{name} disagrees with the plain "
                                         f"version: {errs}")
                rec["max_abs_err"] = max(errs)
            rec["serve_ms"].append(time_ms(
                lambda: fa.flash_short_fwd(*serve, scale, False)))
            rec["train_ms"].append(time_ms(
                lambda: fa.flash_short_fwd_train(*train, scale, False)))
    _use(None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the records to this file")
    ap.add_argument("--only", nargs="*", choices=sorted(ABLATIONS),
                    help="these ablations only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("short_fwd_ablation: needs a CUDA card")
    card = card_line()
    recs = measure(tuple(args.only or ABLATIONS))
    for name, r in recs.items():
        err = r.get("max_abs_err")
        print(f"[short_fwd_ablation] {name}: BH={SERVE_BATCH * HEADS} "
              f"{' '.join(f'{m:.4f}' for m in r['serve_ms'])} ms, "
              f"training form BH={TRAIN_BATCH * HEADS} "
              f"{' '.join(f'{m:.4f}' for m in r['train_ms'])} ms, "
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
