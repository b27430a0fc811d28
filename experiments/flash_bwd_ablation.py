"""Ablations of the streaming attention backward kernels (rows 3 and 4,
`bwd_dq_tma` and `bwd_dkv_tma`), on the card: each builds a copy of
`incubator_mxnet_torch/csrc/flash_bwd.cu` with one design choice undone
or one part of the work removed, and times both kernels beside the
kernels as they are, at BERT-base's T = 2048 training shape.

    python3 experiments/flash_bwd_ablation.py [--json OUT] [--only ...]

A measurement script, not part of the package: each ablation is a set
of exact text substitutions on the kernels' source as it stood when the
ablation was written, and raises when the source no longer holds that
text (built by `short_fwd_ablation.build_variants`).  The timing
(`time_ms`), the shapes and the tolerances are chip_smoke.py's.
Ablations (each applies to both kernels):

- ``precise_exp``: CUDA's expf instead of ex2.approx (the same results
  within the tolerances);
- ``always_mask``: the mask on every step, not only on the steps that
  need it (the same results bit for bit);
- ``three_consumers``: three consumer warpgroups with 160 registers a
  thread instead of two with 240, so 192-row (dq) and 192-key (dk/dv)
  work tiles; dq then steps 64 keys at a time (its products would not
  fit in 160 registers at 128), dk/dv keeps its 64-row steps;
- ``no_turns``: the consumers issue their products whenever they are
  ready, without taking turns;
- ``no_exp``: the elementwise work with p = 1 (0 where masked) for
  its exp (wrong results: what the exp costs);
- ``no_math``: neither product nor exp (wrong results: the floor that
  the loads, the stores and the rest of the elementwise work set);
- ``no_elementwise``: the products without the elementwise work between
  them, p and ds being the raw products (wrong results: the floor that
  the products and the loads set).

Each variant's device time (mean of 20 back-to-back launches, CUDA
events) in bf16, d = 64, every kv_length T = 2048, BH = 4*12 (the
training step's shape), non-causal and causal, in turns with the
kernels as built from the source; and, for the variants that keep the
results, the largest error of dq, dk, dv against the plain versions
relative to the largest reference value, at BH = 48 with kv_length
random, 0 and T among them, causal and not.
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
    D, GRAD_RTOL, HEADS, LONG_T, LONG_TRAIN_BATCH, card_line, time_ms)
from incubator_mxnet_torch import _kernels  # noqa: E402
from incubator_mxnet_torch.ops import flash_attention as fa  # noqa: E402
from short_fwd_ablation import build_variants  # noqa: E402

GRAD_RTOL = GRAD_RTOL[torch.bfloat16]
BLOCKS = (512, 1024)
ENTRIES = {"flash_bwd_dq": 8, "flash_bwd_dkv": 9}     # pointers each takes

_SRC = os.path.join(_kernels._CSRC, "flash_bwd.cu")

_NO_EXP = [("  float y;\n  asm(",
            "  return x == -INFINITY ? 0.f : 1.f;\n  float y;\n  asm(")]

# dq's products at 64 keys a step (three consumers): s = q·kᵀ and dp =
# do·vᵀ as wgmma m64n64k16 with both operands in shared memory
_ABT64 = """// acc = a·bᵀ over d at 64 columns
__device__ __forceinline__ void bwd_abt(float (&acc)[32], uint64_t da,
                                        const unsigned char* b) {
  const uint64_t db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    asm volatile(
        "{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "REGS, %32, %33, p, 1, 1, 0, 0;\\n}\\n"
        : OUTS
        : "l"(da + 2 * kk), "l"(db + 2 * kk), "r"(kk));
}

""".replace("REGS", "{" + ", ".join(f"%{i}" for i in range(32)) + "}").replace(
    "OUTS", ", ".join(f'"+f"(acc[{i}])' for i in range(32)))

# name: (substitutions, keeps the results)
ABLATIONS = {
    "precise_exp": ([("  float y;\n  asm(", "  return expf(x);\n  float y;\n"
                      "  asm(")], True),
    "always_mask": ([("return len == 0 || c0 + BK > lim ||",
                      "return true || c0 + BK > lim ||"),
                     ("return len == 0 || kc0 + 64 > lim ||",
                      "return true || kc0 + 64 > lim ||")], True),
    "three_consumers": ([("constexpr int NC = 2;", "constexpr int NC = 3;"),
                         ("constexpr int BK = 128;", "constexpr int BK = 64;"),
                         ("// acc += a·b over 16·KS rows of b",
                          _ABT64 + "// acc += a·b over 16·KS rows of b"),
                         ("constexpr int CONSUMER_REGS = 240;",
                          "constexpr int CONSUMER_REGS = 160;")], True),
    "no_turns": ([("if (c == NC - 1) pair_arrive(SCHED);", ""),
                  ("if (c == 0) pair_sync(SCHED);", ""),
                  ("pair_sync(SCHED + c);", ";"),
                  ("pair_arrive(SCHED + (c + 1) % NC);", ";")], True),
    "no_exp": (_NO_EXP, False),
    "no_math": (_NO_EXP + [(f" {w}(acc,", f" if (0) {w}(acc,") for w in (
        "wgmma_m64n128k16_ss", "wgmma_m64n64k16_rs_abt",
        "wgmma_m64n64k16_rs")], False),
    "no_elementwise": ([("const float (&dl)[2], float scale) {",
                         "const float (&dl)[2], float scale) {\n  return;"),
                        ("int tq,\n                                         "
                         "float scale) {",
                         "int tq,\n                                         "
                         "float scale) {\n  return;")], False),
}


def _use(path):
    """Route the wrappers' `flash_bwd_dq` and `flash_bwd_dkv` entries to
    the library at `path` (None: the kernels as built from the source)."""
    for name in ENTRIES:
        _kernels._entries.pop(name, None)
    if path is None:
        return
    lib = ctypes.CDLL(path)
    for name, n_ptrs in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernels._entries[name] = fn


def _inputs(gen, random_lengths, causal):
    """The backward's arguments at the training shape: q, k, v, do, the
    plain forward's lse, delta, lengths and the rest."""
    bh = LONG_TRAIN_BATCH * HEADS
    q, k, v, do = (torch.randn(bh, LONG_T, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    if random_lengths:
        per_row = torch.randint(0, LONG_T + 1, (LONG_TRAIN_BATCH,),
                                generator=gen, device="cuda",
                                dtype=torch.int32)
        per_row[0], per_row[1] = 0, LONG_T
        lengths = per_row.repeat_interleave(HEADS)
    else:
        lengths = torch.full((bh,), LONG_T, dtype=torch.int32,
                             device="cuda")
    o, lse = fa.flash_fwd_reference(q, k, v, lengths, D ** -0.5, causal,
                                    *BLOCKS)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return (q, k, v, do, lse, delta, lengths, D ** -0.5, causal, *BLOCKS)


def _max_rel_err(args):
    """The largest error of dq, dk, dv against the plain versions, each
    relative to its largest reference value."""
    got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    ref = (fa.flash_bwd_dq_reference(*args),
           *fa.flash_bwd_dkv_reference(*args))
    errs = {}
    for name, x, y in zip(("dq", "dk", "dv"), got, ref):
        errs[name] = ((x.float() - y.float()).abs().max()
                      / y.float().abs().max()).item()
    if not max(errs.values()) <= GRAD_RTOL:
        raise AssertionError(f"disagrees with the plain versions: {errs}")
    return max(errs.values())


def measure(names=tuple(ABLATIONS), rounds=2, seed=0):
    """{variant: {"dq_ms": [...], "dq_causal_ms": [...], "dkv_ms": [...],
    "dkv_causal_ms": [...], "max_rel_err": ...}}, the kernels as built
    ("kernel") first in every round."""
    t0 = time.time()
    built = build_variants(_SRC, {n: ABLATIONS[n][0] for n in names})
    print(f"[flash_bwd_ablation] built {len(built)} variants in "
          f"{time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    checks = [_inputs(gen, True, c) for c in (False, True)]
    train = {c: _inputs(gen, False, c) for c in (False, True)}
    out = {}
    for _ in range(rounds):
        for name in ("kernel", *names):
            _use(built.get(name))
            rec = out.setdefault(name, {
                "dq_ms": [], "dq_causal_ms": [], "dkv_ms": [],
                "dkv_causal_ms": []})
            if "max_rel_err" not in rec and (name == "kernel"
                                             or ABLATIONS[name][1]):
                rec["max_rel_err"] = max(_max_rel_err(a) for a in checks)
            for causal in (False, True):
                args = train[causal]
                tag = "_causal_ms" if causal else "_ms"
                rec["dq" + tag].append(time_ms(lambda: fa.flash_bwd_dq(*args)))
                rec["dkv" + tag].append(time_ms(
                    lambda: fa.flash_bwd_dkv(*args)))
            print(f"[flash_bwd_ablation] {name}: "
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
        raise SystemExit("flash_bwd_ablation: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    recs = measure(tuple(args.only or ABLATIONS))

    def ms(xs):
        return " ".join(f"{m:.4f}" for m in xs)
    for name, r in recs.items():
        err = r.get("max_rel_err")
        print(f"[flash_bwd_ablation] {name}: BH={LONG_TRAIN_BATCH * HEADS} "
              f"T={LONG_T} dq {ms(r['dq_ms'])} ms, causal "
              f"{ms(r['dq_causal_ms'])} ms; dk/dv {ms(r['dkv_ms'])} ms, "
              f"causal {ms(r['dkv_causal_ms'])} ms; "
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
