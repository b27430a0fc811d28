"""Ablations of the int8 products' persistent wgmma kernels (row 9a,
`igemm_wgmma` and `igemm_conv_wgmma` of
`incubator_mxnet_torch/csrc/int8_gemm.cu`), on the card: each builds a
copy of the source with one design step undone, or one part of the work
removed, and times it beside the kernels as they are, at BERT-base's
four Dense shapes (M = 128 x 128) and ResNet-50 v1b's stage-1 1x1 and
3x3 convolutions at batch 32 (`chip_smoke.py`'s `[int8-kernels]`
shapes), with the fused bfloat16 epilogue of the main path.

    python3 experiments/int8_igemm_ablation.py [--json OUT] [--only ...]

A measurement script, not part of the package: each ablation is a set
of exact text substitutions on the kernel's source as it stood when the
ablation was written, and raises when the source no longer holds that
text (`short_fwd_ablation.build_variants`).  `chip_smoke.py` does not
run it.  Ablations, one for each design step:

- ``one_tile_a_block``: a grid of one block a tile instead of one
  persistent block an SM (the persistent grid);
- ``two_stages``: a ring of 2 stages instead of 4 to 8 (the ring that
  the producer warp keeps full through its empty barriers; the
  convolution's 4);
- ``serial_products``: a consumer waits for each K step's products
  before it issues the next step's (one group in flight);
- ``k128_steps``: 128-byte K steps at K = 64 (half of every box zeros);
- ``direct_store``: every output by direct stores from the staged tile
  instead of TMA stores (the TMA-store epilogue);
- ``conv_n128``: the convolution's 128-wide tile at O = 64;
- ``conv_deep_ring``: the convolution's ring of 8 stages instead of 4,
  with the shared memory that takes from L1;
- ``conv_cg``: the convolution's A rows by cp.async.cg (L2 only)
  instead of .ca (the convolution's A path);
- ``conv_mma_sync``: the one-group NHWC convolution on the parent's
  `igemm_kernel<2>` (mma.sync, A's addresses computed again every
  stage) instead of `igemm_conv_wgmma`;
- ``no_store``: the epilogue computed and staged but not stored (wrong
  results: what the output's write costs);
- ``no_mma``: the loads and the epilogue without the products (wrong
  results);
- ``no_values``: the accumulators staged and stored as they are,
  without the epilogue's arithmetic (wrong results);
- ``no_epilogue``: nothing staged or stored (wrong results: the loads
  and the products alone);
- ``loads_only``: neither products nor epilogue (wrong results: the
  producer's ring alone).

The 256-wide cooperative tile (both consumers on one 128 x 256 tile,
wgmma m64n256k32) that this kernel replaced is not a substitution of
this source; PERF.md gives its times from the same script.

Each variant's device time (`chip_smoke.time_ms`: CUDA events over 20
back-to-back launches) at each shape, in turns with the kernels as
built from the source, and for the variants that keep the results,
whether every output equals its plain version bit for bit.
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
    INT8_CONV_BATCH, INT8_CONVS, INT8_DENSE, INT8_M, _int8_bound, card_line,
    time_ms)
from incubator_mxnet_torch import _kernels  # noqa: E402
from incubator_mxnet_torch.ops import quantized as qops  # noqa: E402
from short_fwd_ablation import build_variants  # noqa: E402

_SRC = os.path.join(_kernels._CSRC, "int8_gemm.cu")
_ENTRIES = ("int8_igemm_dense", "int8_igemm_pointwise", "int8_igemm_conv")
CONV_SHAPES = ("stage-1 1x1", "stage-1 3x3")

_NO_MMA = [("        wgmma_s8<BN>(acc[0], da0 + 2 * kk, db + 2 * kk);\n"
            "        wgmma_s8<BN>(acc[1], da1 + 2 * kk, db + 2 * kk);",
            "        ;")]
_NO_VALUES = [("ws_values<BN>(acc[hf], e, fac, ctid & 3);", ";")]
_NO_EPILOGUE = [("    ws_epilogue<BN>(acc, stg,",
                 "    if (0) ws_epilogue<BN>(acc, stg,")]

# name: (substitutions, keeps the results)
ABLATIONS = {
    "one_tile_a_block": ([("<<<persistent_grid(tiles), ws::THREADS,",
                           "<<<tiles, ws::THREADS,")], True),
    "two_stages": ([("constexpr int MAX_STAGES = 8;",
                     "constexpr int MAX_STAGES = 2;"),
                    ("constexpr int CONV_STAGES = 4;",
                     "constexpr int CONV_STAGES = 2;")], True),
    "serial_products": ([("      wgmma_wait<1>();                  // step kt",
                          "      wgmma_wait<0>();                  // step kt")],
                        True),
    "k128_steps": ([("  return K % 128 == 0\n", "  return true\n")], True),
    "direct_store": ([("  g.tma_store = row * es % 16 == 0 &&",
                       "  g.tma_store = false &&")], True),
    "conv_n128": ([("  if (N <= 64) return launch_conv_wgmma<64>(",
                    "  if (false) return launch_conv_wgmma<64>(")], True),
    "conv_deep_ring": ([("constexpr int CONV_STAGES = 4;",
                         "constexpr int CONV_STAGES = 8;")], True),
    "conv_cg": ([("        cp_async16_ca(st + kmajor_at<BK>(r, j),",
                  "        cp_async16(st + kmajor_at<BK>(r, j),")], True),
    "conv_mma_sync": ([("      return launch_conv(x, w, out, M, N, K, cv, e, st);",
                        "      return launch_igemm<2>(x, w, out, M, N, K, "
                        "groups, cv, e, 1, st);")], True),
    "no_store": ([("                tma_store(omap, box, n, m0 + 64 * hf, 0);",
                   "                ;"),
                  ("              tma_store(omap, box, pos0 + 64 * hf + pass * per,",
                   "              if (0) tma_store(omap, box, "
                   "pos0 + 64 * hf + pass * per,")], False),
    "no_mma": (_NO_MMA, False),
    "no_values": (_NO_VALUES, False),
    "no_epilogue": (_NO_VALUES + _NO_EPILOGUE, False),
    "loads_only": (_NO_MMA + _NO_VALUES + _NO_EPILOGUE, False),
}


def _use(path):
    """Route the wrappers' int8 product entries to the library at `path`
    (None: the kernels as built from the source)."""
    dense = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    point = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    conv = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    for name in _ENTRIES:
        _kernels._entries.pop(name, None)
    if path is None:
        return
    lib = ctypes.CDLL(path)
    for name, args in (("int8_igemm_dense", dense),
                       ("int8_igemm_pointwise", point),
                       ("int8_igemm_conv", conv)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
        _kernels._entries[name] = fn


def _cases(gen):
    """{shape name: (run, plain, bound ms)}: the product with the fused
    bfloat16 epilogue on int8 inputs quantized once by the kernel."""
    cases = {}
    ws = {}

    def fused(n):
        if n not in ws:
            ws[n] = dict(
                x_scale=torch.tensor(0.0123, device="cuda"),
                w_scale=torch.rand(n, generator=gen, device="cuda") * 0.01,
                bias=torch.randn(n, generator=gen, device="cuda"),
                out_dtype=torch.bfloat16)
        return ws[n]
    for name, K, N in INT8_DENSE:
        q = torch.randint(-127, 128, (INT8_M, K), generator=gen,
                          device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        kw = fused(N)
        bound = _int8_bound(q.numel() + w.numel() + INT8_M * N * 2 + N * 8,
                            2 * INT8_M * N * K)[0]
        cases[name] = (lambda q=q, w=w, kw=kw: qops.int8_dense(q, w, **kw),
                       lambda q=q, w=w, kw=kw: qops.igemm_plain(
                           q, w, None, **kw), bound)
    for name, C, H, O, k, s, p, g in INT8_CONVS:
        if name not in CONV_SHAPES:
            continue
        x = torch.randn(INT8_CONV_BATCH, C, H, H, generator=gen,
                        device="cuda").to(torch.bfloat16)
        q, _, _ = qops.int8_quantize(x, None, channels_last=True)
        w = torch.randint(-127, 128, (O, C // g, k, k), generator=gen,
                          device="cuda", dtype=torch.int8)
        conv = ((s, s), (p, p), (1, 1), g)
        kw = fused(O)
        OH = (H + 2 * p - k) // s + 1
        out = INT8_CONV_BATCH * O * OH * OH
        bound = _int8_bound(q.numel() + w.numel() + out * 2 + O * 8,
                            2 * out * w[0].numel())[0]
        cases[name] = (
            lambda q=q, w=w, conv=conv, kw=kw: qops.int8_conv(q, w, *conv,
                                                              **kw),
            lambda q=q, w=w, conv=conv, kw=kw: qops.igemm_plain(
                q.contiguous(), w, conv, **kw), bound)
    return cases


def measure(names=tuple(ABLATIONS), rounds=2, seed=0):
    """{variant: {shape: {"ms": [...], "bound_ms": b}, "equal": bool}},
    the kernels as built ("kernel") first in every round."""
    t0 = time.time()
    built = build_variants(_SRC, {n: ABLATIONS[n][0] for n in names})
    print(f"[int8_igemm_ablation] built {len(built)} variants in "
          f"{time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = _cases(gen)
    refs = {n: plain() for n, (_, plain, _) in cases.items()}
    out = {}
    for _ in range(rounds):
        for name in ("kernel", *names):
            _use(built.get(name))
            rec = out.setdefault(name, {})
            if "equal" not in rec and (name == "kernel"
                                       or ABLATIONS[name][1]):
                got = {n: run() for n, (run, _, _) in cases.items()}
                torch.cuda.synchronize()
                rec["equal"] = all(torch.equal(got[n], refs[n])
                                   for n in cases)
                if not rec["equal"]:
                    raise AssertionError(f"{name} differs from the plain "
                                         f"versions")
            for shape, (run, _, bound) in cases.items():
                r = rec.setdefault(shape, {"ms": [], "bound_ms": bound})
                r["ms"].append(time_ms(run))
            print(f"[int8_igemm_ablation] {name}: " + ", ".join(
                f"{s} {rec[s]['ms'][-1]:.4f}" for s in cases), flush=True)
    _use(None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the records to this file")
    ap.add_argument("--only", nargs="*", choices=sorted(ABLATIONS),
                    help="these ablations only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_igemm_ablation: needs a CUDA card")
    card = card_line()
    recs = measure(tuple(args.only or ABLATIONS))
    for name, r in recs.items():
        parts = []
        for shape, v in r.items():
            if shape == "equal":
                continue
            best = min(v["ms"])
            parts.append(f"{shape} {' '.join(f'{m:.4f}' for m in v['ms'])}"
                         f" ms ({100 * v['bound_ms'] / best:.1f}% of bound)")
        print(f"[int8_igemm_ablation] {name}: " + "; ".join(parts) +
              ("; equal to the plain versions" if r.get("equal")
               else "; results changed by design") + f" ({card})",
              flush=True)
    line = {"card": card, "records": recs}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
