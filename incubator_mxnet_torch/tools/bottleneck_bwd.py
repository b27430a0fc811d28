"""Fused backward of the ResNet bottleneck's 1x1 stage, y = BN_train(x @ W),
against torch autograd's backward of the same function.

Counterpart of `tools/pallas_bottleneck_bwd.py`.  The backward needs the
column sums s1 = Σ dy and s2 = Σ dy·zh before dz exists, so it runs in
two passes over the rows, each a hand-written CUDA kernel
(`csrc/bottleneck_bwd.cu`):

  pass 1 (reduce):  read dy, x         -> z = x·W recomputed in the kernel,
                                          zh = (z − m)·inv, s1, s2
  pass 2 (apply):   read dy, x         -> dz = (g·inv)·(dy − s1/n − zh·s2/n)
                                          in registers, rounded to bf16;
                                          dx = dz·Wᵀ, dW = Σ xᵀ·dz

so z is never read from memory and dz never written to it.  At the two
shapes the tool's path runs, ResNet-50 stage 1's 1x1 expand (C = 64 ->
K = 256) and its reverse (256 -> 64), each pass is a persistent kernel
that reads dy and x once and keeps W in shared memory (`bnb_reduce_tma`,
`bnb_apply_tma`); at any other shape they are `bnb_reduce` and
`bnb_apply`.  The shapes default to the expand
convolution as a product: M = 256·56·56 rows, C = 64 -> K = 256.  On the
card:

    python -m incubator_mxnet_torch.tools.bottleneck_bwd [--rows M]
        [--cin C] [--cout K] [--full-block] [--json OUT]

prints one JSON line: the kernels' time (CUDA events, mean of 8 calls)
beside torch autograd's backward of `bn_dot` (cuBLAS and elementwise
passes), the bound the bytes the kernels must move put on them, and the
kernels' mean relative error against autograd.  `--full-block` times
the 3-block NHWC bottleneck stack's forward + backward with its 1x1 + BN
stages either plain autograd or `Conv1x1BN`.

Each kernel wrapper launches its kernel for a CUDA tensor (bf16 only),
takes the plain PyTorch version of the same arithmetic only for a CPU
tensor, and counts its launches in `launch_counts`.  Unlike
`pallas_bwd`, which runs M // bm row tiles and leaves a ragged tail out
of s1, s2 and dx, every row is covered.  `Conv1x1BN` is not wired into
the port's ResNet: the JAX package's ResNet does not use it either.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import threading

import torch

from .._kernels import entry, route as _route, stream as _stream
from ..base import MXNetError

__all__ = ["bn_dot", "bottleneck_bwd", "bottleneck_bwd_reduce",
           "bottleneck_bwd_apply", "bottleneck_reduce_reference",
           "bottleneck_apply_reference", "Conv1x1BN", "full_block_compare",
           "measure", "launch_counts", "reset_launch_counts", "main"]

EPS = 1e-5
# the JAX tool's bound on the mean relative error against autograd (z is
# rounded to bf16 between the passes there; dz is rounded here)
REL_TOL = 3e-2

_count_lock = threading.Lock()
launch_counts = {"bottleneck_bwd_reduce": 0, "bottleneck_bwd_apply": 0}


def reset_launch_counts():
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _launched(name, err):
    if err != 0:
        raise MXNetError(f"{name}: kernel launch failed with cudaError {err}")
    with _count_lock:
        launch_counts[name] += 1


# ------------------------------------------------------------- forward
def bn_dot(x, w, gamma, beta):
    """y = BN_train(x @ w) with float32 statistics.  z is the float32
    product of the bf16 inputs (the JAX `preferred_element_type=f32`).
    Returns (y in x's dtype, (z in x's dtype, m, inv))."""
    z = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    m = z.mean(dim=0)
    v = torch.clamp_min((z * z).mean(dim=0) - m * m, 0.0)
    inv = torch.rsqrt(v + EPS)
    y = (z - m) * inv * gamma + beta
    return y.to(x.dtype), (z.to(x.dtype), m, inv)


# ------------------------------------------------------ plain versions
def _zh(x, w, m, inv):
    z = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return (z - m) * inv


def bottleneck_reduce_reference(dy, x, w, m, inv):
    """Pass 1 in plain PyTorch: (s1, s2), float32 (K,)."""
    dyf = dy.to(torch.float32)
    return dyf.sum(dim=0), (dyf * _zh(x, w, m, inv)).sum(dim=0)


def bottleneck_apply_reference(dy, x, w, m, inv, gamma, s1, s2):
    """Pass 2 in plain PyTorch: (dx in x's dtype, dW float32)."""
    n = float(dy.shape[0])
    zh = _zh(x, w, m, inv)
    dz = (gamma * inv) * (dy.to(torch.float32) - s1 / n - zh * s2 / n)
    dzb = dz.to(dy.dtype).to(torch.float32)
    dx = torch.matmul(dzb, w.to(torch.float32).t()).to(x.dtype)
    dw = torch.matmul(x.to(torch.float32).t(), dzb)
    return dx, dw


# ------------------------------------------------------- the wrappers
def _check(name, dy, x, w, vectors):
    M, K = dy.shape
    if x.ndim != 2 or x.shape[0] != M or w.shape != (x.shape[1], K):
        raise MXNetError(f"{name}: dy (M, K), x (M, C), w (C, K) expected, "
                         f"got {tuple(dy.shape)}, {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if any(t.device != dy.device for t in (x, w, *vectors)):
        raise MXNetError(f"{name}: all inputs must be on one device")
    for v in vectors:
        if v.shape != (K,) or v.dtype != torch.float32:
            raise MXNetError(f"{name}: m, inv, gamma, s1, s2 must be "
                             f"float32 ({K},), got {v.dtype} "
                             f"{tuple(v.shape)}")


def _device_args(name, dy, x, w, vectors):
    """Checks of the CUDA path; returns the tensors contiguous and 16-byte
    aligned, as the kernels read 16 bytes at a time."""
    if dy.device.type != "cuda":
        raise MXNetError(f"{name}: no kernel for device {dy.device}")
    if not all(t.dtype == torch.bfloat16 for t in (dy, x, w)):
        raise MXNetError(f"{name}: the kernel takes bfloat16 dy, x, w, got "
                         f"{dy.dtype}, {x.dtype}, {w.dtype}")
    C, K = w.shape
    if C % 16 or K % 16 or C == 0 or K == 0:
        raise MXNetError(f"{name}: C and K must be positive multiples of "
                         f"16, got C={C}, K={K}")
    out = []
    for t in (dy, x, w, *vectors):
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def _groups(which, M, C, K):
    fn = entry("bottleneck_bwd", "bottleneck_bwd_groups", [ctypes.c_int] * 4)
    g = fn(which, M, C, K)
    if g < 0:
        raise MXNetError(f"bottleneck_bwd: occupancy query failed with "
                         f"cudaError {-g}")
    return g


def _launch_reduce(dy, x, w, m, inv):
    name = "bottleneck_bwd_reduce"
    dy, x, w, m, inv = _device_args(name, dy, x, w, (m, inv))
    (M, K), C = dy.shape, x.shape[1]
    s1, s2 = (torch.empty(K, dtype=torch.float32, device=dy.device)
              for _ in range(2))
    if M == 0:
        return s1.zero_(), s2.zero_()
    groups = _groups(0, M, C, K)
    # (groups, 2K): each group's s1 then s2, summed by one launch
    part = torch.empty(2 * groups * K, dtype=torch.float32, device=dy.device)
    fn = entry("bottleneck_bwd", name, [ctypes.c_void_p] * 8
               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(dy.data_ptr(), x.data_ptr(), w.data_ptr(), m.data_ptr(),
             inv.data_ptr(), part.data_ptr(), s1.data_ptr(), s2.data_ptr(),
             M, C, K, groups, _stream(dy))
    _launched(name, err)
    return s1, s2


def _launch_apply(dy, x, w, m, inv, gamma, s1, s2):
    name = "bottleneck_bwd_apply"
    dy, x, w, m, inv, gamma, s1, s2 = _device_args(
        name, dy, x, w, (m, inv, gamma, s1, s2))
    (M, K), C = dy.shape, x.shape[1]
    dx = torch.empty((M, C), dtype=x.dtype, device=x.device)
    dw = torch.empty((C, K), dtype=torch.float32, device=x.device)
    if M == 0:
        return dx, dw.zero_()
    groups = _groups(1, M, C, K)
    part = torch.empty(groups * C * K, dtype=torch.float32, device=x.device)
    fn = entry("bottleneck_bwd", name, [ctypes.c_void_p] * 11
               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(dy.data_ptr(), x.data_ptr(), w.data_ptr(), m.data_ptr(),
             inv.data_ptr(), gamma.data_ptr(), s1.data_ptr(), s2.data_ptr(),
             part.data_ptr(), dx.data_ptr(), dw.data_ptr(), M, C, K, groups,
             _stream(dy))
    _launched(name, err)
    return dx, dw


def bottleneck_bwd_reduce(dy, x, w, m, inv):
    """Pass 1 (`_reduce_kernel`): s1 = Σ dy, s2 = Σ dy·zh over the rows,
    float32 (K,), from dy (M, K), x (M, C), w (C, K) and the forward's
    m, inv (K,) float32: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    name = "bottleneck_bwd_reduce"
    _check(name, dy, x, w, (m, inv))
    return _route(name, dy, lambda: _launch_reduce(dy, x, w, m, inv),
                  lambda: bottleneck_reduce_reference(dy, x, w, m, inv))


def bottleneck_bwd_apply(dy, x, w, m, inv, gamma, s1, s2):
    """Pass 2 (`_apply_kernel`): dx (M, C) in x's dtype and dW (C, K)
    float32, with dz rounded to dy's dtype between them: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    name = "bottleneck_bwd_apply"
    _check(name, dy, x, w, (m, inv, gamma, s1, s2))
    return _route(
        name, dy, lambda: _launch_apply(dy, x, w, m, inv, gamma, s1, s2),
        lambda: bottleneck_apply_reference(dy, x, w, m, inv, gamma, s1, s2))


def bottleneck_bwd(dy, x, w, m, inv, gamma):
    """The backward of `bn_dot` from its saved (m, inv): dx, dW (float32),
    dgamma = s2, dbeta = s1 (`pallas_bwd`)."""
    s1, s2 = bottleneck_bwd_reduce(dy, x, w, m, inv)
    dx, dw = bottleneck_bwd_apply(dy, x, w, m, inv, gamma, s1, s2)
    return dx, dw, s2, s1


class Conv1x1BN(torch.autograd.Function):
    """`conv1x1_bn`: a 1x1 convolution as x (M, C) @ w (C, K) followed by
    train-mode BN, forward `bn_dot`, backward `bottleneck_bwd`.  The
    forward saves (m, inv, x, w, gamma) and not z: the backward
    recomputes z in its kernels."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta):
        y, (_z, m, inv) = bn_dot(x, w, gamma, beta)
        ctx.save_for_backward(m, inv, x, w, gamma)
        return y

    @staticmethod
    def backward(ctx, dy):
        m, inv, x, w, gamma = ctx.saved_tensors
        dx, dw, dg, db = bottleneck_bwd(dy.contiguous(), x, w, m, inv, gamma)
        return dx, dw.to(w.dtype), dg, db


# ------------------------------------------------------------- timing
def _time_ms(fn, iters=8):
    """Mean time of fn() over `iters` calls between CUDA events, after
    one call that warms it up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel(ref, got):
    ref, got = ref.to(torch.float32), got.to(torch.float32)
    return float((ref - got).abs().mean() / (ref.abs().mean() + 1e-9))


# ------------------------------------------------- full-block experiment
def _bn_nhwc(h, g, b):
    mm = h.mean(dim=(0, 1, 2), dtype=torch.float32)
    ms = (h * h).mean(dim=(0, 1, 2), dtype=torch.float32)
    inv = torch.rsqrt(torch.clamp_min(ms - mm * mm, 0.0) + EPS)
    return h * (inv * g).to(h.dtype) + (b - mm * inv * g).to(h.dtype)


def _conv3x3_nhwc(h, w):
    """'SAME' 3x3 convolution of NHWC h with HWIO w, through NCHW views
    of the same memory (channels-last)."""
    out = torch.nn.functional.conv2d(h.permute(0, 3, 1, 2),
                                     w.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def _block(x, p, fused):
    w1, w2, w3, g1, b1, g2, b2, g3, b3 = p
    n, hh, ww, c4 = x.shape
    c, rows = c4 // 4, n * hh * ww
    if fused:
        h = Conv1x1BN.apply(x.reshape(rows, c4), w1, g1, b1) \
            .reshape(n, hh, ww, c)
    else:
        z = torch.matmul(x.to(torch.float32), w1.to(torch.float32)) \
            .to(x.dtype)
        h = _bn_nhwc(z, g1, b1)
    h = torch.relu(h)
    h = torch.relu(_bn_nhwc(_conv3x3_nhwc(h, w2), g2, b2))
    if fused:
        return Conv1x1BN.apply(h.reshape(rows, c), w3, g3, b3).reshape(
            x.shape)
    z = torch.matmul(h.to(torch.float32), w3.to(torch.float32)).to(x.dtype)
    return _bn_nhwc(z, g3, b3)


def full_block_compare(batch=256, size=56, channels=64, device="cuda"):
    """The 3-block NHWC bottleneck stack (the JAX tool's roofline probe),
    its 1x1 + BN stages plain autograd or `Conv1x1BN`: forward + backward
    ms of each and the largest mean relative difference of their
    gradients."""
    gen = torch.Generator(device=device).manual_seed(0)
    c = channels

    def f(*s):
        return (torch.randn(s, generator=gen, device=device) * 0.05).to(
            torch.bfloat16)

    def const(v, n):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    x = torch.randn(batch, size, size, 4 * c, generator=gen,
                    device=device).to(torch.bfloat16)
    params = [[f(4 * c, c), f(3, 3, c, c), f(c, 4 * c), const(1, c),
               const(0, c), const(1, c), const(0, c), const(1, 4 * c),
               const(0, 4 * c)] for _ in range(3)]
    leaves = [t.requires_grad_() for p in params for t in p]

    def grads(fused):
        h = x
        for p in params:
            h = torch.relu(h + _block(h, p, fused))
        return torch.autograd.grad(h.to(torch.float32).square().sum(),
                                   leaves)

    out, got = {}, {}
    for fused in (False, True):
        key = "fused" if fused else "plain"
        if device == "cuda":
            out[key] = _time_ms(lambda: grads(fused), iters=4)
        got[key] = grads(fused)
    out["max_rel_err"] = max(_rel(a, b) for a, b in zip(got["plain"],
                                                       got["fused"]))
    if "fused" in out:
        out["speedup"] = out["plain"] / out["fused"]
    return out


# ------------------------------------------------- the isolated stage
def _bytes_bound_ms(M, C, K, peak_bytes_per_s=3.35e12):
    """Least time of the two passes at the card's memory rate: pass 1
    reads dy and x once, pass 2 reads them and writes dx (W, the (K,)
    vectors and dW are small beside them)."""
    reduce_bytes = 2 * M * K + 2 * M * C
    apply_bytes = 2 * M * K + 2 * M * C + 2 * M * C
    return (reduce_bytes + apply_bytes) / peak_bytes_per_s * 1e3


def measure(rows, cin, cout, seed=0):
    """The isolated stage at (rows, cin, cout) on the card: the kernels'
    and torch autograd's backward times and the kernels' errors against
    autograd.  Returns the tool's JSON record."""
    M, C, K = rows, cin, cout
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(C, K, generator=gen, device="cuda") * 0.05).to(
        torch.bfloat16)
    gamma = torch.ones(K, device="cuda")
    beta = torch.zeros(K, device="cuda")
    dy = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)

    leaves = [t.detach().requires_grad_() for t in (x, w, gamma, beta)]
    y = bn_dot(*leaves)[0]

    def vjp():
        return torch.autograd.grad(y, leaves, dy, retain_graph=True)
    vjp_ms = _time_ms(vjp)
    ref = vjp()
    with torch.no_grad():
        _, (_z, m, inv) = bn_dot(x, w, gamma, beta)
    kernel_ms = _time_ms(lambda: bottleneck_bwd(dy, x, w, m, inv, gamma))
    got = bottleneck_bwd(dy, x, w, m, inv, gamma)
    errs = {name: _rel(a, b) for name, a, b in
            zip(("dx", "dw", "dgamma", "dbeta"), ref, got)}
    bound = _bytes_bound_ms(M, C, K)
    return {"metric": "bottleneck_bwd",
            "device": torch.cuda.get_device_name(0),
            "shape": {"M": M, "C": C, "K": K},
            "torch_vjp_ms": vjp_ms, "kernel_ms": kernel_ms,
            "speedup": vjp_ms / kernel_ms,
            "bytes_bound_ms": bound, "kernel_vs_bound": kernel_ms / bound,
            "vjp_vs_bound": vjp_ms / bound, "rel_err": errs}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m incubator_mxnet_torch.tools.bottleneck_bwd")
    ap.add_argument("--rows", type=int, default=256 * 56 * 56)
    ap.add_argument("--cin", type=int, default=64)
    ap.add_argument("--cout", type=int, default=256)
    ap.add_argument("--bm", type=int, default=None,
                    help="the JAX tool's row tile; the kernels tile on "
                         "their own and cover every row, so it is ignored")
    ap.add_argument("--full-block", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bottleneck_bwd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.full_block:
        out = {"metric": "bottleneck_full_block",
               "device": torch.cuda.get_device_name(0),
               **full_block_compare()}
    else:
        out = measure(args.rows, args.cin, args.cout)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    bad = [k for k, v in out.get("rel_err", {}).items() if not v <= REL_TOL]
    if bad:
        raise SystemExit(f"numerics mismatch: {bad}")
    return out


if __name__ == "__main__":
    main()
