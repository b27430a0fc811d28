"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C entry point.  It is
compiled at first use with `nvcc` for Hopper (`sm_90a`) into
`build/kernels/` at the repository root, a directory git ignores, and
loaded with ctypes.  The library's file name carries a hash of its
source and of the shared headers `csrc/*.cuh`, so an edited kernel is
rebuilt and a stale one is never loaded.
Nothing is built when a module is imported: a CPU-only machine without
`nvcc` imports every module and never calls this.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading

from . import _build
from .base import MXNetError, traced

__all__ = ["SOURCES", "library", "library_path", "build_all", "entry",
           "route", "stream", "add_flops", "counting_flops"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("flash_short_fwd", "flash_short_bthd_bwd", "flash_fwd",
           "flash_bwd", "bottleneck_bwd", "int8_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
_entries = {}


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found: the port's CUDA kernels are built "
                     "at first use on a machine with the CUDA toolkit")


def _target(name):
    src = os.path.join(_CSRC, f"{name}.cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES, timeout=600):
    """Compile every kernel library at once, one `nvcc` per source, all
    started together (`_build`).  Returns {name: compiler output} for the
    sources it built (ptxas register and shared-memory reports)."""
    with _lock:
        jobs = []
        for n in names:
            src, so = _target(n)
            jobs.append(_build.start(
                so, lambda tmp, src=src: [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                          src], n))
        return _build.finish(jobs, timeout)


def library_path(name):
    """The path of kernel `name`'s library, built if needed."""
    build_all((name,))
    return _target(name)[1]


def library(name):
    """The loaded ctypes library of kernel `name`, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(path)
    return lib


def entry(name, fn_name, argtypes, restype=ctypes.c_int):
    """The C function `fn_name` of kernel library `name`, built and
    loaded at first use, with its ctypes signature set."""
    fn = _entries.get(fn_name)
    if fn is None:
        fn = getattr(library(name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _entries[fn_name] = fn
    return fn


def route(name, t, launch, plain, traceable=False):
    """launch() for a CUDA tensor or device `t`, plain() for a CPU one
    or a meta one (symbolic shape inference: the plain version only
    computes shapes there); any other device raises.  The wrappers' one dispatch rule: a CUDA
    tensor never reaches a plain version.  A traced CUDA tensor
    (`torch.export`, `make_fx`) raises unless `traceable`: only a launch
    behind a registered custom op can be recorded in a graph."""
    device = getattr(t, "device", t)
    if device.type == "cuda":
        if not traceable and traced(t):
            raise MXNetError(
                f"{name}: its kernel is not a registered custom op, so a "
                f"torch.export graph cannot hold it")
        return launch()
    if device.type in ("cpu", "meta"):
        return plain()
    raise MXNetError(f"{name}: no kernel for device {device}")


# FLOPs of the ctypes launches while a count runs (`goodput.count_flops`):
# torch's FlopCounterMode sees only dispatched ops, so each wrapper of a
# kernel that is not a registered op adds its own formula here when it
# launches.  One count at a time a process; None when none runs.
_flop_acc = None


def add_flops(n):
    """Add a launch's FLOPs to the running count, if one runs."""
    acc = _flop_acc
    if acc is not None:
        acc[0] += int(n)


class counting_flops:
    """`with counting_flops() as acc:` sums `add_flops` into acc[0]."""

    def __enter__(self):
        global _flop_acc
        self._prev, _flop_acc = _flop_acc, [0]
        return _flop_acc

    def __exit__(self, *exc):
        global _flop_acc
        _flop_acc = self._prev
        return False


def stream(t):
    """The current CUDA stream of `t`'s device, as the int the C entry
    points take."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
