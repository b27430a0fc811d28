"""Runtime-compiled CUDA kernels: MXNet's `mx.rtc` on the H100.

Counterpart of `incubator_mxnet_tpu/rtc.py` (`PallasModule`,
`PallasKernel`), whose one `pl.pallas_call` (`PallasKernel._build`)
wraps whatever kernel body the user wrote.  The JAX package takes
Python bodies over `pl.Ref`s; no such body runs on a GPU, so the port
takes what MXNet's own `mx.rtc` takes, which the JAX module's docstring
names as its reference: CUDA C++ source.

    mod = CudaModule(source, options=(), exports=("axpy<float>",))
    k = mod.get_kernel("axpy<float>", "const float *x, float *y, float a, "
                       "int64_t n", cpu_fn=axpy_plain)
    k.launch([x, y, 2.0, n], mx.gpu(0), (blocks, 1, 1), (256, 1, 1))

- **Signatures** are MXNet's strings of C parameters.  The types are
  MXNet's (`float`, `double`, `__half`, `int`, `int32_t`, `int64_t`,
  `int8_t`, `uint8_t`, `char`) and `__nv_bfloat16` for bfloat16.  A
  pointer takes an NDArray or a torch tensor of that dtype, contiguous
  and on the launch's context, which the kernel reads or writes in
  place; a scalar takes a Python or numpy number, packed in exactly its
  C type.  Anything else raises `MXNetError` before any launch.
- **Compile.**  At the first launch the module's source, behind a
  prelude of the fp16/bf16 headers, and a generated `extern "C"`
  launcher for every `__global__` it defines and every name in
  `exports` (C++ and template names, resolved by the compiler) are
  compiled once with `nvcc` for `sm_90a` into a shared library, loaded
  with ctypes.  The launcher calls `cudaLaunchKernel` on the caller's
  stream, after raising the kernel's dynamic shared-memory limit when a
  launch asks for more than 48 KB.
- **Cache.**  The library's name is the sha256 of the source, options,
  exports and nvcc flags, under `build/kernels/rtc/` (git ignores
  `build/`), written to a temporary file and renamed: one source
  compiles once per machine and loads once per process, as
  `PallasKernel._cache` compiles once per signature.
- **Devices.**  A CUDA context launches the kernel or raises (a compile
  error with nvcc's log, a launch error with `cudaGetErrorString`); a
  CPU context runs the `cpu_fn` given to `get_kernel`, the kernel's
  plain PyTorch version, and raises without one.  `launch_counts`
  counts each kernel's launches on the card, by its name.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import json
import numbers
import os
import re
import subprocess
import threading

import numpy as _np
import torch

from . import _kernels
from .base import MXNetError
from .context import as_device

__all__ = ["CudaModule", "CudaKernel", "KernelNotFoundError",
           "parse_signature", "launch_counts", "reset_launch_counts",
           "nvcc_runs"]

BUILD_DIR = os.path.join(_kernels.BUILD_DIR, "rtc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# what a signature's types need; `#line 1` keeps nvcc's line numbers
# those of the user's source
PRELUDE = ("#include <cstdint>\n#include <cuda_fp16.h>\n"
           "#include <cuda_bf16.h>\n#line 1\n")
MAX_SHARED_MEM = 232448          # the most dynamic shared memory a block has
_GRID_MAX = (2 ** 31 - 1, 65535, 65535)
_BLOCK_MAX = (1024, 1024, 64)
_THREADS_MAX = 1024

# C type: (tensor dtype of a pointer, ctypes type of a scalar)
C_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "__nv_bfloat16": (torch.bfloat16, ctypes.c_uint16),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
    "int8_t": (torch.int8, ctypes.c_int8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "char": (torch.int8, ctypes.c_int8),
}
_INT_RANGE = {ctypes.c_int8: (-2 ** 7, 2 ** 7 - 1),
              ctypes.c_uint8: (0, 2 ** 8 - 1),
              ctypes.c_int32: (-2 ** 31, 2 ** 31 - 1),
              ctypes.c_int64: (-2 ** 63, 2 ** 63 - 1)}
_PARAM = re.compile(r"^\s*(const\s+)?([A-Za-z_]\w*)\s*(\*)?\s*"
                    r"(?:__restrict__\s*)?([A-Za-z_]\w*)?\s*$")

Param = collections.namedtuple("Param", "ctype pointer const name")

_count_lock = threading.Lock()
launch_counts = collections.Counter()
# nvcc invocations by this process, a module's sha256 key each
nvcc_runs = collections.Counter()
_libs = {}
_build_lock = threading.Lock()


def reset_launch_counts():
    with _count_lock:
        launch_counts.clear()


class KernelNotFoundError(MXNetError, KeyError):
    """`get_kernel` of a name the module neither defines as a
    `__global__` nor exports (a `KeyError`, as the JAX package's
    `PallasModule.get_kernel` raises)."""

    def __str__(self):
        return str(self.args[0])


def parse_signature(signature):
    """MXNet's signature string as a tuple of `Param`s, e.g.
    "const float *x, float *y, int n"; parameter names are optional."""
    if not signature.strip():
        return ()
    params = []
    for text in signature.split(","):
        m = _PARAM.match(text)
        if m is None:
            raise MXNetError(f"invalid kernel signature {signature!r}: "
                             f"cannot parse {text.strip()!r}")
        const, ctype, star, name = m.groups()
        if ctype not in C_TYPES:
            raise MXNetError(f"invalid kernel signature {signature!r}: type "
                             f"{ctype!r} is not one of {sorted(C_TYPES)}")
        params.append(Param(ctype, star is not None, const is not None,
                            name))
    return tuple(params)


def _global_kernels(source):
    """The names of the non-template `__global__` functions `source`
    declares, in order (a template needs its arguments, in `exports`)."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", " ", source, flags=re.S)
    text = re.sub(r"__launch_bounds__\s*\([^)]*\)", " ", text)
    names = []
    for m in re.finditer(r"__global__\s+[^(;{}]*?\b([A-Za-z_]\w*)\s*\(",
                         text):
        start = max(text.rfind(";", 0, m.start()),
                    text.rfind("}", 0, m.start())) + 1
        if not re.search(r"\btemplate\b", text[start:m.start()]):
            names.append(m.group(1))
    return list(dict.fromkeys(names))


def _launchers(names):
    """One `extern "C"` launcher per kernel name, by position."""
    out = ["", "// launchers generated by incubator_mxnet_torch.rtc"]
    for i, name in enumerate(names):
        out.append(f"""extern "C" int mxrtc_launch_{i}(
    void **args, unsigned gx, unsigned gy, unsigned gz, unsigned bx,
    unsigned by, unsigned bz, unsigned shared_mem, void *stream) {{
  const void *fn = (const void *)&{name};
  if (shared_mem > 48 * 1024) {{
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared_mem);
    if (e != cudaSuccess) return (int)e;
  }}
  return (int)cudaLaunchKernel(fn, dim3(gx, gy, gz), dim3(bx, by, bz),
                               args, shared_mem, (cudaStream_t)stream);
}}""")
    out.append('extern "C" const char *mxrtc_error_string(int e) {\n'
               '  return cudaGetErrorString((cudaError_t)e);\n}\n')
    return "\n".join(out)


def _run_nvcc(args):
    """Run nvcc with `args`: (exit code, its output)."""
    proc = subprocess.run([_kernels._nvcc(), *args], capture_output=True,
                          text=True, timeout=600)
    return proc.returncode, proc.stdout + proc.stderr


def _write(path, data):
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)


class CudaModule:
    """CUDA C++ source compiled at first launch (MXNet's
    `mx.rtc.CudaModule`).  `options` are extra nvcc flags; `exports`
    names the C++ or template kernels (e.g. "axpy<float>") that
    `get_kernel` may ask for beside the source's plain `__global__`
    functions."""

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self.kernel_names = tuple(dict.fromkeys(
            _global_kernels(source) + list(self.exports)))
        self.text = PRELUDE + source + _launchers(self.kernel_names)
        self.key = hashlib.sha256(json.dumps(
            [self.text, self.options, self.exports, NVCC_FLAGS])
            .encode()).hexdigest()

    def get_kernel(self, name, signature, cpu_fn=None):
        """The `CudaKernel` `name` with its parameters from `signature`;
        `cpu_fn(*args)`, the kernel's plain PyTorch version, runs it on
        CPU tensors.  Nothing is compiled here."""
        if name not in self.kernel_names:
            raise KernelNotFoundError(
                f"no kernel {name!r} in this CudaModule: it defines "
                f"{list(self.kernel_names)} (a template or C++ name must be "
                f"in exports)")
        return CudaKernel(self, name, parse_signature(signature), cpu_fn)

    @property
    def path(self):
        return os.path.join(BUILD_DIR, f"librtc-{self.key[:24]}.so")

    def build(self):
        """The shared library's path, compiled by nvcc unless this
        machine already has it."""
        so = self.path
        if os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        cu = so[:-3] + ".cu"
        _write(cu, self.text)
        tmp = f"{so}.tmp{os.getpid()}"
        rc, log = _run_nvcc([*NVCC_FLAGS, *self.options, "-o", tmp, cu])
        nvcc_runs[self.key] += 1
        if rc != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise MXNetError(f"nvcc failed for CudaModule {self.key[:12]} "
                             f"(exit {rc}):\n{log}")
        os.replace(tmp, so)
        return so

    def library(self):
        """The loaded ctypes library, built and loaded once a process."""
        lib = _libs.get(self.key)
        if lib is None:
            with _build_lock:
                lib = _libs.get(self.key)
                if lib is None:
                    lib = ctypes.CDLL(self.build())
                    lib.mxrtc_error_string.argtypes = [ctypes.c_int]
                    lib.mxrtc_error_string.restype = ctypes.c_char_p
                    _libs[self.key] = lib
        return lib


def _dims(dims, what, limits):
    dims = tuple(dims) if isinstance(dims, (tuple, list)) else (dims,)
    if not 1 <= len(dims) <= 3 or not all(
            isinstance(d, numbers.Integral) and not isinstance(d, bool)
            for d in dims):
        raise MXNetError(f"{what} dims must be 1 to 3 integers, got {dims}")
    dims = tuple(int(d) for d in dims) + (1,) * (3 - len(dims))
    if any(not 1 <= d <= m for d, m in zip(dims, limits)):
        raise MXNetError(f"{what} dims {dims} outside [1, {limits}]")
    return dims


class CudaKernel:
    """One kernel of a `CudaModule` with its signature (MXNet's
    `CudaModule.Kernel`)."""

    def __init__(self, module, name, params, cpu_fn=None):
        self.module = module
        self.name = name
        self.params = params
        self.cpu_fn = cpu_fn
        self._index = module.kernel_names.index(name)
        self._fn = None

    def _values(self, args, device):
        """The arguments (tensors and numbers) checked against the
        signature: the tensors for the pointers, ctypes scalars for the
        scalars."""
        if len(args) != len(self.params):
            raise MXNetError(f"{self.name}: {len(args)} arguments for "
                             f"{len(self.params)} parameters")
        out = []
        for i, (a, p) in enumerate(zip(args, self.params)):
            dtype, ctype = C_TYPES[p.ctype]
            what = f"{self.name}: argument {i} ({p.name or p.ctype})"
            if p.pointer:
                if not isinstance(a, torch.Tensor):
                    raise MXNetError(f"{what} is a {p.ctype} pointer: pass "
                                     f"an NDArray, got {type(a).__name__}")
                if a.dtype != dtype:
                    raise MXNetError(f"{what} needs {dtype}, got {a.dtype}")
                if a.device != device:
                    raise MXNetError(f"{what} is on {a.device}, the launch "
                                     f"on {device}")
                if not a.is_contiguous():
                    raise MXNetError(f"{what} is not contiguous")
                out.append(a)
            else:
                out.append(self._scalar(a, p.ctype, ctype, dtype, what))
        return out

    @staticmethod
    def _scalar(a, cname, ctype, dtype, what):
        if isinstance(a, torch.Tensor) or not isinstance(
                a, (numbers.Real, _np.number, _np.bool_)):
            raise MXNetError(f"{what} is a {cname} scalar: pass a number, "
                             f"got {type(a).__name__}")
        if ctype in _INT_RANGE:
            if not isinstance(a, (numbers.Integral, _np.integer, _np.bool_)):
                raise MXNetError(f"{what} is {cname}: got {a!r}")
            lo, hi = _INT_RANGE[ctype]
            if not lo <= int(a) <= hi:
                raise MXNetError(f"{what}: {a} does not fit {cname}")
            return ctype(int(a))
        if ctype is ctypes.c_uint16:         # __half, __nv_bfloat16 bits
            bits = torch.tensor(float(a), dtype=dtype).view(torch.int16)
            return ctype(int(bits) & 0xFFFF)
        return ctype(float(a))

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Run the kernel on `ctx` over `grid_dims` blocks of
        `block_dims` threads with `shared_mem` bytes of dynamic shared
        memory; array arguments are written in place."""
        from .ndarray import NDArray
        device = as_device(ctx)
        args = [a.data if isinstance(a, NDArray) else a for a in args]
        values = self._values(args, device)
        grid = _dims(grid_dims, "grid", _GRID_MAX)
        block = _dims(block_dims, "block", _BLOCK_MAX)
        if block[0] * block[1] * block[2] > _THREADS_MAX:
            raise MXNetError(f"block dims {block}: more than {_THREADS_MAX} "
                             f"threads")
        if not (isinstance(shared_mem, numbers.Integral)
                and 0 <= shared_mem <= MAX_SHARED_MEM):
            raise MXNetError(f"shared_mem {shared_mem} outside [0, "
                             f"{MAX_SHARED_MEM}]")

        def plain():
            if self.cpu_fn is None:
                raise MXNetError(f"{self.name}: a CPU context needs the "
                                 f"kernel's plain version (get_kernel's "
                                 f"cpu_fn)")
            self.cpu_fn(*args)

        def launch():
            fn = self._entry()
            ptrs = [ctypes.c_void_p(v.data_ptr())
                    if isinstance(v, torch.Tensor) else v for v in values]
            argv = (ctypes.c_void_p * max(1, len(ptrs)))(
                *[ctypes.addressof(v) for v in ptrs])
            rc = fn(argv, *grid, *block, int(shared_mem),
                    torch.cuda.current_stream(device).cuda_stream)
            if rc != 0:
                err = self.module.library().mxrtc_error_string(rc).decode()
                raise MXNetError(f"{self.name}: launch failed: {err} "
                                 f"(cudaError {rc})")
            with _count_lock:
                launch_counts[self.name] += 1

        return _kernels.route(f"rtc kernel {self.name}", device, launch,
                              plain)

    def _entry(self):
        if self._fn is None:
            fn = getattr(self.module.library(), f"mxrtc_launch_{self._index}")
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_uint] * 7 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
