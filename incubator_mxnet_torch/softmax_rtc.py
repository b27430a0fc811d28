"""A softmax loss head whose forward and backward are runtime-compiled
CUDA kernels: MXNet's `custom_softmax_rtc` example on the port's `rtc`
and `operator` modules, the path that runs kernel row 7 (the JAX
package's `rtc.PallasKernel`, whose body the user writes).

    out = net(x)                                   # (N, C) logits
    prob = nd.Custom(out, label, op_type="softmax_rtc")
    prob.backward()                                # dx = prob - onehot

`softmax_rtc` is registered when this module is imported.  Its forward
is `softmax_fwd` (a row of up to 1024 columns read once into a warp's
registers: its max, the sum of exp, then p = exp(x - max) / sum with one
exp an element, 16-byte accesses where the row allows; a wider row in an
online pass and a writing pass),
its backward `softmax_bwd` (SoftmaxOutput's gradient
p - onehot(label), one thread an element; it needs no head gradient);
labels are float32, as MXNet's are, truncated to integers.  `axpy<T>`
(y = a·x + y, float32 arithmetic, for float32 and bfloat16) is the
source's template kernel, reached through `exports`.  All three read
and write each element once, so their bound is bytes over the card's
memory rate.  Each has its plain PyTorch version beside it, which CPU
tensors take.
"""
from __future__ import annotations

import functools

import torch

from .context import Context
from .operator import CustomOp, CustomOpProp, register
from .rtc import CudaModule

__all__ = ["SOURCE", "EXPORTS", "kernels", "softmax_fwd", "softmax_bwd",
           "axpy", "softmax_fwd_plain", "softmax_bwd_plain", "axpy_plain",
           "SoftmaxRTC", "SoftmaxRTCProp"]

SOURCE = r"""
// softmax over the rows of x (rows x cols), y = p or, req 3 (MXNet's
// kAddTo), y += p, a warp a row.  Each element is read once and its exp
// taken once for rows of at most 1024 columns, which stay in registers:
// 16-byte loads and stores where cols % 4 == 0 and x and y are 16-byte
// aligned, scalar ones elsewhere.  Wider rows take an online pass (the
// running max and the sum rescaled with it) and a pass that writes: two
// reads.  Any launch of whole warps covers every row.
#define SM_NEG_INF __int_as_float(0xff800000)

__device__ __forceinline__ float sm_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sm_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// e / s from inv = 1 / s: one product and one correction step
__device__ __forceinline__ float sm_div(float e, float s, float inv) {
  const float q = e * inv;
  return fmaf(fmaf(-s, q, e), inv, q);
}

__device__ __forceinline__ float sm_out(float p, const float *y, int req) {
  return req == 3 ? *y + p : p;
}

// a row of at most 1024 columns over a warp, 32 scalars a lane
__device__ __forceinline__ void sm_row(const float *xr, float *yr, int cols,
                                       int req, int lane) {
  float v[32];
  float m = SM_NEG_INF;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < cols ? xr[i] : SM_NEG_INF;
    m = fmaxf(m, v[k]);
  }
  m = sm_max(m);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    v[k] = expf(v[k] - m);
    s += v[k];
  }
  s = sm_sum(s);
  const float inv = 1.f / s;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = lane + 32 * k;
    if (i < cols) yr[i] = sm_out(sm_div(v[k], s, inv), yr + i, req);
  }
}

// a row of at most 128 * K columns over a warp, K float4 a lane
template <int K>
__device__ __forceinline__ void sm_row4(const float *xr, float *yr, int cols,
                                        int req, int lane) {
  const float4 *x4 = reinterpret_cast<const float4 *>(xr);
  float4 *y4 = reinterpret_cast<float4 *>(yr);
  const int n4 = cols >> 2;
  float4 v[K];
  float m = SM_NEG_INF;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < n4 ? x4[j]
                  : make_float4(SM_NEG_INF, SM_NEG_INF, SM_NEG_INF,
                                SM_NEG_INF);
    m = fmaxf(m, fmaxf(fmaxf(v[k].x, v[k].y), fmaxf(v[k].z, v[k].w)));
  }
  m = sm_max(m);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k].x = expf(v[k].x - m);
    v[k].y = expf(v[k].y - m);
    v[k].z = expf(v[k].z - m);
    v[k].w = expf(v[k].w - m);
    s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  }
  s = sm_sum(s);
  const float inv = 1.f / s;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    if (j < n4) {
      float4 p = make_float4(sm_div(v[k].x, s, inv), sm_div(v[k].y, s, inv),
                             sm_div(v[k].z, s, inv), sm_div(v[k].w, s, inv));
      if (req == 3) {
        const float4 o = y4[j];
        p.x += o.x;
        p.y += o.y;
        p.z += o.z;
        p.w += o.w;
      }
      y4[j] = p;
    }
  }
}

// a row of any width over a warp: max and sum in one online pass, then
// the pass that writes
__device__ __forceinline__ void sm_row_wide(const float *xr, float *yr,
                                            int cols, int req, int lane) {
  float m = SM_NEG_INF, s = 0.f;
  for (int i = lane; i < cols; i += 32) {
    const float x = xr[i];
    if (x > m) {
      s = s * expf(m - x) + 1.f;
      m = x;
    } else {
      s += x == m ? 1.f : expf(x - m);
    }
  }
  const float mr = sm_max(m);
  s = sm_sum(m == mr ? s : s * expf(m - mr));
  const float inv = 1.f / s;
  for (int i = lane; i < cols; i += 32)
    yr[i] = sm_out(sm_div(expf(xr[i] - mr), s, inv), yr + i, req);
}

extern "C" __global__ void softmax_fwd(const float *__restrict__ x,
                                       float *__restrict__ y, int rows,
                                       int cols, int req) {
  const int lane = threadIdx.x & 31;
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int warps = (int)((gridDim.x * blockDim.x) >> 5);
  const bool vec = (cols & 3) == 0 &&
      ((reinterpret_cast<unsigned long long>(x) |
        reinterpret_cast<unsigned long long>(y)) & 15) == 0;
  for (int r = warp; r < rows; r += warps) {
    const float *xr = x + (long long)r * cols;
    float *yr = y + (long long)r * cols;
    if (cols > 1024) sm_row_wide(xr, yr, cols, req, lane);
    else if (vec) sm_row4<8>(xr, yr, cols, req, lane);
    else sm_row(xr, yr, cols, req, lane);
  }
}

// SoftmaxOutput's gradient: dx = y - onehot(label), one thread an element
extern "C" __global__ void softmax_bwd(const float *__restrict__ label,
                                       const float *__restrict__ y,
                                       float *__restrict__ dx, int rows,
                                       int cols, int req) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int r = (int)(i / cols), c = (int)(i % cols);
  const float g = y[i] - (c == (int)label[r] ? 1.f : 0.f);
  dx[i] = req == 3 ? dx[i] + g : g;
}

// y = a * x + y in float32 arithmetic, rounded once to T; the product
// and sum are not fused, as the plain version's are not
template <typename T>
__global__ void axpy(const T *__restrict__ x, T *__restrict__ y, float a,
                     int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    y[i] = static_cast<T>(__fadd_rn(__fmul_rn(a, static_cast<float>(x[i])),
                                    static_cast<float>(y[i])));
}
"""
EXPORTS = ("axpy<float>", "axpy<__nv_bfloat16>")
REQ = {"write": 1, "add": 3}         # MXNet's OpReqType codes
FWD_THREADS = 256                    # 8 warps a block
THREADS = 256
_AXPY_SIG = "const {t} *x, {t} *y, float a, int64_t n"


def softmax_fwd_plain(x, y, rows, cols, req):
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    p = e / e.sum(dim=1, keepdim=True)
    y.copy_(y + p if req == REQ["add"] else p)


def softmax_bwd_plain(label, y, dx, rows, cols, req):
    onehot = torch.arange(cols, device=y.device)[None, :] == \
        label.to(torch.int64)[:, None]
    g = y - onehot.to(y.dtype)
    dx.copy_(dx + g if req == REQ["add"] else g)


def axpy_plain(x, y, a, n):
    y.copy_((a * x.float() + y.float()).to(y.dtype))


@functools.cache
def kernels():
    """{name: CudaKernel} of one `CudaModule` of `SOURCE` (compiled at
    the first launch on the card)."""
    mod = CudaModule(SOURCE, exports=EXPORTS)
    return {
        "softmax_fwd": mod.get_kernel(
            "softmax_fwd", "const float *x, float *y, int rows, int cols, "
            "int req", cpu_fn=softmax_fwd_plain),
        "softmax_bwd": mod.get_kernel(
            "softmax_bwd", "const float *label, const float *y, float *dx, "
            "int rows, int cols, int req", cpu_fn=softmax_bwd_plain),
        "axpy<float>": mod.get_kernel(
            "axpy<float>", _AXPY_SIG.format(t="float"), cpu_fn=axpy_plain),
        "axpy<__nv_bfloat16>": mod.get_kernel(
            "axpy<__nv_bfloat16>", _AXPY_SIG.format(t="__nv_bfloat16"),
            cpu_fn=axpy_plain),
    }


def _blocks(n, per_block):
    return (max(1, -(-n // per_block)), 1, 1)


def softmax_fwd(x, y, req="write"):
    """y = softmax(x) over rows ("add": y += softmax(x)); (N, C) float32."""
    rows, cols = x.shape
    kernels()["softmax_fwd"].launch(
        [x, y, rows, cols, REQ[req]], Context.from_device(x.device),
        _blocks(rows, FWD_THREADS // 32), (FWD_THREADS, 1, 1))


def softmax_bwd(label, y, dx, req="write"):
    """dx = y - onehot(label) ("add": dx += ...)."""
    rows, cols = y.shape
    kernels()["softmax_bwd"].launch(
        [label, y, dx, rows, cols, REQ[req]], Context.from_device(y.device),
        _blocks(rows * cols, THREADS), (THREADS, 1, 1))


def axpy(x, y, a):
    """y += a * x, float32 or bfloat16, in place."""
    name = "axpy<float>" if y.dtype == torch.float32 else \
        "axpy<__nv_bfloat16>"
    n = y.numel()
    kernels()[name].launch([x, y, a, n], Context.from_device(y.device),
                           _blocks(n, THREADS), (THREADS, 1, 1))


class SoftmaxRTC(CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        if req[0] != "null":
            softmax_fwd(in_data[0].data, out_data[0].data, req[0])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        if req[0] != "null":
            softmax_bwd(in_data[1].data, out_data[0].data, in_grad[0].data,
                        req[0])


@register("softmax_rtc")
class SoftmaxRTCProp(CustomOpProp):
    """(data (N, C) float32, label (N,) float32) -> softmax (N, C); a
    loss head, so it takes no head gradient."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        data, _ = in_shape
        return [data, [data[0]]], [data], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return SoftmaxRTC()
