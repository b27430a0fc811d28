"""A softmax loss head whose forward and backward are runtime-compiled
CUDA kernels: MXNet's `custom_softmax_rtc` example on the port's `rtc`
and `operator` modules, the path that runs kernel row 7 (the JAX
package's `rtc.PallasKernel`, whose body the user writes).

    out = net(x)                                   # (N, C) logits
    prob = nd.Custom(out, label, op_type="softmax_rtc")
    prob.backward()                                # dx = prob - onehot

`softmax_rtc` is registered when this module is imported.  Its forward
is `softmax_fwd` (one warp a row: the row's max, the sum of exp, then
p = exp(x - max) / sum, reading the row three times, which stays in L1
and L2), its backward `softmax_bwd` (SoftmaxOutput's gradient
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
// softmax over each row of x (rows x cols), one warp a row
extern "C" __global__ void softmax_fwd(const float *__restrict__ x,
                                       float *__restrict__ y, int rows,
                                       int cols, int req) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;            // whole warps: blockDim.x % 32 == 0
  const float *xr = x + (long long)row * cols;
  float *yr = y + (long long)row * cols;
  float m = __int_as_float(0xff800000);                    // -inf
  for (int i = lane; i < cols; i += 32) m = fmaxf(m, xr[i]);
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float s = 0.f;
  for (int i = lane; i < cols; i += 32) s += expf(xr[i] - m);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  for (int i = lane; i < cols; i += 32) {
    const float p = expf(xr[i] - m) / s;
    yr[i] = req == 3 ? yr[i] + p : p;              // 3: MXNet's kAddTo
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
FWD_THREADS = 256                    # 8 rows a block
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
