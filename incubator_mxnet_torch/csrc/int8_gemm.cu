// int8 products and activation quantization for the int8 inference path
// (incubator_mxnet_torch/ops/quantized.py).
//
// Replaces no Pallas kernel: the JAX package computes its int8 products
// with XLA (`conv_general_dilated` / `dot_general` with
// `preferred_element_type=int32`, incubator_mxnet_tpu/ops/quantized.py
// :106, :130, :240, :262).  PyTorch on CUDA has no integer convolution,
// and `torch._int_mm` refuses m <= 16 and k or n not a multiple of 8
// (a one-row request, Dense(4), ResNet's stem with K = 147), so the
// products are these kernels.
//
// int8_igemm: C[m, n] = sum_k A[m, k] * B[n, k] in int32, A and B both
// K-major.  Three forms, chosen by the wrapper from the shapes:
//   - `igemm_wgmma`: the dense product (A = data [M, K], B = weight
//     [N, K], K % 16 == 0, aligned rows) and the pointwise convolution
//     (1 x 1, stride 1, one group) of NHWC data as that product.  TMA
//     brings 128 x 128-byte tiles of both in 128-byte swizzle into a ring
//     of three stages; two warpgroups run wgmma m64n128k32 s8 with one
//     group of products in flight; the 128 x 128 output tile is staged in
//     shared memory and written 16 bytes a thread (or, for the
//     convolution, NCHW with consecutive threads on consecutive
//     positions).  Two blocks an SM.
//   - `igemm_kernel<2>`: any other convolution whose groups have a
//     multiple of 16 channels, an implicit GEMM over m = (b, oh, ow) and
//     k = (r, s, c) of NHWC data (int8_quantize writes it channels-last)
//     against OHWI weights, A's 16-byte chunks of channels by cp.async.
//   - `igemm_kernel<1>` and `<0>`: the rest (ResNet's stem, K = 147;
//     grouped convolutions with few channels a group; dense with K % 16
//     != 0): A gathered byte by byte from NCHW data (k = (c, r, s)) or
//     from ragged rows, through registers.
//   The mma.sync forms take a 128 x 128 block tile, 64 bytes of K a step
//   in four shared-memory stages, 8 warps of 64 x 32 with
//   mma.sync.m16n8k32 s8 fragments by ldmatrix from 80-byte rows; grid.z
//   runs over the groups.  M, N and K tails are masked (zeros enter the
//   product).  Two epilogues: (i) int32 plus an int32 bias per channel
//   (the per-tensor ops), (ii) float(acc) * (x_scale * w_scale[n]) +
//   bias[n], relu, float32 or bfloat16 out (the per-channel ops), written
//   with __fmul_rn / __fadd_rn, so nvcc does not contract it into an FMA
//   and it equals the plain version bit for bit.
//   Bound: 2*M*N*K operations at 1,979 TOP/s int8 (H100 SXM) or the
//   bytes of A, B and C at 3.35 TB/s, whichever is larger; at BERT's
//   shapes the operations.
//
// int8_quantize: q = clip(rint(x / scale), -127, 127) with scale =
//   max(amax, 1e-12) / 127, amax a static threshold or max|x| (an atomic
//   max on the float's bits, values >= 0, in a first pass); the scale's
//   division as XLA does it (`quant_scale`).  rintf rounds
//   half to even as jnp.round and torch.round do (roundf would not), and
//   x / scale is an IEEE division (no fast math: a multiply by 1/scale
//   moves q at rounding boundaries).  16-byte loads and 8-byte stores
//   where x and q are aligned; for a convolution's NHWC form q is written
//   channels-last through a shared-memory tile.  Bound: the bytes of x
//   read (twice when dynamic) and of q written.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_common.cuh"   // TMA, mbarriers, wgmma descriptors

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;          // 80-byte smem rows: conflict-free
constexpr int TILE = BM * LDS;        // bytes of one operand's stage
constexpr int STAGES = 4;             // K steps in flight
constexpr int SMEM = STAGES * 2 * TILE;
static_assert(SMEM >= BN * (BM * 4 + 16), "the stages hold the output tile");
constexpr int THREADS = 256;

struct Conv {
  int C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW, Cg, O;
};

struct Epi {
  int kind;               // 0 int32, 1 float32, 2 bfloat16
  const int* bias_i32;    // (i), may be null
  const float* bias_f;    // (ii), may be null
  const float* x_scale;   // (ii), one value
  const float* w_scale;   // (ii), per channel
  int relu;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bytes [k, k + 16) of row r of a K-major [rows, K] int8 matrix, zeros
// past either edge (the path for K % 16 != 0 or unaligned operands)
__device__ __forceinline__ int4 chunk_bytes(const int8_t* g, int rows,
                                            int K, int r, int k) {
  int w[4] = {0, 0, 0, 0};
  if (r < rows) {
    const int8_t* p = g + (long long)r * K + k;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (k + j < K) w[j >> 2] |= (int)(uint8_t)p[j] << (8 * (j & 3));
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float epilogue_f(int acc, float xs, int o,
                                            const Epi& e) {
  float f = __fmul_rn(__int2float_rn(acc), __fmul_rn(xs, e.w_scale[o]));
  if (e.bias_f) f = __fadd_rn(f, e.bias_f[o]);
  if (e.relu) f = fmaxf(f, 0.f);
  return f;
}

// One 128 x 128 output tile of block (blockIdx.x, blockIdx.y), group
// blockIdx.z.  STAGES shared-memory stages of 64 bytes of K: while the
// tensor cores work on one, the next STAGES - 1 K steps' tiles arrive
// (cp.async where rows are 16-byte chunks; through registers, stored
// after this step's products, for the byte gathers).  Eight warps of
// 64 x 32 outputs; fragments by ldmatrix.
// MODE: 0 dense with K % 16 != 0 (or unaligned rows), bytes through
// registers; 1 convolution gathered byte by byte from NCHW data
// (k = (c, r, s)); 2 convolution of NHWC data and OHWI weights
// (k = (r, s, c)), whose 16-byte chunks of channels arrive by cp.async
// (channels a group a multiple of 16).  B by cp.async where `vecB`.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
igemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             void* __restrict__ out, int M, int N, int K, Conv cv, Epi e,
             int vecB) {
  extern __shared__ __align__(128) int8_t smem[];   // [STAGES][A, B][TILE]
  constexpr bool CONV = MODE != 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, grp = blockIdx.z;
  const int8_t* wg = w + (long long)grp * N * K;

  // dense tiles: two 16-byte chunks of A and of B a thread a stage,
  // rows c_row and c_row + 64
  const int c_row = tid >> 2, c_col = (tid & 3) * 16;
  // the convolution's gather: row m0 + a_row, 32 k columns a stage
  const int a_row = tid & (BM - 1), a_half = tid >> 7;
  const int8_t* a_base = x;
  int ih0 = 0, iw0 = 0;
  bool a_valid = false;
  if (MODE == 1) {
    int m = m0 + a_row;
    a_valid = m < M;
    if (a_valid) {
      int ohw = cv.OH * cv.OW;
      int b = m / ohw, r = m - b * ohw;
      int oh = r / cv.OW, ow = r - oh * cv.OW;
      ih0 = oh * cv.sh - cv.ph;
      iw0 = ow * cv.sw - cv.pw;
      a_base = x + ((long long)b * cv.C + (long long)grp * cv.Cg) *
                       cv.H * cv.W;
    }
  }

  // NHWC: each of this thread's two dense rows as (image, ih0, iw0)
  const int8_t* nh_base[2] = {x, x};
  int nh_ih0[2] = {0, 0}, nh_iw0[2] = {0, 0};
  bool nh_ok[2] = {false, false};
  if (MODE == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m = m0 + c_row + h * 64;
      nh_ok[h] = m < M;
      if (nh_ok[h]) {
        int ohw = cv.OH * cv.OW;
        int b = m / ohw, r = m - b * ohw;
        int oh = r / cv.OW, ow = r - oh * cv.OW;
        nh_ih0[h] = oh * cv.sh - cv.ph;
        nh_iw0[h] = ow * cv.sw - cv.pw;
        nh_base[h] = x + (long long)b * cv.H * cv.W * cv.C +
                     (long long)grp * cv.Cg;
      }
    }
  }

  int4 a_reg[2], b_reg[2];

  auto gather = [&](int k0, int4* dst) {
    int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    int kb = k0 + a_half * 32;
    if (a_valid && kb < K) {
      int khw = cv.kh * cv.kw;
      int c = kb / khw, rs = kb - c * khw;
      int r = rs / cv.kw, s = rs - r * cv.kw;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (kb + j < K) {
          int ih = ih0 + r * cv.dh, iw = iw0 + s * cv.dw;
          if ((unsigned)ih < (unsigned)cv.H && (unsigned)iw < (unsigned)cv.W)
            v[j >> 2] |= (int)(uint8_t)a_base[(c * cv.H + ih) * cv.W + iw]
                         << (8 * (j & 3));
        }
        if (++s == cv.kw) {
          s = 0;
          if (++r == cv.kh) {
            r = 0;
            ++c;
          }
        }
      }
    }
    dst[0] = make_int4(v[0], v[1], v[2], v[3]);
    dst[1] = make_int4(v[4], v[5], v[6], v[7]);
  };

  auto stage_a = [&](int st) { return smem + st * 2 * TILE; };
  auto stage_b = [&](int st) { return smem + st * 2 * TILE + TILE; };

  // start stage `st`'s loads of K step k0
  auto fetch = [&](int st, int k0) {
    int k = k0 + c_col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row = c_row + h * 64;
      if (vecB) {
        int r = n0 + row;
        bool ok = r < N && k < K;
        cp_async16(stage_b(st) + row * LDS + c_col,
                   ok ? wg + (long long)r * K + k : wg, ok);
      } else {
        b_reg[h] = chunk_bytes(wg, N, K, n0 + row, k);
      }
      if (MODE == 2) {
        bool ok = nh_ok[h] && k < K;
        const int8_t* src = x;
        if (ok) {
          int rs = k / cv.Cg, c = k - rs * cv.Cg;
          int r = rs / cv.kw, s = rs - r * cv.kw;
          int ih = nh_ih0[h] + r * cv.dh, iw = nh_iw0[h] + s * cv.dw;
          ok = (unsigned)ih < (unsigned)cv.H && (unsigned)iw < (unsigned)cv.W;
          src = nh_base[h] + ((long long)ih * cv.W + iw) * cv.C + c;
        }
        cp_async16(stage_a(st) + row * LDS + c_col, ok ? src : x, ok);
      }
      if (!CONV) a_reg[h] = chunk_bytes(x, M, K, m0 + row, k);
    }
    if (MODE == 1) gather(k0, a_reg);
  };
  // finish stage `st`: the loads that went through registers
  auto land = [&](int st) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row = c_row + h * 64;
      if (!vecB)
        *reinterpret_cast<int4*>(stage_b(st) + row * LDS + c_col) = b_reg[h];
      if (!CONV)
        *reinterpret_cast<int4*>(stage_a(st) + row * LDS + c_col) = a_reg[h];
    }
    if (MODE == 1) {
      int4* d = reinterpret_cast<int4*>(stage_a(st) + a_row * LDS +
                                        a_half * 32);
      d[0] = a_reg[0];
      d[1] = a_reg[1];
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) {
      fetch(st, st * BK);
      land(st);
    }
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();            // step kt landed; step kt - 1 consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) fetch(nxt % STAGES, nxt * BK);
    cp_commit();
    const int8_t* sa = stage_a(kt % STAGES);
    const int8_t* sb = stage_b(kt % STAGES);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], sa + (wm + i * 16 + (lane & 15)) * LDS + ks +
                          (lane >> 4) * 16);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldsm_x4(b[jj], sb + (wn + jj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                LDS + ks + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], a[i], &b[j >> 1][(j & 1) * 2]);
    }
    if (nxt < nk) land(nxt % STAGES);
  }

  // epilogue: c0, c1 at (gid, 2 tig + {0, 1}), c2, c3 at (gid + 8, ...)
  float xs = 0.f;
  if (e.kind != 0) xs = *e.x_scale;
  if (CONV) {
    // NCHW output: staged channel-major in shared memory, then written
    // with consecutive threads on consecutive output positions
    cp_wait<0>();
    __syncthreads();                // every stage read and landed
    const int es = e.kind == 2 ? 2 : 4;
    const int ldo = BM * es + 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int r = wm + i * 16 + gid + h * 8;
            const int c = wn + j * 8 + tig * 2 + t;
            const int o = grp * N + min(n0 + c, N - 1);
            int v = acc[i][j][h * 2 + t];
            int8_t* dst = smem + c * ldo + r * es;
            if (e.kind == 0) {
              if (e.bias_i32) v = (int)((unsigned)v + (unsigned)e.bias_i32[o]);
              *reinterpret_cast<int*>(dst) = v;
            } else {
              const float f = epilogue_f(v, xs, o, e);
              if (e.kind == 1)
                *reinterpret_cast<float*>(dst) = f;
              else
                *reinterpret_cast<__nv_bfloat16*>(dst) =
                    __float2bfloat16_rn(f);
            }
          }
    __syncthreads();
    const int r = tid & (BM - 1), m = m0 + r;      // fixed for the thread
    if (m < M) {
      const int ohw = cv.OH * cv.OW;
      const int b = m / ohw, p = m - b * ohw;
      unsigned char* o = static_cast<unsigned char*>(out);
      for (int c = tid >> 7; c < BN; c += THREADS / BM) {
        if (n0 + c >= N) break;
        const long long idx =
            ((long long)b * cv.O + grp * N + n0 + c) * ohw + p;
        const int8_t* src = smem + c * ldo + r * es;
        if (es == 4)
          *reinterpret_cast<int*>(o + idx * 4) =
              *reinterpret_cast<const int*>(src);
        else
          *reinterpret_cast<unsigned short*>(o + idx * 2) =
              *reinterpret_cast<const unsigned short*>(src);
      }
    }
    return;
  }
  // dense (the ragged-K form): row-major [M, N], value by value
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int m = m0 + wm + i * 16 + gid + h * 8;
          const int n = n0 + wn + j * 8 + tig * 2 + t;
          if (m >= M || n >= N) continue;
          const long long idx = (long long)m * N + n;
          int v = acc[i][j][h * 2 + t];
          if (e.kind == 0) {
            if (e.bias_i32) v = (int)((unsigned)v + (unsigned)e.bias_i32[n]);
            static_cast<int*>(out)[idx] = v;
          } else {
            const float f = epilogue_f(v, xs, n, e);
            if (e.kind == 1)
              static_cast<float*>(out)[idx] = f;
            else
              static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(f);
          }
        }
}

// ---------------------------------------------------------------------
// The dense product on Hopper's warpgroup MMA: wgmma m64n128k32 s8 from
// shared memory, both operands K-major in 128-byte swizzle, brought by
// TMA through a ring of WG_STAGES stages (K % 16 == 0, aligned rows).
// Two warpgroups of 64 x 128 outputs, one group of products kept in
// flight while the next is started; thread 0 starts the loads; two
// blocks an SM.
// ---------------------------------------------------------------------
constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 128, WG_STAGES = 3;
constexpr int WG_TILE = 128 * WG_BK;                 // 16 KB a tile
constexpr int WG_SMEM = WG_STAGES * 2 * WG_TILE + 1024;
static_assert(WG_STAGES * 2 * WG_TILE >= 128 * (128 * 4 + 16),
              "the stages hold the staged output tile");

// acc (64 x 128 per warpgroup, s32) += A·Bᵀ over k = 32 bytes
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, 1;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void fence_acc(int (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

struct DenseMaps {
  CUtensorMap a, b;     // (K, rows) int8, (1, 128, 128) boxes
};

__global__ void __launch_bounds__(256)
igemm_wgmma(const __grid_constant__ DenseMaps maps, void* __restrict__ out,
            int M, int N, int K, int ohw, Epi e) {
  extern __shared__ unsigned char raw[];
  unsigned char* sm = smem_align1024(raw);
  __shared__ __align__(8) uint64_t full[WG_STAGES];
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  const int nk = (K + WG_BK - 1) / WG_BK;

  auto fetch = [&](int s, int kt) {
    unsigned char* st = sm + s * 2 * WG_TILE;
    mbar_expect_tx(&full[s], 2 * WG_TILE);
    tma_load(st, &maps.a, &full[s], kt * WG_BK, m0, 0);
    tma_load(st + WG_TILE, &maps.b, &full[s], kt * WG_BK, n0, 0);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < WG_STAGES && s < nk; ++s) fetch(s, s);
  }
  __syncthreads();

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(&full[s], (kt / WG_STAGES) & 1);
    unsigned char* st = sm + s * 2 * WG_TILE;
    const uint64_t da = sw128_desc(st + wg * 64 * 128);
    const uint64_t db = sw128_desc(st + WG_TILE);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 32; ++kk)
      wgmma_s8_m64n128k32(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();                // step kt - 1's products are done
    fence_acc(acc);
    __syncthreads();                // by both warpgroups: its stage is free
    const int next = kt - 1 + WG_STAGES;
    if (tid == 0 && kt >= 1 && next < nk) fetch(next % WG_STAGES, next);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();                  // every stage read: reuse for staging

  // the tile's outputs staged in shared memory, rows of 128 values plus
  // 16 bytes (conflict-free writes), then written out 16 bytes a thread.
  // acc[4i + {0, 1}] at (16 warp + lane / 4, 8 i + 2 (lane % 4) + {0, 1}),
  // acc[4i + {2, 3}] eight rows below
  const int es = e.kind == 2 ? 2 : 4;
  const int ldo = 128 * es + 16;
  const float xs = e.kind != 0 ? *e.x_scale : 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
    unsigned char* srow = sm + r * ldo;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = i * 8 + (lane & 3) * 2;
      const int n = min(n0 + c, N - 1);     // past N: computed, not written
      const int n1 = min(n0 + c + 1, N - 1);
      const int v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if (e.kind == 0) {
        int2 p = make_int2(v0, v1);
        if (e.bias_i32) {
          p.x = (int)((unsigned)v0 + (unsigned)e.bias_i32[n]);
          p.y = (int)((unsigned)v1 + (unsigned)e.bias_i32[n1]);
        }
        *reinterpret_cast<int2*>(srow + c * 4) = p;
      } else {
        const float f0 = epilogue_f(v0, xs, n, e);
        const float f1 = epilogue_f(v1, xs, n1, e);
        if (e.kind == 1)
          *reinterpret_cast<float2*>(srow + c * 4) = make_float2(f0, f1);
        else
          *reinterpret_cast<__nv_bfloat162*>(srow + c * 2) =
              __halves2bfloat162(__float2bfloat16_rn(f0),
                                 __float2bfloat16_rn(f1));
      }
    }
  }
  __syncthreads();
  unsigned char* o = static_cast<unsigned char*>(out);
  if (ohw > 0) {
    // a pointwise convolution's NCHW output: row m = (image, position),
    // column n a channel; consecutive threads on consecutive positions
    const int r = tid & 127, m = m0 + r;
    if (m >= M) return;
    const int b = m / ohw, p = m - b * ohw;
    for (int c = tid >> 7; c < WG_BN && n0 + c < N; c += 2) {
      const long long idx = ((long long)b * N + n0 + c) * ohw + p;
      const unsigned char* src = sm + r * ldo + c * es;
      if (es == 4)
        *reinterpret_cast<int*>(o + idx * 4) =
            *reinterpret_cast<const int*>(src);
      else
        *reinterpret_cast<unsigned short*>(o + idx * 2) =
            *reinterpret_cast<const unsigned short*>(src);
    }
    return;
  }
  const int chunks = 128 * es / 16;         // 16-byte chunks a row
  const bool whole = m0 + WG_BM <= M && n0 + WG_BN <= N &&
                     ((long long)N * es) % 16 == 0;
  for (int idx = tid; idx < WG_BM * chunks; idx += 256) {
    const int r = idx / chunks, cc = idx - r * chunks;
    const unsigned char* src = sm + r * ldo + cc * 16;
    if (whole) {
      *reinterpret_cast<int4*>(o + ((long long)(m0 + r) * N + n0) * es +
                               cc * 16) =
          *reinterpret_cast<const int4*>(src);
      continue;
    }
    if (m0 + r >= M) continue;
    for (int j = 0; j < 16 / es; ++j) {
      const int n = n0 + cc * (16 / es) + j;
      if (n >= N) break;
      unsigned char* dst = o + ((long long)(m0 + r) * N + n) * es;
      if (es == 4)
        *reinterpret_cast<int*>(dst) =
            *reinterpret_cast<const int*>(src + j * 4);
      else
        *reinterpret_cast<unsigned short*>(dst) =
            *reinterpret_cast<const unsigned short*>(src + j * 2);
    }
  }
}

// A map of an int8 (rows, K) K-major matrix read as (1, 128, 128) boxes
// in 128-byte swizzle (rows and columns past the edges arrive as 0).
static bool encode_s8(EncodeTiledFn fn, CUtensorMap* map, const void* base,
                      long long K, long long rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)(K * rows)};
  const cuuint32_t box[3] = {(cuuint32_t)WG_BK, 128, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the wgmma kernel; cudaErrorInvalidValue where the tensor maps cannot
// be encoded
int launch_wgmma(const void* x, const void* w, void* out, int M, int N,
                 int K, int ohw, Epi e, cudaStream_t st) {
  EncodeTiledFn fn = encode_tiled();
  DenseMaps maps;
  if (!fn || !encode_s8(fn, &maps.a, x, K, M) ||
      !encode_s8(fn, &maps.b, w, K, N))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        igemm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BN - 1) / WG_BN);
  igemm_wgmma<<<grid, 256, WG_SMEM, st>>>(maps, out, M, N, K, ohw, e);
  return (int)cudaGetLastError();
}

template <typename T>
__device__ __forceinline__ float load_f(const T* p, long long i);
template <>
__device__ __forceinline__ float load_f<float>(const float* p, long long i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p,
                                                       long long i) {
  return __bfloat162float(p[i]);
}

// 8 values from element 8 * i8 on (16-byte aligned rows of 8)
__device__ __forceinline__ void load8(const float* p, long long i8,
                                      float* f) {
  const float4* q = reinterpret_cast<const float4*>(p) + 2 * i8;
  float4 u = q[0], v = q[1];
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, long long i8,
                                      float* f) {
  uint4 u = reinterpret_cast<const uint4*>(p)[i8];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

template <typename T>
__global__ void amax_kernel(const T* __restrict__ x, long long n, int vec,
                            int* __restrict__ amax_bits) {
  __shared__ float part[32];
  float m = 0.f;
  long long stride = (long long)gridDim.x * blockDim.x;
  long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    float f[8];
    for (long long i = i0; i < n / 8; i += stride) {
      load8(x, i, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
    }
    done = n / 8 * 8;
  }
  for (long long i = done + i0; i < n; i += stride)
    m = fmaxf(m, fabsf(load_f(x, i)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < (blockDim.x >> 5) ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    // values >= 0: their float bits order as ints
    if (threadIdx.x == 0) atomicMax(amax_bits, __float_as_int(m));
  }
}

// max(amax, 1e-12) / 127 as the JAX package's XLA computes it: a static
// threshold is a constant of the trace and the division folds exactly; a
// run-time amax is multiplied by the float32 reciprocal of 127
constexpr float RECIP_127 = 0x1.020408p-7f;
__device__ __forceinline__ float quant_scale(float a, int dynamic) {
  return dynamic ? __fmul_rn(fmaxf(a, 1e-12f), RECIP_127)
                 : __fdiv_rn(fmaxf(a, 1e-12f), 127.0f);
}

__device__ __forceinline__ int quant1(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, long long n,
                                int vec, int8_t* __restrict__ q,
                                float* __restrict__ amax, float thr,
                                int dynamic, float* __restrict__ scale_out) {
  float a = dynamic ? *amax : thr;
  float scale = quant_scale(a, dynamic);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *scale_out = scale;
    if (!dynamic) *amax = thr;
  }
  long long stride = (long long)gridDim.x * blockDim.x;
  long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    float f[8];
    for (long long i = i0; i < n / 8; i += stride) {
      load8(x, i, f);
      unsigned lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= (unsigned)(uint8_t)(int8_t)quant1(f[j], scale) << (8 * j);
        hi |= (unsigned)(uint8_t)(int8_t)quant1(f[4 + j], scale) << (8 * j);
      }
      reinterpret_cast<uint2*>(q)[i] = make_uint2(lo, hi);
    }
    done = n / 8 * 8;
  }
  for (long long i = done + i0; i < n; i += stride)
    q[i] = (int8_t)quant1(load_f(x, i), scale);
}

// quantize_kernel's values written channels-last (C % 16 == 0): a
// block quantizes a 64-channel x 64-position tile of one image, read 8
// positions (16 bytes of bf16) a thread along the rows of x and written
// 16 channels a thread along the rows of q, through shared memory
template <typename T>
__global__ void __launch_bounds__(256)
quantize_nhwc_kernel(const T* __restrict__ x, int C, int HW,
                     int8_t* __restrict__ q, float* __restrict__ amax,
                     float thr, int dynamic, float* __restrict__ scale_out) {
  constexpr int PITCH = 80;                    // 64 channels + 16 bytes
  __shared__ __align__(16) int8_t tile[64 * PITCH];   // [position][channel]
  float a = dynamic ? *amax : thr;
  float scale = quant_scale(a, dynamic);
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0) {
    *scale_out = scale;
    if (!dynamic) *amax = thr;
  }
  const long long b = blockIdx.z;
  const int c0 = blockIdx.y * 64, p0 = blockIdx.x * 64;
  const bool vec = HW % 8 == 0;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int idx = threadIdx.x + it * 256;
    const int c = idx >> 3, p = (idx & 7) * 8;
    if (c0 + c >= C) continue;
    const long long row = (b * C + c0 + c) * HW;
    float f[8];
    if (vec && p0 + p < HW) {
      load8(x, (row + p0 + p) / 8, f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = p0 + p + j < HW ? load_f(x, row + p0 + p + j) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tile[(p + j) * PITCH + c] = (int8_t)quant1(f[j], scale);
  }
  __syncthreads();
  const int p = threadIdx.x >> 2, cc = (threadIdx.x & 3) * 16;
  if (p0 + p < HW && c0 + cc < C)
    *reinterpret_cast<int4*>(q + (b * HW + p0 + p) * C + c0 + cc) =
        *reinterpret_cast<const int4*>(tile + p * PITCH + cc);
}

int blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  if (b > 132 * 16) b = 132 * 16;
  return b < 1 ? 1 : (int)b;
}

template <int MODE>
int launch_igemm(const void* x, const void* w, void* out, int M, int N,
                 int K, int groups, Conv cv, Epi e, int vecB,
                 cudaStream_t st) {
  static bool sized = false;      // above 48 KB only when asked for
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        igemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, groups);
  igemm_kernel<MODE><<<grid, THREADS, SMEM, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), out, M,
      N, K, cv, e, vecB);
  return (int)cudaGetLastError();
}

template <typename T>
int quantize_launch(const T* x, long long n, int vec, int8_t* q, float* amax,
                    float thr, int dynamic, float* scale, int C, int HW,
                    cudaStream_t st) {
  const int threads = 256;
  int blocks = blocks_for(vec ? (n + 7) / 8 : n, threads);
  if (dynamic)
    amax_kernel<<<blocks, threads, 0, st>>>(x, n, vec,
                                            reinterpret_cast<int*>(amax));
  if (C > 0) {
    dim3 grid((HW + 63) / 64, (C + 63) / 64,
              (unsigned)(n / ((long long)C * HW)));
    quantize_nhwc_kernel<<<grid, 256, 0, st>>>(
        x, C, HW, q, amax, thr, dynamic, scale);
  } else {
    quantize_kernel<<<blocks, threads, 0, st>>>(x, n, vec, q, amax, thr,
                                                dynamic, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int int8_igemm_dense(const void* x, const void* w, void* out, int M, int N,
                     int K, int kind, const void* bias_i32,
                     const void* bias_f, const void* x_scale,
                     const void* w_scale, int relu, int vec, void* stream) {
  Epi e{kind, static_cast<const int*>(bias_i32),
        static_cast<const float*>(bias_f),
        static_cast<const float*>(x_scale),
        static_cast<const float*>(w_scale), relu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)                        // 16-byte rows: TMA and wgmma
    return launch_wgmma(x, w, out, M, N, K, 0, e, st);
  Conv cv{};
  return launch_igemm<0>(x, w, out, M, N, K, 1, cv, e, 0, st);
}

// A pointwise convolution (1 x 1, stride 1, no padding, one group) of
// NHWC data, as the dense product of x [B*H*W, C] and w [O, C] written
// NCHW (ohw = H * W); C % 16 == 0 and aligned rows.
int int8_igemm_pointwise(const void* x, const void* w, void* out, int M,
                         int N, int K, int ohw, int kind,
                         const void* bias_i32, const void* bias_f,
                         const void* x_scale, const void* w_scale, int relu,
                         void* stream) {
  Epi e{kind, static_cast<const int*>(bias_i32),
        static_cast<const float*>(bias_f),
        static_cast<const float*>(x_scale),
        static_cast<const float*>(w_scale), relu};
  return launch_wgmma(x, w, out, M, N, K, ohw, e,
                      static_cast<cudaStream_t>(stream));
}

int int8_igemm_conv(const void* x, const void* w, void* out, int B, int C,
                    int H, int W, int O, int groups, int kh, int kw, int sh,
                    int sw, int ph, int pw, int dh, int dw, int OH, int OW,
                    int kind, const void* bias_i32, const void* bias_f,
                    const void* x_scale, const void* w_scale, int relu,
                    int vecB, int nhwc, void* stream) {
  Epi e{kind, static_cast<const int*>(bias_i32),
        static_cast<const float*>(bias_f),
        static_cast<const float*>(x_scale),
        static_cast<const float*>(w_scale), relu};
  int Cg = C / groups;
  Conv cv{C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW, Cg, O};
  int M = B * OH * OW, N = O / groups, K = Cg * kh * kw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nhwc)   // x NHWC, w OHWI, channels a group a multiple of 16
    return launch_igemm<2>(x, w, out, M, N, K, groups, cv, e, 1, st);
  return launch_igemm<1>(x, w, out, M, N, K, groups, cv, e, vecB, st);
}

// C > 0 (a multiple of 16): x is (B, C, H, W) with HW = H * W and q is
// written channels-last, (B, H, W, C), for the convolution's NHWC form
int int8_quantize(const void* x, int in_kind, long long n, void* q,
                  void* amax, float thr, int dynamic, void* scale, int C,
                  int HW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte loads of x and 8-byte stores of q where both are aligned
  int vec = ((reinterpret_cast<unsigned long long>(x) |
              reinterpret_cast<unsigned long long>(q)) & 15) == 0;
  int8_t* qq = static_cast<int8_t*>(q);
  float* a = static_cast<float*>(amax);
  float* sc = static_cast<float*>(scale);
  if (in_kind == 0)
    return quantize_launch(static_cast<const float*>(x), n, vec, qq, a, thr,
                           dynamic, sc, C, HW, st);
  return quantize_launch(static_cast<const __nv_bfloat16*>(x), n, vec, qq, a,
                         thr, dynamic, sc, C, HW, st);
}

}  // extern "C"
