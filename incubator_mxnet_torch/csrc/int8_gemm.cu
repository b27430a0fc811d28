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
// K-major.  Five device kernels, chosen by the wrapper from the shapes
// before the launch (`ops/quantized.py` `igemm_form`):
//   - `igemm_wgmma`: the dense product (A = data [M, K], B = weight
//     [N, K], K % 16 == 0, aligned rows) and the pointwise convolution
//     (1 x 1, stride 1, one group) of NHWC data as that product, written
//     NCHW.  BERT-base's four Dense products at 128 x 128 tokens are
//     bound by their operations (qkv, ffn_1, ffn_2) or bytes (proj);
//     ResNet's pointwise convolutions by the bytes of their output.
//   - `igemm_conv_wgmma`: any other convolution of NHWC data in one
//     group with a multiple of 16 channels (ResNet-50's 3 x 3 and strided
//     1 x 1 convolutions), an implicit GEMM over m = (b, oh, ow) and
//     k = (r, s, c) against OHWI weights.  Bound by bytes at stage 1.
//   - `igemm_kernel<2>`: the same convolution in several groups, on
//     mma.sync (a multiple of 16 channels a group).
//   - `igemm_kernel<1>` and `<0>`: the rest (ResNet's stem, K = 147;
//     grouped convolutions with few channels a group; dense with K % 16
//     != 0): A gathered byte by byte from NCHW data (k = (c, r, s)) or
//     from ragged rows, through registers.
//
//   The two wgmma kernels (`ws_body`) are one design for the card:
//   * Persistent: one block an SM (`persistent_grid`) walks the output
//     tiles with the columns fastest, so the tiles in flight share their
//     rows of A (read from memory about once) and read all of B (the
//     weights, at most 2.4 MB at BERT's widths), which L2 holds.
//   * Warp-specialized: a producer warpgroup keeps a ring of S stages
//     full, tracked by full and empty mbarriers, and gives its registers
//     to the two consumer warpgroups (`setmaxnreg`: 40 and 232 a
//     thread).  The consumers take the block's tiles in turns, each a
//     whole 128 x BN tile (two wgmma m64nBNk32 s8 a 32-byte K step, 2 x
//     BN / 2 accumulators a thread), keep one group of products in
//     flight and give a stage back as soon as its products have read it.
//     No block-wide barrier after the start, so the producer runs up to
//     S steps ahead across tiles.
//   * Ping-pong: the consumers also take turns on the tensor cores (two
//     named barriers): one issues its tile's products while the other
//     runs its epilogue.  The epilogue's int-to-float and float-to-bf16
//     conversions run at 16 a clock an SM, 2 x 2,048 clocks for 128 x
//     128 outputs, as long as the tile's products at K = 768; in the
//     cooperative form that this replaced (both consumers on one 128 x
//     256 tile, m64n256k32) they ran after the products, with the tensor
//     cores idle (PERF.md row 9a).
//   * Tiles: 128 x 128, so two tiles in flight cover 128 x 256 of the
//     output; the convolution takes 64 columns where O <= 64, so that
//     stage 1's O = 64 fills its tiles.  K steps of 128 bytes (128-byte
//     swizzle) where K % 128 == 0, else 64 bytes (64-byte swizzle): K =
//     64 (stage 1's pointwise convolutions) loads no half-empty box.  The
//     stages are what 208 KB leaves after the two 128 x BN x 2-byte
//     staging buffers, at most 8: 4 of 32 KB with 128-byte steps, 8 of
//     16 KB with 64-byte ones; the convolution keeps 4 (below).
//   * A: the dense kernel loads 128 x BK boxes by TMA; the convolution's
//     producer threads own one row of the tile each (an output
//     position), compute its image and window corner once a tile, and
//     copy BK bytes of k = (r, s, c) a step by cp.async into the swizzled
//     stage, zeros outside the image or past K; the copies' arrivals
//     complete the stage's barrier.  The copies go through L1
//     (cp.async.ca), and the ring stops at 4 stages so that L1 keeps the
//     rest of the SM's 256 KB (the carveout is set to what the ring
//     needs): a tile's window of input pixels stays there while its 9
//     taps read it again.  B: its (BN, BK) box by TMA.
//   * The epilogue overlaps the other consumer's products and the
//     producer's loads: the tile's per-column factors go to shared
//     memory before its products (their loads hidden by them), the
//     values into the consumer's staging buffer as 64-row boxes of 128
//     bytes in 128-byte swizzle (conflict-free), which its lead thread
//     stores by TMA in one bulk group, waited for only when the buffer
//     is written again at its next tile (4-byte outputs take two passes
//     through the buffer).  An NCHW output is a 3-D map over (position,
//     channel, image) whose tiles stay inside one image (H * W = 3,136
//     at stage 1 is 24.5 tiles); its boxes hold 128 bytes of positions
//     of 64 channels.  Where no map can be encoded (rows, or an image's
//     positions, not a multiple of 16 bytes: the classifier's N = 2,
//     ResNet's 14 x 14 and 7 x 7 stages in bf16), the launcher picks
//     direct stores from the same staging by shape, before the launch
//     (`ws_geometry`), and the tiles run over M.
//   The mma.sync forms take a 128 x 128 block tile, 64 bytes of K a step
//   in four shared-memory stages, 8 warps of 64 x 32 with
//   mma.sync.m16n8k32 s8 fragments by ldmatrix from 80-byte rows; grid.z
//   runs over the groups.  M, N and K tails are masked (zeros enter the
//   product).  Two epilogues: (i) int32 plus an int32 bias per channel
//   (the per-tensor ops), (ii) float(acc) * (x_scale * w_scale[n]) +
//   bias[n], relu, float32 or bfloat16 out (the per-channel ops), written
//   with __fmul_rn / __fadd_rn, so nvcc does not contract it into an FMA
//   and it equals the plain version bit for bit in every form (int32
//   sums are exact in any order).
//   Bound: 2*M*N*K operations at 1,979 TOP/s int8 (H100 SXM) or the
//   bytes of A, B and C at 3.35 TB/s, whichever is larger.
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
#include <string.h>

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
// the same through L1, whose line serves the next chunks of the same
// 64 bytes (the convolution's rows of C = 64 channels)
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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
// The persistent warp-specialized products on Hopper's warpgroup MMA:
// `igemm_wgmma` (the dense product and the pointwise convolution, A by
// TMA) and `igemm_conv_wgmma` (the implicit-GEMM convolution of NHWC
// data in one group, A by cp.async from the producer warpgroup).  Both
// run `ws_body`; the file's header says why each part is there.
// ---------------------------------------------------------------------
namespace ws {
constexpr int THREADS = 384;            // a producer and two consumer WGs
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BM = 128;                 // rows of a tile: two m64 products
constexpr int BOX = 64 * 128;           // a staged output box: 64 x 128 B
constexpr int BUDGET = 208 * 1024;      // ring + staging, of 227 KB
constexpr int MAX_STAGES = 8;
// The convolution's ring: 4 stages leave the rest of the SM's 256 KB to
// L1, where a tile's window of input pixels stays while its 9 taps read
// it again (cp.async.ca)
constexpr int CONV_STAGES = 4;
constexpr int TURN = 3;                 // named barriers 3, 4: the turns

// the ring's stages for a BM x BN tile of BK-byte K steps: what the
// budget leaves after the two consumers' staging buffers (128 x BN x 2
// bytes each), at most cap
__host__ __device__ constexpr int stages(int BN, int BK, int cap) {
  return (BUDGET - 4 * BN * 128) / ((BM + BN) * BK) < cap
             ? (BUDGET - 4 * BN * 128) / ((BM + BN) * BK)
             : cap;
}
// the ring, the two staging buffers, the two consumers' per-column
// factors (2 x BN floats each) and the alignment slack
__host__ __device__ constexpr int smem_bytes(int BN, int BK, int S) {
  return S * (BM + BN) * BK + 4 * BN * 128 + 16 * BN + 1024;
}
}  // namespace ws

struct WsMaps {
  CUtensorMap a, b, out;    // a unused by the convolution
};

struct WsGeo {
  int M, N, K;              // the product: rows, columns, depth
  int ohw;                  // NCHW output: positions an image; 0: [M, N]
  int tpi;                  // m tiles an image (tiles inside one image);
                            // 0: tiles over the rows of M
  int tiles_m, tiles_n;
  int tma_store;            // 1: TMA stores; 0: direct stores
};

// A wgmma descriptor of a K-major tile of BK-byte rows in BK-byte
// swizzle: 8-row groups 8 * BK bytes apart (the stride offset); the
// leading offset is not read for a swizzled K-major operand.
template <int BK>
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile) {
  if (BK == 128) return sw128_desc(tile);
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (32ull << 32) | (2ull << 62);
}

// byte offset of 16-byte chunk j of row r of a BK-byte-row tile in
// BK-byte swizzle, as TMA writes it and wgmma reads it
template <int BK>
__device__ __forceinline__ int kmajor_at(int r, int j) {
  return r * BK + ((j ^ (BK == 128 ? (r & 7) : ((r >> 1) & 3))) << 4);
}

// byte `byte` of row r of a staged output box (128-byte rows, 128-byte
// swizzle, as a TMA store reads it)
__device__ __forceinline__ int box_at(int r, int byte) {
  return r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
}

// acc (64 x BN per warpgroup, s32) += A·Bᵀ over k = 32 bytes
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, 1;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
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
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// the fused epilogue (ii) of one value, sc = x_scale * w_scale[o], b =
// bias[o]: the operations and their order of `epilogue_f`
__device__ __forceinline__ float epi_f(int acc, float sc, bool has_bias,
                                       float b, bool relu) {
  float f = __fmul_rn(__int2float_rn(acc), sc);
  if (has_bias) f = __fadd_rn(f, b);
  if (relu) f = fmaxf(f, 0.f);
  return f;
}

// A tile's per-column factors in shared memory, written by the consumer
// warpgroup before the tile's products (so their loads overlap them):
// fac[j] = x_scale * w_scale[n] (or the int32 bias's bits) and fac[BN +
// j] = bias[n] of column n = n0 + j, clamped to N - 1
template <int BN>
__device__ __forceinline__ void ws_factors(float* fac, const Epi& e,
                                           float xs, int n0, int N,
                                           int ctid) {
  for (int j = ctid; j < BN; j += 128) {
    const int n = min(n0 + j, N - 1);
    if (e.kind == 0) {
      fac[j] = __int_as_float(e.bias_i32 ? e.bias_i32[n] : 0);
    } else {
      fac[j] = __fmul_rn(xs, e.w_scale[n]);
      fac[BN + j] = e.bias_f ? e.bias_f[n] : 0.f;
    }
  }
}

// two values rounded to bfloat16 by one instruction (cvt.rn.bf16x2.f32),
// a in the low half
__device__ __forceinline__ unsigned bf16x2_bits(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&p);
}

// tile t of the walk: columns fastest, so the tiles in flight at once
// share their rows of A and read all of B, which L2 holds
template <int BN>
__device__ __forceinline__ void ws_tile(const WsGeo& g, int t, int& m0,
                                        int& rows, int& n0, int& img,
                                        int& pos0) {
  const int mt = t / g.tiles_n;
  n0 = (t - mt * g.tiles_n) * BN;
  if (g.tpi) {
    img = mt / g.tpi;
    pos0 = (mt - img * g.tpi) * ws::BM;
    m0 = img * g.ohw + pos0;
    rows = min(ws::BM, g.ohw - pos0);
  } else {
    img = pos0 = 0;
    m0 = mt * ws::BM;
    rows = min(ws::BM, g.M - m0);
  }
}

// The epilogue's values of one consumer thread's accumulators, in
// place: acc[4i + 2h + e] (row lr0 + 8h, column 8i + 2t + e) becomes the
// output's bits (int32, float32, or bfloat16 in the low half), from the
// tile's factors `fac` (`ws_factors`).  One loop a kind, every index
// static, so that the accumulators stay in registers.  The int-to-float
// and float-to-bf16 conversions run at 16 a clock an SM, as fast as a
// tile's products at K = 768: a bf16 pair takes one conversion.
template <int BN>
__device__ __forceinline__ void ws_values(int (&acc)[BN / 2], const Epi& e,
                                          const float* fac, int t4) {
  if (e.kind == 0) {
    if (!e.bias_i32) return;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 b = *reinterpret_cast<const float2*>(fac + 8 * i + 2 * t4);
      const unsigned ba = __float_as_uint(b.x), bb = __float_as_uint(b.y);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * i + 2 * h] = (int)((unsigned)acc[4 * i + 2 * h] + ba);
        acc[4 * i + 2 * h + 1] = (int)((unsigned)acc[4 * i + 2 * h + 1] + bb);
      }
    }
    return;
  }
  const bool bf16 = e.kind == 2, has_bias = e.bias_f != nullptr;
  const bool relu = e.relu != 0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const float2 sc = *reinterpret_cast<const float2*>(fac + 8 * i + 2 * t4);
    const float2 b =
        *reinterpret_cast<const float2*>(fac + BN + 8 * i + 2 * t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float fa = epi_f(acc[4 * i + 2 * h], sc.x, has_bias, b.x, relu);
      const float fb =
          epi_f(acc[4 * i + 2 * h + 1], sc.y, has_bias, b.y, relu);
      if (bf16) {                       // the pair in both, halves apart
        const unsigned pk = bf16x2_bits(fa, fb);
        acc[4 * i + 2 * h] = (int)pk;
        acc[4 * i + 2 * h + 1] = (int)(pk >> 16);
      } else {
        acc[4 * i + 2 * h] = (int)__float_as_uint(fa);
        acc[4 * i + 2 * h + 1] = (int)__float_as_uint(fb);
      }
    }
  }
}

// One 64-row half of a consumer's tile (`ws_values`'s bits) written into
// its staging half `buf` as 64 x 128-byte boxes in 128-byte swizzle
// (conflict-free).  A row-major output's box b holds 128 bytes of
// columns of the 64 rows; an NCHW one's box b holds 128 bytes of
// positions of 64 channels.  A 4-byte output takes two passes, its
// columns (or positions) split in halves; this writes pass `pass`.
template <int BN>
__device__ __forceinline__ void ws_stage(const int (&acc)[BN / 2],
                                         unsigned char* buf, int es,
                                         bool nchw, int pass, int lr0,
                                         int t4) {
  const int per = 128 / es;             // values in a box row
  if (!nchw && es == 2) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * i + 2 * t4, r = lr0 + 8 * h;
        *reinterpret_cast<unsigned*>(buf + (col >> 6) * ws::BOX +
                                     box_at(r, (col & 63) * 2)) =
            (unsigned)acc[4 * i + 2 * h];   // the bf16 pair (ws_values)
      }
  } else if (!nchw) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int cp = 8 * i + 2 * t4 - pass * (BN / 2);
      if (cp >= 0 && cp < BN / 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint2*>(buf + (cp >> 5) * ws::BOX +
                                    box_at(lr0 + 8 * h, (cp & 31) * 4)) =
              make_uint2((unsigned)acc[4 * i + 2 * h],
                         (unsigned)acc[4 * i + 2 * h + 1]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rp = lr0 + 8 * h - pass * per;
        if (rp >= 0 && rp < per) {
          const int ch = 8 * i + 2 * t4;
          unsigned char* d0 =
              buf + (ch >> 6) * ws::BOX + box_at(ch & 63, rp * es);
          unsigned char* d1 =
              buf + (ch >> 6) * ws::BOX + box_at((ch + 1) & 63, rp * es);
          if (es == 2) {
            *reinterpret_cast<unsigned short*>(d0) =
                (unsigned short)acc[4 * i + 2 * h];
            *reinterpret_cast<unsigned short*>(d1) =
                (unsigned short)acc[4 * i + 2 * h + 1];
          } else {
            *reinterpret_cast<int*>(d0) = acc[4 * i + 2 * h];
            *reinterpret_cast<int*>(d1) = acc[4 * i + 2 * h + 1];
          }
        }
      }
  }
}

// A consumer's 128 x BN tile staged half by half in its buffer `stg`
// (half hf at stg + hf * BN * 128), then stored by TMA (the lead thread,
// in one bulk group, waited for only when the buffer is written again
// at the consumer's next tile) or by direct stores.
template <int BN>
__device__ __forceinline__ void ws_epilogue(
    const int (&acc)[2][BN / 2], unsigned char* stg,
    const CUtensorMap* omap, void* out, const WsGeo& g, int es, int m0,
    int n0, int img, int pos0, int bar, int ctid, bool lead) {
  const int passes = es / 2;
  const int per = 128 / es;
  const bool nchw = g.ohw > 0;
  const int lr0 = 16 * (ctid >> 5) + ((ctid & 31) >> 2);
  for (int pass = 0; pass < passes; ++pass) {
    if (lead) bulk_wait_read<0>();      // the last stores read the buffer
    warpgroup_sync(bar);                // and the direct stores did
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      ws_stage<BN>(acc[hf], stg + hf * BN * 128, es, nchw, pass, lr0,
                   ctid & 3);
    fence_async_smem();
    warpgroup_sync(bar);                // the pass is staged
    if (g.tma_store) {
      if (lead) {
        for (int hf = 0; hf < 2; ++hf)
          for (int b = 0; b < BN / 64; ++b) {
            unsigned char* box = stg + hf * BN * 128 + b * ws::BOX;
            if (!nchw) {
              const int n = n0 + pass * (BN / 2) + b * per;
              if (n < g.N && m0 + 64 * hf < g.M)
                tma_store(omap, box, n, m0 + 64 * hf, 0);
            } else if (n0 + 64 * b < g.N && pos0 + 64 * hf < g.ohw) {
              tma_store(omap, box, pos0 + 64 * hf + pass * per,
                        n0 + 64 * b, img);
            }
          }
        bulk_commit();
      }
      continue;
    }
    // direct stores: the staged values read back as the TMA store would
    unsigned char* o = static_cast<unsigned char*>(out);
    const int sh = es == 2 ? 6 : 5;     // log2(per)
    if (!nchw) {
      // row by row, consecutive threads on consecutive columns
      const int cols = BN * 2 / es;     // the columns of this pass
      for (int r = 0; r < 128 && m0 + r < g.M; ++r)
        for (int cp = ctid; cp < cols; cp += 128) {
          const int n = n0 + pass * (BN / 2) + cp;
          if (n >= g.N) break;
          const unsigned char* src = stg + (r >> 6) * BN * 128 +
                                     (cp >> sh) * ws::BOX +
                                     box_at(r & 63, (cp & (per - 1)) * es);
          unsigned char* d = o + ((long long)(m0 + r) * g.N + n) * es;
          if (es == 4)
            *reinterpret_cast<unsigned*>(d) =
                *reinterpret_cast<const unsigned*>(src);
          else
            *reinterpret_cast<unsigned short*>(d) =
                *reinterpret_cast<const unsigned short*>(src);
        }
    } else if (((ctid & 63) >> sh) == pass) {
      // each thread one row of the tile (an output position, its image
      // found once), every channel; consecutive threads on consecutive
      // positions of a channel
      const int r = ctid;
      int im = img, pos = pos0 + r;
      bool ok = pos < g.ohw;
      if (!g.tpi) {
        ok = m0 + r < g.M;
        im = (m0 + r) / g.ohw;
        pos = m0 + r - im * g.ohw;
      }
      if (ok) {
        const unsigned char* sb = stg + (r >> 6) * BN * 128;
        const int byte = ((r & 63) - pass * per) * es;
        unsigned char* d =
            o + (((long long)im * g.N + n0) * g.ohw + pos) * es;
        const long long step = (long long)g.ohw * es;
        const int nch = min(BN, g.N - n0);
        for (int ch = 0; ch < nch; ++ch, d += step) {
          const unsigned char* src =
              sb + (ch >> 6) * ws::BOX + box_at(ch & 63, byte);
          if (es == 4)
            *reinterpret_cast<unsigned*>(d) =
                *reinterpret_cast<const unsigned*>(src);
          else
            *reinterpret_cast<unsigned short*>(d) =
                *reinterpret_cast<const unsigned short*>(src);
        }
      }
    }
  }
}

// The producer of the convolution: each of the warpgroup's 128 threads
// owns one row of every A tile (an output position), computes its
// image, ih0 and iw0 once a tile, and copies its BK bytes of k = (r, s,
// c) a step by cp.async into the swizzled stage, zeros outside the
// image or past K; their arrival on the stage's full barrier fires when
// the copies land.  Thread 0 brings B's tile by TMA.
template <int BN, int BK, int S>
__device__ __forceinline__ void ws_produce_conv(
    const WsMaps& maps, const WsGeo& g, const Conv& cv, const int8_t* x,
    unsigned char* ring, uint64_t* full, uint64_t* empty) {
  constexpr int A_TILE = ws::BM * BK, STAGE = (ws::BM + BN) * BK;
  const int r = threadIdx.x;
  const int tiles = g.tiles_m * g.tiles_n;
  const int nk = (g.K + BK - 1) / BK;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, rows, n0, img, pos0;
    ws_tile<BN>(g, t, m0, rows, n0, img, pos0);
    const bool valid = r < rows;
    const int8_t* base = x;
    int ih0 = 0, iw0 = 0;
    if (valid) {
      int im = img, p = pos0 + r;
      if (!g.tpi) {
        const int m = m0 + r;
        im = m / g.ohw;
        p = m - im * g.ohw;
      }
      const int oh = p / cv.OW, ow = p - oh * cv.OW;
      ih0 = oh * cv.sh - cv.ph;
      iw0 = ow * cv.sw - cv.pw;
      base = x + (long long)im * cv.H * cv.W * cv.C;
    }
    int c = 0, sx = 0, ry = 0;          // the tap and channel of k
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % S;
      unsigned char* st = ring + s * STAGE;
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
      if (r == 0) {
        mbar_expect_tx(&full[s], BN * BK);
        tma_load(st + A_TILE, &maps.b, &full[s], kt * BK, n0, 0);
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int ih = ih0 + ry * cv.dh, iw = iw0 + sx * cv.dw;
        const bool ok = valid && ry < cv.kh && (unsigned)ih < (unsigned)cv.H &&
                        (unsigned)iw < (unsigned)cv.W;
        cp_async16_ca(st + kmajor_at<BK>(r, j),
                      ok ? base + ((long long)ih * cv.W + iw) * cv.C + c : x,
                      ok);
        c += 16;
        if (c == cv.C) {
          c = 0;
          if (++sx == cv.kw) {
            sx = 0;
            ++ry;
          }
        }
      }
      mbar_arrive_cp_async(&full[s]);
    }
  }
}

// The persistent block: a producer warpgroup keeps the ring of S stages
// full (its registers given to the consumers); two consumer warpgroups
// take the block's tiles in turns (consumer c the tiles c, c + 2, ...),
// each a whole 128 x BN tile (two m64 products a K step), with one group
// of products in flight, giving each stage back on its empty barrier as
// soon as its products have read it.  They also take turns on the
// tensor cores (named barriers TURN, TURN + 1): a consumer issues its
// tile's products only in its turn, and hands the turn on once they are
// issued, so that its epilogue runs while the other consumer's products
// do.  No block-wide barrier after the start.
template <bool CONV, int BN, int BK, int S>
__device__ __forceinline__ void ws_body(const WsMaps& maps, const WsGeo& g,
                                        const Conv& cv, const int8_t* x,
                                        void* out, const Epi& e,
                                        unsigned char* raw, uint64_t* full,
                                        uint64_t* empty) {
  constexpr int A_TILE = ws::BM * BK, STAGE = (ws::BM + BN) * BK;
  unsigned char* ring = smem_align1024(raw);
  unsigned char* staging = ring + S * STAGE;
  const int tid = threadIdx.x;
  const int tiles = g.tiles_m * g.tiles_n;
  const int nk = (g.K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], CONV ? 1 + 128 : 1);  // B's TMA (+ A's rows)
      mbar_init(&empty[s], 1);                  // its consumer's lead
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        ws::PRODUCER_REGS));
    if constexpr (CONV) {
      ws_produce_conv<BN, BK, S>(maps, g, cv, x, ring, full, empty);
    } else if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, rows, n0, img, pos0;
        ws_tile<BN>(g, t, m0, rows, n0, img, pos0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S;
          unsigned char* st = ring + s * STAGE;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE);
          tma_load(st, &maps.a, &full[s], kt * BK, m0, 0);
          tma_load(st + A_TILE, &maps.b, &full[s], kt * BK, n0, 0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      ws::CONSUMER_REGS));
  const int c = tid / 128 - 1, ctid = tid & 127;
  const bool lead = ctid == 0;
  unsigned char* stg = staging + c * 2 * BN * 128;
  float* fac = reinterpret_cast<float*>(staging + 4 * BN * 128) + c * 2 * BN;
  const float xs = e.kind != 0 ? *e.x_scale : 0.f;
  int acc[2][BN / 2];
  if (c == 1) pair_arrive(ws::TURN);    // consumer 0 takes the first turn
  int j = c;                            // the block's tile j = c, c + 2, ...
  for (int t = blockIdx.x + c * gridDim.x; t < tiles;
       t += 2 * gridDim.x, j += 2) {
    int m0, rows, n0, img, pos0;
    ws_tile<BN>(g, t, m0, rows, n0, img, pos0);
    // (the last tile's factors were read before its staging barrier)
    ws_factors<BN>(fac, e, xs, n0, g.N, ctid);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[hf][i] = 0;
    pair_sync(ws::TURN + c);            // this consumer's turn
    for (int kt = 0; kt < nk; ++kt) {
      const int it = j * nk + kt, s = it % S;
      unsigned char* st = ring + s * STAGE;
      mbar_wait(&full[s], (it / S) & 1);
      if (CONV) fence_async_smem();     // A's cp.async bytes, to wgmma
      const uint64_t da0 = kmajor_desc<BK>(st);
      const uint64_t da1 = kmajor_desc<BK>(st + 64 * BK);
      const uint64_t db = kmajor_desc<BK>(st + A_TILE);
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        wgmma_s8<BN>(acc[0], da0 + 2 * kk, db + 2 * kk);
        wgmma_s8<BN>(acc[1], da1 + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();                  // step kt - 1's products are done
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (kt > 0 && lead) mbar_arrive(&empty[(it - 1) % S]);
    }
    pair_arrive(ws::TURN + (c ^ 1));    // the other consumer's turn
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (nk > 0 && lead) mbar_arrive(&empty[(j * nk + nk - 1) % S]);
    warpgroup_sync(1 + c);              // the tile's factors are written
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) ws_values<BN>(acc[hf], e, fac, ctid & 3);
    ws_epilogue<BN>(acc, stg, &maps.out, out, g, e.kind == 2 ? 2 : 4, m0,
                    n0, img, pos0, 1 + c, ctid, lead);
  }
  // the turn that the block's last tile handed on, taken by its consumer
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (c == (mine & 1)) pair_sync(ws::TURN + c);
  if (lead) bulk_wait_all();
}

template <int BN, int BK>
__global__ void __launch_bounds__(ws::THREADS, 1)
    igemm_wgmma(const __grid_constant__ WsMaps maps, const WsGeo g,
                void* __restrict__ out, const Epi e) {
  extern __shared__ unsigned char ws_dense_raw[];
  constexpr int S = ws::stages(BN, BK, ws::MAX_STAGES);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  ws_body<false, BN, BK, S>(maps, g, Conv{}, nullptr, out, e, ws_dense_raw,
                         full, empty);
}

template <int BN>
__global__ void __launch_bounds__(ws::THREADS, 1)
    igemm_conv_wgmma(const __grid_constant__ WsMaps maps, const WsGeo g,
                     const Conv cv, const int8_t* __restrict__ x,
                     void* __restrict__ out, const Epi e) {
  extern __shared__ unsigned char ws_conv_raw[];
  constexpr int S = ws::stages(BN, 128, ws::CONV_STAGES);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  ws_body<true, BN, 128, S>(maps, g, cv, x, out, e, ws_conv_raw, full, empty);
}

// A map of an int8 (rows, K) K-major matrix read as (1, box_rows, BK)
// boxes in BK-byte swizzle (rows and columns past the edges arrive as
// 0).
static bool encode_s8(EncodeTiledFn fn, CUtensorMap* map, const void* base,
                      long long K, long long rows, int bk, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)(K * rows)};
  const cuuint32_t box[3] = {(cuuint32_t)bk, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of the output, (d0, d1, d2) values of es bytes with d0
// contiguous, written as (1, 64, 128 / es) boxes in 128-byte swizzle.
static bool encode_out(EncodeTiledFn fn, CUtensorMap* map, void* base,
                       int es, long long d0, long long d1, long long d2) {
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * es),
                                 (cuuint64_t)(d0 * d1 * es)};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                         : CU_TENSOR_MAP_DATA_TYPE_UINT32,
            3, base, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The output's route, by shape before the launch: by TMA where each of
// its rows (a row-major output's N values, an NCHW output's H * W
// positions of one channel) is a multiple of 16 bytes and it starts
// 16-byte aligned, the forms a tensor map can encode; by direct stores
// otherwise (the classifier's N = 2 in bf16, ResNet-50's 14 x 14 and
// 7 x 7 stages in bf16).  An NCHW output stored by TMA is tiled inside
// each image, so that no box crosses one; else the tiles run over M.
static int ws_geometry(WsGeo& g, const void* out, int es, int M, int N,
                       int K, int ohw, int bn) {
  g.M = M;
  g.N = N;
  g.K = K;
  g.ohw = ohw;
  const long long row = ohw > 0 ? ohw : N;
  g.tma_store = row * es % 16 == 0 &&
                (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  g.tpi = ohw > 0 && g.tma_store ? (ohw + ws::BM - 1) / ws::BM : 0;
  g.tiles_m = g.tpi ? M / ohw * g.tpi : (M + ws::BM - 1) / ws::BM;
  g.tiles_n = (N + bn - 1) / bn;
  return g.tiles_m * g.tiles_n;
}

static bool ws_out_map(EncodeTiledFn fn, CUtensorMap* map, void* out,
                       const WsGeo& g, int es) {
  if (!g.tma_store) return true;
  return g.ohw > 0 ? encode_out(fn, map, out, es, g.ohw, g.N, g.M / g.ohw)
                   : encode_out(fn, map, out, es, g.N, g.M, 1);
}

// the dense product (ohw = 0) or the pointwise convolution written NCHW
// (ohw = H * W); cudaErrorInvalidValue where a tensor map cannot be
// encoded
template <int BN, int BK>
int launch_wgmma(const void* x, const void* w, void* out, int M, int N,
                 int K, int ohw, Epi e, cudaStream_t st) {
  constexpr int SMEM =
      ws::smem_bytes(BN, BK, ws::stages(BN, BK, ws::MAX_STAGES));
  EncodeTiledFn fn = encode_tiled();
  const int es = e.kind == 2 ? 2 : 4;
  WsGeo g;
  const int tiles = ws_geometry(g, out, es, M, N, K, ohw, BN);
  WsMaps maps;
  if (!fn || !encode_s8(fn, &maps.a, x, K, M, BK, ws::BM) ||
      !encode_s8(fn, &maps.b, w, K, N, BK, BN) ||
      !ws_out_map(fn, &maps.out, out, g, es))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        igemm_wgmma<BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  igemm_wgmma<BN, BK><<<persistent_grid(tiles), ws::THREADS,
                        SMEM, st>>>(maps, g, out, e);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles (two in flight a block, one a consumer: 128 x 256 of
// the output where N >= 256); 128-byte K steps where K is a multiple of
// 128, else 64-byte ones, so that K = 64 loads no half-empty box
int launch_dense(const void* x, const void* w, void* out, int M, int N,
                 int K, int ohw, Epi e, cudaStream_t st) {
  return K % 128 == 0
             ? launch_wgmma<128, 128>(x, w, out, M, N, K, ohw, e, st)
             : launch_wgmma<128, 64>(x, w, out, M, N, K, ohw, e, st);
}

template <int BN>
int launch_conv_wgmma(const void* x, const void* w, void* out, int M, int N,
                      int K, Conv cv, Epi e, cudaStream_t st) {
  constexpr int SMEM =
      ws::smem_bytes(BN, 128, ws::stages(BN, 128, ws::CONV_STAGES));
  EncodeTiledFn fn = encode_tiled();
  const int es = e.kind == 2 ? 2 : 4;
  WsGeo g;
  const int tiles = ws_geometry(g, out, es, M, N, K, cv.OH * cv.OW, BN);
  WsMaps maps;
  memset(&maps.a, 0, sizeof(maps.a));
  if (!fn || !encode_s8(fn, &maps.b, w, K, N, 128, BN) ||
      !ws_out_map(fn, &maps.out, out, g, es))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    // shared memory as the ring needs it, the rest of the SM's to L1
    cudaError_t err = cudaFuncSetAttribute(
        igemm_conv_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          igemm_conv_wgmma<BN>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (SMEM * 100 + 228 * 1024 - 1) / (228 * 1024));
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  igemm_conv_wgmma<BN><<<persistent_grid(tiles), ws::THREADS, SMEM,
                         st>>>(
      maps, g, cv, static_cast<const int8_t*>(x), out, e);
  return (int)cudaGetLastError();
}

// the tile's width from O: 64 or 128 columns, so that stage 1's O = 64
// fills its tiles
int launch_conv(const void* x, const void* w, void* out, int M, int N,
                int K, Conv cv, Epi e, cudaStream_t st) {
  if (N <= 64) return launch_conv_wgmma<64>(x, w, out, M, N, K, cv, e, st);
  return launch_conv_wgmma<128>(x, w, out, M, N, K, cv, e, st);
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

// The device kernels of int8_igemm, in the order of `IGEMM_FORMS` in
// ops/quantized.py.  The wrapper names the form by shape, before the
// launch (`igemm_form`); an entry launches that kernel or refuses a
// shape the form cannot take with cudaErrorInvalidValue, and chooses no
// other kernel itself (only the tile width within a form: launch_dense,
// launch_conv).
enum IgemmForm {
  kWgmma = 0,       // igemm_wgmma: Dense, pointwise (K % 16, TMA rows)
  kConvWgmma = 1,   // igemm_conv_wgmma: one-group NHWC convolution
  kNhwcGroups = 2,  // igemm_kernel<2>: NHWC, channels a group % 16
  kGather = 3,      // igemm_kernel<1>: convolution, bytes gathered
  kRagged = 4,      // igemm_kernel<0>: dense, bytes gathered
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

Epi make_epi(int kind, const void* bias_i32, const void* bias_f,
             const void* x_scale, const void* w_scale, int relu) {
  return Epi{kind, static_cast<const int*>(bias_i32),
             static_cast<const float*>(bias_f),
             static_cast<const float*>(x_scale),
             static_cast<const float*>(w_scale), relu};
}

}  // namespace

extern "C" {

// x [M, K] against w [N, K] on `form` kWgmma (16-byte rows for TMA) or
// kRagged
int int8_igemm_dense(const void* x, const void* w, void* out, int M, int N,
                     int K, int kind, const void* bias_i32,
                     const void* bias_f, const void* x_scale,
                     const void* w_scale, int relu, int form, void* stream) {
  Epi e = make_epi(kind, bias_i32, bias_f, x_scale, w_scale, relu);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == kWgmma) {
    if (K % 16 || !aligned16(x) || !aligned16(w))
      return (int)cudaErrorInvalidValue;
    return launch_dense(x, w, out, M, N, K, 0, e, st);
  }
  if (form != kRagged) return (int)cudaErrorInvalidValue;
  Conv cv{};
  return launch_igemm<0>(x, w, out, M, N, K, 1, cv, e, 0, st);
}

// A pointwise convolution (1 x 1, stride 1, no padding, one group) of
// NHWC data on kWgmma, as the dense product of x [B*H*W, C] and w [O, C]
// written NCHW (ohw = H * W); C % 16 == 0 and aligned rows.
int int8_igemm_pointwise(const void* x, const void* w, void* out, int M,
                         int N, int K, int ohw, int kind,
                         const void* bias_i32, const void* bias_f,
                         const void* x_scale, const void* w_scale, int relu,
                         void* stream) {
  if (K % 16 || ohw <= 0 || M % ohw || !aligned16(x) || !aligned16(w))
    return (int)cudaErrorInvalidValue;
  return launch_dense(x, w, out, M, N, K, ohw,
                      make_epi(kind, bias_i32, bias_f, x_scale, w_scale,
                               relu),
                      static_cast<cudaStream_t>(stream));
}

// The convolution on `form`: kConvWgmma (one group) and kNhwcGroups take
// x NHWC and w OHWI with a multiple of 16 channels a group, kGather x
// NCHW and w OIHW.
int int8_igemm_conv(const void* x, const void* w, void* out, int B, int C,
                    int H, int W, int O, int groups, int kh, int kw, int sh,
                    int sw, int ph, int pw, int dh, int dw, int OH, int OW,
                    int kind, const void* bias_i32, const void* bias_f,
                    const void* x_scale, const void* w_scale, int relu,
                    int form, void* stream) {
  Epi e = make_epi(kind, bias_i32, bias_f, x_scale, w_scale, relu);
  int Cg = C / groups;
  Conv cv{C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, OH, OW, Cg, O};
  int M = B * OH * OW, N = O / groups, K = Cg * kh * kw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool nhwc = Cg % 16 == 0 && aligned16(x) && aligned16(w);
  switch (form) {
    case kConvWgmma:
      if (groups != 1 || !nhwc) return (int)cudaErrorInvalidValue;
      return launch_conv(x, w, out, M, N, K, cv, e, st);
    case kNhwcGroups:
      if (!nhwc) return (int)cudaErrorInvalidValue;
      return launch_igemm<2>(x, w, out, M, N, K, groups, cv, e, 1, st);
    case kGather:
      return launch_igemm<1>(x, w, out, M, N, K, groups, cv, e,
                             K % 16 == 0 && aligned16(w), st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
