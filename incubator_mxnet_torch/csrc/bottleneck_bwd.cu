// Two-pass backward of y = BN_train(x @ W) for a ResNet 1x1 convolution,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of tools/pallas_bottleneck_bwd.py, both
// launched by `pallas_bwd` (:143):
//   * `_reduce_kernel` (:83):  z = x·W recomputed tile by tile (never read
//     from memory), zh = (z − m)·inv, s1 = Σ_rows dy, s2 = Σ_rows dy·zh;
//   * `_apply_kernel` (:110):  dz = (g·inv)·(dy − s1/n − zh·s2/n) rounded
//     to bf16, dx = dz·Wᵀ (bf16), dW = Σ_rows xᵀ·dz (f32).
// x (M, C), W (C, K), dy (M, K) are bf16 row-major; m, inv, g (K) f32;
// n = M.  dz never leaves the SM.
//
// Design.
//   * Tiles of 64 rows x 64 columns, 4 warps of mma.sync.m16n8k16 (bf16
//     in, f32 accumulators), warp w owning rows 16w..16w+15 of each
//     product.  z for a (row tile, K tile) is accumulated over C in
//     64-wide chunks of x and W staged with cp.async, double-buffered.
//     W (C·K·2 bytes) is never held whole: above 64↔256 it would not fit
//     shared memory, so every product walks K (and C) tile by tile.
//   * The TPU grid walked the row tiles in order into VMEM accumulators.
//     Here blocks run in parallel: the blocks of one group g walk row
//     tiles g, g + G, g + 2G, ... and write their sums to a partial
//     buffer, one slot per group; `sum_partials` then adds the G slots in
//     a fixed order.  No float atomics, so results are deterministic for
//     a given G, which the host picks so that every block of a launch is
//     resident at once: the blocks of one group then read the same x and
//     dy tiles at about the same time, and the second read comes from L2.
//   * Pass 1 (`bnb_reduce`): block (kt, g) owns K tile kt.
//   * Pass 2 (`bnb_apply`): two kinds of block in one launch.  Block
//     (ct·nK + j, g) writes dx[rows, ct] = Σ_kt dz[rows, kt]·W[ct, kt]ᵀ
//     for the row tiles g + G·j, g + G·j + G·nK, ..., recomputing z and dz
//     for every K tile; block (nC·nK + ct·nK + kt, g) accumulates
//     dW[ct, kt] += x[rows, ct]ᵀ·dz[rows, kt] over the row tiles g, g + G,
//     ....  A dx block walks nK times fewer rows than a dW block and does
//     nK times the work on each, so every block of the launch does the
//     same number of tile steps.  Both recompute z over all of C, so z is
//     computed 2·C/64 times per pass (twice at the stage-1 shape, C = 64).
//   * Ragged M, C and K: rows of x and dy past M, and columns past C or K,
//     are staged as zeros, and m, inv, g as zeros past K.  A zero row adds
//     nothing to s1, s2 (dy = 0) or dW (x = 0); dx is stored only for rows
//     < M and columns < C.  The TPU kernel ran M // bm tiles and left the
//     tail rows out; this one covers every row.
//
// Bound on an H100 SXM at ResNet-50 stage 1 (M = 256·56·56 = 802,816,
// C = 64, K = 256): pass 1 reads dy and x, 514 MB, 0.153 ms at 3.35 TB/s;
// pass 2 reads dy and x and writes dx, 617 MB, 0.184 ms.  Their products
// take 0.027 and 0.080 ms at 989 TFLOP/s, so both are bound by memory.
// This design reads dy and x from memory about once per pass when L2
// serves the groups' repeated reads; TMA, wgmma and one block covering
// several K tiles are later work.
#include "flash_common.cuh"

namespace {

constexpr int TM = 64;               // rows of a tile
constexpr int TN = 64;               // columns of a tile (K, or C for dx)
constexpr int TC = 64;               // C chunk of the z product
constexpr int LDS = 72;              // padded shared row: 144 bytes
constexpr int NTHR = 128;            // 4 warps
constexpr int TILE = TM * LDS;       // elements of one staged tile

// Column parameters of one K tile, in shared memory.
struct ColParams {
  float m[TN], inv[TN], a[TN], s1n[TN], s2[TN];
};

constexpr size_t REDUCE_SMEM = 5 * TILE * sizeof(bf16) + sizeof(ColParams);
constexpr size_t APPLY_SMEM = 7 * TILE * sizeof(bf16) + sizeof(ColParams);

// A 64 x 64 tile of a row-major (rows, cols) bf16 matrix with leading
// dimension ld, from (r0, c0), into a padded shared tile; cells past
// (rows, cols) are zeros.  cols and ld are multiples of 8.
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long ld,
                                      long long r0, int rows, int c0,
                                      int cols, int tid) {
  for (int i = tid; i < TM * 8; i += NTHR) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = r0 + r < rows && c0 + c < cols;
    const bf16* p = ok ? src + (size_t)(r0 + r) * ld + c0 + c : src;
    cp_async16(dst + r * LDS + c, p, ok);
  }
}

// A fragment (m16 x k16) of Xᵀ from X row-major [k][LDS] in shared
// memory: rows k0.., columns m0...  ldmatrix.trans hands each lane the
// transposed 8 x 8 blocks (k0 + i, m0) (k0 + i, m0 + 8) (k0 + 8 + i, m0)
// (k0 + 8 + i, m0 + 8), which are a0..a3.
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const bf16* x,
                                             int k0, int m0, int lane) {
  const int i = lane & 7, mat = lane >> 3;
  ldsm_x4_trans(a, x + (k0 + i + 8 * (mat >> 1)) * LDS + m0 + 8 * (mat & 1));
}

// acc[nt] += A · Yᵀ over a 64-wide k, Y row-major [n][LDS] (n = 8nt + g).
__device__ __forceinline__ void mma_abt_acc(float (&acc)[8][4],
                                            const uint32_t (&a)[4][4],
                                            const bf16* y, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* p = y + (nt * 8 + g) * LDS + kk * 16 + 2 * t;
      mma_bf16(acc[nt], a[kk], ld32(p), ld32(p + 8));
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

struct Geo {
  int M, C, K, nM, nC, nK, G;
};

// z[rows of row tile rt][K tile kt] = x·W over all of C, into acc (warp
// w's rows 16w.., columns 8nt + 2t + {0, 1}).  Loads already issued by
// the caller complete with the last chunk's; on return every staged
// tile is visible to the block, and xs/ws may be overwritten after the
// caller's next __syncthreads.
__device__ void z_tile(float (&acc)[8][4], const bf16* x, const bf16* w,
                       long long rt, int kt, const Geo& geo, bf16* xs,
                       bf16* ws, int tid, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int n_chunks = (geo.C + TC - 1) / TC;
  zero(acc);
  stage(xs, x, geo.C, rt * TM, geo.M, 0, geo.C, tid);
  stage(ws, w, geo.K, 0, geo.C, kt * TN, geo.K, tid);
  cp_async_commit();
  for (int cc = 0; cc < n_chunks; ++cc) {
    const int buf = cc & 1;
    if (cc + 1 < n_chunks) {
      stage(xs + (buf ^ 1) * TILE, x, geo.C, rt * TM, geo.M, (cc + 1) * TC,
            geo.C, tid);
      stage(ws + (buf ^ 1) * TILE, w, geo.K, (long long)(cc + 1) * TC, geo.C,
            kt * TN, geo.K, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      load_a(a[kk], xs + buf * TILE, warp * 16 + g, LDS, kk, t);
    mma_ab<4>(acc, a, ws + buf * TILE, LDS, lane);
    __syncthreads();
  }
}

// The column parameters of K tile kt (zeros past K).  s1, s2, g are null
// in pass 1.
__device__ __forceinline__ void load_cols(ColParams& cp, const float* m,
                                          const float* inv, const float* gam,
                                          const float* s1, const float* s2,
                                          int kt, const Geo& geo, int tid) {
  for (int c = tid; c < TN; c += NTHR) {
    const int k = kt * TN + c;
    const bool ok = k < geo.K;
    cp.m[c] = ok ? m[k] : 0.f;
    cp.inv[c] = ok ? inv[k] : 0.f;
    if (gam != nullptr) {
      cp.a[c] = ok ? gam[k] * inv[k] : 0.f;
      cp.s1n[c] = ok ? s1[k] / (float)geo.M : 0.f;
      cp.s2[c] = ok ? s2[k] : 0.f;
    }
  }
}

// dz = a·(dy − s1/n − zh·s2/n) of this warp's rows of the tile, rounded
// to bf16 into dzs (the TPU kernel's `dzb`).
__device__ __forceinline__ void form_dz(bf16* dzs, const float (&acc)[8][4],
                                        const bf16* dys, const ColParams& cp,
                                        float n, int warp, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h, c = nt * 8 + 2 * t;
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float zh = (acc[nt][2 * h + j] - cp.m[c + j]) * cp.inv[c + j];
        const float dy = __bfloat162float(dys[r * LDS + c + j]);
        v[j] = cp.a[c + j] * (dy - cp.s1n[c + j] - zh * cp.s2[c + j] / n);
      }
      *reinterpret_cast<uint32_t*>(dzs + r * LDS + c) = pack_bf16(v[0], v[1]);
    }
  }
}

// Pass 1.  grid (nK, G).  part1, part2: (G, K) f32.
__global__ void __launch_bounds__(NTHR)
    bnb_reduce(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ dy, const float* __restrict__ m,
               const float* __restrict__ inv, float* __restrict__ part1,
               float* __restrict__ part2, Geo geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + 2 * TILE;
  bf16* dys = ws + 2 * TILE;
  ColParams& cp = *reinterpret_cast<ColParams*>(dys + TILE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, grp = blockIdx.y;
  load_cols(cp, m, inv, nullptr, nullptr, nullptr, kt, geo, tid);
  float s1[8][2] = {}, s2[8][2] = {};
  for (long long rt = grp; rt < geo.nM; rt += geo.G) {
    stage(dys, dy, geo.K, rt * TM, geo.M, kt * TN, geo.K, tid);
    float acc[8][4];
    z_tile(acc, x, w, rt, kt, geo, xs, ws, tid, warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + 8 * (e >> 1), c = nt * 8 + 2 * t + (e & 1);
        const float d = __bfloat162float(dys[r * LDS + c]);
        const float zh = (acc[nt][e] - cp.m[c]) * cp.inv[c];
        s1[nt][e & 1] += d;
        s2[nt][e & 1] += d * zh;
      }
    }
    __syncthreads();           // dys is restaged by the next row tile
  }
  // the 8 lanes of one t hold the same columns: sum them, then the warps
  float* red = reinterpret_cast<float*>(xs);      // [2][4 warps][TN]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float a = s1[nt][j], b = s2[nt][j];
      for (int o = 4; o < 32; o <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (g == 0) {
        red[warp * TN + nt * 8 + 2 * t + j] = a;
        red[4 * TN + warp * TN + nt * 8 + 2 * t + j] = b;
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < TN; c += NTHR) {
    const int k = kt * TN + c;
    if (k < geo.K) {
      float a = 0.f, b = 0.f;
      for (int wi = 0; wi < 4; ++wi) {
        a += red[wi * TN + c];
        b += red[4 * TN + wi * TN + c];
      }
      part1[(size_t)grp * geo.K + k] = a;
      part2[(size_t)grp * geo.K + k] = b;
    }
  }
}

// Pass 2.  grid (2·nC·nK, G).  partw: (G, C, K) f32.
__global__ void __launch_bounds__(NTHR)
    bnb_apply(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const bf16* __restrict__ dy, const float* __restrict__ m,
              const float* __restrict__ inv, const float* __restrict__ gam,
              const float* __restrict__ s1, const float* __restrict__ s2,
              bf16* __restrict__ dx, float* __restrict__ partw, Geo geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + 2 * TILE;
  bf16* dys = ws + 2 * TILE;
  bf16* dzs = dys + TILE;
  bf16* aux = dzs + TILE;            // W[ct, kt] (dx) or x[rows, ct] (dW)
  ColParams& cp = *reinterpret_cast<ColParams*>(aux + TILE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.y;
  const float n = (float)geo.M;
  float acc[8][4], out[8][4];
  if ((int)blockIdx.x < geo.nC * geo.nK) {
    // dx[rows, ct] = Σ_kt dz[rows, kt] · W[ct, kt]ᵀ
    const int ct = blockIdx.x / geo.nK, j = blockIdx.x % geo.nK;
    const long long stride = (long long)geo.G * geo.nK;
    for (long long rt = grp + (long long)geo.G * j; rt < geo.nM;
         rt += stride) {
      zero(out);
      for (int kt = 0; kt < geo.nK; ++kt) {
        load_cols(cp, m, inv, gam, s1, s2, kt, geo, tid);
        stage(dys, dy, geo.K, rt * TM, geo.M, kt * TN, geo.K, tid);
        stage(aux, w, geo.K, (long long)ct * TN, geo.C, kt * TN, geo.K, tid);
        z_tile(acc, x, w, rt, kt, geo, xs, ws, tid, warp, lane);
        form_dz(dzs, acc, dys, cp, n, warp, g, t);
        __syncwarp();
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          load_a(a[kk], dzs, warp * 16 + g, LDS, kk, t);
        mma_abt_acc(out, a, aux, g, t);
        __syncthreads();     // cp, dys and aux are restaged next
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = rt * TM + warp * 16 + g + 8 * h;
          const int c = ct * TN + nt * 8 + 2 * t;
          if (r < geo.M && c < geo.C)
            *reinterpret_cast<uint32_t*>(dx + (size_t)r * geo.C + c) =
                pack_bf16(out[nt][2 * h], out[nt][2 * h + 1]);
        }
      }
    }
    return;
  }
  // dW[ct, kt] += x[rows, ct]ᵀ · dz[rows, kt]
  const int idx = blockIdx.x - geo.nC * geo.nK;
  const int ct = idx / geo.nK, kt = idx % geo.nK;
  load_cols(cp, m, inv, gam, s1, s2, kt, geo, tid);
  zero(out);
  for (long long rt = grp; rt < geo.nM; rt += geo.G) {
    stage(dys, dy, geo.K, rt * TM, geo.M, kt * TN, geo.K, tid);
    stage(aux, x, geo.C, rt * TM, geo.M, ct * TN, geo.C, tid);
    z_tile(acc, x, w, rt, kt, geo, xs, ws, tid, warp, lane);
    form_dz(dzs, acc, dys, cp, n, warp, g, t);
    __syncthreads();
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a_trans(a[kk], aux, kk * 16, warp * 16, lane);
    mma_ab<4>(out, a, dzs, LDS, lane);
    __syncthreads();         // dys, dzs and aux are restaged next
  }
  float* dst = partw + (size_t)grp * geo.C * geo.K;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ct * TN + warp * 16 + g + 8 * h;
      const int k = kt * TN + nt * 8 + 2 * t;
      if (c < geo.C && k < geo.K) {
        dst[(size_t)c * geo.K + k] = out[nt][2 * h];
        dst[(size_t)c * geo.K + k + 1] = out[nt][2 * h + 1];
      }
    }
  }
}

// out[i] = Σ_{g < G} part[g·n + i], in the order g = 0, 1, ...
__global__ void sum_partials(const float* __restrict__ part, int groups,
                             long long n, float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[g * n + i];
    out[i] = s;
  }
}

Geo geometry(int M, int C, int K, int G) {
  return Geo{M, C, K, (M + TM - 1) / TM, (C + TN - 1) / TN,
             (K + TN - 1) / TN, G};
}

cudaError_t launch_sum(const float* part, int groups, long long n, float* out,
                       cudaStream_t st) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sum_partials<<<(int)(blocks < 4096 ? blocks : 4096), threads, 0, st>>>(
      part, groups, n, out);
  return cudaGetLastError();
}

}  // namespace

// The number of row groups G of a pass (0: reduce, 1: apply) at this
// shape: as many as let every block of the launch be resident at once on
// the current device, at least 1 and at most the number of row tiles.
// Returns a negative CUDA error on failure.  The caller sizes the partial
// buffers (G·K twice for reduce, G·C·K for apply) from it.
extern "C" int bottleneck_bwd_groups(int pass, int M, int C, int K) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = pass == 0 ? allow_smem(bnb_reduce, REDUCE_SMEM)
                    : allow_smem(bnb_apply, APPLY_SMEM);
  if (err == cudaSuccess)
    err = pass == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &per_sm, bnb_reduce, NTHR, REDUCE_SMEM)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &per_sm, bnb_apply, NTHR, APPLY_SMEM);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const Geo geo = geometry(M, C, K, 1);
  const long long tiles = pass == 0 ? geo.nK : 2LL * geo.nC * geo.nK;
  long long groups = (long long)sms * (per_sm > 0 ? per_sm : 1) / tiles;
  if (groups > geo.nM) groups = geo.nM;
  return groups < 1 ? 1 : (int)groups;
}

// Pass 1: s1, s2 (K) f32 through part (2·G·K f32 scratch).
extern "C" int bottleneck_bwd_reduce(const void* dy, const void* x,
                                     const void* w, const float* m,
                                     const float* inv, float* part, float* s1,
                                     float* s2, int M, int C, int K, int groups,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo geo = geometry(M, C, K, groups);
  cudaError_t err = allow_smem(bnb_reduce, REDUCE_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part2 = part + (size_t)groups * K;
  bnb_reduce<<<dim3(geo.nK, groups), NTHR, REDUCE_SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(dy), m, inv, part, part2, geo);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_sum(part, groups, K, s1, st);
  if (err == cudaSuccess) err = launch_sum(part2, groups, K, s2, st);
  return static_cast<int>(err);
}

// Pass 2: dx (M, C) bf16 and dW (C, K) f32 through part (G·C·K f32).
extern "C" int bottleneck_bwd_apply(const void* dy, const void* x,
                                    const void* w, const float* m,
                                    const float* inv, const float* gamma,
                                    const float* s1, const float* s2,
                                    float* part, void* dx, float* dw, int M,
                                    int C, int K, int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo geo = geometry(M, C, K, groups);
  cudaError_t err = allow_smem(bnb_apply, APPLY_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  bnb_apply<<<dim3(2 * geo.nC * geo.nK, groups), NTHR, APPLY_SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(dy), m, inv, gamma, s1, s2,
      static_cast<bf16*>(dx), part, geo);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_sum(part, groups, (long long)C * K, dw, st);
  return static_cast<int>(err);
}
