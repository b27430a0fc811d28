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
//   * Pass 1 at any shape but the two below (`bnb_reduce`): block
//     (kt, g) owns K tile kt, so x is staged once per K tile.
//   * Pass 2 at any shape but the two below (`bnb_apply`): two kinds of
//     block in one launch.  Block (ct·nK + j, g) writes dx[rows, ct] =
//     Σ_kt dz[rows, kt]·W[ct, kt]ᵀ for the row tiles g + G·j,
//     g + G·j + G·nK, ..., recomputing z and dz for every K tile; block
//     (nC·nK + ct·nK + kt, g) accumulates dW[ct, kt] += x[rows, ct]ᵀ·
//     dz[rows, kt] over the row tiles g, g + G, ....  A dx block walks nK
//     times fewer rows than a dW block and does nK times the work on
//     each, so every block of the launch does the same number of tile
//     steps.  Both recompute z over all of C, so z is computed 2·C/64
//     times per pass.
//   * Pass 2 at ResNet-50 stage 1's 1x1 expand (C = 64, K = 256) and its
//     reverse (C = 256, K = 64), the two shapes of the tool's path
//     (`bnb_apply_tma`): one persistent block an SM reads dy and x once
//     and writes dx once, z and dz computed once a row.  W (32 KB at both
//     shapes) is loaded once a block by TMA and stays in shared memory as
//     64 x 64 boxes in 128-byte swizzle, read both ways by wgmma's
//     transpose bits: N-major (its rows are the k of the product) for
//     z = x·W, K-major for dx = dz·Wᵀ.  A producer warpgroup (one
//     thread) brings each 64-row tile's x (C columns) and dy (K columns)
//     by TMA into a ring of 4 stages of 40 KB; the rest of it gives its
//     registers away (`setmaxnreg`: 24 a thread, 240 to each consumer
//     thread).  Two consumer warpgroups take the block's tiles in turns
//     (consumer c the tiles c, c + 2, ... and stages c, c + 2), each
//     working a tile alone, so that one's elementwise work runs while
//     the other's products and loads do.  For each 64-column chunk kc
//     of K: z = x·W[:, kc] (wgmma, f32, x K-major); dz as `form_dz`,
//     rounded to bf16 once, written over dy in the stage and kept as the
//     register operand of dx; dW[:, kc] += xᵀ·dz (wgmma with x read
//     transposed, M-major, and dz N-major, both from the stage) into f32
//     accumulators that live across all of the consumer's tiles; and
//     dx += dz·W[:, kc]ᵀ (C = 64), or at K = 64 dx[:, cc] = dz·W[cc]ᵀ box
//     by box (C = 256).  dx is rounded once to bf16 into x's boxes of
//     the stage, which its products have read, and written by TMA store;
//     a consumer gives the stage back once that store has read it,
//     after its next tile's products are issued.  At the end the two
//     consumers' dW are added in shared memory in a fixed order into the
//     block's one partial, and `sum_partials` adds the G blocks' partials
//     in a fixed order: two launches give the same bits.  The split is
//     by rows, not by K: a consumer holding z and dx of a 64-row tile and
//     dW at its full 64·256 needs 32 + 32 + 128 accumulator registers,
//     within its 240, and the consumers never wait on each other.
//     ptxas (-Xptxas -v): 168 registers a thread at launch, the
//     consumers' raised to 240 by `setmaxnreg`; no stack at 256 -> 64,
//     72 bytes of stack (spills) at 64 -> 256 (orderings of the chunk
//     steps that spill less were no faster, PERF.md).
//   * Pass 1 at the same two shapes (`bnb_reduce_tma`): pass 2's
//     machinery without dz, dx or dW.  One persistent block an SM loads
//     W once by TMA (the same swizzled boxes, read N-major for z = x·W);
//     a producer warp brings each 64-row tile's x and dy into a ring of
//     4 stages of 40 KB, so x and dy are read from memory once (the old
//     kernel staged x once per K tile and restaged W every row tile).
//     Two consumer warpgroups take the tiles in turns; for each 64-column
//     chunk of K a consumer computes z with wgmma (f32), zh = (z − m)·inv
//     and adds dy and dy·zh of its two rows to per-column sums kept in
//     registers across all of its tiles (2·16 a chunk a thread: 128 at
//     64 -> 256).  It gives the stage back once its products are waited
//     for and its dy read; a reduction stores nothing, so no store holds
//     a stage.  At the end the sums go across the 8 lanes of one column,
//     then the 4 warps and the 2 consumers, in a fixed order, into the
//     block's row of a (G, 2K) partial (s1 then s2), which one
//     `sum_partials` launch adds in a fixed order: no float atomics, and
//     two launches give the same bits.
//   * Ragged M, C and K: rows of x and dy past M, and columns past C or K,
//     are staged as zeros (TMA fills its boxes past M with zeros), and m,
//     inv, g as zeros past K.  A zero row adds nothing to s1, s2 (dy = 0)
//     or dW (x = 0); dx is stored only for rows < M (a TMA store writes
//     nothing past the tensor) and columns < C.  The TPU kernel ran
//     M // bm tiles and left the tail rows out; these cover every row.
//
// Bound on an H100 SXM at ResNet-50 stage 1 (M = 256·56·56 = 802,816,
// C = 64, K = 256): pass 1 reads dy and x, 514 MB, 0.153 ms at 3.35 TB/s;
// pass 2 reads dy and x and writes dx, 617 MB, 0.184 ms.  Their products
// take 0.027 and 0.080 ms at 989 TFLOP/s, so both are bound by memory;
// the reverse (C = 256, K = 64) moves 925 MB in pass 2, 0.276 ms.
// `bnb_reduce` reads dy and x from memory about once when L2 serves the
// groups' repeated reads; `bnb_reduce_tma` and `bnb_apply_tma` read them
// once.
#include "flash_common.cuh"
#include "hopper_common.cuh"

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

// Pass 1.  grid (nK, G).  part: (G, 2K) f32, s1 then s2 in each row.
__global__ void __launch_bounds__(NTHR)
    bnb_reduce(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ dy, const float* __restrict__ m,
               const float* __restrict__ inv, float* __restrict__ part,
               Geo geo) {
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
      part[(size_t)grp * 2 * geo.K + k] = a;
      part[(size_t)grp * 2 * geo.K + geo.K + k] = b;
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

// ---------------------------------------------------------------------
// Pass 2 at ResNet-50 stage 1's two shapes, (C, K) = (64, 256) and
// (256, 64): `bnb_apply_tma` (see the header).  NC = C/64, NK = K/64.
// ---------------------------------------------------------------------
namespace apply_tma {
constexpr int BOX = 64 * 64 * 2;        // 64 rows x 64 columns of bf16: 8 KB
constexpr int STAGES = 4;               // two row tiles a consumer
constexpr int THREADS = 384;            // producer + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int PAIR = 3;                 // named barrier of both consumers
static_assert(STAGES % 2 == 0, "each consumer owns every other stage");
// a consumer gives its last tile's stage back once its next tile's has
// arrived (where that is another stage), so that the dx store of one
// tile runs while the next one's products do
constexpr bool DEFER = STAGES > 2;

template <int NC, int NK> struct Shape {
  static constexpr int STAGE = (NC + NK) * BOX;      // x, dy: 40 KB
  static constexpr int WBYTES = NC * NK * BOX;       // W: 32 KB
  static constexpr size_t SMEM =                     // + 5 (K) f32, slack
      (size_t)STAGES * STAGE + WBYTES + 5 * 64 * NK * sizeof(float) + 1024;
};
}  // namespace apply_tma

// x, dy, dx (1, M, C or K) and W (1, C, K), read and written as 64 x 64
// boxes in 128-byte swizzle.
struct ApplyMaps {
  CUtensorMap x, dy, w, dx;
};

// dz = a·(dy − s1/n − zh·s2/n), zh = (z − m)·inv, as `form_dz`; the
// division by n is one product by rn = 1/n and one correction step
// (flash_short_fwd.cu `quotient`), which is the correctly rounded
// quotient wherever it is a normal float: the bits of `form_dz`'s.
__device__ __forceinline__ float apply_dz(float z, float dy, float m,
                                          float inv, float a, float s1n,
                                          float s2, float n, float rn) {
  const float zh = (z - m) * inv;
  const float x = zh * s2;
  const float q = x * rn;
  return a * (dy - s1n - fmaf(fmaf(-n, q, x), rn, q));
}

// dz of one 64-column chunk of a row tile, from the chunk's z (this
// lane's accumulators: rows lr0, lr1, columns 8j + 2t + {0, 1}) and dy
// read from its swizzled box: rounded to bf16 over dy in the box, and
// as the register A fragments of dx = dz·Wᵀ (columns 16kk.. are k-step
// kk).  cols holds m, inv, a, s1/n, s2 of the chunk's 64 columns, K
// apart.
__device__ __forceinline__ void apply_form_dz(uint32_t (&da)[4][4],
                                              unsigned char* dyb,
                                              const float (&z)[32],
                                              const float* cols, int K,
                                              float n, float rn, int lr0,
                                              int lr1, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 m = *reinterpret_cast<const float2*>(cols + c);
    const float2 inv = *reinterpret_cast<const float2*>(cols + K + c);
    const float2 a = *reinterpret_cast<const float2*>(cols + 2 * K + c);
    const float2 s1n = *reinterpret_cast<const float2*>(cols + 3 * K + c);
    const float2 s2 = *reinterpret_cast<const float2*>(cols + 4 * K + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t* at = reinterpret_cast<uint32_t*>(
          dyb + sw128_at(h ? lr1 : lr0, j) + 4 * t);
      const float2 dy =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
      const uint32_t dz = pack_bf16(
          apply_dz(z[4 * j + 2 * h], dy.x, m.x, inv.x, a.x, s1n.x, s2.x, n,
                   rn),
          apply_dz(z[4 * j + 2 * h + 1], dy.y, m.y, inv.y, a.y, s1n.y, s2.y,
                   n, rn));
      *at = dz;
      da[j >> 1][2 * (j & 1) + h] = dz;
    }
  }
}

// Pass 2, persistent: grid G <= the SMs, G·C·K f32 partials of dW.
template <int NC, int NK>
__global__ void __launch_bounds__(apply_tma::THREADS, 1)
    bnb_apply_tma(const __grid_constant__ ApplyMaps maps,
                  const float* __restrict__ m, const float* __restrict__ inv,
                  const float* __restrict__ gam,
                  const float* __restrict__ s1, const float* __restrict__ s2,
                  float* __restrict__ partw, int M) {
  using namespace apply_tma;
  constexpr int C = 64 * NC, K = 64 * NK, STAGE = Shape<NC, NK>::STAGE;
  extern __shared__ unsigned char apply_smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], wfull;
  unsigned char* ring = smem_align1024(apply_smem_raw);
  unsigned char* wbuf = ring + STAGES * STAGE;         // box (cc, kc)
  float* cols = reinterpret_cast<float*>(wbuf + NC * NK * BOX);
  const int tid = threadIdx.x;
  const int n_tiles = (M + 63) / 64;
  const float n = (float)M;
  for (int k = tid; k < K; k += THREADS) {
    cols[k] = m[k];
    cols[K + k] = inv[k];
    cols[2 * K + k] = gam[k] * inv[k];
    cols[3 * K + k] = s1[k] / n;
    cols[4 * K + k] = s2[k];
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);          // its consumer's lead thread
    }
    mbar_init(&wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer: one thread loads W once and then each row tile's x
    // and dy into the ring; the warpgroup gives its registers away
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(&wfull, NC * NK * BOX);
      for (int cc = 0; cc < NC; ++cc)
        for (int kc = 0; kc < NK; ++kc)
          tma_load(wbuf + (cc * NK + kc) * BOX, &maps.w, &wfull, 64 * kc,
                   64 * cc, 0);
      int i = 0;
      for (int rt = blockIdx.x; rt < n_tiles; rt += gridDim.x, ++i) {
        const int s = i % STAGES;
        unsigned char* st = ring + s * STAGE;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE);
        for (int cc = 0; cc < NC; ++cc)
          tma_load(st + cc * BOX, &maps.x, &full[s], 64 * cc, 64 * rt, 0);
        for (int kc = 0; kc < NK; ++kc)
          tma_load(st + (NC + kc) * BOX, &maps.dy, &full[s], 64 * kc,
                   64 * rt, 0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // Consumer c takes the block's row tiles c, c + 2, ... (its stages are
  // c, c + 2, ...); warp w holds rows w*16 + g and w*16 + g + 8.
  const int c = tid / 128 - 1;
  const int ctid = tid % 128;
  const int w = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int lr0 = w * 16 + g, lr1 = lr0 + 8;
  const bool lead = ctid == 0;
  const float rn = 1.f / n;
  float dw[NC * NK][32];                // dW[cc][kc] over every tile
#pragma unroll
  for (int b = 0; b < NC * NK; ++b)
#pragma unroll
    for (int e = 0; e < 32; ++e) dw[b][e] = 0.f;
  int prev = -1;                        // a stage not yet given back
  auto release = [&] {
    if (prev >= 0 && lead) {
      bulk_wait_read<0>();              // its dx store has read it
      mbar_arrive(&empty[prev]);
    }
    prev = -1;
  };
  mbar_wait(&wfull, 0);
  int i = c;
  for (int rt = blockIdx.x + c * gridDim.x; rt < n_tiles;
       rt += 2 * gridDim.x, i += 2) {
    const int s = i % STAGES;
    unsigned char* st = ring + s * STAGE;             // x box cc at cc*BOX
    if (!DEFER) release();
    mbar_wait(&full[s], (i / STAGES) & 1);
    float dx[32];                       // dx of 64 columns of C
    uint32_t da[4][4];                  // dz of one K chunk, bf16
#pragma unroll
    for (int e = 0; e < 32; ++e) dx[e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      unsigned char* dyb = st + (NC + kc) * BOX;      // dy, then dz
      // z = x·W[:, kc]: x K-major, W's rows (c) the k of the product
      float z[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) z[e] = 0.f;
      fence_regs(z);
      wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const uint64_t ax = sw128_desc(st + cc * BOX);
        const uint64_t bw = sw128_desc(wbuf + (cc * NK + kc) * BOX);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n64k16_ss<0, 1>(z, ax + 2 * ks, bw + 128 * ks, cc | ks);
      }
      wgmma_commit();
      if (DEFER && kc == 0) release();
      wgmma_wait<0>();                  // also dW, dx of chunk kc - 1
      fence_regs(z);
      fence_regs(da);
      apply_form_dz(da, dyb, z, cols + 64 * kc, K, n, rn, lr0, lr1, t);
      fence_async_smem();
      warpgroup_sync(1 + c);            // the chunk's dz is in its box
#pragma unroll
      for (int b = 0; b < NC * NK; ++b) fence_regs(dw[b]);
      fence_regs(da);
      wgmma_fence();
      // dW[:, kc] += xᵀ·dz: x read transposed (M-major), dz N-major
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const uint64_t ax = sw128_desc(st + cc * BOX);
        const uint64_t bz = sw128_desc(dyb);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n64k16_ss<1, 1>(dw[cc * NK + kc], ax + 128 * ks,
                                   bz + 128 * ks, 1);
      }
      if (NC == 1) {
        // dx += dz·W[:, kc]ᵀ: W's rows (c) the columns of the product
        const uint64_t bw = sw128_desc(wbuf + kc * BOX);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n64k16_rs_abt(dx, da[ks], bw + 2 * ks, kc | ks);
      }
      wgmma_commit();
    }
    if (NC == 1) {
      wgmma_wait<0>();
      fence_regs(dx);
      fence_regs(da);
      bwd_stage(st, dx, lr0, lr1, t);   // over x: every read of it is done
    } else {
      // NK == 1: dx[:, cc] = dz·W[cc]ᵀ a box at a time, over x's box cc
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        fence_regs(dx);
        wgmma_fence();
        const uint64_t bw = sw128_desc(wbuf + cc * BOX);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n64k16_rs_abt(dx, da[ks], bw + 2 * ks, ks);
        wgmma_commit();
        wgmma_wait<0>();                // and every dW product of the tile
        fence_regs(dx);
        bwd_stage(st + cc * BOX, dx, lr0, lr1, t);
      }
      fence_regs(da);
    }
    fence_async_smem();
    warpgroup_sync(1 + c);
    if (lead) {
      for (int cc = 0; cc < NC; ++cc)
        tma_store(&maps.dx, st + cc * BOX, 64 * cc, 64 * rt, 0);
      bulk_commit();                    // rows past M are not written
    }
    prev = s;
  }
  release();
  if (lead) bulk_wait_all();
#pragma unroll
  for (int b = 0; b < NC * NK; ++b) fence_regs(dw[b]);

  // the block's dW partial: consumer 1's sums through the (now idle)
  // ring, added to consumer 0's in that order
  float* red = reinterpret_cast<float*>(ring);        // [NC*NK*32][128]
  pair_sync(PAIR);                      // every store has read the ring
  if (c == 1) {
#pragma unroll
    for (int b = 0; b < NC * NK; ++b)
#pragma unroll
      for (int e = 0; e < 32; ++e) red[(b * 32 + e) * 128 + ctid] = dw[b][e];
  }
  pair_sync(PAIR);
  if (c == 0) {
    float* dst = partw + (size_t)blockIdx.x * C * K;
#pragma unroll
    for (int b = 0; b < NC * NK; ++b) {
      const int cc = b / NK, kc = b % NK;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h;
          const int row = 64 * cc + (h ? lr1 : lr0);
          const int col = 64 * kc + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(dst + (size_t)row * K + col) =
              make_float2(dw[b][e] + red[(b * 32 + e) * 128 + ctid],
                          dw[b][e + 1] + red[(b * 32 + e + 1) * 128 + ctid]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// Pass 1 at the same two shapes: `bnb_reduce_tma` (see the header).
// ---------------------------------------------------------------------
namespace reduce_tma {
constexpr int RING = 4;                 // stages: two row tiles a consumer
constexpr int CONSUMERS = 2;            // warpgroups taking tiles in turns
constexpr int THREADS = 128 * (1 + CONSUMERS);
// ptxas sizes the registers at launch for three warpgroups (168 a
// thread) whatever CONSUMERS is, so that `setmaxnreg` only ever raises
// the consumers' count
constexpr int BOUND = 384;
constexpr int LOW_REGS = 24, HIGH_REGS = 240;       // producer, consumers
constexpr int SUMS = 3;                 // named barrier of the consumers
static_assert(RING % CONSUMERS == 0, "a stage belongs to one consumer");

template <int NC, int NK> struct Shape {
  static constexpr int K = 64 * NK;
  static constexpr int STAGE = (NC + NK) * apply_tma::BOX;   // x, dy: 40 KB
  static constexpr int WBYTES = NC * NK * apply_tma::BOX;     // W: 32 KB
  static constexpr int RED = CONSUMERS * 4 * 2 * K;  // f32: a warp's s1, s2
  static constexpr size_t SMEM =                     // + m, inv; slack
      (size_t)RING * STAGE + WBYTES + (2 * K + RED) * sizeof(float) + 1024;
};
}  // namespace reduce_tma

struct ReduceMaps {
  CUtensorMap x, dy, w;
};

// Pass 1, persistent: grid G <= the SMs, part (G, 2K) f32.
template <int NC, int NK>
__global__ void __launch_bounds__(reduce_tma::BOUND, 1)
    bnb_reduce_tma(const __grid_constant__ ReduceMaps maps,
                   const float* __restrict__ m,
                   const float* __restrict__ inv, float* __restrict__ part,
                   int M) {
  using namespace reduce_tma;
  using apply_tma::BOX;
  constexpr int K = 64 * NK, STAGE = Shape<NC, NK>::STAGE;
  extern __shared__ unsigned char reduce_smem_raw[];
  __shared__ __align__(8) uint64_t full[RING], empty[RING], wfull;
  unsigned char* ring = smem_align1024(reduce_smem_raw);
  unsigned char* wbuf = ring + RING * STAGE;            // box (cc, kc)
  float* cols = reinterpret_cast<float*>(wbuf + NC * NK * BOX);  // m, inv
  float* red = cols + 2 * K;            // [consumer][warp][s1 | s2][K]
  const int tid = threadIdx.x;
  const int n_tiles = (M + 63) / 64;
  for (int k = tid; k < K; k += THREADS) {
    cols[k] = m[k];
    cols[K + k] = inv[k];
  }
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);          // the lead lane of each warp
    }
    mbar_init(&wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer: one thread loads W once and then each row tile's x
    // and dy into the ring; the warpgroup gives its registers away
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOW_REGS));
    if (tid == 0) {
      mbar_expect_tx(&wfull, NC * NK * BOX);
      for (int cc = 0; cc < NC; ++cc)
        for (int kc = 0; kc < NK; ++kc)
          tma_load(wbuf + (cc * NK + kc) * BOX, &maps.w, &wfull, 64 * kc,
                   64 * cc, 0);
      int i = 0;
      for (int rt = blockIdx.x; rt < n_tiles; rt += gridDim.x, ++i) {
        const int s = i % RING;
        unsigned char* st = ring + s * STAGE;
        mbar_wait(&empty[s], ((i / RING) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE);
        for (int cc = 0; cc < NC; ++cc)
          tma_load(st + cc * BOX, &maps.x, &full[s], 64 * cc, 64 * rt, 0);
        for (int kc = 0; kc < NK; ++kc)
          tma_load(st + (NC + kc) * BOX, &maps.dy, &full[s], 64 * kc,
                   64 * rt, 0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(HIGH_REGS));
  // Consumer c takes the block's row tiles c, c + CONSUMERS, ... (its
  // stages likewise); warp w holds rows w*16 + g and w*16 + g + 8, and
  // of each 64-column chunk kc the columns 8j + 2t + {0, 1}.
  const int c = tid / 128 - 1;
  const int ctid = tid % 128;
  const int w = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int lr0 = w * 16 + g, lr1 = lr0 + 8;
  float s1[NK][16], s2[NK][16];         // [kc][2j + e]: over every tile
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
#pragma unroll
    for (int e = 0; e < 16; ++e) s1[kc][e] = s2[kc][e] = 0.f;
  mbar_wait(&wfull, 0);
  int i = c;
  for (int rt = blockIdx.x + c * gridDim.x; rt < n_tiles;
       rt += CONSUMERS * gridDim.x, i += CONSUMERS) {
    const int s = i % RING;
    const unsigned char* st = ring + s * STAGE;       // x box cc at cc*BOX
    mbar_wait(&full[s], (i / RING) & 1);
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      // zc = x·W[:, kc]: x K-major, W's rows (c) the k of the product
      float zc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) zc[e] = 0.f;
      fence_regs(zc);
      wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const uint64_t ax = sw128_desc(st + cc * BOX);
        const uint64_t bw = sw128_desc(wbuf + (cc * NK + kc) * BOX);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n64k16_ss<0, 1>(zc, ax + 2 * ks, bw + 128 * ks, cc | ks);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(zc);
      // s1 += dy, s2 += dy·zh, zh = (z − m)·inv, dy from its swizzled box
      const unsigned char* dyb = st + (NC + kc) * BOX;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 mm =
            *reinterpret_cast<const float2*>(cols + 64 * kc + 8 * j + 2 * t);
        const float2 iv = *reinterpret_cast<const float2*>(
            cols + K + 64 * kc + 8 * j + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 d = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  dyb + sw128_at(h ? lr1 : lr0, j) + 4 * t));
          s1[kc][2 * j] += d.x;
          s1[kc][2 * j + 1] += d.y;
          s2[kc][2 * j] += d.x * ((zc[4 * j + 2 * h] - mm.x) * iv.x);
          s2[kc][2 * j + 1] += d.y * ((zc[4 * j + 2 * h + 1] - mm.y) * iv.y);
        }
      }
    }
    // the tile's x and dy are read (its products waited for): give the
    // stage back
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Deterministic sums: the 8 lanes of one t hold the same columns (sum
  // them), lane t writes its warp's sums, then each column adds the
  // warps of consumer 0, then those of consumer 1, in that order, into
  // the block's row of part.
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float a = s1[kc][e], b = s2[kc][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (g == 0) {
        const int col = 64 * kc + 8 * (e >> 1) + 2 * t + (e & 1);
        float* r = red + (c * 4 + w) * 2 * K;
        r[col] = a;
        r[K + col] = b;
      }
    }
  }
  asm volatile("bar.sync %0, %1;\n" ::"n"(SUMS), "n"(128 * CONSUMERS)
               : "memory");
  for (int k = tid - 128; k < 2 * K; k += 128 * CONSUMERS) {
    float v = 0.f;
    for (int q = 0; q < CONSUMERS * 4; ++q) v += red[q * 2 * K + k];
    part[(size_t)blockIdx.x * 2 * K + k] = v;
  }
}

// out[i] = Σ_{g < G} part[g·stride + i] for i < n, in the order
// g = 0, 1, ...; entries from `split` on go to out2[i − split].
__global__ void sum_partials(const float* __restrict__ part, int groups,
                             long long n, long long stride, long long split,
                             float* __restrict__ out,
                             float* __restrict__ out2) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[g * stride + i];
    if (i < split)
      out[i] = s;
    else
      out2[i - split] = s;
  }
}

Geo geometry(int M, int C, int K, int G) {
  return Geo{M, C, K, (M + TM - 1) / TM, (C + TN - 1) / TN,
             (K + TN - 1) / TN, G};
}

// The G partial rows of length `stride` summed (their first n entries):
// out gets entries [0, split), out2 the rest.
cudaError_t launch_sum(const float* part, int groups, long long n,
                       long long stride, long long split, float* out,
                       float* out2, cudaStream_t st) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sum_partials<<<(int)(blocks < 4096 ? blocks : 4096), threads, 0, st>>>(
      part, groups, n, stride, split, out, out2);
  return cudaGetLastError();
}

}  // namespace

// The shapes `bnb_reduce_tma` and `bnb_apply_tma` serve: (NC, NK) =
// (C/64, K/64) of ResNet-50 stage 1's 1x1 expand and its reverse, or
// (0, 0).
static void tma_shape(int C, int K, int& nc, int& nk) {
  nc = nk = 0;
  if (C == 64 && K == 256) nc = 1, nk = 4;
  if (C == 256 && K == 64) nc = 4, nk = 1;
}

template <int NC, int NK>
static cudaError_t launch_apply_tma(const void* dy, const void* x,
                                    const void* w, const float* m,
                                    const float* inv, const float* gamma,
                                    const float* s1, const float* s2,
                                    float* part, void* dx, int M, int groups,
                                    cudaStream_t st) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  constexpr int C = 64 * NC, K = 64 * NK;
  ApplyMaps maps;
  if (!(encode(fn, &maps.x, x, C, M, 1, C, (long long)M * C, 64) &&
        encode(fn, &maps.dy, dy, K, M, 1, K, (long long)M * K, 64) &&
        encode(fn, &maps.w, w, K, C, 1, K, (long long)C * K, 64) &&
        encode(fn, &maps.dx, dx, C, M, 1, C, (long long)M * C, 64)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = apply_tma::Shape<NC, NK>::SMEM;
  cudaError_t err = allow_smem(bnb_apply_tma<NC, NK>, smem);
  if (err != cudaSuccess) return err;
  bnb_apply_tma<NC, NK><<<groups, apply_tma::THREADS, smem, st>>>(
      maps, m, inv, gamma, s1, s2, part, M);
  return cudaGetLastError();
}

template <int NC, int NK>
static cudaError_t launch_reduce_tma(const void* dy, const void* x,
                                     const void* w, const float* m,
                                     const float* inv, float* part, int M,
                                     int groups, cudaStream_t st) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  constexpr int C = 64 * NC, K = 64 * NK;
  ReduceMaps maps;
  if (!(encode(fn, &maps.x, x, C, M, 1, C, (long long)M * C, 64) &&
        encode(fn, &maps.dy, dy, K, M, 1, K, (long long)M * K, 64) &&
        encode(fn, &maps.w, w, K, C, 1, K, (long long)C * K, 64)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = reduce_tma::Shape<NC, NK>::SMEM;
  cudaError_t err = allow_smem(bnb_reduce_tma<NC, NK>, smem);
  if (err != cudaSuccess) return err;
  bnb_reduce_tma<NC, NK><<<groups, reduce_tma::THREADS, smem, st>>>(
      maps, m, inv, part, M);
  return cudaGetLastError();
}

// The number of row groups G of a pass (0: reduce, 1: apply) at this
// shape, which is also the number of partial sums the pass writes: at
// the two shapes of the persistent kernels their grid, one block an SM,
// at most one a row tile; otherwise as many as let every block of the
// launch be resident at once on the current device, at least 1 and at
// most the number of row tiles.  Returns a negative CUDA error on
// failure.  The caller sizes the partial buffers (G·2K for reduce, G·C·K
// for apply) from it.
extern "C" int bottleneck_bwd_groups(int pass, int M, int C, int K) {
  const Geo geo = geometry(M, C, K, 1);
  int nc, nk;
  tma_shape(C, K, nc, nk);
  if (nc > 0) return persistent_grid(geo.nM);
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
  const long long tiles = pass == 0 ? geo.nK : 2LL * geo.nC * geo.nK;
  long long groups = (long long)sms * (per_sm > 0 ? per_sm : 1) / tiles;
  if (groups > geo.nM) groups = geo.nM;
  return groups < 1 ? 1 : (int)groups;
}

// Pass 1: s1, s2 (K) f32 through part ((G, 2K) f32 scratch, s1 then s2
// in each row, summed by one launch): `bnb_reduce_tma` at the two shapes
// it serves, `bnb_reduce` at any other.
extern "C" int bottleneck_bwd_reduce(const void* dy, const void* x,
                                     const void* w, const float* m,
                                     const float* inv, float* part, float* s1,
                                     float* s2, int M, int C, int K, int groups,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nc, nk;
  tma_shape(C, K, nc, nk);
  cudaError_t err;
  if (nc == 1) {
    err = launch_reduce_tma<1, 4>(dy, x, w, m, inv, part, M, groups, st);
  } else if (nc == 4) {
    err = launch_reduce_tma<4, 1>(dy, x, w, m, inv, part, M, groups, st);
  } else {
    const Geo geo = geometry(M, C, K, groups);
    err = allow_smem(bnb_reduce, REDUCE_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    bnb_reduce<<<dim3(geo.nK, groups), NTHR, REDUCE_SMEM, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(dy), m, inv, part, geo);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = launch_sum(part, groups, 2LL * K, 2LL * K, K, s1, s2, st);
  return static_cast<int>(err);
}

// Pass 2: dx (M, C) bf16 and dW (C, K) f32 through part (G·C·K f32):
// `bnb_apply_tma` at the two shapes it serves, `bnb_apply` at any other.
extern "C" int bottleneck_bwd_apply(const void* dy, const void* x,
                                    const void* w, const float* m,
                                    const float* inv, const float* gamma,
                                    const float* s1, const float* s2,
                                    float* part, void* dx, float* dw, int M,
                                    int C, int K, int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nc, nk;
  tma_shape(C, K, nc, nk);
  cudaError_t err;
  if (nc == 1) {
    err = launch_apply_tma<1, 4>(dy, x, w, m, inv, gamma, s1, s2, part, dx,
                                 M, groups, st);
  } else if (nc == 4) {
    err = launch_apply_tma<4, 1>(dy, x, w, m, inv, gamma, s1, s2, part, dx,
                                 M, groups, st);
  } else {
    const Geo geo = geometry(M, C, K, groups);
    err = allow_smem(bnb_apply, APPLY_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    bnb_apply<<<dim3(2 * geo.nC * geo.nK, groups), NTHR, APPLY_SMEM, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(dy), m, inv, gamma, s1, s2,
        static_cast<bf16*>(dx), part, geo);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = launch_sum(part, groups, (long long)C * K, (long long)C * K,
                     (long long)C * K, dw, nullptr, st);
  return static_cast<int>(err);
}
