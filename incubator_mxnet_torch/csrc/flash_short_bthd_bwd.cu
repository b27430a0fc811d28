// Short-sequence attention backward in the BTHD layout for Hopper
// (sm_90a).
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/flash_attention.py
// `_bwd_short_bthd_kernel` (:443), launched by `_bwd_short_bthd` (:506),
// the custom VJP of `_flash_short_bthd`.  For each batch-head (b, h), from
// the forward's saved normalized p (in the input type) and
// delta = rowsum(do·o) (float32, computed outside the kernel as the JAX
// package does),
//
//     dp = do·vᵀ                          (f32)
//     ds = (p·(dp − delta))·scale          rounded to the input type
//     dq = ds·k,  dk = dsᵀ·q,  dv = pᵀ·do  (f32 accumulation, rounded once)
//
// q, k, v and do are (B, T, H, d) with one batch stride and one row
// stride per tensor (`Rows`, flash_common.cuh), so the q, k, v column
// slices of a fused (B, T, 3E) projection are read in place; p is
// (B, H, T, T), delta (B, H, T) f32; dq, dk, dv are written contiguous
// (B, T, H, d).  p is read, never recomputed, as in the TPU kernel.
// Causal needs no test here: the saved p is already 0 above the diagonal,
// and a row with kv_length 0 has p = 1/T, which sends gradient into k as
// the TPU kernel does.
//
// Design.
//   * bf16, T = 128, d = 64 (BERT's training shape): `bthd_bwd_mma`, one
//     block of 8 warps per batch-head.  q, k, v, do (16 KB each) and p
//     (32 KB) are staged in shared memory with cp.async.  Phase 1, warp w
//     owns keys 16w..16w+15: dpᵀ = v·doᵀ in mma.sync registers (v rows as
//     the A operand), pᵀ read from the staged p, dsᵀ formed in registers
//     and written back over the same p entries (each warp reads and
//     writes only its own key columns), then dv += pᵀ·do and dk += dsᵀ·q
//     with pᵀ and dsᵀ reused from the accumulators as A operands and do,
//     q read down their columns with ldmatrix.trans, 32 queries at a time
//     to bound registers.  Phase 2, warp w owns queries 16w..16w+15:
//     dq = ds·k from the ds rows in shared memory and k by ldmatrix.trans.
//     Each block owns its (b, h), so no atomics.  106.5 KiB of shared
//     memory, so two blocks fit an SM if the registers allow.
//   * float32, and bf16 of other shapes (any T <= 512, d <= 256):
//     `bthd_bwd_dq_fma` (a block per 16 query rows, key chunks of 32
//     streamed through shared memory) and `bthd_bwd_dkv_fma` (a block per
//     16 keys, query chunks of 32, p's columns re-read per chunk), both in
//     full f32 FMA.  dp is computed by both.
//
// Bound on an H100 SXM at the training shape (B = 60, H = 12, T = 128,
// d = 64, bf16): q, k, v, do 47.2 MB + p 23.6 MB + delta 0.4 MB in,
// dq, dk, dv 35.4 MB out, ~106.6 MB, 32 us at 3.35 TB/s; the 4·2·T²·d
// per batch-head, 6.0 GFLOP, take 6 us at 989 TFLOP/s.  So the kernel is
// bound by memory.  The design reads every input byte once and writes
// every output once; the scores' (T, T) intermediates never leave the
// SM.  TMA, wgmma and overlapping one batch-head's loads with another's
// math are later work.
#include "flash_common.cuh"

// ---------------------------------------------------------------------
// Tensor-core kernel: bf16, T = 128, d = 64.
// ---------------------------------------------------------------------
constexpr int BN = 128;              // T
constexpr int BD = 64;               // d
constexpr int LD = BD + 8;           // padded (T, d) rows: conflict-free
constexpr int LDP = BN + 8;          // padded p / ds rows
constexpr int NW = BN / 16;          // warps: 16 keys, then 16 queries each
constexpr int NTHR = NW * 32;
constexpr int HALF = 32;             // queries per phase-1 step
constexpr size_t MMA_SMEM =
    (size_t)(4 * BN * LD + BN * LDP) * sizeof(bf16) + BN * sizeof(float);

// Rows [0, BN) of one head of a (B, T, H, 64) bf16 tensor into a padded
// [BN][LD] shared tile, 16 bytes per copy.
__device__ __forceinline__ void stage_head(bf16* dst, const bf16* src,
                                           long long ts, int tid) {
  for (int i = tid; i < BN * 8; i += NTHR) {
    const int r = i >> 3, c = (i & 7) * 8;
    cp_async16(dst + r * LD + c, src + (size_t)r * ts + c, true);
  }
}

// Rows [16w, 16w + 16) of a padded tile (warp w's own rows, staged there
// from its accumulators) to one head of a contiguous (B, T, H, 64) output.
__device__ __forceinline__ void store_rows(bf16* dst, long long ts,
                                           const bf16* tile, int warp,
                                           int lane) {
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = warp * 16 + i / 8, c = (i % 8) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ts + c) =
        *reinterpret_cast<const uint4*>(tile + r * LD + c);
  }
}

// The f32 accumulators of 16 rows x 64 columns into rows `row` and
// row + 8 of a padded tile, rounded to bf16.
__device__ __forceinline__ void stage_acc(bf16* tile, int row,
                                          const float (&acc)[8][4], int t) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + row * LD + c) =
        pack_bf16(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(tile + (row + 8) * LD + c) =
        pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

__global__ void __launch_bounds__(NTHR)
bthd_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ delta, const bf16* __restrict__ p,
             bf16* __restrict__ dq, bf16* __restrict__ dk,
             bf16* __restrict__ dv, Rows rq, Rows rk, Rows rv, Rows rdo,
             int heads, float scale) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(bwd_smem);   // [BN][LD], later dq
  bf16* ks = qs + BN * LD;                        // [BN][LD]
  bf16* vs = ks + BN * LD;                        // [BN][LD], later dv
  bf16* dos = vs + BN * LD;                       // [BN][LD], later dk
  bf16* ps = dos + BN * LD;                       // [BN][LDP]: p, then ds
  float* dls = reinterpret_cast<float*>(ps + BN * LDP);   // [BN] delta

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  stage_head(qs, q + head_at(rq, bh, heads, BD), rq.ts, tid);
  stage_head(ks, k + head_at(rk, bh, heads, BD), rk.ts, tid);
  stage_head(vs, v + head_at(rv, bh, heads, BD), rv.ts, tid);
  stage_head(dos, dout + head_at(rdo, bh, heads, BD), rdo.ts, tid);
  const bf16* pb = p + (size_t)bh * BN * BN;
  for (int i = tid; i < BN * BN / 8; i += NTHR) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    cp_async16(ps + r * LDP + c, pb + (size_t)r * BN + c, true);
  }
  if (tid < BN) cp_async4(dls + tid, delta + (size_t)bh * BN + tid, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // phase 1: this warp's 16 keys (rows of dpᵀ, pᵀ, dsᵀ, dk, dv)
  const int wrow = warp * 16 + g;
  uint32_t va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(va[kk], vs, wrow, LD, kk, t);
  float dkc[8][4], dvc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkc[dt][e] = dvc[dt][e] = 0.f;

#pragma unroll 1
  for (int q0 = 0; q0 < BN; q0 += HALF) {
    const bf16* qt = qs + q0 * LD;
    const bf16* dot = dos + q0 * LD;
    float dp[4][4];
    mma_abt<4>(dp, va, dot, LD, g, t);        // dpᵀ = v·doᵀ
    float pv[4][4], dsv[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = q0 + nt * 8 + 2 * t + (e & 1);
        const int key = e < 2 ? wrow : wrow + 8;
        bf16* at = ps + qr * LDP + key;
        const float pp = to_f(*at);
        const float x = pp * (dp[nt][e] - dls[qr]) * scale;
        const bf16 xr = __float2bfloat16(x);
        pv[nt][e] = pp;
        dsv[nt][e] = __bfloat162float(xr);
        *at = xr;                             // ds in place of p
      }
    }
    uint32_t pa[2][4], dsa[2][4];              // k-steps of 16 queries
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      pack_a(pa[j], pv[2 * j], pv[2 * j + 1]);
      pack_a(dsa[j], dsv[2 * j], dsv[2 * j + 1]);
    }
    mma_ab<2>(dvc, pa, dot, LD, lane);        // dv += pᵀ·do
    mma_ab<2>(dkc, dsa, qt, LD, lane);        // dk += dsᵀ·q
  }
  __syncthreads();          // every warp's ds written; q, do, p read

  const size_t row = (size_t)heads * BD;     // outputs: (B, T, H, d)
  const size_t ob =
      (size_t)(bh / heads) * BN * row + (size_t)(bh % heads) * BD;
  stage_acc(dos, wrow, dkc, t);
  stage_acc(vs, wrow, dvc, t);
  __syncwarp();
  store_rows(dk + ob, row, dos, warp, lane);
  store_rows(dv + ob, row, vs, warp, lane);

  // phase 2: this warp's 16 queries, dq = ds·k
  uint32_t da[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) load_a(da[j], ps, wrow, LDP, j, t);
  float dqc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqc[dt][e] = 0.f;
  mma_ab<8>(dqc, da, ks, LD, lane);
  stage_acc(qs, wrow, dqc, t);
  __syncwarp();
  store_rows(dq + ob, row, qs, warp, lane);
}

// ---------------------------------------------------------------------
// FMA kernels: float32, and bf16 of any T <= 512, d <= 256.
// ---------------------------------------------------------------------
constexpr int FB_ROWS = 16;          // rows a block owns (queries or keys)
constexpr int FB_STEP = 32;          // rows of the other side per step
constexpr int FTHREADS = 128;

static size_t dq_fma_smem(int d) {
  return ((size_t)2 * FB_ROWS * d + (size_t)2 * FB_STEP * (d + 1) +
          (size_t)FB_ROWS * FB_STEP + FB_ROWS) * sizeof(float);
}

// dq for 16 query rows of one batch-head: k and v stream in chunks of 32
// keys; dp, ds and ds·k in full f32, ds rounded to T before ds·k.
template <typename T>
__global__ void __launch_bounds__(FTHREADS)
bthd_bwd_dq_fma(const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ delta,
                const T* __restrict__ p, T* __restrict__ dq, Rows rk,
                Rows rv, Rows rdo, int heads, int n, int d, float scale) {
  extern __shared__ __align__(16) unsigned char dq_fma_smem_[];
  const int ldk = d + 1;
  float* dos = reinterpret_cast<float*>(dq_fma_smem_);  // [ROWS][d]
  float* acc = dos + FB_ROWS * d;                       // [ROWS][d]
  float* ks = acc + FB_ROWS * d;                        // [STEP][ldk]
  float* vs = ks + FB_STEP * ldk;                       // [STEP][ldk]
  float* ds = vs + FB_STEP * ldk;                       // [ROWS][STEP]
  float* dlr = ds + FB_ROWS * FB_STEP;                  // [ROWS]

  const int bh = blockIdx.y, q0 = blockIdx.x * FB_ROWS;
  const int tid = threadIdx.x;
  const int rows = min(FB_ROWS, n - q0);
  const T* kb = k + head_at(rk, bh, heads, d);
  const T* vb = v + head_at(rv, bh, heads, d);
  const T* db = dout + head_at(rdo, bh, heads, d);
  const T* pb = p + (size_t)bh * n * n;

  for (int i = tid; i < FB_ROWS * d; i += FTHREADS) {
    const int r = i / d, e = i % d;
    dos[i] = r < rows ? to_f(db[(size_t)(q0 + r) * rdo.ts + e]) : 0.f;
    acc[i] = 0.f;
  }
  if (tid < FB_ROWS)
    dlr[tid] = tid < rows ? delta[(size_t)bh * n + q0 + tid] : 0.f;

  for (int c0 = 0; c0 < n; c0 += FB_STEP) {
    const int kc = min(FB_STEP, n - c0);
    __syncthreads();
    for (int i = tid; i < kc * d; i += FTHREADS) {
      const int r = i / d, e = i % d;
      ks[r * ldk + e] = to_f(kb[(size_t)(c0 + r) * rk.ts + e]);
      vs[r * ldk + e] = to_f(vb[(size_t)(c0 + r) * rv.ts + e]);
    }
    __syncthreads();
    for (int i = tid; i < FB_ROWS * FB_STEP; i += FTHREADS) {
      const int r = i / FB_STEP, j = i % FB_STEP;
      float x = 0.f;
      if (r < rows && j < kc) {
        const float* dr = dos + r * d;
        const float* vr = vs + j * ldk;
        float dp = 0.f;
        for (int e = 0; e < d; ++e) dp = fmaf(dr[e], vr[e], dp);
        const float pp = to_f(pb[(size_t)(q0 + r) * n + c0 + j]);
        x = round_to<T>(pp * (dp - dlr[r]) * scale);
      }
      ds[i] = x;
    }
    __syncthreads();
    for (int i = tid; i < FB_ROWS * d; i += FTHREADS) {
      const int r = i / d, e = i % d;
      const float* dsr = ds + r * FB_STEP;
      float a = acc[i];
      for (int j = 0; j < kc; ++j) a = fmaf(dsr[j], ks[j * ldk + e], a);
      acc[i] = a;
    }
  }
  const size_t row = (size_t)heads * d;
  T* out = dq + (size_t)(bh / heads) * n * row + (size_t)(bh % heads) * d;
  for (int i = tid; i < rows * d; i += FTHREADS)
    out[(size_t)(q0 + i / d) * row + i % d] = from_f<T>(acc[i]);
}

static size_t dkv_fma_smem(int d) {
  return ((size_t)FB_ROWS * (d + 1) + (size_t)2 * FB_ROWS * d +
          (size_t)2 * FB_STEP * (d + 1) + (size_t)2 * FB_ROWS * FB_STEP +
          FB_STEP) * sizeof(float);
}

// dk and dv for 16 keys of one batch-head: q and do stream in chunks of
// 32 queries, with the matching rows of p's key columns; p and ds are
// rounded to T before pᵀ·do and dsᵀ·q.
template <typename T>
__global__ void __launch_bounds__(FTHREADS)
bthd_bwd_dkv_fma(const T* __restrict__ q, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ delta,
                 const T* __restrict__ p, T* __restrict__ dk,
                 T* __restrict__ dv, Rows rq, Rows rv, Rows rdo, int heads,
                 int n, int d, float scale) {
  extern __shared__ __align__(16) unsigned char dkv_fma_smem_[];
  const int ld = d + 1;
  float* vs = reinterpret_cast<float*>(dkv_fma_smem_);  // [ROWS][ld]
  float* dka = vs + FB_ROWS * ld;                       // [ROWS][d]
  float* dva = dka + FB_ROWS * d;                       // [ROWS][d]
  float* qs = dva + FB_ROWS * d;                        // [STEP][ld]
  float* dos = qs + FB_STEP * ld;                       // [STEP][ld]
  float* pbuf = dos + FB_STEP * ld;                     // [ROWS][STEP]
  float* dsb = pbuf + FB_ROWS * FB_STEP;                // [ROWS][STEP]
  float* dlr = dsb + FB_ROWS * FB_STEP;                 // [STEP]

  const int bh = blockIdx.y, c0 = blockIdx.x * FB_ROWS;
  const int tid = threadIdx.x;
  const int keys = min(FB_ROWS, n - c0);
  const T* qb = q + head_at(rq, bh, heads, d);
  const T* vb = v + head_at(rv, bh, heads, d);
  const T* db = dout + head_at(rdo, bh, heads, d);
  const T* pb = p + (size_t)bh * n * n;

  for (int i = tid; i < FB_ROWS * d; i += FTHREADS) {
    const int c = i / d, e = i % d;
    vs[c * ld + e] = c < keys ? to_f(vb[(size_t)(c0 + c) * rv.ts + e]) : 0.f;
    dka[i] = dva[i] = 0.f;
  }

  for (int r0 = 0; r0 < n; r0 += FB_STEP) {
    const int rc = min(FB_STEP, n - r0);
    __syncthreads();
    for (int i = tid; i < rc * d; i += FTHREADS) {
      const int j = i / d, e = i % d;
      qs[j * ld + e] = to_f(qb[(size_t)(r0 + j) * rq.ts + e]);
      dos[j * ld + e] = to_f(db[(size_t)(r0 + j) * rdo.ts + e]);
    }
    if (tid < rc) dlr[tid] = delta[(size_t)bh * n + r0 + tid];
    __syncthreads();
    // consecutive threads take consecutive keys: one p row's run
    for (int i = tid; i < FB_ROWS * FB_STEP; i += FTHREADS) {
      const int j = i / FB_ROWS, c = i % FB_ROWS;
      float pp = 0.f, x = 0.f;
      if (c < keys && j < rc) {
        const float* vr = vs + c * ld;
        const float* dr = dos + j * ld;
        float dp = 0.f;
        for (int e = 0; e < d; ++e) dp = fmaf(vr[e], dr[e], dp);
        pp = to_f(pb[(size_t)(r0 + j) * n + c0 + c]);
        x = round_to<T>(pp * (dp - dlr[j]) * scale);
      }
      pbuf[c * FB_STEP + j] = pp;
      dsb[c * FB_STEP + j] = x;
    }
    __syncthreads();
    for (int i = tid; i < FB_ROWS * d; i += FTHREADS) {
      const int c = i / d, e = i % d;
      const float* pr = pbuf + c * FB_STEP;
      const float* sr = dsb + c * FB_STEP;
      float a = dva[i], b = dka[i];
      for (int j = 0; j < rc; ++j) {
        a = fmaf(pr[j], dos[j * ld + e], a);
        b = fmaf(sr[j], qs[j * ld + e], b);
      }
      dva[i] = a;
      dka[i] = b;
    }
  }
  const size_t row = (size_t)heads * d;
  const size_t ob =
      (size_t)(bh / heads) * n * row + (size_t)(bh % heads) * d;
  for (int i = tid; i < keys * d; i += FTHREADS) {
    const size_t at = ob + (size_t)(c0 + i / d) * row + i % d;
    dk[at] = from_f<T>(dka[i]);
    dv[at] = from_f<T>(dva[i]);
  }
}

template <typename T>
static cudaError_t launch_fma(const void* q, const void* k, const void* v,
                              const void* dout, const float* delta,
                              const void* p, void* dq, void* dk, void* dv,
                              int bh, int n, int d, Rows rq, Rows rk,
                              Rows rv, Rows rdo, int heads, float scale,
                              cudaStream_t st) {
  const size_t s1 = dq_fma_smem(d), s2 = dkv_fma_smem(d);
  cudaError_t err = allow_smem(bthd_bwd_dq_fma<T>, s1);
  if (err == cudaSuccess) err = allow_smem(bthd_bwd_dkv_fma<T>, s2);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + FB_ROWS - 1) / FB_ROWS, bh);
  bthd_bwd_dq_fma<T><<<grid, FTHREADS, s1, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), delta, static_cast<const T*>(p),
      static_cast<T*>(dq), rk, rv, rdo, heads, n, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bthd_bwd_dkv_fma<T><<<grid, FTHREADS, s2, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(v),
      static_cast<const T*>(dout), delta, static_cast<const T*>(p),
      static_cast<T*>(dk), static_cast<T*>(dv), rq, rv, rdo, heads, n, d,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Host entry point.  q, k, v, do: (batch, n, heads, d) with element
// (b, t, h, e) at b*x_bs + t*x_ts + h*d + e, bf16 (is_bf16 = 1) or
// float32; delta: (batch, heads, n) float32; p: (batch, heads, n, n) of
// the input type; dq, dk, dv: (batch, n, heads, d) contiguous.  For the
// tensor-core kernel (bf16, n = 128, d = 64) the bases and the strides in
// bytes are multiples of 16.  Launches on `stream` and returns the
// cudaError_t of the launch (0 = success).  The caller checks
// 1 <= n <= 512, 1 <= d <= 256 and batch, heads >= 1.
// ---------------------------------------------------------------------
extern "C" int flash_short_bthd_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* delta, const void* p, void* dq, void* dk, void* dv,
    int batch, int heads, int n, int d, long long q_bs, long long q_ts,
    long long k_bs, long long k_ts, long long v_bs, long long v_ts,
    long long do_bs, long long do_ts, float scale, int is_bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rows rq{q_bs, q_ts}, rk{k_bs, k_ts}, rv{v_bs, v_ts},
      rdo{do_bs, do_ts};
  const int bh = batch * heads;
  cudaError_t err;
  if (is_bf16 && n == BN && d == BD) {
    err = allow_smem(bthd_bwd_mma, MMA_SMEM);
    if (err == cudaSuccess) {
      bthd_bwd_mma<<<bh, NTHR, MMA_SMEM, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), delta,
          static_cast<const bf16*>(p), static_cast<bf16*>(dq),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), rq, rk, rv, rdo,
          heads, scale);
      err = cudaGetLastError();
    }
  } else if (is_bf16) {
    err = launch_fma<bf16>(q, k, v, dout, delta, p, dq, dk, dv, bh, n, d, rq,
                           rk, rv, rdo, heads, scale, st);
  } else {
    err = launch_fma<float>(q, k, v, dout, delta, p, dq, dk, dv, bh, n, d, rq,
                            rk, rv, rdo, heads, scale, st);
  }
  return static_cast<int>(err);
}
