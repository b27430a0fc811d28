// Streaming FlashAttention-2 backward for Hopper (sm_90a): dq, and dk/dv.
//
// Replaces the TPU kernels incubator_mxnet_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (:140) and `_bwd_dkv_kernel` (:176), both launched by
// `_bwd` (:217), the custom VJP of `_flash`.  From q, k, v, do, the
// forward's lse and delta = rowsum(do·o) (f32, computed outside the
// kernels as `_bwd` does) they recompute, tile by tile,
//
//     s = q·kᵀ·scale, masked (flash_common.cuh `fa_score`)
//     p = exp(s - lse);  dp = do·vᵀ;  ds = p·(dp - delta)·scale
//     dq = Σ round(ds)·k;  dv = Σ round(p)ᵀ·do;  dk = Σ round(ds)ᵀ·q
//
// with f32 accumulation and p, ds rounded to the input type before each
// product, as the TPU kernels do.  A row with kv_length 0 has lse = -1e30
// and p = 1 on every key of the key tiles the TPU grid visits.
//
// Design.  The TPU grid runs its last dimension in order and carries the
// accumulators in VMEM scratch; a Hopper block carries nothing, so each
// block loops itself:
//   * `flash_bwd_dq`: one block per (bh, 64 query rows), looping over key
//     tiles of 64; q and do stay in mma.sync registers, K and V stream
//     through shared memory double-buffered with cp.async, ds is reused
//     from the accumulators as the A operand of ds·k (K read with
//     ldmatrix.trans).
//   * `flash_bwd_dkv`: one block per (bh, 64 keys), looping over query
//     tiles of 64 (two halves of 32 rows per step to bound registers); k
//     and v stay in registers as the A operands of sᵀ = k·qᵀ and
//     dpᵀ = v·doᵀ, Q, dO, lse and delta stream double-buffered.  Each
//     block owns its key rows, so no atomics are needed.
//   * bf16 with d = 64 takes those tensor-core kernels; float32 and other
//     d <= 256 take FMA kernels in full float32 (`bwd_dq_fma`,
//     `bwd_dkv_fma`).
//   * Causal: tiles wholly above the diagonal are never loaded, and keys
//     at or past a row's kv_length (> 0) neither.
//
// Bound on an H100 SXM at the training shape (BH = 48, T = 2048, d = 64,
// bf16, non-causal): dq recomputes s and computes dp and ds·k,
// 6*BH*T*T*d = 77.3 GFLOP, 0.078 ms at 989 TFLOP/s; dk/dv computes s,
// dp, pᵀ·do and dsᵀ·q, 8*BH*T*T*d = 103 GFLOP, 0.104 ms; the bytes (q, k,
// v, do, lse, delta in, dq or dk and dv out) are ~40-50 MB, ~15 us.  Both
// are bound by operations.  The scores never leave the SM; wgmma and TMA
// are later work.
#include "flash_common.cuh"

constexpr int D = 64;
constexpr int LD = D + 8;             // padded row: conflict-free fragments
constexpr int BQ = 64;                // query rows of a tile
constexpr int BK = 64;                // keys of a tile
constexpr int THREADS = 128;

// ---------------------------------------------------------------------
// dq, tensor cores
// ---------------------------------------------------------------------
constexpr size_t DQ_SMEM = (size_t)(2 * BQ + 4 * BK) * LD * 2;

__global__ void __launch_bounds__(THREADS)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ lens, bf16* __restrict__ dq, FaGeo g) {
  extern __shared__ __align__(16) unsigned char dq_smem[];
  bf16* qs = reinterpret_cast<bf16*>(dq_smem);     // [BQ][LD], later dq
  bf16* dos = qs + BQ * LD;                        // [BQ][LD]
  bf16* ks = dos + BQ * LD;                        // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                     // [2][BK][LD]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int len = max(lens[bh], 0);
  const size_t qoff = (size_t)bh * g.tq * D, koff = (size_t)bh * g.tk * D;
  const int kend = fa_key_end(min(q0 + BQ, g.tq) - 1, len, g);
  const int nkt = (kend + BK - 1) / BK;

  load_rows64<BQ, THREADS>(qs, LD, q + qoff, q0, g.tq, tid);
  load_rows64<BQ, THREADS>(dos, LD, dout + qoff, q0, g.tq, tid);
  cp_async_commit();
  if (nkt > 0) {
    load_rows64<BK, THREADS>(ks, LD, k + koff, 0, g.tk, tid);
    load_rows64<BK, THREADS>(vs, LD, v + koff, 0, g.tk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int wrow = warp * 16 + gq;
  const int r0 = q0 + wrow, r1 = r0 + 8;
  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a(qa[kk], qs, wrow, LD, kk, t);
    load_a(da[kk], dos, wrow, LD, kk, t);
  }
  const float* lb = lse + (size_t)bh * g.tq;
  const float* db = delta + (size_t)bh * g.tq;
  const float lse0 = r0 < g.tq ? lb[r0] : 0.f, lse1 = r1 < g.tq ? lb[r1] : 0.f;
  const float dl0 = r0 < g.tq ? db[r0] : 0.f, dl1 = r1 < g.tq ? db[r1] : 0.f;

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int it = 0; it < nkt; ++it) {
    if (it + 1 < nkt) {
      const int nb = (it + 1) & 1;
      load_rows64<BK, THREADS>(ks + nb * BK * LD, LD, k + koff,
                               (it + 1) * BK, g.tk, tid);
      load_rows64<BK, THREADS>(vs + nb * BK * LD, LD, v + koff,
                               (it + 1) * BK, g.tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + (it & 1) * BK * LD;
    const bf16* vt = vs + (it & 1) * BK * LD;

    float sc[8][4], dp[8][4];
    mma_abt<8>(sc, qa, kt, LD, gq, t);
    mma_abt<8>(dp, da, vt, LD, gq, t);
    const int c0 = it * BK;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + nt * 8 + 2 * t + e;
        const float p0 =
            expf(fa_score(sc[nt][e] * g.scale, r0, c, len, g) - lse0);
        const float p1 =
            expf(fa_score(sc[nt][2 + e] * g.scale, r1, c, len, g) - lse1);
        sc[nt][e] = p0 * (dp[nt][e] - dl0) * g.scale;
        sc[nt][2 + e] = p1 * (dp[nt][2 + e] - dl1) * g.scale;
      }
    }
    uint32_t dsa[4][4];            // ds rounded to bf16: A of ds·k
#pragma unroll
    for (int j = 0; j < 4; ++j) pack_a(dsa[j], sc[2 * j], sc[2 * j + 1]);
    mma_ab<4>(acc, dsa, kt, LD, lane);
    __syncthreads();
  }

  // stage dq in this warp's own q rows, then store 16-byte row chunks
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    *reinterpret_cast<uint32_t*>(qs + wrow * LD + dt * 8 + 2 * t) =
        pack_bf16(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(qs + (wrow + 8) * LD + dt * 8 + 2 * t) =
        pack_bf16(acc[dt][2], acc[dt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * 8; i += 32) {
    const int rr = warp * 16 + i / 8, cc = (i % 8) * 8;
    if (q0 + rr < g.tq)
      *reinterpret_cast<uint4*>(dq + qoff + (size_t)(q0 + rr) * D + cc) =
          *reinterpret_cast<const uint4*>(qs + rr * LD + cc);
  }
}

// ---------------------------------------------------------------------
// dk and dv, tensor cores
// ---------------------------------------------------------------------
constexpr size_t DKV_SMEM =
    (size_t)(2 * BK + 4 * BQ) * LD * 2 + 4 * BQ * sizeof(float);

__global__ void __launch_bounds__(THREADS)
bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ lens, bf16* __restrict__ dk,
            bf16* __restrict__ dv, FaGeo g) {
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  bf16* ks = reinterpret_cast<bf16*>(dkv_smem);    // [BK][LD], later dk
  bf16* vs = ks + BK * LD;                         // [BK][LD], later dv
  bf16* qs = vs + BK * LD;                         // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;                    // [2][BQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * LD);   // [2][BQ]
  float* dls = ls + 2 * BQ;                                  // [2][BQ]

  const int bh = blockIdx.y, c0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int len = max(lens[bh], 0);
  const size_t qoff = (size_t)bh * g.tq * D, koff = (size_t)bh * g.tk * D;
  const float* lb = lse + (size_t)bh * g.tq;
  const float* db = delta + (size_t)bh * g.tq;
  const int rbegin = (fa_row_begin(c0, len, g) / BQ) * BQ;
  const int nqt = rbegin < g.tq ? (g.tq - rbegin + BQ - 1) / BQ : 0;

  // the q, do, lse and delta rows of query tile `i` into buffer `b`
  auto load_q_tile = [&](int i, int b) {
    const int row0 = rbegin + i * BQ;
    load_rows64<BQ, THREADS>(qs + b * BQ * LD, LD, q + qoff, row0, g.tq,
                             tid);
    load_rows64<BQ, THREADS>(dos + b * BQ * LD, LD, dout + qoff, row0, g.tq,
                             tid);
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool ok = row0 + r < g.tq;
      const float* src = (tid < BQ ? lb : db) + (ok ? row0 + r : 0);
      cp_async4((tid < BQ ? ls : dls) + b * BQ + r, src, ok);
    }
  };

  load_rows64<BK, THREADS>(ks, LD, k + koff, c0, g.tk, tid);
  load_rows64<BK, THREADS>(vs, LD, v + koff, c0, g.tk, tid);
  cp_async_commit();
  if (nqt > 0) load_q_tile(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int wrow = warp * 16 + gq;               // this lane's first key
  const int key0 = c0 + wrow, key1 = key0 + 8;
  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a(ka[kk], ks, wrow, LD, kk, t);
    load_a(va[kk], vs, wrow, LD, kk, t);
  }

  float dkc[8][4], dvc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    dkc[dt][0] = dkc[dt][1] = dkc[dt][2] = dkc[dt][3] = 0.f;
    dvc[dt][0] = dvc[dt][1] = dvc[dt][2] = dvc[dt][3] = 0.f;
  }

  for (int it = 0; it < nqt; ++it) {
    if (it + 1 < nqt) load_q_tile(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int b = it & 1;
    const int row0 = rbegin + it * BQ;
#pragma unroll
    for (int h = 0; h < 2; ++h) {          // two halves of 32 query rows
      const bf16* qt = qs + (b * BQ + h * 32) * LD;
      const bf16* dt_ = dos + (b * BQ + h * 32) * LD;
      const float* lt = ls + b * BQ + h * 32;
      const float* dlt = dls + b * BQ + h * 32;
      float sc[4][4], dp[4][4];
      mma_abt<4>(sc, ka, qt, LD, gq, t);   // sᵀ = k·qᵀ
      mma_abt<4>(dp, va, dt_, LD, gq, t);  // dpᵀ = v·doᵀ
      float ds[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = nt * 8 + 2 * t + (e & 1);     // row in the half
          const int key = e < 2 ? key0 : key1;
          const float p = expf(
              fa_score(sc[nt][e] * g.scale, row0 + h * 32 + rl, key, len, g) -
              lt[rl]);
          ds[nt][e] = p * (dp[nt][e] - dlt[rl]) * g.scale;
          sc[nt][e] = p;
        }
      }
      uint32_t pa[2][4], dsa[2][4];        // k-steps of 16 query rows
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        pack_a(pa[j], sc[2 * j], sc[2 * j + 1]);
        pack_a(dsa[j], ds[2 * j], ds[2 * j + 1]);
      }
      mma_ab<2>(dvc, pa, dt_, LD, lane);   // dv += pᵀ·do
      mma_ab<2>(dkc, dsa, qt, LD, lane);   // dk += dsᵀ·q
    }
    __syncthreads();
  }

  // stage dk and dv in this warp's own k and v rows, then store
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ks + wrow * LD + c) =
        pack_bf16(dkc[dt][0], dkc[dt][1]);
    *reinterpret_cast<uint32_t*>(ks + (wrow + 8) * LD + c) =
        pack_bf16(dkc[dt][2], dkc[dt][3]);
    *reinterpret_cast<uint32_t*>(vs + wrow * LD + c) =
        pack_bf16(dvc[dt][0], dvc[dt][1]);
    *reinterpret_cast<uint32_t*>(vs + (wrow + 8) * LD + c) =
        pack_bf16(dvc[dt][2], dvc[dt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * 8; i += 32) {
    const int rr = warp * 16 + i / 8, cc = (i % 8) * 8;
    if (c0 + rr < g.tk) {
      const size_t off = koff + (size_t)(c0 + rr) * D + cc;
      *reinterpret_cast<uint4*>(dk + off) =
          *reinterpret_cast<const uint4*>(ks + rr * LD + cc);
      *reinterpret_cast<uint4*>(dv + off) =
          *reinterpret_cast<const uint4*>(vs + rr * LD + cc);
    }
  }
}

// ---------------------------------------------------------------------
// FMA kernels: float32, and bf16 of any d <= 256.
// ---------------------------------------------------------------------
constexpr int FB_ROWS = 16;          // rows a block owns (queries or keys)
constexpr int FB_STEP = 32;          // rows of the other side per step

static size_t dq_fma_smem(int d) {
  return ((size_t)3 * FB_ROWS * d + (size_t)2 * FB_STEP * (d + 1) +
          (size_t)FB_ROWS * FB_STEP + 2 * FB_ROWS) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dq_fma(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ lens, T* __restrict__ dq, FaGeo g) {
  extern __shared__ __align__(16) unsigned char dq_fma_smem_[];
  const int d = g.d, ldk = d + 1;
  float* qs = reinterpret_cast<float*>(dq_fma_smem_);   // [ROWS][d]
  float* dos = qs + FB_ROWS * d;                        // [ROWS][d]
  float* acc = dos + FB_ROWS * d;                       // [ROWS][d]
  float* ks = acc + FB_ROWS * d;                        // [STEP][ldk]
  float* vs = ks + FB_STEP * ldk;                       // [STEP][ldk]
  float* ds = vs + FB_STEP * ldk;                       // [ROWS][STEP]
  float* lr = ds + FB_ROWS * FB_STEP;                   // [ROWS]
  float* dlr = lr + FB_ROWS;                            // [ROWS]

  const int bh = blockIdx.y, q0 = blockIdx.x * FB_ROWS;
  const int tid = threadIdx.x;
  const int len = max(lens[bh], 0);
  const size_t qoff = (size_t)bh * g.tq * d, koff = (size_t)bh * g.tk * d;
  const int rows = min(FB_ROWS, g.tq - q0);
  const int kend = fa_key_end(q0 + rows - 1, len, g);

  load_rows_f32<T>(qs, d, q + qoff, q0, FB_ROWS, g.tq, d, tid, THREADS);
  load_rows_f32<T>(dos, d, dout + qoff, q0, FB_ROWS, g.tq, d, tid, THREADS);
  for (int i = tid; i < FB_ROWS * d; i += THREADS) acc[i] = 0.f;
  if (tid < FB_ROWS) {
    const bool ok = tid < rows;
    lr[tid] = ok ? lse[(size_t)bh * g.tq + q0 + tid] : 0.f;
    dlr[tid] = ok ? delta[(size_t)bh * g.tq + q0 + tid] : 0.f;
  }

  for (int c0 = 0; c0 < kend; c0 += FB_STEP) {
    const int kc = min(FB_STEP, g.tk - c0);
    __syncthreads();
    load_rows_f32<T>(ks, ldk, k + koff, c0, kc, g.tk, d, tid, THREADS);
    load_rows_f32<T>(vs, ldk, v + koff, c0, kc, g.tk, d, tid, THREADS);
    __syncthreads();
    for (int i = tid; i < FB_ROWS * FB_STEP; i += THREADS) {
      const int r = i / FB_STEP, j = i % FB_STEP;
      float s = 0.f, dp = 0.f;
      if (j < kc) {
        const float* qr = qs + r * d;
        const float* dr = dos + r * d;
        const float* kr = ks + j * ldk;
        const float* vr = vs + j * ldk;
        for (int e = 0; e < d; ++e) {
          s = fmaf(qr[e], kr[e], s);
          dp = fmaf(dr[e], vr[e], dp);
        }
      }
      const float p =
          expf(fa_score(s * g.scale, q0 + r, c0 + j, len, g) - lr[r]);
      ds[i] = round_to<T>(p * (dp - dlr[r]) * g.scale);
    }
    __syncthreads();
    for (int i = tid; i < FB_ROWS * d; i += THREADS) {
      const int r = i / d, e = i % d;
      const float* dsr = ds + r * FB_STEP;
      float a = acc[i];
      for (int j = 0; j < kc; ++j) a = fmaf(dsr[j], ks[j * ldk + e], a);
      acc[i] = a;
    }
  }
  for (int i = tid; i < rows * d; i += THREADS)
    dq[qoff + (size_t)q0 * d + i] = from_f<T>(acc[i]);
}

static size_t dkv_fma_smem(int d) {
  return ((size_t)4 * FB_ROWS * d + (size_t)2 * FB_STEP * (d + 1) +
          (size_t)2 * FB_ROWS * FB_STEP + 2 * FB_STEP) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_fma(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ lens, T* __restrict__ dk,
            T* __restrict__ dv, FaGeo g) {
  extern __shared__ __align__(16) unsigned char dkv_fma_smem_[];
  const int d = g.d, ldq = d + 1;
  float* ks = reinterpret_cast<float*>(dkv_fma_smem_);  // [ROWS][d]
  float* vs = ks + FB_ROWS * d;                         // [ROWS][d]
  float* dka = vs + FB_ROWS * d;                        // [ROWS][d]
  float* dva = dka + FB_ROWS * d;                       // [ROWS][d]
  float* qs = dva + FB_ROWS * d;                        // [STEP][ldq]
  float* dos = qs + FB_STEP * ldq;                      // [STEP][ldq]
  float* pb = dos + FB_STEP * ldq;                      // [ROWS][STEP]
  float* dsb = pb + FB_ROWS * FB_STEP;                  // [ROWS][STEP]
  float* lr = dsb + FB_ROWS * FB_STEP;                  // [STEP]
  float* dlr = lr + FB_STEP;                            // [STEP]

  const int bh = blockIdx.y, c0 = blockIdx.x * FB_ROWS;
  const int tid = threadIdx.x;
  const int len = max(lens[bh], 0);
  const size_t qoff = (size_t)bh * g.tq * d, koff = (size_t)bh * g.tk * d;
  const int keys = min(FB_ROWS, g.tk - c0);
  const int rbegin = (fa_row_begin(c0, len, g) / FB_STEP) * FB_STEP;

  load_rows_f32<T>(ks, d, k + koff, c0, FB_ROWS, g.tk, d, tid, THREADS);
  load_rows_f32<T>(vs, d, v + koff, c0, FB_ROWS, g.tk, d, tid, THREADS);
  for (int i = tid; i < FB_ROWS * d; i += THREADS) dka[i] = dva[i] = 0.f;

  for (int r0 = rbegin; r0 < g.tq; r0 += FB_STEP) {
    const int rc = min(FB_STEP, g.tq - r0);
    __syncthreads();
    load_rows_f32<T>(qs, ldq, q + qoff, r0, rc, g.tq, d, tid, THREADS);
    load_rows_f32<T>(dos, ldq, dout + qoff, r0, rc, g.tq, d, tid, THREADS);
    if (tid < FB_STEP) {
      const bool ok = tid < rc;
      lr[tid] = ok ? lse[(size_t)bh * g.tq + r0 + tid] : 0.f;
      dlr[tid] = ok ? delta[(size_t)bh * g.tq + r0 + tid] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FB_ROWS * FB_STEP; i += THREADS) {
      const int c = i / FB_STEP, j = i % FB_STEP;
      float s = 0.f, dp = 0.f;
      if (j < rc) {
        const float* kr = ks + c * d;
        const float* vr = vs + c * d;
        const float* qr = qs + j * ldq;
        const float* dr = dos + j * ldq;
        for (int e = 0; e < d; ++e) {
          s = fmaf(kr[e], qr[e], s);
          dp = fmaf(vr[e], dr[e], dp);
        }
      }
      const float p =
          expf(fa_score(s * g.scale, r0 + j, c0 + c, len, g) - lr[j]);
      pb[i] = round_to<T>(p);
      dsb[i] = round_to<T>(p * (dp - dlr[j]) * g.scale);
    }
    __syncthreads();
    for (int i = tid; i < FB_ROWS * d; i += THREADS) {
      const int c = i / d, e = i % d;
      const float* pr = pb + c * FB_STEP;
      const float* dr = dsb + c * FB_STEP;
      float a = dva[i], b = dka[i];
      for (int j = 0; j < rc; ++j) {
        a = fmaf(pr[j], dos[j * ldq + e], a);
        b = fmaf(dr[j], qs[j * ldq + e], b);
      }
      dva[i] = a;
      dka[i] = b;
    }
  }
  for (int i = tid; i < keys * d; i += THREADS) {
    dk[koff + (size_t)c0 * d + i] = from_f<T>(dka[i]);
    dv[koff + (size_t)c0 * d + i] = from_f<T>(dva[i]);
  }
}

// ---------------------------------------------------------------------
// Host entry points.  q, do, dq: (bh, tq, d); k, v, dk, dv: (bh, tk, d),
// contiguous, bf16 (is_bf16 = 1) or float32; lse, delta: (bh, tq) float32;
// lens: (bh,) int32.  block_q, block_k are the JAX block sizes after
// `_fit_block`.  Each launches on `stream` and returns the cudaError_t of
// the launch (0 = success).  The caller checks bh, tq, tk >= 1 and
// 1 <= d <= 256.
// ---------------------------------------------------------------------
template <typename T>
static cudaError_t launch_dq_fma(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* lens,
                                 void* dq, int bh, const FaGeo& g,
                                 cudaStream_t st) {
  const size_t smem = dq_fma_smem(g.d);
  cudaError_t err = allow_smem(bwd_dq_fma<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.tq + FB_ROWS - 1) / FB_ROWS, bh);
  bwd_dq_fma<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lens, static_cast<T*>(dq), g);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_dkv_fma(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  const int* lens, void* dk, void* dv,
                                  int bh, const FaGeo& g, cudaStream_t st) {
  const size_t smem = dkv_fma_smem(g.d);
  cudaError_t err = allow_smem(bwd_dkv_fma<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.tk + FB_ROWS - 1) / FB_ROWS, bh);
  bwd_dkv_fma<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lens, static_cast<T*>(dk), static_cast<T*>(dv), g);
  return cudaGetLastError();
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* lens, void* dq,
                            int bh, int tq, int tk, int d, int causal,
                            int block_q, int block_k, int is_bf16,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FaGeo g{tq, tk, d, causal, block_q, block_k, scale};
  cudaError_t err;
  if (is_bf16 && d == D) {
    err = allow_smem(bwd_dq_mma, DQ_SMEM);
    if (err == cudaSuccess) {
      dim3 grid((tq + BQ - 1) / BQ, bh);
      bwd_dq_mma<<<grid, THREADS, DQ_SMEM, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
          delta, lens, static_cast<bf16*>(dq), g);
      err = cudaGetLastError();
    }
  } else if (is_bf16) {
    err = launch_dq_fma<bf16>(q, k, v, dout, lse, delta, lens, dq, bh, g, st);
  } else {
    err = launch_dq_fma<float>(q, k, v, dout, lse, delta, lens, dq, bh, g,
                               st);
  }
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* lens, void* dk,
                             void* dv, int bh, int tq, int tk, int d,
                             int causal, int block_q, int block_k,
                             int is_bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FaGeo g{tq, tk, d, causal, block_q, block_k, scale};
  cudaError_t err;
  if (is_bf16 && d == D) {
    err = allow_smem(bwd_dkv_mma, DKV_SMEM);
    if (err == cudaSuccess) {
      dim3 grid((tk + BK - 1) / BK, bh);
      bwd_dkv_mma<<<grid, THREADS, DKV_SMEM, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
          delta, lens, static_cast<bf16*>(dk), static_cast<bf16*>(dv), g);
      err = cudaGetLastError();
    }
  } else if (is_bf16) {
    err = launch_dkv_fma<bf16>(q, k, v, dout, lse, delta, lens, dk, dv, bh, g,
                               st);
  } else {
    err = launch_dkv_fma<float>(q, k, v, dout, lse, delta, lens, dk, dv, bh,
                                g, st);
  }
  return static_cast<int>(err);
}
