// Streaming FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/flash_attention.py
// `_fwd_kernel` (:55), reached through `_fwd` / `_flash` /
// `flash_attention` for Tq != Tk, T > 512, or
// MXNET_FLASH_ATTENTION_SHORT=0.  For each batch-head bh and query row r
// it walks the key tiles with an online softmax:
//
//     s = q[r]·k[c]ᵀ·scale, masked (flash_common.cuh `fa_score`)
//     m' = max(m, max_c s); corr = exp(m - m'); p = exp(s - m')
//     l = l·corr + Σ p;  acc = acc·corr + round(p)·v    (f32 acc)
//     o[r] = acc / l (l == 0 -> 1), cast;  lse[r] = m + log(l)  (f32)
//
// with m starting at -1e30, p rounded to the input type before p·v, and
// the division by l only at the end, as the TPU kernel does.
//
// Design.  The TPU grid (bh, query tile, key tile) runs its key tiles in
// order and carries m, l and acc in VMEM scratch between grid steps.  A
// Hopper block carries nothing to the next block, so here a block owns a
// (bh, query tile) and loops over the key tiles itself.
//   * bf16, d = 64 (every BERT config of the repository): `fwd_mma`.
//     4 warps, 64 query rows (16 per warp), 64 keys per step.  K and V
//     stream through shared memory double-buffered with cp.async; each
//     warp keeps its rows' scores, m, l and f32 accumulator in mma.sync
//     registers, reuses the bf16 p as the A operand of p·v and reads V
//     with ldmatrix.trans.
//   * float32, and bf16 of other d <= 256: `fwd_fma`, 16 query rows per
//     block, scores and accumulator in shared memory, FMA loops in full
//     float32 (no TF32, as the TPU kernel's Precision.HIGHEST).
//   * Causal: key tiles past the block's last row are never loaded; a
//     row with kv_length > 0 stops at its length too (those keys add
//     exactly 0).  The JAX block sizes decide only which keys a row with
//     kv_length 0 averages (`fa_key_end`, `fa_score`).
//
// Bound on an H100 SXM at the training shape (BH = 4*12 = 48, T = 2048,
// d = 64, bf16, non-causal): 4*BH*T*T*d = 51.5 GFLOP of q·kᵀ and p·v take
// 0.052 ms at 989 TFLOP/s, while q, k, v, o and lse are 50.7 MB, 15 us at
// 3.35 TB/s: the kernel is bound by operations.  At the serving shape
// (BH = 16*12 = 192) 206 GFLOP, 0.208 ms.  The design keeps every score
// on the SM (nothing of size T*T touches device memory) and reads each
// K/V tile once per 64 query rows; wgmma, TMA and warp-specialised
// pipelines, which the bound needs, are later work.
#include "flash_common.cuh"

constexpr int MMA_D = 64;
constexpr int MMA_LD = MMA_D + 8;     // padded row: conflict-free fragments
constexpr int MMA_BQ = 64;            // query rows per block
constexpr int MMA_BK = 64;            // keys per step
constexpr int MMA_THREADS = 128;
constexpr size_t MMA_SMEM = (size_t)(MMA_BQ + 4 * MMA_BK) * MMA_LD * 2;

__global__ void __launch_bounds__(MMA_THREADS)
fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const int* __restrict__ lens,
        bf16* __restrict__ o, float* __restrict__ lse, FaGeo g) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fwd_smem);    // [BQ][LD], later o
  bf16* ks = qs + MMA_BQ * MMA_LD;                 // [2][BK][LD]
  bf16* vs = ks + 2 * MMA_BK * MMA_LD;             // [2][BK][LD]

  const int bh = blockIdx.y, q0 = blockIdx.x * MMA_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int len = max(lens[bh], 0);
  const bf16* qb = q + (size_t)bh * g.tq * MMA_D;
  const bf16* kb = k + (size_t)bh * g.tk * MMA_D;
  const bf16* vb = v + (size_t)bh * g.tk * MMA_D;
  const int kend = fa_key_end(min(q0 + MMA_BQ, g.tq) - 1, len, g);
  const int nkt = (kend + MMA_BK - 1) / MMA_BK;

  load_rows64<MMA_BQ, MMA_THREADS>(qs, MMA_LD, qb, q0, g.tq, tid);
  cp_async_commit();
  if (nkt > 0) {
    load_rows64<MMA_BK, MMA_THREADS>(ks, MMA_LD, kb, 0, g.tk, tid);
    load_rows64<MMA_BK, MMA_THREADS>(vs, MMA_LD, vb, 0, g.tk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int wrow = warp * 16 + gq;               // this lane's first row
  const int r0 = q0 + wrow, r1 = r0 + 8;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(qa[kk], qs, wrow, MMA_LD, kk, t);

  float m0 = FA_NEG_BIG, m1 = FA_NEG_BIG, l0 = 0.f, l1 = 0.f;
  float oc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
    oc[dt][0] = oc[dt][1] = oc[dt][2] = oc[dt][3] = 0.f;

  for (int it = 0; it < nkt; ++it) {
    if (it + 1 < nkt) {
      const int nb = (it + 1) & 1;
      load_rows64<MMA_BK, MMA_THREADS>(ks + nb * MMA_BK * MMA_LD, MMA_LD, kb,
                                       (it + 1) * MMA_BK, g.tk, tid);
      load_rows64<MMA_BK, MMA_THREADS>(vs + nb * MMA_BK * MMA_LD, MMA_LD, vb,
                                       (it + 1) * MMA_BK, g.tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + (it & 1) * MMA_BK * MMA_LD;
    const bf16* vt = vs + (it & 1) * MMA_BK * MMA_LD;

    float sc[8][4];
    mma_abt<8>(sc, qa, kt, MMA_LD, gq, t);

    // scale, then mask; the new row max starts from the running one
    const int c0 = it * MMA_BK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + nt * 8 + 2 * t + e;
        sc[nt][e] = fa_score(sc[nt][e] * g.scale, r0, c, len, g);
        sc[nt][2 + e] = fa_score(sc[nt][2 + e] * g.scale, r1, c, len, g);
        mx0 = fmaxf(mx0, sc[nt][e]);
        mx1 = fmaxf(mx1, sc[nt][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = expf(sc[nt][e] - mx0);
        sc[nt][2 + e] = expf(sc[nt][2 + e] - mx1);
        sum0 += sc[nt][e];
        sum1 += sc[nt][2 + e];
      }
    }
    l0 = l0 * corr0 + quad_sum(sum0);
    l1 = l1 * corr1 + quad_sum(sum1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      oc[dt][0] *= corr0;
      oc[dt][1] *= corr0;
      oc[dt][2] *= corr1;
      oc[dt][3] *= corr1;
    }

    uint32_t pa[4][4];             // p rounded to bf16: A of p·v
#pragma unroll
    for (int j = 0; j < 4; ++j) pack_a(pa[j], sc[2 * j], sc[2 * j + 1]);
    mma_ab<4>(oc, pa, vt, MMA_LD, lane);
    __syncthreads();               // the next step overwrites this buffer
  }

  const float safe0 = l0 == 0.f ? 1.f : l0, safe1 = l1 == 0.f ? 1.f : l1;
  // stage o in this warp's own q rows (no other warp reads them), then
  // store 16-byte row chunks
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    *reinterpret_cast<uint32_t*>(qs + wrow * MMA_LD + dt * 8 + 2 * t) =
        pack_bf16(oc[dt][0] / safe0, oc[dt][1] / safe0);
    *reinterpret_cast<uint32_t*>(qs + (wrow + 8) * MMA_LD + dt * 8 + 2 * t) =
        pack_bf16(oc[dt][2] / safe1, oc[dt][3] / safe1);
  }
  __syncwarp();
  bf16* ob = o + (size_t)bh * g.tq * MMA_D;
  for (int i = lane; i < 16 * 8; i += 32) {
    const int rr = warp * 16 + i / 8, cc = (i % 8) * 8;
    if (q0 + rr < g.tq)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + rr) * MMA_D + cc) =
          *reinterpret_cast<const uint4*>(qs + rr * MMA_LD + cc);
  }
  if (t == 0) {
    float* lb = lse + (size_t)bh * g.tq;
    if (r0 < g.tq) lb[r0] = m0 + logf(safe0);
    if (r1 < g.tq) lb[r1] = m1 + logf(safe1);
  }
}

// ---------------------------------------------------------------------
// FMA kernel: float32, and bf16 of any d <= 256.  16 query rows per
// block; keys in chunks of 32, one warp per row for the online softmax
// (lane j owns key j of the chunk).
// ---------------------------------------------------------------------
constexpr int FMA_BQ = 16;
constexpr int FMA_BK = 32;            // = warp size: one key per lane
constexpr int FMA_THREADS = 128;

static size_t fma_smem(int d) {
  return ((size_t)2 * FMA_BQ * d + (size_t)FMA_BK * (d + 1) +
          (size_t)FMA_BQ * FMA_BK + 3 * FMA_BQ) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(FMA_THREADS)
fwd_fma(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const int* __restrict__ lens,
        T* __restrict__ o, float* __restrict__ lse, FaGeo g) {
  extern __shared__ __align__(16) unsigned char fwd_fma_smem[];
  const int d = g.d, ldk = d + 1;
  float* qs = reinterpret_cast<float*>(fwd_fma_smem);   // [BQ][d]
  float* acc = qs + FMA_BQ * d;                         // [BQ][d]
  float* kv = acc + FMA_BQ * d;                         // [BK][ldk]
  float* s = kv + FMA_BK * ldk;                         // [BQ][BK]
  float* mrow = s + FMA_BQ * FMA_BK;                    // [BQ]
  float* lrow = mrow + FMA_BQ;                          // [BQ]
  float* crow = lrow + FMA_BQ;                          // [BQ]

  const int bh = blockIdx.y, q0 = blockIdx.x * FMA_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = max(lens[bh], 0);
  const size_t qbase = (size_t)bh * g.tq * d, kbase = (size_t)bh * g.tk * d;
  const int rows = min(FMA_BQ, g.tq - q0);
  const int kend = fa_key_end(q0 + rows - 1, len, g);

  load_rows_f32<T>(qs, d, q + qbase, q0, FMA_BQ, g.tq, d, tid, FMA_THREADS);
  for (int i = tid; i < FMA_BQ * d; i += FMA_THREADS) acc[i] = 0.f;
  if (tid < FMA_BQ) {
    mrow[tid] = FA_NEG_BIG;
    lrow[tid] = 0.f;
  }

  for (int c0 = 0; c0 < kend; c0 += FMA_BK) {
    const int kc = min(FMA_BK, g.tk - c0);
    __syncthreads();
    load_rows_f32<T>(kv, ldk, k + kbase, c0, kc, g.tk, d, tid, FMA_THREADS);
    __syncthreads();
    for (int i = tid; i < FMA_BQ * FMA_BK; i += FMA_THREADS) {
      const int r = i / FMA_BK, j = i % FMA_BK;
      float dot = 0.f;
      if (j < kc) {
        const float* qr = qs + r * d;
        const float* kr = kv + j * ldk;
        for (int e = 0; e < d; ++e) dot = fmaf(qr[e], kr[e], dot);
      }
      s[i] = fa_score(dot * g.scale, q0 + r, c0 + j, len, g);
    }
    __syncthreads();
    for (int r = warp; r < FMA_BQ; r += FMA_THREADS / 32) {
      const float x = s[r * FMA_BK + lane];
      const float m_prev = mrow[r];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = expf(x - m_new);
      const float corr = expf(m_prev - m_new);
      const float l_new = lrow[r] * corr + warp_sum(p);
      s[r * FMA_BK + lane] = round_to<T>(p);
      __syncwarp();
      if (lane == 0) {
        mrow[r] = m_new;
        lrow[r] = l_new;
        crow[r] = corr;
      }
    }
    __syncthreads();
    load_rows_f32<T>(kv, ldk, v + kbase, c0, kc, g.tk, d, tid, FMA_THREADS);
    __syncthreads();
    for (int i = tid; i < FMA_BQ * d; i += FMA_THREADS) {
      const int r = i / d, e = i % d;
      const float* pr = s + r * FMA_BK;
      float a = acc[i] * crow[r];
      for (int j = 0; j < kc; ++j) a = fmaf(pr[j], kv[j * ldk + e], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * d; i += FMA_THREADS) {
    const int r = i / d;
    const float l = lrow[r];
    o[qbase + (size_t)q0 * d + i] = from_f<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
  if (tid < rows) {
    const float l = lrow[tid];
    lse[(size_t)bh * g.tq + q0 + tid] = mrow[tid] + logf(l == 0.f ? 1.f : l);
  }
}

// ---------------------------------------------------------------------
// Host entry point
// ---------------------------------------------------------------------
template <typename T>
static cudaError_t launch_fma(const void* q, const void* k, const void* v,
                              const int* lens, void* o, float* lse, int bh,
                              const FaGeo& g, cudaStream_t st) {
  const size_t smem = fma_smem(g.d);
  cudaError_t err = allow_smem(fwd_fma<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.tq + FMA_BQ - 1) / FMA_BQ, bh);
  fwd_fma<T><<<grid, FMA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(o), lse, g);
  return cudaGetLastError();
}

// q, o: (bh, tq, d); k, v: (bh, tk, d), contiguous, bf16 (is_bf16 = 1) or
// float32; lens: (bh,) int32; lse: (bh, tq) float32.  block_q, block_k are
// the JAX block sizes after `_fit_block`.  Launches on `stream` and
// returns the cudaError_t of the launch (0 = success).  The caller checks
// bh, tq, tk >= 1 and 1 <= d <= 256.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* lens, void* o, float* lse, int bh,
                         int tq, int tk, int d, int causal, int block_q,
                         int block_k, int is_bf16, float scale,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FaGeo g{tq, tk, d, causal, block_q, block_k, scale};
  cudaError_t err;
  if (is_bf16 && d == MMA_D) {
    err = allow_smem(fwd_mma, MMA_SMEM);
    if (err == cudaSuccess) {
      dim3 grid((tq + MMA_BQ - 1) / MMA_BQ, bh);
      fwd_mma<<<grid, MMA_THREADS, MMA_SMEM, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), lens, static_cast<bf16*>(o), lse, g);
      err = cudaGetLastError();
    }
  } else if (is_bf16) {
    err = launch_fma<bf16>(q, k, v, lens, o, lse, bh, g, st);
  } else {
    err = launch_fma<float>(q, k, v, lens, o, lse, bh, g, st);
  }
  return static_cast<int>(err);
}
