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
//   * bf16, T = 128, d = 64 (BERT's training shape): `bthd_bwd_tma`, one
//     persistent block an SM walking the batch-heads bh = blockIdx.x,
//     + gridDim.x, ...  A producer warpgroup, whose first warp works,
//     loads each batch-head's q, k, v, do (through a tensor map each,
//     with that tensor's own row and batch strides, 128 x 64 boxes) and
//     p (two 128 x 64 boxes: the queries of keys 0-63 and of 64-127) by
//     TMA, and delta (512 bytes, a row a lane) by cp.async arriving on
//     the stage's barrier, into a ring of 2 stages, so that the next
//     batch-head's loads run under this one's math; the rest of the
//     warpgroup gives its registers away (`setmaxnreg`: 24 a thread, 240
//     to each consumer thread).  Shared memory holds what TMA writes:
//     128-byte rows in 128-byte swizzle (`sw128_at`), which wgmma's
//     descriptors and the elementwise loads address, 96 KiB a stage (q,
//     k, v, do 16 KiB each, p 32 KiB) plus 512 bytes of delta: 193 KiB
//     with 1 KiB to align the ring.  ptxas (-Xptxas -v): 168 registers a
//     thread at launch (240 for a consumer), 8 bytes of stack.
//   * Two consumer warpgroups; consumer c owns keys 64c..64c+63.
//     dpᵀ = v·doᵀ (wgmma m64n128k16, v's and do's rows K-major); dsᵀ =
//     (pᵀ·(dpᵀ − delta))·scale rounded to bf16 in the accumulators, pᵀ
//     read from the consumer's p box and ds written back over it
//     (`bthd_ds`); dv = pᵀ·do and dk = dsᵀ·q (wgmma m64n64k16 with pᵀ,
//     dsᵀ as the register operand and do, q read N-major: their rows are
//     the queries).  Then, once both consumers' ds are in shared memory
//     (a named barrier), consumer c owns queries 64c..64c+63: dq = ds·k
//     (wgmma, ds K-major from the two p boxes, k N-major).  The products
//     are wgmma because every operand is already in shared memory as TMA
//     wrote it, and one instruction of a warpgroup covers what 16
//     mma.sync and their ldmatrix loads did.  dq, dk and dv are rounded
//     once to bf16 into the stage buffers they replace (q → dq, do → dk,
//     v → dv: v's rows once dpᵀ has read them, q and do once both
//     consumers' products have) and leave by TMA store; each consumer
//     gives the stage back once its stores have read it, after the next
//     batch-head's first products are issued.  Each block owns its
//     batch-heads, so no atomics, and two launches give the same bits.
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
// bound by memory.  It reads every input byte once and writes every
// output once; the scores' (T, T) intermediates never leave the SM.  The
// 720 batch-heads make 5.45 rounds of 132 blocks, so the SMs that take 6
// set the time.
#include "flash_common.cuh"
#include "hopper_common.cuh"

// ---------------------------------------------------------------------
// Persistent TMA + wgmma kernel: bf16, T = 128, d = 64.
// ---------------------------------------------------------------------
namespace bt {
constexpr int N = 128, D = 64;          // the one shape of this kernel
constexpr int STAGES = 2;
constexpr int TILE = N * D * 2;         // q, k, v or do of a head: 16 KB
constexpr int BOX = 64 * D * 2;         // 64 rows of one: 8 KB
constexpr int STAGE = 6 * TILE;         // q, k, v, do, p (two key boxes)
constexpr int CONSUMERS = 256;          // threads of 2 consumer warpgroups
constexpr int THREADS = 384;            // consumers + a producer warpgroup
// registers a thread of the producer and of a consumer warpgroup keep
// (`setmaxnreg`): 65,536 an SM in all
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int PAIR = 3;                 // named barrier of both consumers
// a consumer gives the last batch-head's stage back once the next one's
// has arrived (where that is another stage), so that the last one's
// stores run while the next one's products do
constexpr bool DEFER = STAGES > 1;
constexpr size_t SMEM =                 // + delta, slack to align the ring
    (size_t)STAGES * STAGE + STAGES * N * sizeof(float) + 1024;
}  // namespace bt

// The tensor maps of one launch (`launch_tma`): q, k, v, do (B, T, H*d)
// with their own strides as 128 x 64 boxes, p (B*H, T, T) as 128 x 64
// boxes (the queries of 64 keys), dq, dk, dv (B, T, H*d) as 64 x 64 boxes.
struct BthdMaps {
  CUtensorMap q, k, v, dout, p, dq, dk, dv;
};

// dsᵀ over the saved pᵀ for this lane's keys lr0, lr1 (of the
// consumer's 64, the rows of its dpᵀ) and queries 8j + 2t + {0, 1}
// (columns): ds = (p·(dp − delta))·scale rounded to bf16, written over p
// in the consumer's key box of the stage, and pᵀ, dsᵀ as the register A
// fragments of pᵀ·do and dsᵀ·q (queries 16kk.. are k-step kk).
__device__ __forceinline__ void bthd_ds(uint32_t (&pa)[8][4],
                                        uint32_t (&da)[8][4],
                                        unsigned char* pbox,
                                        const float (&dp)[64],
                                        const float* delta, float scale,
                                        int lr0, int lr1, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = h ? lr1 : lr0;
      bf16 pp[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bf16* at = reinterpret_cast<bf16*>(
            pbox + sw128_at(8 * j + 2 * t + e, key >> 3) + 2 * (key & 7));
        pp[e] = *at;
        ds[e] = __float2bfloat16(__bfloat162float(pp[e]) *
                                 (dp[4 * j + 2 * h + e] - (e ? dl.y : dl.x)) *
                                 scale);
        *at = ds[e];
      }
      const __nv_bfloat162 p2 = __halves2bfloat162(pp[0], pp[1]);
      const __nv_bfloat162 d2 = __halves2bfloat162(ds[0], ds[1]);
      pa[j >> 1][2 * (j & 1) + h] = *reinterpret_cast<const uint32_t*>(&p2);
      da[j >> 1][2 * (j & 1) + h] = *reinterpret_cast<const uint32_t*>(&d2);
    }
  }
}

// One warp's share of loading batch-head bh into stage st: lane 0 issues
// the TMA loads of q, k, v, do and p, every lane copies delta rows by
// cp.async, and each lane's copies arrive on `full` when they land.
__device__ __forceinline__ void bthd_load(const BthdMaps& maps,
                                          unsigned char* st, float* dl,
                                          const float* delta, int bh,
                                          int heads, uint64_t* full,
                                          int lane) {
  using namespace bt;
  const int b = bh / heads, h = bh % heads;
  if (lane == 0) {
    mbar_expect_tx(full, STAGE);
    tma_load(st, &maps.q, full, h * D, 0, b);
    tma_load(st + TILE, &maps.k, full, h * D, 0, b);
    tma_load(st + 2 * TILE, &maps.v, full, h * D, 0, b);
    tma_load(st + 3 * TILE, &maps.dout, full, h * D, 0, b);
    tma_load(st + 4 * TILE, &maps.p, full, 0, 0, bh);
    tma_load(st + 5 * TILE, &maps.p, full, 64, 0, bh);
  }
  for (int r = lane; r < N; r += 32)
    cp_async4(dl + r, delta + (size_t)bh * N + r, true);
  mbar_arrive_cp_async(full);
}

__global__ void __launch_bounds__(bt::THREADS, 1)
bthd_bwd_tma(const __grid_constant__ BthdMaps maps,
             const float* __restrict__ delta, int bh_total, int heads,
             float scale) {
  using namespace bt;
  extern __shared__ unsigned char bt_smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* ring = smem_align1024(bt_smem_raw);
  float* dls = reinterpret_cast<float*>(ring + STAGES * STAGE);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);      // the TMA, each producer lane
      mbar_init(&empty[s], 2);          // each consumer's lead thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warpgroup: its first warp loads each batch-head
    // (`bthd_load`); the warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lane = tid - CONSUMERS;
    if (lane >= 32) return;
    int i = 0;
    for (int bh = blockIdx.x; bh < bh_total; bh += gridDim.x, ++i) {
      const int s = i % STAGES;
      mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      bthd_load(maps, ring + s * STAGE, dls + s * N, delta, bh, heads,
                &full[s], lane);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // Consumer c owns keys c*64 .. c*64+63 of every batch-head (the rows of
  // its dpᵀ, dk, dv; warp w holds keys w*16 + g and w*16 + g + 8), then
  // queries c*64 .. c*64+63 (the rows of its dq).
  const int c = tid / 128;
  const int ctid = tid & 127;
  const int w = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int lr0 = w * 16 + g, lr1 = lr0 + 8;
  const bool lead = ctid == 0;
  int prev = -1;                        // a stage not yet given back
  auto release = [&] {
    if (prev >= 0 && lead) {
      bulk_wait_read<0>();              // its dq, dk, dv stores read it
      mbar_arrive(&empty[prev]);
    }
    prev = -1;
  };
  int i = 0;
  for (int bh = blockIdx.x; bh < bh_total; bh += gridDim.x, ++i) {
    const int s = i % STAGES;
    unsigned char* qs = ring + s * STAGE;             // then dq
    unsigned char* ks = qs + TILE;
    unsigned char* vs = qs + 2 * TILE;                // then dv
    unsigned char* dos = qs + 3 * TILE;               // then dk
    unsigned char* ps = qs + 4 * TILE;                // p, then ds
    const int b = bh / heads, h = bh % heads;
    if (!DEFER) release();
    mbar_wait(&full[s], (i / STAGES) & 1);

    // dpᵀ = v·doᵀ: this consumer's 64 keys (v's rows, K-major) against
    // the 128 queries (do's rows, K-major)
    float dp[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) dp[e] = 0.f;
    fence_regs(dp);
    wgmma_fence();
    {
      const uint64_t av = sw128_desc(vs + c * BOX);
      const uint64_t bd = sw128_desc(dos);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128k16_ss(dp, av + 2 * kk, bd + 2 * kk, kk);
    }
    wgmma_commit();
    if (DEFER) release();
    wgmma_wait<0>();
    fence_regs(dp);

    uint32_t pa[8][4], da[8][4];
    bthd_ds(pa, da, ps + c * TILE, dp, dls + s * N, scale, lr0, lr1, t);
    fence_async_smem();                 // ds, for the other consumer's dq

    // dv = pᵀ·do, dk = dsᵀ·q over the 128 queries: pᵀ, dsᵀ in registers,
    // do and q read N-major (their rows are the queries)
    float dv[32], dk[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dv[e] = dk[e] = 0.f;
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    {
      const uint64_t bd = sw128_desc(dos), bq = sw128_desc(qs);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_m64n64k16_rs(dv, pa[kk], bd + (uint64_t)(kk * 16 * 128 >> 4));
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_m64n64k16_rs(dk, da[kk], bq + (uint64_t)(kk * 16 * 128 >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    bwd_stage(vs + c * BOX, dv, lr0, lr1, t);         // v's rows are read
    pair_sync(PAIR);                    // ds complete; q and do read
    bwd_stage(dos + c * BOX, dk, lr0, lr1, t);

    // dq = ds·k for queries c*64..: ds K-major from the two key boxes, k
    // N-major (its rows are the keys)
    float dq[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] = 0.f;
    fence_regs(dq);
    wgmma_fence();
    {
      const uint64_t bk = sw128_desc(ks);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t ad =
            sw128_desc(ps + (kk >> 2) * TILE + c * BOX) + 2 * (kk & 3);
        wgmma_m64n64k16_ss<0, 1>(dq, ad, bk + (uint64_t)(kk * 16 * 128 >> 4),
                                 kk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    bwd_stage(qs + c * BOX, dq, lr0, lr1, t);         // q's rows are read
    fence_async_smem();
    warpgroup_sync(1 + c);
    if (lead) {
      tma_store(&maps.dv, vs + c * BOX, h * D, c * 64, b);
      tma_store(&maps.dk, dos + c * BOX, h * D, c * 64, b);
      tma_store(&maps.dq, qs + c * BOX, h * D, c * 64, b);
      bulk_commit();
    }
    prev = s;
  }
  release();
  if (lead) bulk_wait_all();
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

// The tensor-core kernel's launch: a tensor map for each of q, k, v, do
// (their own row and batch strides), p and the three outputs.  TMA reads
// and writes through a map only from a 16-byte-aligned base with row and
// batch strides that are multiples of 16 bytes; any other tensor is
// refused here (the wrapper hands such a view over as a contiguous copy).
static cudaError_t launch_tma(const void* q, const void* k, const void* v,
                              const void* dout, const float* delta,
                              const void* p, void* dq, void* dk, void* dv,
                              int batch, int heads, Rows rq, Rows rk,
                              Rows rv, Rows rdo, float scale,
                              cudaStream_t st) {
  using namespace bt;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  auto aligned = [&](const void* base, long long ts, long long bs) {
    return reinterpret_cast<uintptr_t>(base) % 16 == 0 && ts * 2 % 16 == 0 &&
           (batch == 1 || bs * 2 % 16 == 0);
  };
  const long long width = (long long)heads * D;
  if (!(aligned(q, rq.ts, rq.bs) && aligned(k, rk.ts, rk.bs) &&
        aligned(v, rv.ts, rv.bs) && aligned(dout, rdo.ts, rdo.bs) &&
        aligned(p, N, N * N) && aligned(dq, width, N * width) &&
        aligned(dk, width, N * width) && aligned(dv, width, N * width) &&
        reinterpret_cast<uintptr_t>(delta) % 4 == 0))
    return cudaErrorMisalignedAddress;
  // a batch stride is never read when batch == 1; the map still wants a
  // multiple of 16 bytes there
  auto outer = [&](const Rows& r) { return batch > 1 ? r.bs : N * r.ts; };
  BthdMaps maps;
  const bool ok =
      encode(fn, &maps.q, q, width, N, batch, rq.ts, outer(rq), N) &&
      encode(fn, &maps.k, k, width, N, batch, rk.ts, outer(rk), N) &&
      encode(fn, &maps.v, v, width, N, batch, rv.ts, outer(rv), N) &&
      encode(fn, &maps.dout, dout, width, N, batch, rdo.ts, outer(rdo), N) &&
      encode(fn, &maps.p, p, N, N, (long long)batch * heads, N, N * N, N) &&
      encode(fn, &maps.dq, dq, width, N, batch, width, N * width, 64) &&
      encode(fn, &maps.dk, dk, width, N, batch, width, N * width, 64) &&
      encode(fn, &maps.dv, dv, width, N, batch, width, N * width, 64);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(bthd_bwd_tma, SMEM);
  if (err != cudaSuccess) return err;
  const int bh = batch * heads;
  bthd_bwd_tma<<<persistent_grid(bh), THREADS, SMEM, st>>>(maps, delta, bh,
                                                           heads, scale);
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
  if (is_bf16 && n == bt::N && d == bt::D) {
    err = launch_tma(q, k, v, dout, delta, p, dq, dk, dv, batch, heads, rq,
                     rk, rv, rdo, scale, st);
  } else if (is_bf16) {
    err = launch_fma<bf16>(q, k, v, dout, delta, p, dq, dk, dv, bh, n, d, rq,
                           rk, rv, rdo, heads, scale, st);
  } else {
    err = launch_fma<float>(q, k, v, dout, delta, p, dq, dk, dv, bh, n, d, rq,
                            rk, rv, rdo, heads, scale, st);
  }
  return static_cast<int>(err);
}
