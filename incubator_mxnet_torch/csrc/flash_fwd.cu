// Streaming FlashAttention forward for Hopper (sm_90a).
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
// the division by l only at the end, as the TPU kernel does.  exp(s - m)
// is the subtraction, then the exp, never a fused multiply-add, so that
// -1e30 - (-1e30) stays exactly 0 on a row with kv_length 0.
//
// Two kernels, split by shape:
//   * bf16, d = 64 (every BERT config of the repository): `fwd_tma`.
//   * float32, and bf16 of other d <= 256: `fwd_fma`, 16 query rows per
//     block, scores and accumulator in shared memory, FMA loops in full
//     float32 (no TF32, as the TPU kernel's Precision.HIGHEST).  No model
//     path runs it.
// Under causal, key tiles past a query tile's last row are never loaded;
// a row with kv_length > 0 stops at its length too (those keys add
// exactly 0).  The JAX block sizes decide only which keys a row with
// kv_length 0 averages (`fa_key_end`, `fa_score`).
//
// What bounds `fwd_tma` on an H100 SXM.  At the training shape (BH =
// 4*12 = 48, T = 2048, d = 64, non-causal) 4*BH*T*T*d = 51.5 GFLOP of
// q·kᵀ and p·v take 0.052 ms at 989 TFLOP/s, while q, k, v, o and lse
// are 50.7 MB, 15 us at 3.35 TB/s: operations bound it.  At the serving
// shape (BH = 16*12 = 192) 206 GFLOP, 0.208 ms.  Causal halves both.
// The bound does not show the exp: BH*T*T = 201 M of them at BH = 48,
// and the SM's special-function unit does 16 a clock, ~55 us at 1.7 GHz
// on 132 SMs, as long as the products.  So the tensor cores reach half
// their rate only if one warpgroup's softmax runs while another's
// products run.
//
// Design of `fwd_tma`.  The TPU grid (bh, query tile, key tile) runs its
// key tiles in order and carries m, l and acc in VMEM scratch.  Here one
// persistent block on each SM walks work tiles of (bh, 192 query rows)
// and loops over their 128-key steps itself.  Every step moves a 32 KB
// k/v stage from L2 to the SM: with 128 query rows a tile that is 805/2
// MB at the training shape, and the loads alone then take ~0.10 ms, near
// L2's rate; 192 rows cut it by a third.  The tiles go a few batch-heads
// at a time (`fwd_tile`), so that at the serving shape, whose 100 MB of
// k and v do not fit in L2, the k and v being read stay there:
//   * a producer warpgroup, one thread of which loads each work tile's q
//     (three 64-row boxes, double-buffered across tiles) and streams k
//     and v into a ring of STAGES 128-key stages (32 KB each) by TMA,
//     over 3-d tensor maps (64, T, BH) in 128-byte swizzle whose rows
//     past a batch-head's end arrive as zeros, with full / empty
//     mbarriers; the rest of the warpgroup gives its registers away
//     (`setmaxnreg`: 24 a thread, and 160 to each consumer thread);
//   * three consumer warpgroups, 64 query rows each, on the same stages:
//     s = q·kᵀ is wgmma m64n128k16 with both operands in shared memory,
//     the online softmax runs on the f32 accumulators with quad
//     shuffles, and o += p·v is wgmma m64n64k16 with the bf16 p as the
//     register operand and v read through the transposed descriptor;
//   * the exp against the tensor cores: the consumers take turns through
//     named barriers (round robin), so that one issues its products while
//     the others run their softmax; and within a consumer the
//     products of step j (s_j = q·k_jᵀ and o += p_{j-1}·v_{j-1}) are
//     issued together and the softmax of s_j runs while p_{j-1}·v_{j-1}
//     is still in flight.  The exp is ex2.approx of (s - m)·log2(e), one
//     special-function operation a score (expf adds a range reduction
//     of about six more);
//   * the mask runs only on the steps that need it: the step that holds
//     min(kv_length, Tk), the steps that cross the diagonal under causal,
//     and rows with kv_length 0.  Elsewhere it keeps s unchanged, so
//     skipping it keeps the results bit for bit.  It is `fa_score`'s rule
//     taken by row: one comparison a score against the row's
//     `fa_key_end`;
//   * the epilogue divides by l, stages o in swizzled shared memory as
//     bf16 and writes it with a TMA store (rows past Tq are not
//     written) that overlaps the next tile; lse goes out from registers.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace ft {
constexpr int D = 64;                   // the one width of this kernel
constexpr int NC = 3;                   // consumer warpgroups
constexpr int BQ = 64 * NC;             // query rows a work tile
constexpr int BK = 128;                 // keys a stage
constexpr int STAGES = 4;
constexpr int KV = BK * D * 2;          // k or v of one stage: 16 KB
constexpr int STAGE = 2 * KV;
constexpr int QBOX = 64 * D * 2;        // one consumer's 64 rows: 8 KB
constexpr int QBUF = NC * QBOX;         // one work tile's q
constexpr int THREADS = 128 * (1 + NC); // producer + consumer warpgroups
constexpr int SCHED = 1 + NC;           // named barriers: the turns
constexpr size_t SMEM =                 // ring, 2 q buffers, the o boxes
    (size_t)STAGES * STAGE + 2 * QBUF + NC * QBOX + 1024;
// registers a thread of the producer and of a consumer warpgroup keep
// (`setmaxnreg`): 65,536 an SM in all
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
}  // namespace ft

// The tensor maps of one launch: q, o (BH, Tq, 64) as 64-row boxes; k, v
// (BH, Tk, 64) as 128-row boxes.
struct FwdMaps {
  CUtensorMap q, k, v, o;
};

// exp(x) for x = s - m <= 0 (or -inf): ex2.approx of x·log2(e), flushed
// to 0 below the normal range.  Relative error near 2^-22; exp(0) is
// exactly 1 and exp(-inf) exactly 0.
__device__ __forceinline__ float fa_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Work tile `idx`: batch-head and first query row.  The tiles of
// `group` batch-heads at a time, so that the blocks that run at once read
// the k and v of few batch-heads, which then stay in L2; within a group
// the last query tiles first (under causal the key steps grow with the
// query tile), and every other group in the reverse order, so that the
// blocks, which take every gridDim.x-th tile, get long and short tiles
// alike.
__device__ __forceinline__ void fwd_tile(int idx, int bh_total, int ntq,
                                         int group, int& bh, int& q0) {
  const int gi = idx / (group * ntq), p0 = idx % (group * ntq);
  const int g0 = gi * group, gn = min(group, bh_total - g0);
  const int p = gi & 1 ? gn * ntq - 1 - p0 : p0;
  bh = g0 + p % gn;
  q0 = (ntq - 1 - p / gn) * ft::BQ;
}

// The 128-key steps of the work tile at q0 (at least 1).
__device__ __forceinline__ int fwd_steps(int q0, int len, const FaGeo& g) {
  const int kend = fa_key_end(min(q0 + ft::BQ, g.tq) - 1, len, g);
  return (kend + ft::BK - 1) / ft::BK;
}

// s = q·k_jᵀ into sc: 4 k-steps of 16 (32 bytes along the swizzled rows).
__device__ __forceinline__ void fwd_qk(float (&sc)[64], uint64_t dq,
                                       const unsigned char* kt) {
  const uint64_t dk = sw128_desc(kt);
#pragma unroll
  for (int kk = 0; kk < ft::D / 16; ++kk)
    wgmma_m64n128k16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
  wgmma_commit();
}

// oc += p·v: 8 k-steps of 16 keys (16 rows of 128 bytes of v each).
__device__ __forceinline__ void fwd_pv(float (&oc)[32],
                                       const uint32_t (&pa)[ft::BK / 16][4],
                                       const unsigned char* vt) {
  const uint64_t dv = sw128_desc(vt);
#pragma unroll
  for (int kk = 0; kk < ft::BK / 16; ++kk)
    wgmma_m64n64k16_rs(oc, pa[kk], dv + (uint64_t)(kk * 16 * 128 >> 4));
  wgmma_commit();
}

// The online softmax of one key step on rows r0 (sc[4nt], sc[4nt+1]) and
// r1 (sc[4nt+2], sc[4nt+3]) of key tile nt, each spread over the 4
// lanes of a quad: scale, then, where `mask` says a mask can apply, the
// mask; the new row max starts from the running one m.  Leaves p in sc,
// the rescaling of the old sums in corr and this lane's share of Σ p in
// sum.  The mask is `fa_score`'s rule by row: for a row r < Tq, key c
// keeps s (kv_length > 0) or -1e30 (kv_length 0) where c <
// fa_key_end(r, kv_length) (`end`), and is -inf elsewhere.
__device__ __forceinline__ void fwd_softmax(float (&sc)[64], float (&m)[2],
                                            float (&corr)[2],
                                            float (&sum)[2], bool mask,
                                            int c0, const int (&end)[2],
                                            bool dead, int t, float scale) {
#pragma unroll
  for (int e = 0; e < 64; ++e) sc[e] *= scale;
  if (mask) {
    // key 8nt + 2t + e of the step is kept where it is < lim, taken here
    // less c0 and 2t
    const int lim0 = end[0] - c0 - 2 * t, lim1 = end[1] - c0 - 2 * t;
#pragma unroll
    for (int nt = 0; nt < ft::BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x0 = sc[4 * nt + e];
        float& x1 = sc[4 * nt + 2 + e];
        x0 = nt * 8 + e < lim0 ? (dead ? FA_NEG_BIG : x0) : -INFINITY;
        x1 = nt * 8 + e < lim1 ? (dead ? FA_NEG_BIG : x1) : -INFINITY;
      }
    }
  }
  // two chains per row for the max and the sum, so that each chain is
  // half as long
  float mx[2][2] = {{m[0], m[1]}, {m[0], m[1]}};
#pragma unroll
  for (int nt = 0; nt < ft::BK / 8; ++nt) {
    float (&x)[2] = mx[nt & 1];
    x[0] = fmaxf(x[0], fmaxf(sc[4 * nt], sc[4 * nt + 1]));
    x[1] = fmaxf(x[1], fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
  }
  const float mx0 = quad_max(fmaxf(mx[0][0], mx[1][0]));
  const float mx1 = quad_max(fmaxf(mx[0][1], mx[1][1]));
  corr[0] = fa_exp(m[0] - mx0);
  corr[1] = fa_exp(m[1] - mx1);
  float sm[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int nt = 0; nt < ft::BK / 8; ++nt) {
    float (&y)[2] = sm[nt & 1];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * nt + e] = fa_exp(sc[4 * nt + e] - mx0);
      sc[4 * nt + 2 + e] = fa_exp(sc[4 * nt + 2 + e] - mx1);
      y[0] += sc[4 * nt + e];
      y[1] += sc[4 * nt + 2 + e];
    }
  }
  m[0] = mx0;
  m[1] = mx1;
  sum[0] = sm[0][0] + sm[1][0];
  sum[1] = sm[0][1] + sm[1][1];
}

// After p_{j-1}·v_{j-1} has landed: l = l·corr + Σ p (this lane's share;
// the quad's shares are summed at the end), acc = acc·corr, and p_j
// rounded to bf16 as p·v's A operand: key tiles 2kk and 2kk+1 are the A
// fragment of k-step kk.
__device__ __forceinline__ void fwd_rescale(float (&oc)[32],
                                            uint32_t (&pa)[ft::BK / 16][4],
                                            const float (&sc)[64],
                                            float (&l)[2],
                                            const float (&corr)[2],
                                            const float (&sum)[2]) {
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
  for (int dt = 0; dt < ft::D / 8; ++dt) {
    oc[4 * dt] *= corr[0];
    oc[4 * dt + 1] *= corr[0];
    oc[4 * dt + 2] *= corr[1];
    oc[4 * dt + 3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < ft::BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

__global__ void __launch_bounds__(ft::THREADS, 1)
fwd_tma(const __grid_constant__ FwdMaps maps, const int* __restrict__ lens,
        float* __restrict__ lse, int bh_total, int group, FaGeo g) {
  using namespace ft;
  extern __shared__ unsigned char fwd_smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qfull[2],
      qempty[2];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fwd_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qbuf = ring + STAGES * STAGE;
  unsigned char* obuf = qbuf + 2 * QBUF;
  const int tid = threadIdx.x;
  const int ntq = (g.tq + BQ - 1) / BQ, tiles = bh_total * ntq;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);     // each consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&qempty[b], 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer: one thread keeps q and the k/v ring filled, the rest
    // of the warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      int it = 0;                       // stages filled so far
      for (int idx = blockIdx.x, i = 0; idx < tiles; idx += gridDim.x, ++i) {
        int bh, q0;
        fwd_tile(idx, bh_total, ntq, group, bh, q0);
        const int steps = fwd_steps(q0, max(lens[bh], 0), g);
        const int b = i & 1;
        unsigned char* qs = qbuf + b * QBUF;
        mbar_wait(&qempty[b], ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[b], QBUF);
        for (int k = 0; k < NC; ++k)
          tma_load(qs + k * QBOX, &maps.q, &qfull[b], 0, q0 + 64 * k, bh);
        for (int j = 0; j < steps; ++j, ++it) {
          const int s = it % STAGES;
          unsigned char* st = ring + s * STAGE;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE);
          tma_load(st, &maps.k, &full[s], 0, j * BK, bh);
          tma_load(st + KV, &maps.v, &full[s], 0, j * BK, bh);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // Consumer c owns rows c*64 .. c*64+63 of every work tile of the block.
  // Warp w holds rows w*16 + gq and w*16 + gq + 8 of them, each spread
  // over the 4 lanes of a quad (wgmma's accumulators are mma.sync's
  // fragments per warp).
  const int c = tid / 128 - 1;
  const int ctid = tid % 128;
  const int w = ctid >> 5, lane = ctid & 31, gq = lane >> 2, t = lane & 3;
  const int lr0 = w * 16 + gq, lr1 = lr0 + 8;
  const bool lead = ctid == 0, warp_lead = lane == 0;
  unsigned char* obox = obuf + c * QBOX;
  if (c == NC - 1) pair_arrive(SCHED);  // consumer 0 takes the first turn

  float sc[64];                         // s, then p, of one key step
  float oc[32];                         // o's f32 accumulators
  uint32_t pa[BK / 16][4];              // p in bf16: p·v's A operand
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
    pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0u;
  int it = 0;                           // stages consumed so far
  for (int idx = blockIdx.x, i = 0; idx < tiles; idx += gridDim.x, ++i) {
    int bh, q0;
    fwd_tile(idx, bh_total, ntq, group, bh, q0);
    const int len = max(lens[bh], 0);
    const int steps = fwd_steps(q0, len, g);
    const int row0 = q0 + c * 64;
    const int r0 = row0 + lr0, r1 = row0 + lr1;
    const int end[2] = {fa_key_end(r0, len, g), fa_key_end(r1, len, g)};
    const int lim = min(len, g.tk);
    const int b = i & 1;
    const uint64_t dq = sw128_desc(qbuf + b * QBUF + c * QBOX);
    float m[2] = {FA_NEG_BIG, FA_NEG_BIG}, l[2] = {0.f, 0.f};
    float corr[2], sum[2];
#pragma unroll
    for (int e = 0; e < 32; ++e) oc[e] = 0.f;
    // a key step needs the mask if it holds min(kv_length, Tk), crosses
    // the diagonal under causal, or kv_length is 0
    auto mask = [&](int c0) {
      return len == 0 || c0 + BK > lim || (g.causal && c0 + BK - 1 > row0);
    };
    mbar_wait(&qfull[b], (i >> 1) & 1);

    // Turn j (of steps + 1) issues s_j = q·k_jᵀ (j < steps) and o +=
    // p_{j-1}·v_{j-1} (j > 0), then runs the softmax of s_j while the
    // second product runs.  The first and last turns are peeled so that
    // every turn of the loop has one shape, which the compiler's check of
    // the registers in flight needs.
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    pair_sync(SCHED + c);
    fence_regs(sc);
    wgmma_fence();
    fwd_qk(sc, dq, ring + (it % STAGES) * STAGE);
    pair_arrive(SCHED + (c + 1) % NC);
    wgmma_wait<0>();
    fence_regs(sc);
    if (steps == 1 && warp_lead) mbar_arrive(&qempty[b]);
    fwd_softmax(sc, m, corr, sum, mask(0), 0, end, len == 0, t, g.scale);
    fwd_rescale(oc, pa, sc, l, corr, sum);
#pragma unroll 1
    for (int j = 1; j < steps; ++j) {
      const int sj = (it + j) % STAGES, sp = (it + j - 1) % STAGES;
      mbar_wait(&full[sj], ((it + j) / STAGES) & 1);
      pair_sync(SCHED + c);
      fence_regs(sc);
      fence_regs(oc);
      fence_regs(pa);
      wgmma_fence();
      fwd_qk(sc, dq, ring + sj * STAGE);
      fwd_pv(oc, pa, ring + sp * STAGE + KV);
      pair_arrive(SCHED + (c + 1) % NC);
      wgmma_wait<1>();
      fence_regs(sc);
      if (j == steps - 1 && warp_lead) mbar_arrive(&qempty[b]);
      fwd_softmax(sc, m, corr, sum, mask(j * BK), j * BK, end, len == 0, t,
                  g.scale);
      wgmma_wait<0>();
      fence_regs(oc);
      fence_regs(pa);
      if (warp_lead) mbar_arrive(&empty[sp]);       // v_{j-1} is read
      fwd_rescale(oc, pa, sc, l, corr, sum);
    }
    {
      const int sp = (it + steps - 1) % STAGES;
      pair_sync(SCHED + c);
      fence_regs(oc);
      fence_regs(pa);
      wgmma_fence();
      fwd_pv(oc, pa, ring + sp * STAGE + KV);
      pair_arrive(SCHED + (c + 1) % NC);
      wgmma_wait<0>();
      fence_regs(oc);
      fence_regs(pa);
      if (warp_lead) mbar_arrive(&empty[sp]);
    }
    it += steps;

    // o = acc / l through this consumer's o box, whose previous store
    // must have read it; lse from registers
    const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    const float safe0 = l0 == 0.f ? 1.f : l0, safe1 = l1 == 0.f ? 1.f : l1;
    if (lead) bulk_wait_read<0>();
    warpgroup_sync(1 + c);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(obox + sw128_at(lr0, dt) + 4 * t) =
          pack_bf16(oc[4 * dt] / safe0, oc[4 * dt + 1] / safe0);
      *reinterpret_cast<uint32_t*>(obox + sw128_at(lr1, dt) + 4 * t) =
          pack_bf16(oc[4 * dt + 2] / safe1, oc[4 * dt + 3] / safe1);
    }
    fence_async_smem();
    warpgroup_sync(1 + c);
    if (lead) {
      tma_store(&maps.o, obox, 0, row0, bh);
      bulk_commit();
    }
    if (t == 0) {
      float* lb = lse + (size_t)bh * g.tq;
      if (r0 < g.tq) lb[r0] = m[0] + logf(safe0);
      if (r1 < g.tq) lb[r1] = m[1] + logf(safe1);
    }
  }
  if (c == 0) pair_sync(SCHED);         // the last consumer's last turn
  if (lead) bulk_wait_all();
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
static cudaError_t launch_tma(const void* q, const void* k, const void* v,
                              const int* lens, void* o, float* lse, int bh,
                              const FaGeo& g, cudaStream_t st) {
  using namespace ft;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long sq = (long long)g.tq * D, sk = (long long)g.tk * D;
  FwdMaps maps;
  const bool ok = encode(fn, &maps.q, q, D, g.tq, bh, D, sq, 64) &&
                  encode(fn, &maps.k, k, D, g.tk, bh, D, sk, BK) &&
                  encode(fn, &maps.v, v, D, g.tk, bh, D, sk, BK) &&
                  encode(fn, &maps.o, o, D, g.tq, bh, D, sq, 64);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fwd_tma, SMEM);
  if (err != cudaSuccess) return err;
  const int ntq = (g.tq + BQ - 1) / BQ, grid = persistent_grid(bh * ntq);
  const int group = grid < ntq ? 1 : grid / ntq;
  fwd_tma<<<grid, THREADS, SMEM, st>>>(maps, lens, lse, bh, group, g);
  return cudaGetLastError();
}

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
// the JAX block sizes after `_fit_block`.  For `fwd_tma` (bf16, d = 64)
// the bases are 16-byte aligned.  Launches on `stream` and returns the
// cudaError_t of the launch (0 = success).  The caller checks bh, tq,
// tk >= 1 and 1 <= d <= 256.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* lens, void* o, float* lse, int bh,
                         int tq, int tk, int d, int causal, int block_q,
                         int block_k, int is_bf16, float scale,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FaGeo g{tq, tk, d, causal, block_q, block_k, scale};
  cudaError_t err;
  if (is_bf16 && d == ft::D) {
    err = launch_tma(q, k, v, lens, o, lse, bh, g, st);
  } else if (is_bf16) {
    err = launch_fma<bf16>(q, k, v, lens, o, lse, bh, g, st);
  } else {
    err = launch_fma<float>(q, k, v, lens, o, lse, bh, g, st);
  }
  return static_cast<int>(err);
}
