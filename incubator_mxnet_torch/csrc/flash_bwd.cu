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
// and p = 1 on every key of the key tiles the TPU grid visits: there
// exp(s - lse) is the subtraction -1e30 - (-1e30), exactly 0, then the
// exp.
//
// Two kernels each, split by shape:
//   * bf16, d = 64 (every BERT config of the repository): `bwd_dq_tma`
//     and `bwd_dkv_tma`, below.
//   * float32, and bf16 of other d <= 256: `bwd_dq_fma` and `bwd_dkv_fma`,
//     16 rows a block, FMA loops in full float32.  No model path runs
//     them.
// Keys at or past a row's kv_length (> 0), and under causal the tiles
// past the diagonal, are never loaded.  Each kernel keeps its own output
// rows, so neither needs atomics and both give the same bits on every
// run.
//
// What bounds them on an H100 SXM.  At the training shape (BH = 48,
// T = 2048, d = 64, bf16, non-causal) dq recomputes s and computes dp
// and ds·k, 6*BH*T*T*d = 77.3 GFLOP, 0.078 ms at 989 TFLOP/s; dk/dv
// computes s, dp, pᵀ·do and dsᵀ·q, 8*BH*T*T*d = 103 GFLOP, 0.104 ms; the
// bytes (q, k, v, do, lse, delta in, dq or dk and dv out) are ~40-50 MB,
// ~15 us.  Operations bound both; causal halves them.  Beside the
// products each kernel takes BH*T*T = 201 M exps, ~55 us at the SM's
// 16 a clock, and FP32 operations on every score, so the tensor cores
// reach half their rate only if one warpgroup's elementwise work runs
// while another's products run, and the elementwise work is kept short:
// one exp, two fused multiply-adds and two multiplies a score (p =
// exp2((s·scale - lse)·log2e) with the first product and subtraction
// fused, ds = p·(dp·scale - delta·scale) likewise; `bwd_exp_arg`,
// `bwd_ds`).  A fused backward would compute s and dp once (10 against
// 14 units of work) but needs dq summed across blocks.
//
// Design, in the image of the forward's `fwd_tma` (flash_fwd.cu).  Both
// kernels run one persistent block on each SM that walks work tiles,
// taken `group` batch-heads at a time so that the rows the running
// blocks stream stay in L2 (`bwd_tile`):
//   * a producer warpgroup, one thread of which loads each work tile's
//     own rows once and streams the other side's rows into a ring of
//     stages by TMA over 3-d tensor maps (64, T, BH) in 128-byte swizzle,
//     whose rows past a batch-head's end arrive as zeros, with full /
//     empty mbarriers; the rest of the warpgroup gives its registers
//     away (`setmaxnreg`: 24 a thread, 240 to each consumer thread);
//   * two consumer warpgroups of 64 rows each on the same stages take
//     turns through named barriers, so that one issues its products
//     while the other runs its elementwise work; within a consumer the
//     products of step j (s_j and dp_j) are issued with the accumulation
//     of step j-1, which is still in flight while step j's p and ds are
//     computed;
//   * the exp is ex2.approx of (s·scale - lse)·log2(e), one
//     special-function operation a score (expf adds a range reduction of
//     about six more);
//   * the mask runs only on the steps that need it (the step that holds
//     min(kv_length, Tk), steps that cross the diagonal, kv_length-0
//     rows, and for dk/dv the ragged last query step, whose rows arrive
//     as zeros): one comparison a score, elsewhere s unchanged, so that
//     skipping it keeps the results bit for bit;
//   * the epilogue stages the gradients in swizzled shared memory as
//     bf16 and writes them by TMA store (rows past T are not written),
//     which overlaps the next tile.
// `bwd_dq_tma` (row 3): a work tile is (bh, 128 query rows); its q and do
// stay in shared memory (double-buffered across tiles), each 128-key
// stage holds k and v (32 KB).  s = q·kᵀ and dp = do·vᵀ are wgmma
// m64n128k16 with both operands in shared memory; dq += ds·k is wgmma
// m64n64k16 with the bf16 ds as the register operand and k read through
// the transposed descriptor, as v is in the forward's p·v.  lse and delta
// of a consumer's rows sit in registers.
// `bwd_dkv_tma` (row 4), its mirror: a work tile is (bh, 128 keys); each
// consumer moves its 64 keys of k and v from shared memory into
// registers once, and each 64-row stage holds q, do (by TMA) and their
// lse and delta (by cp.async, a row a lane).  All four products are
// wgmma m64n64k16 with a register operand: sᵀ = k·qᵀ and dpᵀ = v·doᵀ with
// k and v, reading q and do as K-major rows, and dv += pᵀ·do and dk +=
// dsᵀ·q with pᵀ and dsᵀ, reading do and q through the transposed
// descriptor; so shared memory feeds one operand of each, where two
// operands of a 64-column product from shared memory would take its
// whole bandwidth.  The mask's "row" is the column of sᵀ: a key keeps the
// rows from the first one that takes gradient from it (`fa_row_begin`)
// to Tq.  A tile whose keys all lie at or past kv_length has no step and
// writes zeros.
#include "flash_common.cuh"
#include "hopper_common.cuh"

constexpr int D = 64;                   // the one width of the wgmma kernels

// exp(x) for x = s·scale - lse <= 0 (or -inf): ex2.approx of x·log2(e),
// flushed to 0 below the normal range.  Relative error near 2^-22;
// exp(0) is exactly 1 and exp(-inf) exactly 0.
__device__ __forceinline__ float fa_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// s·scale - lse for a score s = q·kᵀ that a row may see: one fused
// multiply-add, or, on a row with kv_length 0 (`dead`), whose scores are
// all -1e30 and whose lse is exactly -1e30, -1e30 - lse taken as a
// subtraction, exactly 0 (so p = 1).
__device__ __forceinline__ float bwd_exp_arg(float s, float scale, float lse,
                                             bool dead) {
  return dead ? FA_NEG_BIG - lse : fmaf(s, scale, -lse);
}

// ds = p·(dp - delta)·scale as p·(dp·scale - delta·scale), dls being
// delta·scale: the same bits when scale is a power of two (1/8 for BERT's
// head width 64), within a rounding otherwise.
__device__ __forceinline__ float bwd_ds(float p, float dp, float scale,
                                        float dls) {
  return p * fmaf(dp, scale, -dls);
}

// Work tile `idx` of a launch with `nt` tiles a batch-head: its
// batch-head and tile.  The tiles go `group` batch-heads at a time, so
// that the blocks that run at once stream the rows of few batch-heads,
// which then stay in L2; within a group the tiles with the most steps
// under causal come first (the last query tiles for dq, `last_first`;
// the first key tiles for dk/dv), and every other group runs in the
// reverse order, so that the blocks, which take every gridDim.x-th
// tile, get long and short tiles alike.
__device__ __forceinline__ void bwd_tile(int idx, int bh_total, int nt,
                                         int group, bool last_first,
                                         int& bh, int& tile) {
  const int gi = idx / (group * nt), p0 = idx % (group * nt);
  const int g0 = gi * group, gn = min(group, bh_total - g0);
  const int p = gi & 1 ? gn * nt - 1 - p0 : p0;
  bh = g0 + p % gn;
  tile = last_first ? nt - 1 - p / gn : p / gn;
}

// acc = a·bᵀ over d: a 64-row tile (descriptor da) and a 128-row tile b,
// both K-major in 128-byte swizzle; 4 k-steps of 16 (32 bytes along the
// swizzled rows).
__device__ __forceinline__ void bwd_abt(float (&acc)[64], uint64_t da,
                                        const unsigned char* b) {
  const uint64_t db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(acc, da + 2 * kk, db + 2 * kk, kk);
}

// acc += a·b over 16·KS rows of b: a the bf16 register fragments of each
// k-step, b a tile of 128-byte rows read through the transposed
// descriptor, 16 rows a k-step.
template <int KS>
__device__ __forceinline__ void bwd_ab(float (&acc)[32],
                                       const uint32_t (&a)[KS][4],
                                       const unsigned char* b) {
  const uint64_t db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_m64n64k16_rs(acc, a[kk], db + (uint64_t)(kk * 16 * 128 >> 4));
}

// acc = a·bᵀ over d: a this warpgroup's 64 rows as register fragments
// (`bwd_frags`), b a 64-row K-major tile in 128-byte swizzle.
__device__ __forceinline__ void bwd_abt_rs(float (&acc)[32],
                                           const uint32_t (&a)[D / 16][4],
                                           const unsigned char* b) {
  const uint64_t db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_rs_abt(acc, a[kk], db + 2 * kk, kk);
}

// Rows lr0 and lr1 of a 64-row box in 128-byte swizzle as the register
// fragments of the 4 k-steps of d (mma.sync's A fragment: columns 2t and
// 2t + 8 of each 16).
__device__ __forceinline__ void bwd_frags(uint32_t (&a)[D / 16][4],
                                          const unsigned char* box, int lr0,
                                          int lr1, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(box + sw128_at(lr0, 2 * kk)
                                                  + 4 * t);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(box + sw128_at(lr1, 2 * kk)
                                                  + 4 * t);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(
        box + sw128_at(lr0, 2 * kk + 1) + 4 * t);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(
        box + sw128_at(lr1, 2 * kk + 1) + 4 * t);
  }
}

// The f32 accumulators x of a 64 x 16·KS product rounded to bf16 as the
// register operand of the next: column tiles 2kk and 2kk+1 are the A
// fragment of k-step kk.
template <int KS>
__device__ __forceinline__ void bwd_pack(uint32_t (&a)[KS][4],
                                         const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------
// dq (row 3)
// ---------------------------------------------------------------------
namespace bdq {
constexpr int NC = 2;                   // consumer warpgroups
constexpr int BQ = 64 * NC;             // query rows a work tile
constexpr int BK = 128;                 // keys a stage
constexpr int STAGES = 4;
constexpr int KV = BK * D * 2;          // k or v of one stage
constexpr int STAGE = 2 * KV;
constexpr int BOX = 64 * D * 2;         // 64 rows: 8 KB
constexpr int QBUF = 2 * NC * BOX;      // q and do of one work tile
constexpr int THREADS = 128 * (1 + NC); // producer + consumer warpgroups
constexpr int SCHED = 1 + NC;           // named barriers: the turns
constexpr size_t SMEM =                 // ring, 2 q/do buffers, dq boxes
    (size_t)STAGES * STAGE + 2 * QBUF + NC * BOX + 1024;
// registers a thread of the producer and of a consumer warpgroup keep
// (`setmaxnreg`): 65,536 an SM in all
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
}  // namespace bdq

// q, do, dq (BH, Tq, 64) as 64-row boxes; k, v (BH, Tk, 64) as stages.
struct DqMaps {
  CUtensorMap q, dout, k, v, dq;
};

// The key steps of the dq work tile at q0 (at least 1).
__device__ __forceinline__ int dq_steps(int q0, int len, const FaGeo& g) {
  const int kend = fa_key_end(min(q0 + bdq::BQ, g.tq) - 1, len, g);
  return (kend + bdq::BK - 1) / bdq::BK;
}

// ds of one key step on rows r0 (x[4nt], x[4nt+1]) and r1 (x[4nt+2],
// x[4nt+3]) of key tile nt, each spread over the 4 lanes of a quad, left
// in x: p = exp(s·scale - lse), where `mask` says a mask can apply
// masked by `fa_score`'s rule by row (key c keeps s, or -1e30 on a row
// with kv_length 0, where c < end, and is -inf elsewhere), and ds =
// p·(dp - delta)·scale.  See `bwd_exp_arg` and `bwd_ds` for how each is
// rounded.
__device__ __forceinline__ void dq_grad(float (&x)[bdq::BK / 2],
                                        const float (&dp)[bdq::BK / 2],
                                        bool mask,
                                        int c0, const int (&end)[2],
                                        bool dead, int t,
                                        const float (&lse)[2],
                                        const float (&dl)[2], float scale) {
  if (mask) {
    // key 8nt + 2t + e of the step is kept where it is < lim, taken here
    // less c0 and 2t
    const int lim0 = end[0] - c0 - 2 * t, lim1 = end[1] - c0 - 2 * t;
#pragma unroll
    for (int nt = 0; nt < bdq::BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x0 = x[4 * nt + e];
        float& x1 = x[4 * nt + 2 + e];
        x0 = nt * 8 + e < lim0 ? bwd_exp_arg(x0, scale, lse[0], dead)
                               : -INFINITY;
        x1 = nt * 8 + e < lim1 ? bwd_exp_arg(x1, scale, lse[1], dead)
                               : -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < bdq::BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[4 * nt + e] = bwd_exp_arg(x[4 * nt + e], scale, lse[0], false);
        x[4 * nt + 2 + e] =
            bwd_exp_arg(x[4 * nt + 2 + e], scale, lse[1], false);
      }
    }
  }
  const float dls[2] = {dl[0] * scale, dl[1] * scale};
#pragma unroll
  for (int nt = 0; nt < bdq::BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i0 = 4 * nt + e, i1 = 4 * nt + 2 + e;
      x[i0] = bwd_ds(fa_exp(x[i0]), dp[i0], scale, dls[0]);
      x[i1] = bwd_ds(fa_exp(x[i1]), dp[i1], scale, dls[1]);
    }
  }
}

__global__ void __launch_bounds__(bdq::THREADS, 1)
bwd_dq_tma(const __grid_constant__ DqMaps maps, const float* __restrict__ lse,
           const float* __restrict__ delta, const int* __restrict__ lens,
           int bh_total, int group, FaGeo g) {
  using namespace bdq;
  extern __shared__ unsigned char dq_smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qfull[2],
      qempty[2];
  unsigned char* ring = smem_align1024(dq_smem_raw);
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
    // the producer: one thread keeps q, do and the k/v ring filled, the
    // rest of the warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      int it = 0;                       // stages filled so far
      for (int idx = blockIdx.x, i = 0; idx < tiles; idx += gridDim.x, ++i) {
        int bh, qt;
        bwd_tile(idx, bh_total, ntq, group, true, bh, qt);
        const int q0 = qt * BQ;
        const int steps = dq_steps(q0, max(lens[bh], 0), g);
        const int b = i & 1;
        unsigned char* qs = qbuf + b * QBUF;
        mbar_wait(&qempty[b], ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[b], QBUF);
        for (int k = 0; k < NC; ++k) {
          tma_load(qs + k * BOX, &maps.q, &qfull[b], 0, q0 + 64 * k, bh);
          tma_load(qs + (NC + k) * BOX, &maps.dout, &qfull[b], 0,
                   q0 + 64 * k, bh);
        }
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
  unsigned char* obox = obuf + c * BOX;
  if (c == NC - 1) pair_arrive(SCHED);  // consumer 0 takes the first turn

  float sc[BK / 2];                     // s, then ds, of one key step
  float dp[BK / 2];                     // dp of one key step
  float acc[32];                        // dq's f32 accumulators
  uint32_t da[BK / 16][4];              // ds in bf16: ds·k's A operand
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
    da[i][0] = da[i][1] = da[i][2] = da[i][3] = 0u;
  int it = 0;                           // stages consumed so far
  for (int idx = blockIdx.x, i = 0; idx < tiles; idx += gridDim.x, ++i) {
    int bh, qt;
    bwd_tile(idx, bh_total, ntq, group, true, bh, qt);
    const int q0 = qt * BQ;
    const int len = max(lens[bh], 0);
    const int steps = dq_steps(q0, len, g);
    const int row0 = q0 + c * 64;
    const int r0 = row0 + lr0, r1 = row0 + lr1;
    const int end[2] = {fa_key_end(r0, len, g), fa_key_end(r1, len, g)};
    const int lim = min(len, g.tk);
    // lse and delta of this lane's rows; rows past Tq (zeros in q and
    // do, not written) take 0
    const float* lb = lse + (size_t)bh * g.tq;
    const float* db = delta + (size_t)bh * g.tq;
    const float ls[2] = {r0 < g.tq ? lb[r0] : 0.f, r1 < g.tq ? lb[r1] : 0.f};
    const float dl[2] = {r0 < g.tq ? db[r0] : 0.f, r1 < g.tq ? db[r1] : 0.f};
    const int b = i & 1;
    const uint64_t dqa = sw128_desc(qbuf + b * QBUF + c * BOX);
    const uint64_t doa = sw128_desc(qbuf + b * QBUF + (NC + c) * BOX);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    // a key step needs the mask if it holds min(kv_length, Tk), crosses
    // the diagonal under causal, or kv_length is 0
    auto mask = [&](int c0) {
      return len == 0 || c0 + BK > lim || (g.causal && c0 + BK - 1 > row0);
    };
    mbar_wait(&qfull[b], (i >> 1) & 1);

    // Turn j (of steps + 1) issues s_j = q·k_jᵀ and dp_j = do·v_jᵀ
    // (j < steps) and dq += ds_{j-1}·k_{j-1} (j > 0), then computes ds_j
    // while the last product runs.  The first and last turns are peeled
    // so that every turn of the loop has one shape, which the compiler's
    // check of the registers in flight needs.
    {
      const int s0 = it % STAGES;
      unsigned char* st = ring + s0 * STAGE;
      mbar_wait(&full[s0], (it / STAGES) & 1);
      pair_sync(SCHED + c);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      bwd_abt(sc, dqa, st);
      bwd_abt(dp, doa, st + KV);
      wgmma_commit();
      pair_arrive(SCHED + (c + 1) % NC);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (steps == 1 && warp_lead) mbar_arrive(&qempty[b]);
      dq_grad(sc, dp, mask(0), 0, end, len == 0, t, ls, dl, g.scale);
      bwd_pack(da, sc);
    }
#pragma unroll 1
    for (int j = 1; j < steps; ++j) {
      const int sj = (it + j) % STAGES, sp = (it + j - 1) % STAGES;
      mbar_wait(&full[sj], ((it + j) / STAGES) & 1);
      pair_sync(SCHED + c);
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(acc);
      fence_regs(da);
      wgmma_fence();
      bwd_abt(sc, dqa, ring + sj * STAGE);
      bwd_abt(dp, doa, ring + sj * STAGE + KV);
      wgmma_commit();
      bwd_ab(acc, da, ring + sp * STAGE);
      wgmma_commit();
      pair_arrive(SCHED + (c + 1) % NC);
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      if (j == steps - 1 && warp_lead) mbar_arrive(&qempty[b]);
      dq_grad(sc, dp, mask(j * BK), j * BK, end, len == 0, t, ls, dl,
                  g.scale);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      if (warp_lead) mbar_arrive(&empty[sp]);       // k_{j-1} is read
      bwd_pack(da, sc);
    }
    {
      const int sp = (it + steps - 1) % STAGES;
      pair_sync(SCHED + c);
      fence_regs(acc);
      fence_regs(da);
      wgmma_fence();
      bwd_ab(acc, da, ring + sp * STAGE);
      wgmma_commit();
      pair_arrive(SCHED + (c + 1) % NC);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      if (warp_lead) mbar_arrive(&empty[sp]);
    }
    it += steps;

    // dq through this consumer's box, whose previous store must have
    // read it
    if (lead) bulk_wait_read<0>();
    warpgroup_sync(1 + c);
    bwd_stage(obox, acc, lr0, lr1, t);
    fence_async_smem();
    warpgroup_sync(1 + c);
    if (lead) {
      tma_store(&maps.dq, obox, 0, row0, bh);
      bulk_commit();
    }
  }
  if (c == 0) pair_sync(SCHED);         // the last consumer's last turn
  if (lead) bulk_wait_all();
}

// ---------------------------------------------------------------------
// dk and dv (row 4)
// ---------------------------------------------------------------------
namespace bkv {
constexpr int NC = 2;                   // consumer warpgroups
constexpr int BKT = 64 * NC;            // keys a work tile
constexpr int BQ = 64;                  // query rows a stage
constexpr int STAGES = 6;
constexpr int QD = BQ * D * 2;          // q or do of one stage
constexpr int VEC = BQ * 4;             // lse or delta of one stage
constexpr int STAGE = 2 * QD + (2 * VEC + 1023) / 1024 * 1024;
constexpr int BOX = 64 * D * 2;         // 64 rows: 8 KB
constexpr int KVBUF = 2 * NC * BOX;     // k and v of one work tile
constexpr int THREADS = 128 * (1 + NC); // producer + consumer warpgroups
constexpr int SCHED = 1 + NC;           // named barriers: the turns
constexpr size_t SMEM =                 // ring, k/v buffer, dk/dv boxes
    (size_t)STAGES * STAGE + KVBUF + 2 * NC * BOX + 1024;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
}  // namespace bkv

// k, v, dk, dv (BH, Tk, 64) as 64-row boxes; q, do (BH, Tq, 64) as
// stages.
struct DkvMaps {
  CUtensorMap q, dout, k, v, dk, dv;
};

// The query steps of the dk/dv work tile at key k0, from its first row
// r_first, the first that takes gradient from its keys (none, and no
// step, where they all lie at or past kv_length).
__device__ __forceinline__ int dkv_steps(int k0, int len, const FaGeo& g,
                                         int& r_first) {
  r_first = fa_row_begin(k0, len, g);
  return r_first < g.tq ? (g.tq - r_first + bkv::BQ - 1) / bkv::BQ : 0;
}

// p and ds of one query step on keys k0 (x[4nt], x[4nt+1]) and k1
// (x[4nt+2], x[4nt+3]) against the step's rows 8nt + 2t + e (the columns
// of sᵀ), lse and delta of those rows read from shared memory: p =
// exp(s·scale - lse), where `mask` says a mask can apply masked by
// `fa_score`'s rule by key (a row r keeps s, or -1e30 on a batch-head
// with kv_length 0, where rb <= r < Tq, rb the key's first row, and is
// -inf elsewhere), left in x; ds = p·(dp - delta)·scale in dp.
__device__ __forceinline__ void dkv_grad(float (&x)[bkv::BQ / 2],
                                         float (&dp)[bkv::BQ / 2], bool mask,
                                         int r0, const int (&rb)[2],
                                         bool dead, int t, const float* lse,
                                         const float* delta, int tq,
                                         float scale) {
  if (mask) {
    // row r0 + 8nt + 2t + e is kept where (unsigned)(8nt + e - lo) < span
    const int lo0 = rb[0] - r0 - 2 * t, lo1 = rb[1] - r0 - 2 * t;
    const unsigned span0 = tq - rb[0], span1 = tq - rb[1];
#pragma unroll
    for (int nt = 0; nt < bkv::BQ / 8; ++nt) {
      const float2 l = *reinterpret_cast<const float2*>(lse + 8 * nt + 2 * t);
      const float lr[2] = {l.x, l.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x0 = x[4 * nt + e];
        float& x1 = x[4 * nt + 2 + e];
        x0 = (unsigned)(nt * 8 + e - lo0) < span0
                 ? bwd_exp_arg(x0, scale, lr[e], dead) : -INFINITY;
        x1 = (unsigned)(nt * 8 + e - lo1) < span1
                 ? bwd_exp_arg(x1, scale, lr[e], dead) : -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < bkv::BQ / 8; ++nt) {
      const float2 l = *reinterpret_cast<const float2*>(lse + 8 * nt + 2 * t);
      const float lr[2] = {l.x, l.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[4 * nt + e] = bwd_exp_arg(x[4 * nt + e], scale, lr[e], false);
        x[4 * nt + 2 + e] =
            bwd_exp_arg(x[4 * nt + 2 + e], scale, lr[e], false);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < bkv::BQ / 8; ++nt) {
    const float2 d =
        *reinterpret_cast<const float2*>(delta + 8 * nt + 2 * t);
    const float dls[2] = {d.x * scale, d.y * scale};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i0 = 4 * nt + e, i1 = 4 * nt + 2 + e;
      x[i0] = fa_exp(x[i0]);
      x[i1] = fa_exp(x[i1]);
      dp[i0] = bwd_ds(x[i0], dp[i0], scale, dls[e]);
      dp[i1] = bwd_ds(x[i1], dp[i1], scale, dls[e]);
    }
  }
}

__global__ void __launch_bounds__(bkv::THREADS, 1)
bwd_dkv_tma(const __grid_constant__ DkvMaps maps,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ lens, int bh_total, int group, FaGeo g) {
  using namespace bkv;
  extern __shared__ unsigned char dkv_smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kvfull,
      kvempty;
  unsigned char* ring = smem_align1024(dkv_smem_raw);
  unsigned char* kvbuf = ring + STAGES * STAGE;
  unsigned char* obuf = kvbuf + KVBUF;
  const int tid = threadIdx.x;
  const int ntk = (g.tk + BKT - 1) / BKT, tiles = bh_total * ntk;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);      // the TMA, each producer lane
      mbar_init(&empty[s], 4 * NC);     // each consumer warp
    }
    mbar_init(&kvfull, 1);
    mbar_init(&kvempty, 4 * NC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer: its first warp keeps k, v and the ring filled, one
    // thread by TMA (k, v, q, do) and every lane by cp.async (lse and
    // delta, whose rows need not be 16-byte aligned; rows past Tq get
    // zeros)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid < 32) {
      int it = 0, kvi = 0;              // stages, k/v tiles filled so far
      for (int idx = blockIdx.x; idx < tiles; idx += gridDim.x) {
        int bh, kt, r_first;
        bwd_tile(idx, bh_total, ntk, group, false, bh, kt);
        const int k0 = kt * BKT;
        const int steps = dkv_steps(k0, max(lens[bh], 0), g, r_first);
        if (steps == 0) continue;
        if (tid == 0) {
          mbar_wait(&kvempty, (kvi & 1) ^ 1);
          mbar_expect_tx(&kvfull, KVBUF);
          for (int k = 0; k < NC; ++k) {
            tma_load(kvbuf + k * BOX, &maps.k, &kvfull, 0, k0 + 64 * k, bh);
            tma_load(kvbuf + (NC + k) * BOX, &maps.v, &kvfull, 0,
                     k0 + 64 * k, bh);
          }
        }
        ++kvi;
        const float* lb = lse + (size_t)bh * g.tq;
        const float* db = delta + (size_t)bh * g.tq;
        for (int j = 0; j < steps; ++j, ++it) {
          const int s = it % STAGES, r0 = r_first + j * BQ;
          unsigned char* st = ring + s * STAGE;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          if (tid == 0) {
            mbar_expect_tx(&full[s], 2 * QD);
            tma_load(st, &maps.q, &full[s], 0, r0, bh);
            tma_load(st + QD, &maps.dout, &full[s], 0, r0, bh);
          }
          float* ls = reinterpret_cast<float*>(st + 2 * QD);
          for (int h = tid; h < BQ; h += 32) {
            const bool ok = r0 + h < g.tq;
            cp_async4(ls + h, lb + (ok ? r0 + h : 0), ok);
            cp_async4(ls + BQ + h, db + (ok ? r0 + h : 0), ok);
          }
          mbar_arrive_cp_async(&full[s]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // Consumer c owns keys c*64 .. c*64+63 of every work tile of the block,
  // the rows of its sᵀ; warp w holds keys w*16 + gq and w*16 + gq + 8.
  const int c = tid / 128 - 1;
  const int ctid = tid % 128;
  const int w = ctid >> 5, lane = ctid & 31, gq = lane >> 2, t = lane & 3;
  const int lr0 = w * 16 + gq, lr1 = lr0 + 8;
  const bool lead = ctid == 0, warp_lead = lane == 0;
  unsigned char* kbox = obuf + 2 * c * BOX;
  unsigned char* vbox = kbox + BOX;
  if (c == NC - 1) pair_arrive(SCHED);  // consumer 0 takes the first turn

  float sc[BQ / 2];                     // sᵀ, then p, of one query step
  float dp[BQ / 2];                     // dpᵀ, then ds
  float dk[32], dv[32];                 // f32 accumulators
  uint32_t pa[BQ / 16][4];              // p in bf16: pᵀ·do's A operand
  uint32_t da[BQ / 16][4];              // ds in bf16: dsᵀ·q's A operand
  uint32_t ka[D / 16][4], va[D / 16][4];  // k, v: the A of sᵀ and dpᵀ
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[i][e] = da[i][e] = 0u;
  int it = 0, kvi = 0;                  // stages, k/v tiles consumed
  for (int idx = blockIdx.x; idx < tiles; idx += gridDim.x) {
    int bh, kt, r_first;
    bwd_tile(idx, bh_total, ntk, group, false, bh, kt);
    const int len = max(lens[bh], 0);
    const int steps = dkv_steps(kt * BKT, len, g, r_first);
    const int kc0 = kt * BKT + c * 64;
    // the first row that takes gradient from each of this lane's keys
    // (Tq where none does)
    const int keys[2] = {kc0 + lr0, kc0 + lr1};
    int rb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rb[h] = keys[h] >= g.tk ? g.tq : min(fa_row_begin(keys[h], len, g),
                                           g.tq);
    const int lim = min(len, g.tk);
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
    if (steps > 0) {
      // a query step needs the mask if this consumer's keys reach
      // min(kv_length, Tk), it crosses the diagonal under causal, it
      // holds Tq, or kv_length is 0
      auto mask = [&](int r0) {
        return len == 0 || kc0 + 64 > lim || r0 + BQ > g.tq ||
               (g.causal && r0 < kc0 + 63);
      };
      auto rows = [&](int s, int off) {
        return reinterpret_cast<const float*>(ring + s * STAGE + 2 * QD +
                                              off);
      };
      // this consumer's k and v rows into registers, which frees the
      // buffer for the next tile's
      mbar_wait(&kvfull, kvi & 1);
      bwd_frags(ka, kvbuf + c * BOX, lr0, lr1, t);
      bwd_frags(va, kvbuf + (NC + c) * BOX, lr0, lr1, t);
      __syncwarp();
      if (warp_lead) mbar_arrive(&kvempty);

      // Turn j (of steps + 1) issues sᵀ_j = k·q_jᵀ and dpᵀ_j = v·do_jᵀ
      // (j < steps) and dv += pᵀ_{j-1}·do_{j-1}, dk += dsᵀ_{j-1}·q_{j-1}
      // (j > 0), then computes p_j and ds_j while the last products run;
      // the first and last turns peeled, as in `bwd_dq_tma`.
      {
        const int s0 = it % STAGES;
        unsigned char* st = ring + s0 * STAGE;
        mbar_wait(&full[s0], (it / STAGES) & 1);
        pair_sync(SCHED + c);
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        bwd_abt_rs(sc, ka, st);
        bwd_abt_rs(dp, va, st + QD);
        wgmma_commit();
        pair_arrive(SCHED + (c + 1) % NC);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        fence_regs(ka);
        fence_regs(va);
        dkv_grad(sc, dp, mask(r_first), r_first, rb, len == 0, t,
                     rows(s0, 0), rows(s0, VEC), g.tq, g.scale);
        bwd_pack(pa, sc);
        bwd_pack(da, dp);
      }
#pragma unroll 1
      for (int j = 1; j < steps; ++j) {
        const int sj = (it + j) % STAGES, sp = (it + j - 1) % STAGES;
        const int r0 = r_first + j * BQ;
        mbar_wait(&full[sj], ((it + j) / STAGES) & 1);
        pair_sync(SCHED + c);
        fence_regs(sc);
        fence_regs(dp);
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
        bwd_abt_rs(sc, ka, ring + sj * STAGE);
        bwd_abt_rs(dp, va, ring + sj * STAGE + QD);
        wgmma_commit();
        bwd_ab(dv, pa, ring + sp * STAGE + QD);
        bwd_ab(dk, da, ring + sp * STAGE);
        wgmma_commit();
        pair_arrive(SCHED + (c + 1) % NC);
        wgmma_wait<1>();
        fence_regs(sc);
        fence_regs(dp);
        fence_regs(ka);
        fence_regs(va);
        dkv_grad(sc, dp, mask(r0), r0, rb, len == 0, t, rows(sj, 0),
                     rows(sj, VEC), g.tq, g.scale);
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
        if (warp_lead) mbar_arrive(&empty[sp]);     // q_{j-1}, do_{j-1}
        bwd_pack(pa, sc);
        bwd_pack(da, dp);
      }
      {
        const int sp = (it + steps - 1) % STAGES;
        pair_sync(SCHED + c);
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
        bwd_ab(dv, pa, ring + sp * STAGE + QD);
        bwd_ab(dk, da, ring + sp * STAGE);
        wgmma_commit();
        pair_arrive(SCHED + (c + 1) % NC);
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
        if (warp_lead) mbar_arrive(&empty[sp]);
      }
      it += steps;
      ++kvi;
    }

    // dk and dv (zeros for a tile without a step) through this consumer's
    // boxes, whose previous stores must have read them
    if (lead) bulk_wait_read<0>();
    warpgroup_sync(1 + c);
    bwd_stage(kbox, dk, lr0, lr1, t);
    bwd_stage(vbox, dv, lr0, lr1, t);
    fence_async_smem();
    warpgroup_sync(1 + c);
    if (lead) {
      tma_store(&maps.dk, kbox, 0, kc0, bh);
      tma_store(&maps.dv, vbox, 0, kc0, bh);
      bulk_commit();
    }
  }
  if (c == 0) pair_sync(SCHED);         // the last consumer's last turn
  if (lead) bulk_wait_all();
}

// ---------------------------------------------------------------------
// FMA kernels: float32, and bf16 of any d <= 256.
// ---------------------------------------------------------------------
constexpr int FB_ROWS = 16;          // rows a block owns (queries or keys)
constexpr int FB_STEP = 32;          // rows of the other side per step
constexpr int FB_THREADS = 128;

static size_t dq_fma_smem(int d) {
  return ((size_t)3 * FB_ROWS * d + (size_t)2 * FB_STEP * (d + 1) +
          (size_t)FB_ROWS * FB_STEP + 2 * FB_ROWS) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(FB_THREADS)
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

  load_rows_f32<T>(qs, d, q + qoff, q0, FB_ROWS, g.tq, d, tid, FB_THREADS);
  load_rows_f32<T>(dos, d, dout + qoff, q0, FB_ROWS, g.tq, d, tid, FB_THREADS);
  for (int i = tid; i < FB_ROWS * d; i += FB_THREADS) acc[i] = 0.f;
  if (tid < FB_ROWS) {
    const bool ok = tid < rows;
    lr[tid] = ok ? lse[(size_t)bh * g.tq + q0 + tid] : 0.f;
    dlr[tid] = ok ? delta[(size_t)bh * g.tq + q0 + tid] : 0.f;
  }

  for (int c0 = 0; c0 < kend; c0 += FB_STEP) {
    const int kc = min(FB_STEP, g.tk - c0);
    __syncthreads();
    load_rows_f32<T>(ks, ldk, k + koff, c0, kc, g.tk, d, tid, FB_THREADS);
    load_rows_f32<T>(vs, ldk, v + koff, c0, kc, g.tk, d, tid, FB_THREADS);
    __syncthreads();
    for (int i = tid; i < FB_ROWS * FB_STEP; i += FB_THREADS) {
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
    for (int i = tid; i < FB_ROWS * d; i += FB_THREADS) {
      const int r = i / d, e = i % d;
      const float* dsr = ds + r * FB_STEP;
      float a = acc[i];
      for (int j = 0; j < kc; ++j) a = fmaf(dsr[j], ks[j * ldk + e], a);
      acc[i] = a;
    }
  }
  for (int i = tid; i < rows * d; i += FB_THREADS)
    dq[qoff + (size_t)q0 * d + i] = from_f<T>(acc[i]);
}

static size_t dkv_fma_smem(int d) {
  return ((size_t)4 * FB_ROWS * d + (size_t)2 * FB_STEP * (d + 1) +
          (size_t)2 * FB_ROWS * FB_STEP + 2 * FB_STEP) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(FB_THREADS)
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

  load_rows_f32<T>(ks, d, k + koff, c0, FB_ROWS, g.tk, d, tid, FB_THREADS);
  load_rows_f32<T>(vs, d, v + koff, c0, FB_ROWS, g.tk, d, tid, FB_THREADS);
  for (int i = tid; i < FB_ROWS * d; i += FB_THREADS) dka[i] = dva[i] = 0.f;

  for (int r0 = rbegin; r0 < g.tq; r0 += FB_STEP) {
    const int rc = min(FB_STEP, g.tq - r0);
    __syncthreads();
    load_rows_f32<T>(qs, ldq, q + qoff, r0, rc, g.tq, d, tid, FB_THREADS);
    load_rows_f32<T>(dos, ldq, dout + qoff, r0, rc, g.tq, d, tid, FB_THREADS);
    if (tid < FB_STEP) {
      const bool ok = tid < rc;
      lr[tid] = ok ? lse[(size_t)bh * g.tq + r0 + tid] : 0.f;
      dlr[tid] = ok ? delta[(size_t)bh * g.tq + r0 + tid] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FB_ROWS * FB_STEP; i += FB_THREADS) {
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
    for (int i = tid; i < FB_ROWS * d; i += FB_THREADS) {
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
  for (int i = tid; i < keys * d; i += FB_THREADS) {
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
  bwd_dq_fma<T><<<grid, FB_THREADS, smem, st>>>(
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
  bwd_dkv_fma<T><<<grid, FB_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lens, static_cast<T*>(dk), static_cast<T*>(dv), g);
  return cudaGetLastError();
}


static cudaError_t launch_dq_tma(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* lens,
                                 void* dq, int bh, const FaGeo& g,
                                 cudaStream_t st) {
  using namespace bdq;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long sq = (long long)g.tq * D, sk = (long long)g.tk * D;
  DqMaps maps;
  const bool ok = encode(fn, &maps.q, q, D, g.tq, bh, D, sq, 64) &&
                  encode(fn, &maps.dout, dout, D, g.tq, bh, D, sq, 64) &&
                  encode(fn, &maps.k, k, D, g.tk, bh, D, sk, BK) &&
                  encode(fn, &maps.v, v, D, g.tk, bh, D, sk, BK) &&
                  encode(fn, &maps.dq, dq, D, g.tq, bh, D, sq, 64);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(bwd_dq_tma, SMEM);
  if (err != cudaSuccess) return err;
  const int ntq = (g.tq + BQ - 1) / BQ, grid = persistent_grid(bh * ntq);
  const int group = grid < ntq ? 1 : grid / ntq;
  bwd_dq_tma<<<grid, THREADS, SMEM, st>>>(maps, lse, delta, lens, bh, group,
                                          g);
  return cudaGetLastError();
}

static cudaError_t launch_dkv_tma(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  const int* lens, void* dk, void* dv,
                                  int bh, const FaGeo& g, cudaStream_t st) {
  using namespace bkv;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long sq = (long long)g.tq * D, sk = (long long)g.tk * D;
  DkvMaps maps;
  const bool ok = encode(fn, &maps.q, q, D, g.tq, bh, D, sq, BQ) &&
                  encode(fn, &maps.dout, dout, D, g.tq, bh, D, sq, BQ) &&
                  encode(fn, &maps.k, k, D, g.tk, bh, D, sk, 64) &&
                  encode(fn, &maps.v, v, D, g.tk, bh, D, sk, 64) &&
                  encode(fn, &maps.dk, dk, D, g.tk, bh, D, sk, 64) &&
                  encode(fn, &maps.dv, dv, D, g.tk, bh, D, sk, 64);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(bwd_dkv_tma, SMEM);
  if (err != cudaSuccess) return err;
  const int ntk = (g.tk + BKT - 1) / BKT, grid = persistent_grid(bh * ntk);
  const int group = grid < ntk ? 1 : grid / ntk;
  bwd_dkv_tma<<<grid, THREADS, SMEM, st>>>(maps, lse, delta, lens, bh,
                                           group, g);
  return cudaGetLastError();
}

// For the wgmma kernels (bf16, d = 64) the bases are 16-byte aligned.
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
    err = launch_dq_tma(q, k, v, dout, lse, delta, lens, dq, bh, g, st);
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
    err = launch_dkv_tma(q, k, v, dout, lse, delta, lens, dk, dv, bh, g, st);
  } else if (is_bf16) {
    err = launch_dkv_fma<bf16>(q, k, v, dout, lse, delta, lens, dk, dv, bh, g,
                               st);
  } else {
    err = launch_dkv_fma<float>(q, k, v, dout, lse, delta, lens, dk, dv, bh,
                                g, st);
  }
  return static_cast<int>(err);
}
