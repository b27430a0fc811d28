// Pieces shared by the attention kernels for Hopper (flash_short_fwd.cu,
// flash_short_bthd_bwd.cu, flash_fwd.cu, flash_bwd.cu): element
// conversions, the mma.sync, ldmatrix and cp.async wrappers, the short
// kernels' row addressing, and the mask rule of the streaming TPU kernels
// (incubator_mxnet_tpu/ops/flash_attention.py `_fwd_kernel`,
// `_bwd_dq_kernel`, `_bwd_dkv_kernel`).
//
// Layouts of the streaming kernels: q and do (bh, tq, d); k, v (bh, tk,
// d); lse and delta (bh, tq) float32; lens (bh,) int32; all contiguous
// (the short kernels address rows through `Rows`).  The JAX block
// sizes jbq, jbk (after `_fit_block`) do not tile these kernels; they
// only decide which keys a row with kv_length 0 attends to (`fa_score`).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define FA_NEG_BIG (-1e30f)      // the TPU kernels' mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the TPU kernels' `.astype(T)` before a dot
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the 4 lanes of an mma.sync quad hold one accumulator row between them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Problem geometry, the same for every block of a launch.
struct FaGeo {
  int tq, tk, d, causal, jbq, jbk;
  float scale;
};

// The score the TPU kernels give key c of query row r, where x is the
// scaled q·k, or -inf for a key that adds exactly nothing:
//  * a key the row may see keeps x;
//  * a key >= kv_length, or (causal) c > r, is -1e30 in the TPU kernels;
//    for a row with kv_length > 0 exp(-1e30 - m) and exp(-1e30 - lse)
//    are exactly 0 there, so -inf gives the same result;
//  * a row with kv_length 0 has every score at -1e30, so each key of a
//    key tile its grid step visits gets p = 1 (forward: exp(0); backward:
//    lse = -1e30 + log(l) rounds to -1e30).  Under causal the TPU grid
//    skips key tile j of query tile i when j*bk > i*bq + bq - 1; the keys
//    of skipped tiles add nothing (-inf);
//  * c >= tk and r >= tq are the ragged edges of this kernel's own tiles.
// The order is the TPU kernels': scale, then mask.  Callers keep
// exp(s - m) and exp(s - lse) as a subtraction followed by exp, never a
// fused multiply-add, so that -1e30 - (-1e30) stays exactly 0.
__device__ __forceinline__ float fa_score(float x, int r, int c, int len,
                                          const FaGeo& g) {
  if (c >= g.tk || r >= g.tq) return -INFINITY;
  if (c < len && !(g.causal && c > r)) return x;
  if (len > 0) return -INFINITY;
  if (!g.causal || (c / g.jbk) * g.jbk <= (r / g.jbq) * g.jbq + g.jbq - 1)
    return FA_NEG_BIG;
  return -INFINITY;
}

// One past the last key that can add to query rows <= r_last.
__device__ __forceinline__ int fa_key_end(int r_last, int len,
                                          const FaGeo& g) {
  if (len > 0) {
    const int end = min(g.tk, len);
    return g.causal ? min(end, r_last + 1) : end;
  }
  if (!g.causal) return g.tk;
  const int last_tile = ((r_last / g.jbq) * g.jbq + g.jbq - 1) / g.jbk;
  return min(g.tk, (last_tile + 1) * g.jbk);
}

// The first query row that can take gradient from keys >= c0 (tq when
// none does).
__device__ __forceinline__ int fa_row_begin(int c0, int len,
                                            const FaGeo& g) {
  if (len > 0 && c0 >= len) return g.tq;
  if (!g.causal) return 0;
  if (len > 0) return c0;
  return ((c0 / g.jbk) * g.jbk / g.jbq) * g.jbq;
}

// ---------------------------------------------------------------------
// Tensor-core helpers (bf16, mma.sync.m16n8k16 with f32 accumulators).
// Fragments (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, col-major):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16x8, f32):        c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// so C tiles 2j and 2j+1 of a product are the A fragment of k-step j of
// the next one (`pack_a`).
// ---------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of k-step kk from a row-major [rows][ld] bf16 tile whose row
// `row` is this lane's first row (g) of the 16-row slab.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row, int ld, int kk, int t) {
  const bf16* p0 = tile + row * ld + kk * 16 + 2 * t;
  const bf16* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// A fragment of k-step j from the f32 C tiles 2j and 2j+1, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc[nt] = A · Yᵀ over a 64-wide k, Y row-major [n][ld] in shared
// memory (n = 8*nt + g): the B operand read along Y's rows.
template <int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* y, int ld, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* p = y + (nt * 8 + g) * ld + kk * 16 + 2 * t;
      mma_bf16(acc[nt], a[kk], ld32(p), ld32(p + 8));
    }
  }
}

// ldmatrix .x4 .trans at a 16-byte-aligned shared-memory row address.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// acc[dt] += A_j · Y[16j .. 16j+16][0 .. 64) for the KS k-steps j, Y
// row-major [k][ld] in shared memory (64 columns, 8 output tiles): the B
// operand read down Y's columns with ldmatrix.trans.  Lane l addresses
// row 16j + (l & 7) + 8((l >> 3) & 1) at column 16p + 8(l >> 4), so the
// four matrices are b0, b1 of column tile 2p and b0, b1 of tile 2p + 1.
template <int KS>
__device__ __forceinline__ void mma_ab(float (&acc)[8][4],
                                       const uint32_t (&a)[KS][4],
                                       const bf16* y, int ld, int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4_trans(b, y + (j * 16 + row) * ld + p * 16 + col);
      mma_bf16(acc[2 * p], a[j], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[j], b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------
// cp.async: global -> shared without registers; `valid` false zero-fills.
// ---------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) of a (n, d) matrix of T into a [*][ld] float
// shared tile (plain loads, for the FMA kernels); rows past n are zeros.
template <typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const T* src, int row0,
                                              int rows, int n, int d,
                                              int tid, int nthreads) {
  for (int i = tid; i < rows * d; i += nthreads) {
    const int r = i / d, e = i % d;
    dst[r * ld + e] =
        row0 + r < n ? to_f(src[(size_t)(row0 + r) * d + e]) : 0.f;
  }
}

// ---------------------------------------------------------------------
// Row addressing of the short kernels.  A (B, T, H, d) tensor whose d
// elements of one head's row are contiguous has element (b, t, h, e) at
// b*bs + t*ts + h*d + e; batch-head bh is head bh % H of batch bh / H.
// The (BH, T, d) layout of `flash_short_fwd` is H = 1, bs = T*d, ts = d;
// the BTHD layout of q, k, v cut from a fused (B, T, 3E) projection is
// bs = T*3E, ts = 3E.
// ---------------------------------------------------------------------
struct Rows {
  long long bs, ts;
};

// Offset of row 0 of batch-head bh.
__device__ __forceinline__ size_t head_at(const Rows& l, int bh, int heads,
                                          int d) {
  return (size_t)(bh / heads) * l.bs + (size_t)(bh % heads) * d;
}

// The dynamic shared memory a kernel asks for, then the launch error.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
