// Device code shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_backward.cu) kernels.
//
// Band: every kernel attends (q, k) pairs with lo <= q - k < hi, the
// internal form of tpudist/ops/flash_attention.py _normalize_band (causal
// is [0, inf), a sliding window W is [0, W), no mask is (-inf, inf); the
// wrapper passes +-kUnbounded for an open side).  Masked scores take the
// hard constant -1e30 as in the Pallas kernels, so a row without a live key
// ends with m = -1e30 and is "dead": out 0, lse -1e30.
//
// bf16 tiles go through the tensor cores with mma.sync m16n8k16 (bf16
// operands, f32 accumulation): a warp owns 16 rows of the CTA's tile, the
// score tile stays in registers and is re-packed in place as the A operand
// of the next product (the C fragment of two adjacent 8-column tiles is the
// A fragment of one 16-deep step).  Shared-memory rows are padded by 8
// elements (16 bytes) so the fragment loads and ldmatrix are free of bank
// conflicts.  Global tiles arrive by cp.async with zero fill past the
// sequence end: double-buffered against the math in the backward passes;
// the forward keeps one buffer and three CTAs per SM instead.
//
// Head dims: the bf16 tiles are compiled for a few padded widths DP
// (pad_head_dim: 16, 32, 64, 96, 128, 256) and take any real head dim
// d <= DP at run time.  Columns d..DP - 1 of every shared tile load as
// zeros, so they add nothing to a product over the depth and their output
// columns are never stored.  The f32 kernels take d at run time, up to
// kMaxHeadDim.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tpd_flash {

using bf16 = __nv_bfloat16;

constexpr float kMask = -1e30f;
constexpr int kUnbounded = 1 << 30;
constexpr int kThreads = 128;  // 4 warps a CTA
constexpr float kLog2e = 1.4426950408889634f;

// exp(x - m) of the bf16 softmax tiles as exp2f((x - m)·log2 e): a
// subtract, a multiply and one MUFU.EX2 against expf's longer sequence.
// The difference is formed first, so x == m
// (a fully masked row: -1e30 against -1e30) gives exactly 1 as expf does;
// p moves by < 3e-6 relative for x - m >= -30, far below the bf16 rounding
// p takes next.
__device__ __forceinline__ float exp_row(float x, float m) {
  return exp2f((x - m) * kLog2e);
}

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kMaxHeadDim = 256;

// The padded width whose bf16 tiles hold head dim d; 0 past kMaxHeadDim.
__host__ __device__ constexpr int pad_head_dim(int d) {
  return d <= 16    ? 16
         : d <= 32  ? 32
         : d <= 64  ? 64
         : d <= 96  ? 96
         : d <= 128 ? 128
         : d <= kMaxHeadDim ? kMaxHeadDim
                            : 0;
}

__device__ __forceinline__ bool in_band(int q, int k, int lo, int hi) {
  const int d = q - k;
  return d >= lo && d < hi;
}

// Every (q, k) of rows [q0, q0 + nq) x keys [k0, k0 + nk) lies in the band
// and before key_end: the mask is a provable no-op (the Pallas kernels'
// _tile_interior).
__device__ __forceinline__ bool tile_interior(int q0, int nq, int k0, int nk,
                                              int lo, int hi, int key_end) {
  return (long long)q0 - (k0 + nk - 1) >= lo &&
         (long long)q0 + nq - 1 - k0 < hi && k0 + nk <= key_end;
}

// Live key tiles [first, last] of width bk for query rows [q0, q_last]
// (_band_kv_index / _last_live_kv): keys q - hi < k <= q - lo, k < Sk.
// first > last when the rows have no live key.
__device__ __forceinline__ void kv_tiles(int q0, int q_last, int lo, int hi,
                                         int Sk, int bk, int& first,
                                         int& last) {
  const long long kmax = (long long)q_last - lo;
  const long long kmin = (long long)q0 - hi + 1;
  const int nkv = (Sk + bk - 1) / bk;
  first = 0;
  last = -1;
  if (kmax < 0 || kmin > Sk - 1) return;
  last = (int)(kmax / bk < nkv - 1 ? kmax / bk : nkv - 1);
  first = (int)((kmin > 0 ? kmin : 0) / bk);
}

// Live query tiles [first, last] of width bq for key rows [k0, k_last]
// (the dk/dv pass's q_index): queries k + lo <= q < k + hi, q < Sq.
__device__ __forceinline__ void q_tiles(int k0, int k_last, int lo, int hi,
                                        int Sq, int bq, int& first,
                                        int& last) {
  const long long qmin = (long long)k0 + lo;
  const long long qmax = (long long)k_last + hi - 1;
  first = 0;
  last = -1;
  if (qmax < 0 || qmin > Sq - 1) return;
  last = (int)((qmax < Sq - 1 ? qmax : Sq - 1) / bq);
  first = (int)((qmin > 0 ? qmin : 0) / bq);
}

// ---------------------------------------------------------------- tensor cores

// c += a (16x16, row-major bf16) * b (16x8, col-major bf16), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices from shared memory; lane i addresses
// row (i % 8) of matrix (i / 8).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows x 16 cols) of a row-major bf16 tile in shared memory
// with leading dimension ld, rows r0.., cols c0..
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* t, int ld,
                                       int r0, int c0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  const bf16* p = t + (r0 + g) * ld + c0 + tq * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// acc[n-tile] += A * T^T as mma_abt below, the A fragments of rows r0.. of
// the row-major shared tile A (leading dimension lda) loaded per 16-deep
// step instead of held: the register budget of the widest head dims.
template <int NT, int KS>
__device__ __forceinline__ void mma_abt_smem(float (*acc)[4], const bf16* A,
                                             int lda, int r0, const bf16* t,
                                             int ld, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    load_a(a, A, lda, r0, kk * 16, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* p = t + (n * 8 + g) * ld + kk * 16 + tq * 2;
      mma_bf16(acc[n], a, lds32(p), lds32(p + 8));
    }
  }
}

// acc[n-tile] += A(16 x 16·KS, fragments a[KS]) * T^T for the 8-row blocks
// n = 0..NT-1 of a row-major tile T (rows = output columns, cols = depth):
// the B operand of T^T is two contiguous bf16 of a T row.
template <int NT, int KS>
__device__ __forceinline__ void mma_abt(float (*acc)[4], uint32_t (*a)[4],
                                        const bf16* t, int ld, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* p = t + (n * 8 + g) * ld + kk * 16 + tq * 2;
      mma_bf16(acc[n], a[kk], lds32(p), lds32(p + 8));
    }
}

// acc[n-tile over the DN·8 columns of T] += P (16 x 16·KS, f32 C fragments
// p[2·KS], rounded to bf16 here) * T, T row-major in shared memory with its
// rows as the depth: the B operand is read transposed by ldmatrix.
template <int DN, int KS>
__device__ __forceinline__ void mma_pt(float (*acc)[4], float (*p)[4],
                                       const bf16* t, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                     pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                     pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                     pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* row =
        t + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
#pragma unroll
    for (int n2 = 0; n2 < DN / 2; ++n2) {
      uint32_t b[4];
      ldsm_x4_trans(b, row + n2 * 16);
      mma_bf16(acc[2 * n2], a, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + ROWS) of a [n_rows, D] bf16 matrix into a [ROWS][D + 8]
// shared tile; rows past n_rows are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_async(bf16* sm, const bf16* g,
                                                int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += blockDim.x) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(sm + r * (D + 8) + col,
               g + (size_t)(ok ? row0 + r : 0) * D + col, ok);
  }
}

// rows [row0, row0 + ROWS) of a [n_rows, d] bf16 matrix (d < DP) into a
// [ROWS][DP + 8] shared tile; rows past n_rows and columns past d are
// zero.  Rows of d % 8 == 0 elements start on 16 bytes and copy by
// cp.async; other widths copy element by element (the stores are done
// when the caller's barrier that follows its cp_wait is).  Kept out of
// line: the kernels' tile loops inline only the exact width's copy.
template <int ROWS, int DP>
__device__ __noinline__ void load_tile_padded(bf16* sm, const bf16* g,
                                              int row0, int n_rows, int d) {
  constexpr int kChunks = DP / 8;
  if ((d & 7) == 0) {
    for (int c = threadIdx.x; c < ROWS * kChunks; c += blockDim.x) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const bool ok = row0 + r < n_rows && col < d;
      cp_async16(sm + r * (DP + 8) + col,
                 g + (ok ? (size_t)(row0 + r) * d + col : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += blockDim.x) {
      const int r = i / DP, col = i % DP;
      sm[r * (DP + 8) + col] = row0 + r < n_rows && col < d
                                   ? g[(size_t)(row0 + r) * d + col]
                                   : __float2bfloat16(0.f);
    }
  }
}

// The same for any d <= DP: the exact width's copy where d == DP.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile_async(bf16* sm, const bf16* g,
                                                int row0, int n_rows, int d) {
  if (d == DP)
    load_tile_async<ROWS, DP>(sm, g, row0, n_rows);
  else
    load_tile_padded<ROWS, DP>(sm, g, row0, n_rows, d);
}

// rows [row0, row0 + ROWS) of a [n_rows, D] f32 matrix into a shared tile
// with leading dimension ld; rows past n_rows are zero
template <int ROWS>
__device__ __forceinline__ void load_tile_f32(float* sm, int ld,
                                              const float* g, int row0,
                                              int n_rows, int D) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sm[r * ld + c] = row0 + r < n_rows ? g[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

// Output columns c and c + 1 (c even) of a row of d values at `row`: one
// paired store where both lie in the row and d is even (the pair is then
// aligned), else each on its own; columns at or past d are not stored.
__device__ __forceinline__ void store_pair(bf16* row, int c, int d, float a,
                                           float b) {
  if ((d & 1) == 0 && c + 1 < d) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(a, b);
  } else {
    if (c < d) row[c] = __float2bfloat16_rn(a);
    if (c + 1 < d) row[c + 1] = __float2bfloat16_rn(b);
  }
}
__device__ __forceinline__ void store_pair(float* row, int c, int d, float a,
                                           float b) {
  if ((d & 1) == 0 && c + 1 < d) {
    *reinterpret_cast<float2*>(row + c) = make_float2(a, b);
  } else {
    if (c < d) row[c] = a;
    if (c + 1 < d) row[c + 1] = b;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace tpd_flash
