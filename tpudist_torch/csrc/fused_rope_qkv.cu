// Fused RoPE + QKV projection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/fused_linear.py
// (fused_rope_qkv, body _rope_qkv_kernel): qkv = h[S·T, d] · w[d, dtot],
// then + extra on the lanes whose on[s] is non-zero (the LoRA qkv delta,
// before the rotation), the split into q [S, nh, T, dh], k and v
// [S, n_kv, T, dh], and GPT-NeoX half-split RoPE of q and k at the absolute
// positions offsets[s] + t.
//
// Rounding follows the Pallas kernel and the port's unfused arm: the
// product accumulates in f32 and rounds to the compute dtype; the delta is
// added in f32 and the sum rounds again; the rotation runs in f32 from the
// rounded values (freqs = powf(base, -j / half) with an IEEE division,
// angles = (offset + t) · freq, sinf / cosf, each product and sum rounded
// on its own as torch's elementwise kernels round them, so no FMA
// contraction) and rounds once more.  Only the order of the f32 sum over
// the depth differs between the arms.
//
// Bound on the H100: bytes.  At decode (S·T = 8 rows) the 6.29 MB bf16
// weight is the traffic and the product does 2 flops per weight byte; at
// prefill (512 rows) the weight, h, extra and the outputs still outweigh
// the 3.2 GFLOP at the tensor-core rate.  Every arm reads the weight as it
// lies: the port stores the qkv projection as [dtot, d] (row = output
// column, contiguous over the depth), the K-major B operand of both
// mma.sync and wgmma, and a head's rotation pair (j, j + dh/2) always ends
// in one thread's accumulators, so the rotation is an epilogue in
// registers.  Arms (ops/fused_linear.py _rope_arm picks one; only the
// smoke and the CUDA tests force another):
//
// - split (bf16, S·T <= kSplitRows at head dims that are multiples of
//   kSplitCols: decode, the draft steps, the speculative verify).  The
//   weight read is the whole cost, so the grid puts all of it in flight at
//   once: a thread-block cluster of kSplitKS CTAs owns kSplitCols output
//   columns (32 rotation pairs of one head), and CTA r of it takes the
//   r-th depth slice (at d 1024: 128 deep, 384 CTAs, 16 KB of weight
//   each).  A CTA issues its whole weight slice and its h rows by cp.async
//   in one wave (rows past S·T zero-filled, not read) and waits once; while
//   they fly, the threads that finish a row read its delta, lane mask and
//   offset and compute its angles.  Warp w multiplies n-tiles w and w + 4
//   (the first halves of pairs 8w..8w+7 and their partners) over the slice
//   on mma.sync m16n8k16, and writes both halves of its pairs into the
//   send slot of their owner (rank r owns pairs 4r..4r+3).  One thread then
//   sends each slot to its owner by a bulk copy into distributed shared
//   memory (cp.async.bulk, the copy engine), completing on the owner's
//   mbarrier; every owner set up that barrier, expecting all kSplitKS
//   slots, before the relaxed arrive of a cluster barrier that opens the
//   kernel, and that barrier's wait comes before the sends (no CTA writes
//   into one that has not started).  Each owner sums the kSplitKS partials
//   of a row in rank order (0 first) and finishes its pairs; no CTA reads
//   another's shared memory, so none waits to leave.  A row's sum never
//   depends on S·T: the slices, the order within each (mma.sync over the
//   slice's 16-deep steps) and across them are fixed by d alone, so the
//   verify's rows sum as the decode step's do.  No global atomics: the
//   result is deterministic.
// - wgmma (bf16, head dims 64 and 128, longer S·T: the prefill chunks).  A
//   CTA owns kWgRows rows × one whole head, so each h tile is read once a
//   head instead of once per 32 columns: dh / 64 warpgroups, warpgroup g
//   multiplying the rows by its own 64-row B tile (the first-half weight
//   rows of pairs 32g..32g+31, then their partners) on wgmma m64n64k16,
//   both operands from shared memory.  h [S·T, d] and the weight
//   [dtot, d] arrive by TMA (boxes of 64 rows of h and of 32 weight rows,
//   64 deep, in the 128-byte swizzle of hopper_mma.cuh; rows past S·T
//   zero-filled by the map) into a ring of kWgStages stages, thread 0
//   keeping kWgStages - 1 tiles in flight ahead of the products.  A pair's
//   first half lies in accumulator block i and its partner in block i + 4
//   of the same thread, so the epilogue rotates in registers and stores two
//   neighbouring columns at a time.
// - mma (bf16, every other head dim and depth; the yardstick the smoke
//   times the new arms against): a CTA owns 64 rows × 32 columns (16
//   pairs), depth tiles of 64 by cp.async, three stages, 4 warps on
//   mma.sync.
// - f32: the mma arm's tiling on CUDA-core FMAs (never TF32).
//
// The mma and f32 arms take any head dim and any depth.  A head's columns
// pair as (j, j + half) with half = ceil(dh / 2) (dh / 2 under RoPE, which
// needs an even dh), 16 pairs a column block, so a block past the head's
// last pair (dh 80: pairs 32..39 of block 2) loads zeros for the weight
// rows that do not exist and stores nothing for them; an odd dh (RoPE
// off) has no partner for its last column.  The depth loop runs
// ceil(d / 64) tiles, the last one zero past d; rows of h and of the
// weight that start on 16 bytes (d % 8 == 0) copy by cp.async, others
// element by element.
//
// Resources (ptxas for sm_90a; no spills): split 64 registers, dynamic
// shared memory 29,960 / 55,048 / 67,592 bytes at 8 / 40 / 64 rows and d
// 1024 (cudaOccupancyMaxActiveClusters 107 and 62 clusters of 8 at 8 and
// 40 rows, 48 a call); wgmma 81 registers, 99,360 bytes at head dim 128
// (two CTAs an SM) and 66,592 at 64; mma 87 registers, 41,472 bytes
// static; f32 56 registers, 12,672 bytes.
//
// What bounds them on the H100 (tests/torch_rope_timeline.py, the device
// clock inside a launch timed as chip_smoke.time_ms times it: L2 flushed,
// which leaves it dirty): split at decode spends ~4.6 us of its ~6.4 us
// span loading the weight (6.29 MB plus the write-back of as many dirty
// lines), ~1 us on the product and the send slots, ~0.5 us on the copies
// and ~0.3 us finishing; at the T 5 verify the product and the slots take
// ~2 us. wgmma at prefill waits ~2.5 us for its first tile, runs its 16
// tiles in ~6.2 us (the 2-CTA SMs move 768 KB of tiles from L2 each) and
// finishes in ~3.5 us (the deltas' first read, sincosf, the stores).
// Outside the span each launch costs the timer's floor, ~5 us.
#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"
#include "tma_host.cuh"

namespace {

using tpd_flash::bf16;
namespace hw = tpd_hopper;

constexpr int kRows = 64;    // rows of S·T per CTA (mma, f32)
constexpr int kCols = 32;    // output columns per CTA: 16 rotation pairs
constexpr int kDepth = 64;   // depth tile (bf16)
constexpr int kLd = kDepth + 8;
constexpr int kStages = 3;
constexpr int kDepthF = 32;  // depth tile (f32)
constexpr int kThreads = tpd_flash::kThreads;
// split arm
constexpr int kSplitRows = 64;        // S·T up to this takes the split arm
constexpr int kSplitKS = 8;           // CTAs a cluster: depth slices
constexpr int kSplitMaxDepth = 8192;  // d up to this takes the split arm
// wgmma arm
constexpr int kWgRows = 64;    // rows of S·T per CTA
constexpr int kWgStages = 4;   // ring stages of 64-deep tiles

enum Arm : int { kArmF32 = 0, kArmMma = 1, kArmSplit = 2, kArmWgmma = 3 };

struct Args {
  const void* h;       // [M, d], M = S·T
  const void* wt;      // [dtot, d]
  const int* offsets;  // [S]
  const void* extra;   // [M, dtot] or null
  const void* on;      // [S] int32 or bool, or null (all on)
  const float* freqs;  // [dh/2] rotation frequencies (split, wgmma)
  void* q;             // [S, nh, T, dh]
  void* k;             // [S, n_kv, T, dh]
  void* v;
  int S, T, d, nh, n_kv, dh, on_is_bool, rope;
  float base;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// round to the storage dtype and back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// One row of one head as its epilogue sees it: where its dh outputs go,
// its delta at the head's first column (null where there is none; read
// whether or not the lane is on, so the read need not wait for the mask),
// whether it adds the delta (the lane is on) and whether and where it
// rotates.
template <typename T>
struct HeadRow {
  T* out;
  const T* e;
  float pos;
  bool add, rot;
};

template <typename T>
__device__ __forceinline__ HeadRow<T> head_row(const Args& a, int m,
                                               int head) {
  const int s = m / a.T, t = m % a.T;
  const int dtot = (a.nh + 2 * a.n_kv) * a.dh;
  HeadRow<T> r;
  r.e = a.extra ? static_cast<const T*>(a.extra) + (size_t)m * dtot +
                      head * a.dh
                : nullptr;
  r.add = a.extra &&
          (a.on == nullptr ||
           (a.on_is_bool ? static_cast<const uint8_t*>(a.on)[s] != 0
                         : static_cast<const int*>(a.on)[s] != 0));
  r.rot = a.rope && head < a.nh + a.n_kv;
  r.pos = r.rot ? __fadd_rn((float)a.offsets[s], (float)t) : 0.f;
  T* out;
  int hh, nheads;
  if (head < a.nh) {
    out = static_cast<T*>(a.q);
    hh = head;
    nheads = a.nh;
  } else if (head < a.nh + a.n_kv) {
    out = static_cast<T*>(a.k);
    hh = head - a.nh;
    nheads = a.n_kv;
  } else {
    out = static_cast<T*>(a.v);
    hh = head - a.nh - a.n_kv;
    nheads = a.n_kv;
  }
  r.out = out + (((size_t)s * nheads + hh) * a.T + t) * a.dh;
  return r;
}

__device__ __forceinline__ float rope_freq(const Args& a, int jl) {
  return powf(a.base, -(float)jl / (float)(a.dh / 2));
}

__device__ __forceinline__ void angle(float pos, float freq, float& sn,
                                      float& cs) {
  // sincosf: one range reduction for both, each result bit for bit sinf's
  // and cosf's
  sincosf(__fmul_rn(pos, freq), &sn, &cs);
}

// One rotation pair's accumulators v1 (first half) and v2 (partner):
// rounded, plus the delta (e1, e2) where has_e, rotated by the angle's
// sine and cosine where rot, as the module header says.
template <typename T>
__device__ __forceinline__ void pair_math(float& v1, float& v2, bool has_e,
                                          float e1, float e2, bool rot,
                                          float sn, float cs) {
  v1 = rnd<T>(v1);
  v2 = rnd<T>(v2);
  if (has_e) {
    v1 = rnd<T>(__fadd_rn(v1, e1));
    v2 = rnd<T>(__fadd_rn(v2, e2));
  }
  if (rot) {
    const float r1 = __fsub_rn(__fmul_rn(v1, cs), __fmul_rn(v2, sn));
    const float r2 = __fadd_rn(__fmul_rn(v1, sn), __fmul_rn(v2, cs));
    v1 = r1;
    v2 = r2;
  }
}

// The pairing of a head's columns on the mma and f32 arms: (j, j + half),
// half = ceil(dh / 2) (dh / 2 under RoPE, whose dh is even).
__device__ __forceinline__ int pair_half(const Args& a) {
  return (a.dh + 1) / 2;
}

// One rotation pair of one row: column jl of the head and jl + half; a pair
// past the head's last (jl >= half) is not stored, nor a partner past dh.
template <typename T>
__device__ __forceinline__ void finish_pair(const Args& a,
                                            const HeadRow<T>& r, int jl,
                                            float v1, float v2) {
  const int half = pair_half(a);
  if (jl >= half) return;
  const bool has2 = jl + half < a.dh;
  float sn = 0.f, cs = 1.f;
  if (r.rot) angle(r.pos, rope_freq(a, jl), sn, cs);
  pair_math<T>(v1, v2, r.add, r.add ? to_f(r.e[jl]) : 0.f,
               r.add && has2 ? to_f(r.e[jl + half]) : 0.f, r.rot, sn, cs);
  r.out[jl] = from_f<T>(v1);
  if (has2) r.out[jl + half] = from_f<T>(v2);
}

// What two neighbouring bf16 pairs (jl and jl + 1, jl even) of a row add:
// the deltas of jl, jl + 1 (x) and of their partners (y), packed as they
// lie; zero where the row has none.
struct PairDelta {
  __nv_bfloat162 x, y;
};

__device__ __forceinline__ PairDelta pair_delta(const HeadRow<bf16>& r,
                                                int jl, int half) {
  PairDelta e;
  e.x = e.y = __floats2bfloat162_rn(0.f, 0.f);
  if (r.e != nullptr) {
    e.x = *reinterpret_cast<const __nv_bfloat162*>(r.e + jl);
    e.y = *reinterpret_cast<const __nv_bfloat162*>(r.e + jl + half);
  }
  return e;
}

// ... and what they turn by: the sines and cosines of their angles at
// frequencies f0 and f1 (none where the row does not rotate).
struct PairTurn {
  float sn[2], cs[2];
};

__device__ __forceinline__ PairTurn pair_turn(const HeadRow<bf16>& r,
                                              float f0, float f1) {
  PairTurn t;
  t.sn[0] = t.sn[1] = 0.f;
  t.cs[0] = t.cs[1] = 1.f;
  if (r.rot) {
    angle(r.pos, f0, t.sn[0], t.cs[0]);
    angle(r.pos, f1, t.sn[1], t.cs[1]);
  }
  return t;
}

// The two pairs' accumulators: (x0, x1) columns jl, jl + 1, (y0, y1)
// their partners; stored as two bf16x2.
__device__ __forceinline__ void finish_two(const HeadRow<bf16>& r, int jl,
                                           int half, const PairDelta& e,
                                           const PairTurn& t, float x0,
                                           float x1, float y0, float y1) {
  const float2 ex = __bfloat1622float2(e.x), ey = __bfloat1622float2(e.y);
  pair_math<bf16>(x0, y0, r.add, ex.x, ey.x, r.rot, t.sn[0], t.cs[0]);
  pair_math<bf16>(x1, y1, r.add, ex.y, ey.y, r.rot, t.sn[1], t.cs[1]);
  *reinterpret_cast<__nv_bfloat162*>(r.out + jl) =
      __floats2bfloat162_rn(x0, x1);
  *reinterpret_cast<__nv_bfloat162*>(r.out + jl + half) =
      __floats2bfloat162_rn(y0, y1);
}

// 16-pair column blocks a head (the mma and f32 arms' grid)
__host__ __device__ __forceinline__ int pair_blocks(int dh) {
  return ((dh + 1) / 2 + 15) / 16;
}

// The head and the first-half column of the 16 pairs of column block cb.
__device__ __forceinline__ void block_columns(const Args& a, int cb,
                                              int& head, int& c0) {
  const int chunks = pair_blocks(a.dh);
  head = cb / chunks;
  c0 = (cb % chunks) * 16;
}

// Local weight row lr (0..31) of a column block: the 16 first-half
// columns, then their 16 partners; -1 where the column does not exist (a
// pair past the head's last, or the missing partner of an odd dh).
__device__ __forceinline__ int weight_row(const Args& a, int head, int c0,
                                          int lr) {
  const int half = pair_half(a), p = c0 + (lr < 16 ? lr : lr - 16);
  const int col = lr < 16 ? p : half + p;
  return p < half && col < a.dh ? head * a.dh + col : -1;
}

// Rows [r0, r0 + ROWS) x depth [k0, k0 + COLS) of a row-major bf16 matrix
// with d columns into a shared tile of leading dimension ld, zero where the
// row does not exist (row(r) < 0) or the depth is past d: 16-byte cp.async
// copies where the rows start on 16 bytes, else element by element.
template <int ROWS, int COLS, typename RowOf>
__device__ __forceinline__ void load_bf16_tile(bf16* sm, int ld,
                                               const bf16* g, int d, int k0,
                                               RowOf row) {
  if ((d & 7) == 0) {
    for (int c = threadIdx.x; c < ROWS * (COLS / 8); c += kThreads) {
      const int r = c / (COLS / 8), col = (c % (COLS / 8)) * 8;
      const int gr = row(r);
      const bool ok = gr >= 0 && k0 + col < d;
      tpd_flash::cp_async16(sm + r * ld + col,
                            g + (ok ? (size_t)gr * d + k0 + col : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, col = i % COLS;
      const int gr = row(r);
      sm[r * ld + col] = gr >= 0 && k0 + col < d
                             ? g[(size_t)gr * d + k0 + col]
                             : __float2bfloat16(0.f);
    }
  }
}

// ------------------------------------------------------------- mma arm

// kWhole: every column block holds 16 whole pairs and the depth whole
// 64-deep tiles (dh % 32 == 0, d % 64 == 0), so no row or column of a tile
// is ever missing: the copies run unchecked
template <bool kWhole>
__global__ void __launch_bounds__(kThreads)
    rope_qkv_bf16(Args a) {
  __shared__ __align__(16) bf16 hs[kStages][kRows * kLd];
  __shared__ __align__(16) bf16 ws[kStages][kCols * kLd];
  int head, c0;
  block_columns(a, blockIdx.x, head, c0);
  const int M = a.S * a.T, m0 = blockIdx.y * kRows;
  const bf16* h = static_cast<const bf16*>(a.h);
  const bf16* wt = static_cast<const bf16*>(a.wt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = (a.d + kDepth - 1) / kDepth;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kDepth;
    if constexpr (kWhole) {
      for (int c = threadIdx.x; c < kRows * (kDepth / 8); c += kThreads) {
        const int r = c / (kDepth / 8), col = (c % (kDepth / 8)) * 8;
        const bool ok = m0 + r < M;
        tpd_flash::cp_async16(&hs[stage][r * kLd + col],
                              h + (size_t)(ok ? m0 + r : 0) * a.d + k0 + col,
                              ok);
      }
      for (int c = threadIdx.x; c < kCols * (kDepth / 8); c += kThreads) {
        const int r = c / (kDepth / 8), col = (c % (kDepth / 8)) * 8;
        const int wrow = head * a.dh + (r < 16 ? c0 + r : a.dh / 2 + c0 + r
                                                              - 16);
        tpd_flash::cp_async16(&ws[stage][r * kLd + col],
                              wt + (size_t)wrow * a.d + k0 + col, true);
      }
    } else {
      load_bf16_tile<kRows, kDepth>(hs[stage], kLd, h, a.d, k0, [&](int r) {
        return m0 + r < M ? m0 + r : -1;
      });
      load_bf16_tile<kCols, kDepth>(ws[stage], kLd, wt, a.d, k0, [&](int r) {
        return weight_row(a, head, c0, r);
      });
    }
  };

  float acc[4][4] = {};
  const bool live = m0 + warp * 16 < M;  // warp-uniform
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    tpd_flash::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tpd_flash::cp_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt);
    tpd_flash::cp_commit();
    const int st = kt % kStages;
    if (live) {
      uint32_t af[kDepth / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        tpd_flash::load_a(af[kk], hs[st], kLd, warp * 16, kk * 16, lane);
      tpd_flash::mma_abt<4, kDepth / 16>(acc, af, ws[st], kLd, lane);
    }
  }
  tpd_flash::cp_wait<0>();
  if (!live) return;
  // C fragment: n-tile n holds columns n·8 + 2·(lane%4) + {0, 1} of rows
  // lane/4 and lane/4 + 8; n-tiles 0-1 are the first halves of the pairs,
  // 2-3 their partners
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + warp * 16 + g + (i >= 2 ? 8 : 0);
    if (m >= M) continue;
    const HeadRow<bf16> r = head_row<bf16>(a, m, head);
#pragma unroll
    for (int n = 0; n < 2; ++n)
      finish_pair<bf16>(a, r, c0 + n * 8 + tq * 2 + (i & 1), acc[n][i],
                        acc[n + 2][i]);
  }
}

// ------------------------------------------------------------- f32 arm

__global__ void __launch_bounds__(kThreads)
    rope_qkv_f32(Args a) {
  __shared__ float hs[kRows][kDepthF + 1];
  __shared__ float ws[kCols][kDepthF + 1];
  int head, c0;
  block_columns(a, blockIdx.x, head, c0);
  const int M = a.S * a.T, m0 = blockIdx.y * kRows;
  const float* h = static_cast<const float*>(a.h);
  const float* wt = static_cast<const float*>(a.wt);
  // thread: pair p (columns p and p + 16 of the CTA), rows rg + 8i
  const int p = threadIdx.x % 16, rg = threadIdx.x / 16;
  float lo[8] = {}, hi[8] = {};
  for (int k0 = 0; k0 < a.d; k0 += kDepthF) {
    for (int i = threadIdx.x; i < kRows * kDepthF; i += kThreads) {
      const int r = i / kDepthF, c = i % kDepthF;
      hs[r][c] = m0 + r < M && k0 + c < a.d
                     ? h[(size_t)(m0 + r) * a.d + k0 + c]
                     : 0.f;
    }
    for (int i = threadIdx.x; i < kCols * kDepthF; i += kThreads) {
      const int r = i / kDepthF, c = i % kDepthF;
      const int wr = weight_row(a, head, c0, r);
      ws[r][c] = wr >= 0 && k0 + c < a.d ? wt[(size_t)wr * a.d + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kDepthF; ++k) {
      const float w1 = ws[p][k], w2 = ws[p + 16][k];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = hs[rg + 8 * i][k];
        lo[i] = fmaf(x, w1, lo[i]);
        hi[i] = fmaf(x, w2, hi[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + rg + 8 * i;
    if (m < M)
      finish_pair<float>(a, head_row<float>(a, m, head), c0 + p, lo[i],
                         hi[i]);
  }
}

// ----------------------------------------------------------- split arm

// A split cluster owns kSplitCols output columns (kSplitCols / 2 rotation
// pairs of one head); each of its ranks finishes kSplitPairs of them, as
// kSplitCpl couples of neighbouring pairs a row.
constexpr int kSplitCols = 64;
constexpr int kSplitPairs = kSplitCols / 2 / kSplitKS;
constexpr int kSplitCpl = kSplitPairs / 2;
constexpr int kSplitNT = kSplitCols / 8;  // n-tiles of the column block

// The cluster barrier in two halves: arrive (relaxed: it orders nothing)
// and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address of shared-memory location `p` in cluster CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(hw::smem_u32(p)), "r"(rank));
  return r;
}

// `bytes` of this CTA's shared memory at `src` into cluster shared memory
// at `dst`, completing on the cluster mbarrier `bar` (cp.async.bulk: the
// copy engine moves it, the receiver waits on its own barrier).
__device__ __forceinline__ void bulk_to_cluster(uint32_t dst, const void* src,
                                                uint32_t bytes,
                                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(hw::smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The slice geometry of the split arm: 16-deep steps a slice, the padded
// row of a shared tile (elements) and the rows padded to a 16-row m-tile.
__host__ __device__ __forceinline__ int split_steps(int d) {
  return (d / 16 + kSplitKS - 1) / kSplitKS;
}
__host__ __device__ __forceinline__ int split_ld(int d) {
  return split_steps(d) * 16 + 8;
}
__host__ __device__ __forceinline__ int pad16(int m) {
  return (m + 15) & ~15;
}
// dynamic shared memory of a split CTA: the weight slice [kSplitCols][ld]
// and the h rows [mp][ld] (bf16); the partials it sends and those it
// receives, each [kSplitKS][mp][kSplitCpl] float4 (by owner, by sender);
// its receive barrier
__host__ __device__ __forceinline__ size_t split_smem(int M, int d) {
  return (size_t)(kSplitCols + pad16(M)) * split_ld(d) * sizeof(bf16) +
         2 * (size_t)kSplitKS * pad16(M) * kSplitCpl * sizeof(float4) +
         sizeof(uint64_t);
}

// grid (kSplitKS, column blocks), clusters of (kSplitKS, 1, 1): the
// cluster's column block is blockIdx.y, the CTA's rank its depth slice
__global__ void __launch_bounds__(kThreads)
    rope_qkv_split(Args a) {
  constexpr int NTW = kSplitNT / 4;  // n-tiles a warp: w, w + 4, ...
  static_assert(kSplitNT % 4 == 0 && kSplitPairs % 2 == 0 &&
                    kSplitRows * kSplitCpl <= kThreads,
                "four warps share the n-tiles; a thread finishes one "
                "couple of pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int M = a.S * a.T, mp = pad16(M), ld = split_ld(a.d);
  const int per = split_steps(a.d);
  const int kb = min(a.d / 16, rank * per);
  const int ns = min(a.d / 16, kb + per) - kb;  // this slice's steps
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* hs = ws + kSplitCols * ld;
  float4* part = reinterpret_cast<float4*>(hs + mp * ld);  // by owner
  float4* recv = part + kSplitKS * mp * kSplitCpl;         // by sender
  uint64_t* bar = reinterpret_cast<uint64_t*>(recv + kSplitKS * mp * kSplitCpl);
  const int chunks = a.dh / kSplitCols;  // column blocks a head
  const int head = blockIdx.y / chunks;
  const int c0 = (blockIdx.y % chunks) * (kSplitCols / 2);
  const int half = a.dh / 2;
  const bf16* h = static_cast<const bf16*>(a.h);
  const bf16* wt = static_cast<const bf16*>(a.wt);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t slot_bytes = M * kSplitCpl * sizeof(float4);
  // the receive barrier expects every rank's partials before any rank may
  // send (the cluster barrier whose relaxed arrive follows, and whose wait
  // comes before the sends, also keeps a CTA from writing into one that
  // has not started)
  if (tid == 0) {
    hw::mbar_init(bar, 1);
    hw::mbar_fence_init();
    hw::mbar_expect(bar, kSplitKS * slot_bytes);
  }
  cluster_arrive_relaxed();

  // the slice: the block's weight rows (first halves, then partners) and
  // the h rows, one wave
  const int kw = ns * 2;  // 16-byte chunks a row
  const int k0 = kb * 16;
  for (int c = tid; c < kSplitCols * kw; c += kThreads) {
    const int r = c / kw, col = (c % kw) * 8;
    const int wrow = head * a.dh + c0 +
                     (r < kSplitCols / 2 ? r : half + r - kSplitCols / 2);
    tpd_flash::cp_async16(ws + r * ld + col,
                          wt + (size_t)wrow * a.d + k0 + col, true);
  }
  for (int c = tid; c < mp * kw; c += kThreads) {
    const int r = c / kw, col = (c % kw) * 8;
    const bool ok = r < M;
    tpd_flash::cp_async16(hs + r * ld + col,
                          h + (size_t)(ok ? r : 0) * a.d + k0 + col, ok);
  }
  tpd_flash::cp_commit();

  // while they fly: thread tid finishes couple cpl (pairs jl, jl + 1) of
  // this rank's pairs of row mrow; its delta, mask, offset and angles come
  // now
  const int mrow = tid / kSplitCpl, cpl = tid % kSplitCpl;
  const int jl = c0 + rank * kSplitPairs + 2 * cpl;
  HeadRow<bf16> row{};
  PairDelta del{};
  PairTurn turn{};
  if (mrow < M) {
    row = head_row<bf16>(a, mrow, head);
    del = pair_delta(row, jl, half);
    turn = pair_turn(row, row.rot ? a.freqs[jl] : 0.f,
                     row.rot ? a.freqs[jl + 1] : 0.f);
  }

  tpd_flash::cp_wait<0>();
  __syncthreads();
  // warp w: n-tiles w, w + 4, ... (8 local weight rows each) over the
  // slice, every live m-tile
  const int mt_n = mp / 16;
  float acc[NTW][kSplitRows / 16][4] = {};
  for (int kk = 0; kk < ns; ++kk) {
    uint32_t b[NTW][2];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const bf16* p = ws + ((warp + 4 * j) * 8 + g) * ld + kk * 16 + tq * 2;
      b[j][0] = tpd_flash::lds32(p);
      b[j][1] = tpd_flash::lds32(p + 8);
    }
#pragma unroll
    for (int mt = 0; mt < kSplitRows / 16; ++mt) {
      if (mt >= mt_n) break;
      uint32_t af[4];
      tpd_flash::load_a(af, hs, ld, mt * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        tpd_flash::mma_bf16(acc[j][mt], af, b[j][0], b[j][1]);
    }
  }
  // n-tile n's columns 8n + 2tq + {0, 1} are pairs pp, pp + 1 (first
  // halves for n < NT/2, partners after): into the send slot of their
  // owner pp / kSplitPairs, as the x (first halves) or y (partners) half
  // of the couple's float4 a row
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int n = warp + 4 * j;
    const bool first = n < kSplitNT / 2;
    const int pp = (first ? n : n - kSplitNT / 2) * 8 + 2 * tq;
    float2* mine = reinterpret_cast<float2*>(
                       part + (size_t)(pp / kSplitPairs) * mp * kSplitCpl +
                       (pp % kSplitPairs) / 2) +
                   (first ? 0 : 1);
#pragma unroll
    for (int mt = 0; mt < kSplitRows / 16; ++mt) {
      if (mt >= mt_n) break;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mt * 16 + g + 8 * hr;
        if (r < M)
          mine[2 * r * kSplitCpl] =
              make_float2(acc[j][mt][2 * hr], acc[j][mt][2 * hr + 1]);
      }
    }
  }
  // the copy engine reads what the threads wrote: order their writes before
  // it, then one thread sends slot o to rank o (into its slot `rank`)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  cluster_wait();
  if (tid == 0) {
    for (int o = 0; o < kSplitKS; ++o)
      bulk_to_cluster(cluster_addr(recv + (size_t)rank * mp * kSplitCpl, o),
                      part + (size_t)o * mp * kSplitCpl, slot_bytes,
                      cluster_addr(bar, o));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  hw::mbar_wait(bar, 0);  // every rank's partials have arrived
  if (mrow < M) {
    const float4* rv = recv + (size_t)mrow * kSplitCpl + cpl;
    float4 s = rv[0];
    for (int k = 1; k < kSplitKS; ++k) {  // in rank order
      const float4 x = rv[(size_t)k * mp * kSplitCpl];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    finish_two(row, jl, half, del, turn, s.x, s.y, s.z, s.w);
  }
  // the sends must have read this CTA's slots before it leaves
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ----------------------------------------------------------- wgmma arm

// G warpgroups a CTA (head dim 64·G), each 32 of the head's pairs: its
// 64-row B tile is the pairs' first-half weight rows, then their partners
template <int G>
__host__ __device__ constexpr size_t wg_stage_elems() {
  return (size_t)(kWgRows + 64 * G) * 64;  // the h tile, then the weight's
}
template <int G>
__host__ __device__ constexpr size_t wg_smem() {
  return 1024 + kWgStages * wg_stage_elems<G>() * sizeof(bf16) +
         kWgStages * sizeof(uint64_t);
}

// grid (nh + 2·n_kv heads, row tiles of kWgRows)
template <int G>
__global__ void __launch_bounds__(128 * G, 1)
    rope_qkv_wgmma(const __grid_constant__ CUtensorMap tmH,
                   const __grid_constant__ CUtensorMap tmW, Args a) {
  constexpr int D = 64 * G, NB = 8;  // accumulator blocks a warpgroup
  constexpr uint32_t kStageBytes = wg_stage_elems<G>() * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(hw::align1024(smem_raw));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kWgStages * wg_stage_elems<G>());
  const int head = blockIdx.x, m0 = blockIdx.y * kWgRows;
  const int nk = a.d / 64, tid = threadIdx.x;

  auto issue = [&](int kt) {  // tile kt into its stage; one thread
    const int st = kt % kWgStages;
    bf16* hs = ring + st * wg_stage_elems<G>();
    bf16* ws = hs + kWgRows * 64;
    hw::mbar_expect(full + st, kStageBytes);
    hw::tma_load_3d(hs, &tmH, full + st, kt * 64, m0, 0);
#pragma unroll
    for (int w = 0; w < G; ++w) {  // 32-row boxes
      hw::tma_load_3d(ws + w * 64 * 64, &tmW, full + st, kt * 64,
                      head * D + 32 * w, 0);
      hw::tma_load_3d(ws + w * 64 * 64 + 32 * 64, &tmW, full + st, kt * 64,
                      head * D + D / 2 + 32 * w, 0);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kWgStages; ++i) hw::mbar_init(full + i, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < min(nk, kWgStages); ++kt) issue(kt);

  // the warpgroup, warp-uniform to the compiler (a shuffle of lane 0's)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // accumulator block i holds columns 8i + 2tq + {0, 1} of the warpgroup's
  // B tile for rows 16w + g and 16w + g + 8: blocks 0-3 are its pairs'
  // first halves (head columns 32·wg + 8i + 2tq), blocks 4-7 the partners.
  // The rows' masks and offsets and the frequencies are read now, while
  // the first tiles fly; the deltas (a third of the bytes the kernel reads)
  // after the products, all of a thread's at once, so they do not delay
  // the first tiles.
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int M = a.S * a.T, half = D / 2;
  const bool rot = a.rope && head < a.nh + a.n_kv;
  HeadRow<bf16> rows[2];
  PairDelta del[2][NB / 2];
  float fr[NB / 2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + warp * 16 + g + 8 * r;
    rows[r] = head_row<bf16>(a, min(m, M - 1), head);
    if (m >= M) rows[r].out = nullptr;  // past the rows: no output
  }
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) {
    const int jl = 32 * wg + 8 * i + 2 * tq;
    fr[i][0] = rot ? a.freqs[jl] : 0.f;
    fr[i][1] = rot ? a.freqs[jl + 1] : 0.f;
  }
  float acc[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kWgStages;
    const bf16* hs = ring + st * wg_stage_elems<G>();
    const bf16* ws = hs + kWgRows * 64 + wg * 64 * 64;
    hw::mbar_wait(full + st, (kt / kWgStages) & 1);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hw::wgmma_ss_n64(acc, hw::desc_k<kWgRows>(hs, kk),
                       hw::desc_k<64>(ws, kk), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<1>();  // tile kt - 1's product is done
    if (kt >= 1 && kt - 1 + kWgStages < nk) {
      __syncthreads();  // ... in every warp: its stage is free
      if (tid == 0) issue(kt - 1 + kWgStages);
    }
  }
  hw::wgmma_wait<0>();
  hw::fence_acc(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < NB / 2; ++i)
      del[r][i] = pair_delta(rows[r], 32 * wg + 8 * i + 2 * tq, half);
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) {
    const int jl = 32 * wg + 8 * i + 2 * tq;
    const int ip = i + NB / 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r].out == nullptr) continue;
      finish_two(rows[r], jl, half, del[r][i],
                 pair_turn(rows[r], fr[i][0], fr[i][1]), acc[i][2 * r],
                 acc[i][2 * r + 1], acc[ip][2 * r], acc[ip][2 * r + 1]);
    }
  }
}

// The TMA maps of h [M, d] (boxes of 64 rows x 64 depth, rows past the end
// zero-filled) and the weight [dtot, d] (boxes of 32 rows).  The encoder needs the device's
// context current on this thread: setting the current device again binds
// it.
bool rope_maps(CUtensorMap* m, const void* h, const void* wt, int M,
               int dtot, int d) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return false;
  return hw::tile_map(m, h, 1, M, d) &&
         hw::tile_map(m + 1, wt, 1, dtot, d, 32);
}

// The split arm's launch configuration: grid (kSplitKS, column blocks),
// clusters of kSplitKS CTAs along x.
struct SplitLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  SplitLaunch(int blocks, size_t smem, cudaStream_t st) {
    cfg.gridDim = dim3(kSplitKS, blocks, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kSplitKS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

int split_prepare(int M, int d, size_t& smem) {
  if (M > kSplitRows || d > kSplitMaxDepth || d % 16)
    return (int)cudaErrorInvalidValue;
  smem = split_smem(M, d);
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        rope_qkv_split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
  return 0;
}

__global__ void empty_kernel() {}

}  // namespace

// dtype: 0 f32, 1 bf16 (tpd_flash::DType); arm: enum Arm (the wrapper's
// _rope_arm picks it and checks the shapes: split S·T <= kSplitRows, d <=
// kSplitMaxDepth and a multiple of 16, dh a multiple of kSplitCols; wgmma
// dh 64 or 128 and d a multiple of 64; mma and f32 any dh and d).
extern "C" int tpd_fused_rope_qkv(const void* h, const void* wt,
                                  const void* offsets, const void* extra,
                                  const void* on, const void* freqs,
                                  void* q, void* k, void* v,
                                  int S, int T, int d, int nh, int n_kv,
                                  int dh, int on_is_bool, int rope,
                                  float base, int dtype, int arm,
                                  void* stream) {
  Args a;
  a.h = h;
  a.wt = wt;
  a.offsets = static_cast<const int*>(offsets);
  a.extra = extra;
  a.on = on;
  a.freqs = static_cast<const float*>(freqs);
  a.q = q;
  a.k = k;
  a.v = v;
  a.S = S;
  a.T = T;
  a.d = d;
  a.nh = nh;
  a.n_kv = n_kv;
  a.dh = dh;
  a.on_is_bool = on_is_bool;
  a.rope = rope;
  a.base = base;
  const int M = S * T, heads = nh + 2 * n_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((arm == kArmF32) != (dtype == tpd_flash::kF32))
    return (int)cudaErrorInvalidValue;
  if (arm == kArmSplit) {
    size_t smem = 0;
    const int e = split_prepare(M, d, smem);
    if (e != 0) return e;
    if (dh % kSplitCols || freqs == nullptr)
      return (int)cudaErrorInvalidValue;
    SplitLaunch l(heads * (dh / kSplitCols), smem, st);
    const cudaError_t le = cudaLaunchKernelEx(&l.cfg, rope_qkv_split, a);
    if (le != cudaSuccess) return (int)le;
    return (int)cudaGetLastError();
  }
  if (arm == kArmWgmma) {
    CUtensorMap m[2];
    if ((dh != 64 && dh != 128) || d % 64 || freqs == nullptr ||
        !rope_maps(m, h, wt, M, heads * dh, d))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(heads, (M + kWgRows - 1) / kWgRows);
#define TPD_ROPE_WGMMA(G)                                                   \
  {                                                                         \
    auto kern = rope_qkv_wgmma<G>;                                          \
    const cudaError_t e = cudaFuncSetAttribute(                             \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,                  \
        (int)wg_smem<G>());                                                 \
    if (e != cudaSuccess) return (int)e;                                    \
    kern<<<grid, 128 * G, wg_smem<G>(), st>>>(m[0], m[1], a);               \
    return (int)cudaGetLastError();                                         \
  }
    if (dh == 64) TPD_ROPE_WGMMA(1)
    TPD_ROPE_WGMMA(2)
#undef TPD_ROPE_WGMMA
  }
  dim3 grid(heads * pair_blocks(dh), (M + kRows - 1) / kRows);
  if (arm == kArmMma && dh % 32 == 0 && d % kDepth == 0)
    rope_qkv_bf16<true><<<grid, kThreads, 0, st>>>(a);
  else if (arm == kArmMma)
    rope_qkv_bf16<false><<<grid, kThreads, 0, st>>>(a);
  else if (arm == kArmF32)
    rope_qkv_f32<<<grid, kThreads, 0, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// How many clusters of the split arm (M rows, depth d, dtot output
// columns) the card holds at once, into *count
// (cudaOccupancyMaxActiveClusters).
extern "C" int tpd_rope_max_clusters(int M, int d, int dtot, int* count) {
  size_t smem = 0;
  const int e = split_prepare(M, d, smem);
  if (e != 0) return e;
  SplitLaunch l(dtot / kSplitCols, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(
      count, (const void*)rope_qkv_split, &l.cfg);
}

// An empty kernel of `ctas` CTAs of kThreads threads, in clusters of
// kSplitKS when `cluster` (ctas then a multiple of kSplitKS): the timer's
// floor for a launch of that grid.
extern "C" int tpd_rope_empty(int ctas, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cluster) {
    empty_kernel<<<ctas, kThreads, 0, st>>>();
    return (int)cudaGetLastError();
  }
  SplitLaunch l(ctas / kSplitKS, 0, st);
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, empty_kernel);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
