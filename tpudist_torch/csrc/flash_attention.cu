// FlashAttention-2 forward for Hopper (sm_90a): out and the row logsumexp.
//
// Replaces the Pallas TPU kernel tpudist/ops/flash_attention.py
// (_flash_forward, body _flash_kernel).  q [b, h, Sq, D], k/v [b, h_kv, Sk,
// D] (GQA: q head h reads kv head h / (h / h_kv), never a repeated copy),
// out [b, h, Sq, D] in the input dtype or f32, lse [b, h, Sq] f32 in the
// scaled-score domain.  Masks: the band lo <= q - k < hi (flash_common.cuh)
// and the ragged key tail k >= Sk; any Sq and Sk.
//
// Schedule, every arm.  The TPU kernel walks a sequential (bh, q tile, kv
// tile) grid and carries (m, l, acc) in VMEM across the KV axis.  Here one
// CTA owns one (b·h, Q tile) and a loop inside it walks only the band's
// live KV tiles (first..last from kv_tiles); tiles wholly inside the band
// skip the mask.  b·h varies fastest and the last Q tiles (the longest
// causal walks) come first.  The running max, sum and accumulator are f32
// in registers (online softmax).
//
// Numerics follow the Pallas kernel's cast points: s = (q·kᵀ) in f32 from
// input-dtype operands, times dh^-0.5, masked to -1e30; p = exp(s - m) in
// f32, summed unrounded into l, rounded to v's dtype for P·V; out = acc / l;
// lse = m + log l; a row without a live key gives out 0 and lse -1e30.
//
// Arms (ops/flash_attention.py _fwd_arm picks one; the caller may force the
// mma.sync arm for bf16 to time it):
//
// - wgmma, bf16 at head dims 64 and 128 (the training path).  A CTA of 128
//   query rows is a producer warpgroup, which hands most of its registers
//   to the others (setmaxnreg) and issues every TMA copy from one thread
//   (hopper_mma.cuh), and two consumer warpgroups of 64 rows sharing every
//   K/V tile.  Q comes once; K and V come in 128-key tiles into a ring of
//   stages, each with a "full" mbarrier for K and one for V and an "empty"
//   one for each that the consumers release (K after its Q·Kᵀ, V after its
//   P·V).  S = Q·Kᵀ is wgmma m64n128k16 with both operands K-major in
//   128-byte-swizzled shared memory; O += bf(P)·V is m64n{D}k16 with P
//   repacked from the score accumulators into A registers and V read
//   MN-major.  Overlap: within a warpgroup, step t issues tile t's Q·Kᵀ and
//   tile t - 1's P·V together and runs tile t's softmax while the P·V is in
//   flight; across warpgroups, named barriers make the two take turns
//   issuing, so one's softmax runs under the other's products.  Both walk
//   all the CTA's tiles (a causal CTA's first warpgroup masks much of its
//   last tile), which keeps the turns in step.
// - mma.sync, bf16 at every other head dim up to 256: 4 warps of 16 query
//   rows (a 64-row Q tile) on mma.sync m16n8k16, K/V tiles of 64 keys
//   through cp.async.  The tiles are compiled for the padded widths of
//   flash_common.cuh (pad_head_dim), zero past a narrower head dim taken
//   at run time, and at 16, 32, 64 and 128 once more with the head dim
//   fixed at the width (kExact); past 128 the Q fragments load from shared
//   memory per step rather than stay in registers, and one CTA holds an
//   SM's registers.
// - f32 (the JAX package's fp32 path) on CUDA-core FMAs in full f32, never
//   TF32, at any head dim up to 256 (each thread owns the output elements
//   tid, tid + 128, ... of the CTA's 16 rows; the head dim compiled in at
//   16, 32, 64 and 128, taken at run time elsewhere).
//
// Bound on the H100: operations.  At the training shapes (s 2048, dh 128)
// the band's 4·pairs·D flops exceed the q/k/v/out bytes over the memory
// rate by two orders of magnitude.  The wgmma arm reaches about a third of
// the bf16 peak there; PERF.md has the readings and what holds it.
#include "flash_common.cuh"
#include "hopper_mma.cuh"
#include "tma_host.cuh"

namespace tpd_flash {
namespace {

// mma.sync: 4 warps of 16 query rows share each 64-key K/V tile, with one
// K/V buffer and at most 170 registers a thread, so three CTAs fit an SM (12
// warps) and hide each other's loads instead of double buffering.  DP is
// the padded head dim (pad_head_dim), d <= DP the real one.
constexpr int kBQ = 64, kBK = 64, kFwdMinCtas = 3;
constexpr int kSQ = 16, kSK = 32;  // f32 tiles

template <int DP, bool kOutF32, bool kExact>
__global__ void __launch_bounds__(kThreads, DP > 128 ? 1 : kFwdMinCtas)
    fwd_bf16(const bf16* __restrict__ Q, const bf16* __restrict__ K,
             const bf16* __restrict__ V, void* __restrict__ Out,
             float* __restrict__ Lse, int H, int Hkv, int Sq, int Sk,
             int d_arg, int lo, int hi, float scale) {
  const int d = kExact ? DP : d_arg;  // kExact: no padded column
  static_assert(DP % 16 == 0, "bf16 tiles take head dims in steps of 16");
  constexpr int LD = DP + 8, DN = DP / 8, KD = DP / 16, NT = kBK / 8;
  constexpr bool kQRegs = DP <= 128;  // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                   // [kBK][LD]
  bf16* Vs = Ks + kBK * LD;                   // [kBK][LD]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = b * Hkv + h / (H / Hkv);
  const bf16* q = Q + (size_t)bh * Sq * d;
  const bf16* k = K + (size_t)hk * Sk * d;
  const bf16* v = V + (size_t)hk * Sk * d;
  // b·h varies fastest and the last Q tiles come first: under a causal
  // band they walk the most KV tiles, so every head's long CTAs start early
  // and the short ones fill the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  int first, last;
  kv_tiles(q0, min(q0 + kBQ, Sq) - 1, lo, hi, Sk, kBK, first, last);

  load_tile_async<kBQ, DP>(Qs, q, q0, Sq, d);
  if (first <= last) {
    load_tile_async<kBK, DP>(Ks, k, first * kBK, Sk, d);
    load_tile_async<kBK, DP>(Vs, v, first * kBK, Sk, d);
  }
  cp_commit();

  float o[DN][4] = {};
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  uint32_t qa[kQRegs ? KD : 1][4];
  for (int j = first; j <= last; ++j) {
    if (j > first) {  // every warp left the previous tile at the barrier
      load_tile_async<kBK, DP>(Ks, k, j * kBK, Sk, d);
      load_tile_async<kBK, DP>(Vs, v, j * kBK, Sk, d);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();

    float s[NT][4] = {};
    if constexpr (kQRegs) {
      if (j == first)
        for (int kk = 0; kk < KD; ++kk)
          load_a(qa[kk], Qs, LD, warp * 16, kk * 16, lane);
      mma_abt<NT, KD>(s, qa, Ks, LD, lane);
    } else {
      mma_abt_smem<NT, KD>(s, Qs, LD, warp * 16, Ks, LD, lane);
    }
    const int k0 = j * kBK;
    const bool interior = tile_interior(q0, kBQ, k0, kBK, lo, hi, Sk);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        if (!interior) {
          const int qp = q0 + warp * 16 + g + (e >> 1) * 8;
          const int kp = k0 + n * 8 + tq * 2 + (e & 1);
          if (!(kp < Sk && in_band(qp, kp, lo, hi))) s[n][e] = kMask;
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp_row(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * r] = exp_row(s[n][2 * r], mx);
        s[n][2 * r + 1] = exp_row(s[n][2 * r + 1], mx);
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * corr + sum;
      m[r] = mx;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        o[dn][2 * r] *= corr;
        o[dn][2 * r + 1] *= corr;
      }
    }
    mma_pt<DN, kBK / 16>(o, s, Vs, LD, lane);
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    // dead row (no live key): out 0, lse -1e30, the "no contribution"
    // partial of a logsumexp merge
    const bool dead = m[r] <= kMask * 0.5f;
    const size_t base = ((size_t)bh * Sq + row) * d;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const float a = dead ? 0.f : o[dn][2 * r] / l[r];
      const float c = dead ? 0.f : o[dn][2 * r + 1] / l[r];
      if (kOutF32)
        store_pair(static_cast<float*>(Out) + base, dn * 8 + tq * 2, d, a, c);
      else
        store_pair(static_cast<bf16*>(Out) + base, dn * 8 + tq * 2, d, a, c);
    }
    if (tq == 0) Lse[(size_t)bh * Sq + row] = dead ? kMask : m[r] + logf(l[r]);
  }
}

// ----------------------------------------------------------- wgmma, bf16

namespace hw = tpd_hopper;
constexpr int kWgRows = hw::kTileRows;  // query rows a consumer warpgroup
constexpr int kConsumers = 2;           // consumer warpgroups a CTA
constexpr int kWgCtaRows = kConsumers * kWgRows;
constexpr int kWgKeys = 128;            // keys a K/V tile
constexpr int kWgThreads = (kConsumers + 1) * 128;  // + the producer
// registers a thread: the producer warpgroup hands most of its share to
// the consumers (24 + 2 x 240 of the 3 x 168 a sub-partition holds)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// K/V ring stages: as many as shared memory holds beside the Q tiles
template <int D>
__host__ __device__ constexpr int wg_stages() {
  return D == 128 ? 3 : 4;
}

// One warpgroup's online-softmax step over its 64 x 128 score tile s (keys
// k0..): scale, mask unless the tile is interior, the row max over the
// quad, p = exp(s - max) in place; returns the correction of the old
// running max through corr and the rows' sums of p through sum.
__device__ __forceinline__ void softmax_tile(float (&s)[16][4], float (&m)[2],
                                             float (&corr)[2],
                                             float (&sum)[2], int q0, int k0,
                                             bool interior, int lo, int hi,
                                             int Sk, float scale, int g,
                                             int tq) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] *= scale;
      if (!interior) {
        const int qp = q0 + g + (e >> 1) * 8;
        const int kp = k0 + n * 8 + tq * 2 + (e & 1);
        if (!(kp < Sk && in_band(qp, kp, lo, hi))) s[n][e] = kMask;
      }
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int n = 0; n < 16; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[r] = exp_row(m[r], mx);
    float t = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      s[n][2 * r] = exp_row(s[n][2 * r], mx);
      s[n][2 * r + 1] = exp_row(s[n][2 * r + 1], mx);
      t += s[n][2 * r] + s[n][2 * r + 1];
    }
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    sum[r] = t;
    m[r] = mx;
  }
}

template <int D, bool kOutF32>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wgmma(const __grid_constant__ CUtensorMap tmQ,
              const __grid_constant__ CUtensorMap tmK,
              const __grid_constant__ CUtensorMap tmV, void* __restrict__ Out,
              float* __restrict__ Lse, int H, int Hkv, int Sq, int Sk, int lo,
              int hi, float scale) {
  static_assert(D == 64 || D == 128, "wgmma tiles take head dims 64 and 128");
  constexpr int T = kWgRows * D, TK = kWgKeys * D, DN = D / 8;
  constexpr int kWgStages = wg_stages<D>();
  constexpr uint32_t kTileBytes = T * sizeof(bf16);
  constexpr uint32_t kKeyBytes = TK * sizeof(bf16);
  constexpr int kBoth = kConsumers * 128;  // threads of the turn barriers
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(hw::align1024(smem_raw));  // [2][64][D]
  bf16* Ks = Qs + kConsumers * T;     // [stages][128][D]
  bf16* Vs = Ks + kWgStages * TK;     // [stages][128][D]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kWgStages * TK);
  uint64_t* k_full = q_full + 1;      // [stages] each
  uint64_t* v_full = k_full + kWgStages;
  uint64_t* k_empty = v_full + kWgStages;
  uint64_t* v_empty = k_empty + kWgStages;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgCtaRows;
  int first, last;
  kv_tiles(q0, min(q0 + kWgCtaRows, Sq) - 1, lo, hi, Sk, kWgKeys, first,
           last);
  const int n = last - first + 1;  // <= 0: no live key

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
    for (int i = 0; i < kWgStages; ++i) {
      hw::mbar_init(k_full + i, 1);
      hw::mbar_init(v_full + i, 1);
      hw::mbar_init(k_empty + i, kBoth);  // every consumer thread releases
      hw::mbar_init(v_empty + i, kBoth);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();
  // the role, warp-uniform to the compiler (a shuffle of lane 0's): wgmma
  // issued on a path it cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {  // the producer warpgroup: one thread issues
    hw::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kBoth && n > 0) {
      hw::mbar_expect(q_full, kConsumers * kTileBytes);
      for (int w = 0; w < kConsumers; ++w)
        hw::tma_tile<D>(Qs + w * T, &tmQ, q_full, q0 + w * kWgRows, bh);
      // K of tile t waits for Q·Kᵀ of tile t - stages in both warpgroups,
      // V for its P·V (a step later)
      for (int t = 0; t < n; ++t) {
        const int st = t % kWgStages, ph = (t / kWgStages - 1) & 1;
        const int k0 = (first + t) * kWgKeys;
        if (t >= kWgStages) hw::mbar_wait(k_empty + st, ph);
        hw::mbar_expect(k_full + st, kKeyBytes);
        hw::tma_tile<D, kWgKeys>(Ks + st * TK, &tmK, k_full + st, k0, hk);
        if (t >= kWgStages) hw::mbar_wait(v_empty + st, ph);
        hw::mbar_expect(v_full + st, kKeyBytes);
        hw::tma_tile<D, kWgKeys>(Vs + st * TK, &tmV, v_full + st, k0, hk);
      }
    }
    return;
  }

  hw::setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int qw = q0 + wg * kWgRows;  // the warpgroup's first row
  const int qr = qw + warp * 16;      // the warp's first row
  const bf16* qs = Qs + wg * T;
  // turns: warpgroup w issues after a sync on barrier 1 + w, then lets the
  // other go with an arrive on its barrier; the second starts one arrive
  // ahead, and its last turn lets no one go, so every barrier balances
  const int mine = 1 + wg, other = 1 + (wg ^ 1);
  float o[DN][4] = {};
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  if (n > 0) {
    float s[16][4], corr[2], sum[2];
    uint32_t pa[8][4];
    // tile t's softmax on s (rescale, after the P·V in flight: o and l to
    // the new max, and p packed for tile t's P·V)
    auto step = [&](int t) {
      const int k0 = (first + t) * kWgKeys;
      softmax_tile(s, m, corr, sum, qr, k0,
                   tile_interior(qw, kWgRows, k0, kWgKeys, lo, hi, Sk), lo,
                   hi, Sk, scale, g, tq);
    };
    auto rescale = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          o[dn][2 * r] *= corr[r];
          o[dn][2 * r + 1] *= corr[r];
        }
      }
      hw::pack_a(pa, s);
    };
    if (wg == 1) hw::named_arrive(other, kBoth);
    hw::mbar_wait(q_full, 0);
    // step 0: tile 0's Q·Kᵀ alone
    hw::mbar_wait(k_full, 0);
    hw::named_sync(mine, kBoth);
    hw::wgmma_fence();
    hw::wgmma_abt128<D>(s, qs, Ks);
    hw::wgmma_commit();
    hw::named_arrive(other, kBoth);
    hw::wgmma_wait<0>();
    hw::fence_acc(s);
    hw::mbar_arrive(k_empty);
    step(0);
    rescale();
    // step t: tile t's Q·Kᵀ with tile t - 1's P·V, tile t's softmax under
    // the P·V
    for (int t = 1; t < n; ++t) {
      const int st = t % kWgStages, sp = (t - 1) % kWgStages;
      hw::mbar_wait(k_full + st, (t / kWgStages) & 1);
      hw::mbar_wait(v_full + sp, ((t - 1) / kWgStages) & 1);
      hw::named_sync(mine, kBoth);
      hw::wgmma_fence();
      hw::wgmma_abt128<D>(s, qs, Ks + st * TK);
      hw::wgmma_commit();
      hw::wgmma_pv<DN, 8>(o, pa, Vs + sp * TK);
      hw::wgmma_commit();
      hw::named_arrive(other, kBoth);
      hw::wgmma_wait<1>();
      hw::fence_acc(s);
      hw::mbar_arrive(k_empty + st);
      step(t);
      hw::wgmma_wait<0>();
      hw::fence_acc(o);
      hw::fence_a(pa);
      hw::mbar_arrive(v_empty + sp);
      rescale();
    }
    // step n: the last tile's P·V alone
    const int sp = (n - 1) % kWgStages;
    hw::mbar_wait(v_full + sp, ((n - 1) / kWgStages) & 1);
    hw::named_sync(mine, kBoth);
    hw::wgmma_pv<DN, 8>(o, pa, Vs + sp * TK);
    hw::wgmma_commit();
    if (wg == 0) hw::named_arrive(other, kBoth);
    hw::wgmma_wait<0>();
    hw::fence_acc(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + g + r * 8;
    if (row >= Sq) continue;
    // dead row (no live key): out 0, lse -1e30
    const bool dead = m[r] <= kMask * 0.5f;
    const size_t base = ((size_t)bh * Sq + row) * D + tq * 2;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const float a = dead ? 0.f : o[dn][2 * r] / l[r];
      const float c = dead ? 0.f : o[dn][2 * r + 1] / l[r];
      if (kOutF32) {
        *reinterpret_cast<float2*>(static_cast<float*>(Out) + base + dn * 8) =
            make_float2(a, c);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(Out) + base +
                                           dn * 8) =
            __floats2bfloat162_rn(a, c);
      }
    }
    if (tq == 0) Lse[(size_t)bh * Sq + row] = dead ? kMask : m[r] + logf(l[r]);
  }
}

// f32: 16 query rows per CTA, 32-key tiles; a warp holds one row's scores
// (a lane per key).  kD > 0 compiles the head dim in (16, 32, 64, 128):
// each thread owns one output column of kAcc consecutive rows.  kD == 0
// takes it at run time (d_arg): the [16, D] output tile's elements go to
// the threads in turn (element tid + 128·i: row e / D, column e % D), so
// any D up to kMaxHeadDim runs, at most kAcc elements a thread.  The
// run-time loops cost up to 68% at the compiled widths (PERF.md).
template <int kD>
__global__ void __launch_bounds__(kThreads)
    fwd_f32(const float* __restrict__ Q, const float* __restrict__ K,
            const float* __restrict__ V, float* __restrict__ Out,
            float* __restrict__ Lse, int H, int Hkv, int Sq, int Sk,
            int d_arg, int lo, int hi, float scale) {
  const int D = kD ? kD : d_arg;
  constexpr int kAcc = (kD ? kD : kMaxHeadDim) * kSQ / kThreads;
  const int LDK = D | 1;  // odd: a warp's 32 key rows fall in 32 banks
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kSQ][D]
  float* Ks = Qs + kSQ * D;                     // [kSK][LDK]
  float* Vs = Ks + kSK * LDK;                   // [kSK][D]
  float* Ps = Vs + kSK * D;                     // [kSQ][kSK]
  float* ms = Ps + kSQ * kSK;                   // [kSQ]
  float* ls = ms + kSQ;                         // [kSQ]
  float* cs = ls + kSQ;                         // [kSQ]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = b * Hkv + h / (H / Hkv);
  const float* q = Q + (size_t)bh * Sq * D;
  const float* k = K + (size_t)hk * Sk * D;
  const float* v = V + (size_t)hk * Sk * D;
  const int q0 = blockIdx.x * kSQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // kD > 0: this thread's column and first row
  const int cb = kD ? threadIdx.x % D : 0;
  const int rb = kD ? threadIdx.x / D * kAcc : 0;
  int first, last;
  kv_tiles(q0, min(q0 + kSQ, Sq) - 1, lo, hi, Sk, kSK, first, last);
  load_tile_f32<kSQ>(Qs, D, q, q0, Sq, D);
  if (threadIdx.x < kSQ) {
    ms[threadIdx.x] = kMask;
    ls[threadIdx.x] = 0.f;
  }
  float acc[kAcc] = {};
  for (int j = first; j <= last; ++j) {
    const int k0 = j * kSK;
    __syncthreads();
    load_tile_f32<kSK>(Ks, LDK, k, k0, Sk, D);
    load_tile_f32<kSK>(Vs, D, v, k0, Sk, D);
    __syncthreads();
    const bool interior = tile_interior(q0, kSQ, k0, kSK, lo, hi, Sk);
    for (int r = warp; r < kSQ; r += kThreads / 32) {
      float s = 0.f;
      for (int c = 0; c < D; ++c) s += Qs[r * D + c] * Ks[lane * LDK + c];
      s *= scale;
      if (!interior && !(k0 + lane < Sk && in_band(q0 + r, k0 + lane, lo, hi)))
        s = kMask;
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      Ps[r * kSK + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ms[r] = m_new;
        ls[r] = ls[r] * corr + sum;
        cs[r] = corr;
      }
    }
    __syncthreads();
    if constexpr (kD > 0) {
      for (int i = 0; i < kAcc; ++i) {
        const int r = rb + i;
        float pv = 0.f;
        for (int c = 0; c < kSK; ++c) pv += Ps[r * kSK + c] * Vs[c * D + cb];
        acc[i] = acc[i] * cs[r] + pv;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (e >= kSQ * D) break;
        const int r = e / D, col = e % D;
        float pv = 0.f;
        for (int c = 0; c < kSK; ++c) pv += Ps[r * kSK + c] * Vs[c * D + col];
        acc[i] = acc[i] * cs[r] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (!kD && e >= kSQ * D) break;
    const int r = kD ? rb + i : e / D, col = kD ? cb : e % D, row = q0 + r;
    if (row >= Sq) continue;
    const bool dead = ms[r] <= kMask * 0.5f;
    Out[((size_t)bh * Sq + row) * D + col] = dead ? 0.f : acc[i] / ls[r];
    if (col == 0)
      Lse[(size_t)bh * Sq + row] = dead ? kMask : ms[r] + logf(ls[r]);
  }
}

}  // namespace
}  // namespace tpd_flash

using namespace tpd_flash;

// the kernel arm: ops/flash_attention.py _ARMS (flash_backward.cu's enum)
enum Arm : int { kArmF32 = 0, kArmMma = 1, kArmWgmma = 2 };

// Shared memory of the wgmma arm: the two [64][D] Q tiles and the ring of
// [128][D] K and V tiles in bf16, the mbarriers and 1 KB of slack to align
// the tiles to 1024 bytes.
inline size_t wgmma_fwd_smem(int D) {
  const int stages = D == 128 ? wg_stages<128>() : wg_stages<64>();
  return ((size_t)kConsumers * kWgRows + 2 * stages * kWgKeys) * D *
             sizeof(bf16) +
         2048;
}

// q/k/v contiguous [B, H|Hkv, S, D], all three alike: bf16 for arms 1-2,
// f32 for arm 0; out_f32 selects an f32 `out` for bf16 inputs (f32 inputs
// always give f32).  D: 64 or 128 on arm 2, 1..kMaxHeadDim on arms 0-1.
extern "C" int tpd_flash_forward(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int H, int Hkv,
                                 int Sq, int Sk, int D, int lo, int hi,
                                 int arm, int out_f32, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B * H <= 0) return 0;
  if (arm == kArmWgmma) {
    CUtensorMap m[3];
    if ((D != 64 && D != 128) ||
        !hw::tile_maps(m, q, k, v, nullptr, B, H, Hkv, Sq, Sk, D))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(B * H, (Sq + kWgCtaRows - 1) / kWgCtaRows);
    const size_t smem = wgmma_fwd_smem(D);
    float* L = static_cast<float*>(lse);
#define TPD_FWD_WGMMA(DD, OF)                                                 \
  {                                                                           \
    auto kern = fwd_wgmma<DD, OF>;                                            \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);        \
    if (e != cudaSuccess) return (int)e;                                      \
    kern<<<grid, kWgThreads, smem, st>>>(m[0], m[1], m[2], out, L, H, Hkv,    \
                                         Sq, Sk, lo, hi, scale);              \
    return (int)cudaGetLastError();                                           \
  }
    if (D == 64 && out_f32) TPD_FWD_WGMMA(64, true)
    if (D == 64) TPD_FWD_WGMMA(64, false)
    if (D == 128 && out_f32) TPD_FWD_WGMMA(128, true)
    if (D == 128) TPD_FWD_WGMMA(128, false)
#undef TPD_FWD_WGMMA
    return (int)cudaErrorInvalidValue;
  }
  if (arm == kArmMma) {
    const int DP = pad_head_dim(D);
    const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
    const size_t smem = (size_t)(kBQ + 2 * kBK) * (DP + 8) * sizeof(bf16);
    const bf16* Q = static_cast<const bf16*>(q);
    const bf16* K = static_cast<const bf16*>(k);
    const bf16* V = static_cast<const bf16*>(v);
    float* L = static_cast<float*>(lse);
#define TPD_FWD_BF16(DD, OF, EX)                                              \
  {                                                                           \
    auto kern = fwd_bf16<DD, OF, EX>;                                         \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);        \
    if (e != cudaSuccess) return (int)e;                                      \
    kern<<<grid, kThreads, smem, st>>>(Q, K, V, out, L, H, Hkv, Sq, Sk, D,    \
                                       lo, hi, scale);                        \
    return (int)cudaGetLastError();                                           \
  }
// the head dim fixed at 16, 32, 64 and 128 (the widths before any padding,
// where the run-time width costs time); every padded width at run time
#define TPD_FWD_BF16_EXACT(DD)                        \
  if (D == DD && out_f32) TPD_FWD_BF16(DD, true, true) \
  if (D == DD) TPD_FWD_BF16(DD, false, true)
#define TPD_FWD_BF16_PAD(DD)                           \
  if (DP == DD && out_f32) TPD_FWD_BF16(DD, true, false) \
  if (DP == DD) TPD_FWD_BF16(DD, false, false)
    TPD_FWD_BF16_EXACT(16)
    TPD_FWD_BF16_EXACT(32)
    TPD_FWD_BF16_EXACT(64)
    TPD_FWD_BF16_EXACT(128)
    TPD_FWD_BF16_PAD(16)
    TPD_FWD_BF16_PAD(32)
    TPD_FWD_BF16_PAD(64)
    TPD_FWD_BF16_PAD(96)
    TPD_FWD_BF16_PAD(128)
    TPD_FWD_BF16_PAD(256)
#undef TPD_FWD_BF16_PAD
#undef TPD_FWD_BF16_EXACT
#undef TPD_FWD_BF16
    return (int)cudaErrorInvalidValue;
  }
  if (arm == kArmF32) {
    if (D < 1 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
    const dim3 grid((Sq + kSQ - 1) / kSQ, B * H);
    const size_t smem =
        ((size_t)kSQ * D + kSK * (D | 1) + kSK * D + kSQ * kSK + 3 * kSQ) *
        sizeof(float);
#define TPD_FWD_F32(DD)                                                       \
  if (D == DD || DD == 0) {                                                   \
    auto kern = fwd_f32<DD>;                                                  \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);        \
    if (e != cudaSuccess) return (int)e;                                      \
    kern<<<grid, kThreads, smem, st>>>(                                       \
        static_cast<const float*>(q), static_cast<const float*>(k),           \
        static_cast<const float*>(v), static_cast<float*>(out),               \
        static_cast<float*>(lse), H, Hkv, Sq, Sk, D, lo, hi, scale);          \
    return (int)cudaGetLastError();                                           \
  }
    TPD_FWD_F32(16)
    TPD_FWD_F32(32)
    TPD_FWD_F32(64)
    TPD_FWD_F32(128)
    TPD_FWD_F32(0)
#undef TPD_FWD_F32
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
