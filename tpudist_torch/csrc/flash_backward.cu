// FlashAttention-2 backward for Hopper (sm_90a): the dq pass and the dk/dv
// pass.
//
// Replaces the Pallas TPU kernels of tpudist/ops/flash_attention.py
// _flash_backward: _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel.  Inputs
// are the forward's q, k, v, the output cotangent do (in q's dtype), the
// forward's row logsumexp lse and delta = rowsum(out·dout) - dlse, both
// [b, h, Sq] f32.  Both passes rebuild the softmax tile from lse, with the
// Pallas kernels' formulas and cast points:
//
//   p  = exp(s - lse) · live           (s masked to -1e30; live = lse > -5e29)
//   dp = do · vᵀ                       (f32 from input-dtype operands)
//   ds = p · (dp - delta) · dh^-0.5
//   dq = bf(ds) · k,   dk = bf(ds)ᵀ · q,   dv = bf(p)ᵀ · do
//
// where bf() rounds to the input dtype; every product accumulates in f32.
//
// Schedule, every arm.  dq: one CTA per (b·h, 64-row Q tile), a loop over
// the live KV tiles accumulating dq in f32 registers (the TPU kernel's
// KV-innermost sweep).  dk/dv: one CTA per (b·h_kv, 64-row KV tile), a loop
// over every (group member, live Q tile) accumulating dk and dv in f32
// registers: the TPU's sequential "arbitrary" grid axis becomes a loop
// inside the CTA, so a GQA group sums into its KV head without atomics and
// the result is deterministic.  Query rows past Sq carry lse = +inf (p = 0)
// and delta 0; keys past Sk are masked in the dq pass and never stored by
// the dk/dv pass.  Under a causal band the longest CTAs start first.
//
// Arms (ops/flash_attention.py _bwd_arm picks one; the caller may force the
// mma.sync arm for bf16 to time it):
//
// - wgmma, bf16 at head dims 64 and 128 (the training path).  One
//   warpgroup (4 warps) a CTA over 64 rows, every product a Hopper
//   warpgroup MMA (hopper_mma.cuh): the score and dp tiles m64n64k16 with
//   both operands in 128-byte-swizzled shared memory, the dq / dk / dv
//   updates m64n{D}k16 with bf(ds) or bf(p) repacked from the accumulators
//   into A registers and B read through the descriptor's transpose bit (k,
//   q and do are stored row-major by key or query).  The CTA's own tiles
//   (q and do for dq; k and v for dk/dv) stay resident; the streamed tiles
//   (k and v, or q and do, 64 rows each) arrive by TMA in a ring of two
//   stages, one thread issuing the next stage's copies while the warpgroup
//   multiplies the other; the dk/dv pass's lse and delta rows for the next
//   step load into registers under the same step.  The maps are built per
//   launch over [heads, rows, D] views, so a tile past a head's last row
//   reads zeros.  The dq kernel can also form delta itself
//   (tpd_flash_backward_dq with an out pointer): it reads its rows of the
//   forward's out with 16-byte loads while the q and do tiles land, sums
//   out·do against the do tile in shared memory, subtracts dlse, uses the
//   result and writes it to a [b, h, Sq] f32 buffer that the dk/dv launch
//   after it reads.
// - mma.sync, bf16 at every other head dim up to 256: 4 warps of 16 rows
//   on mma.sync m16n8k16, padded shared tiles, cp.async double buffers
//   (dk/dv streams 32-row Q tiles).  The tiles are compiled for the padded
//   widths of flash_common.cuh (pad_head_dim), zero past a narrower head
//   dim, and at 16, 32, 64 and 128 once more with the head dim fixed at the
//   width (kExact).  Past 128 a CTA's f32 accumulators (dq, or dk and dv)
//   would not fit four warps' registers, so the output columns split into
//   chunks of kColChunk, one CTA each along grid z: every chunk's CTA forms
//   the whole score and dp tiles (the depth is the full head dim) and
//   accumulates its own columns only, and the A fragments of the score
//   products load from shared memory per step.
// - f32 on CUDA-core FMAs in full f32, never TF32, at any head dim up to
//   256 (each thread owns the output elements tid, tid + 128, ... of the
//   CTA's rows; the head dim compiled in at 16, 32, 64 and 128, taken at
//   run time elsewhere).
//
// Bound on the H100: operations (6·pairs·D flops for dq and 8·pairs·D for
// dk/dv against a few MB of operands at the training shapes).  The wgmma
// arm has no warp specialisation and one warpgroup a CTA; shared memory
// (six 16 KB tiles at D = 128) holds an SM to two CTAs, so one CTA's
// softmax arithmetic overlaps the other's products, and each step waits
// on its products before the next (PERF.md has the readings).
#include "flash_common.cuh"
#include "hopper_mma.cuh"
#include "tma_host.cuh"

namespace tpd_flash {
namespace {

// bf16, 4 warps of 16 rows, the streamed tiles double-buffered: dq walks
// 64-key tiles for 64 query rows, dk/dv 32-row Q tiles for 64 keys.  DP is
// the padded head dim (pad_head_dim), d <= DP the real one; a CTA
// accumulates output columns [c0, c0 + DC), c0 = blockIdx.z · DC.
constexpr int kBQ = 64, kBK = 64;
constexpr int kKB = 64, kQB = 32;
constexpr int kSQ = 16, kSK = 32;  // f32 tiles
constexpr int kColChunk = 128;     // output columns a bf16 CTA at most

// the output columns a bf16 CTA accumulates at padded head dim DP
__host__ __device__ constexpr int col_chunk(int DP) {
  return DP < kColChunk ? DP : kColChunk;
}

__device__ __forceinline__ float live_of(float lse) {
  return lse > kMask * 0.5f ? 1.f : 0.f;
}

// acc[n-tile] += A(rows r0.. of the shared tile A, depth DP) · Tᵀ: the A
// fragments held (a[KD], loaded here) up to a depth of 128, loaded per
// step past it
template <int NT, int DP>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const bf16* A,
                                         int r0, const bf16* t, int lane) {
  constexpr int LD = DP + 8, KD = DP / 16;
  if constexpr (DP <= 128) {
    uint32_t a[KD][4];
    for (int kk = 0; kk < KD; ++kk) load_a(a[kk], A, LD, r0, kk * 16, lane);
    mma_abt<NT, KD>(acc, a, t, LD, lane);
  } else {
    mma_abt_smem<NT, KD>(acc, A, LD, r0, t, LD, lane);
  }
}

// ------------------------------------------------------------------ dq, bf16

template <int DP, bool kExact>
__global__ void __launch_bounds__(kThreads)
    dq_bf16(const bf16* __restrict__ Q, const bf16* __restrict__ K,
            const bf16* __restrict__ V, const bf16* __restrict__ dO,
            const float* __restrict__ Lse, const float* __restrict__ Delta,
            bf16* __restrict__ dQ, int H, int Hkv, int Sq, int Sk, int d_arg,
            int lo, int hi, float scale) {
  const int d = kExact ? DP : d_arg;  // kExact: no padded column
  static_assert(DP % 16 == 0, "bf16 tiles take head dims in steps of 16");
  constexpr int LD = DP + 8, DC = col_chunk(DP), DN = DC / 8, NT = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kBQ][LD]
  bf16* dOs = Qs + kBQ * LD;                  // [kBQ][LD]
  bf16* Ks = dOs + kBQ * LD;                  // [2][kBK][LD]
  bf16* Vs = Ks + 2 * kBK * LD;               // [2][kBK][LD]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = b * Hkv + h / (H / Hkv);
  const int c0 = DP > DC ? blockIdx.z * DC : 0;  // this CTA's dq columns
  const bf16* k = K + (size_t)hk * Sk * d;
  const bf16* v = V + (size_t)hk * Sk * d;
  // longest CTAs first, as in the forward (last Q tiles, b·h fastest)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  int first, last;
  kv_tiles(q0, min(q0 + kBQ, Sq) - 1, lo, hi, Sk, kBK, first, last);

  load_tile_async<kBQ, DP>(Qs, Q + (size_t)bh * Sq * d, q0, Sq, d);
  load_tile_async<kBQ, DP>(dOs, dO + (size_t)bh * Sq * d, q0, Sq, d);
  if (first <= last) {
    load_tile_async<kBK, DP>(Ks, k, first * kBK, Sk, d);
    load_tile_async<kBK, DP>(Vs, v, first * kBK, Sk, d);
  }
  cp_commit();
  float lse[2], live[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    const bool ok = row < Sq;
    lse[r] = ok ? Lse[(size_t)bh * Sq + row] : INFINITY;
    live[r] = ok ? live_of(lse[r]) : 0.f;
    delta[r] = ok ? Delta[(size_t)bh * Sq + row] : 0.f;
  }

  float acc[DN][4] = {};
  for (int j = first; j <= last; ++j) {
    const int buf = (j - first) & 1;
    if (j < last) {
      load_tile_async<kBK, DP>(Ks + (buf ^ 1) * kBK * LD, k, (j + 1) * kBK,
                               Sk, d);
      load_tile_async<kBK, DP>(Vs + (buf ^ 1) * kBK * LD, v, (j + 1) * kBK,
                               Sk, d);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* ks = Ks + buf * kBK * LD;
    const bf16* vs = Vs + buf * kBK * LD;

    float s[NT][4] = {};
    mma_rows<NT, DP>(s, Qs, warp * 16, ks, lane);
    float dp[NT][4] = {};
    mma_rows<NT, DP>(dp, dOs, warp * 16, vs, lane);

    const int k0 = j * kBK;
    const bool interior = tile_interior(q0, kBQ, k0, kBK, lo, hi, Sk);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[n][e] * scale;
        if (!interior) {
          const int qp = q0 + warp * 16 + g + r * 8;
          const int kp = k0 + n * 8 + tq * 2 + (e & 1);
          if (!(kp < Sk && in_band(qp, kp, lo, hi))) x = kMask;
        }
        const float p = exp_row(x, lse[r]) * live[r];
        s[n][e] = p * (dp[n][e] - delta[r]) * scale;  // ds
      }
    mma_pt<DN, kBK / 16>(acc, s, ks + c0, LD, lane);
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    bf16* out = dQ + ((size_t)bh * Sq + row) * d;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      store_pair(out, c0 + dn * 8 + tq * 2, d, acc[dn][2 * r],
                 acc[dn][2 * r + 1]);
  }
}

// ---------------------------------------------------------------- dk/dv, bf16

template <int DP, bool kExact>
__global__ void __launch_bounds__(kThreads)
    dkv_bf16(const bf16* __restrict__ Q, const bf16* __restrict__ K,
             const bf16* __restrict__ V, const bf16* __restrict__ dO,
             const float* __restrict__ Lse, const float* __restrict__ Delta,
             bf16* __restrict__ dK, bf16* __restrict__ dV, int H, int Hkv,
             int Sq, int Sk, int d_arg, int lo, int hi, float scale) {
  const int d = kExact ? DP : d_arg;  // kExact: no padded column
  static_assert(DP % 16 == 0, "bf16 tiles take head dims in steps of 16");
  constexpr int LD = DP + 8, DC = col_chunk(DP), DN = DC / 8, NT = kQB / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kKB][LD]
  bf16* Vs = Ks + kKB * LD;                   // [kKB][LD]
  bf16* Qs = Vs + kKB * LD;                   // [2][kQB][LD]
  bf16* dOs = Qs + 2 * kQB * LD;              // [2][kQB][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kQB * LD);  // [2][kQB]
  float* delta_s = lse_s + 2 * kQB;                              // [2][kQB]
  const int bkv = blockIdx.x, b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int c0 = DP > DC ? blockIdx.z * DC : 0;  // its dk, dv columns
  // b·h_kv fastest; under a causal band the first KV tiles see the most
  // Q tiles, so the longest CTAs start first
  const int k0 = blockIdx.y * kKB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  int qfirst, qlast;
  q_tiles(k0, min(k0 + kKB, Sk) - 1, lo, hi, Sq, kQB, qfirst, qlast);
  const int per_head = qlast - qfirst + 1;
  const int steps = per_head > 0 ? group * per_head : 0;

  // (group member gi, Q tile) of step `it`: rows of q head b·H + hk·group + gi
  auto prefetch = [&](int it, int buf) {
    const int gi = it / per_head, qt = qfirst + it % per_head;
    const size_t bh = (size_t)b * H + hk * group + gi;
    load_tile_async<kQB, DP>(Qs + buf * kQB * LD, Q + bh * Sq * d, qt * kQB,
                             Sq, d);
    load_tile_async<kQB, DP>(dOs + buf * kQB * LD, dO + bh * Sq * d,
                             qt * kQB, Sq, d);
    if (threadIdx.x < kQB) {
      const int row = qt * kQB + threadIdx.x;
      const bool ok = row < Sq;
      lse_s[buf * kQB + threadIdx.x] = ok ? Lse[bh * Sq + row] : INFINITY;
      delta_s[buf * kQB + threadIdx.x] = ok ? Delta[bh * Sq + row] : 0.f;
    }
  };
  if (steps > 0) {
    load_tile_async<kKB, DP>(Ks, K + (size_t)bkv * Sk * d, k0, Sk, d);
    load_tile_async<kKB, DP>(Vs, V + (size_t)bkv * Sk * d, k0, Sk, d);
    prefetch(0, 0);
  }
  cp_commit();

  float dk[DN][4] = {}, dv[DN][4] = {};
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < steps) {
      prefetch(it + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = (qfirst + it % per_head) * kQB;
    const bf16* qs = Qs + buf * kQB * LD;
    const bf16* dos = dOs + buf * kQB * LD;
    const float* ls = lse_s + buf * kQB;
    const float* ds_ = delta_s + buf * kQB;

    // sᵀ = k·qᵀ (rows: this warp's 16 keys; columns: the tile's 32 queries)
    float s[NT][4] = {};
    mma_rows<NT, DP>(s, Ks, warp * 16, qs, lane);
    const bool interior = tile_interior(q0, kQB, k0, kKB, lo, hi, 1 << 30);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + tq * 2 + (e & 1);
        float x = s[n][e] * scale;
        if (!interior) {
          const int kp = k0 + warp * 16 + g + (e >> 1) * 8;
          if (!in_band(q0 + c, kp, lo, hi)) x = kMask;
        }
        s[n][e] = exp_row(x, ls[c]) * live_of(ls[c]);  // pᵀ
      }
    mma_pt<DN, kQB / 16>(dv, s, dos + c0, LD, lane);  // dv += bf(pᵀ)·do

    float dp[NT][4] = {};  // dpᵀ = v·doᵀ
    mma_rows<NT, DP>(dp, Vs, warp * 16, dos, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + tq * 2 + (e & 1);
        s[n][e] = s[n][e] * (dp[n][e] - ds_[c]) * scale;  // dsᵀ
      }
    mma_pt<DN, kQB / 16>(dk, s, qs + c0, LD, lane);  // dk += bf(dsᵀ)·q
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + r * 8;
    if (row >= Sk) continue;
    const size_t base = ((size_t)bkv * Sk + row) * d;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int c = c0 + dn * 8 + tq * 2;
      store_pair(dK + base, c, d, dk[dn][2 * r], dk[dn][2 * r + 1]);
      store_pair(dV + base, c, d, dv[dn][2 * r], dv[dn][2 * r + 1]);
    }
  }
}

// ----------------------------------------------------------- wgmma, bf16

namespace hw = tpd_hopper;
constexpr int kWg = hw::kTileRows;  // rows of a CTA's tile and of a step's

// sum of the eight bf16 products of two 16-byte chunks, in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// Out != nullptr: form delta = rowsum(out·do) - dlse (GLse may be null) and
// write it to Delta; else read Delta.
template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_wgmma(const __grid_constant__ CUtensorMap tmQ,
             const __grid_constant__ CUtensorMap tmK,
             const __grid_constant__ CUtensorMap tmV,
             const __grid_constant__ CUtensorMap tmdO,
             const float* __restrict__ Lse, float* __restrict__ Delta,
             const bf16* __restrict__ Out, const float* __restrict__ GLse,
             bf16* __restrict__ dQ, int H, int Hkv, int Sq, int Sk, int lo,
             int hi, float scale) {
  static_assert(D == 64 || D == 128, "wgmma tiles take head dims 64 and 128");
  constexpr int T = kWg * D, DN = D / 8, NT = kWg / 8;
  constexpr uint32_t kTileBytes = T * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(hw::align1024(smem_raw));  // [64][D]
  bf16* dOs = Qs + T;                                           // [64][D]
  bf16* Ks = dOs + T;                                           // [2][64][D]
  bf16* Vs = Ks + 2 * T;                                        // [2][64][D]
  float* delta_s = reinterpret_cast<float*>(Vs + 2 * T);        // [64]
  // barriers: the resident Q/dO tiles, then one per K/V ring stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(delta_s + kWg);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = b * Hkv + h / (H / Hkv);
  // longest CTAs first, as in the forward (last Q tiles, b·h fastest)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  int first, last;
  kv_tiles(q0, min(q0 + kWg, Sq) - 1, lo, hi, Sk, kWg, first, last);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) hw::mbar_init(bars + i, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hw::mbar_expect(bars, 2 * kTileBytes);
    hw::tma_tile<D>(Qs, &tmQ, bars, q0, bh);
    hw::tma_tile<D>(dOs, &tmdO, bars, q0, bh);
    if (first <= last) {
      hw::mbar_expect(bars + 1, 2 * kTileBytes);
      hw::tma_tile<D>(Ks, &tmK, bars + 1, first * kWg, hk);
      hw::tma_tile<D>(Vs, &tmV, bars + 1, first * kWg, hk);
    }
  }
  if (Out != nullptr) {
    // two threads a row, half of its columns each: the out loads fly with
    // the Q/dO tiles, the sums run while the first K/V tile is in flight
    // (a row past Sq reads row Sq - 1 and is not stored)
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    const bf16* o =
        Out + ((size_t)bh * Sq + min(row, Sq - 1)) * D + half * (D / 2);
    uint4 ov[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      ov[c] = *reinterpret_cast<const uint4*>(o + c * 8);
    hw::mbar_wait(bars, 0);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      sum += dot8(ov[c], *reinterpret_cast<const uint4*>(
                             dOs + hw::swz(r, half * (D / 2) + c * 8)));
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      float d = 0.f;
      if (row < Sq) {
        d = GLse != nullptr ? sum - GLse[(size_t)bh * Sq + row] : sum;
        Delta[(size_t)bh * Sq + row] = d;
      }
      delta_s[r] = d;
    }
    __syncthreads();
  } else {
    hw::mbar_wait(bars, 0);
  }
  float lse[2], live[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = warp * 16 + g + r * 8, row = q0 + rl;
    const bool ok = row < Sq;
    lse[r] = ok ? Lse[(size_t)bh * Sq + row] : INFINITY;
    live[r] = ok ? live_of(lse[r]) : 0.f;
    delta[r] = Out != nullptr ? delta_s[rl]
                              : (ok ? Delta[(size_t)bh * Sq + row] : 0.f);
  }

  float acc[DN][4] = {};
  for (int j = first; j <= last; ++j) {
    const int t = j - first, buf = t & 1;
    if (j < last && threadIdx.x == 0) {  // the stage freed last step
      hw::mbar_expect(bars + 1 + (buf ^ 1), 2 * kTileBytes);
      hw::tma_tile<D>(Ks + (buf ^ 1) * T, &tmK, bars + 1 + (buf ^ 1),
                      (j + 1) * kWg, hk);
      hw::tma_tile<D>(Vs + (buf ^ 1) * T, &tmV, bars + 1 + (buf ^ 1),
                      (j + 1) * kWg, hk);
    }
    hw::mbar_wait(bars + 1 + buf, (t >> 1) & 1);
    const bf16* ks = Ks + buf * T;
    const bf16* vs = Vs + buf * T;
    float s[NT][4] = {}, dp[NT][4] = {};
    hw::wgmma_fence();
    hw::wgmma_abt<D>(s, Qs, ks);    // s = q·kᵀ
    hw::wgmma_abt<D>(dp, dOs, vs);  // dp = do·vᵀ
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_acc(s);
    hw::fence_acc(dp);

    const int k0 = j * kWg;
    const bool interior = tile_interior(q0, kWg, k0, kWg, lo, hi, Sk);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[n][e] * scale;
        if (!interior) {
          const int qp = q0 + warp * 16 + g + r * 8;
          const int kp = k0 + n * 8 + tq * 2 + (e & 1);
          if (!(kp < Sk && in_band(qp, kp, lo, hi))) x = kMask;
        }
        const float p = exp_row(x, lse[r]) * live[r];
        s[n][e] = p * (dp[n][e] - delta[r]) * scale;  // ds
      }
    hw::wgmma_pt<DN>(acc, s, ks);  // dq += bf(ds)·k
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_acc(acc);
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    const size_t base = ((size_t)bh * Sq + row) * D + tq * 2;
#pragma unroll
    for (int i = 0; i < DN; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dQ + base + i * 8) =
          __floats2bfloat162_rn(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_wgmma(const __grid_constant__ CUtensorMap tmQ,
              const __grid_constant__ CUtensorMap tmK,
              const __grid_constant__ CUtensorMap tmV,
              const __grid_constant__ CUtensorMap tmdO,
              const float* __restrict__ Lse, const float* __restrict__ Delta,
              bf16* __restrict__ dK, bf16* __restrict__ dV, int H, int Hkv,
              int Sq, int Sk, int lo, int hi, float scale) {
  static_assert(D == 64 || D == 128, "wgmma tiles take head dims 64 and 128");
  constexpr int T = kWg * D, DN = D / 8, NT = kWg / 8;
  constexpr uint32_t kTileBytes = T * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(hw::align1024(smem_raw));  // [64][D]
  bf16* Vs = Ks + T;                                            // [64][D]
  bf16* Qs = Vs + T;                                            // [2][64][D]
  bf16* dOs = Qs + 2 * T;                                       // [2][64][D]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * T);         // [2][64]
  float* delta_s = lse_s + 2 * kWg;                             // [2][64]
  // barriers: the resident K/V tiles, then one per Q/dO ring stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(delta_s + 2 * kWg);
  const int bkv = blockIdx.x, b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  // b·h_kv fastest; under a causal band the first KV tiles see the most
  // Q tiles, so the longest CTAs start first
  const int k0 = blockIdx.y * kWg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  int qfirst, qlast;
  q_tiles(k0, min(k0 + kWg, Sk) - 1, lo, hi, Sq, kWg, qfirst, qlast);
  const int per_head = qlast - qfirst + 1;
  const int steps = per_head > 0 ? group * per_head : 0;
  // q head (b·H + hk·group + member) and Q tile of step `it`
  auto head_of = [&](int it) { return b * H + hk * group + it / per_head; };
  auto tile_of = [&](int it) { return qfirst + it % per_head; };
  // one thread: the step's Q and dO tiles into ring stage `buf`
  auto stream = [&](int it, int buf) {
    hw::mbar_expect(bars + 1 + buf, 2 * kTileBytes);
    hw::tma_tile<D>(Qs + buf * T, &tmQ, bars + 1 + buf, tile_of(it) * kWg,
                    head_of(it));
    hw::tma_tile<D>(dOs + buf * T, &tmdO, bars + 1 + buf, tile_of(it) * kWg,
                    head_of(it));
  };
  // the lse and delta of a step's 64 rows (threads < 64, a row each)
  auto row_scalars = [&](int it, float& l, float& d) {
    const int row = tile_of(it) * kWg + threadIdx.x;
    const size_t i = (size_t)head_of(it) * Sq + row;
    l = row < Sq ? Lse[i] : INFINITY;
    d = row < Sq ? Delta[i] : 0.f;
  };
  if (steps == 0) {
    // no live query: dk = dv = 0
  } else if (threadIdx.x < kWg) {
    row_scalars(0, lse_s[threadIdx.x], delta_s[threadIdx.x]);
  } else if (threadIdx.x == kWg) {
    for (int i = 0; i < 3; ++i) hw::mbar_init(bars + i, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();
  if (steps > 0 && threadIdx.x == 0) {
    hw::mbar_expect(bars, 2 * kTileBytes);
    hw::tma_tile<D>(Ks, &tmK, bars, k0, bkv);
    hw::tma_tile<D>(Vs, &tmV, bars, k0, bkv);
    stream(0, 0);
  }
  if (steps > 0) hw::mbar_wait(bars, 0);

  float dk[DN][4] = {}, dv[DN][4] = {};
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    const bool next = it + 1 < steps;
    float nl = 0.f, nd = 0.f;  // the next step's row scalars, in flight
    if (next && threadIdx.x < kWg) row_scalars(it + 1, nl, nd);
    if (next && threadIdx.x == 0) stream(it + 1, buf ^ 1);
    hw::mbar_wait(bars + 1 + buf, (it >> 1) & 1);
    const int q0 = tile_of(it) * kWg;
    const bf16* qs = Qs + buf * T;
    const bf16* dos = dOs + buf * T;
    const float* ls = lse_s + buf * kWg;
    const float* dl = delta_s + buf * kWg;

    // rows: this warp's 16 keys; columns: the step's 64 queries
    float s[NT][4] = {}, dp[NT][4] = {};
    hw::wgmma_fence();
    hw::wgmma_abt<D>(s, Ks, qs);    // sᵀ = k·qᵀ
    hw::wgmma_abt<D>(dp, Vs, dos);  // dpᵀ = v·doᵀ
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_acc(s);
    hw::fence_acc(dp);
    const bool interior = tile_interior(q0, kWg, k0, kWg, lo, hi, 1 << 30);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + tq * 2 + (e & 1);
        float x = s[n][e] * scale;
        if (!interior) {
          const int kp = k0 + warp * 16 + g + (e >> 1) * 8;
          if (!in_band(q0 + c, kp, lo, hi)) x = kMask;
        }
        s[n][e] = exp_row(x, ls[c]) * live_of(ls[c]);  // pᵀ
      }
    hw::wgmma_pt<DN>(dv, s, dos);  // dv += bf(pᵀ)·do
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + tq * 2 + (e & 1);
        dp[n][e] = s[n][e] * (dp[n][e] - dl[c]) * scale;  // dsᵀ
      }
    hw::wgmma_pt<DN>(dk, dp, qs);  // dk += bf(dsᵀ)·q
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_acc(dk);
    hw::fence_acc(dv);
    if (next && threadIdx.x < kWg) {
      lse_s[(buf ^ 1) * kWg + threadIdx.x] = nl;
      delta_s[(buf ^ 1) * kWg + threadIdx.x] = nd;
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + r * 8;
    if (row >= Sk) continue;
    const size_t base = ((size_t)bkv * Sk + row) * D + tq * 2;
#pragma unroll
    for (int i = 0; i < DN; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dK + base + i * 8) =
          __floats2bfloat162_rn(dk[i][2 * r], dk[i][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dV + base + i * 8) =
          __floats2bfloat162_rn(dv[i][2 * r], dv[i][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------- f32

// dq: 16 query rows per CTA, 32-key tiles; a warp holds one row's tile
// (a lane per key).  kD > 0 compiles the head dim in (16, 32, 64, 128):
// each thread owns one dq column of kDqAcc consecutive rows.  kD == 0
// takes it at run time: the [16, D] dq tile's elements go to the threads
// in turn (element tid + 128·i: row e / D, column e % D), at most kDqAcc a
// thread, so any D up to kMaxHeadDim runs (fwd_f32's rule).
template <int kD>
__global__ void __launch_bounds__(kThreads)
    dq_f32(const float* __restrict__ Q, const float* __restrict__ K,
           const float* __restrict__ V, const float* __restrict__ dO,
           const float* __restrict__ Lse, const float* __restrict__ Delta,
           float* __restrict__ dQ, int H, int Hkv, int Sq, int Sk, int d_arg,
           int lo, int hi, float scale) {
  const int D = kD ? kD : d_arg;
  constexpr int kDqAcc = (kD ? kD : kMaxHeadDim) * kSQ / kThreads;
  const int LDK = D | 1;  // odd: a warp's 32 key rows fall in 32 banks
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kSQ][D]
  float* dOs = Qs + kSQ * D;                    // [kSQ][D]
  float* Ks = dOs + kSQ * D;                    // [kSK][LDK]
  float* Vs = Ks + kSK * LDK;                   // [kSK][LDK]
  float* dSs = Vs + kSK * LDK;                  // [kSQ][kSK]
  float* ls = dSs + kSQ * kSK;                  // [kSQ]
  float* dl = ls + kSQ;                         // [kSQ]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = b * Hkv + h / (H / Hkv);
  const float* k = K + (size_t)hk * Sk * D;
  const float* v = V + (size_t)hk * Sk * D;
  const int q0 = blockIdx.x * kSQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // kD > 0: this thread's column and first row
  const int cb = kD ? threadIdx.x % D : 0;
  const int rb = kD ? threadIdx.x / D * kDqAcc : 0;
  int first, last;
  kv_tiles(q0, min(q0 + kSQ, Sq) - 1, lo, hi, Sk, kSK, first, last);
  load_tile_f32<kSQ>(Qs, D, Q + (size_t)bh * Sq * D, q0, Sq, D);
  load_tile_f32<kSQ>(dOs, D, dO + (size_t)bh * Sq * D, q0, Sq, D);
  if (threadIdx.x < kSQ) {
    const int row = q0 + threadIdx.x;
    ls[threadIdx.x] = row < Sq ? Lse[(size_t)bh * Sq + row] : INFINITY;
    dl[threadIdx.x] = row < Sq ? Delta[(size_t)bh * Sq + row] : 0.f;
  }
  float acc[kDqAcc] = {};
  for (int j = first; j <= last; ++j) {
    const int k0 = j * kSK;
    __syncthreads();
    load_tile_f32<kSK>(Ks, LDK, k, k0, Sk, D);
    load_tile_f32<kSK>(Vs, LDK, v, k0, Sk, D);
    __syncthreads();
    const bool interior = tile_interior(q0, kSQ, k0, kSK, lo, hi, Sk);
    for (int r = warp; r < kSQ; r += kThreads / 32) {
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < D; ++c) {
        s += Qs[r * D + c] * Ks[lane * LDK + c];
        dp += dOs[r * D + c] * Vs[lane * LDK + c];
      }
      s *= scale;
      if (!interior && !(k0 + lane < Sk && in_band(q0 + r, k0 + lane, lo, hi)))
        s = kMask;
      const float p = expf(s - ls[r]) * live_of(ls[r]);
      dSs[r * kSK + lane] = p * (dp - dl[r]) * scale;
    }
    __syncthreads();
    if constexpr (kD > 0) {
      for (int i = 0; i < kDqAcc; ++i) {
        const int r = rb + i;
        float x = 0.f;
        for (int c = 0; c < kSK; ++c) x += dSs[r * kSK + c] * Ks[c * LDK + cb];
        acc[i] += x;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kDqAcc; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (e >= kSQ * D) break;
        const int r = e / D, col = e % D;
        float x = 0.f;
        for (int c = 0; c < kSK; ++c)
          x += dSs[r * kSK + c] * Ks[c * LDK + col];
        acc[i] += x;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kDqAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (!kD && e >= kSQ * D) break;
    const int row = q0 + (kD ? rb + i : e / D), col = kD ? cb : e % D;
    if (row < Sq) dQ[((size_t)bh * Sq + row) * D + col] = acc[i];
  }
}

// dk/dv: 32 keys per CTA, a loop over (group member, 16-row Q tile); at a
// compiled head dim each thread owns one dk/dv column of kKvAcc
// consecutive keys, at a run-time one the [32, D] dk and dv tiles'
// elements go to the threads in turn, at most kKvAcc a thread (kD as
// dq_f32's).
template <int kD>
__global__ void __launch_bounds__(kThreads)
    dkv_f32(const float* __restrict__ Q, const float* __restrict__ K,
            const float* __restrict__ V, const float* __restrict__ dO,
            const float* __restrict__ Lse, const float* __restrict__ Delta,
            float* __restrict__ dK, float* __restrict__ dV, int H, int Hkv,
            int Sq, int Sk, int d_arg, int lo, int hi, float scale) {
  const int D = kD ? kD : d_arg;
  constexpr int kKvAcc = (kD ? kD : kMaxHeadDim) * kSK / kThreads;
  const int LD = D | 1, LP = kSQ + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [kSK][LD]
  float* Vs = Ks + kSK * LD;                    // [kSK][LD]
  float* Qs = Vs + kSK * LD;                    // [kSQ][LD]
  float* dOs = Qs + kSQ * LD;                   // [kSQ][LD]
  float* Ps = dOs + kSQ * LD;                   // [kSK][LP]
  float* dSs = Ps + kSK * LP;                   // [kSK][LP]
  float* ls = dSs + kSK * LP;                   // [kSQ]
  float* dl = ls + kSQ;                         // [kSQ]
  const int bkv = blockIdx.y, b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * kSK;
  // kD > 0: this thread's column and first key
  const int cb = kD ? threadIdx.x % D : 0;
  const int kb = kD ? threadIdx.x / D * kKvAcc : 0;
  int qfirst, qlast;
  q_tiles(k0, min(k0 + kSK, Sk) - 1, lo, hi, Sq, kSQ, qfirst, qlast);
  load_tile_f32<kSK>(Ks, LD, K + (size_t)bkv * Sk * D, k0, Sk, D);
  load_tile_f32<kSK>(Vs, LD, V + (size_t)bkv * Sk * D, k0, Sk, D);
  float dk[kKvAcc] = {}, dv[kKvAcc] = {};
  for (int gi = 0; gi < group; ++gi) {
    const size_t bh = (size_t)b * H + hk * group + gi;
    for (int qt = qfirst; qt <= qlast; ++qt) {
      const int q0 = qt * kSQ;
      __syncthreads();
      load_tile_f32<kSQ>(Qs, LD, Q + bh * Sq * D, q0, Sq, D);
      load_tile_f32<kSQ>(dOs, LD, dO + bh * Sq * D, q0, Sq, D);
      if (threadIdx.x < kSQ) {
        const int row = q0 + threadIdx.x;
        ls[threadIdx.x] = row < Sq ? Lse[bh * Sq + row] : INFINITY;
        dl[threadIdx.x] = row < Sq ? Delta[bh * Sq + row] : 0.f;
      }
      __syncthreads();
      const bool interior = tile_interior(q0, kSQ, k0, kSK, lo, hi, 1 << 30);
      const int r = threadIdx.x % kSQ;
      for (int c = threadIdx.x / kSQ; c < kSK; c += kThreads / kSQ) {
        float s = 0.f, dp = 0.f;
        for (int x = 0; x < D; ++x) {
          s += Ks[c * LD + x] * Qs[r * LD + x];
          dp += Vs[c * LD + x] * dOs[r * LD + x];
        }
        s *= scale;
        if (!interior && !in_band(q0 + r, k0 + c, lo, hi)) s = kMask;
        const float p = expf(s - ls[r]) * live_of(ls[r]);
        Ps[c * LP + r] = p;
        dSs[c * LP + r] = p * (dp - dl[r]) * scale;
      }
      __syncthreads();
      if constexpr (kD > 0) {
        for (int i = 0; i < kKvAcc; ++i) {
          const int c = kb + i;
          float xv = 0.f, xk = 0.f;
          for (int rr = 0; rr < kSQ; ++rr) {
            xv += Ps[c * LP + rr] * dOs[rr * LD + cb];
            xk += dSs[c * LP + rr] * Qs[rr * LD + cb];
          }
          dv[i] += xv;
          dk[i] += xk;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kKvAcc; ++i) {
          const int e = threadIdx.x + i * kThreads;
          if (e >= kSK * D) break;
          const int c = e / D, col = e % D;
          float xv = 0.f, xk = 0.f;
          for (int rr = 0; rr < kSQ; ++rr) {
            xv += Ps[c * LP + rr] * dOs[rr * LD + col];
            xk += dSs[c * LP + rr] * Qs[rr * LD + col];
          }
          dv[i] += xv;
          dk[i] += xk;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kKvAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (!kD && e >= kSK * D) break;
    const int row = k0 + (kD ? kb + i : e / D), col = kD ? cb : e % D;
    if (row >= Sk) continue;
    dK[((size_t)bkv * Sk + row) * D + col] = dk[i];
    dV[((size_t)bkv * Sk + row) * D + col] = dv[i];
  }
}

}  // namespace
}  // namespace tpd_flash

using namespace tpd_flash;

#define TPD_LAUNCH(KERN, GRID, THREADS, SMEM, ...)                            \
  {                                                                           \
    auto kern = KERN;                                                         \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(SMEM));      \
    if (e != cudaSuccess) return (int)e;                                      \
    kern<<<GRID, THREADS, SMEM, st>>>(__VA_ARGS__);                           \
    return (int)cudaGetLastError();                                           \
  }

// the kernel arm: ops/flash_attention.py _ARMS
enum Arm : int { kArmF32 = 0, kArmMma = 1, kArmWgmma = 2 };

// Shared memory of the wgmma arm: two resident and four streamed [64][D]
// bf16 tiles, up to 1 KB of row scalars, the mbarriers and 1 KB of slack
// to align the tiles to 1024 bytes.
inline size_t wgmma_smem(int D) {
  return (size_t)6 * kWg * D * sizeof(bf16) + 3072;
}

// All of q, k, v, do, dq alike (bf16 for arms 1-2, f32 for arm 0),
// contiguous; lse f32 [B, H, Sq]; D 64 or 128 on arm 2, 1..kMaxHeadDim on
// arms 0-1.  out == NULL: delta is read.  out != NULL
// (arm 2 only; out bf16 like q, glse f32 or NULL): the kernel forms delta =
// rowsum(out·do) - glse and writes it to delta.
extern "C" int tpd_flash_backward_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, void* delta,
                                     const void* out, const void* glse,
                                     void* dq, int B, int H, int Hkv, int Sq,
                                     int Sk, int D, int lo, int hi, int arm,
                                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out != nullptr && arm != kArmWgmma) return (int)cudaErrorInvalidValue;
  if (Sq <= 0 || B * H <= 0) return 0;
  const float* L = static_cast<const float*>(lse);
  float* Dl = static_cast<float*>(delta);
  if (arm == kArmWgmma) {
    const dim3 grid(B * H, (Sq + kWg - 1) / kWg);
    const size_t smem = wgmma_smem(D);
    CUtensorMap m[4];
    if ((D != 64 && D != 128) ||
        !hw::tile_maps(m, q, k, v, dout, B, H, Hkv, Sq, Sk, D))
      return (int)cudaErrorInvalidValue;
    const bf16* O = static_cast<const bf16*>(out);
    const float* GL = static_cast<const float*>(glse);
    bf16* dQ = static_cast<bf16*>(dq);
    if (D == 64)
      TPD_LAUNCH(dq_wgmma<64>, grid, kThreads, smem, m[0], m[1], m[2],
                 m[3], L, Dl, O, GL, dQ, H, Hkv, Sq, Sk, lo, hi, scale)
    if (D == 128)
      TPD_LAUNCH(dq_wgmma<128>, grid, kThreads, smem, m[0], m[1], m[2],
                 m[3], L, Dl, O, GL, dQ, H, Hkv, Sq, Sk, lo, hi, scale)
  } else if (arm == kArmMma) {
    const int DP = pad_head_dim(D);
    const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ, DP / col_chunk(DP));
    const size_t smem = (size_t)(2 * kBQ + 4 * kBK) * (DP + 8) * sizeof(bf16);
    const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
               *V = static_cast<const bf16*>(v),
               *dO = static_cast<const bf16*>(dout);
    bf16* dQ = static_cast<bf16*>(dq);
// the head dim fixed at 16, 32, 64 and 128, every padded width at run
// time (the forward's rule)
#define TPD_DQ_BF16(DD, EX)                                               \
  TPD_LAUNCH((dq_bf16<DD, EX>), grid, kThreads, smem, Q, K, V, dO, L, Dl, \
             dQ, H, Hkv, Sq, Sk, D, lo, hi, scale)
#define TPD_DQ_BF16_EXACT(DD) if (D == DD) TPD_DQ_BF16(DD, true)
#define TPD_DQ_BF16_PAD(DD) if (DP == DD) TPD_DQ_BF16(DD, false)
    TPD_DQ_BF16_EXACT(16)
    TPD_DQ_BF16_EXACT(32)
    TPD_DQ_BF16_EXACT(64)
    TPD_DQ_BF16_EXACT(128)
    TPD_DQ_BF16_PAD(16)
    TPD_DQ_BF16_PAD(32)
    TPD_DQ_BF16_PAD(64)
    TPD_DQ_BF16_PAD(96)
    TPD_DQ_BF16_PAD(128)
    TPD_DQ_BF16_PAD(256)
#undef TPD_DQ_BF16_PAD
#undef TPD_DQ_BF16_EXACT
#undef TPD_DQ_BF16
  } else if (arm == kArmF32) {
    if (D < 1 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
    const dim3 grid((Sq + kSQ - 1) / kSQ, B * H);
    const size_t smem =
        ((size_t)2 * kSQ * D + 2 * kSK * (D | 1) + kSQ * kSK + 2 * kSQ) *
        sizeof(float);
#define TPD_DQ_F32(DD)                                                     \
  if (D == DD || DD == 0)                                                  \
    TPD_LAUNCH(dq_f32<DD>, grid, kThreads, smem,                           \
               static_cast<const float*>(q), static_cast<const float*>(k), \
               static_cast<const float*>(v),                               \
               static_cast<const float*>(dout), L, Dl,                     \
               static_cast<float*>(dq), H, Hkv, Sq, Sk, D, lo, hi, scale)
    TPD_DQ_F32(16)
    TPD_DQ_F32(32)
    TPD_DQ_F32(64)
    TPD_DQ_F32(128)
    TPD_DQ_F32(0)
#undef TPD_DQ_F32
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int tpd_flash_backward_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int H,
                                      int Hkv, int Sq, int Sk, int D, int lo,
                                      int hi, int arm, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sk <= 0 || B * Hkv <= 0) return 0;
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  if (arm == kArmWgmma) {
    const dim3 grid(B * Hkv, (Sk + kWg - 1) / kWg);
    const size_t smem = wgmma_smem(D);
    CUtensorMap m[4];
    if ((D != 64 && D != 128) ||
        !hw::tile_maps(m, q, k, v, dout, B, H, Hkv, Sq, Sk, D))
      return (int)cudaErrorInvalidValue;
    bf16 *dK = static_cast<bf16*>(dk), *dV = static_cast<bf16*>(dv);
    if (D == 64)
      TPD_LAUNCH(dkv_wgmma<64>, grid, kThreads, smem, m[0], m[1], m[2],
                 m[3], L, Dl, dK, dV, H, Hkv, Sq, Sk, lo, hi, scale)
    if (D == 128)
      TPD_LAUNCH(dkv_wgmma<128>, grid, kThreads, smem, m[0], m[1],
                 m[2], m[3], L, Dl, dK, dV, H, Hkv, Sq, Sk, lo, hi, scale)
  } else if (arm == kArmMma) {
    const int DP = pad_head_dim(D);
    const dim3 grid(B * Hkv, (Sk + kKB - 1) / kKB, DP / col_chunk(DP));
    const size_t smem = (size_t)(2 * kKB + 4 * kQB) * (DP + 8) * sizeof(bf16) +
                        4 * kQB * sizeof(float);
    const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
               *V = static_cast<const bf16*>(v),
               *dO = static_cast<const bf16*>(dout);
    bf16 *dK = static_cast<bf16*>(dk), *dV = static_cast<bf16*>(dv);
#define TPD_DKV_BF16(DD, EX)                                              \
  TPD_LAUNCH((dkv_bf16<DD, EX>), grid, kThreads, smem, Q, K, V, dO, L, Dl, \
             dK, dV, H, Hkv, Sq, Sk, D, lo, hi, scale)
#define TPD_DKV_BF16_EXACT(DD) if (D == DD) TPD_DKV_BF16(DD, true)
#define TPD_DKV_BF16_PAD(DD) if (DP == DD) TPD_DKV_BF16(DD, false)
    TPD_DKV_BF16_EXACT(16)
    TPD_DKV_BF16_EXACT(32)
    TPD_DKV_BF16_EXACT(64)
    TPD_DKV_BF16_EXACT(128)
    TPD_DKV_BF16_PAD(16)
    TPD_DKV_BF16_PAD(32)
    TPD_DKV_BF16_PAD(64)
    TPD_DKV_BF16_PAD(96)
    TPD_DKV_BF16_PAD(128)
    TPD_DKV_BF16_PAD(256)
#undef TPD_DKV_BF16_PAD
#undef TPD_DKV_BF16_EXACT
#undef TPD_DKV_BF16
  } else if (arm == kArmF32) {
    if (D < 1 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
    const dim3 grid((Sk + kSK - 1) / kSK, B * Hkv);
    const size_t smem = ((size_t)2 * kSK * (D | 1) + 2 * kSQ * (D | 1) +
                         2 * kSK * (kSQ + 1) + 2 * kSQ) *
                        sizeof(float);
#define TPD_DKV_F32(DD)                                                    \
  if (D == DD || DD == 0)                                                  \
    TPD_LAUNCH(dkv_f32<DD>, grid, kThreads, smem,                          \
               static_cast<const float*>(q), static_cast<const float*>(k), \
               static_cast<const float*>(v),                               \
               static_cast<const float*>(dout), L, Dl,                     \
               static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv,   \
               Sq, Sk, D, lo, hi, scale)
    TPD_DKV_F32(16)
    TPD_DKV_F32(32)
    TPD_DKV_F32(64)
    TPD_DKV_F32(128)
    TPD_DKV_F32(0)
#undef TPD_DKV_F32
  }
  return (int)cudaErrorInvalidValue;
}

#undef TPD_LAUNCH

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
