// FlashAttention-2 forward for Hopper (sm_90a): out and the row logsumexp.
//
// Replaces the Pallas TPU kernel tpudist/ops/flash_attention.py
// (_flash_forward, body _flash_kernel).  q [b, h, Sq, D], k/v [b, h_kv, Sk,
// D] (GQA: q head h reads kv head h / (h / h_kv), never a repeated copy),
// out [b, h, Sq, D] in the input dtype or f32, lse [b, h, Sq] f32 in the
// scaled-score domain.  Masks: the band lo <= q - k < hi (flash_common.cuh)
// and the ragged key tail k >= Sk; any Sq and Sk.
//
// Design.  The TPU kernel walks a sequential (bh, q tile, kv tile) grid and
// carries (m, l, acc) in VMEM across the KV axis.  Here one CTA owns one
// (b·h, 64-row Q tile) and a loop inside it walks only the band's live KV
// tiles (first..last from kv_tiles); tiles wholly inside the band skip the
// mask.  The running max, sum and accumulator are f32 in registers (online
// softmax, one warp per 16 query rows).
//
// Numerics follow the Pallas kernel's cast points: s = (q·kᵀ) in f32 from
// input-dtype operands, times dh^-0.5, masked to -1e30; p = exp(s - m) in
// f32, summed unrounded into l, rounded to v's dtype for P·V; out = acc / l.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, K/V tiles of 64 keys
// through cp.async); f32 (the JAX package's fp32 path) runs on CUDA-core
// FMAs in full f32, never TF32.
//
// Bound on the H100: operations.  At the training shapes (s 2048, dh 128)
// the band's 4·pairs·D flops exceed the q/k/v/out bytes over the memory
// rate by two orders of magnitude; the kernel is a first, simple version
// (no wgmma/TMA, no warp specialisation), so it runs well below that bound.
#include "flash_common.cuh"

namespace tpd_flash {
namespace {

// bf16: 4 warps of 16 query rows share each 64-key K/V tile, with one K/V
// buffer and at most 170 registers a thread, so three CTAs fit an SM (12
// warps) and hide each other's loads instead of double buffering.
// Head dims: the kernels are instantiated for 16, 32, 64 and 128 (the bf16
// tiles need multiples of 16; the f32 kernels map a thread to a column, so
// D must divide the 128 threads).
constexpr int kBQ = 64, kBK = 64, kFwdMinCtas = 3;
constexpr int kSQ = 16, kSK = 32;  // f32 tiles

template <int D, bool kOutF32>
__global__ void __launch_bounds__(kThreads, kFwdMinCtas)
    fwd_bf16(const bf16* __restrict__ Q, const bf16* __restrict__ K,
             const bf16* __restrict__ V, void* __restrict__ Out,
             float* __restrict__ Lse, int H, int Hkv, int Sq, int Sk, int lo,
             int hi, float scale) {
  static_assert(D % 16 == 0, "bf16 tiles take head dims in steps of 16");
  constexpr int LD = D + 8, DN = D / 8, KD = D / 16, NT = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                   // [kBK][LD]
  bf16* Vs = Ks + kBK * LD;                   // [kBK][LD]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = b * Hkv + h / (H / Hkv);
  const bf16* q = Q + (size_t)bh * Sq * D;
  const bf16* k = K + (size_t)hk * Sk * D;
  const bf16* v = V + (size_t)hk * Sk * D;
  // b·h varies fastest and the last Q tiles come first: under a causal
  // band they walk the most KV tiles, so every head's long CTAs start early
  // and the short ones fill the tail of the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  int first, last;
  kv_tiles(q0, min(q0 + kBQ, Sq) - 1, lo, hi, Sk, kBK, first, last);

  load_tile_async<kBQ, D>(Qs, q, q0, Sq);
  if (first <= last) {
    load_tile_async<kBK, D>(Ks, k, first * kBK, Sk);
    load_tile_async<kBK, D>(Vs, v, first * kBK, Sk);
  }
  cp_commit();

  float o[DN][4] = {};
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  uint32_t qa[KD][4];
  for (int j = first; j <= last; ++j) {
    if (j > first) {  // every warp left the previous tile at the barrier
      load_tile_async<kBK, D>(Ks, k, j * kBK, Sk);
      load_tile_async<kBK, D>(Vs, v, j * kBK, Sk);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();
    if (j == first)
      for (int kk = 0; kk < KD; ++kk)
        load_a(qa[kk], Qs, LD, warp * 16, kk * 16, lane);

    float s[NT][4] = {};
    mma_abt<NT, KD>(s, qa, Ks, LD, lane);
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
    const size_t base = ((size_t)bh * Sq + row) * D + tq * 2;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const float a = dead ? 0.f : o[dn][2 * r] / l[r];
      const float c = dead ? 0.f : o[dn][2 * r + 1] / l[r];
      if (kOutF32) {
        float2* p = reinterpret_cast<float2*>(static_cast<float*>(Out) + base +
                                              dn * 8);
        *p = make_float2(a, c);
      } else {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            static_cast<bf16*>(Out) + base + dn * 8);
        *p = __floats2bfloat162_rn(a, c);
      }
    }
    if (tq == 0) Lse[(size_t)bh * Sq + row] = dead ? kMask : m[r] + logf(l[r]);
  }
}

// f32: 16 query rows per CTA, 32-key tiles; a warp holds one row's scores
// (a lane per key), each thread one output column of its rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_f32(const float* __restrict__ Q, const float* __restrict__ K,
            const float* __restrict__ V, float* __restrict__ Out,
            float* __restrict__ Lse, int H, int Hkv, int Sq, int Sk, int lo,
            int hi, float scale) {
  static_assert(kThreads % D == 0, "a thread owns one output column");
  constexpr int LDK = D + 1, RPT = kSQ * D / kThreads;
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
  const int col = threadIdx.x % D, rb = (threadIdx.x / D) * RPT;
  int first, last;
  kv_tiles(q0, min(q0 + kSQ, Sq) - 1, lo, hi, Sk, kSK, first, last);
  load_tile_f32<kSQ, D>(Qs, D, q, q0, Sq);
  if (threadIdx.x < kSQ) {
    ms[threadIdx.x] = kMask;
    ls[threadIdx.x] = 0.f;
  }
  float acc[RPT] = {};
  for (int j = first; j <= last; ++j) {
    const int k0 = j * kSK;
    __syncthreads();
    load_tile_f32<kSK, D>(Ks, LDK, k, k0, Sk);
    load_tile_f32<kSK, D>(Vs, D, v, k0, Sk);
    __syncthreads();
    const bool interior = tile_interior(q0, kSQ, k0, kSK, lo, hi, Sk);
    for (int r = warp; r < kSQ; r += kThreads / 32) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += Qs[r * D + d] * Ks[lane * LDK + d];
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
    for (int i = 0; i < RPT; ++i) {
      const int r = rb + i;
      float pv = 0.f;
      for (int c = 0; c < kSK; ++c) pv += Ps[r * kSK + c] * Vs[c * D + col];
      acc[i] = acc[i] * cs[r] + pv;
    }
  }
  __syncthreads();
  for (int i = 0; i < RPT; ++i) {
    const int r = rb + i, row = q0 + r;
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

// q/k/v contiguous [B, H|Hkv, S, D]; dtype kBF16 or kF32 (all three alike);
// out_f32 selects an f32 `out` for bf16 inputs (f32 inputs always give f32)
extern "C" int tpd_flash_forward(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int H, int Hkv,
                                 int Sq, int Sk, int D, int lo, int hi,
                                 int dtype, int out_f32, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B * H <= 0) return 0;
  if (dtype == kBF16) {
    const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
    const size_t smem = (size_t)(kBQ + 2 * kBK) * (D + 8) * sizeof(bf16);
    const bf16* Q = static_cast<const bf16*>(q);
    const bf16* K = static_cast<const bf16*>(k);
    const bf16* V = static_cast<const bf16*>(v);
    float* L = static_cast<float*>(lse);
#define TPD_FWD_BF16(DD, OF)                                                  \
  {                                                                           \
    auto kern = fwd_bf16<DD, OF>;                                             \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);        \
    if (e != cudaSuccess) return (int)e;                                      \
    kern<<<grid, kThreads, smem, st>>>(Q, K, V, out, L, H, Hkv, Sq, Sk, lo,   \
                                       hi, scale);                            \
    return (int)cudaGetLastError();                                           \
  }
    if (D == 16 && out_f32) TPD_FWD_BF16(16, true)
    if (D == 16) TPD_FWD_BF16(16, false)
    if (D == 32 && out_f32) TPD_FWD_BF16(32, true)
    if (D == 32) TPD_FWD_BF16(32, false)
    if (D == 64 && out_f32) TPD_FWD_BF16(64, true)
    if (D == 64) TPD_FWD_BF16(64, false)
    if (D == 128 && out_f32) TPD_FWD_BF16(128, true)
    if (D == 128) TPD_FWD_BF16(128, false)
#undef TPD_FWD_BF16
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kF32) {
    const dim3 grid((Sq + kSQ - 1) / kSQ, B * H);
    const size_t smem =
        ((size_t)kSQ * D + kSK * (D + 1) + kSK * D + kSQ * kSK + 3 * kSQ) *
        sizeof(float);
    const float* Q = static_cast<const float*>(q);
    const float* K = static_cast<const float*>(k);
    const float* V = static_cast<const float*>(v);
    float* O = static_cast<float*>(out);
    float* L = static_cast<float*>(lse);
#define TPD_FWD_F32(DD)                                                       \
  {                                                                           \
    auto kern = fwd_f32<DD>;                                                  \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);        \
    if (e != cudaSuccess) return (int)e;                                      \
    kern<<<grid, kThreads, smem, st>>>(Q, K, V, O, L, H, Hkv, Sq, Sk, lo, hi, \
                                       scale);                                \
    return (int)cudaGetLastError();                                           \
  }
    if (D == 16) TPD_FWD_F32(16)
    if (D == 32) TPD_FWD_F32(32)
    if (D == 64) TPD_FWD_F32(64)
    if (D == 128) TPD_FWD_F32(128)
#undef TPD_FWD_F32
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
