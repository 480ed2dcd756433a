// LoRA gather-matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/fused_linear.py (lora_delta,
// body _lora_kernel): out[s] = (x[s] · A[layer, id]) · B[layer, id] with
// id = min(ids[s], B - 1), reading each slot's factor block straight from
// the full f32 pools ([L, B, d_in, r] and [L, B, r, d_out]) — no gathered
// copy.  Sentinel ids clamp into a real block; the caller's on-mask select
// discards those lanes.
//
// Rounding follows the Pallas kernel (jnp.dot of compute-dtype operands):
// the f32 factors round to the compute dtype as they load (nearest even);
// the [T, r] intermediate accumulates in f32 and rounds to the compute
// dtype; the second product accumulates in f32 and rounds.
//
// Bound on the H100: bytes.  At rank 8 the work is 2·r flops per x and out
// element, far below the tensor cores' share, and the traffic is x, the
// output tile and each slot's factor blocks.  Design: a CTA owns one slot,
// 16 rows of its T and 256 output columns.  It recomputes the slot's
// [16, r] intermediate (cheap at small r) with the A block staged through
// shared memory in depth chunks, so each CTA reads it from L2 once, and its
// warps split each chunk among them when the rows are few (decode); then
// every thread owns one output column, holds its r B-factor values in
// registers and writes the column's rows.  Products on
// CUDA-core FMAs in f32 for both dtypes (products of bf16 values are exact
// in f32; never TF32).
#include "flash_common.cuh"

namespace {

using tpd_flash::bf16;

constexpr int kThreads = 256;  // 8 warps; one output column per thread
constexpr int kWarps = kThreads / 32;
constexpr int kRowsT = 16;     // rows of T per CTA: at most 2 per warp
constexpr int kColsN = kThreads;

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
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    lora_kernel(const T* x, const float* pool_a, const float* pool_b,
                const int* ids, T* out, int T_len, int d_in, int d_out,
                int B, int layer) {
  // depth rows of A staged per pass: 16 KB of shared memory (8 KB at rank
  // 64, where part[] takes 32 KB)
  constexpr int kChunk = (R >= 64 ? 2048 : 4096) / R;
  __shared__ float as[R * kChunk];  // [r][chunk], rounded to T
  __shared__ float part[kWarps][kRowsT][R];  // per depth slice
  __shared__ float mid[kRowsT][R];
  const int s = blockIdx.y, t0 = blockIdx.z * kRowsT;
  const int rows = min(kRowsT, T_len - t0);
  const int n = blockIdx.x * kColsN + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bid = max(0, min(ids[s], B - 1));
  const float* a = pool_a + ((size_t)layer * B + bid) * d_in * R;
  const float* b = pool_b + ((size_t)layer * B + bid) * R * d_out;

  // x[s] rows t0.. times A, the A block staged through shared memory in
  // depth chunks (read once per CTA).  A warp owns a row pair and a slice
  // of each chunk: with few rows (decode) the 8 warps split the chunk 8
  // ways, with 16 rows each warp takes all of it for its pair.  Lanes
  // stride the slice; then a warp sum, and a sum over the slices.
  const int pairs = (rows + 1) / 2;
  const int p2 = pairs > 4 ? 8 : pairs > 2 ? 4 : pairs > 1 ? 2 : 1;
  const int slices = kWarps / p2;
  const int pair = warp % p2, slice = warp / p2;
  const int r0 = 2 * pair;
  const bool live = pair < pairs, ok1 = r0 + 1 < rows;
  const T* x0 = x + ((size_t)s * T_len + t0 + r0) * d_in;
  const T* x1 = x0 + d_in;
  float acc0[R] = {}, acc1[R] = {};
  for (int k0 = 0; k0 < d_in; k0 += kChunk) {
    const int kc = min(kChunk, d_in - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kc * R; i += kThreads)
      as[(i % R) * kChunk + i / R] = rnd<T>(a[(size_t)k0 * R + i]);
    __syncthreads();
    if (!live) continue;  // warp-uniform
    const int span = (kc + slices - 1) / slices;
    const int kb = slice * span, ke = min(kc, kb + span);
    for (int k = kb + lane; k < ke; k += 32) {
      const float xv0 = to_f(x0[k0 + k]);
      const float xv1 = ok1 ? to_f(x1[k0 + k]) : 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float av = as[j * kChunk + k];
        acc0[j] = fmaf(xv0, av, acc0[j]);
        acc1[j] = fmaf(xv1, av, acc1[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float m0 = tpd_flash::warp_sum(acc0[j]);
    const float m1 = tpd_flash::warp_sum(acc1[j]);
    if (lane == 0 && live) {
      part[slice][r0][j] = m0;
      part[slice][r0 + 1][j] = m1;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * R; i += kThreads) {
    const int r = i / R, j = i % R;
    float m = 0.f;
    for (int sl = 0; sl < slices; ++sl) m += part[sl][r][j];
    mid[r][j] = rnd<T>(m);
  }
  __syncthreads();
  if (n >= d_out) return;
  float bv[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    bv[j] = rnd<T>(__ldg(b + (size_t)j * d_out + n));
  T* o = out + ((size_t)s * T_len + t0) * d_out + n;
  for (int r = 0; r < rows; ++r) {
    float y = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) y = fmaf(mid[r][j], bv[j], y);
    o[(size_t)r * d_out] = from_f<T>(y);
  }
}

template <typename T>
int launch(const void* x, const void* pool_a, const void* pool_b,
           const void* ids, void* out, int S, int T_len, int d_in, int d_out,
           int B, int r, int layer, cudaStream_t st) {
  dim3 grid((d_out + kColsN - 1) / kColsN, S, (T_len + kRowsT - 1) / kRowsT);
  const T* xp = static_cast<const T*>(x);
  const float* pa = static_cast<const float*>(pool_a);
  const float* pb = static_cast<const float*>(pool_b);
  const int* ip = static_cast<const int*>(ids);
  T* op = static_cast<T*>(out);
#define TPD_LORA(RR)                                                     \
  case RR:                                                               \
    lora_kernel<T, RR><<<grid, kThreads, 0, st>>>(xp, pa, pb, ip, op,    \
                                                  T_len, d_in, d_out, B, \
                                                  layer);                \
    break;
  switch (r) {
    TPD_LORA(1)
    TPD_LORA(2)
    TPD_LORA(4)
    TPD_LORA(8)
    TPD_LORA(16)
    TPD_LORA(32)
    TPD_LORA(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TPD_LORA
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16; r one of 1, 2, 4, 8, 16, 32, 64 (the wrapper
// checks).
extern "C" int tpd_lora_delta(const void* x, const void* pool_a,
                              const void* pool_b, const void* ids, void* out,
                              int S, int T, int d_in, int d_out, int B, int r,
                              int layer, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tpd_flash::kBF16)
    return launch<bf16>(x, pool_a, pool_b, ids, out, S, T, d_in, d_out, B, r,
                        layer, st);
  return launch<float>(x, pool_a, pool_b, ids, out, S, T, d_in, d_out, B, r,
                       layer, st);
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
