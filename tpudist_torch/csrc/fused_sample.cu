// Fused sampling prep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/fused_sample.py
// (fused_sample_prep, body _sample_kernel) for top_k = 0 and top_p = 0:
// per slot, the grammar allow-row mask (finfo(f32).min where disallowed),
// the greedy arg-max of the masked logits (lowest index on ties, a NaN
// counts as the largest value, as jnp.argmax), and the temperature scale
// lg / max(temp, 1e-6) as a true IEEE division.
//
// Bound on the H100: bytes.  Each logit is read once and written twice with
// a handful of flops, so the time is the [S, V] traffic (plus launch
// latency at serving widths).  One CTA per slot row makes the elementwise
// pass and the arg-max reduction in one read of the row.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// (value, index) order of jnp.argmax: NaN first, then larger, then lower index
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

__global__ void __launch_bounds__(kThreads)
    fused_sample_kernel(const float* logits, const float* temps,
                        const uint8_t* gallow, const int* gidx,
                        const int* gstate, float* masked, float* scaled,
                        int* greedy, int V, int G1, int n_states) {
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  const int s = blockIdx.x;
  const float t = fmaxf(temps[s], 1e-6f);
  const float* row = logits + (size_t)s * V;
  const uint8_t* allow = nullptr;
  if (gallow) {
    const int gi = min(gidx[s], G1 - 1), gs = min(gstate[s], n_states - 1);
    allow = gallow + ((size_t)gi * n_states + gs) * V;
  }
  float best = -INFINITY;
  int bidx = V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float lg = row[v];
    if (allow && !allow[v]) lg = -FLT_MAX;
    masked[(size_t)s * V + v] = lg;
    scaled[(size_t)s * V + v] = lg / t;
    if (better(lg, v, best, bidx)) {
      best = lg;
      bidx = v;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (better(ov, oi, best, bidx)) {
      best = ov;
      bidx = oi;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x / 32); ++w)
      if (better(red_v[w], red_i[w], best, bidx)) {
        best = red_v[w];
        bidx = red_i[w];
      }
    greedy[s] = bidx;
  }
}

}  // namespace

extern "C" int tpd_fused_sample(const void* logits, const void* temps,
                                const void* gallow, const void* gidx,
                                const void* gstate, void* masked,
                                void* scaled, void* greedy, int S, int V,
                                int G1, int n_states, void* stream) {
  fused_sample_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(temps),
      static_cast<const uint8_t*>(gallow), static_cast<const int*>(gidx),
      static_cast<const int*>(gstate), static_cast<float*>(masked),
      static_cast<float*>(scaled), static_cast<int*>(greedy), V, G1,
      n_states);
  return (int)cudaGetLastError();
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
