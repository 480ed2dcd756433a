// Fused sampling prep and the speculative-verify residual prep for Hopper
// (sm_90a).
//
// tpd_fused_sample replaces the Pallas TPU kernel tpudist/ops/fused_sample.py
// (fused_sample_prep, body _sample_kernel): per slot, the grammar allow-row
// mask (finfo(f32).min where disallowed), the greedy arg-max of the masked
// logits (lowest index on ties, a NaN counts as the largest value, as
// jnp.argmax), the temperature scale lg / max(temp, 1e-6) as a true IEEE
// division, then the value-space filters of the scaled row:
//
// - top_k > 0: every value below the k-th largest (duplicates counted, as
//   lax.top_k) becomes finfo(f32).min, so ties at the threshold survive;
// - 0 < top_p < 1: the nucleus.  Over the row sorted in descending order,
//   position i is kept when the softmax mass of positions [0, i) is below
//   top_p (the top token always stays); values below the last kept one
//   become finfo(f32).min.
//
// The filters sort the row in shared memory (bitonic, padded to a power of
// two with -inf), so a row of up to kMaxSortV values fits one CTA; the
// wrapper raises above it.  The softmax mass is a block prefix sum of
// exp(x - max) over the sorted row divided by the total, which rounds in
// another order than a sequential cumsum: a kept set can differ only where
// the mass sits within float rounding of top_p.
//
// Bound on the H100: bytes.  Each logit is read once and written twice with
// a handful of flops, so the time is the [S, V] traffic (plus launch
// latency at serving widths).  One CTA per slot row makes the elementwise
// pass and the arg-max reduction in one read of the row; the sort touches
// shared memory only.
//
// tpd_fused_residual replaces the Pallas TPU kernel
// tpudist/ops/fused_sample.py (fused_residual_prep, body _residual_kernel):
// per (slot, draft position) row of the verify window, with
// t = max(temps[s], 1e-6) and IEEE divisions (no reciprocal multiply),
// pt = softmax(lt / t) and pd = softmax(ld / t) as exp(x - max) / sum with
// expf, and the residual sampling logits log(max(pt - pd, 0) + 1e-30) (logf),
// or lt / t where no residual entry is positive.  "Some entry > 0" is how
// the row's residual sum is tested: a sum of non-negative terms is > 0
// exactly when one term is, whatever the summation order.
//
// Bound on the H100: bytes (two rows read, three written: 20 bytes a vocab
// entry, 160 KB at the serving shape S 8, k 4, V 256 = 0.05 us at 3.35 TB/s),
// so at serving widths the time is the launch.  One CTA per row loops over
// the row for any V: one pass for the two maxima, one for the two sums, one
// that writes pt, pd and the residual logits (rereading lt and ld from L2,
// not keeping the row on chip), and a fourth over the rare row whose
// residual is empty.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSortV = 4096;

// (value, index) order of jnp.argmax: NaN first, then larger, then lower index
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// block-wide sum / count over kThreads threads (red: kThreads/32 floats)
__device__ float block_sum(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(kThreads)
    fused_sample_kernel(const float* logits, const float* temps,
                        const uint8_t* gallow, const int* gidx,
                        const int* gstate, float* masked, float* scaled,
                        int* greedy, int V, int G1, int n_states, int top_k,
                        float top_p) {
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  extern __shared__ float srt[];  // [Vp] sorted row, then [Vp] prefix sums
  const int s = blockIdx.x;
  const float t = fmaxf(temps[s], 1e-6f);
  const float* row = logits + (size_t)s * V;
  const bool use_k = top_k > 0 && top_k < V;
  const bool use_p = top_p > 0.f && top_p < 1.f;
  const bool filter = use_k || use_p;
  int Vp = 1;
  while (Vp < V) Vp <<= 1;
  const uint8_t* allow = nullptr;
  if (gallow) {
    const int gi = min(gidx[s], G1 - 1), gs = min(gstate[s], n_states - 1);
    allow = gallow + ((size_t)gi * n_states + gs) * V;
  }
  float best = -INFINITY;
  int bidx = V;
  for (int v = threadIdx.x; v < Vp; v += blockDim.x) {
    if (v >= V) {
      if (filter) srt[v] = -INFINITY;
      continue;
    }
    float lg = row[v];
    if (allow && !allow[v]) lg = -FLT_MAX;
    masked[(size_t)s * V + v] = lg;
    const float sc = lg / t;
    scaled[(size_t)s * V + v] = sc;
    if (filter) srt[v] = sc;
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
  if (!filter) return;

  // bitonic sort of srt[0, Vp) into descending order
  for (int k = 2; k <= Vp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < Vp; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const float a = srt[i], b = srt[ixj];
          if ((i & k) == 0 ? (a < b) : (a > b)) {
            srt[i] = b;
            srt[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const float neg = -FLT_MAX;
  const float kth = use_k ? srt[top_k - 1] : -INFINITY;
  float cutoff = -INFINITY;
  if (use_p) {
    // the sorted row after the top-k filter stays sorted; its softmax mass
    float* pre = srt + Vp;
    const float top = srt[0] < kth ? neg : srt[0];
    const int per = Vp / kThreads > 0 ? Vp / kThreads : 1;
    const int lo = threadIdx.x * per;
    float run = 0.f;
    for (int i = lo; i < lo + per && i < Vp; ++i) {
      const float x = srt[i] < kth ? neg : srt[i];
      run += i < V ? expf(x - top) : 0.f;
      pre[i] = run;
    }
    // exclusive scan of the per-thread totals
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    __syncthreads();
    if (lane == 31) red_v[warp] = incl;
    __syncthreads();
    float base = incl - run;
    for (int w = 0; w < warp; ++w) base += red_v[w];
    for (int i = lo; i < lo + per && i < Vp; ++i) pre[i] += base;
    __syncthreads();
    const float total = pre[V - 1];
    // kept = 1 + #{j < V - 1 : mass(0..j) < top_p}; the mass is monotone
    float n = 0.f;
    for (int j = threadIdx.x; j < V - 1; j += blockDim.x)
      n += (pre[j] / total < top_p) ? 1.f : 0.f;
    const int keep = 1 + (int)block_sum(n, red_v);
    const float c = srt[keep - 1];
    cutoff = c < kth ? neg : c;
  }
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float sc = scaled[(size_t)s * V + v];
    if (sc < kth) sc = neg;
    if (sc < cutoff) sc = neg;
    scaled[(size_t)s * V + v] = sc;
  }
}


// block-wide max over kThreads threads (red: kThreads/32 floats)
__device__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// element v of a row stored as f32 or bf16
__device__ __forceinline__ float load_row(const void* row, bool bf16, int v) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(row)[v])
              : static_cast<const float*>(row)[v];
}

__global__ void __launch_bounds__(kThreads)
    fused_residual_kernel(const void* lt, const void* ld, const float* temps,
                          float* pt, float* pd, float* lr, int k, int V,
                          int lt_bf16, int ld_bf16) {
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const float t = fmaxf(temps[row / k], 1e-6f);
  const size_t esz_t = lt_bf16 ? 2 : 4, esz_d = ld_bf16 ? 2 : 4;
  const void* rt = static_cast<const char*>(lt) + row * V * esz_t;
  const void* rd = static_cast<const char*>(ld) + row * V * esz_d;
  float* out_t = pt + row * V;
  float* out_d = pd + row * V;
  float* out_r = lr + row * V;
  float mt = -INFINITY, md = -INFINITY;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    mt = fmaxf(mt, load_row(rt, lt_bf16, v) / t);
    md = fmaxf(md, load_row(rd, ld_bf16, v) / t);
  }
  mt = block_max(mt, red);
  md = block_max(md, red);
  float st = 0.f, sd = 0.f;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    st += expf(load_row(rt, lt_bf16, v) / t - mt);
    sd += expf(load_row(rd, ld_bf16, v) / t - md);
  }
  st = block_sum(st, red);
  sd = block_sum(sd, red);
  int has_res = 0;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    const float p = expf(load_row(rt, lt_bf16, v) / t - mt) / st;
    const float q = expf(load_row(rd, ld_bf16, v) / t - md) / sd;
    out_t[v] = p;
    out_d[v] = q;
    const float res = fmaxf(p - q, 0.f);
    has_res |= res > 0.f;
    out_r[v] = logf(res + 1e-30f);
  }
  if (__syncthreads_or(has_res)) return;
  for (int v = threadIdx.x; v < V; v += kThreads)
    out_r[v] = load_row(rt, lt_bf16, v) / t;
}

}  // namespace

extern "C" int tpd_fused_sample(const void* logits, const void* temps,
                                const void* gallow, const void* gidx,
                                const void* gstate, void* masked,
                                void* scaled, void* greedy, int S, int V,
                                int G1, int n_states, int top_k, float top_p,
                                void* stream) {
  const bool filter = (top_k > 0 && top_k < V) || (top_p > 0.f && top_p < 1.f);
  int Vp = 1;
  while (Vp < V) Vp <<= 1;
  if (filter && V > kMaxSortV) return (int)cudaErrorInvalidValue;
  const size_t smem = filter ? 2 * (size_t)Vp * sizeof(float) : 0;
  fused_sample_kernel<<<S, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(temps),
      static_cast<const uint8_t*>(gallow), static_cast<const int*>(gidx),
      static_cast<const int*>(gstate), static_cast<float*>(masked),
      static_cast<float*>(scaled), static_cast<int*>(greedy), V, G1,
      n_states, top_k, top_p);
  return (int)cudaGetLastError();
}

extern "C" int tpd_fused_residual(const void* lt, const void* ld,
                                  const void* temps, void* pt, void* pd,
                                  void* lr, int S, int k, int V, int lt_bf16,
                                  int ld_bf16, void* stream) {
  fused_residual_kernel<<<S * k, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      lt, ld, static_cast<const float*>(temps), static_cast<float*>(pt),
      static_cast<float*>(pd), static_cast<float*>(lr), k, V, lt_bf16,
      ld_bf16);
  return (int)cudaGetLastError();
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
