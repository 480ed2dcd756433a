// Fused MLP forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/fused_mlp.py (fused_mlp, body
// _fused_kernel): h = x, then h = leaky(h · W_i + b_i) for every layer but
// the last, which has no activation; leaky(h) = h >= 0 ? h : 0.01f * h, as
// jnp.where(x >= 0, x, NEGATIVE_SLOPE * x) writes it.  f32 throughout, every
// product a full-f32 FMA on the CUDA cores (the Pallas kernel's
// Precision.HIGHEST: no TF32, no bf16 passes); each output column sums its
// products in order of k from 0, then adds the bias, as `h @ w + b` does.
//
// The TPU kernel pads every layer to a [128, 128] tile because the MXU is
// 128 wide.  Here the weights come packed at their true widths
// (ops/fused_mlp.py pack_params: per layer W [d_in, d_out] row-major, then
// b [d_out], one contiguous f32 buffer) with the widths in a device int32
// table of n_layers + 1 entries, every width at most 128.
//
// Bound on the H100: operations.  The toy model (2→10→10→10→10→1) does 660
// flops a row against 12 bytes of x and out a row, 55 flops a byte, far
// above the 20 flops a byte where f32 CUDA cores (67 TFLOP/s) overtake HBM
// (3.35 TB/s); at batch 4096 the whole call is 2.7 MFLOP, so the launch
// sets its time.  Design: a CTA of 128 threads owns a tile of rows and TPR
// threads share a row, thread s of a row computing columns s, s + TPR, ...
// (at most CN of them) of every layer.  The weights sit in shared memory,
// every layer at once when the packed buffer fits kAllFloats (the toy
// model's 371 floats), else one layer at a time (64.5 KB at 128 wide).
// Each row's activations stay on the chip from input to output: in the
// thread's registers when one thread owns a row (widths up to 32), else in
// the CTA's two ping-pong shared-memory tiles.  Only x is read from device
// memory and only the last layer's output is written.  Rows past the batch
// are computed on zeros and never stored, so any batch size works.  Each
// FMA reads its weight from shared memory, one load (a broadcast across the
// warp) per FMA.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kAllFloats = 12288;  // 48 KB: stage every layer at once
constexpr float kSlope = 0.01f;    // NEGATIVE_SLOPE, torch's LeakyReLU default

__device__ __forceinline__ float leaky(float h) {
  return h >= 0.f ? h : kSlope * h;
}

// Copy n floats of the packed weights into shared memory.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <int CN, int TPR>
__global__ void __launch_bounds__(kThreads)
    mlp_kernel(const float* __restrict__ x, const float* __restrict__ params,
               const int* __restrict__ widths, float* __restrict__ out,
               long long batch, int n_layers, int total_floats,
               int all_layers) {
  constexpr int kRows = kThreads / TPR;
  constexpr int kLda = CN * TPR + 1;  // odd row stride: no bank conflicts
  extern __shared__ float smem[];
  float* a_in = smem;                  // [kRows][kLda] when TPR > 1
  float* a_out = smem + kRows * kLda;  // [kRows][kLda] when TPR > 1
  float* wbuf = smem + (TPR > 1 ? 2 * kRows * kLda : 0);
  const int r = threadIdx.x / TPR, s = threadIdx.x % TPR;
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long row = row0 + r;
  const int d_in = widths[0];

  if (all_layers) stage(wbuf, params, total_floats);
  [[maybe_unused]] float h[TPR == 1 ? CN : 1];  // the row's activations
  if constexpr (TPR == 1) {
#pragma unroll
    for (int k = 0; k < CN; ++k)
      h[k] = (k < d_in && row < batch) ? x[row * d_in + k] : 0.f;
  } else {
    for (int i = threadIdx.x; i < kRows * d_in; i += kThreads) {
      const int rr = i / d_in, k = i % d_in;
      a_in[rr * kLda + k] =
          row0 + rr < batch ? x[(row0 + rr) * d_in + k] : 0.f;
    }
  }
  __syncthreads();

  long long off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int din = widths[l], dout = widths[l + 1];
    const int nw = din * dout + dout;
    const float* w = wbuf + (all_layers ? off : 0);
    if (!all_layers) {
      __syncthreads();  // every thread is done with the previous weights
      stage(wbuf, params + off, nw);
      __syncthreads();
    }
    const float* b = w + din * dout;
    const bool last = l + 1 == n_layers;
    float acc[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[j] = 0.f;
    if constexpr (TPR == 1) {
#pragma unroll
      for (int k = 0; k < CN; ++k) {
        if (k < din) {
          const float hk = h[k];
          const float* wr = w + k * dout;
#pragma unroll
          for (int j = 0; j < CN; ++j)
            if (j < dout) acc[j] = fmaf(hk, wr[j], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float v = j < dout ? acc[j] + b[j] : 0.f;
        h[j] = last ? v : leaky(v);
      }
    } else {
      for (int k = 0; k < din; ++k) {
        const float hk = a_in[r * kLda + k];
        const float* wr = w + k * dout + s;
#pragma unroll
        for (int j = 0; j < CN; ++j)
          if (s + TPR * j < dout) acc[j] = fmaf(hk, wr[TPR * j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = s + TPR * j;
        if (c >= dout) continue;
        const float v = acc[j] + b[c];
        if (!last)
          a_out[r * kLda + c] = leaky(v);
        else if (row < batch)
          out[row * dout + c] = v;
      }
      float* t = a_in;
      a_in = a_out;
      a_out = t;
      __syncthreads();
    }
    off += nw;
  }
  if constexpr (TPR == 1) {
    const int d_out = widths[n_layers];
    if (row < batch) {
#pragma unroll
      for (int j = 0; j < CN; ++j)
        if (j < d_out) out[row * d_out + j] = h[j];
    }
  }
}

template <int CN, int TPR>
int launch(const float* x, const float* params, const int* widths,
           float* out, long long batch, int n_layers, int total_floats,
           int max_layer_floats, cudaStream_t st) {
  constexpr int kRows = kThreads / TPR;
  const int all_layers = total_floats <= kAllFloats;
  const size_t act =
      TPR > 1 ? 2 * (size_t)kRows * (CN * TPR + 1) * sizeof(float) : 0;
  const size_t bytes =
      act + (size_t)(all_layers ? total_floats : max_layer_floats) *
                sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_kernel<CN, TPR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (batch + kRows - 1) / kRows;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  mlp_kernel<CN, TPR><<<(unsigned)blocks, kThreads, bytes, st>>>(
      x, params, widths, out, batch, n_layers, total_floats, all_layers);
  return (int)cudaGetLastError();
}

}  // namespace

// x [batch, widths[0]] f32, params packed as the header says, widths a
// device int32 table [n_layers + 1]; max_width the largest entry of the
// table (at most 128), total_floats the packed buffer's length and
// max_layer_floats the longest layer's share of it.  out [batch,
// widths[n_layers]] f32.  The wrapper checks every argument.
extern "C" int tpd_fused_mlp(const void* x, const void* params,
                             const void* widths, void* out, long long batch,
                             int n_layers, int max_width, int total_floats,
                             int max_layer_floats, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* pp = static_cast<const float*>(params);
  const int* wp = static_cast<const int*>(widths);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n_layers <= 0 || max_width <= 0 || max_width > 128)
    return (int)cudaErrorInvalidValue;
  if (max_width <= 16)
    return launch<16, 1>(xp, pp, wp, op, batch, n_layers, total_floats,
                         max_layer_floats, st);
  if (max_width <= 32)
    return launch<32, 1>(xp, pp, wp, op, batch, n_layers, total_floats,
                         max_layer_floats, st);
  if (max_width <= 64)
    return launch<32, 2>(xp, pp, wp, op, batch, n_layers, total_floats,
                         max_layer_floats, st);
  return launch<32, 4>(xp, pp, wp, op, batch, n_layers, total_floats,
                       max_layer_floats, st);
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
