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
// 128 wide.  Here the weights come packed (ops/fused_mlp.py pack_params: per
// layer W [pad2(d_in), pad2(d_out)] row-major, then b [pad2(d_out)], one
// contiguous f32 buffer whose length is a multiple of 4), every width padded
// to an even number with zero rows, columns and biases.  That padding is
// exact: a padded input lane is zero, its weights are zero and leaky(0) = 0,
// so the extra lanes stay zero through every layer.  The true widths come
// by value (Dims) for the first kDimsCap layers and from the device table
// only past them, so nothing waits on a global read before the loads start.
//
// Bound on the H100: operations.  The toy model (2→10→10→10→10→1) does 660
// flops a row against 12 bytes of x and out a row, 55 flops a byte, far
// above the 20 flops a byte where f32 CUDA cores (67 TFLOP/s) overtake HBM
// (3.35 TB/s); at batch 4096 the whole call is 2.7 MFLOP, so the launch and
// one chain of loads set its time.  Two arms (the wrapper's plan picks one
// and sizes the grid):
//
// - small (every padded width <= 32, the toy): each thread owns R rows
//   (rows tid, tid + blockDim, ... of a tile; a CTA walks tiles
//   blockIdx.x, + gridDim.x, ...) and keeps their activations in registers
//   from input to output; every weight it reads from shared memory (a
//   float2, broadcast across the warp) feeds 2R FMAs.  Inner loops run over
//   the exact padded widths: the output width is a template argument (a
//   switch per layer) and the depth loop leaves at the padded input width,
//   each step's weights loaded during the step before.  Every layer's
//   weights reach shared memory in one wave of 16-byte loads issued before
//   the x loads (one layer at a time when they pass 48 KB).  The plan gives
//   a CTA few rows at small batches (32 at batch 4096, one warp) so the
//   grid spreads over the SMs, and R = 4 where there are rows enough to
//   fill the card four warps deep; then as many CTAs as the card holds at
//   once walk the tiles, each bringing the next tile's x into shared
//   memory by cp.async while it computes one (at 2^20 rows the x stream,
//   waited for tile by tile, had cost more than three layers).
// - wide (any padded width 33-128): a CTA owns a tile of 32 or 64 rows
//   whose activations stay in shared memory ([rows][132] f32, two tiles in
//   turn) from the first layer to the last.  Each layer is a [rows, 128] x
//   [128, 128] product: 128 threads, each a register micro-tile of TM rows
//   (tr, tr + 8, ...) by 8 columns (tc*4.., 64 + tc*4..), activations and
//   weights read as float4.  The next layer's weights arrive by cp.async
//   (zero-filled past the padded widths) into the other of two 64.5 KB
//   buffers while this layer computes: 2 x 32 KB + 2 x 64.5 KB = 195 KB at
//   64 rows, one CTA an SM.  The plan takes 64-row tiles where they still
//   give every SM a CTA, else 32.
//
// Rows past the batch are computed on zeros and never stored, so any batch
// size works.
#include <cuda_runtime.h>

#include <climits>
#include <stdint.h>

namespace {

constexpr int kDimsCap = 32;       // layers whose widths come by value
constexpr int kAllFloats = 12288;  // small arm: 48 KB, every layer at once
constexpr int kSmallMax = 32;      // the small arm's widest padded layer
constexpr int kMaxThreads = 128;
constexpr int kLane = 128;                    // the wide arm's tile width
constexpr int kActLd = kLane + 4;             // activation row stride
constexpr int kWLayer = kLane * kLane + kLane;  // a staged layer, floats
constexpr float kSlope = 0.01f;  // NEGATIVE_SLOPE, torch's LeakyReLU default

struct Dims {
  int n_layers;
  unsigned char w[kDimsCap + 1];  // true widths of layers 0..kDimsCap
};

// h >= 0 ? h : kSlope * h, bit for bit (NaN stays NaN), in two operations
__device__ __forceinline__ float leaky(float h) {
  return fmaxf(h, kSlope * h);
}

__device__ __forceinline__ int pad2(int w) { return w + (w & 1); }

// Copy the by-value widths to shared memory (static indices: no local
// copy of the parameter struct); the caller syncs before reading them.
__device__ __forceinline__ void widths_to_smem(const Dims& d, int* s_w) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kDimsCap; ++i) s_w[i] = d.w[i];
  }
}

__device__ __forceinline__ int width_of(const int* s_w, const int* table,
                                        int i) {
  return i <= kDimsCap ? s_w[i] : __ldg(table + i);
}

// cp.async of 4, 8 or 16 bytes, zero-filled where ok is false
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool ok) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     addr),
                 "l"(gmem), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     addr),
                 "l"(gmem), "n"(N), "r"(ok ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One layer of the small arm: h[r][0..DOUT) = act(h[r][0..dinp) · W + b),
// W [dinp][DOUT] and b [DOUT] in shared memory.  The depth loop is
// unrolled: over DIN steps when the template fixes it (a square layer of
// the 16-wide instantiations, the toy's hidden layers), else
// leaving at the padded input width (a uniform branch a step).  Each float2
// weight load, broadcast across the warp, feeds 2R FMAs.  A step's weight
// row is loaded during the step before it, across the branch, so no step
// waits on shared memory (past the last row the load reads the bias: inside
// the layer, never used).
template <int CN, int R, int DOUT, int DIN>
__device__ __forceinline__ void small_layer(float (&h)[R][CN],
                                            const float* w, int dinp,
                                            bool last) {
  float acc[R][DOUT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < DOUT; ++j) acc[r][j] = 0.f;
  const float2* w2 = reinterpret_cast<const float2*>(w);
  float2 wn[DOUT / 2];
#pragma unroll
  for (int j = 0; j < DOUT / 2; ++j) wn[j] = w2[j];
#pragma unroll
  for (int k = 0; k < (DIN ? DIN : CN); ++k) {
    if (!DIN && k >= dinp) break;  // uniform: the padded input width
    float2 wv[DOUT / 2];
#pragma unroll
    for (int j = 0; j < DOUT / 2; ++j) {
      wv[j] = wn[j];
      wn[j] = w2[(k + 1) * (DOUT / 2) + j];
    }
#pragma unroll
    for (int j = 0; j < DOUT / 2; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][2 * j] = fmaf(h[r][k], wv[j].x, acc[r][2 * j]);
        acc[r][2 * j + 1] = fmaf(h[r][k], wv[j].y, acc[r][2 * j + 1]);
      }
    }
  }
  const float* b = w + dinp * DOUT;
  if (last) {
#pragma unroll
    for (int j = 0; j < DOUT; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) h[r][j] = acc[r][j] + b[j];
  } else {
#pragma unroll
    for (int j = 0; j < DOUT; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) h[r][j] = leaky(acc[r][j] + b[j]);
  }
}

template <int CN, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
    mlp_small(const float* __restrict__ x, const float* __restrict__ params,
              const int* __restrict__ table, float* __restrict__ out,
              long long batch, int rows_per_cta, int total_floats,
              int all_layers, int x_off, const Dims dims) {
  // the weights, then (for a grid that walks several tiles) the x of two
  // row tiles from float x_off
  extern __shared__ __align__(16) float wsm[];
  __shared__ int s_w[kDimsCap + 1];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long tiles = (batch + rows_per_cta - 1) / rows_per_cta;
  const int d_in = dims.w[0], n_layers = dims.n_layers;
  const int tile_floats = rows_per_cta * d_in;

  // every layer's weights: the first wave of 16-byte loads in flight
  // before the first tile's x loads, stored to shared memory after them
  constexpr int kWave = 4;
  const float4* src = reinterpret_cast<const float4*>(params);
  const int n4 = all_layers ? total_floats / 4 : 0;
  float4 wv[kWave];
#pragma unroll
  for (int q = 0; q < kWave; ++q)
    if (tid + q * nt < n4) wv[q] = __ldg(src + tid + q * nt);

  // a CTA walks the row tiles blockIdx.x, + gridDim.x, ...; thread tid
  // owns rows tid, tid + nt, ... of a tile
  float h[R][CN];
  bool live[R];
  long long tile = blockIdx.x;
  auto load_x = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int lr = tid + i * nt;
      const long long row = tile * rows_per_cta + lr;
      live[i] = lr < rows_per_cta && row < batch;
#pragma unroll
      for (int k = 0; k < CN; ++k) h[i][k] = 0.f;
#pragma unroll
      for (int k = 0; k < CN; ++k) {  // the first layer reads pad2(d_in)
        if (k >= d_in) break;
        if (live[i]) h[i][k] = __ldg(x + row * d_in + k);
      }
    }
  };
  load_x();
  // a CTA with more tiles to walk brings the next tile's x into shared
  // memory (cp.async, zero past the batch) while it computes this one
  auto prefetch_x = [&](long long t, float* buf) {
    const long long first = t * rows_per_cta * d_in;
    const long long end = batch * d_in;
    for (int i = tid; i < tile_floats; i += nt)
      cp_async<4>(buf + i, first + i < end ? x + first + i : x,
                  first + i < end);
    cp_async_commit();
  };
  if (tile + gridDim.x < tiles) prefetch_x(tile + gridDim.x, wsm + x_off);
  float4* dst = reinterpret_cast<float4*>(wsm);
#pragma unroll
  for (int q = 0; q < kWave; ++q)
    if (tid + q * nt < n4) dst[tid + q * nt] = wv[q];
  for (int i = tid + kWave * nt; i < n4; i += nt) dst[i] = __ldg(src + i);
  widths_to_smem(dims, s_w);
  __syncthreads();

  for (int it = 0; tile < tiles;) {
    int off = 0, din = d_in;
    for (int l = 0; l < n_layers; ++l) {
      const int dout = width_of(s_w, table, l + 1);
      const int dinp = pad2(din), doutp = pad2(dout);
      const int nw = dinp * doutp + doutp;
      const float* w = wsm + (all_layers ? off : 0);
      if (!all_layers) {
        __syncthreads();  // every thread is done with the previous layer
        const float2* s2 = reinterpret_cast<const float2*>(params + off);
        float2* d2 = reinterpret_cast<float2*>(wsm);
        for (int i = tid; i < nw / 2; i += nt) d2[i] = __ldg(s2 + i);
        __syncthreads();
      }
      const bool last = l + 1 == n_layers;
      switch (doutp) {
#define TPD_MLP_CASE(D)                              \
  case D:                                            \
    if constexpr (D <= CN) {                         \
      if (CN == 16 && dinp == D)                     \
        small_layer<CN, R, D, D>(h, w, dinp, last);  \
      else                                           \
        small_layer<CN, R, D, 0>(h, w, dinp, last);  \
    }                                                \
    break;
        TPD_MLP_CASE(2)
        TPD_MLP_CASE(4)
        TPD_MLP_CASE(6)
        TPD_MLP_CASE(8)
        TPD_MLP_CASE(10)
        TPD_MLP_CASE(12)
        TPD_MLP_CASE(14)
        TPD_MLP_CASE(16)
        TPD_MLP_CASE(18)
        TPD_MLP_CASE(20)
        TPD_MLP_CASE(22)
        TPD_MLP_CASE(24)
        TPD_MLP_CASE(26)
        TPD_MLP_CASE(28)
        TPD_MLP_CASE(30)
        TPD_MLP_CASE(32)
#undef TPD_MLP_CASE
        default:
          break;
      }
      off += nw;
      din = dout;
    }
    const int d_out = din;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!live[i]) continue;
      float* o = out + (tile * rows_per_cta + tid + i * nt) * d_out;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        if (j >= d_out) break;
        o[j] = h[i][j];
      }
    }
    tile += gridDim.x;
    if (tile >= tiles) break;
    cp_async_wait<0>();
    __syncthreads();  // the tile's x is in; every thread read the other
    const float* xs = wsm + x_off + (it & 1) * tile_floats;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int lr = tid + i * nt;
      live[i] = lr < rows_per_cta && tile * rows_per_cta + lr < batch;
#pragma unroll
      for (int k = 0; k < CN; ++k) {  // zero past the batch and d_in
        if (k >= pad2(d_in)) break;
        h[i][k] = k < d_in && lr < rows_per_cta ? xs[lr * d_in + k] : 0.f;
      }
    }
    if (tile + gridDim.x < tiles)
      prefetch_x(tile + gridDim.x, wsm + x_off + ((it + 1) & 1) * tile_floats);
    ++it;
  }
}

// Stage one layer of the wide arm, in N-float chunks, into a [128][128] +
// [128] buffer: rows k below the input width rounded up to 4 (the depth
// loop's reach), all 128 columns, zero past the padded widths.
template <int N>
__device__ __forceinline__ void stage_chunks(float* buf, const float* w,
                                             int dinp, int doutp, int k4) {
  constexpr int kPer = kLane / N;  // chunks a row
  const int chunks = k4 * kPer;
  for (int i = threadIdx.x; i < chunks + kPer; i += kMaxThreads) {
    if (i < chunks) {
      const int k = i / kPer, c = N * (i % kPer);
      const bool ok = k < dinp && c < doutp;
      cp_async<4 * N>(buf + k * kLane + c, ok ? w + k * doutp + c : w, ok);
    } else {  // the bias
      const int c = N * (i - chunks);
      const bool ok = c < doutp;
      cp_async<4 * N>(buf + kLane * kLane + c,
                      ok ? w + dinp * doutp + c : w, ok);
    }
  }
}

// 16-byte chunks where the layer's rows allow (an output width that is a
// multiple of 4 at an offset that is one), else 8-byte chunks.
__device__ __forceinline__ void stage_wide(float* buf, const float* params,
                                           int off, int din, int dout) {
  const int dinp = pad2(din), doutp = pad2(dout), k4 = (din + 3) & ~3;
  if (doutp % 4 == 0 && off % 4 == 0)
    stage_chunks<4>(buf, params + off, dinp, doutp, k4);
  else
    stage_chunks<2>(buf, params + off, dinp, doutp, k4);
}

template <int TM>
__global__ void __launch_bounds__(kMaxThreads, 1)
    mlp_wide(const float* __restrict__ x, const float* __restrict__ params,
             const int* __restrict__ table, float* __restrict__ out,
             long long batch, const Dims dims) {
  constexpr int kRows = 8 * TM;
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_w[kDimsCap + 1];
  float* const act0 = sm;
  float* const act1 = sm + kRows * kActLd;
  float* const wb0 = sm + 2 * kRows * kActLd;
  float* const wb1 = wb0 + kWLayer;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int d_in = dims.w[0], n_layers = dims.n_layers;

  {  // the x tile (columns up to the first depth loop's reach) and W_0
    const int k4 = (d_in + 3) & ~3;
    for (int i = tid; i < kRows * k4; i += kMaxThreads) {
      const int r = i / k4, k = i % k4;
      const long long row = row0 + r;
      const bool ok = row < batch && k < d_in;
      cp_async<4>(act0 + r * kActLd + k, ok ? x + row * d_in + k : x, ok);
    }
    stage_wide(wb0, params, 0, d_in, dims.w[1]);
    cp_async_commit();
  }
  widths_to_smem(dims, s_w);
  __syncthreads();

  int off = 0, din = d_in;
  for (int l = 0; l < n_layers; ++l) {
    const int dout = width_of(s_w, table, l + 1);
    const int next = off + pad2(din) * pad2(dout) + pad2(dout);
    const bool last = l + 1 == n_layers;
    if (!last) {
      stage_wide((l & 1) ? wb0 : wb1, params, next, dout,
                 width_of(s_w, table, l + 2));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this layer's weights (and x) are in
    const float* a = (l & 1) ? act1 : act0;
    const float* w = (l & 1) ? wb1 : wb0;
    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    // register double buffer: the next 4-deep step's fragments load while
    // this one's 32·TM FMAs run
    float4 av[2][TM], wf[2][8];
    auto load_frag = [&](float4(&af)[TM], float4(&wq)[8], int k) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        af[i] =
            *reinterpret_cast<const float4*>(a + (tr + 8 * i) * kActLd + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = w + (k + kk) * kLane + tc * 4;
        wq[2 * kk] = *reinterpret_cast<const float4*>(wr);
        wq[2 * kk + 1] = *reinterpret_cast<const float4*>(wr + 64);
      }
    };
    auto step = [&](const float4(&af)[TM], const float4(&wq)[8]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w0 = wq[2 * kk], w1 = wq[2 * kk + 1];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float hv = kk == 0   ? af[i].x
                           : kk == 1 ? af[i].y
                           : kk == 2 ? af[i].z
                                     : af[i].w;
          acc[i][0] = fmaf(hv, w0.x, acc[i][0]);
          acc[i][1] = fmaf(hv, w0.y, acc[i][1]);
          acc[i][2] = fmaf(hv, w0.z, acc[i][2]);
          acc[i][3] = fmaf(hv, w0.w, acc[i][3]);
          acc[i][4] = fmaf(hv, w1.x, acc[i][4]);
          acc[i][5] = fmaf(hv, w1.y, acc[i][5]);
          acc[i][6] = fmaf(hv, w1.z, acc[i][6]);
          acc[i][7] = fmaf(hv, w1.w, acc[i][7]);
        }
      }
    };
    const int k4 = (din + 3) & ~3;
    load_frag(av[0], wf[0], 0);
    for (int k = 0; k < k4; k += 8) {
      if (k + 4 < k4) load_frag(av[1], wf[1], k + 4);
      step(av[0], wf[0]);
      if (k + 4 >= k4) break;
      if (k + 8 < k4) load_frag(av[0], wf[0], k + 8);
      step(av[1], wf[1]);
    }
    const float* b = w + kLane * kLane;
    float bv[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b[tc * 4 + j];
      bv[4 + j] = b[64 + tc * 4 + j];
    }
    if (!last) {
      float* an = (l & 1) ? act0 : act1;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = leaky(acc[i][j] + bv[j]);
        float* ar = an + (tr + 8 * i) * kActLd + tc * 4;
        *reinterpret_cast<float4*>(ar) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(ar + 64) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long row = row0 + tr + 8 * i;
        if (row >= batch) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = (j < 4 ? 0 : 64) + tc * 4 + (j & 3);
          if (c < dout) out[row * dout + c] = acc[i][j] + bv[j];
        }
      }
    }
    __syncthreads();  // every read of this layer's tiles is done
    off = next;
    din = dout;
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int CN, int R>
int launch_small(const float* x, const float* p, const int* t, float* o,
                 long long batch, int rows_per_cta, int threads,
                 long long blocks, int total_floats, int w_floats, int smem,
                 const Dims& dims, cudaStream_t st) {
  const int all = total_floats <= kAllFloats;
  const int w_off = all ? total_floats : w_floats;  // floats of weights
  if (smem < 4 * w_off) return (int)cudaErrorInvalidValue;
  if (const int e = set_smem((const void*)mlp_small<CN, R>, smem)) return e;
  if (smem >= 4 * (w_off + 2 * rows_per_cta * dims.w[0])) {
    // room for the x of two tiles (the plan gives it at R > 1): a grid of
    // the CTAs the card holds at once walks the tiles
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, mlp_small<CN, R>, threads, smem) != cudaSuccess)
      return (int)cudaGetLastError();
    blocks = blocks < (long long)sms * per_sm ? blocks
                                              : (long long)sms * per_sm;
  } else if (blocks < (batch + rows_per_cta - 1) / rows_per_cta) {
    return (int)cudaErrorInvalidValue;  // a CTA a tile without that room
  }
  mlp_small<CN, R><<<(unsigned)blocks, threads, smem, st>>>(
      x, p, t, o, batch, rows_per_cta, total_floats, all, w_off, dims);
  return (int)cudaGetLastError();
}

template <int TM>
int launch_wide(const float* x, const float* p, const int* t, float* o,
                long long batch, long long blocks, int smem, const Dims& dims,
                cudaStream_t st) {
  if (const int e = set_smem((const void*)mlp_wide<TM>, smem)) return e;
  mlp_wide<TM><<<(unsigned)blocks, kMaxThreads, smem, st>>>(x, p, t, o,
                                                            batch, dims);
  return (int)cudaGetLastError();
}

}  // namespace

// One call's launch: the wrapper's plan (ops/fused_mlp.py _mlp_plan, built
// once a weight set and batch and passed by pointer, so a call converts
// few arguments): arm 0 small (cn 16 or 32, r rows a thread 1, 2 or 4 and
// 1 or 2 at cn 32, threads a multiple of 32 up to 128, rows_per_cta <=
// threads * r) or 1 wide (r = TM 4 or 8); smem the dynamic shared memory;
// the true widths of layers 0..kDimsCap (past them the kernel reads the
// device table).  Field for field ops/fused_mlp.py MlpLaunch.
struct MlpLaunch {
  long long batch, blocks;
  int n_layers, arm, cn, r, threads, rows_per_cta, total_floats, w_floats,
      smem;
  int widths[kDimsCap + 1];
};

// x [batch, widths[0]] f32, params packed as the header says
// (total_floats long, w_floats the longest layer's share), table the true
// widths on the device [n_layers + 1]; out [batch, widths[n_layers]] f32.
// The wrapper checks every argument; this checks the plan against what is
// built.
extern "C" int tpd_fused_mlp(const void* x, const void* params,
                             const void* table, void* out,
                             const MlpLaunch* plan, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* pp = static_cast<const float*>(params);
  const int* tp = static_cast<const int*>(table);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MlpLaunch& p = *plan;
  if (p.batch <= 0 || p.n_layers <= 0 || p.blocks <= 0 ||
      p.blocks > INT_MAX || p.total_floats % 4 || p.w_floats % 2 ||
      reinterpret_cast<uintptr_t>(params) % 16)
    return (int)cudaErrorInvalidValue;
  Dims dims{};
  dims.n_layers = p.n_layers;
  for (int i = 0; i <= p.n_layers && i <= kDimsCap; ++i) {
    if (p.widths[i] < 1 || p.widths[i] > kLane)
      return (int)cudaErrorInvalidValue;
    dims.w[i] = (unsigned char)p.widths[i];
  }
  if (p.arm == 1) {
    if (p.r == 4)
      return launch_wide<4>(xp, pp, tp, op, p.batch, p.blocks, p.smem, dims,
                            st);
    if (p.r == 8)
      return launch_wide<8>(xp, pp, tp, op, p.batch, p.blocks, p.smem, dims,
                            st);
    return (int)cudaErrorInvalidValue;
  }
  if (p.arm != 0 || p.threads < 32 || p.threads > kMaxThreads ||
      p.threads % 32 || p.rows_per_cta < 1 ||
      p.rows_per_cta > p.threads * p.r || p.cn > kSmallMax)
    return (int)cudaErrorInvalidValue;
#define TPD_SMALL(CN, R)                                                  \
  if (p.cn == CN && p.r == R)                                             \
    return launch_small<CN, R>(xp, pp, tp, op, p.batch, p.rows_per_cta,   \
                               p.threads, p.blocks, p.total_floats,       \
                               p.w_floats, p.smem, dims, st);
  TPD_SMALL(16, 1)
  TPD_SMALL(16, 2)
  TPD_SMALL(16, 4)
  TPD_SMALL(32, 1)
  TPD_SMALL(32, 2)
#undef TPD_SMALL
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
