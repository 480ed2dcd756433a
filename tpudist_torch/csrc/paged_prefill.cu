// Paged prefill attention with block writes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/paged_prefill.py
// (paged_prefill_attention, body _kernel).  Two launches on one stream:
//
// 1. attention: one CTA per (slot, kv head) walks the reused prefix out of
//    the pool, then attends the chunk to itself under the causal mask as
//    the walk's last virtual block (the decode kernel's code with s = P,
//    fill = 0 and the chunk as the fresh block);
// 2. block writes: one CTA per (slot, touched block, kv head) reads the
//    block's original contents, overlays the chunk's K/V at positions
//    [pos0, pos0 + clen), and requantizes with amax / 127 (round half to
//    even, true division), writing SEPARATE outputs.  The pool is never
//    written in place here: a lane's partially filled first block is read
//    by the prefix walk of launch 1 and rewritten by launch 2, and CTAs run
//    in no order, so in-place writes would race.  The caller commits the
//    outputs with _Paged.commit_quantized.
//
// Bound on the H100: bytes.  At the main path's chunk of 64 tokens the
// attention does 4 * 64 flops per K/V element against 2 bytes of bf16, ~128
// flops per byte, under the ~295 flops/byte ridge; the writes are pure
// data movement.  The design reads the live prefix once per kv head group
// (never a dense view), reads each touched block once more for the merge,
// and writes only the blocks the chunk covers.  The score and P.V products
// run on CUDA cores in f32; tensor-core tiles (wgmma) are later work.
#include "paged_common.cuh"

namespace tpd {

constexpr int kWriteThreads = 256;

struct WriteArgs {
  const void* k_new;  // [S, n_kv, P, dh] compute dtype
  const void* v_new;
  const void* pool_k;  // [L, nb, n_kv, bs, dh] storage dtype
  const void* pool_v;
  const float* scale_k;  // [L, nb, n_kv]
  const float* scale_v;
  const int* wtable;  // [S, Mw] touched block ids, sentinel nb
  const int* pos0;    // [S]
  const int* clen;    // [S]
  void* out_k;        // [S, Mw, n_kv, bs, dh] storage dtype
  void* out_v;
  float* out_sk;  // [S, Mw, n_kv]
  float* out_sv;
  int n_kv, P, dh, nb, bs, Mw, layer;
};

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x / 32) ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

// Merge one K or V block and emit it in storage form (plus its scale).
template <typename CT, typename PT>
__device__ void emit_block(const WriteArgs& a, const CT* chunk, const PT* pool,
                           const float* scales, PT* out, float* out_scale,
                           float* merged, float* red, int b, int w, int h) {
  const int bs = a.bs, dh = a.dh, n = bs * dh;
  const int bid = max(0, min(a.wtable[b * a.Mw + w], a.nb - 1));
  const int pos0 = a.pos0[b], cl = a.clen[b];
  const int blk0 = (pos0 / bs + w) * bs;
  const size_t blk = (size_t)(a.layer * a.nb + bid) * a.n_kv + h;
  const float sc_in = round_to<CT>(scales[blk]);
  const PT* orig = pool + blk * n;
  const CT* src = chunk + (size_t)(b * a.n_kv + h) * a.P * dh;
  float amax = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int t = e / dh, d = e - t * dh;
    const int kpos = blk0 + t;
    float v;
    if (kpos >= pos0 && kpos < pos0 + cl) {
      v = to_float(src[(size_t)(kpos - pos0) * dh + d]);
    } else {
      v = pool_value<CT, PT>(orig[e], sc_in);
    }
    merged[e] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = block_max(amax, red);
  const size_t o = ((size_t)(b * a.Mw + w) * a.n_kv + h);
  if constexpr (std::is_same<PT, int8_t>::value) {
    const float sc = amax > 0.f ? amax / 127.0f : 1.0f;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const float r = fminf(fmaxf(rintf(merged[e] / sc), -127.f), 127.f);
      out[o * n + e] = static_cast<int8_t>(r);
    }
    if (threadIdx.x == 0) out_scale[o] = sc;
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      out[o * n + e] = from_float<PT>(merged[e]);
    if (threadIdx.x == 0) out_scale[o] = 1.0f;
  }
  __syncthreads();  // merged is reused by the next block
}

template <typename CT, typename PT>
__global__ void __launch_bounds__(kWriteThreads)
    prefill_write_kernel(WriteArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int b = blockIdx.x, w = blockIdx.y, h = blockIdx.z;
  emit_block<CT, PT>(a, static_cast<const CT*>(a.k_new),
                     static_cast<const PT*>(a.pool_k), a.scale_k,
                     static_cast<PT*>(a.out_k), a.out_sk, smem, red, b, w, h);
  emit_block<CT, PT>(a, static_cast<const CT*>(a.v_new),
                     static_cast<const PT*>(a.pool_v), a.scale_v,
                     static_cast<PT*>(a.out_v), a.out_sv, smem, red, b, w, h);
}

template <typename CT, typename PT>
static cudaError_t launch_write_t(const WriteArgs& a, int S,
                                  cudaStream_t stream) {
  const size_t smem = (size_t)a.bs * a.dh * sizeof(float);
  auto kern = prefill_write_kernel<CT, PT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(S, a.Mw, a.n_kv);
  kern<<<grid, kWriteThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t launch_write(const WriteArgs& a, int S, int q_dtype,
                                int pool_dtype, cudaStream_t stream) {
  if (q_dtype == kBF16) {
    if (pool_dtype == kBF16)
      return launch_write_t<__nv_bfloat16, __nv_bfloat16>(a, S, stream);
    if (pool_dtype == kI8)
      return launch_write_t<__nv_bfloat16, int8_t>(a, S, stream);
    if (pool_dtype == kF32)
      return launch_write_t<__nv_bfloat16, float>(a, S, stream);
  } else if (q_dtype == kF32) {
    if (pool_dtype == kF32) return launch_write_t<float, float>(a, S, stream);
    if (pool_dtype == kI8) return launch_write_t<float, int8_t>(a, S, stream);
    if (pool_dtype == kBF16)
      return launch_write_t<float, __nv_bfloat16>(a, S, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tpd

extern "C" int tpd_paged_prefill(
    const void* q, const void* k_new, const void* v_new, const void* pool_k,
    const void* pool_v, const void* scale_k, const void* scale_v,
    const void* table, const void* wtable, const void* pos0, const void* clen,
    void* out, void* out_k, void* out_v, void* out_sk, void* out_sv, int S,
    int n_kv, int R, int P, int dh, int nb, int bs, int M, int Mw, int layer,
    int window, float scale, int q_dtype, int pool_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tpd::AttnArgs a;
  a.q = q;
  a.pool_k = pool_k;
  a.pool_v = pool_v;
  a.scale_k = static_cast<const float*>(scale_k);
  a.scale_v = static_cast<const float*>(scale_v);
  a.table = static_cast<const int*>(table);
  a.pos0 = static_cast<const int*>(pos0);
  a.fill = nullptr;
  a.wk = k_new;
  a.wv = v_new;
  a.out = out;
  a.n_kv = n_kv;
  a.R = R;
  a.s = P;
  a.dh = dh;
  a.nb = nb;
  a.bs = bs;
  a.M = M;
  a.W = P;
  a.layer = layer;
  a.window = window;
  a.scale = scale;
  cudaError_t e = tpd::launch_attention(a, S, q_dtype, pool_dtype, st);
  if (e != cudaSuccess) return (int)e;

  tpd::WriteArgs w;
  w.k_new = k_new;
  w.v_new = v_new;
  w.pool_k = pool_k;
  w.pool_v = pool_v;
  w.scale_k = static_cast<const float*>(scale_k);
  w.scale_v = static_cast<const float*>(scale_v);
  w.wtable = static_cast<const int*>(wtable);
  w.pos0 = static_cast<const int*>(pos0);
  w.clen = static_cast<const int*>(clen);
  w.out_k = out_k;
  w.out_v = out_v;
  w.out_sk = static_cast<float*>(out_sk);
  w.out_sv = static_cast<float*>(out_sv);
  w.n_kv = n_kv;
  w.P = P;
  w.dh = dh;
  w.nb = nb;
  w.bs = bs;
  w.Mw = Mw;
  w.layer = layer;
  return (int)tpd::launch_write(w, S, q_dtype, pool_dtype, st);
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
