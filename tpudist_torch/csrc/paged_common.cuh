// Device code shared by the paged decode-attention and paged-prefill kernels.
//
// One CTA per (slot, kv head) walks the slot's block table over its live
// prefix, then the "fresh" virtual block (the decode window buffer, or the
// prefill chunk) under the per-query causal mask, with an f32 online
// softmax.  The q rows of one kv head's group (R = group * s) share every
// K/V tile, so each pool block is read once per group, never per q head.
//
// Numerical contract with the plain PyTorch versions (and the JAX ones they
// mirror): int8 blocks dequantize as round_ct(float(q8) * round_ct(scale)),
// scores accumulate in f32 and are scaled by dh^-0.5, masked scores take the
// hard constant -1e30, and the softmax weights are rounded to the compute
// dtype before the P.V product.  Only the accumulation order differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace tpd {

constexpr float kMaskValue = -1e30f;
constexpr int kAttnThreads = 128;
// query rows per CTA: a long prefill chunk (R = group * P) splits over
// several CTAs, which keeps shared memory per CTA small enough for several
// CTAs per SM (the walk is latency-bound; more resident warps hide it)
constexpr int kRowsPerCta = 16;

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the compute dtype T (round-to-nearest-even), as a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// One pool element in the compute dtype CT: int8 dequantizes against its
// block scale (already rounded to CT), other storage types are cast.
template <typename CT, typename PT>
__device__ __forceinline__ float pool_value(PT x, float scale_ct) {
  if constexpr (std::is_same<PT, int8_t>::value) {
    return round_to<CT>(to_float(x) * scale_ct);
  } else {
    return round_to<CT>(to_float(x));
  }
}

struct AttnArgs {
  const void* q;        // [S, n_kv, R, dh] compute dtype (q heads kv-major)
  const void* pool_k;   // [L, nb, n_kv, bs, dh] storage dtype
  const void* pool_v;
  const float* scale_k;  // [L, nb, n_kv]
  const float* scale_v;
  const int* table;      // [S, M] physical block ids, sentinel nb
  const int* pos0;       // [S] live prefix length
  const int* fill;       // [S] window tokens before the queries, or null
  const void* wk;        // [S, n_kv, W, dh] compute dtype (fresh block)
  const void* wv;
  void* out;             // [S, n_kv, R, dh] compute dtype
  int n_kv, R, s, dh, nb, bs, M, W, layer, window;
  int rt;                // query rows per CTA (blockIdx.z tiles R)
  float scale;           // dh ** -0.5
};

// Row stride of the K/V smem tiles: 16-byte aligned rows (float4 stores)
// padded by 4 floats, so the score loop's reads down a column spread over
// the banks (2-way conflicts at most).
__host__ __device__ inline int tile_ld(int dh) {
  return dh % 4 == 0 ? dh + 4 : dh + 1;
}

__host__ __device__ inline size_t attn_smem_floats(int R, int dh, int bs) {
  // q, acc [R, dh]; K, V tiles [bs, tile_ld(dh)]; scores/probs [R, bs];
  // m, l, corr [R]
  return (size_t)2 * R * dh + (size_t)2 * bs * tile_ld(dh) +
         (size_t)R * bs + 3 * (size_t)R;
}

// Load one K and one V tile of n rows ([n, dh] at ks / vs) into smem rows of
// stride ld as compute-dtype values; rows [n, bs) are zeroed so a short
// tile never multiplies stale smem.  The common case makes 16-byte loads,
// K's and V's together, so each thread has several in flight at once.
template <typename CT, typename T>
__device__ __forceinline__ void load_kv(float* kd, float* vd, const T* ks,
                                        const T* vs, int n, int bs, int dh,
                                        int ld, float sk, float sv) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = dh % VEC == 0 && ld % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(ks) |
                     reinterpret_cast<uintptr_t>(vs)) & 15) == 0;
  if (vec) {
    const int nvec = bs * dh / VEC;
#pragma unroll 2
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      const int e = i * VEC, r = e / dh, d = e - r * dh;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;  // zeros past row n
      if (r < n) {
        kr = __ldg(reinterpret_cast<const uint4*>(ks + e));
        vr = __ldg(reinterpret_cast<const uint4*>(vs + e));
      }
      const T* kt = reinterpret_cast<const T*>(&kr);
      const T* vt = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        *reinterpret_cast<float4*>(kd + r * ld + d + j) = make_float4(
            pool_value<CT, T>(kt[j], sk), pool_value<CT, T>(kt[j + 1], sk),
            pool_value<CT, T>(kt[j + 2], sk), pool_value<CT, T>(kt[j + 3], sk));
        *reinterpret_cast<float4*>(vd + r * ld + d + j) = make_float4(
            pool_value<CT, T>(vt[j], sv), pool_value<CT, T>(vt[j + 1], sv),
            pool_value<CT, T>(vt[j + 2], sv), pool_value<CT, T>(vt[j + 3], sv));
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < bs * dh; e += blockDim.x) {
    const int r = e / dh, d = e - r * dh;
    kd[r * ld + d] = r < n ? pool_value<CT, T>(ks[e], sk) : 0.f;
    vd[r * ld + d] = r < n ? pool_value<CT, T>(vs[e], sv) : 0.f;
  }
}

// scores[r, c] = q[r] . k[c] * scale under the tile's mask.  A group of G
// lanes (a power of two inside one warp) splits each dot product; the loop
// trip count is uniform over the block, so the full-mask shuffles are safe.
// kind 0: pool block j (key position j * bs + c, live below pos0);
// kind 1: fresh tile starting at column t0 (column t0 + c <= fill + i).
// Rows are this CTA's: local row r is query row r0 + r of the group.
__device__ __forceinline__ void tile_scores(const AttnArgs& a, int R, int r0,
                                            const float* q_s,
                                            const float* k_s, float* p_s,
                                            int kind, int base, int n,
                                            int pos0, int fill) {
  const int TB = a.bs, dh = a.dh, ld = tile_ld(dh);
  const int pairs = R * TB;
  int G = 1;
  while (G < 32 && pairs * G * 2 <= (int)blockDim.x) G *= 2;
  const int ngroups = blockDim.x / G;
  const int sub = threadIdx.x % G;
  for (int first = 0; first < pairs; first += ngroups) {
    const int pidx = first + threadIdx.x / G;
    float acc = 0.f;
    int r = 0, c = 0;
    if (pidx < pairs) {
      r = pidx / TB;
      c = pidx - r * TB;
      const float* qr = q_s + r * dh;
      const float* kc = k_s + c * ld;
      for (int d = sub; d < dh; d += G) acc += qr[d] * kc[d];
    }
    for (int off = G / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (pidx < pairs && sub == 0) {
      const int i = (r0 + r) % a.s;
      const int qpos = pos0 + fill + i;
      float sc;
      if (c >= n) {
        sc = -INFINITY;  // no such column (short fresh tile)
      } else {
        bool keep;
        int abs_k;
        if (kind == 0) {
          abs_k = base + c;
          keep = abs_k < pos0;
        } else {
          const int col = base + c;
          abs_k = pos0 + col;
          keep = col <= fill + i;
        }
        if (a.window > 0) keep = keep && abs_k > qpos - a.window;
        sc = keep ? acc * a.scale : kMaskValue;
      }
      p_s[r * TB + c] = sc;
    }
  }
}

// FlashAttention-2 online-softmax step over one tile of scores (in place:
// p_s turns into the tile's probabilities, rounded to the compute dtype).
template <typename CT>
__device__ __forceinline__ void softmax_update(int R, int TB, float* p_s,
                                               float* m_s, float* l_s,
                                               float* c_s) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float* pr = p_s + r * TB;
    const float m_old = m_s[r];
    float m_new = m_old;
    for (int c = 0; c < TB; ++c) m_new = fmaxf(m_new, pr[c]);
    float sum = 0.f;
    for (int c = 0; c < TB; ++c) {
      const float p = expf(pr[c] - m_new);
      sum += p;
      pr[c] = round_to<CT>(p);
    }
    const float corr = expf(m_old - m_new);
    l_s[r] = l_s[r] * corr + sum;
    m_s[r] = m_new;
    c_s[r] = corr;
  }
}

__device__ __forceinline__ void pv_update(int R, int TB, int dh,
                                          const float* p_s, const float* v_s,
                                          const float* c_s, float* acc_s) {
  const int ld = tile_ld(dh);
  for (int e = threadIdx.x; e < R * dh; e += blockDim.x) {
    const int r = e / dh, d = e - r * dh;
    const float* pr = p_s + r * TB;
    float acc = 0.f;
    for (int c = 0; c < TB; ++c) acc += pr[c] * v_s[c * ld + d];
    acc_s[e] = acc_s[e] * c_s[r] + acc;
  }
}

template <typename CT, typename PT>
__global__ void __launch_bounds__(kAttnThreads)
    paged_attention_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * a.rt;
  const int R = min(a.rt, a.R - r0);
  const int dh = a.dh, TB = a.bs, ld = tile_ld(dh);
  float* q_s = smem;
  float* acc_s = q_s + R * dh;
  float* k_s = acc_s + R * dh;
  float* v_s = k_s + TB * ld;
  float* p_s = v_s + TB * ld;
  float* m_s = p_s + R * TB;
  float* l_s = m_s + R;
  float* c_s = l_s + R;

  const size_t row0 = ((size_t)(b * a.n_kv + h) * a.R + r0) * dh;
  const CT* q = static_cast<const CT*>(a.q) + row0;
  for (int e = threadIdx.x; e < R * dh; e += blockDim.x) {
    q_s[e] = to_float(q[e]);
    acc_s[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = kMaskValue;
    l_s[r] = 0.f;
  }
  const int pos0 = a.pos0[b];
  const int fill = a.fill ? a.fill[b] : 0;
  __syncthreads();

  // prefix walk: live blocks only
  const int live = min((pos0 + TB - 1) / TB, a.M);
  const PT* pk = static_cast<const PT*>(a.pool_k);
  const PT* pv = static_cast<const PT*>(a.pool_v);
  for (int j = 0; j < live; ++j) {
    const int bid = max(0, min(a.table[b * a.M + j], a.nb - 1));
    const size_t blk = (size_t)(a.layer * a.nb + bid) * a.n_kv + h;
    const float sk = round_to<CT>(a.scale_k[blk]);
    const float sv = round_to<CT>(a.scale_v[blk]);
    load_kv<CT, PT>(k_s, v_s, pk + blk * TB * dh, pv + blk * TB * dh, TB,
                    TB, dh, ld, sk, sv);
    __syncthreads();
    tile_scores(a, R, r0, q_s, k_s, p_s, 0, j * TB, TB, pos0, fill);
    __syncthreads();
    softmax_update<CT>(R, TB, p_s, m_s, l_s, c_s);
    __syncthreads();
    pv_update(R, TB, dh, p_s, v_s, c_s, acc_s);
    __syncthreads();
  }

  // the fresh virtual block, in tiles of bs columns.  A tile starting past
  // every local row's own column (fill + i) comes after each row has seen
  // a live score, so its scores all mask to probability 0 and correction 1:
  // it is skipped
  int imax = 0;
  for (int r = 0; r < R; ++r) imax = max(imax, (r0 + r) % a.s);
  const CT* wk = static_cast<const CT*>(a.wk) + (size_t)(b * a.n_kv + h) * a.W * dh;
  const CT* wv = static_cast<const CT*>(a.wv) + (size_t)(b * a.n_kv + h) * a.W * dh;
  for (int t0 = 0; t0 < a.W && t0 <= fill + imax; t0 += TB) {
    const int n = min(TB, a.W - t0);
    load_kv<CT, CT>(k_s, v_s, wk + (size_t)t0 * dh, wv + (size_t)t0 * dh, n,
                    TB, dh, ld, 1.f, 1.f);
    __syncthreads();
    tile_scores(a, R, r0, q_s, k_s, p_s, 1, t0, n, pos0, fill);
    __syncthreads();
    softmax_update<CT>(R, TB, p_s, m_s, l_s, c_s);
    __syncthreads();
    pv_update(R, TB, dh, p_s, v_s, c_s, acc_s);
    __syncthreads();
  }

  // every query keeps at least its own column, so l > 0
  CT* out = static_cast<CT*>(a.out) + row0;
  for (int e = threadIdx.x; e < R * dh; e += blockDim.x)
    out[e] = from_float<CT>(acc_s[e] / l_s[e / dh]);
}

template <typename CT, typename PT>
static cudaError_t launch_attention_t(const AttnArgs& a, int S,
                                      cudaStream_t stream) {
  const size_t smem = attn_smem_floats(a.rt, a.dh, a.bs) * sizeof(float);
  auto kern = paged_attention_kernel<CT, PT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(S, a.n_kv, (a.R + a.rt - 1) / a.rt);
  kern<<<grid, kAttnThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

static inline cudaError_t launch_attention(AttnArgs a, int S, int q_dtype,
                                           int pool_dtype,
                                           cudaStream_t stream) {
  a.rt = a.R < kRowsPerCta ? a.R : kRowsPerCta;
  if (q_dtype == kBF16) {
    if (pool_dtype == kBF16)
      return launch_attention_t<__nv_bfloat16, __nv_bfloat16>(a, S, stream);
    if (pool_dtype == kI8)
      return launch_attention_t<__nv_bfloat16, int8_t>(a, S, stream);
    if (pool_dtype == kF32)
      return launch_attention_t<__nv_bfloat16, float>(a, S, stream);
  } else if (q_dtype == kF32) {
    if (pool_dtype == kF32)
      return launch_attention_t<float, float>(a, S, stream);
    if (pool_dtype == kI8) return launch_attention_t<float, int8_t>(a, S, stream);
    if (pool_dtype == kBF16)
      return launch_attention_t<float, __nv_bfloat16>(a, S, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tpd
