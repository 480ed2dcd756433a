// Tensor-core gathers of paged K/V shared by the paged prefill's tensor-core
// arm (paged_prefill.cu) and the paged decode's split walk
// (paged_attention.cu): pool rows reached through the block table into
// padded bf16 shared tiles ([keys][D + 8]) that mma.sync reads.  bf16
// pools copy with cp.async; int8 pools dequantize in registers as
// round_ct(float(q8) * round_ct(scale)) and f32 pools round to bf16
// (paged_common.cuh's contract).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "paged_common.cuh"

namespace tpd {
namespace tc {

using tpd_flash::bf16;
using tpd_flash::cp_async16;

// 8 values of a pool in the compute dtype (int8 dequantized against its
// block scale, already rounded to bf16; f32 rounded) as floats
template <typename PT>
__device__ __forceinline__ void load8(const PT* p, float sc, float* x) {
  if constexpr (std::is_same<PT, bf16>::value) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x, x[2 * e + 1] = f.y;
    }
  } else if constexpr (std::is_same<PT, int8_t>::value) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const int8_t* q = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = round_to<bf16>(to_float(q[e]) * sc);
  } else {
    const float4 lo = reinterpret_cast<const float4*>(p)[0];
    const float4 hi = reinterpret_cast<const float4*>(p)[1];
    x[0] = round_to<bf16>(lo.x), x[1] = round_to<bf16>(lo.y);
    x[2] = round_to<bf16>(lo.z), x[3] = round_to<bf16>(lo.w);
    x[4] = round_to<bf16>(hi.x), x[5] = round_to<bf16>(hi.y);
    x[6] = round_to<bf16>(hi.z), x[7] = round_to<bf16>(hi.w);
  }
}

// 8 values in storage form (int8 quantized by scale qs)
template <typename PT>
__device__ __forceinline__ void store8(PT* p, const float* x, float qs) {
  if constexpr (std::is_same<PT, bf16>::value) {
    uint4 r;
    r.x = tpd_flash::pack_bf16(x[0], x[1]);
    r.y = tpd_flash::pack_bf16(x[2], x[3]);
    r.z = tpd_flash::pack_bf16(x[4], x[5]);
    r.w = tpd_flash::pack_bf16(x[6], x[7]);
    *reinterpret_cast<uint4*>(p) = r;
  } else if constexpr (std::is_same<PT, int8_t>::value) {
    uint2 r;
    int8_t* q = reinterpret_cast<int8_t*>(&r);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      q[e] = static_cast<int8_t>(fminf(fmaxf(rintf(x[e] / qs), -127.f),
                                       127.f));
    *reinterpret_cast<uint2*>(p) = r;
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// 8 pool values (16 bytes of bf16 in shared memory) of one K or V row in
// the compute dtype: bf16 pools copy asynchronously, int8 and f32 pools
// convert through registers; !ok fills zeros.
template <typename PT>
__device__ __forceinline__ void pool_chunk(bf16* dst, const PT* src, float sc,
                                           bool ok) {
  if constexpr (std::is_same<PT, bf16>::value) {
    cp_async16(dst, src, ok);
  } else {
    float v[8] = {};
    if (ok) load8<PT>(src, sc, v);
    store8<bf16>(dst, v, 1.f);
  }
}

// Keys [k0, k0 + KEYS) of the prefix of slot b, kv head h, gathered block
// by block through the table into [KEYS][D + 8] K and V tiles by THREADS
// threads (this one is `tid`); keys at or past kend (the live prefix) are
// zero.  Each thread first resolves the pool rows of all its chunks
// (independent table loads in flight together), then issues their copies.
template <int D, int KEYS, int THREADS, typename PT>
__device__ __forceinline__ void load_prefix_tile(bf16* Ks, bf16* Vs,
                                                 const AttnArgs& a, int b,
                                                 int h, int k0, int kend,
                                                 int tid) {
  constexpr int LD = D + 8, CH = D / 8, NC = KEYS * CH;
  // chunks a thread at most; with NC not a multiple of THREADS (head dims
  // 48, 80 and 112 on the prefill's 256 threads) the last round is partial
  constexpr int N = (NC + THREADS - 1) / THREADS;
  const PT* pk = static_cast<const PT*>(a.pool_k);
  const PT* pv = static_cast<const PT*>(a.pool_v);
  size_t off[N];
  float sk[N], sv[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = tid + n * THREADS, k = k0 + c / CH;
    off[n] = 0;
    sk[n] = sv[n] = 1.f;
    if (c < NC && k < kend) {
      const int bid =
          max(0, min(__ldg(a.table + b * a.M + k / a.bs), a.nb - 1));
      const size_t blk = (size_t)(a.layer * a.nb + bid) * a.n_kv + h;
      off[n] = (blk * a.bs + k % a.bs) * D + (c % CH) * 8;
      if constexpr (std::is_same<PT, int8_t>::value) {
        sk[n] = round_to<bf16>(__ldg(a.scale_k + blk));
        sv[n] = round_to<bf16>(__ldg(a.scale_v + blk));
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = tid + n * THREADS, r = c / CH, col = (c % CH) * 8;
    if (c >= NC) break;  // a partial last round, or head dim 16 on 256
    const bool ok = k0 + r < kend;
    pool_chunk<PT>(Ks + r * LD + col, pk + off[n], sk[n], ok);
    pool_chunk<PT>(Vs + r * LD + col, pv + off[n], sv[n], ok);
  }
}

}  // namespace tc
}  // namespace tpd
