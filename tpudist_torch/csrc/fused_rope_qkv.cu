// Fused RoPE + QKV projection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/fused_linear.py
// (fused_rope_qkv, body _rope_qkv_kernel): qkv = h[S·T, d] · w[d, dtot],
// then + extra on the lanes whose on[s] is non-zero (the LoRA qkv delta,
// before the rotation), the split into q [S, nh, T, dh], k and v
// [S, n_kv, T, dh], and GPT-NeoX half-split RoPE of q and k at the absolute
// positions offsets[s] + t.
//
// Rounding follows the Pallas kernel and the port's unfused arm: the
// product accumulates in f32 and rounds to the compute dtype; the delta is
// added in f32 and the sum rounds again; the rotation runs in f32 from the
// rounded values (freqs = powf(base, -j / half) with an IEEE division,
// angles = (offset + t) · freq, sinf / cosf, each product and sum rounded
// on its own as torch's elementwise kernels round them, so no FMA
// contraction) and rounds once more.
//
// Bound on the H100: bytes.  At decode (S·T = 8 rows) the 6.29 MB bf16
// weight is the traffic and the product does 2 flops per weight byte; at
// prefill (512 rows) the weight, h, extra and the outputs still outweigh
// the 3.2 GFLOP at the tensor-core rate.  Design:
//
// - the weight is read as it lies: the port stores the qkv projection as
//   [dtot, d] (row = output column, contiguous over the depth), which is
//   the col-major B operand of mma.sync m16n8k16 — no transposed copy;
// - a CTA owns 32 output columns that hold 16 rotation pairs of one head
//   (columns c..c+15 and half+c..half+c+15), so both members of a pair
//   land in the same thread's accumulator fragment (n-tiles n and n+2) and
//   the rotation is an epilogue in registers;
// - a CTA owns 64 rows of the flattened S·T axis, so at decode every slot's
//   row sits in one tile and each weight column is read once; the row's
//   slot gives its offset and its on flag, read from device memory (no
//   host sync);
// - depth tiles of 64 arrive by cp.async, three stages in flight (the
//   rows past S·T are zero-filled and never read from memory).
//
// f32 inputs run on CUDA-core FMAs (never TF32) with the same tiling.
#include "flash_common.cuh"

namespace {

using tpd_flash::bf16;

constexpr int kRows = 64;    // rows of S·T per CTA
constexpr int kCols = 32;    // output columns per CTA: 16 rotation pairs
constexpr int kDepth = 64;   // depth tile (bf16)
constexpr int kLd = kDepth + 8;
constexpr int kStages = 3;
constexpr int kDepthF = 32;  // depth tile (f32)
constexpr int kThreads = tpd_flash::kThreads;

struct Args {
  const void* h;       // [M, d], M = S·T
  const void* wt;      // [dtot, d]
  const int* offsets;  // [S]
  const void* extra;   // [M, dtot] or null
  const void* on;      // [S] int32 or bool, or null (all on)
  void* q;             // [S, nh, T, dh]
  void* k;             // [S, n_kv, T, dh]
  void* v;
  int S, T, d, nh, n_kv, dh, on_is_bool, rope;
  float base;
};

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
// round to the storage dtype and back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// One rotation pair of one row: columns jl (first half of the head) and
// jl + half, accumulators v1 and v2.  Rounds, adds the delta, rotates and
// stores as the module header says.
template <typename T>
__device__ __forceinline__ void finish_pair(const Args& a, int m, int head,
                                            int jl, float v1, float v2) {
  const int half = a.dh / 2;
  const int s = m / a.T, t = m % a.T;
  const int dtot = (a.nh + 2 * a.n_kv) * a.dh;
  const int col = head * a.dh + jl;
  v1 = rnd<T>(v1);
  v2 = rnd<T>(v2);
  if (a.extra) {
    const bool on =
        a.on == nullptr ||
        (a.on_is_bool ? static_cast<const uint8_t*>(a.on)[s] != 0
                      : static_cast<const int*>(a.on)[s] != 0);
    if (on) {
      const T* e = static_cast<const T*>(a.extra) + (size_t)m * dtot + col;
      v1 = rnd<T>(__fadd_rn(v1, to_f(e[0])));
      v2 = rnd<T>(__fadd_rn(v2, to_f(e[half])));
    }
  }
  if (a.rope && head < a.nh + a.n_kv) {
    const float freq = powf(a.base, -(float)jl / (float)half);
    const float pos = __fadd_rn((float)a.offsets[s], (float)t);
    const float ang = __fmul_rn(pos, freq);
    const float sn = sinf(ang), cs = cosf(ang);
    const float r1 = __fsub_rn(__fmul_rn(v1, cs), __fmul_rn(v2, sn));
    const float r2 = __fadd_rn(__fmul_rn(v1, sn), __fmul_rn(v2, cs));
    v1 = r1;
    v2 = r2;
  }
  T* out;
  int hh, nheads;
  if (head < a.nh) {
    out = static_cast<T*>(a.q);
    hh = head;
    nheads = a.nh;
  } else if (head < a.nh + a.n_kv) {
    out = static_cast<T*>(a.k);
    hh = head - a.nh;
    nheads = a.n_kv;
  } else {
    out = static_cast<T*>(a.v);
    hh = head - a.nh - a.n_kv;
    nheads = a.n_kv;
  }
  T* row = out + (((size_t)s * nheads + hh) * a.T + t) * a.dh;
  row[jl] = from_f<T>(v1);
  row[jl + half] = from_f<T>(v2);
}

// The CTA's head and the first-half column of its 16 pairs.
__device__ __forceinline__ void cta_columns(const Args& a, int& head,
                                            int& c0) {
  const int chunks = a.dh / 32;  // 16-pair chunks per head
  head = blockIdx.x / chunks;
  c0 = (blockIdx.x % chunks) * 16;
}

// Local weight row lr (0..31) of the CTA: the 16 first-half columns, then
// their 16 partners.
__device__ __forceinline__ int weight_row(const Args& a, int head, int c0,
                                          int lr) {
  return head * a.dh + (lr < 16 ? c0 + lr : a.dh / 2 + c0 + lr - 16);
}

__global__ void __launch_bounds__(kThreads)
    rope_qkv_bf16(Args a) {
  __shared__ __align__(16) bf16 hs[kStages][kRows * kLd];
  __shared__ __align__(16) bf16 ws[kStages][kCols * kLd];
  int head, c0;
  cta_columns(a, head, c0);
  const int M = a.S * a.T, m0 = blockIdx.y * kRows;
  const bf16* h = static_cast<const bf16*>(a.h);
  const bf16* wt = static_cast<const bf16*>(a.wt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = a.d / kDepth;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kDepth;
    for (int c = threadIdx.x; c < kRows * (kDepth / 8); c += kThreads) {
      const int r = c / (kDepth / 8), col = (c % (kDepth / 8)) * 8;
      const bool ok = m0 + r < M;
      tpd_flash::cp_async16(&hs[stage][r * kLd + col],
                            h + (size_t)(ok ? m0 + r : 0) * a.d + k0 + col,
                            ok);
    }
    for (int c = threadIdx.x; c < kCols * (kDepth / 8); c += kThreads) {
      const int r = c / (kDepth / 8), col = (c % (kDepth / 8)) * 8;
      tpd_flash::cp_async16(
          &ws[stage][r * kLd + col],
          wt + (size_t)weight_row(a, head, c0, r) * a.d + k0 + col, true);
    }
  };

  float acc[4][4] = {};
  const bool live = m0 + warp * 16 < M;  // warp-uniform
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    tpd_flash::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tpd_flash::cp_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt);
    tpd_flash::cp_commit();
    const int st = kt % kStages;
    if (live) {
      uint32_t af[kDepth / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        tpd_flash::load_a(af[kk], hs[st], kLd, warp * 16, kk * 16, lane);
      tpd_flash::mma_abt<4, kDepth / 16>(acc, af, ws[st], kLd, lane);
    }
  }
  tpd_flash::cp_wait<0>();
  if (!live) return;
  // C fragment: n-tile n holds columns n·8 + 2·(lane%4) + {0, 1} of rows
  // lane/4 and lane/4 + 8; n-tiles 0-1 are the first halves of the pairs,
  // 2-3 their partners
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + warp * 16 + g + (i >= 2 ? 8 : 0);
      if (m < M)
        finish_pair<bf16>(a, m, head, c0 + n * 8 + tq * 2 + (i & 1),
                          acc[n][i], acc[n + 2][i]);
    }
}

__global__ void __launch_bounds__(kThreads)
    rope_qkv_f32(Args a) {
  __shared__ float hs[kRows][kDepthF + 1];
  __shared__ float ws[kCols][kDepthF + 1];
  int head, c0;
  cta_columns(a, head, c0);
  const int M = a.S * a.T, m0 = blockIdx.y * kRows;
  const float* h = static_cast<const float*>(a.h);
  const float* wt = static_cast<const float*>(a.wt);
  // thread: pair p (columns p and p + 16 of the CTA), rows rg + 8i
  const int p = threadIdx.x % 16, rg = threadIdx.x / 16;
  float lo[8] = {}, hi[8] = {};
  for (int k0 = 0; k0 < a.d; k0 += kDepthF) {
    for (int i = threadIdx.x; i < kRows * kDepthF; i += kThreads) {
      const int r = i / kDepthF, c = i % kDepthF;
      hs[r][c] = m0 + r < M ? h[(size_t)(m0 + r) * a.d + k0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kCols * kDepthF; i += kThreads) {
      const int r = i / kDepthF, c = i % kDepthF;
      ws[r][c] = wt[(size_t)weight_row(a, head, c0, r) * a.d + k0 + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kDepthF; ++k) {
      const float w1 = ws[p][k], w2 = ws[p + 16][k];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = hs[rg + 8 * i][k];
        lo[i] = fmaf(x, w1, lo[i]);
        hi[i] = fmaf(x, w2, hi[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + rg + 8 * i;
    if (m < M) finish_pair<float>(a, m, head, c0 + p, lo[i], hi[i]);
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16 (tpd_flash::DType).  The wrapper checks shapes:
// dh a multiple of 32, d a multiple of 64.
extern "C" int tpd_fused_rope_qkv(const void* h, const void* wt,
                                  const void* offsets, const void* extra,
                                  const void* on, void* q, void* k, void* v,
                                  int S, int T, int d, int nh, int n_kv,
                                  int dh, int on_is_bool, int rope,
                                  float base, int dtype, void* stream) {
  Args a;
  a.h = h;
  a.wt = wt;
  a.offsets = static_cast<const int*>(offsets);
  a.extra = extra;
  a.on = on;
  a.q = q;
  a.k = k;
  a.v = v;
  a.S = S;
  a.T = T;
  a.d = d;
  a.nh = nh;
  a.n_kv = n_kv;
  a.dh = dh;
  a.on_is_bool = on_is_bool;
  a.rope = rope;
  a.base = base;
  const int M = S * T;
  dim3 grid((nh + 2 * n_kv) * (dh / 32), (M + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tpd_flash::kBF16)
    rope_qkv_bf16<<<grid, kThreads, 0, st>>>(a);
  else
    rope_qkv_f32<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
