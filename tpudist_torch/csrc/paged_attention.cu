// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/paged_attention.py
// (paged_attention, body _kernel): decode / speculative-verify attention
// that walks each slot's block table in-kernel, dequantizes int8 blocks
// against their per-(layer, block, kv-head) scales, and treats the
// uncommitted window buffer as the walk's last virtual block under the
// per-query causal mask col <= fill + i.
//
// Bound on the H100: bytes.  A decode step does 4 flops per K/V byte at
// bf16 (R = group * s query rows per kv head), far below the ~295 flops/byte
// where the tensor cores become the limit, so the time is the live KV
// blocks read from HBM.  Only the live blocks of each lane are read (never
// the table's sentinel tail, never a dense max_len view), each once per kv
// head group.  The wrapper (ops/paged_attention.py _decode_arm) picks one of
// two arms:
//
// - the split walk on the tensor cores (bf16 q over bf16 or int8 pools, head
//   dims that are multiples of 16 up to 128), one launch.  The grid is (slot, kv head, split x
//   16-row tile of the R query rows): split z owns keys [128 z, 128 z + 128)
//   of the lane's table, a fixed span the host sizes from the table width
//   alone (reading the cursors on the host would synchronise it on the
//   card).  A CTA whose span lies past the lane's live prefix exits at
//   once; the split holding the end of the prefix also takes the window
//   buffer's columns.  Inside a CTA four warps take the span's 16-key tiles
//   in turn, each gathering its tiles through the table into a ring of two
//   buffers (paged_tc.cuh: cp.async for bf16 pools, int8 dequantized in
//   registers), so one tile's loads fly under the other's products.  The
//   query rows sit in registers as mma.sync A fragments (padded to 16
//   rows); S = Q.K^T and O += P.V run on bf16 mma.sync m16n8k16 with f32
//   accumulation and the online softmax in registers, masked scores at the
//   hard -1e30.  The warps merge their (m, l, O) in shared memory; a lane
//   whose live keys fit one split writes its output there, else each split
//   writes its partial to an f32 workspace and the last CTA of the (slot,
//   kv head, row tile) to finish -- found by an atomic counter, which it
//   resets to zero for the next call -- merges the partials by logsumexp.
//   A split that sees no live key of a row (a sliding window past it) has
//   m = -1e30 there and p = 1 on its masked keys: its weight exp(m - max m)
//   is 0, since every row keeps its own window column in the window split.
// - the CUDA-core code of paged_common.cuh (f32, other head dims, f32
//   pools; and forced, to time it beside the split walk): one CTA per (slot,
//   kv head) walking the live blocks one after another.
//
// Numerics (paged_common.cuh's contract): scores in f32 scaled by dh^-0.5,
// the unnormalized probabilities rounded to bf16 before P.V and summed
// unrounded; only the order of the sums differs between the arms.
#include "flash_common.cuh"
#include "paged_common.cuh"
#include "paged_tc.cuh"

namespace tpd {
namespace dec {

using tpd_flash::bf16;
using tpd_flash::exp_row;

constexpr int kKeys = 16;         // keys a tile: one k-step of P.V
constexpr int kSplitKeys = 128;   // keys a split owns
constexpr int kWarps = 4;         // warps a CTA, each walking its own tiles
constexpr int kThreads = 32 * kWarps;
constexpr int kBufs = 2;          // a warp's ring of K/V tile buffers
constexpr int kRows = 16;         // query rows a CTA (one mma row tile)

// f32 values a lane keeps of its (m, l, O) fragments: O's DN x 4, then m
// and l of its two rows
template <int D>
__host__ __device__ constexpr int frag_floats() {
  return D / 8 * 4 + 4;
}

// Shared memory of a CTA: the warps' K/V rings, reused for the merge
template <int D>
constexpr size_t split_smem() {
  const size_t ring = (size_t)kWarps * kBufs * 2 * kKeys * (D + 8) * 2;
  const size_t merge = (size_t)kWarps * frag_floats<D>() * 32 * 4;
  return ring > merge ? ring : merge;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D, typename PT>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(AttnArgs a, float* __restrict__ part,
                        int* __restrict__ count, int splits) {
  static_assert(D % 16 == 0 && D <= 128, "bf16 tiles: head dim 16..128");
  constexpr int LD = D + 8, DN = D / 8, KD = D / 16, FR = frag_floats<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int nrt = (a.R + kRows - 1) / kRows;
  const int split = blockIdx.z / nrt, rt = blockIdx.z % nrt;
  const int pos0 = a.pos0[b], fill = a.fill[b];
  const int kend = min(pos0, a.M * a.bs);
  // the splits holding live keys, and the one that takes the window: the
  // split of the prefix's end (a new one when the prefix ends on a split
  // boundary, unless the table is full)
  const int pool_splits = (kend + kSplitKeys - 1) / kSplitKeys;
  const int ws = min(kend / kSplitKeys, splits - 1);
  const int live = max(pool_splits, ws + 1);
  if (split >= live) return;

  const int s0 = split * kSplitKeys;
  const int npool =
      split < pool_splits ? (min(kend, s0 + kSplitKeys) - s0 + kKeys - 1) / kKeys
                          : 0;
  // window columns any row can see: col <= fill + i, i < s
  const int wcols = min(a.W, fill + a.s);
  const int nwin = split == ws ? (wcols + kKeys - 1) / kKeys : 0;
  const int ntiles = npool + nwin;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int R = a.R, r0 = rt * kRows, window = a.window;
  const size_t head = (size_t)b * a.n_kv + h;

  // Q rows r0..r0 + 15 as A fragments (rows past R zero)
  const bf16* q = static_cast<const bf16*>(a.q) + head * R * D;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + tq * 2, ra = r0 + g, rb = ra + 8;
    qa[kk][0] = ra < R ? ld32(q + (size_t)ra * D + c) : 0u;
    qa[kk][1] = rb < R ? ld32(q + (size_t)rb * D + c) : 0u;
    qa[kk][2] = ra < R ? ld32(q + (size_t)ra * D + c + 8) : 0u;
    qa[kk][3] = rb < R ? ld32(q + (size_t)rb * D + c + 8) : 0u;
  }
  int qpos[2], irow[2];  // window step and absolute position of the rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    irow[r] = (r0 + g + r * 8) % a.s;
    qpos[r] = pos0 + fill + irow[r];
  }

  bf16* ring = reinterpret_cast<bf16*>(smem) + warp * kBufs * 2 * kKeys * LD;
  const bf16* wk = static_cast<const bf16*>(a.wk) + head * a.W * D;
  const bf16* wv = static_cast<const bf16*>(a.wv) + head * a.W * D;
  // tile t of the split's walk into ring buffer `buf`: a pool tile through
  // the table, or window columns (zero past W); always one cp.async group
  auto issue = [&](int t, int buf) {
    bf16* Kt = ring + buf * 2 * kKeys * LD;
    bf16* Vt = Kt + kKeys * LD;
    if (t < npool) {
      tc::load_prefix_tile<D, kKeys, 32, PT>(Kt, Vt, a, b, h,
                                             s0 + t * kKeys, kend, lane);
    } else if (t < ntiles) {
      const int c0 = (t - npool) * kKeys;
      for (int c = lane; c < kKeys * DN; c += 32) {
        const int r = c / DN, col = (c % DN) * 8;
        const bool ok = c0 + r < a.W;
        const size_t src = (size_t)(ok ? c0 + r : 0) * D + col;
        tpd_flash::cp_async16(Kt + r * LD + col, wk + src, ok);
        tpd_flash::cp_async16(Vt + r * LD + col, wv + src, ok);
      }
    }
    tpd_flash::cp_commit();
  };
  issue(warp, 0);
  issue(warp + kWarps, 1);

  float o[DN][4] = {};
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  for (int t = warp, j = 0; t < ntiles; t += kWarps, ++j) {
    tpd_flash::cp_wait<kBufs - 1>();
    __syncwarp();
    const bf16* Kt = ring + (j % kBufs) * 2 * kKeys * LD;
    const bf16* Vt = Kt + kKeys * LD;
    float sc[2][4] = {};
    tpd_flash::mma_abt<2, KD>(sc, qa, Kt, LD, lane);
    const bool pool = t < npool;
    const int c0 = pool ? s0 + t * kKeys : (t - npool) * kKeys;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = c0 + n * 8 + tq * 2 + (e & 1);
        bool keep;
        int abs_k;
        if (pool) {
          abs_k = c;
          keep = c < kend;
        } else {
          abs_k = pos0 + c;
          keep = c <= fill + irow[r];
        }
        if (window > 0) keep = keep && abs_k > qpos[r] - window;
        sc[n][e] = !pool && c >= a.W ? -INFINITY  // no such column
                   : keep            ? sc[n][e] * a.scale
                                     : kMaskValue;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp_row(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        sc[n][2 * r] = exp_row(sc[n][2 * r], mx);
        sc[n][2 * r + 1] = exp_row(sc[n][2 * r + 1], mx);
        sum += sc[n][2 * r] + sc[n][2 * r + 1];
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
    tpd_flash::mma_pt<DN, 1>(o, sc, Vt, LD, lane);
    __syncwarp();  // every lane is done with the buffer
    issue(t + kBufs * kWarps, j % kBufs);
  }
  tpd_flash::cp_wait<0>();

  // merge the warps (fragment-major in the freed rings): a warp whose rows
  // saw no live key (or no tile) has m = -1e30 and weight 0 beside one
  // that did
  __syncthreads();
  float* xs = reinterpret_cast<float*>(smem);  // [kWarps][FR][32]
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[(warp * FR + dn * 4 + e) * 32 + lane] = o[dn][e];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    xs[(warp * FR + DN * 4 + r) * 32 + lane] = m[r];
    xs[(warp * FR + DN * 4 + 2 + r) * 32 + lane] = l[r];
  }
  __syncthreads();
  if (warp != 0) return;
  // combine n partials of (m, l, O) fragments (the warps' in shared memory,
  // or the live splits' in the workspace, read past L1) into o, m and l
  auto combine = [&](const float* base, int n, bool global) {
    auto rd = [&](int i, int f) {
      const float* p = base + (size_t)(i * FR + f) * 32 + lane;
      return global ? __ldcg(p) : *p;
    };
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kMaskValue;
      for (int i = 0; i < n; ++i) mx = fmaxf(mx, rd(i, DN * 4 + r));
      float lt = 0.f;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) o[dn][2 * r] = o[dn][2 * r + 1] = 0.f;
      for (int i = 0; i < n; ++i) {
        const float c = exp_row(rd(i, DN * 4 + r), mx);
        lt += rd(i, DN * 4 + 2 + r) * c;
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          o[dn][2 * r] += rd(i, dn * 4 + 2 * r) * c;
          o[dn][2 * r + 1] += rd(i, dn * 4 + 2 * r + 1) * c;
        }
      }
      m[r] = mx;
      l[r] = lt;
    }
  };
  combine(xs, kWarps, false);

  bf16* out = static_cast<bf16*>(a.out) + head * R * D;
  auto store = [&]() {
    // every query keeps at least its own column, so l > 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + r * 8;
      if (row >= R) continue;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + dn * 8 +
                                           tq * 2) =
            __floats2bfloat162_rn(o[dn][2 * r] / l[r],
                                  o[dn][2 * r + 1] / l[r]);
    }
  };
  if (live == 1) {  // the lane's keys fit this split: no partials
    store();
    return;
  }
  const size_t tile = head * nrt + rt;
  float* mine = part + (tile * splits + split) * FR * 32;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(dn * 4 + e) * 32 + lane] = o[dn][e];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mine[(DN * 4 + r) * 32 + lane] = m[r];
    mine[(DN * 4 + 2 + r) * 32 + lane] = l[r];
  }
  __threadfence();  // the partial is visible before the count says so
  int prev = 0;
  if (lane == 0) prev = atomicAdd(count + tile, 1);
  prev = __shfl_sync(0xffffffffu, prev, 0);
  if (prev != live - 1) return;
  // the last split of this (slot, kv head, row tile) merges them all
  __threadfence();
  combine(part + tile * splits * FR * 32, live, true);
  if (lane == 0) count[tile] = 0;  // zero for the next call
  store();
}

template <int D, typename PT>
static cudaError_t launch_split_t(const AttnArgs& a, int S, float* part,
                                  int* count, int splits,
                                  cudaStream_t stream) {
  constexpr size_t smem = split_smem<D>();
  auto kern = decode_split_kernel<D, PT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(S, a.n_kv, splits * ((a.R + kRows - 1) / kRows));
  kern<<<grid, kThreads, smem, stream>>>(a, part, count, splits);
  return cudaGetLastError();
}

template <typename PT>
static cudaError_t launch_split_pool(const AttnArgs& a, int S, float* part,
                                     int* count, int splits,
                                     cudaStream_t st) {
  switch (a.dh) {
    case 16: return launch_split_t<16, PT>(a, S, part, count, splits, st);
    case 32: return launch_split_t<32, PT>(a, S, part, count, splits, st);
    case 48: return launch_split_t<48, PT>(a, S, part, count, splits, st);
    case 64: return launch_split_t<64, PT>(a, S, part, count, splits, st);
    case 80: return launch_split_t<80, PT>(a, S, part, count, splits, st);
    case 96: return launch_split_t<96, PT>(a, S, part, count, splits, st);
    case 112: return launch_split_t<112, PT>(a, S, part, count, splits, st);
    case 128: return launch_split_t<128, PT>(a, S, part, count, splits, st);
  }
  return cudaErrorInvalidValue;
}

// bf16 q (and window) over bf16 or int8 pools
static cudaError_t launch_split(const AttnArgs& a, int S, int q_dtype,
                                int pool_dtype, float* part, int* count,
                                cudaStream_t st) {
  if (q_dtype != kBF16 || a.fill == nullptr) return cudaErrorInvalidValue;
  const int splits = (a.M * a.bs + kSplitKeys - 1) / kSplitKeys;
  if (pool_dtype == kBF16)
    return launch_split_pool<bf16>(a, S, part, count, splits, st);
  if (pool_dtype == kI8)
    return launch_split_pool<int8_t>(a, S, part, count, splits, st);
  return cudaErrorInvalidValue;
}

}  // namespace dec
}  // namespace tpd

// arm 1: the split walk on the tensor cores, with `part` an f32 workspace
// of [S, n_kv, ceil(R / 16), ceil(M * bs / 128), D / 2 + 4, 32] floats and
// `count` [S, n_kv, ceil(R / 16)] int32 zeros (left zero); arm 0: the
// CUDA-core walk (part and count unused)
extern "C" int tpd_paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* scale_k, const void* scale_v, const void* table,
    const void* pos0, const void* fill, const void* wk, const void* wv,
    void* out, void* part, void* count, int S, int n_kv, int R, int s,
    int dh, int nb, int bs, int M, int W, int layer, int window, float scale,
    int q_dtype, int pool_dtype, int arm, void* stream) {
  tpd::AttnArgs a;
  a.q = q;
  a.pool_k = pool_k;
  a.pool_v = pool_v;
  a.scale_k = static_cast<const float*>(scale_k);
  a.scale_v = static_cast<const float*>(scale_v);
  a.table = static_cast<const int*>(table);
  a.pos0 = static_cast<const int*>(pos0);
  a.fill = static_cast<const int*>(fill);
  a.wk = wk;
  a.wv = wv;
  a.out = out;
  a.n_kv = n_kv;
  a.R = R;
  a.s = s;
  a.dh = dh;
  a.nb = nb;
  a.bs = bs;
  a.M = M;
  a.W = W;
  a.layer = layer;
  a.window = window;
  a.scale = scale;
  a.rt = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || n_kv <= 0 || R <= 0) return 0;
  if (arm == 1)
    return (int)tpd::dec::launch_split(a, S, q_dtype, pool_dtype,
                                       static_cast<float*>(part),
                                       static_cast<int*>(count), st);
  if (arm == 0)
    return (int)tpd::launch_attention(a, S, q_dtype, pool_dtype, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
