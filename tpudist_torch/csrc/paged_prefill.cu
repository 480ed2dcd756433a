// Paged prefill attention with block writes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/paged_prefill.py
// (paged_prefill_attention, body _kernel): a chunk's attention over its
// reused prefix out of the pool, then over the chunk itself under the
// causal mask col <= i (row r of a kv head's R = group * P query rows is
// chunk row i = r % P), and the touched blocks [pos0, pos0 + clen) merged
// and requantized into SEPARATE outputs.  The pool is never written in
// place here: a lane's partially filled first block is read by the prefix
// walk and rewritten by the writes, and CTAs run in no order, so in-place
// writes would race.  The caller commits the outputs with
// _Paged.commit_quantized.  The wrapper's plan picks one of two arms
// (tpudist_torch/ops/paged_prefill.py _prefill_plan):
//
// - the tensor-core arm (bf16 compute, head dims that are multiples of 16
//   up to 128), one launch.  An attention CTA per (slot, kv head, tile of 64 query rows)
//   of 8 warps: a warp holds 16 rows' Q in registers as mma.sync
//   A fragments and takes one half of every 64-key K/V tile, so two warps
//   share each SM sub-partition's tensor core; the halves' (m, l, O) merge
//   once at the end.  The prefix is gathered block by block through the
//   table (cp.async 16-byte copies of bf16 pools straight into shared
//   memory; int8 and f32 pools dequantize through registers) into three
//   tile buffers, so two gathers are in flight behind each tile's
//   products, one barrier a tile; then the chunk's K/V in tiles of 64 rows.
//   S = Q.K^T and O += P.V run on bf16 mma.sync m16n8k16 with f32
//   accumulation, the online softmax in registers (flash_common.cuh).  A
//   write CTA per (slot, kv head) in the same grid merges and requantizes
//   that head's touched blocks (16-byte chunks, a warp a block) beside the
//   attention CTAs, on SMs they leave idle;
// - the CUDA-core arm (f32 compute, or bf16 at another head dim), two
//   launches: the decode kernel's code of paged_common.cuh with s = P,
//   fill = 0 and the chunk as the fresh block, in full f32 (never TF32),
//   then the same block writes as a kernel of their own.
//
// The writes merge K and V in one pass (int8: amax / 127, round half to
// even, true division, K's and V's reductions together).
//
// Bound on the H100: bytes at the main path's shapes.  A chunk of 64 rows
// does 4 * 64 flops per K/V element against 2 bytes of bf16, ~128 flops
// per byte, under the ~295 flops/byte ridge; the writes are pure data
// movement.  At the serving shape (8 slots, 8 kv heads, prefixes of at
// most 256 tokens) the work is so small that latency sets the time: the
// longest CTA's serial steps, one per 64 keys.  Numerics: paged_common.cuh's
// contract (int8 dequantizes as round_ct(float(q8) * round_ct(scale)),
// scores in f32 scaled by dh^-0.5, masked scores -1e30, columns past the
// chunk -inf, the unnormalized probabilities rounded to bf16 before P.V);
// only the order of the sums differs between the arms.
#include "flash_common.cuh"
#include "paged_common.cuh"
#include "paged_tc.cuh"

namespace tpd {

// ------------------------------------------------ the block writes

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

// max over the CTA of (x, y) in one reduction; red holds 64 floats
__device__ __forceinline__ float2 block_max2(float x, float y, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = x, red[32 + warp] = y;
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (int)(blockDim.x / 32);
    x = in ? red[lane] : 0.f;
    y = in ? red[32 + lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, off));
    }
    if (lane == 0) red[0] = x, red[32] = y;
  }
  __syncthreads();
  const float2 out = make_float2(red[0], red[32]);
  __syncthreads();  // red is reused by the next block
  return out;
}

// Touched block w of lane b, kv head h: the chunk's K and V merged over the
// block's original contents at positions [pos0, pos0 + clen), in storage
// form with their scales, K and V in the same pass.  A thread loads kU
// elements of each before it stores any, so their loads are in flight
// together.  int8 requantizes with amax / 127 (one reduction for K and V)
// and re-reads the merged values for its second pass instead of staging
// them.
constexpr int kU = 8;

template <typename CT, typename PT>
__device__ void write_block(const WriteArgs& a, int b, int w, int h,
                            float* red) {
  const int bs = a.bs, dh = a.dh, n = bs * dh, T = blockDim.x;
  const int bid = max(0, min(a.wtable[b * a.Mw + w], a.nb - 1));
  const int pos0 = a.pos0[b], cl = a.clen[b];
  const int blk0 = (pos0 / bs + w) * bs;
  const size_t blk = (size_t)(a.layer * a.nb + bid) * a.n_kv + h;
  const float sk = round_to<CT>(a.scale_k[blk]);
  const float sv = round_to<CT>(a.scale_v[blk]);
  const PT* __restrict__ pk = static_cast<const PT*>(a.pool_k) + blk * n;
  const PT* __restrict__ pv = static_cast<const PT*>(a.pool_v) + blk * n;
  const size_t head = ((size_t)b * a.n_kv + h) * a.P * dh;
  const CT* __restrict__ ck = static_cast<const CT*>(a.k_new) + head;
  const CT* __restrict__ cv = static_cast<const CT*>(a.v_new) + head;
  const size_t o = ((size_t)b * a.Mw + w) * a.n_kv + h;
  PT* __restrict__ ok = static_cast<PT*>(a.out_k) + o * n;
  PT* __restrict__ ov = static_cast<PT*>(a.out_v) + o * n;
  // the merged values of this thread's elements base + u * T + tid
  auto load = [&](int base, float* k, float* v) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = base + u * T + threadIdx.x;
      k[u] = v[u] = 0.f;
      if (e >= n) continue;
      const int t = e / dh, kpos = blk0 + t;
      if (kpos >= pos0 && kpos < pos0 + cl) {
        const size_t i = (size_t)(kpos - pos0) * dh + (e - t * dh);
        k[u] = to_float(ck[i]);
        v[u] = to_float(cv[i]);
      } else {
        k[u] = pool_value<CT, PT>(pk[e], sk);
        v[u] = pool_value<CT, PT>(pv[e], sv);
      }
    }
  };
  float k[kU], v[kU];
  if constexpr (std::is_same<PT, int8_t>::value) {
    float mk = 0.f, mv = 0.f;
    for (int base = 0; base < n; base += kU * T) {
      load(base, k, v);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        mk = fmaxf(mk, fabsf(k[u]));
        mv = fmaxf(mv, fabsf(v[u]));
      }
    }
    const float2 amax = block_max2(mk, mv, red);
    const float qk = amax.x > 0.f ? amax.x / 127.0f : 1.0f;
    const float qv = amax.y > 0.f ? amax.y / 127.0f : 1.0f;
    for (int base = 0; base < n; base += kU * T) {
      load(base, k, v);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = base + u * T + threadIdx.x;
        if (e >= n) break;
        ok[e] = static_cast<int8_t>(
            fminf(fmaxf(rintf(k[u] / qk), -127.f), 127.f));
        ov[e] = static_cast<int8_t>(
            fminf(fmaxf(rintf(v[u] / qv), -127.f), 127.f));
      }
    }
    if (threadIdx.x == 0) a.out_sk[o] = qk, a.out_sv[o] = qv;
  } else {
    for (int base = 0; base < n; base += kU * T) {
      load(base, k, v);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = base + u * T + threadIdx.x;
        if (e >= n) break;
        ok[e] = from_float<PT>(k[u]);
        ov[e] = from_float<PT>(v[u]);
      }
    }
    if (threadIdx.x == 0) a.out_sk[o] = 1.0f, a.out_sv[o] = 1.0f;
  }
}

// the CUDA-core arm's writes: one CTA per (slot, touched block, kv head)
template <typename CT, typename PT>
__global__ void __launch_bounds__(kWriteThreads)
    prefill_write_kernel(WriteArgs a) {
  __shared__ float red[64];
  write_block<CT, PT>(a, blockIdx.x, blockIdx.y, blockIdx.z, red);
}

template <typename CT, typename PT>
static cudaError_t launch_write_t(const WriteArgs& a, int S,
                                  cudaStream_t stream) {
  dim3 grid(S, a.Mw, a.n_kv);
  prefill_write_kernel<CT, PT><<<grid, kWriteThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t launch_write(const WriteArgs& a, int S, int q_dtype,
                                int pool_dtype, cudaStream_t stream) {
  if (a.Mw == 0) return cudaSuccess;
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

// ------------------------------------------------ the tensor-core arm

namespace tc {

using tpd_flash::bf16;
using tpd_flash::cp_async16;
using tpd_flash::exp_row;

constexpr int kTile = 64;     // keys per K/V tile
constexpr int kStages = 3;    // K/V tile buffers: two in flight, one in use
constexpr int kRowWarps = 4;  // warps over a CTA's query rows, 16 rows each
constexpr int kGroups = 2;    // key groups: each warp takes half of a tile
// query rows per CTA: 64 ran faster than 32 on the H100 in every timed call
constexpr int kRows = 16 * kRowWarps;
constexpr int kThreads = 32 * kRowWarps * kGroups;

// The touched blocks of slot b, kv head h in one CTA, the tensor-core arm's
// writes: warp i merges blocks i, i + nwarps, ...; a lane moves chunks of 8
// values, U of them in flight (head dims are multiples of 16 here, so a
// chunk lies in one row, all of it from the chunk or all from the pool).
// int8 reduces each block's amax within its warp.  One such CTA per (slot,
// kv head) keeps the write CTAs few enough to run beside the attention
// CTAs in their first wave.
template <typename PT>
__device__ void write_head(const WriteArgs& a, int b, int h) {
  constexpr int U = 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bs = a.bs, dh = a.dh, n = bs * dh, nch = n / 8;
  const int pos0 = a.pos0[b], cl = a.clen[b];
  const size_t head = ((size_t)b * a.n_kv + h) * a.P * dh;
  const bf16* ck = static_cast<const bf16*>(a.k_new) + head;
  const bf16* cv = static_cast<const bf16*>(a.v_new) + head;
  for (int w = warp; w < a.Mw; w += blockDim.x / 32) {
    const int bid = max(0, min(a.wtable[b * a.Mw + w], a.nb - 1));
    const int blk0 = (pos0 / bs + w) * bs;
    const size_t blk = (size_t)(a.layer * a.nb + bid) * a.n_kv + h;
    const float sk = round_to<bf16>(a.scale_k[blk]);
    const float sv = round_to<bf16>(a.scale_v[blk]);
    const PT* pk = static_cast<const PT*>(a.pool_k) + blk * n;
    const PT* pv = static_cast<const PT*>(a.pool_v) + blk * n;
    const size_t o = ((size_t)b * a.Mw + w) * a.n_kv + h;
    PT* ok = static_cast<PT*>(a.out_k) + o * n;
    PT* ov = static_cast<PT*>(a.out_v) + o * n;
    float k[U][8], v[U][8];
    // the merged chunks j0 + u * 32 + lane, u < U (zeros past the block)
    auto load = [&](int j0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * 32 + lane, t = 8 * j / dh, kpos = blk0 + t;
        if (j >= nch) {
#pragma unroll
          for (int e = 0; e < 8; ++e) k[u][e] = v[u][e] = 0.f;
        } else if (kpos >= pos0 && kpos < pos0 + cl) {
          const size_t i = (size_t)(kpos - pos0) * dh + 8 * j - t * dh;
          load8<bf16>(ck + i, 1.f, k[u]);
          load8<bf16>(cv + i, 1.f, v[u]);
        } else {
          load8<PT>(pk + 8 * j, sk, k[u]);
          load8<PT>(pv + 8 * j, sv, v[u]);
        }
      }
    };
    float qk = 1.f, qv = 1.f;
    if constexpr (std::is_same<PT, int8_t>::value) {
      float mk = 0.f, mv = 0.f;
      for (int j0 = 0; j0 < nch; j0 += 32 * U) {
        load(j0);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            mk = fmaxf(mk, fabsf(k[u][e]));
            mv = fmaxf(mv, fabsf(v[u][e]));
          }
      }
      mk = tpd_flash::warp_max(mk);
      mv = tpd_flash::warp_max(mv);
      qk = mk > 0.f ? mk / 127.0f : 1.0f;
      qv = mv > 0.f ? mv / 127.0f : 1.0f;
    }
    for (int j0 = 0; j0 < nch; j0 += 32 * U) {
      load(j0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * 32 + lane;
        if (j < nch) {
          store8<PT>(ok + 8 * j, k[u], qk);
          store8<PT>(ov + 8 * j, v[u], qv);
        }
      }
    }
    if (lane == 0) a.out_sk[o] = qk, a.out_sv[o] = qv;
  }
}

// One launch, two kinds of CTA.  blockIdx.z < ntiles = ceil(R / kRows):
// the attention of kv head h of slot b over query rows [r0, r0 + kRows)
// of the head's R = group * P rows (q heads are kv-major, so a tile may
// span q heads).  blockIdx.z = ntiles (when the call writes blocks): the
// touched blocks of (b, h) (write_head), beside the attention CTAs.
//
// Attention: warp w takes rows (w % kRowWarps) * 16.. and key half
// w / kRowWarps of every 64-key tile, so two warps share each SM
// sub-partition's tensor core and hide each other's latency; the halves
// merge once, at the end.  The walk:
// prefix tiles [pf, pl], then chunk tiles [cf, cl]; a window drops leading
// tiles wholly outside it for every row of the CTA (their columns would
// mask to weight 0: only the order of the sum moves), and chunk tiles past
// the CTA's last own column are never needed.  One barrier a tile: tile
// s + 2 is issued after tile s's score product, into the buffer every warp
// left at that barrier, so two gathers are in flight behind each tile's
// products.
template <int D, typename PT>
__global__ void __launch_bounds__(kThreads)
    prefill_tc_kernel(AttnArgs a, WriteArgs wa) {
  static_assert(D % 16 == 0 && D <= 128, "bf16 tiles: head dim 16..128");
  constexpr int THREADS = kThreads, ROWS = kRows, LD = D + 8;
  constexpr int HALF = kTile / kGroups, DN = D / 8, KD = D / 16;
  constexpr int NT = HALF / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  if (blockIdx.z == (a.R + ROWS - 1) / ROWS) {
    write_head<PT>(wa, b, h);
    return;
  }
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [ROWS][LD]
  bf16* KV = Qs + ROWS * LD;  // kStages x {K, V} [kTile][LD]
  const int r0 = blockIdx.z * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % kRowWarps, kg = warp / kRowWarps;
  const int g = lane >> 2, tq = lane & 3;
  const int P = a.s, R = a.R, window = a.window;
  const int pos0 = a.pos0[b];
  const int kend = min(pos0, a.M * a.bs);

  // chunk rows [imin, imax] of this CTA's live query rows
  const int nrows = min(ROWS, R - r0);
  int imin = r0 % P, imax = imin + nrows - 1;
  if (imax >= P) imin = 0, imax = P - 1;
  int pf = 0, cf = 0;
  if (window > 0) {
    pf = max(0, pos0 + imin - window + 1) / kTile;
    cf = max(0, imin - window + 1) / kTile;
  }
  const int pl = (kend + kTile - 1) / kTile - 1;
  const int np = max(0, pl - pf + 1);
  const int steps = np + imax / kTile - cf + 1;

  const size_t head = (size_t)b * a.n_kv + h;
  const bf16* q = static_cast<const bf16*>(a.q) + head * R * D;
  const bf16* wk = static_cast<const bf16*>(a.wk) + head * P * D;
  const bf16* wv = static_cast<const bf16*>(a.wv) + head * P * D;
  auto issue = [&](int s) {  // always one group, empty past the walk
    bf16* Ks = KV + (s % kStages) * 2 * kTile * LD;
    bf16* Vs = Ks + kTile * LD;
    if (s < np) {
      load_prefix_tile<D, kTile, THREADS, PT>(Ks, Vs, a, b, h,
                                              (pf + s) * kTile, kend,
                                              threadIdx.x);
    } else if (s < steps) {
      const int t0 = (cf + s - np) * kTile;
      tpd_flash::load_tile_async<kTile, D>(Ks, wk, t0, P);
      tpd_flash::load_tile_async<kTile, D>(Vs, wv, t0, P);
    }
    tpd_flash::cp_commit();
  };
  tpd_flash::load_tile_async<ROWS, D>(Qs, q, r0, R);
  issue(0);  // one group: Q and the first tile
  issue(1);

  int irow[2];  // chunk row of this thread's two fragment rows
#pragma unroll
  for (int r = 0; r < 2; ++r) irow[r] = (r0 + rw * 16 + g + r * 8) % P;
  float o[DN][4] = {};
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  uint32_t qa[KD][4];
  for (int s = 0; s < steps; ++s) {
    tpd_flash::cp_wait<kStages - 2>();
    __syncthreads();
    if (s == 0)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tpd_flash::load_a(qa[kk], Qs, LD, rw * 16, kk * 16, lane);
    const bf16* Ks = KV + (s % kStages) * 2 * kTile * LD + kg * HALF * LD;
    const bf16* Vs = Ks + kTile * LD;
    float sc[NT][4] = {};
    tpd_flash::mma_abt<NT, KD>(sc, qa, Ks, LD, lane);
    issue(s + kStages - 1);
    const bool prefix = s < np;
    const int k0 = (prefix ? pf + s : cf + s - np) * kTile + kg * HALF;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + tq * 2 + (e & 1), i = irow[e >> 1];
        bool keep;
        if (prefix) {
          keep = col < kend && (window <= 0 || col > pos0 + i - window);
        } else {
          keep = col <= i && (window <= 0 || col > i - window);
        }
        sc[n][e] = !prefix && col >= P ? -INFINITY
                   : keep              ? sc[n][e] * a.scale
                                       : kMaskValue;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp_row(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
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
    tpd_flash::mma_pt<DN, HALF / 16>(o, sc, Vs, LD, lane);
  }

  // merge the key halves (the tiles' buffers, free now, hold group 1's
  // state, element-major so a warp's stores are contiguous): the weights
  // of a half whose row saw no live column (m = -1e30) correct to 0
  tpd_flash::cp_wait<0>();
  __syncthreads();
  constexpr int T = kRowWarps * 32;
  float* xs = reinterpret_cast<float*>(KV);  // [DN * 4 + 4][T]
  const int t = threadIdx.x % T;
  if (kg == 1) {
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(dn * 4 + e) * T + t] = o[dn][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xs[(DN * 4 + r) * T + t] = m[r];
      xs[(DN * 4 + 2 + r) * T + t] = l[r];
    }
  }
  __syncthreads();
  if (kg == 1) return;
  bf16* out = static_cast<bf16*>(a.out) + head * R * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xs[(DN * 4 + r) * T + t];
    const float mx = fmaxf(m[r], m1);
    const float c0 = exp_row(m[r], mx), c1 = exp_row(m1, mx);
    // every query keeps at least its own column, so l > 0
    const float lt = l[r] * c0 + xs[(DN * 4 + 2 + r) * T + t] * c1;
    const int row = r0 + rw * 16 + g + r * 8;
    if (row >= R) continue;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const float x = o[dn][2 * r] * c0 + xs[(dn * 4 + 2 * r) * T + t] * c1;
      const float y =
          o[dn][2 * r + 1] * c0 + xs[(dn * 4 + 2 * r + 1) * T + t] * c1;
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + dn * 8 +
                                         tq * 2) =
          __floats2bfloat162_rn(x / lt, y / lt);
    }
  }
}

template <int D, typename PT>
static cudaError_t launch_t(const AttnArgs& a, const WriteArgs& w, int S,
                            cudaStream_t stream) {
  const size_t smem =
      (size_t)(kRows + 2 * kStages * kTile) * (D + 8) * sizeof(bf16);
  auto kern = prefill_tc_kernel<D, PT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(S, a.n_kv, (a.R + kRows - 1) / kRows + (w.Mw > 0));
  kern<<<grid, kThreads, smem, stream>>>(a, w);
  return cudaGetLastError();
}

template <typename PT>
static cudaError_t launch_pool(const AttnArgs& a, const WriteArgs& w, int S,
                               cudaStream_t st) {
  switch (a.dh) {
    case 16: return launch_t<16, PT>(a, w, S, st);
    case 32: return launch_t<32, PT>(a, w, S, st);
    case 48: return launch_t<48, PT>(a, w, S, st);
    case 64: return launch_t<64, PT>(a, w, S, st);
    case 80: return launch_t<80, PT>(a, w, S, st);
    case 96: return launch_t<96, PT>(a, w, S, st);
    case 112: return launch_t<112, PT>(a, w, S, st);
    case 128: return launch_t<128, PT>(a, w, S, st);
  }
  return cudaErrorInvalidValue;
}

// bf16 compute only: q, the chunk's K/V and the output are bf16
static cudaError_t launch(const AttnArgs& a, const WriteArgs& w, int S,
                          int pool_dtype, cudaStream_t st) {
  if (pool_dtype == kBF16) return launch_pool<bf16>(a, w, S, st);
  if (pool_dtype == kI8) return launch_pool<int8_t>(a, w, S, st);
  if (pool_dtype == kF32) return launch_pool<float>(a, w, S, st);
  return cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace tpd

extern "C" int tpd_paged_prefill(
    const void* q, const void* k_new, const void* v_new, const void* pool_k,
    const void* pool_v, const void* scale_k, const void* scale_v,
    const void* table, const void* wtable, const void* pos0, const void* clen,
    void* out, void* out_k, void* out_v, void* out_sk, void* out_sv, int S,
    int n_kv, int R, int P, int dh, int nb, int bs, int M, int Mw, int layer,
    int window, float scale, int q_dtype, int pool_dtype, int tensor_cores,
    void* stream) {
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
  if (tensor_cores) {  // one launch: attention and block writes
    if (q_dtype != tpd::kBF16) return (int)cudaErrorInvalidValue;
    return (int)tpd::tc::launch(a, w, S, pool_dtype, st);
  }
  cudaError_t e = tpd::launch_attention(a, S, q_dtype, pool_dtype, st);
  if (e != cudaSuccess) return (int)e;
  return (int)tpd::launch_write(w, S, q_dtype, pool_dtype, st);
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
