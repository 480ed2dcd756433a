// LoRA gather-matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/fused_linear.py (lora_delta,
// body _lora_kernel): out[s] = (x[s] · A[layer, id]) · B[layer, id] with
// id = min(ids[s], B - 1), reading each slot's factor block straight from
// the full f32 pools ([L, B, d_in, r] and [L, B, r, d_out]) — no gathered
// copy.  Sentinel ids clamp into a real block; the caller's on-mask select
// discards those lanes.
//
// Rounding follows the Pallas kernel (jnp.dot of compute-dtype operands):
// the f32 factors round to the compute dtype as they load (nearest even);
// the [T, r] intermediate accumulates in f32 and rounds to the compute
// dtype; the second product accumulates in f32 and rounds.
//
// Bound on the H100: bytes.  At rank 8 the work is 2·r flops per x and out
// element, far below the tensor cores' share, and the traffic is x, the
// output tile and each slot's factor blocks.  At decode (one row a slot)
// that is a few thousand FMAs a slot: the time is the chain of dependent
// loads and barriers, so the two arms (the wrapper picks by T) cut it.
//
// - cluster arm (T <= kDecodeRows: decode, the draft steps, the
//   speculative verify's K + 1 rows): one thread-block cluster of kCluster
//   CTAs a slot.  CTA c reads the c-th slice of A's depth straight into
//   registers with 16-byte loads, multiplies it by the same slice of x and
//   sums over its warps in shared memory; the loads of its own d_out /
//   kCluster columns of B are issued with the A loads, so they overlap the
//   A read and the barrier.  Each CTA writes its partial [T, r] sum into
//   its slot of every CTA's shared memory (distributed shared memory
//   stores), and after one cluster barrier every CTA adds the kCluster
//   slots in the same order (rank 0 first), so all hold the same total,
//   and rounds it as the plain version does; then it writes its columns.
//   One load wave, one block reduction, one cluster barrier (and the wait
//   half of one whose arrive opens the kernel, so no CTA writes into
//   another that has not started), one store; no CTA reads another's
//   shared memory, so none waits to leave.
// - staged arm (longer T: the prefill chunk): a CTA owns one slot, 16 rows
//   of its T and 256 output columns.  It recomputes the slot's [16, r]
//   intermediate (cheap at small r) with the A block staged through shared
//   memory in depth chunks, so each CTA reads it from L2 once, and its
//   warps split each chunk among them when the rows are few; then every
//   thread owns one output column, holds its r B-factor values in
//   registers and writes the column's rows.
//
// Any rank r >= 1.  A rank that is one of the widths 1, 2, 4, ..., 64 runs
// kernels compiled with the rank fixed at it (kFixed: every index and loop
// bound a constant; the staged arm's is lora_kernel).  Any other rank runs
// at the first of the padded widths 4, 16 and 64 that holds it, the rank
// taken at run time and its columns past r loading as zeros; a rank past
// 64 runs in chunks of 64 columns of the intermediate (the cluster arm sums
// each chunk over the cluster in turn into a [T, r] intermediate in
// dynamic shared memory, lora_kernel_padded carries each column's [16]
// output sums in registers across the chunks), so the intermediate still
// rounds once an element and the second product still sums over r in
// order before it rounds.  The cluster arm's intermediate takes 32·r bytes
// of shared memory: the wrapper sends ranks past LORA_CLUSTER_MAX_RANK to
// the staged arm.
//
// Products on CUDA-core FMAs in f32 for both dtypes (products of bf16
// values are exact in f32; never TF32).
#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace {

using tpd_flash::bf16;

constexpr int kThreads = 256;  // 8 warps; one output column per thread
constexpr int kWarps = kThreads / 32;
constexpr int kRowsT = 16;     // rows of T per CTA: at most 2 per warp
constexpr int kColsN = kThreads;
constexpr int kCluster = 8;     // CTAs a cluster (the portable maximum)
constexpr int kDecodeRows = 8;  // T up to this takes the cluster arm
constexpr int kMaxWidth = 64;   // the widest rank width; wider ranks chunk

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
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    lora_kernel(const T* x, const float* pool_a, const float* pool_b,
                const int* ids, T* out, int T_len, int d_in, int d_out,
                int B, int layer) {
  // depth rows of A staged per pass: 16 KB of shared memory (8 KB at rank
  // 64, where part[] takes 32 KB)
  constexpr int kChunk = (R >= 64 ? 2048 : 4096) / R;
  __shared__ float as[R * kChunk];  // [r][chunk], rounded to T
  __shared__ float part[kWarps][kRowsT][R];  // per depth slice
  __shared__ float mid[kRowsT][R];
  const int s = blockIdx.y, t0 = blockIdx.z * kRowsT;
  const int rows = min(kRowsT, T_len - t0);
  const int n = blockIdx.x * kColsN + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bid = max(0, min(ids[s], B - 1));
  const float* a = pool_a + ((size_t)layer * B + bid) * d_in * R;
  const float* b = pool_b + ((size_t)layer * B + bid) * R * d_out;

  // x[s] rows t0.. times A, the A block staged through shared memory in
  // depth chunks (read once per CTA).  A warp owns a row pair and a slice
  // of each chunk: with few rows (decode) the 8 warps split the chunk 8
  // ways, with 16 rows each warp takes all of it for its pair.  Lanes
  // stride the slice; then a warp sum, and a sum over the slices.
  const int pairs = (rows + 1) / 2;
  const int p2 = pairs > 4 ? 8 : pairs > 2 ? 4 : pairs > 1 ? 2 : 1;
  const int slices = kWarps / p2;
  const int pair = warp % p2, slice = warp / p2;
  const int r0 = 2 * pair;
  const bool live = pair < pairs, ok1 = r0 + 1 < rows;
  const T* x0 = x + ((size_t)s * T_len + t0 + r0) * d_in;
  const T* x1 = x0 + d_in;
  float acc0[R] = {}, acc1[R] = {};
  for (int k0 = 0; k0 < d_in; k0 += kChunk) {
    const int kc = min(kChunk, d_in - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kc * R; i += kThreads)
      as[(i % R) * kChunk + i / R] = rnd<T>(a[(size_t)k0 * R + i]);
    __syncthreads();
    if (!live) continue;  // warp-uniform
    const int span = (kc + slices - 1) / slices;
    const int kb = slice * span, ke = min(kc, kb + span);
    for (int k = kb + lane; k < ke; k += 32) {
      const float xv0 = to_f(x0[k0 + k]);
      const float xv1 = ok1 ? to_f(x1[k0 + k]) : 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float av = as[j * kChunk + k];
        acc0[j] = fmaf(xv0, av, acc0[j]);
        acc1[j] = fmaf(xv1, av, acc1[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float m0 = tpd_flash::warp_sum(acc0[j]);
    const float m1 = tpd_flash::warp_sum(acc1[j]);
    if (lane == 0 && live) {
      part[slice][r0][j] = m0;
      part[slice][r0 + 1][j] = m1;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * R; i += kThreads) {
    const int r = i / R, j = i % R;
    float m = 0.f;
    for (int sl = 0; sl < slices; ++sl) m += part[sl][r][j];
    mid[r][j] = rnd<T>(m);
  }
  __syncthreads();
  if (n >= d_out) return;
  float bv[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    bv[j] = rnd<T>(__ldg(b + (size_t)j * d_out + n));
  T* o = out + ((size_t)s * T_len + t0) * d_out + n;
  for (int r = 0; r < rows; ++r) {
    float y = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) y = fmaf(mid[r][j], bv[j], y);
    o[(size_t)r * d_out] = from_f<T>(y);
  }
}

// The staged arm at any rank r: the columns [j0, j0 + RP) of the
// intermediate at a time, each chunk's share of the second product summed
// into the column's rows in registers (the fixed-rank kernel above, chunk
// by chunk).
template <typename T, int RP>
__global__ void __launch_bounds__(kThreads)
    lora_kernel_padded(const T* x, const float* pool_a, const float* pool_b,
                       const int* ids, T* out, int T_len, int d_in,
                       int d_out, int B, int r, int layer) {
  // depth rows of A staged per pass: 16 KB of shared memory (8 KB at width
  // 64, where part[] takes 32 KB)
  constexpr int kChunk = (RP >= 64 ? 2048 : 4096) / RP;
  __shared__ float as[RP * kChunk];  // [RP][chunk], rounded to T
  __shared__ float part[kWarps][kRowsT][RP];  // per depth slice
  __shared__ float mid[kRowsT][RP];
  const int s = blockIdx.y, t0 = blockIdx.z * kRowsT;
  const int rows = min(kRowsT, T_len - t0);
  const int n = blockIdx.x * kColsN + threadIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bid = max(0, min(ids[s], B - 1));
  const float* a = pool_a + ((size_t)layer * B + bid) * d_in * r;
  const float* b = pool_b + ((size_t)layer * B + bid) * r * d_out;

  // x[s] rows t0.. times A's columns [j0, j0 + RP), the A block staged
  // through shared memory in depth chunks (read once per CTA).  A warp owns
  // a row pair and a slice of each chunk: with few rows (decode) the 8
  // warps split the chunk 8 ways, with 16 rows each warp takes all of it
  // for its pair.  Lanes stride the slice; then a warp sum, and a sum over
  // the slices.
  const int pairs = (rows + 1) / 2;
  const int p2 = pairs > 4 ? 8 : pairs > 2 ? 4 : pairs > 1 ? 2 : 1;
  const int slices = kWarps / p2;
  const int pair = warp % p2, slice = warp / p2;
  const int r0 = 2 * pair;
  const bool live = pair < pairs, ok1 = r0 + 1 < rows;
  const T* x0 = x + ((size_t)s * T_len + t0 + r0) * d_in;
  const T* x1 = x0 + d_in;
  float y[kRowsT] = {};  // this thread's column, summed over the chunks
  for (int j0 = 0; j0 < r; j0 += RP) {
    const int rc = min(RP, r - j0);
    float acc0[RP] = {}, acc1[RP] = {};
    for (int k0 = 0; k0 < d_in; k0 += kChunk) {
      const int kc = min(kChunk, d_in - k0);
      __syncthreads();
      for (int i = threadIdx.x; i < kc * RP; i += kThreads) {
        const int kk = i / RP, jj = i % RP;
        as[jj * kChunk + kk] =
            jj < rc ? rnd<T>(a[(size_t)(k0 + kk) * r + j0 + jj]) : 0.f;
      }
      __syncthreads();
      if (!live) continue;  // warp-uniform
      const int span = (kc + slices - 1) / slices;
      const int kb = slice * span, ke = min(kc, kb + span);
      for (int k = kb + lane; k < ke; k += 32) {
        const float xv0 = to_f(x0[k0 + k]);
        const float xv1 = ok1 ? to_f(x1[k0 + k]) : 0.f;
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const float av = as[j * kChunk + k];
          acc0[j] = fmaf(xv0, av, acc0[j]);
          acc1[j] = fmaf(xv1, av, acc1[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      const float m0 = tpd_flash::warp_sum(acc0[j]);
      const float m1 = tpd_flash::warp_sum(acc1[j]);
      if (lane == 0 && live) {
        part[slice][r0][j] = m0;
        part[slice][r0 + 1][j] = m1;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * RP; i += kThreads) {
      const int rr = i / RP, j = i % RP;
      float m = 0.f;
      for (int sl = 0; sl < slices; ++sl) m += part[sl][rr][j];
      mid[rr][j] = rnd<T>(m);
    }
    __syncthreads();
    // the chunk's columns of the second product, in order, its B values
    // loaded together (the next chunk's first barrier keeps mid until
    // every thread is done; padded columns add 0 · 0)
    T* o = out + ((size_t)s * T_len + t0) * d_out + n;
    if (n >= d_out) continue;
    float bv[RP];
#pragma unroll
    for (int j = 0; j < RP; ++j)
      bv[j] = j < rc ? rnd<T>(__ldg(b + (size_t)(j0 + j) * d_out + n)) : 0.f;
#pragma unroll
    for (int t = 0; t < kRowsT; ++t) {
      if (t >= rows) break;
#pragma unroll
      for (int j = 0; j < RP; ++j) y[t] = fmaf(mid[t][j], bv[j], y[t]);
    }
    if (j0 + RP >= r) {  // the last chunk: the column's rows are summed
#pragma unroll
      for (int t = 0; t < kRowsT; ++t) {
        if (t >= rows) break;
        o[(size_t)t * d_out] = from_f<T>(y[t]);
      }
    }
  }
}

// The cluster barrier in two halves: arrive (relaxed: it orders nothing)
// and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The arrive half with release semantics: this thread's shared-memory reads
// before it are done before any CTA passes the matching wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

// Four consecutive floats of A from flat index f of a slice of n: one
// 16-byte load where the slice is aligned (vec) and holds all four, else
// element by element, zero past the end.
__device__ __forceinline__ float4 load4(const float* a, int f, int n,
                                        bool vec) {
  if (vec && f + 3 < n) return __ldg(reinterpret_cast<const float4*>(a + f));
  float4 v;
  v.x = f < n ? __ldg(a + f) : 0.f;
  v.y = f + 1 < n ? __ldg(a + f + 1) : 0.f;
  v.z = f + 2 < n ? __ldg(a + f + 2) : 0.f;
  v.w = f + 3 < n ? __ldg(a + f + 3) : 0.f;
  return v;
}

// Virtual elements f..f+3 of a chunk's [rows][RP] view of A's slice a
// (real row stride r, the chunk's rc columns from j0; nflat = rows · RP):
// for RP >= 4 the four share a row and are real columns j0 + f % RP.., one
// 16-byte load where vec (r % 4 == 0) and all four are real, zero past rc
// or the slice's end.  Where the rank is its width (kFixed, and every rank
// below 4) the view is the slice itself.
template <int RP, bool kFixed>
__device__ __forceinline__ float4 load_chunk4(const float* a, int f,
                                              int nflat, int r, int j0,
                                              int rc, bool vec) {
  if constexpr (RP < 4 || kFixed) {  // the view is the slice
    return load4(a, f, nflat, vec);
  } else {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f >= nflat) return v;
    const int jj = f % RP;
    const float* p = a + (size_t)(f / RP) * r + j0 + jj;
    if (vec && jj + 3 < rc) return __ldg(reinterpret_cast<const float4*>(p));
    v.x = jj < rc ? __ldg(p) : 0.f;
    v.y = jj + 1 < rc ? __ldg(p + 1) : 0.f;
    v.z = jj + 2 < rc ? __ldg(p + 2) : 0.f;
    v.w = jj + 3 < rc ? __ldg(p + 3) : 0.f;
    return v;
  }
}

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// One output column of the cluster arm: its T_len rows from the rounded
// intermediate mid [kDecodeRows][r] and the column's B values (the first
// RP prefetched in bq, the rest read here from bcol, the column's first),
// summed over the rank in order: row by row where the rank is the width
// (kFixed: only the T_len live rows run), else B value by B value.
template <typename T, int RP, bool kFixed>
__device__ __forceinline__ void write_column(const float* mid, int r,
                                             const float (&bq)[RP],
                                             const float* bcol, T* o,
                                             int T_len, int d_out) {
  if constexpr (kFixed) {
#pragma unroll
    for (int t = 0; t < kDecodeRows; ++t) {
      if (t >= T_len) break;
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < RP; ++j) y = fmaf(mid[t * RP + j], bq[j], y);
      o[(size_t)t * d_out] = from_f<T>(y);
    }
  } else {
    float y[kDecodeRows] = {};
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      if (j >= r) break;
#pragma unroll
      for (int t = 0; t < kDecodeRows; ++t)
        if (t < T_len) y[t] = fmaf(mid[t * r + j], bq[j], y[t]);
    }
    for (int j = RP; j < r; ++j) {
      const float bj = rnd<T>(__ldg(bcol + (size_t)j * d_out));
#pragma unroll
      for (int t = 0; t < kDecodeRows; ++t)
        if (t < T_len) y[t] = fmaf(mid[t * r + j], bj, y[t]);
    }
#pragma unroll
    for (int t = 0; t < kDecodeRows; ++t)
      if (t < T_len) o[(size_t)t * d_out] = from_f<T>(y[t]);
  }
}

// The cluster arm: grid (kCluster, S), clusters of (kCluster, 1, 1), one
// cluster a slot; T_len <= kDecodeRows; dynamic shared memory
// cluster_smem(r) for the [T, r] intermediate.  vec: A's slices take
// 16-byte loads (the pool's pointer aligned, and r % 4 == 0 at width 4 and
// up, d_in · r % 4 == 0 below).
template <typename T, int RP, bool kFixed>
__global__ void __launch_bounds__(kThreads, 1)
    lora_cluster_kernel(const T* x, const float* pool_a, const float* pool_b,
                        const int* ids, T* out, int T_len, int d_in,
                        int d_out, int B, int r_arg, int layer, int vec) {
  const int r = kFixed ? RP : r_arg;
  constexpr int kJ = RP < 4 ? RP : 4;          // distinct j a thread holds
  constexpr int kLanes = RP < 4 ? 1 : RP / 4;  // lanes holding distinct j
  constexpr int kU = 4;                        // A loads in flight a thread
  constexpr int kStride = 4 * kThreads * kU;
  constexpr int kQ = RP <= 16 ? 2 : 1;         // B columns prefetched
  __shared__ float part[kWarps][kDecodeRows][RP];
  // a chunk's CTA sums, by rank (written by every CTA of the cluster)
  __shared__ float recv[kCluster][kDecodeRows][RP];
  extern __shared__ float mid[];  // [kDecodeRows][r], rounded
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank(), s = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this CTA's depth slice [k0, k1) (a multiple of 4 deep, so every slice
  // starts 16-byte aligned) and columns [n0, n1)
  const int ks = ((d_in + kCluster - 1) / kCluster + 3) & ~3;
  const int k0 = min(d_in, c * ks), k1 = min(d_in, k0 + ks);
  const int nflat = (k1 - k0) * RP;  // a chunk's view of the slice
  const int nc = (d_out + kCluster - 1) / kCluster;
  const int n0 = min(d_out, c * nc), n1 = min(d_out, n0 + nc);
  const T* xs = x + (size_t)s * T_len * d_in;
  // the writes into other CTAs' shared memory wait until every CTA of the
  // cluster runs; that barrier's arrive goes first, its wait after the loads
  cluster_arrive_relaxed();

  // thread tid takes the view's flat floats 4·tid + kStride·p + 4·256·u:
  // element e of each has j = (4·tid + e) % RP on every pass, and at RP >=
  // 4 one k for all four.  x first: it does not wait on ids[s].
  float xv[kU][kDecodeRows];
  auto load_x = [&](int base) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int f = base + 4 * kThreads * u;
      const int k = k0 + f / RP;
#pragma unroll
      for (int t = 0; t < kDecodeRows; ++t)
        xv[u][t] = RP >= 4 && f < nflat && t < T_len
                       ? to_f(xs[(size_t)t * d_in + k])
                       : 0.f;
    }
  };
  load_x(4 * tid);
  const int bid = max(0, min(ids[s], B - 1));
  const float* a = pool_a + (((size_t)layer * B + bid) * d_in + k0) * r;
  const float* b = pool_b + ((size_t)layer * B + bid) * r * d_out;

  // B: this thread's first columns' first RP rows, loaded with A, used
  // after the barriers
  float bv[kQ][RP];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int n = n0 + tid + q * kThreads;
#pragma unroll
    for (int j = 0; j < RP; ++j)
      bv[q][j] =
          n < n1 && j < r ? rnd<T>(__ldg(b + (size_t)j * d_out + n)) : 0.f;
  }

  for (int j0 = 0; j0 < r; j0 += RP) {
    const int rc = kFixed ? RP : min(RP, r - j0);
    float acc[kDecodeRows][4];
#pragma unroll
    for (int t = 0; t < kDecodeRows; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    for (int base = 4 * tid; base < nflat; base += kStride) {
      float4 av[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        av[u] = load_chunk4<RP, kFixed>(a, base + 4 * kThreads * u, nflat,
                                        r, j0, rc, vec);
      if (base != 4 * tid || j0 != 0) load_x(base);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int f = base + 4 * kThreads * u;
        if (f >= nflat) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float av_e = rnd<T>(elem(av[u], e));
          if constexpr (RP >= 4) {
#pragma unroll
            for (int t = 0; t < kDecodeRows; ++t)
              acc[t][e] = fmaf(xv[u][t], av_e, acc[t][e]);
          } else {  // widths 1 and 2: each element its own k
            if (f + e >= nflat) break;
            const int k = k0 + (f + e) / RP;
#pragma unroll
            for (int t = 0; t < kDecodeRows; ++t)
              if (t < T_len)
                acc[t][e] =
                    fmaf(to_f(xs[(size_t)t * d_in + k]), av_e, acc[t][e]);
          }
        }
      }
    }
    // fold the elements onto their j, then sum the lanes that share a j
    if constexpr (RP < 4) {
#pragma unroll
      for (int t = 0; t < kDecodeRows; ++t)
#pragma unroll
        for (int e = RP; e < 4; ++e) acc[t][e % RP] += acc[t][e];
    }
#pragma unroll
    for (int t = 0; t < kDecodeRows; ++t) {
      if (t >= T_len) break;
#pragma unroll
      for (int e = 0; e < kJ; ++e) {
        float v = acc[t][e];
#pragma unroll
        for (int m = kLanes; m < 32; m <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, m);
        if (lane < kLanes) part[warp][t][(RP < 4 ? 0 : 4 * lane) + e] = v;
      }
    }
    __syncthreads();
    // every CTA runs (the first chunk), or has read the previous chunk's
    // sums out of recv (the arrive after that read)
    cluster_wait();
    // this CTA's [T, rc] sum, pushed into slot c of every CTA of the cluster
    for (int i = tid; i < T_len * RP; i += kThreads) {
      const int t = i / RP, j = i % RP;
      float m = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m += part[w][t][j];
#pragma unroll
      for (int cc = 0; cc < kCluster; ++cc)
        *cluster.map_shared_rank(&recv[c][t][j], cc) = m;
    }
    cluster.sync();  // every CTA's sum has arrived everywhere
    for (int i = tid; i < T_len * rc; i += kThreads) {
      const int t = i / rc, j = i % rc;
      float m = 0.f;
#pragma unroll
      for (int cc = 0; cc < kCluster; ++cc) m += recv[cc][t][j];
      mid[t * r + j0 + j] = rnd<T>(m);
    }
    if (j0 + RP < r) cluster_arrive();  // recv is free for the next chunk
  }
  __syncthreads();

  T* o = out + (size_t)s * T_len * d_out;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int n = n0 + tid + q * kThreads;
    if (n < n1)
      write_column<T, RP, kFixed>(mid, r, bv[q], b + n, o + n, T_len, d_out);
  }
  for (int n = n0 + tid + kQ * kThreads; n < n1; n += kThreads) {
    float bq[RP];
#pragma unroll
    for (int j = 0; j < RP; ++j)
      bq[j] = j < r ? rnd<T>(__ldg(b + (size_t)j * d_out + n)) : 0.f;
    write_column<T, RP, kFixed>(mid, r, bq, b + n, o + n, T_len, d_out);
  }
}

// The cluster arm's launch configuration: grid (kCluster, S), clusters of
// kCluster CTAs along x.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int S, size_t smem, cudaStream_t st) {
    cfg.gridDim = dim3(kCluster, S, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// dynamic shared memory of a cluster CTA at rank r: the [kDecodeRows][r]
// intermediate
size_t cluster_smem(int r) {
  return (size_t)kDecodeRows * r * sizeof(float);
}

template <typename T, int RP, bool kFixed>
int launch_r(const T* x, const float* pa, const float* pb, const int* ids,
             T* out, int S, int T_len, int d_in, int d_out, int B, int r,
             int layer, int arm, cudaStream_t st) {
  if (arm == 1) {
    if (T_len > kDecodeRows) return (int)cudaErrorInvalidValue;
    const bool aligned = reinterpret_cast<uintptr_t>(pa) % 16 == 0;
    const int vec = aligned && (RP >= 4 ? r % 4 == 0
                                        : ((long long)d_in * r) % 4 == 0);
    const size_t smem = cluster_smem(r);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          lora_cluster_kernel<T, RP, kFixed>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    ClusterLaunch l(S, smem, st);
    const cudaError_t e =
        cudaLaunchKernelEx(&l.cfg, lora_cluster_kernel<T, RP, kFixed>, x, pa,
                           pb, ids, out, T_len, d_in, d_out, B, r, layer,
                           vec);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (arm != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((d_out + kColsN - 1) / kColsN, S, (T_len + kRowsT - 1) / kRowsT);
  if constexpr (kFixed)
    lora_kernel<T, RP><<<grid, kThreads, 0, st>>>(x, pa, pb, ids, out, T_len,
                                                  d_in, d_out, B, layer);
  else
    lora_kernel_padded<T, RP><<<grid, kThreads, 0, st>>>(
        x, pa, pb, ids, out, T_len, d_in, d_out, B, r, layer);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* pool_a, const void* pool_b,
           const void* ids, void* out, int S, int T_len, int d_in, int d_out,
           int B, int r, int layer, int arm, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const float* pa = static_cast<const float*>(pool_a);
  const float* pb = static_cast<const float*>(pool_b);
  const int* ip = static_cast<const int*>(ids);
  T* op = static_cast<T*>(out);
  if (r < 1) return (int)cudaErrorInvalidValue;
  // a rank that is a width of its own runs there with the rank fixed
#define TPD_LORA(RR)                                                     \
  if (r == RR)                                                           \
    return launch_r<T, RR, true>(xp, pa, pb, ip, op, S, T_len, d_in,    \
                                 d_out, B, r, layer, arm, st);
  TPD_LORA(1)
  TPD_LORA(2)
  TPD_LORA(4)
  TPD_LORA(8)
  TPD_LORA(16)
  TPD_LORA(32)
  TPD_LORA(64)
#undef TPD_LORA
  // any other at the first padded width that holds it; past the widest,
  // in chunks of it
#define TPD_LORA_PADDED(RR)                                              \
  if (r <= RR || RR == kMaxWidth)                                        \
    return launch_r<T, RR, false>(xp, pa, pb, ip, op, S, T_len, d_in,   \
                                  d_out, B, r, layer, arm, st);
  TPD_LORA_PADDED(4)
  TPD_LORA_PADDED(16)
  TPD_LORA_PADDED(64)
#undef TPD_LORA_PADDED
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 f32, 1 bf16; r any rank >= 1; arm 0 the staged kernel, 1 the
// cluster arm (T <= kDecodeRows; cluster_smem(r) of shared memory).  The
// wrapper checks the arguments and picks the arm (ops/fused_linear.py
// _lora_arm).
extern "C" int tpd_lora_delta(const void* x, const void* pool_a,
                              const void* pool_b, const void* ids, void* out,
                              int S, int T, int d_in, int d_out, int B, int r,
                              int layer, int dtype, int arm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tpd_flash::kBF16)
    return launch<bf16>(x, pool_a, pool_b, ids, out, S, T, d_in, d_out, B, r,
                        layer, arm, st);
  return launch<float>(x, pool_a, pool_b, ids, out, S, T, d_in, d_out, B, r,
                       layer, arm, st);
}

// How many clusters of the cluster arm (bf16, rank 8) the card can hold at
// once, into *count (cudaOccupancyMaxActiveClusters).
extern "C" int tpd_lora_max_clusters(int S, int* count) {
  ClusterLaunch l(S, cluster_smem(8), nullptr);
  return (int)cudaOccupancyMaxActiveClusters(
      count, (const void*)lora_cluster_kernel<bf16, 8, true>, &l.cfg);
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
