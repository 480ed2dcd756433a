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
// No sort.  Each value gets an order-preserving 32-bit key (the sign bit
// flipped for a positive value, every bit for a negative one, every NaN the
// largest key, where the plain version's sort puts it), and both thresholds
// are radix selects over 8-bit digits in four rounds:
//
// - top-k: kth is the value c with count(x > c) < k <= count(x >= c).  A
//   round histograms the digit of the keys that agree with the prefix found
//   so far and walks the bins from the top to the one holding the k-th.
// - top-p, over the top-k-filtered row y (m its maximum): the cutoff is the
//   smallest value c with sum_{y > c} exp(y - m) < top_p * sum exp(y - m),
//   which equals the sort form's last kept value.  The rounds carry each
//   bin's mass beside its count, in fixed point (exp(y - m) * 2^26 rounded,
//   summed as 64-bit integers, so the sums do not depend on the order the
//   atomics land in and every run picks the same cutoff), and walk to the
//   lowest non-empty bin whose mass above stays below top_p * Z.  A row
//   whose maximum is NaN or infinite has a NaN softmax in the plain version,
//   which keeps the top value alone as its cutoff: so does the kernel.
//
// The mass differs from the plain version's float cumsum by rounding only
// (each value's fixed point within 2^-27 of exp(y - m) <= 1, the cumsum's
// own V additions within 2^-24 relative each), so a kept set can differ
// only where the mass before a value lies within V * 2^-23 of top_p;
// masked, greedy and top-k-only outputs are exact.
//
// Bound on the H100: bytes (each logit read once, written twice).  Two arms
// (the wrapper's plan, ops/fused_sample.py _sample_arm):
//
// - row (short rows): one CTA a row, the row in registers (NV values a
//   thread, float4 loads where the row is 16-byte aligned); temps[s], the
//   grammar coordinates and the logits are all requested before any is
//   used, then the grammar row.  The arg-max is one 64-bit key max (value
//   key over index complement): warp shuffles and one shared-memory step.
// - cluster (long rows): a thread-block cluster of C CTAs a row, each
//   holding its V / C slice of the scaled row in shared memory (one
//   cp.async per value, all in flight together), so HBM is read once.  The
//   arg-max keys meet in the peers' shared memory.
//
// A round histograms into per-warp bins with 32-bit shared atomics (the
// 64-bit mass as a low word and a carry) and walks the 256 bins by one
// block scan.  A round is a chain of short dependent steps, so what costs
// is trips, not bytes: after round 0 a CTA copies the values left in the
// digit found into a short list that rounds 1-3 walk.  Across a cluster a
// round is two barriers of stores into the peers' shared memory (each bin
// to its owner rank, the owner's sums to every rank), and after two rounds
// the values left in the 16-bit prefix, usually few, are gathered to every
// rank so the last two rounds need no barrier.  Top-k on the cluster arm
// starts from each CTA's own k-th largest instead: the values at or above
// it hold every value at or above the row's, so they alone (up to 128 a
// CTA) are gathered and both selects run there after one barrier.  Any
// list or gather that overflows falls back to the rounds over the slice.
//
// tpd_fused_residual replaces the Pallas TPU kernel
// tpudist/ops/fused_sample.py (fused_residual_prep, body _residual_kernel):
// per (slot, draft position) row of the verify window, with
// t = max(temps[s], 1e-6) and IEEE divisions by t (no reciprocal
// multiply), pt = softmax(lt / t) and pd = softmax(ld / t) as exp(x - max)
// times the sum's reciprocal (one rounding more than a division, well
// inside the stated rtol 2e-6) with expf, and the residual sampling logits
// log(max(pt - pd, 0) + 1e-30) (logf), or lt / t where no residual entry is
// positive.  "Some entry > 0" is how the row's residual sum is tested: a
// sum of non-negative terms is > 0 exactly when one term is, whatever the
// summation order.
//
// Bound on the H100: bytes (two rows read, three written: 20 bytes a vocab
// entry, 160 KB at the serving shape S 8, k 4, V 256 = 0.05 us at 3.35 TB/s),
// so at serving widths the time is the launch.  Each row is read once and
// held on chip: the row arm (ops/fused_sample.py _residual_arm) gives a CTA
// a row, NV values a thread in registers; the cluster arm a cluster of C
// CTAs a row, slices of lt / t and ld / t in shared memory, the maxima,
// then the sums, then the residual test merged through the peers' shared
// memory, one cluster barrier each.  Division by t > 0 rounds
// monotonically, so the maxima are taken over the raw values, before any
// division.  One pass writes pt, pd and the residual logits; the rare empty
// residual rewrites lt / t from the held values.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // a sampling CTA (row and cluster arms)
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;  // 8-bit digits, four rounds
constexpr int kRowMaxNV = 16;  // row arm: values a thread holds
constexpr int kSliceCap = 40960;  // cluster arm: f32 values in shared memory
constexpr int kResRowMaxNV = 16;  // residual row arm: values a thread holds
constexpr int kCandCap = 128;  // cluster arm: top-k candidates a CTA sends
constexpr int kListCap = 1024;  // values a CTA keeps past a select's round 0
constexpr float kMassScale = 67108864.f;  // 2^26: one value's mass at 1
constexpr unsigned kFull = 0xffffffffu;
enum Arm { kArmRow = 0, kArmCluster = 1 };
static_assert(kThreads == kBins, "a thread per bin in the scan");

// order-preserving key: x < y <=> key(x) < key(y); every NaN the largest
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  if (isnan(x)) return kFull;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The arg-max order of jnp.argmax as one 64-bit key: the value's order
// key (-0 as +0, which compares equal to it; a NaN the largest) above the
// index's complement, so the largest key is the largest value at its
// lowest index.
__device__ __forceinline__ unsigned long long argmax_key(float g, int v) {
  return ((unsigned long long)order_key(g + 0.f) << 32) |
         (0xffffffffu - (unsigned)v);
}

__device__ __forceinline__ int argmax_index(unsigned long long k) {
  return (int)(0xffffffffu - (unsigned)k);
}

// one value's softmax mass exp(y - m) in [0, 1], in fixed point
__device__ __forceinline__ unsigned mass_fx(float y, float m) {
  return __float2uint_rn(expf(y - m) * kMassScale);
}

// the cluster barrier in two halves (release / acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// a radix select's state: the key prefix found, the rank still to find
// (top-k) and the fixed-point mass above the prefix (top-p)
struct Select {
  unsigned prefix, k_rem;
  unsigned long long above;
};

// shared state of a sampling CTA; with C > 1 its cluster's exchange slots
template <int C>
struct SampleSmem {
  unsigned wcnt[kWarps][kBins];  // a round's histogram, by warp: counts,
  unsigned wlo[kWarps][kBins];  // and the fixed-point mass as two words
  unsigned whi[kWarps][kBins];
  unsigned recv_c[C][kBins / C];  // C > 1: the owned bins' sums, by sender
  unsigned long long recv_m[C][kBins / C];
  unsigned merged_c[kBins];  // C > 1: the cluster's sums of every bin
  unsigned long long merged_m[kBins];
  unsigned long long part_a[C];  // arg-max keys, by rank
  unsigned long long warp_a[kWarps];
  unsigned scan_c[kWarps];
  unsigned long long scan_m[kWarps];
  float cand[C > 1 ? C * kCandCap : 1];  // C > 1: gathered values, by rank
  int cand_n[C];
  int n_local;
  float list[kListCap];  // the values left after a select's first round
  int list_n;
  Select sel[3];  // top-k, top-p, a CTA's own top-k (cluster arm)
};

struct SampleArgs {
  const float* logits;
  const float* temps;
  const uint8_t* gallow;
  const int* gidx;
  const int* gstate;
  float* masked;
  float* scaled;
  int* greedy;
  int V, G1, n_states, top_k;
  float top_p;
};

// zeroes the per-warp histograms (every round leaves them zero again)
template <int C>
__device__ void init_smem(SampleSmem<C>& sh) {
  for (int w = 0; w < kWarps; ++w) {
    sh.wcnt[w][threadIdx.x] = 0;
    sh.wlo[w][threadIdx.x] = 0;
    sh.whi[w][threadIdx.x] = 0;
  }
}

// the slot's grammar allow row, or nullptr
__device__ __forceinline__ const uint8_t* allow_row(const SampleArgs& a,
                                                    int s) {
  if (!a.gallow) return nullptr;
  const int gi = min(__ldg(a.gidx + s), a.G1 - 1);
  const int gs = min(__ldg(a.gstate + s), a.n_states - 1);
  return a.gallow + ((size_t)gi * a.n_states + gs) * a.V;
}

// The CTA's largest arg-max key: warp shuffles, then one shared-memory
// step; thread 0 returns it.
template <int C>
__device__ unsigned long long block_argmax(SampleSmem<C>& sh,
                                          unsigned long long k) {
  for (int off = 16; off > 0; off >>= 1)
    k = max(k, __shfl_xor_sync(kFull, k, off));
  if (threadIdx.x % 32 == 0) sh.warp_a[threadIdx.x / 32] = k;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) k = max(k, sh.warp_a[w]);
  return k;
}

// Count n values of fixed-point mass w into bin `digit` of the warp's
// histogram: 32-bit shared atomics, the mass's low word first, whose
// returned old value tells when to carry into the high word.  Integer
// sums: the total does not depend on the order the adds land in.  (A
// 64-bit shared add is a compare-and-swap loop.)
template <int C, bool MASS>
__device__ __forceinline__ void bin_add(SampleSmem<C>& sh, int warp,
                                        unsigned digit, unsigned n,
                                        unsigned w) {
  atomicAdd(&sh.wcnt[warp][digit], n);
  if (MASS && w) {
    const unsigned old = atomicAdd(&sh.wlo[warp][digit], w);
    if (old + w < old) atomicAdd(&sh.whi[warp][digit], 1u);
  }
}

// Add one value (where `live`) into bin `digit` of its warp's histogram.
// Each lane adds on its own: aggregating the lanes of a warp that share a
// digit (by __match_any_sync, or by ballots over the leading digits) costs
// more on the card than the atomics it saves.
template <int C, bool MASS>
__device__ __forceinline__ void hist_add(SampleSmem<C>& sh, bool live,
                                         unsigned digit, unsigned w) {
  if (live) bin_add<C, MASS>(sh, threadIdx.x / 32, digit, 1u, w);
}

// This CTA's sums of bin b in a round (and zeroes them for the next).
template <int C, bool MASS>
__device__ __forceinline__ void take_bin(SampleSmem<C>& sh, int b,
                                         unsigned& c, unsigned long long& m) {
  c = 0;
  m = 0;
  for (int w = 0; w < kWarps; ++w) {
    c += sh.wcnt[w][b];
    sh.wcnt[w][b] = 0;
    if constexpr (MASS) {
      m += ((unsigned long long)sh.whi[w][b] << 32) | sh.wlo[w][b];
      sh.wlo[w][b] = 0;
      sh.whi[w][b] = 0;
    }
  }
}

// One round of a radix select over a row split across the C CTAs of a
// cluster (C = 1: the CTA's own).  Histograms the digit at `shift` of the
// keys whose higher digits equal the prefix found so far (`key_of`; with
// MASS also `mass_of`), merges the histograms across the cluster and walks
// the 256 bins from the top, one thread a bin, by a block scan:
//
// - top-k (MASS false): the bin with count above < k_rem <= count through
//   it, where the k_rem-th largest key lies;
// - top-p: the lowest non-empty bin whose mass above (and above the prefix)
//   stays below T = top_p * Z, Z the round-0 total.
//
// The cluster's merge is two barriers of plain stores into the peers'
// shared memory: each CTA sends bin b to its owner (rank b / (256 / C)),
// the owner sums its bins in rank order and sends them to every rank.
// Extends st.prefix by the digit found.  Every thread of the CTA calls it;
// with X false (and always at C = 1) the round stays within the CTA.
template <int C, bool X, bool MASS, class Slice, class KeyOf, class MassOf>
__device__ void radix_round(SampleSmem<C>& sh, Select& st, Slice& sl,
                            int round, KeyOf key_of, MassOf mass_of,
                            float top_p, double& T) {
  const int shift = 24 - 8 * round;
  const unsigned pre = st.prefix, k_rem = st.k_rem;
  const unsigned long long above = st.above;
  const unsigned hi = round == 0 ? 0u : (kFull << (shift + 8));
  sl.each([&](float x, bool live) {
    const unsigned k = key_of(x);
    const bool in = live && (k & hi) == (pre & hi);
    unsigned w = 0;
    if (MASS && in) w = mass_of(x);
    hist_add<C, MASS>(sh, in, (k >> shift) & 0xffu, w);
  });
  __syncthreads();
  const int t = threadIdx.x, b = kBins - 1 - t;
  unsigned c;
  unsigned long long m;
  if constexpr (C == 1 || !X) {
    take_bin<C, MASS>(sh, b, c, m);
  } else {
    constexpr int kOwn = kBins / C;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    take_bin<C, MASS>(sh, t, c, m);  // bin t, to its owner
    *cluster.map_shared_rank(&sh.recv_c[rank][t % kOwn], t / kOwn) = c;
    if (MASS)
      *cluster.map_shared_rank(&sh.recv_m[rank][t % kOwn], t / kOwn) = m;
    cluster.sync();
    // thread t sums owned bin j = t % kOwn and sends it to rank t / kOwn
    const int j = t % kOwn, ob = rank * kOwn + j;
    c = 0;
    m = 0;
    for (int r = 0; r < C; ++r) {
      c += sh.recv_c[r][j];
      if (MASS) m += sh.recv_m[r][j];
    }
    *cluster.map_shared_rank(&sh.merged_c[ob], t / kOwn) = c;
    if (MASS) *cluster.map_shared_rank(&sh.merged_m[ob], t / kOwn) = m;
    cluster.sync();
    c = sh.merged_c[b];
    m = MASS ? sh.merged_m[b] : 0ull;
  }
  const int lane = t % 32, warp = t / 32;
  unsigned ci = c;
  unsigned long long mi = m;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned oc = __shfl_up_sync(kFull, ci, off);
    unsigned long long om = 0;
    if constexpr (MASS) om = __shfl_up_sync(kFull, mi, off);
    if (lane >= off) {
      ci += oc;
      mi += om;
    }
  }
  if (lane == 31) {
    sh.scan_c[warp] = ci;
    if (MASS) sh.scan_m[warp] = mi;
  }
  __syncthreads();
  unsigned total_c = 0;
  unsigned long long total_m = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      ci += total_c;
      mi += total_m;
    }
    total_c += sh.scan_c[w];
    if (MASS) total_m += sh.scan_m[w];
  }
  const unsigned ec = ci - c;  // count above bin b
  const unsigned long long em = mi - m;  // mass above bin b
  if constexpr (!MASS) {
    if (ec < k_rem && k_rem <= ci) {
      st.prefix = pre | ((unsigned)b << shift);
      st.k_rem = k_rem - ec;
    }
  } else {
    if (round == 0) T = (double)top_p * (double)total_m;
    if (c > 0 && (double)(above + em) < T &&
        ((double)(above + mi) >= T || ci == total_c)) {
      st.prefix = pre | ((unsigned)b << shift);
      st.above = above + em;
    }
  }
  __syncthreads();
}

// the row arm's values: NV a thread in registers; VEC: float4 groups
template <int NV, bool VEC>
struct RegSlice {
  float x[NV];
  int n;
  __device__ static int index(int j) {
    if constexpr (VEC)
      return 4 * ((int)threadIdx.x + kThreads * (j / 4)) + j % 4;
    else
      return (int)threadIdx.x + kThreads * j;
  }
  template <class F>
  __device__ void each(F f) {  // the same trips in every thread
#pragma unroll
    for (int j = 0; j < NV; ++j) f(x[j], index(j) < n);
  }
};

// the cluster arm's slice: n values, the first `cap` in shared memory, the
// rest in the scaled output (written in the first pass).  Four values a
// thread are read before any is used: a round is a chain of short,
// dependent steps per value.
struct SmemSlice {
  const float* xs;
  const float* spill;
  int n, cap;
  __device__ float get(int i) const { return i < cap ? xs[i] : spill[i]; }
  template <class F>
  __device__ void each(F f) {  // the same trips in every thread
    constexpr int U = 4;
    for (int b = 0; b < n; b += U * kThreads) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = b + (int)threadIdx.x + u * kThreads;
        v[u] = i < n ? (n <= cap ? xs[i] : get(i)) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        f(v[u], b + (int)threadIdx.x + u * kThreads < n);
    }
  }
};

// a short list of values in shared memory (a CTA's values left after a
// select's first round)
struct ListSlice {
  const float* v;
  int n;
  template <class F>
  __device__ void each(F f) {  // the same trips in every thread
    for (int b = 0; b < n; b += kThreads) {
      const int i = b + (int)threadIdx.x;
      f(i < n ? v[i] : 0.f, i < n);
    }
  }
};

// Sets a radix select's state: no prefix yet, rank k to find.
__device__ __forceinline__ void start_select(Select& st, unsigned k) {
  if (threadIdx.x == 0) st = Select{0u, k, 0ull};
  __syncthreads();
}

// A slot for each lane with `take` in a list counted by *n: one atomic a
// warp, the lanes in order.  Every lane of the warp calls it; -1 where not
// taking.
__device__ __forceinline__ int warp_append(int* n, bool take) {
  const unsigned m = __ballot_sync(kFull, take);
  if (!m) return -1;
  const int lane = threadIdx.x % 32, first = __ffs(m) - 1;
  int base = 0;
  if (lane == first) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(kFull, base, first);
  return take ? base + __popc(m & ((1u << lane) - 1u)) : -1;
}

// Sends every value of this CTA's slice that `want`s to every rank of the
// cluster (up to kCandCap of them, at this rank's slots) with their count,
// then one cluster barrier.  Where every rank's fitted, packs them in rank
// order at the front of cand and returns how many; else returns -1.
template <int C, class Slice, class Want>
__device__ int gather_values(SampleSmem<C>& sh, Slice& sl, Want want) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  if (threadIdx.x == 0) sh.n_local = 0;
  __syncthreads();
  sl.each([&](float x, bool live) {
    const int j = warp_append(&sh.n_local, live && want(x));
    if (j < 0 || j >= kCandCap) return;
    for (int r = 0; r < C; ++r)
      *cluster.map_shared_rank(&sh.cand[rank * kCandCap + j], r) = x;
  });
  __syncthreads();
  if ((int)threadIdx.x < C)
    *cluster.map_shared_rank(&sh.cand_n[rank], threadIdx.x) = sh.n_local;
  cluster.sync();
  int off[C], total = 0;
  for (int r = 0; r < C; ++r) {
    if (sh.cand_n[r] > kCandCap) return -1;
    off[r] = total;
    total += sh.cand_n[r];
  }
  constexpr int kSlots = (C * kCandCap + kThreads - 1) / kThreads;
  float v[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int i = (int)threadIdx.x + u * kThreads;
    v[u] = i < C * kCandCap ? sh.cand[i] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int i = (int)threadIdx.x + u * kThreads;
    const int r = i / kCandCap, j = i % kCandCap;
    if (i < C * kCandCap && j < sh.cand_n[r]) sh.cand[off[r] + j] = v[u];
  }
  __syncthreads();
  return total;
}

// Copies the values of `sl` that `want` into the CTA's list; returns
// whether they fitted (then the list holds them all).
template <int C, class Slice, class Want>
__device__ bool list_values(SampleSmem<C>& sh, Slice& sl, Want want) {
  if (threadIdx.x == 0) sh.list_n = 0;
  __syncthreads();
  sl.each([&](float x, bool live) {
    const int j = warp_append(&sh.list_n, live && want(x));
    if (j >= 0 && j < kListCap) sh.list[j] = x;
  });
  __syncthreads();
  return sh.list_n <= kListCap;
}

// One radix select (four rounds) over `sl`, starting at rank k (top-k) or
// mass 0 (MASS: top-p); returns the key found.  X: across the cluster,
// where after two rounds the values left (those that agree with the 16-bit
// prefix) are usually few: they are gathered to every rank and the last two
// rounds run there without a barrier, unless some rank had too many.
template <int C, bool X, bool MASS, class Slice, class KeyOf, class MassOf>
__device__ unsigned run_select(SampleSmem<C>& sh, Select& st, Slice& sl,
                               unsigned k, KeyOf key_of, MassOf mass_of,
                               float top_p) {
  constexpr bool kX = X && C > 1;
  double T = 0.0;
  start_select(st, k);
  radix_round<C, kX, MASS>(sh, st, sl, 0, key_of, mass_of, top_p, T);
  // this CTA's values in the digit found: usually a short list to walk
  const unsigned pre8 = st.prefix >> 24;
  const bool listed =
      list_values(sh, sl, [&](float x) { return key_of(x) >> 24 == pre8; });
  ListSlice ls{sh.list, sh.list_n};
  if (listed)
    radix_round<C, kX, MASS>(sh, st, ls, 1, key_of, mass_of, top_p, T);
  else
    radix_round<C, kX, MASS>(sh, st, sl, 1, key_of, mass_of, top_p, T);
  if constexpr (kX) {
    // the cluster's values in the 16-bit prefix, gathered to every rank:
    // the last two rounds then need no barrier, unless some rank had more
    // than kCandCap
    const unsigned pre = st.prefix >> 16;
    auto want = [&](float x) { return key_of(x) >> 16 == pre; };
    const int got = listed ? gather_values(sh, ls, want)
                           : gather_values(sh, sl, want);
    ListSlice cs{sh.cand, got};
    for (int r = 2; r < 4; ++r) {
      if (got >= 0)
        radix_round<C, false, MASS>(sh, st, cs, r, key_of, mass_of, top_p, T);
      else if (listed)
        radix_round<C, true, MASS>(sh, st, ls, r, key_of, mass_of, top_p, T);
      else
        radix_round<C, true, MASS>(sh, st, sl, r, key_of, mass_of, top_p, T);
    }
  } else {
    for (int r = 2; r < 4; ++r) {
      if (listed)
        radix_round<C, false, MASS>(sh, st, ls, r, key_of, mass_of, top_p, T);
      else
        radix_round<C, false, MASS>(sh, st, sl, r, key_of, mass_of, top_p, T);
    }
  }
  return st.prefix;
}

// The key of the k-th largest value of `sl` (X: across the cluster).
template <int C, bool X, class Slice>
__device__ unsigned kth_key(SampleSmem<C>& sh, Select& st, Slice& sl,
                            unsigned k) {
  auto key_of = [](float x) { return order_key(x); };
  auto no_mass = [](float) { return 0u; };
  return run_select<C, X, false>(sh, st, sl, k, key_of, no_mass, 0.f);
}

// The top-p cutoff over the top-k-filtered values of `sl` (X: across the
// cluster): values below kth count as finfo(f32).min, m is the row's
// largest value (finite).
template <int C, bool X, class Slice>
__device__ float top_p_cutoff(SampleSmem<C>& sh, Slice& sl, float kth,
                              float m, float top_p) {
  auto key_of = [kth](float x) { return order_key(x < kth ? -FLT_MAX : x); };
  auto mass_of = [kth, m](float x) {
    return mass_fx(x < kth ? -FLT_MAX : x, m);
  };
  return key_value(
      run_select<C, X, true>(sh, sh.sel[1], sl, 0u, key_of, mass_of, top_p));
}

// The filters' two radix selects over `sl` (X: across the cluster) and the
// value each leaves: kth (top-k, -inf when off) and the top-p cutoff (-inf
// when off).  `m` is the row's largest value.
template <int C, bool X, class Slice>
__device__ void select_thresholds(SampleSmem<C>& sh, Slice& sl,
                                  const SampleArgs& a, bool use_k,
                                  bool use_p, float m, float& kth,
                                  float& cutoff) {
  kth = -INFINITY;
  cutoff = -INFINITY;
  if (use_k) kth = key_value(kth_key<C, X>(sh, sh.sel[0], sl, a.top_k));
  if (!use_p) return;
  if (!isfinite(m)) {  // the plain version's softmax is NaN: top value only
    cutoff = m;
    return;
  }
  cutoff = top_p_cutoff<C, X>(sh, sl, kth, m, a.top_p);
}

__device__ __forceinline__ float filtered(float x, float kth, float cutoff) {
  const float neg = -FLT_MAX;
  if (x < kth) x = neg;
  if (x < cutoff) x = neg;
  return x;
}

// a thread's NV values of a row into `out` (float4 groups with VEC)
template <int NV, bool VEC>
__device__ __forceinline__ void store_row(float* out, const float* x,
                                          int V) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      const int v = RegSlice<NV, VEC>::index(4 * q);
      if (v < V)
        *reinterpret_cast<float4*>(out + v) =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = RegSlice<NV, VEC>::index(j);
      if (v < V) out[v] = x[j];
    }
  }
}

template <int NV, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sample_row_kernel(SampleArgs a) {
  __shared__ SampleSmem<1> sh;
  const int s = blockIdx.x, V = a.V;
  init_smem(sh);
  const float temp = __ldg(a.temps + s);
  const uint8_t* allow = allow_row(a, s);
  const float* row = a.logits + (size_t)s * V;
  RegSlice<NV, VEC> sl;
  sl.n = V;
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      const int v = RegSlice<NV, VEC>::index(4 * q);
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < V) f = __ldg(reinterpret_cast<const float4*>(row + v));
      sl.x[4 * q] = f.x;
      sl.x[4 * q + 1] = f.y;
      sl.x[4 * q + 2] = f.z;
      sl.x[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = RegSlice<NV, VEC>::index(j);
      sl.x[j] = v < V ? __ldg(row + v) : 0.f;
    }
  }
  uint8_t al[NV];
  if (allow) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = RegSlice<NV, VEC>::index(j);
      al[j] = v < V ? __ldg(allow + v) : 1;
    }
  }
  const bool use_k = a.top_k > 0 && a.top_k < V;
  const bool use_p = a.top_p > 0.f && a.top_p < 1.f;
  const bool filter = use_k || use_p;
  const float t = fmaxf(temp, 1e-6f);
  unsigned long long ak = 0;  // the arg-max key
  float mk[NV];  // the masked logits
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = RegSlice<NV, VEC>::index(j);
    mk[j] = (allow && !al[j]) ? -FLT_MAX : sl.x[j];
    sl.x[j] = mk[j] / t;
    if (v < V) ak = max(ak, argmax_key(mk[j], v));
  }
  float* mrow = a.masked + (size_t)s * V;
  float* srow = a.scaled + (size_t)s * V;
  store_row<NV, VEC>(mrow, mk, V);
  if (!filter) store_row<NV, VEC>(srow, sl.x, V);
  ak = block_argmax(sh, ak);
  if (threadIdx.x == 0) {
    a.greedy[s] = argmax_index(ak);
    sh.part_a[0] = ak;
  }
  if (!filter) return;
  __syncthreads();
  float kth, cutoff;
  // the row's largest scaled value: x / t rounds monotonically in x
  const float m = key_value((unsigned)(sh.part_a[0] >> 32)) / t;
  select_thresholds<1, false>(sh, sl, a, use_k, use_p, m, kth, cutoff);
#pragma unroll
  for (int j = 0; j < NV; ++j) mk[j] = filtered(sl.x[j], kth, cutoff);
  store_row<NV, VEC>(srow, mk, V);
}

// The cluster arm: grid C * S, clusters of C CTAs along x, one cluster a
// row; rank r holds the row's values [r * per, r * per + per), the first
// `cap` of them in dynamic shared memory.
template <int C>
__global__ void __launch_bounds__(kThreads)
    sample_cluster_kernel(SampleArgs a, int per, int cap) {
  __shared__ SampleSmem<C> sh;
  extern __shared__ float4 dyn[];
  float* xs = reinterpret_cast<float*>(dyn);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / C, V = a.V;
  init_smem(sh);
  cluster_arrive();  // that this CTA runs
  const float temp = __ldg(a.temps + s);
  const uint8_t* allow = allow_row(a, s);
  const int lo = rank * per;
  const int n = max(0, min(per, V - lo));
  const float* row = a.logits + (size_t)s * V + lo;
  float* mrow = a.masked + (size_t)s * V + lo;
  float* srow = a.scaled + (size_t)s * V + lo;
  if (allow) allow += lo;
  const bool use_k = a.top_k > 0 && a.top_k < V;
  const bool use_p = a.top_p > 0.f && a.top_p < 1.f;
  const bool filter = use_k || use_p;
  const float t = fmaxf(temp, 1e-6f);
  unsigned long long ak = 0;  // the arg-max key
  const int held = min(n, cap);
  for (int i = threadIdx.x; i < held; i += kThreads)  // all in flight at once
    __pipeline_memcpy_async(xs + i, row + i, sizeof(float));
  __pipeline_commit();
  __pipeline_wait_prior(0);  // this thread's copies: the values it reads
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float lg = i < cap ? xs[i] : __ldg(row + i);
    const float g = (allow && !__ldg(allow + i)) ? -FLT_MAX : lg;
    mrow[i] = g;
    ak = max(ak, argmax_key(g, lo + i));
    const float x = g / t;
    if (i < cap) xs[i] = x;
    if (!filter || i >= cap) srow[i] = x;
  }
  ak = block_argmax(sh, ak);
  SmemSlice sl{xs, srow, n, cap};
  // top-k: this CTA's candidates, the values at or above its own k-th
  // largest; together they hold every value at or above the row's k-th
  // largest (a value above it has fewer than k above it in its slice)
  unsigned key_r = 0;
  if (use_k && n > a.top_k)
    key_r = kth_key<C, false>(sh, sh.sel[2], sl, a.top_k);
  cluster_wait();  // every peer runs
  if (threadIdx.x == 0)  // without filters only rank 0 reads them
    for (int r = 0; r < (filter ? C : 1); ++r)
      *cluster.map_shared_rank(&sh.part_a[rank], r) = ak;
  // one barrier publishes the arg-max keys and, with top-k, the candidates
  int got = -1;
  if (use_k)
    got = gather_values(sh, sl,
                        [key_r](float x) { return order_key(x) >= key_r; });
  else
    cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    unsigned long long best = sh.part_a[0];
    for (int r = 1; r < C; ++r) best = max(best, sh.part_a[r]);
    a.greedy[s] = argmax_index(best);
  }
  if (!filter) return;
  unsigned long long best = 0;
  for (int r = 0; r < C; ++r) best = max(best, sh.part_a[r]);
  const float m = key_value((unsigned)(best >> 32)) / t;
  float kth = -INFINITY, cutoff = -INFINITY;
  if (got >= 0) {  // every rank's candidates arrived: select among them
    ListSlice cs{sh.cand, got};
    kth = key_value(kth_key<C, false>(sh, sh.sel[0], cs, a.top_k));
    if (use_p && !isfinite(m)) {
      cutoff = m;
    } else if (use_p && m > -FLT_MAX) {  // the rest weigh exp(-FLT_MAX - m) = 0
      cutoff = top_p_cutoff<C, false>(sh, cs, kth, m, a.top_p);
    } else if (use_p) {
      cutoff = top_p_cutoff<C, true>(sh, sl, kth, m, a.top_p);
    }
  } else {
    select_thresholds<C, true>(sh, sl, a, use_k, use_p, m, kth, cutoff);
  }
  for (int i = threadIdx.x; i < n; i += kThreads)
    srow[i] = filtered(sl.get(i), kth, cutoff);
}

// ---------------------------------------------------------------------------
// the residual prep

struct ResArgs {
  const void* lt;
  const void* ld;
  const float* temps;
  float* pt;
  float* pd;
  float* lr;
  int k, V, rows, lt_bf16, ld_bf16;
};

// U values of a row (f32 or bf16) for this thread, element `first + u *
// step` for u < U where below n (else 0): one branch on the dtype outside
// the loads, so all U are in flight together
template <int U>
__device__ __forceinline__ void load_values(const void* src, bool bf16,
                                            size_t base, int first, int step,
                                            int n, float (&out)[U]) {
  if (bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(src) + base;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = first + u * step;
      out[u] = i < n ? __bfloat162float(p[i]) : 0.f;
    }
  } else {
    const float* p = static_cast<const float*>(src) + base;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = first + u * step;
      out[u] = i < n ? __ldg(p + i) : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// block-wide reduction of two floats over kThreads threads (red: two
// kWarps slots); every thread returns the CTA's
template <bool MAX>
__device__ void block_reduce2(float& x, float& y, float (*red)[kWarps]) {
  if constexpr (MAX) {
    x = warp_max(x);
    y = warp_max(y);
  } else {
    x = warp_sum(x);
    y = warp_sum(y);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the slots' previous readers are done
  if (lane == 0) {
    red[0][warp] = x;
    red[1][warp] = y;
  }
  __syncthreads();
  x = red[0][0];
  y = red[1][0];
  for (int w = 1; w < kWarps; ++w) {
    x = MAX ? fmaxf(x, red[0][w]) : x + red[0][w];
    y = MAX ? fmaxf(y, red[1][w]) : y + red[1][w];
  }
}

// The residual row arm: a CTA a row, thread t holding values t + 256 j in
// registers (a warp a row left one warp a scheduler running the long
// dependent chains of divisions, exps and a log).  Division by t > 0 rounds
// monotonically, so max(x / t) is max(x) / t.
template <int NV>
__global__ void __launch_bounds__(kThreads) residual_row_kernel(ResArgs a) {
  __shared__ float red[2][kWarps];
  const int row = blockIdx.x, V = a.V;
  const float temp = __ldg(a.temps + row / a.k);
  const size_t base = (size_t)row * V;
  float xt[NV], xd[NV];
  load_values(a.lt, a.lt_bf16, base, (int)threadIdx.x, kThreads, V, xt);
  load_values(a.ld, a.ld_bf16, base, (int)threadIdx.x, kThreads, V, xd);
  float mt = -INFINITY, md = -INFINITY;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const bool live = (int)threadIdx.x + kThreads * j < V;
    mt = fmaxf(mt, live ? xt[j] : -INFINITY);
    md = fmaxf(md, live ? xd[j] : -INFINITY);
  }
  const float t = fmaxf(temp, 1e-6f);
  block_reduce2<true>(mt, md, red);
  mt = mt / t;
  md = md / t;
  float st = 0.f, sd = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const bool live = (int)threadIdx.x + kThreads * j < V;
    xt[j] = xt[j] / t;
    xd[j] = xd[j] / t;
    st += live ? expf(xt[j] - mt) : 0.f;
    sd += live ? expf(xd[j] - md) : 0.f;
  }
  block_reduce2<false>(st, sd, red);
  const float it = 1.f / st, id = 1.f / sd;  // one rounding more than e / s
  int has = 0;
  float* ot = a.pt + base;
  float* od = a.pd + base;
  float* orr = a.lr + base;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = (int)threadIdx.x + kThreads * j;
    if (v >= V) continue;
    const float p = expf(xt[j] - mt) * it;
    const float q = expf(xd[j] - md) * id;
    ot[v] = p;
    od[v] = q;
    const float res = fmaxf(p - q, 0.f);
    has |= res > 0.f;
    orr[v] = logf(res + 1e-30f);
  }
  if (__syncthreads_or(has)) return;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = (int)threadIdx.x + kThreads * j;
    if (v < V) orr[v] = xt[j];
  }
}

// The residual cluster arm: grid C * rows, clusters of C CTAs along x, one
// cluster a row; rank r holds lt / t and ld / t of the row's values
// [r * per, r * per + per), the first `cap` of each in dynamic shared
// memory (the rest in pt and pd until the write pass).
template <int C>
__global__ void __launch_bounds__(kThreads)
    residual_cluster_kernel(ResArgs a, int per, int cap) {
  __shared__ float red[2][kWarps];
  __shared__ float part_m[2][C], part_s[2][C];
  __shared__ int part_has[C];
  extern __shared__ float4 dyn[];
  float* xts = reinterpret_cast<float*>(dyn);
  float* xds = xts + cap;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C, V = a.V;
  cluster_arrive();  // that this CTA runs
  const float temp = __ldg(a.temps + row / a.k);
  const int lo = rank * per;
  const int n = max(0, min(per, V - lo));
  const size_t base = (size_t)row * V + lo;
  float* ot = a.pt + base;
  float* od = a.pd + base;
  float* orr = a.lr + base;
  const float t = fmaxf(temp, 1e-6f);
  float mt = -INFINITY, md = -INFINITY;
  constexpr int U = 16;
  for (int i0 = 0; i0 < n; i0 += U * kThreads) {
    float vt[U], vd[U];
    load_values(a.lt, a.lt_bf16, base, i0 + (int)threadIdx.x, kThreads, n,
                vt);
    load_values(a.ld, a.ld_bf16, base, i0 + (int)threadIdx.x, kThreads, n,
                vd);
#pragma unroll
    for (int u = 0; u < U; ++u) {  // max(x / t) = max(x) / t: no division
      const int i = i0 + (int)threadIdx.x + u * kThreads;
      mt = fmaxf(mt, i < n ? vt[u] : -INFINITY);
      md = fmaxf(md, i < n ? vd[u] : -INFINITY);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + (int)threadIdx.x + u * kThreads;
      if (i >= n) continue;
      if (i < cap) {
        xts[i] = vt[u] / t;
        xds[i] = vd[u] / t;
      } else {
        ot[i] = vt[u] / t;
        od[i] = vd[u] / t;
      }
    }
  }
  block_reduce2<true>(mt, md, red);
  mt = mt / t;
  md = md / t;
  cluster_wait();  // every peer runs
  if (threadIdx.x < C) {
    *cluster.map_shared_rank(&part_m[0][rank], threadIdx.x) = mt;
    *cluster.map_shared_rank(&part_m[1][rank], threadIdx.x) = md;
  }
  cluster.sync();
  mt = part_m[0][0];
  md = part_m[1][0];
  for (int r = 1; r < C; ++r) {
    mt = fmaxf(mt, part_m[0][r]);
    md = fmaxf(md, part_m[1][r]);
  }
  float st = 0.f, sd = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    st += expf((i < cap ? xts[i] : ot[i]) - mt);
    sd += expf((i < cap ? xds[i] : od[i]) - md);
  }
  block_reduce2<false>(st, sd, red);
  if (threadIdx.x < C) {
    *cluster.map_shared_rank(&part_s[0][rank], threadIdx.x) = st;
    *cluster.map_shared_rank(&part_s[1][rank], threadIdx.x) = sd;
  }
  cluster.sync();
  st = part_s[0][0];
  sd = part_s[1][0];
  for (int r = 1; r < C; ++r) {  // in rank order: the same sum everywhere
    st += part_s[0][r];
    sd += part_s[1][r];
  }
  const float it = 1.f / st, id = 1.f / sd;  // one rounding more than e / s
  int has = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float x = i < cap ? xts[i] : ot[i];
    const float y = i < cap ? xds[i] : od[i];
    const float p = expf(x - mt) * it;
    const float q = expf(y - md) * id;
    ot[i] = p;
    od[i] = q;
    const float res = fmaxf(p - q, 0.f);
    has |= res > 0.f;
    // a spilled value's lr holds lt / t until the residual test is known
    orr[i] = i < cap ? logf(res + 1e-30f) : x;
  }
  has = __syncthreads_or(has);
  if (threadIdx.x < C)
    *cluster.map_shared_rank(&part_has[rank], threadIdx.x) = has;
  cluster.sync();
  bool any = false;
  for (int r = 0; r < C; ++r) any |= part_has[r] != 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (i < cap) {
      if (!any) orr[i] = xts[i];
    } else if (any) {  // the thread's own pt, pd of this value
      orr[i] = logf(fmaxf(ot[i] - od[i], 0.f) + 1e-30f);
    }
  }
}

// ---------------------------------------------------------------------------
// launches

template <class Kernel, class... Args>
int launch_cluster(Kernel kernel, int C, int grid, size_t smem,
                   cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// a cluster arm's slice of V values over C CTAs: a multiple of 4 values
int slice_of(int V, int C) { return ((V + C - 1) / C + 3) & ~3; }

int sample_row(const SampleArgs& a, int S, int nv, bool vec,
               cudaStream_t st) {
#define TPD_ROW(NV, VEC) \
  sample_row_kernel<NV, VEC><<<S, kThreads, 0, st>>>(a)
  if (vec && nv >= 4) {
    switch (nv) {
      case 4: TPD_ROW(4, true); break;
      case 8: TPD_ROW(8, true); break;
      case 16: TPD_ROW(16, true); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (nv) {
      case 1: TPD_ROW(1, false); break;
      case 2: TPD_ROW(2, false); break;
      case 4: TPD_ROW(4, false); break;
      case 8: TPD_ROW(8, false); break;
      case 16: TPD_ROW(16, false); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef TPD_ROW
  return (int)cudaGetLastError();
}

int sample_cluster(const SampleArgs& a, int S, int C, cudaStream_t st) {
  const int per = slice_of(a.V, C), cap = min(per, kSliceCap);
  const size_t smem = (size_t)cap * sizeof(float);
#define TPD_SAMPLE(CC)                                                    \
  case CC:                                                                \
    return launch_cluster(sample_cluster_kernel<CC>, CC, CC * S, smem, st, \
                          a, per, cap);
  switch (C) {
    TPD_SAMPLE(2)
    TPD_SAMPLE(4)
    TPD_SAMPLE(8)
    TPD_SAMPLE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TPD_SAMPLE
}

int residual_row(const ResArgs& a, int nv, cudaStream_t st) {
#define TPD_RES(NV)                                          \
  case NV:                                                   \
    residual_row_kernel<NV><<<a.rows, kThreads, 0, st>>>(a); \
    break;
  switch (nv) {
    TPD_RES(1)
    TPD_RES(2)
    TPD_RES(4)
    TPD_RES(8)
    TPD_RES(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TPD_RES
  return (int)cudaGetLastError();
}

int residual_cluster(const ResArgs& a, int C, cudaStream_t st) {
  const int per = slice_of(a.V, C), cap = min(per, kSliceCap / 2);
  const size_t smem = 2 * (size_t)cap * sizeof(float);
#define TPD_RESIDUAL(CC)                                               \
  case CC:                                                             \
    return launch_cluster(residual_cluster_kernel<CC>, CC, CC * a.rows, \
                          smem, st, a, per, cap);
  switch (C) {
    TPD_RESIDUAL(2)
    TPD_RESIDUAL(4)
    TPD_RESIDUAL(8)
    TPD_RESIDUAL(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TPD_RESIDUAL
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// arm 0: the row arm with `width` = NV values a thread (1, 2, 4, 8, 16); arm
// 1: the cluster arm with `width` = C CTAs a row (2, 4, 8, 16).  The
// wrapper picks them (ops/fused_sample.py _sample_arm) and checks the
// arguments; the row arm takes float4 loads where the row is aligned.
extern "C" int tpd_fused_sample(const void* logits, const void* temps,
                                const void* gallow, const void* gidx,
                                const void* gstate, void* masked,
                                void* scaled, void* greedy, int S, int V,
                                int G1, int n_states, int top_k, float top_p,
                                int arm, int width, void* stream) {
  SampleArgs a{static_cast<const float*>(logits),
               static_cast<const float*>(temps),
               static_cast<const uint8_t*>(gallow),
               static_cast<const int*>(gidx),
               static_cast<const int*>(gstate),
               static_cast<float*>(masked),
               static_cast<float*>(scaled),
               static_cast<int*>(greedy),
               V, G1, n_states, top_k, top_p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (arm == kArmRow) {
    if (width > kRowMaxNV || V > width * kThreads)
      return (int)cudaErrorInvalidValue;
    const bool vec = V % 4 == 0 && aligned16(logits) && aligned16(masked) &&
                     aligned16(scaled);
    return sample_row(a, S, width, vec, st);
  }
  if (arm == kArmCluster) return sample_cluster(a, S, width, st);
  return (int)cudaErrorInvalidValue;
}

// arm 0: the row arm with `width` = NV values a thread (1, 2, 4, 8, 16);
// arm 1: the cluster arm with `width` = C CTAs a row (2, 4, 8, 16).
extern "C" int tpd_fused_residual(const void* lt, const void* ld,
                                  const void* temps, void* pt, void* pd,
                                  void* lr, int S, int k, int V, int lt_bf16,
                                  int ld_bf16, int arm, int width,
                                  void* stream) {
  ResArgs a{lt, ld, static_cast<const float*>(temps),
            static_cast<float*>(pt), static_cast<float*>(pd),
            static_cast<float*>(lr), k, V, S * k, lt_bf16, ld_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (arm == kArmRow) {
    if (width > kResRowMaxNV || V > width * kThreads)
      return (int)cudaErrorInvalidValue;
    return residual_row(a, width, st);
  }
  if (arm == kArmCluster) return residual_cluster(a, width, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
