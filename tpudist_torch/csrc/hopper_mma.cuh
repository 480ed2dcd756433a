// Hopper warpgroup matrix products (wgmma) and the shared-memory layout they
// read, for the flash kernels' wgmma arms (flash_attention.cu,
// flash_backward.cu); the host side of the TMA loads is tma_host.cuh.
//
// A warpgroup is 4 consecutive warps (128 threads).  wgmma.mma_async
// computes D[64 x N] += A[64 x 16] · B[16 x N] in f32, A from shared memory
// or from registers, B from shared memory, each operand in shared memory
// named by a 64-bit descriptor.
//
// Tiles.  An operand tile has 64 rows (128 for the forward's key tiles) of
// D bf16 columns (D = 64 or 128), stored as D / 64 column blocks of [rows]
// [64 columns]: one row of a block is 128 bytes, and its eight 16-byte
// chunks are permuted by the 128-byte swizzle (chunk c of row r sits at
// chunk c ^ (r % 8)), the canonical layout of the descriptor's swizzle mode
// 1.  Blocks are 1024-byte aligned, so the hardware's swizzle (an XOR of
// address bits 4-6 with bits 7-9) lines up with the one the loads write.
//
// - K-major (the tile's columns are the product's depth; A, or B stored as
//   [N][K]): depth step kk (16 columns) starts kk % 4 · 32 bytes into block
//   kk / 4; the stride between 8-row groups (SBO) is 1024 bytes, the
//   leading offset unused.
// - MN-major (the tile's rows are the depth, its columns the N of B; the
//   descriptor's transpose bit): depth step kk starts at row 16·kk of block
//   0; 8-row groups 1024 bytes apart (SBO), column blocks 64·128 bytes apart
//   (the leading offset, LBO).
//
// Accumulator fragment of m64nNk16 (N / 2 f32 a thread), as float d[N/8][4]:
// warp w of the warpgroup holds rows 16w..16w+15; with g = lane / 4 and
// t = lane % 4, d[i][0..1] are row 16w + g, columns 8i + 2t and 8i + 2t + 1,
// d[i][2..3] the same columns of row 16w + g + 8.  The A fragment from
// registers of one 16-deep step kk is the mma.sync m16n8k16 A fragment of
// the warp's 16 rows, so the accumulator blocks 2kk and 2kk + 1 repack into
// it pairwise (pack_a).
//
// Tiles arrive by TMA (cp.async.bulk.tensor over a tensor map that names
// the same swizzle), one thread issuing, completion counted in bytes on an
// mbarrier that every consumer waits on.
//
// Ordering: wgmma_fence() before a batch whose registers were written since
// the last one; commit and wait before any thread reads its accumulators or
// rewrites its A registers.  TMA writes and wgmma reads are both in the
// async proxy: the mbarrier orders them; a barrier over the CTA after the
// last wgmma read of a buffer frees it for the next TMA write.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tpd_hopper {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;                 // rows of every operand tile
constexpr int kBlockElems = kTileRows * 64;   // one [64][64] column block

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<unsigned char*>((a + 1023) & ~uintptr_t(1023));
}

// element offset of (row r, column col) in a swizzled tile
__device__ __forceinline__ int swz(int r, int col) {
  return (col >> 6) * kBlockElems + r * 64 +
         ((((col >> 3) & 7) ^ (r & 7)) << 3) + (col & 7);
}

__device__ __forceinline__ uint64_t make_desc(const bf16* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) |
         ((uint64_t)1 << 62);  // 128-byte swizzle
}

// depth step kk (16 columns) of a tile of ROWS rows read K-major
template <int ROWS = kTileRows>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return make_desc(tile + (kk >> 2) * ROWS * 64 + (kk & 3) * 16, 16, 1024);
}

// depth step kk (16 rows) of a tile of ROWS rows read MN-major (B with the
// transpose bit): column blocks ROWS * 128 bytes apart
template <int ROWS = kTileRows>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return make_desc(tile + kk * 16 * 64, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of the accumulators across
// the asynchronous product that owns them
template <int NB>
__device__ __forceinline__ void fence_acc(float (&d)[NB][4]) {
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

#define TPD_D4(n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])

// d[64 x 64] (+)= A · B, both from shared memory, both K-major; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TPD_D4(0), TPD_D4(1), TPD_D4(2), TPD_D4(3), TPD_D4(4), TPD_D4(5),
        TPD_D4(6), TPD_D4(7)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 128] (+)= A · B, both from shared memory, both K-major; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TPD_D4(0), TPD_D4(1), TPD_D4(2), TPD_D4(3), TPD_D4(4), TPD_D4(5),
        TPD_D4(6), TPD_D4(7), TPD_D4(8), TPD_D4(9), TPD_D4(10), TPD_D4(11),
        TPD_D4(12), TPD_D4(13), TPD_D4(14), TPD_D4(15)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x N] += A · B, A (one 16-deep step) from registers, B from shared
// memory MN-major (transpose bit); N = 8·NB = 64 or 128
template <int NB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NB][4],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, "
      "1;\n}\n"
      : TPD_D4(0), TPD_D4(1), TPD_D4(2), TPD_D4(3), TPD_D4(4), TPD_D4(5),
        TPD_D4(6), TPD_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TPD_D4(0), TPD_D4(1), TPD_D4(2), TPD_D4(3), TPD_D4(4), TPD_D4(5),
        TPD_D4(6), TPD_D4(7), TPD_D4(8), TPD_D4(9), TPD_D4(10), TPD_D4(11),
        TPD_D4(12), TPD_D4(13), TPD_D4(14), TPD_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TPD_D4

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the 64 x 16·KS f32 accumulator tile s, rounded to bf16, as the A
// fragments of the KS 16-deep steps of the next product
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4],
                                       const float (&s)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack2(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack2(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// d[64 x 64] = A · Bᵀ over D columns: A and B row-major [64][D] tiles in
// shared memory (both K-major); issued, not waited for
template <int D>
__device__ __forceinline__ void wgmma_abt(float (&d)[8][4], const bf16* a,
                                          const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(d, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// d[64 x 128] = A · Bᵀ over D columns: A a row-major [64][D] tile, B a
// row-major [128][D] tile in shared memory (both K-major); issued, not
// waited for
template <int D>
__device__ __forceinline__ void wgmma_abt128(float (&d)[16][4], const bf16* a,
                                             const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(d, desc_k(a, kk), desc_k<128>(b, kk), kk > 0);
}

// acc[64 x D] += A · T over the 16·KS rows of T: A the packed bf16
// fragments of a 64 x 16·KS tile (pack_a), T a [16·KS][D] tile in shared
// memory read MN-major; issued, not waited for.  The caller keeps `a`
// unchanged until the wait.
template <int NB, int KS>
__device__ __forceinline__ void wgmma_pv(float (&acc)[NB][4],
                                         const uint32_t (&a)[KS][4],
                                         const bf16* t) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs<NB>(acc, a[kk], desc_mn<16 * KS>(t, kk));
}

// acc[64 x D] += bf(p) · T over 64 rows of T: p the f32 accumulator tile,
// T a [64][D] tile in shared memory read MN-major; issued, not waited for
template <int NB>
__device__ __forceinline__ void wgmma_pt(float (&acc)[NB][4],
                                         const float (&p)[8][4],
                                         const bf16* t) {
  uint32_t a[4][4];
  pack_a(a, p);
  wgmma_pv<NB, 4>(acc, a, t);
}

// keep the compiler from moving reads or writes of packed A fragments
// across the asynchronous product that reads them
template <int KS>
__device__ __forceinline__ void fence_a(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// ------------------------------------------------- TMA copies and mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// arrive once (a consumer releasing a ring stage)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing `bar`'s expected bytes.  The map (a __grid_constant__
// kernel parameter) names the 128-byte swizzle, so the box lands in the
// layout above.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows [row0, row0 + ROWS) of head `head` of a [heads, rows, D] bf16
// tensor (its map: boxes of 64 rows x 64 columns) into a swizzled tile of
// ROWS rows, ROWS / 64 boxes a column block; rows past the end are
// zero-filled.  One thread issues it.
template <int D, int ROWS = kTileRows>
__device__ __forceinline__ void tma_tile(bf16* tile, const void* map,
                                         uint64_t* bar, int row0, int head) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
    for (int rb = 0; rb < ROWS / kTileRows; ++rb)
      tma_load_3d(tile + cb * ROWS * 64 + rb * kBlockElems, map, bar,
                  cb * 64, row0 + rb * kTileRows, head);
}

// Hand registers back (dec) or take them (inc), up to N a thread, for the
// calling warpgroup: every warp of it executes the same one, on a path that
// does not reconverge with the other warpgroups' (else ptxas ignores it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier `id` (1..15; 0 is __syncthreads') over `n` threads: sync
// waits for all n, arrive counts this thread and goes on.  Two warpgroups
// take turns with them (a sync on one's own id, an arrive on the other's).
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

}  // namespace tpd_hopper
