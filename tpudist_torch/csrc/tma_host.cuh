// Host side of the TMA tile loads of hopper_mma.cuh: the tensor maps of
// [heads, rows, D] bf16 tensors, shared by the flash forward's and the
// flash backward's wgmma arms (flash_attention.cu, flash_backward.cu) and
// the RoPE+QKV wgmma arm (fused_rope_qkv.cu).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace tpd_hopper {

// cuTensorMapEncodeTiled lives in libcuda, which this library does not link:
// it is reached through the runtime's entry-point query
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a [heads, rows, D] bf16 tensor in boxes of box_rows rows x 64
// columns with the 128-byte swizzle; rows past the end read as zeros.
static bool tile_map(CUtensorMap* m, const void* p, int heads, int rows,
                     int D, int box_rows = kTileRows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16),
                                 (cuuint64_t)rows * D * sizeof(bf16)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of q, k, v and do, in that order (do null: the first three
// only).  The encoder needs the device's context current on this thread,
// which a thread whose first CUDA work this is (autograd's) may not have
// yet: setting the current device again binds it.
static bool tile_maps(CUtensorMap* m, const void* q, const void* k,
                      const void* v, const void* dout, int B, int H, int Hkv,
                      int Sq, int Sk, int D) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return false;
  return tile_map(m, q, B * H, Sq, D) && tile_map(m + 1, k, B * Hkv, Sk, D) &&
         tile_map(m + 2, v, B * Hkv, Sk, D) &&
         (dout == nullptr || tile_map(m + 3, dout, B * H, Sq, D));
}

}  // namespace tpd_hopper
