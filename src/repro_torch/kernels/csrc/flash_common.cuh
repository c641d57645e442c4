// What the two bf16 flash-attention kernels share (csrc/flash_attention.cu,
// the forward, and csrc/flash_attention_bwd.cu, the backward): per-tensor
// strides, the TMA tensor maps over a (B, H, S, D) view whose three outer
// axes the wrapper sorted by stride (kernels/flash_attention.py::tma_axes),
// and the few register-level helpers of their epilogues and softmax.
#pragma once

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types (nothing is linked)
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

struct Strides {
  long long b, h, s;
};

// A tensor map's coordinates are (column, then row, head and batch in the
// order the wrapper sorted them by stride); `order` holds that order, two
// bits an axis (0 row, 1 head, 2 batch).
__device__ __forceinline__ int pick(int axis, int row, int head, int batch) {
  return axis == 0 ? row : axis == 1 ? head : batch;
}

__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, int order,
                                         uint32_t bar, int col, int row, int head, int batch) {
  hopper::tma_load_4d(dst, map, bar, col, pick(order & 3, row, head, batch),
                      pick((order >> 2) & 3, row, head, batch),
                      pick((order >> 4) & 3, row, head, batch));
}

// 2^x by the special-function unit, flushing results below 2^-126 to zero:
// such a probability adds nothing to l >= 1 or to a bf16 P.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Columns col and col + 1 of a bf16 row, as one 4-byte store where D is even.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int col, int D, bool pairs, float x0,
                                           float x1) {
  if (pairs && col + 1 < D) {
    *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < D) p[col] = __float2bfloat16_rn(x0);
    if (col + 1 < D) p[col + 1] = __float2bfloat16_rn(x1);
  }
}

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has loaded (looked
// up at run time, so the library links against nothing but the runtime).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr) fn = (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

constexpr int kErrNoEncoder = -1;     // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrTensorMap = -1000;  // minus the CUresult of a refused tensor map

// A 4-D map over (D, then the three axes as the wrapper ordered them), boxes
// of 64 columns by `box_rows` rows, 128-byte swizzle, zeros out of bounds.
// `axes` is {size1, size2, size3, stride1, stride2, stride3, order}, strides
// in elements.
inline int make_map(CUtensorMap* map, const void* ptr, int D, const long long* axes,
                    int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const int order = (int)axes[6];
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)axes[0], (cuuint64_t)axes[1],
                        (cuuint64_t)axes[2]};
  cuuint64_t strides[3] = {(cuuint64_t)axes[3] * 2, (cuuint64_t)axes[4] * 2,
                           (cuuint64_t)axes[5] * 2};
  cuuint32_t box[4] = {64, 1, 1, 1};
  for (int i = 0; i < 3; ++i)
    if (((order >> (2 * i)) & 3) == 0) box[1 + i] = (cuuint32_t)box_rows;
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                     strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrTensorMap - (int)res;
}

}  // namespace flash
