// Fragment-membership bitmap on Hopper (sm_90a): the sketch-capture scan.
//
// Replaces repro/kernels/fragment_bitmap.py::fragment_bitmap_pallas
// (Pallas body _bitmap_kernel):
//   bits[r] = OR over rows i with bucket[i] == r of prov[i]
// Rows whose bucket lies outside [0, n_ranges) set nothing.
//
// Bound on an H100: memory bandwidth.  Each row is read once, 5 bytes
// (i32 bucket, u8 provenance flag); at n = 8,388,608 rows that is ~42 MB,
// ~12.5 us at 3.35 TB/s.  The output is n_ranges words.
//
// Design: the TPU kernel compares every row against every range id (a
// one-hot compare and column max).  Here each block keeps an n_ranges-word
// bitmap in shared memory and a grid-stride loop streams the rows with
// coalesced loads; a provenance row stores 1 into its fragment's word (a
// plain store: every writer writes the same value, so the result does not
// depend on order).  The bucket of a row outside the provenance is never
// loaded.  At the end each block ORs its set words into the global bitmap,
// at most n_ranges atomics a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bitmap_kernel(const int32_t* __restrict__ bucket, const uint8_t* __restrict__ prov,
              int64_t n, int n_ranges, int32_t* __restrict__ bits) {
  extern __shared__ int32_t s_bits[];
  for (int r = threadIdx.x; r < n_ranges; r += blockDim.x) s_bits[r] = 0;
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (prov[i]) {
      const int b = bucket[i];
      if ((unsigned)b < (unsigned)n_ranges) s_bits[b] = 1;
    }
  }
  __syncthreads();

  for (int r = threadIdx.x; r < n_ranges; r += blockDim.x) {
    if (s_bits[r]) atomicOr(&bits[r], 1);
  }
}

}  // namespace

extern "C" int bitmap_threads() { return kThreads; }

// bits must hold n_ranges zeroed int32 words.  Returns cudaGetLastError().
extern "C" int bitmap_launch(int device, void* stream, const int32_t* bucket,
                             const uint8_t* prov, long long n, int n_ranges,
                             int32_t* bits, int n_blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)n_ranges * sizeof(int32_t);
  err = cudaFuncSetAttribute(bitmap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  bitmap_kernel<<<n_blocks, kThreads, smem, (cudaStream_t)stream>>>(bucket, prov, n,
                                                                    n_ranges, bits);
  return (int)cudaGetLastError();
}
