// Sketch application on Hopper (sm_90a): the row keep-mask of a sketch.
//
// Replaces repro/kernels/sketch_filter.py::sketch_filter_pallas
// (Pallas body _filter_kernel):
//   keep[i] = bits[bucket[i]]
// Rows whose bucket lies outside [0, n_ranges) are not kept.
//
// Bound on an H100: memory bandwidth.  Each row reads 4 bytes (i32 bucket)
// and writes 1 (u8 keep flag); at n = 8,388,608 rows that is ~42 MB,
// ~12.5 us at 3.35 TB/s.
//
// Design: the TPU has no fast gather, so its kernel contracts a one-hot
// (rows x ranges) matrix against the bitmap.  Hopper gathers well from
// shared memory: each block stages the n_ranges flags there once, then a
// grid-stride loop reads each bucket with a coalesced load, looks its flag
// up in shared memory and writes one byte, so device memory sees each input
// and output byte once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
filter_kernel(const int32_t* __restrict__ bucket, const uint8_t* __restrict__ bits,
              int64_t n, int n_ranges, uint8_t* __restrict__ keep) {
  extern __shared__ uint8_t s_bits[];
  for (int r = threadIdx.x; r < n_ranges; r += blockDim.x) s_bits[r] = bits[r] != 0;
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int b = bucket[i];
    keep[i] = (unsigned)b < (unsigned)n_ranges ? s_bits[b] : 0;
  }
}

}  // namespace

extern "C" int filter_threads() { return kThreads; }

// keep must hold n bytes.  Returns cudaGetLastError().
extern "C" int filter_launch(int device, void* stream, const int32_t* bucket,
                             const uint8_t* bits, long long n, int n_ranges,
                             uint8_t* keep, int n_blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)n_ranges;
  err = cudaFuncSetAttribute(filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  filter_kernel<<<n_blocks, kThreads, smem, (cudaStream_t)stream>>>(bucket, bits, n,
                                                                    n_ranges, keep);
  return (int)cudaGetLastError();
}
