// Batched fragment-membership bitmaps on Hopper (sm_90a): multi-sketch capture.
//
// Replaces repro/kernels/fragment_bitmap.py::fragment_bitmap_batch_pallas
// (Pallas body _bitmap_batch_kernel):
//   bits[b, r] = OR over rows i with bucket[i] == r of provs[b, i]
// for B provenance masks over one bucketization.  Rows whose bucket lies
// outside [0, n_ranges) set nothing.
//
// Bound on an H100: memory bandwidth.  Each row's bucket (4 bytes) and its B
// mask bytes are read once, and B x n_ranges bytes are written: at
// n = 8,388,608 rows, B = 8 that is ~100.7 MB, ~30 us at 3.35 TB/s; at
// B = 32 ~302 MB, ~90 us.
//
// Design: the TPU kernel contracts a one-hot (rows x ranges) incidence with
// the (B x rows) masks on the MXU.  Here a block owns a chunk of up to 32
// masks (blockIdx.y) and keeps one 32-bit word per range in shared memory,
// bit j of word r standing for mask 32 * chunk + j.  A grid-stride loop
// takes four consecutive rows per thread: one 16-byte load of their buckets,
// then for each mask of the chunk one 4-byte load of its four flags, packed
// into the four rows' words.  A nonzero word is OR-ed into its range's
// shared word, with the atomic skipped once the word already holds those
// bits (after the first rows most fragments are saturated).  At the end each
// block ORs its nonzero words into a global (chunks x n_ranges) word table,
// and a second small kernel unpacks the table into the bool[B, n_ranges]
// output.  OR is idempotent, so the result does not depend on the order in
// which blocks and threads arrive: bit-exact by construction.  Shared memory
// is n_ranges words per block whatever B is, so the single kernel's cap of
// 32,768 ranges holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMasksPerChunk = 32;

__device__ __forceinline__ void or_word(uint32_t* s_bits, int b, int n_ranges, uint32_t w) {
  if (w != 0u && (unsigned)b < (unsigned)n_ranges) {
    // A stale read only costs an atomic that was not needed.
    if ((s_bits[b] & w) != w) atomicOr(&s_bits[b], w);
  }
}

// kAligned: n % 4 == 0, so every mask row starts on a 4-byte boundary and
// four flags load as one word.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
bitmap_batch_kernel(const int32_t* __restrict__ bucket, const uint8_t* __restrict__ provs,
                    int64_t n, int n_masks, int n_ranges, uint32_t* __restrict__ words) {
  extern __shared__ uint32_t s_bits[];
  for (int r = threadIdx.x; r < n_ranges; r += blockDim.x) s_bits[r] = 0u;
  __syncthreads();

  const int chunk = blockIdx.y;
  const int m0 = chunk * kMasksPerChunk;
  const int nm = min(kMasksPerChunk, n_masks - m0);
  const uint8_t* base = provs + (int64_t)m0 * n;

  const int64_t n_quads = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < n_quads; q += stride) {
    const int64_t i = 4 * q;
    const int4 bk = *reinterpret_cast<const int4*>(bucket + i);
    uint32_t w0 = 0u, w1 = 0u, w2 = 0u, w3 = 0u;
    for (int j = 0; j < nm; ++j) {
      const uint8_t* row = base + (int64_t)j * n + i;
      uint32_t f;
      if (kAligned) {
        f = *reinterpret_cast<const uint32_t*>(row);
      } else {
        f = (uint32_t)row[0] | ((uint32_t)row[1] << 8) | ((uint32_t)row[2] << 16) |
            ((uint32_t)row[3] << 24);
      }
      w0 |= (uint32_t)((f & 0xFFu) != 0u) << j;
      w1 |= (uint32_t)((f & 0xFF00u) != 0u) << j;
      w2 |= (uint32_t)((f & 0xFF0000u) != 0u) << j;
      w3 |= (uint32_t)((f & 0xFF000000u) != 0u) << j;
    }
    or_word(s_bits, bk.x, n_ranges, w0);
    or_word(s_bits, bk.y, n_ranges, w1);
    or_word(s_bits, bk.z, n_ranges, w2);
    or_word(s_bits, bk.w, n_ranges, w3);
  }
  // The last n % 4 rows, one per thread of block 0 of each chunk.
  if (blockIdx.x == 0) {
    const int64_t i = 4 * n_quads + threadIdx.x;
    if (i < n) {
      uint32_t w = 0u;
      for (int j = 0; j < nm; ++j) w |= (uint32_t)(base[(int64_t)j * n + i] != 0) << j;
      or_word(s_bits, bucket[i], n_ranges, w);
    }
  }
  __syncthreads();

  uint32_t* out = words + (int64_t)chunk * n_ranges;
  for (int r = threadIdx.x; r < n_ranges; r += blockDim.x) {
    const uint32_t w = s_bits[r];
    if (w) atomicOr(&out[r], w);
  }
}

// bits[b, r] = bit (b % 32) of words[b / 32, r].
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ words, int n_masks, int n_ranges,
              bool* __restrict__ bits) {
  const int64_t total = (int64_t)n_masks * n_ranges;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < total; k += stride) {
    const int b = (int)(k / n_ranges);
    const int r = (int)(k - (int64_t)b * n_ranges);
    const uint32_t w = words[(int64_t)(b / kMasksPerChunk) * n_ranges + r];
    bits[k] = (w >> (b % kMasksPerChunk)) & 1u;
  }
}

}  // namespace

extern "C" int bitmap_batch_threads() { return kThreads; }

extern "C" int bitmap_batch_masks_per_chunk() { return kMasksPerChunk; }

// words must hold ceil(n_masks / 32) * n_ranges zeroed uint32 words; bits
// receives n_masks * n_ranges bools.  n_blocks is the grid's x extent (the
// y extent is the number of 32-mask chunks).  Returns cudaGetLastError().
extern "C" int bitmap_batch_launch(int device, void* stream, const int32_t* bucket,
                                   const uint8_t* provs, long long n, int n_masks,
                                   int n_ranges, uint32_t* words, bool* bits,
                                   int n_blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)n_ranges * sizeof(uint32_t);
  const int chunks = (n_masks + kMasksPerChunk - 1) / kMasksPerChunk;
  const dim3 grid(n_blocks, chunks);
  cudaStream_t s = (cudaStream_t)stream;
  if (n % 4 == 0) {
    err = cudaFuncSetAttribute(bitmap_batch_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    bitmap_batch_kernel<true><<<grid, kThreads, smem, s>>>(bucket, provs, n, n_masks,
                                                           n_ranges, words);
  } else {
    err = cudaFuncSetAttribute(bitmap_batch_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    bitmap_batch_kernel<false><<<grid, kThreads, smem, s>>>(bucket, provs, n, n_masks,
                                                            n_ranges, words);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n_masks * n_ranges;
  const int unpack_blocks = (int)((total + kThreads - 1) / kThreads < 1024
                                      ? (total + kThreads - 1) / kThreads : 1024);
  unpack_kernel<<<unpack_blocks, kThreads, 0, s>>>(words, n_masks, n_ranges, bits);
  return (int)cudaGetLastError();
}
