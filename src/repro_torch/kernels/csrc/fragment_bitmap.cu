// Fragment-membership bitmap on Hopper (sm_90a): the sketch-capture scan.
//
// Replaces repro/kernels/fragment_bitmap.py::fragment_bitmap_pallas
// (Pallas body _bitmap_kernel):
//   bits[r] = OR over rows i with bucket[i] == r of prov[i]
// Rows whose bucket lies outside [0, n_ranges) set nothing.
//
// Bound on an H100: memory bandwidth.  Every provenance flag is read (1 byte
// a row), and the bucket of every provenance row; device memory moves
// 32-byte sectors, so the bucket bytes to read are 32 per sector of 8 rows
// holding a provenance row.  At n = 8,388,608 rows with a random quarter in
// the provenance (9 in 10 sectors hold one) that is ~39 MB, ~11.6 us at
// 3.35 TB/s.  The output is n_ranges bytes.
//
// Design: the TPU kernel compares every row against every range id (a
// one-hot compare and column max).  Here one launch does the whole call:
// - each block keeps one bit per range in shared memory (at most 4 KB, so
//   many blocks share an SM) and takes tiles of 4,096 rows, 16 a thread in
//   four runs of 4 rows, 1,024 rows apart (so each load instruction reads
//   contiguous bytes across the warp): the four runs' provenance flags as
//   four 4-byte loads, then the buckets only of the runs that hold a
//   provenance row, each as one 16-byte load;
// - a thread first ORs the bits of its rows that fall in one shared word
//   (clustered provenance puts a run of rows in one fragment) and sets the
//   word with an atomicOr only when a bit is missing, so a word that is
//   already full costs a shared load and no atomic;
// - blocks are grouped in thread-block clusters of kCluster; at the end
//   each block ORs its share of the words over every block of its cluster
//   through distributed shared memory and ORs the nonzero ones into a
//   global word array (one atomic a word and cluster);
// - the last cluster to finish (an atomic count) turns the words into the
//   bool output (16-byte stores; the output starts on a 16-byte boundary)
//   and zeroes the words and the count for the next call.
// OR does not depend on order, so the bits are deterministic.  The word
// array and the count are a workspace the wrapper keeps per device and
// stream (zeroed once when made).
//
// Measured on the H100 (kernels/filter_probe.py, PERF.md): the scan is
// about 90% of a call with the L2 evicted, the merge and output about
// 0.004 ms at 100 ranges; clusters of 8 beat single blocks 1.3-1.75x at
// 32,768 ranges (a block's words go to global atomics) and cost 3-11% at
// 100; runs of 4 rows gained 11% over 16 consecutive rows a thread; bucket
// loads that do not wait for the flags gain 1-9% here but would read every
// sector where the provenance is sparse.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;  // four runs of 4
constexpr int kRun = kThreads * 4;  // rows between a thread's runs
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kCluster = 8;  // the portable maximum
constexpr int kMaxRanges = 32768;
constexpr int kMaxWords = kMaxRanges / 32;

// Four bits (bits 0-3 of m) as four bytes of 0 or 1.
__device__ __forceinline__ uint32_t bytes_of(uint32_t m) {
  return (m & 1u) | ((m & 2u) << 7) | ((m & 4u) << 14) | ((m & 8u) << 21);
}

struct Run {
  int word = -1;
  uint32_t bits = 0;
};

__device__ __forceinline__ void flush(uint32_t* s_words, const Run& run) {
  if (run.bits && (s_words[run.word] & run.bits) != run.bits)
    atomicOr(&s_words[run.word], run.bits);
}

__device__ __forceinline__ void set(uint32_t* s_words, Run& run, int b, int n_ranges) {
  if ((unsigned)b >= (unsigned)n_ranges) return;
  const int w = b >> 5;
  if (w != run.word) {
    flush(s_words, run);
    run.word = w;
    run.bits = 0;
  }
  run.bits |= 1u << (b & 31);
}

__global__ void __launch_bounds__(kThreads)
bitmap_kernel(const int32_t* __restrict__ bucket, const uint8_t* __restrict__ prov, int64_t n,
              int n_ranges, uint32_t* __restrict__ words, unsigned int* __restrict__ done,
              uint8_t* __restrict__ out) {
  extern __shared__ uint32_t s_words[];
  __shared__ bool s_last;
  const int n_words = (n_ranges + 31) >> 5;
  for (int w = threadIdx.x; w < n_words; w += kThreads) s_words[w] = 0;
  __syncthreads();

  const int64_t n_tiles = (n + kTile - 1) / kTile;
  Run run;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t base = tile * kTile + threadIdx.x * 4;
    if (tile * kTile + kTile <= n) {
      uint32_t pw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pw[q] = __ldg(reinterpret_cast<const uint32_t*>(prov + base + q * kRun));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!pw[q]) continue;
        const int4 v = __ldg(reinterpret_cast<const int4*>(bucket + base + q * kRun));
        if (pw[q] & 0xffu) set(s_words, run, v.x, n_ranges);
        if (pw[q] & 0xff00u) set(s_words, run, v.y, n_ranges);
        if (pw[q] & 0xff0000u) set(s_words, run, v.z, n_ranges);
        if (pw[q] & 0xff000000u) set(s_words, run, v.w, n_ranges);
      }
    } else {
      for (int q = 0; q < 4; ++q)
        for (int j = 0; j < 4; ++j) {
          const int64_t r = base + q * kRun + j;
          if (r < n && prov[r]) set(s_words, run, bucket[r], n_ranges);
        }
    }
  }
  flush(s_words, run);

  // Merge the cluster's bitmaps: block `rank` ORs words rank*kThreads + t,
  // stepping by the cluster's threads, over every block of the cluster.
  cluster_sync();
  const uint32_t rank = cluster_rank(), size = cluster_size();
  for (int w = rank * kThreads + threadIdx.x; w < n_words; w += size * kThreads) {
    uint32_t v = 0;
    for (uint32_t r = 0; r < size; ++r) v |= ld_shared_cluster(s_words + w, r);
    if (v) {
      atomicOr(&words[w], v);
      __threadfence();  // before the cluster's count below
    }
  }
  cluster_sync();  // no block leaves while its words may still be read
  if (threadIdx.x == 0) s_last = rank == 0 && atomicAdd(done, 1u) == gridDim.x / size - 1;
  __syncthreads();
  if (!s_last) return;
  // The last cluster: every other cluster's words are in.  Each word becomes
  // 32 bytes of the output (two 16-byte stores) and is zeroed.
  __threadfence();
  for (int w = threadIdx.x; w < n_words; w += kThreads) {
    const uint32_t v = __ldcg(&words[w]);
    words[w] = 0;
    const int r0 = w * 32;
    if (r0 + 32 <= n_ranges) {
      uint4* dst = reinterpret_cast<uint4*>(out + r0);
      dst[0] = make_uint4(bytes_of(v), bytes_of(v >> 4), bytes_of(v >> 8), bytes_of(v >> 12));
      dst[1] = make_uint4(bytes_of(v >> 16), bytes_of(v >> 20), bytes_of(v >> 24),
                          bytes_of(v >> 28));
    } else {
      for (int r = r0; r < n_ranges; ++r) out[r] = (uint8_t)((v >> (r - r0)) & 1u);
    }
  }
  if (threadIdx.x == 0) *done = 0;
}

// Per device (up to kDevices), set once: the clusters that can be resident.
constexpr int kDevices = 64;
int g_clusters[kDevices];

cudaLaunchConfig_t config(int blocks, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t clusters_of(int device, int* clusters) {
  const bool cached = device >= 0 && device < kDevices;
  if (cached && g_clusters[device] > 0) {
    *clusters = g_clusters[device];
    return cudaSuccess;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(kCluster, kMaxWords * 4, 0, &attr);
  int count = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&count, bitmap_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (count < 1) return cudaErrorInvalidConfiguration;
  *clusters = count;
  if (cached) g_clusters[device] = count;
  return cudaSuccess;
}

}  // namespace


// The clusters of kCluster blocks the launch keeps resident on `device`
// (the grid is at most this many), or minus a CUDA error code.
extern "C" int bitmap_clusters(int device) {
  int cur = -1, clusters = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = clusters_of(device, &clusters);
  return err == cudaSuccess ? clusters : -(int)err;
}

// bits (n_ranges bytes) receives the bitmap; bucket and prov 16-byte
// aligned; 1 <= n_ranges <= kMaxRanges.  ws holds kMaxWords + 1 u32 words,
// zero (every call leaves them so).  Returns cudaGetLastError() (or the
// launch's own refusal).
extern "C" int bitmap_launch(int device, void* stream, const int32_t* bucket, const uint8_t* prov,
                             long long n, int n_ranges, uint32_t* ws, uint8_t* bits) {
  if (n_ranges < 1 || n_ranges > kMaxRanges) return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  int clusters = 0;
  if (err == cudaSuccess) err = clusters_of(device, &clusters);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long want = (tiles + kCluster - 1) / kCluster;
  const int grid = (int)(want < 1 ? 1 : (want < clusters ? want : clusters)) * kCluster;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      config(grid, (size_t)(n_ranges + 31) / 32 * 4, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, bitmap_kernel, bucket, prov, (int64_t)n, n_ranges, ws,
                           reinterpret_cast<unsigned int*>(ws + kMaxWords), bits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
