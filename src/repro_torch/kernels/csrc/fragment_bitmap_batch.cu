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
// the (B x rows) masks on the MXU.  Here one launch does the whole call.
// - A block owns a chunk of up to 32 masks (blockIdx.y) and keeps one
//   32-bit word per range in shared memory, bit j of word r standing for
//   mask 32 * chunk + j (n_ranges words, at most 128 KB).
// - It takes tiles of 4,096 rows, 16 a thread as four runs of 4 rows, 1,024
//   rows apart (each load instruction reads contiguous bytes across the
//   warp).  The flags of a run are one 4-byte load a mask; the masks are
//   taken kGroup = 8 at a time, all 32 loads of a group (8 masks, 4 runs)
//   issued before any is used, and packed into a word a row (the kernel is
//   templated on the masks a chunk, 8, 16 or 32, so the loops unroll).  The
//   buckets of a run are one 16-byte load, only where some mask has a flag
//   in the run.
// - A thread ORs the words of its consecutive rows of one range first (a
//   clustered provenance puts a run of rows in one fragment) and sets the
//   shared word with an atomicOr only when a bit is missing.
// - Blocks are grouped in thread-block clusters of kCluster; at the end
//   each block ORs its share of the words over every block of its cluster
//   through distributed shared memory and ORs the nonzero ones into a
//   global word table (chunks x n_ranges, one atomic a word and cluster).
// - The last cluster to finish (an atomic count) writes the bool[B, n_ranges]
//   output (16-byte stores where a mask's row of it allows) and zeroes the
//   word table and the count for the next call.
// OR does not depend on order, so the bits are deterministic.  The word
// table and the count are a workspace the wrapper keeps per device and
// stream (zeroed when made).  Bools are bytes of 0 or 1 (torch.bool).
//
// kAligned (n % 4 == 0, the masks 4-byte and the buckets 16-byte aligned):
// the loads above.  Else every row's flags and bucket are loaded one by one
// (a view of odd length or offset; the same bits, slower).
//
// Measured on an H100 80GB HBM3 at 700 W (kernels/bitmap_probe.py, PERF.md;
// n = 2^23, device time, L2 warm): B = 8 at 100 ranges 0.044 ms against a
// 0.030 bound (the three launches it replaced: 0.042), of it the scan 0.037
// (the flags alone 0.032), the cluster merge 0.004 and the output 0.003;
// B = 32 0.112 (0.115) against 0.090; B = 8 at 32,768 ranges 0.111 (0.187).
// Clusters of one block tie at 100 ranges and are 1.7x slower at 32,768;
// 16 consecutive rows a thread with 16-byte flag loads are 17% slower at
// B = 8; loading every run's buckets ties; registers capped for 4 blocks
// an SM are 24% slower at B = 8.  Registers: 70 (8 masks), 100 (16), 128
// (32), no spills.

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
constexpr int kMasksPerChunk = 32;
constexpr int kGroup = 8;  // masks whose flag loads are in flight together
constexpr int kMaxRanges = 32768;
constexpr int kDevices = 64;

struct Run {
  int range = -1;
  uint32_t bits = 0;
};

__device__ __forceinline__ void flush(uint32_t* s_words, const Run& run) {
  if (run.bits && (s_words[run.range] & run.bits) != run.bits)
    atomicOr(&s_words[run.range], run.bits);
}

// Row of range b with mask word w: joins the open run or flushes it.
__device__ __forceinline__ void set(uint32_t* s_words, Run& run, int b, uint32_t w,
                                    int n_ranges) {
  if (w == 0u || (unsigned)b >= (unsigned)n_ranges) return;
  if (b != run.range) {
    flush(s_words, run);
    run.range = b;
    run.bits = 0;
  }
  run.bits |= w;
}

// Gridded as (blocks, chunks) in clusters of kCluster along x; kMasks the
// masks of the widest chunk (8, 16 or 32).
template <int kMasks, bool kAligned>
__global__ void __launch_bounds__(kThreads)
bitmap_batch_kernel(const int32_t* __restrict__ bucket, const uint8_t* __restrict__ provs,
                    int64_t n, int n_masks, int n_ranges, uint32_t* __restrict__ words,
                    unsigned int* __restrict__ done, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t s_words[];
  __shared__ uint32_t s_last;
  for (int r = threadIdx.x; r < n_ranges; r += kThreads) s_words[r] = 0u;
  __syncthreads();

  const int chunk = blockIdx.y;
  const int nm = min(kMasksPerChunk, n_masks - chunk * kMasksPerChunk);
  const uint8_t* base = provs + (int64_t)chunk * kMasksPerChunk * n;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  Run run;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t first = tile * kTile + threadIdx.x * 4;
    if (kAligned && tile * kTile + kTile <= n) {
      uint32_t w[4][4] = {};  // [run][row]: the row's mask word
#pragma unroll
      for (int g = 0; g < kMasks; g += kGroup) {
        uint32_t f[kGroup][4];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            f[j][q] = g + j < nm ? __ldg(reinterpret_cast<const uint32_t*>(
                                       base + (int64_t)(g + j) * n + first + q * kRun))
                                 : 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t a = 0;  // byte r: the group's flags of row r, bit j for mask g + j
#pragma unroll
          for (int j = 0; j < kGroup; ++j) a |= f[j][q] << j;
#pragma unroll
          for (int r = 0; r < 4; ++r) w[q][r] |= ((a >> (8 * r)) & 0xffu) << g;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!(w[q][0] | w[q][1] | w[q][2] | w[q][3])) continue;
        const int4 v = __ldg(reinterpret_cast<const int4*>(bucket + first + q * kRun));
        set(s_words, run, v.x, w[q][0], n_ranges);
        set(s_words, run, v.y, w[q][1], n_ranges);
        set(s_words, run, v.z, w[q][2], n_ranges);
        set(s_words, run, v.w, w[q][3], n_ranges);
      }
    } else {
      for (int q = 0; q < 4; ++q)
        for (int r = 0; r < 4; ++r) {
          const int64_t i = first + q * kRun + r;
          if (i >= n) continue;
          uint32_t w = 0;
#pragma unroll
          for (int j = 0; j < kMasks; ++j)
            if (j < nm) w |= (uint32_t)(base[(int64_t)j * n + i] != 0) << j;
          if (w) set(s_words, run, bucket[i], w, n_ranges);
        }
    }
  }
  flush(s_words, run);

  // Merge the cluster's words: block `rank` ORs words rank * kThreads + t,
  // stepping by the cluster's threads, over every block of the cluster.
  cluster_sync();
  const uint32_t rank = cluster_rank();
  uint32_t* table = words + (int64_t)chunk * n_ranges;
  for (int r = rank * kThreads + threadIdx.x; r < n_ranges; r += kCluster * kThreads) {
    uint32_t v = 0;
#pragma unroll
    for (uint32_t c = 0; c < kCluster; ++c) v |= ld_shared_cluster(s_words + r, c);
    if (v) atomicOr(&table[r], v);
  }
  __threadfence();  // the words before the count
  cluster_sync();   // no remote reads of s_words after this
  if (rank == 0 && threadIdx.x == 0) {
    const unsigned clusters = gridDim.x / kCluster * gridDim.y;
    const uint32_t last = atomicAdd(done, 1u) == clusters - 1;
    for (uint32_t c = 0; c < kCluster; ++c) st_shared_cluster(&s_last, c, last);
  }
  cluster_sync();
  if (!s_last) return;
  // The last cluster: every other cluster's words are in.  Mask b's row of
  // the output is bit b % 32 of the words of chunk b / 32, 16 ranges a
  // thread at a time (one 16-byte store where the row allows it).
  __threadfence();
  const int spans = (n_ranges + 15) / 16;
  const int64_t items = (int64_t)n_masks * spans;
  for (int64_t k = rank * kThreads + threadIdx.x; k < items; k += kCluster * kThreads) {
    const int b = (int)(k / spans);
    const int r0 = (int)(k - (int64_t)b * spans) * 16;
    const uint32_t* src = words + (int64_t)(b / kMasksPerChunk) * n_ranges + r0;
    const int shift = b % kMasksPerChunk;
    uint8_t* dst = out + (int64_t)b * n_ranges + r0;
    if (r0 + 16 <= n_ranges && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t x = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) x |= ((__ldcg(src + 4 * e + t) >> shift) & 1u) << (8 * t);
        v[e] = x;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int r = 0; r < 16 && r0 + r < n_ranges; ++r)
        dst[r] = (uint8_t)((__ldcg(src + r) >> shift) & 1u);
    }
  }
  // Every block of this cluster has read the words it writes above: zero the
  // table (each block its share) and the count once all have.
  cluster_sync();
  const int64_t table_words = (int64_t)gridDim.y * n_ranges;
  for (int64_t r = rank * kThreads + threadIdx.x; r < table_words; r += kCluster * kThreads)
    words[r] = 0u;
  if (rank == 0 && threadIdx.x == 0) *done = 0;
}

using Kernel = void (*)(const int32_t*, const uint8_t*, int64_t, int, int, uint32_t*,
                        unsigned int*, uint8_t*);

// The instance for chunks of up to `masks` masks (kMasks 8, 16 or 32).
Kernel kernel_of(int masks, bool aligned) {
  if (masks <= 8) return aligned ? bitmap_batch_kernel<8, true> : bitmap_batch_kernel<8, false>;
  if (masks <= 16)
    return aligned ? bitmap_batch_kernel<16, true> : bitmap_batch_kernel<16, false>;
  return aligned ? bitmap_batch_kernel<32, true> : bitmap_batch_kernel<32, false>;
}

// The launch, with the kernel's shared-memory allowance raised to the most
// any call needs once per device and instance.
cudaError_t config(int masks, bool aligned, int blocks, int chunks, int n_ranges,
                   cudaStream_t stream, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                   Kernel& fn) {
  if (n_ranges < 1 || n_ranges > kMaxRanges || masks < 1 || blocks < kCluster ||
      blocks % kCluster != 0)
    return cudaErrorInvalidValue;
  fn = kernel_of(masks, aligned);
  static bool allowed[kDevices][6] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int which = 2 * (masks <= 8 ? 0 : masks <= 16 ? 1 : 2) + aligned;
  if (device >= kDevices || !allowed[device][which]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxRanges * 4);
    if (err != cudaSuccess) return err;
    if (device < kDevices) allowed[device][which] = true;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(blocks, chunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)n_ranges * 4;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// The clusters of kCluster blocks of the instance for `masks` masks a chunk
// that can be resident at once with n_ranges words of shared memory a block,
// or minus a CUDA error code.
extern "C" int bitmap_batch_clusters(int device, int masks, int n_ranges) {
  cudaError_t err = use_device(device);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Kernel fn;
  if (err == cudaSuccess) err = config(masks, true, kCluster, 1, n_ranges, 0, cfg, attr, fn);
  int count = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  if (err == cudaSuccess && count < 1) err = cudaErrorInvalidConfiguration;
  return err == cudaSuccess ? count : -(int)err;
}

// bits (n_masks x n_ranges bytes) receives the bitmaps.  words holds at
// least ceil(n_masks / 32) * n_ranges zero u32 words and done one zero u32
// (every call leaves them so).  blocks: the grid's x extent (whole
// clusters); aligned: n % 4 == 0, provs 4-byte and bucket 16-byte aligned.
// Returns cudaGetLastError() (or the launch's own refusal).
extern "C" int bitmap_batch_launch(int device, void* stream, const int32_t* bucket,
                                   const uint8_t* provs, long long n, int n_masks,
                                   int n_ranges, uint32_t* words, unsigned int* done,
                                   uint8_t* bits, int blocks, int aligned) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (n_masks + kMasksPerChunk - 1) / kMasksPerChunk;
  const int masks = n_masks < kMasksPerChunk ? n_masks : kMasksPerChunk;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Kernel fn;
  err = config(masks, aligned != 0, blocks, chunks, n_ranges, (cudaStream_t)stream, cfg, attr,
               fn);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, fn, bucket, provs, (int64_t)n, n_masks, n_ranges, words, done,
                             bits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
