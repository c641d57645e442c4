// Segmented sum and count on Hopper (sm_90a).
//
// Replaces repro/kernels/segment_aggregate.py::segment_aggregate_pallas
// (Pallas body _segagg_kernel):
//   sums[g]   = sum over rows i with gid[i] == g of values[i] * weights[i]
//   counts[g] = sum over rows i with gid[i] == g of weights[i]
// Rows whose gid lies outside [0, n_groups) add nothing (the Pallas kernel's
// -1 padding); rows of weight 0 whose product is 0 are skipped, which is
// exact because every sum starts at +0.0.
//
// Bound on an H100: memory bandwidth.  Each row is read once, 12 bytes
// (f32 value, i32 gid, f32 weight), and each group written once, 8 bytes;
// at n = 8,388,608 rows that is ~101 MB, ~30 us at 3.35 TB/s.  The
// arithmetic (one multiply, two adds a row) is far below the card's rate.
//
// Design: the TPU kernel builds a (rows x groups) one-hot matrix for the
// MXU, O(rows * groups) work for an O(rows) job.  Here each block sums its
// rows into partials in shared memory in one pass, so every input byte
// crosses the memory bus once; each block writes its partials to global
// scratch and a second launch adds them per group in block order.
//
// The order of the float additions is fixed, so reruns give the same bits
// (no float atomics; the result depends only on the inputs and the grid).
// Two ways, by the number of groups:
//
// - Few groups (segagg_private): every warp keeps its own sums and counts
//   (2 * n_groups floats each) and adds its own runs of 32 rows, several
//   runs' loads in flight at once.  The lanes holding rows of one group
//   find each other with __match_any_sync; the lowest adds their rows in
//   lane order (fetched by shuffles), so a warp sums a group's rows in row
//   order.  At the end the block adds its warps' partials in warp order.
// - Many groups (segagg_owned, up to 128 KB of partials for the 16,384-group
//   pad of the widest group-bys; above the shared-memory budget they live in
//   the block's slice of the global scratch): one copy of the partials a
//   block, and warp w owns the groups g with g % kWarps == w.  Each tile of
//   kTile rows is split into one list per owning warp, keeping row order (a
//   stable counting sort: match per run of 32 rows, then a prefix sum of the
//   counts), and each warp adds its list as above.  The next tile's loads
//   are in flight while the current one is split and added.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMergeThreads = 256;

// segagg_private: 8 warps a block, each with kSteps runs of loads in flight.
constexpr int kPrivThreads = 256;
constexpr int kPrivWarps = kPrivThreads / 32;
constexpr int kSteps = 2;

// segagg_owned: 16 owning warps, tiles of 2,048 rows (4 a thread).
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;   // owners: warp w adds the groups g % kWarps == w
constexpr int kRows = 4;                // rows per thread per tile
constexpr int kTile = kThreads * kRows;
constexpr int kRuns = kRows * kWarps;   // runs of 32 rows in a tile
constexpr int kCounts = kWarps * kRuns; // rows of each owner in each run

static_assert(kCounts == 2 * kThreads, "the scan gives each thread two counts");

// Shared words before the partials: the owner lists (group, value * weight,
// weight), the counts, and the per-warp scan totals.
constexpr int kStageWords = 3 * kTile + kCounts + 32;

// Row i as (group or -1 when it adds nothing, value * weight, weight).
__device__ __forceinline__ void load_row(const float* __restrict__ values,
                                         const int32_t* __restrict__ gid,
                                         const float* __restrict__ weights, int64_t i,
                                         int64_t n, int n_groups, int32_t& k, float& p,
                                         float& w) {
  k = -1;
  p = w = 0.f;
  if (i < n) {
    const int g = gid[i];
    w = weights[i];
    p = values[i] * w;
    if ((unsigned)g < (unsigned)n_groups && !(w == 0.f && p == 0.f)) k = g;
  }
}

// One warp adds a run of 32 rows (lane l holds row k, p, w) into acc, each
// group's rows in lane order after what acc holds.
__device__ __forceinline__ void add_run(float* acc, int n_groups, int lane, int32_t k,
                                        float p, float w) {
  const unsigned peers = __match_any_sync(kFull, k);
  const bool lead = k >= 0 && __ffs(peers) - 1 == lane;
  const int most = (int)__reduce_max_sync(kFull, lead ? (unsigned)__popc(peers) : 0u);
  float sum = 0.f, count = 0.f;
  if (lead) {
    sum = acc[k];
    count = acc[n_groups + k];
  }
  unsigned m = lead ? peers : 0u;
  for (int it = 0; it < most; ++it) {
    const bool take = m != 0;
    const int src = take ? __ffs(m) - 1 : lane;
    m &= m - 1;
    const float ps = __shfl_sync(kFull, p, src);
    const float ws = __shfl_sync(kFull, w, src);
    if (take) {
      sum += ps;
      count += ws;
    }
  }
  if (lead) {
    acc[k] = sum;
    acc[n_groups + k] = count;
  }
  __syncwarp();  // the next run's leader may be another lane of this warp
}

__global__ void __launch_bounds__(kPrivThreads)
segagg_private(const float* __restrict__ values, const int32_t* __restrict__ gid,
               const float* __restrict__ weights, int64_t n, int n_groups,
               float* __restrict__ partials) {
  extern __shared__ float smem[];  // kPrivWarps copies of (sums, counts)
  for (int j = threadIdx.x; j < kPrivWarps * 2 * n_groups; j += kPrivThreads) smem[j] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* acc = smem + warp * 2 * n_groups;
  const int64_t n_runs = (n + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * kPrivWarps;  // this warp's runs: run0 + t * stride
  int32_t rk[kSteps];
  float rp[kSteps], rw[kSteps];
  for (int64_t run0 = (int64_t)blockIdx.x * kPrivWarps + warp; run0 < n_runs;
       run0 += kSteps * stride) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      load_row(values, gid, weights, (run0 + u * stride) * 32 + lane, n, n_groups, rk[u],
               rp[u], rw[u]);
#pragma unroll
    for (int u = 0; u < kSteps; ++u) add_run(acc, n_groups, lane, rk[u], rp[u], rw[u]);
  }
  __syncthreads();
  float* out = partials + (int64_t)blockIdx.x * 2 * n_groups;
  for (int j = threadIdx.x; j < 2 * n_groups; j += kPrivThreads) {
    float t = 0.f;
    for (int w = 0; w < kPrivWarps; ++w) t += smem[w * 2 * n_groups + j];
    out[j] = t;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
segagg_owned(const float* __restrict__ values, const int32_t* __restrict__ gid,
             const float* __restrict__ weights, int64_t n, int n_groups,
             float* __restrict__ partials) {
  extern __shared__ float smem[];
  int32_t* lkey = reinterpret_cast<int32_t*>(smem);
  float* lp = smem + kTile;
  float* lw = lp + kTile;
  int32_t* cnt = reinterpret_cast<int32_t*>(lw + kTile);  // [owner][run], then offsets
  int32_t* wsum = cnt + kCounts;                          // warp totals; [kWarps] = tile total
  float* acc = kShared ? smem + kStageWords : partials + (int64_t)blockIdx.x * 2 * n_groups;
  for (int j = threadIdx.x; j < 2 * n_groups; j += kThreads) acc[j] = 0.f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  int32_t rk[kRows], nk[kRows];  // this tile's rows and the next tile's
  float rp[kRows], rw[kRows], np[kRows], nw[kRows];
  auto fetch = [&](int64_t tile) {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      load_row(values, gid, weights,
               tile < n_tiles ? tile * kTile + j * kThreads + threadIdx.x : n, n, n_groups,
               nk[j], np[j], nw[j]);
  };

  fetch(blockIdx.x);
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      rk[j] = nk[j];
      rp[j] = np[j];
      rw[j] = nw[j];
    }
    fetch(tile + gridDim.x);  // in flight while this tile is split and added
    // Row j * kThreads + threadIdx.x of the tile lies in run j * kWarps + warp:
    // runs in this order are rows in order.  1. Count each owner's rows per run.
    __syncthreads();  // the previous tile's lists are consumed (and acc is zeroed)
    for (int i = threadIdx.x; i < kCounts; i += kThreads) cnt[i] = 0;
    __syncthreads();
    int rank[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int owner = rk[j] < 0 ? -1 : (rk[j] & (kWarps - 1));
      const unsigned same = __match_any_sync(kFull, owner);
      rank[j] = __popc(same & below);
      if (owner >= 0 && rank[j] == 0) cnt[owner * kRuns + j * kWarps + warp] = __popc(same);
    }
    __syncthreads();

    // 2. Exclusive prefix sum of the counts in (owner, run) order.
    const int a = cnt[2 * threadIdx.x], b = cnt[2 * threadIdx.x + 1];
    int incl = a + b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < kWarps ? wsum[lane] : 0;
      int w_incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, w_incl, d);
        if (lane >= d) w_incl += y;
      }
      if (lane < kWarps) wsum[lane] = w_incl - v;
      if (lane == kWarps - 1) wsum[kWarps] = w_incl;
    }
    __syncthreads();
    const int base = wsum[warp] + incl - (a + b);
    cnt[2 * threadIdx.x] = base;
    cnt[2 * threadIdx.x + 1] = base + a;
    __syncthreads();

    // 3. Each row to its owner's list, in row order.
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (rk[j] >= 0) {
        const int pos = cnt[(rk[j] & (kWarps - 1)) * kRuns + j * kWarps + warp] + rank[j];
        lkey[pos] = rk[j];
        lp[pos] = rp[j];
        lw[pos] = rw[j];
      }
    }
    __syncthreads();

    // 4. Warp w adds its list, 32 rows a step, each group's rows in lane order.
    const int begin = cnt[warp * kRuns];
    const int end = warp + 1 < kWarps ? cnt[(warp + 1) * kRuns] : wsum[kWarps];
    for (int s = begin; s < end; s += 32) {
      const bool in = s + lane < end;
      add_run(acc, n_groups, lane, in ? lkey[s + lane] : -1, in ? lp[s + lane] : 0.f,
              in ? lw[s + lane] : 0.f);
    }
  }

  if (kShared) {
    __syncthreads();
    float* out = partials + (int64_t)blockIdx.x * 2 * n_groups;
    for (int j = threadIdx.x; j < 2 * n_groups; j += kThreads) out[j] = acc[j];
  }
}

// One thread per output: adds the blocks' partials in block order.
__global__ void segagg_merge(const float* __restrict__ partials, int n_blocks,
                             int n_groups, float* __restrict__ sums,
                             float* __restrict__ counts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * n_groups) return;
  float t = 0.f;
  for (int b = 0; b < n_blocks; ++b) t += partials[(int64_t)b * 2 * n_groups + j];
  if (j < n_groups) {
    sums[j] = t;
  } else {
    counts[j - n_groups] = t;
  }
}

}  // namespace

// scratch holds n_blocks * 2 * n_groups floats.  mode picks where the
// per-block partials accumulate: 0 per-warp copies in shared memory
// (segagg_private), 1 one copy in shared memory and 2 the block's slice of
// scratch (segagg_owned).  Returns cudaGetLastError() after both launches
// (0 on success).
extern "C" int segagg_launch(int device, void* stream, const float* values,
                             const int32_t* gid, const float* weights, long long n,
                             int n_groups, float* sums, float* counts,
                             float* scratch, int n_blocks, int mode) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t part = (size_t)2 * n_groups * sizeof(float);
  const size_t stage = (size_t)kStageWords * sizeof(float);
  if (mode == 0) {
    const size_t smem = kPrivWarps * part;
    err = cudaFuncSetAttribute(segagg_private, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    segagg_private<<<n_blocks, kPrivThreads, smem, s>>>(values, gid, weights, n, n_groups,
                                                        scratch);
  } else if (mode == 1) {
    err = cudaFuncSetAttribute(segagg_owned<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(stage + part));
    if (err != cudaSuccess) return (int)err;
    segagg_owned<true><<<n_blocks, kThreads, stage + part, s>>>(values, gid, weights, n,
                                                                n_groups, scratch);
  } else {
    segagg_owned<false><<<n_blocks, kThreads, stage, s>>>(values, gid, weights, n, n_groups,
                                                          scratch);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outs = 2 * n_groups;
  segagg_merge<<<(outs + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
      scratch, n_blocks, n_groups, sums, counts);
  return (int)cudaGetLastError();
}
