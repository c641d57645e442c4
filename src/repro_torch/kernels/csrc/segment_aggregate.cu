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
// The TPU kernel builds a (rows x groups) one-hot matrix for the MXU,
// O(rows * groups) work for an O(rows) job; here every row is read once and
// added once, with no float atomics: the order of the additions depends only
// on (n, n_groups, the plan), so reruns give equal bits on any input.
//
// Few groups (segagg_private, 2 * n_groups floats at most 8 KB): every warp
// keeps its own sums and counts in shared memory and adds its own runs of 32
// rows, several runs' loads in flight at once.  The lanes holding rows of one
// group find each other with __match_any_sync; the lowest adds their rows in
// lane order (fetched by shuffles), so a warp sums a group's rows in row
// order.  The block adds its warps' copies in warp order into its partials.
//
// Many groups (segagg_sliced): a thread-block cluster of C blocks sums one
// chunk of rows, and block c owns the groups [c * slice, (c + 1) * slice)
// of its window, slice <= kSliceMax (C = 4 at the 16,384-group pad of the
// widest group-bys seen, 1 up to 4,096).  A cluster covers at most
// kClusterMax * kSliceMax = 32,768 groups, its window: above that the
// grid's z axis runs one cluster per window and chunk (2 windows at
// 65,536 groups), each reading the chunk's rows for its own groups, so a
// launch takes any width with blocks of one shape.  The chunk's tiles of
// kTileRows rows stream into a ring of kStages stages in every block's
// shared memory by 1-D bulk async copies: block i % C copies tile i whole
// (values, gids, weights), multicast to every block of the cluster, and
// asks L2 for the tile
// kPrefetch ahead, so device memory is read once a row and the copies find
// their rows in L2.  The warps are specialised.  kFilters filter warps each
// take kFilterRows rows of a tile and, with no branch, find the rows of
// their block's slice (an unsigned compare, a ballot and a popc rank a run
// of 32) and compact them in place, in row order, at the head of their rows
// of the stage, as (group in the slice, value * weight, weight); a run of
// consecutive kept rows of one group (the norm on a table clustered on the
// group-by) is first summed by a segmented scan and kept as one row.  kAdders
// adder warps each own a private copy of the slice's sums and counts and
// add the kept rows of kFilters / kAdders filter warps, in row order, 32
// at a time: in place when no group repeats among the 32 (a byte tag per
// group finds repeats), else by add_run.
// Barriers a stage: "full" completes in each block when the tile's bytes
// have landed there; "listed" when the block's filter warps have compacted
// their rows; "empty" counts one arrival from each adder warp of
// all C blocks (remote arrivals), so no tile is copied into a stage that
// any block still reads.  No block-wide barrier runs per tile.  At the end the
// block adds its adders' copies in adder order and writes its slice of the
// chunk's partials.
//
// A bulk copy needs 16-byte aligned addresses and sizes, and a row of a
// (B, n) tensor, or a view of one, may start at any 4-byte boundary.  So
// each array's copy covers the 16-byte segments that hold the tile's rows,
// and the warps start reading it at the tile's offset in its first
// segment (0-3 rows, the same for every tile of a chunk).  The rows before
// and after the tile in those segments are read but never added; a 16-byte
// segment that holds one of the array's elements lies inside its
// allocation, so nothing outside it is read.
//
// Partials scale with the rows: a batch row gets `parts` chunks (the plan's,
// a function of n, n_groups and the card, never of the batch), the clusters
// of a chunk write its 2 * n_groups floats, and segagg_merge adds each
// output's partials in part order with kMergeUnroll loads in flight.
//
// What it reaches and what holds it back (PERF.md has the times, measured
// by kernels/segagg_probe.py and chip_smoke.py): every block of a cluster
// still examines every row of the chunk, so the filter warps do C times the
// rows' work (slices of 4,096 groups halve it against 2,048), and a stage
// is refilled only after the slowest adder warp of the cluster is done with
// it, so three stages of 1,024 rows cover little more than one round trip
// of filter, adds, release and copy.  The copies and barriers alone take
// about 60% of the kernel's time at n = 2^23, G = 16,384; a deeper ring
// needs the shared memory the adders' copies use.
// Registers (-Xptxas -v): about 50 a thread, no spills.
//
// Shared memory of segagg_sliced (kStages = 3, kTileRows = 1,024): the ring
// 37,008 bytes, 128 of barriers, 96 of the filter warps' counts, and per
// adder warp 9 bytes a group of the slice (sum, count, tag); at slice 2,048
// (G = 2,048) 74,096 bytes, at slice 4,096 (the most: G = 4,096, 16,384
// and every wider pad) 110,960 (2 blocks an SM).  Batch: blockIdx.y is the batch row, so a
// batched launch (segment_aggregate_batch.cu) computes each row exactly as a
// launch over that row alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMergeThreads = 256;
constexpr int kMergeUnroll = 8;

// segagg_private: 8 warps a block, each with kSteps runs of loads in flight.
constexpr int kPrivThreads = 256;
constexpr int kPrivWarps = kPrivThreads / 32;
constexpr int kSteps = 2;

// segagg_sliced.
constexpr int kTileRows = 1024;              // rows a ring stage holds
constexpr int kStages = 3;                   // ring stages
constexpr int kPrefetch = 8;                 // tiles asked of L2 ahead of the copy
constexpr int kStageWords = kTileRows + 4;   // words of one array in a stage
constexpr int kSliceMax = 4096;              // the most groups a block owns while C <= kClusterMax
constexpr int kClusterMax = 8;               // the portable cluster size
constexpr int kRingBytes = kStages * 3 * kStageWords * 4;
constexpr int kBarrierBytes = 128;           // 3 * kStages mbarriers of 8 bytes
constexpr int kFilters = 8;                  // filter warps a block
constexpr int kFilterRows = kTileRows / kFilters;  // rows a filter warp takes of a tile
constexpr int kCountBytes = kStages * kFilters * 4;  // the filter warps' kept rows
constexpr int kAdders = 2;                   // adder warps a block

static_assert((kStageWords * 4) % 16 == 0, "stage arrays start 16-byte aligned");
static_assert(3 * kStages * 8 <= kBarrierBytes, "the barriers fit their room");
static_assert(kFilterRows % 32 == 0, "every filter warp takes whole runs of 32 rows");

// Dynamic shared bytes of segagg_sliced with a slice of `slice` groups:
// the ring, the barriers, the filter warps' counts of kept rows, and each
// adder's sums, counts and byte tags.
constexpr size_t sliced_smem(int slice) {
  return (size_t)kRingBytes + kBarrierBytes + kCountBytes +
         (size_t)kAdders * ((size_t)8 * slice + ((slice + 15) & ~15));
}

// The slice of each block for n_groups in clusters of `cluster` blocks
// (the wrapper's slice_shape).
int slice_of(int n_groups, int cluster) {
  const int64_t even = ((int64_t)n_groups + cluster - 1) / cluster;
  return even < kSliceMax ? (int)even : kSliceMax;
}

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

// Three st.shared.b32 (a at pa, b at pb, c at pc) where p holds, with no
// branch around them.
__device__ __forceinline__ void st_shared3_if(bool p, const void* pa, uint32_t a, const void* pb,
                                              uint32_t b, const void* pc, uint32_t c) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %6, 0;\n"
      "@q st.shared.b32 [%0], %1;\n"
      "@q st.shared.b32 [%2], %3;\n"
      "@q st.shared.b32 [%4], %5;\n"
      "}\n" ::"r"(smem_u32(pa)),
      "r"(a), "r"(smem_u32(pb)), "r"(b), "r"(smem_u32(pc)), "r"(c), "r"((int)p)
      : "memory");
}

// One warp adds a run of 32 rows (lane l holds row k, p, w) into acc, each
// group's rows in lane order after what acc holds.
__device__ __forceinline__ void add_run(float* acc, int n_groups, int lane, int32_t k,
                                        float p, float w) {
  const unsigned peers = __match_any_sync(kFull, k);
  const bool lead = k >= 0 && __ffs(peers) - 1 == lane;
  const int most = (int)__reduce_max_sync(kFull, lead ? (unsigned)__popc(peers) : 0u);
  if (most == 1) {  // no group twice in the run: each leader adds its own row
    if (lead) {
      acc[k] += p;
      acc[n_groups + k] += w;
    }
    __syncwarp();
    return;
  }
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
  values += (int64_t)blockIdx.y * n;
  gid += (int64_t)blockIdx.y * n;
  weights += (int64_t)blockIdx.y * n;
  partials += (int64_t)blockIdx.y * gridDim.x * 2 * n_groups;
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

// add_run for a warp whose copy has a byte tag per group: when no two lanes
// hold the same group (each reads back its own lane from its group's tag),
// each adds its row in place, which is what add_run computes then; else
// add_run.  The sums are read beside the tags, so one round trip to shared
// memory serves both.
__device__ __forceinline__ void add_run_tagged(float* acc, uint8_t* tags, int n_groups,
                                               int lane, int32_t k, float p, float w) {
  float sum = 0.f, count = 0.f;
  if (k >= 0) {
    tags[k] = (uint8_t)lane;
    sum = acc[k];
    count = acc[n_groups + k];
  }
  __syncwarp();
  if (__any_sync(kFull, k >= 0 && tags[k] != lane)) {
    add_run(acc, n_groups, lane, k, p, w);
    return;
  }
  if (k >= 0) {
    acc[k] = sum + p;
    acc[n_groups + k] = count + w;
  }
  __syncwarp();
}

// Gridded as (parts * C, batch, windows) in clusters of C along x: cluster
// x of batch row y and window z sums the rows [x * part_rows, (x + 1) *
// part_rows) of that row for the groups of all its blocks, block c (its
// rank) the groups [(z * C + c) * slice, (z * C + c + 1) * slice), into
// partials[y][x][2 * n_groups].  Warps: kFilters filter warps, kAdders adder
// warps, one producer.
__global__ void __launch_bounds__((kFilters + kAdders + 1) * 32)
segagg_sliced(const float* __restrict__ values, const int32_t* __restrict__ gid,
              const float* __restrict__ weights, int64_t n, int n_groups, int slice,
              int64_t part_rows, float* __restrict__ partials) {
  constexpr int kLists = kFilters / kAdders;  // filter warps whose rows an adder adds
  constexpr int kRuns = kFilterRows / 32;     // runs of 32 rows a filter warp takes a tile
  extern __shared__ __align__(128) unsigned char shm[];
  float* ring = reinterpret_cast<float*>(shm);  // [stage][value, gid, weight][kStageWords]
  uint64_t* bars = reinterpret_cast<uint64_t*>(shm + kRingBytes);  // full, empty, listed
  int* counts = reinterpret_cast<int*>(shm + kRingBytes + kBarrierBytes);  // [stage][filter]
  float* accs = reinterpret_cast<float*>(shm + kRingBytes + kBarrierBytes + kCountBytes);
  const int tag_bytes = (slice + 15) & ~15;
  uint8_t* tag0 = reinterpret_cast<uint8_t*>(accs + (size_t)kAdders * 2 * slice);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t rank = cluster_rank();
  const uint32_t n_ctas = cluster_size();
  const int64_t part = cluster_id_x();
  const int64_t parts = gridDim.x / n_ctas;
  const int64_t row0 = (int64_t)blockIdx.y * n;
  partials += ((int64_t)blockIdx.y * parts + part) * 2 * n_groups;
  // This block's groups: [lo, lo + width).
  const int64_t lo64 = ((int64_t)blockIdx.z * n_ctas + rank) * slice;
  const int lo = (int)min(lo64, (int64_t)n_groups);
  const int width = max(0, min(slice, n_groups - lo));
  const int64_t r0 = min(n, part * part_rows);
  const int64_t rows_here = min(n, r0 + part_rows) - r0;
  const int n_tiles = (int)((rows_here + kTileRows - 1) / kTileRows);
  // The chunk's first row of each array.  Tiles lie 4 * kTileRows bytes
  // apart, so every tile of an array starts at the same offset (head, in
  // rows) in its first 16-byte segment.
  const char* src[3] = {reinterpret_cast<const char*>(values + row0 + r0),
                        reinterpret_cast<const char*>(gid + row0 + r0),
                        reinterpret_cast<const char*>(weights + row0 + r0)};
  int head[3];
  for (int a = 0; a < 3; ++a) head[a] = (int)(reinterpret_cast<uintptr_t>(src[a]) & 15) >> 2;

  const int n_acc = kAdders * 2 * slice;  // even; accs start 16-byte aligned
  for (int j = threadIdx.x; j < n_acc / 4; j += blockDim.x)
    reinterpret_cast<float4*>(accs)[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x < n_acc % 4) accs[n_acc / 4 * 4 + threadIdx.x] = 0.f;
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages),
                 listed0 = smem_u32(bars + 2 * kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, n_ctas * kAdders);
      mbar_init(listed0 + 8 * s, kFilters);
    }
    fence_barrier_init();
  }
  cluster_sync();  // every block's barriers are set before any copy or arrival

  if (warp == kFilters + kAdders) {
    // Producer, one lane: for every tile, once the stage's last tile has
    // landed here, arrive on this block's full barrier announcing the
    // tile's bytes; for every C-th tile (tile i is block i % C's), once
    // every adder warp of the cluster has released the stage, copy the tile
    // whole, multicast to the cluster, and ask L2 for the tile kPrefetch
    // ahead, so that copies find their rows in L2.
    if (lane == 0) {
      const uint16_t mask = (uint16_t)((1u << n_ctas) - 1);
      auto bytes = [&](int a, int i) -> uint32_t {
        const int rows = (int)min((int64_t)kTileRows, rows_here - (int64_t)i * kTileRows);
        return (uint32_t)(head[a] + rows + 3) / 4 * 16;
      };
      auto segment = [&](int a, int i) {
        return src[a] - 4 * head[a] + (int64_t)i * 4 * kTileRows;
      };
      auto prefetch = [&](int i) {
        for (int a = 0; a < 3; ++a) bulk_prefetch_l2(segment(a, i), bytes(a, i));
      };
      for (int i = kStages; i < min(n_tiles, kPrefetch); ++i)
        if (i % n_ctas == rank) prefetch(i);
      uint32_t turn = 0;  // i % n_ctas
      for (int i = 0; i < n_tiles; ++i, turn = turn + 1 == n_ctas ? 0 : turn + 1) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;  // of the stage's last round
        if (i >= kStages) mbar_wait(full0 + 8 * s, parity);
        mbar_expect_tx(full0 + 8 * s, bytes(0, i) + bytes(1, i) + bytes(2, i));
        if (turn != rank) continue;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, parity);
        for (int a = 0; a < 3; ++a) {
          const uint32_t dst = smem_u32(ring + (s * 3 + a) * kStageWords);
          if (n_ctas == 1) {
            bulk_load(dst, segment(a, i), bytes(a, i), full0 + 8 * s);
          } else {
            bulk_load_multicast(dst, segment(a, i), bytes(a, i), full0 + 8 * s, mask);
          }
        }
        if (i + kPrefetch < n_tiles) prefetch(i + kPrefetch);
      }
    }
    __syncwarp();
  } else if (warp < kFilters) {
    // Filter warp: kRuns runs of 32 rows of every tile.  With no branch,
    // each run finds its rows of the block's slice (a ballot) and their
    // places among the warp's kept rows (a popc rank), and the warp writes
    // them there, compacted in place at the head of its rows of the stage,
    // as (group in the slice, value * weight, weight); then it publishes how
    // many it kept.
    const unsigned below = (1u << lane) - 1;
    const int first = warp * kFilterRows;  // the warp's first row of a tile
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int rows = (int)min((int64_t)kTileRows, rows_here - (int64_t)i * kTileRows);
      float* sv = ring + (s * 3) * kStageWords + head[0] + first;
      int32_t* sg = reinterpret_cast<int32_t*>(ring + (s * 3 + 1) * kStageWords) + head[1] + first;
      float* sx = ring + (s * 3 + 2) * kStageWords + head[2] + first;
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      int32_t g[kRuns];
      float v[kRuns], w[kRuns];
#pragma unroll
      for (int u = 0; u < kRuns; ++u) {  // every row read before any is written
        g[u] = sg[u * 32 + lane];
        v[u] = sv[u * 32 + lane];
        w[u] = sx[u * 32 + lane];
      }
      int kept = 0;
#pragma unroll
      for (int u = 0; u < kRuns; ++u) {
        float p = v[u] * w[u], x = w[u];
        bool keep = first + u * 32 + lane < rows && (unsigned)(g[u] - lo) < (unsigned)width &&
                    !(x == 0.f && p == 0.f);
        unsigned m = __ballot_sync(kFull, keep);
        if (m == 0) continue;  // no row of the slice (weight-0 padding, say)
        // Consecutive kept rows of one group (a table clustered on the
        // group-by) are summed first, by a segmented scan in a fixed order,
        // and only each run's last row is kept.
        const int key = keep ? g[u] - lo : -1 - lane;
        const int before = __shfl_up_sync(kFull, key, 1);
        const unsigned heads = __ballot_sync(kFull, lane == 0 || before != key);
        if (heads != kFull) {
          const int head = 31 - __clz(heads & (kFull >> (31 - lane)));  // the run's first lane
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const float pu = __shfl_up_sync(kFull, p, d), xu = __shfl_up_sync(kFull, x, d);
            if (lane - d >= head) {
              p += pu;
              x += xu;
            }
          }
          keep = keep && (lane == 31 || ((heads >> (lane + 1)) & 1));
          m = __ballot_sync(kFull, keep);
        }
        const int at = kept + __popc(m & below);  // at most the row's own place
        st_shared3_if(keep, sg + at, (uint32_t)(g[u] - lo), sv + at, __float_as_uint(p), sx + at,
                      __float_as_uint(x));
        kept += __popc(m);
      }
      fence_proxy_async();  // before the stage's next bulk copy
      if (lane == 0) counts[s * kFilters + warp] = kept;
      __syncwarp();
      if (lane == 0) mbar_arrive(listed0 + 8 * s);
    }
  } else {
    // Adder warp: the kept rows of kLists filter warps of every tile, in row
    // order, 32 at a time, into the warp's private sums and counts of the
    // slice.
    const int a = warp - kFilters;
    float* acc = accs + (size_t)a * 2 * slice;
    uint8_t* tags = tag0 + a * tag_bytes;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const float* sv = ring + (s * 3) * kStageWords + head[0] + a * kLists * kFilterRows;
      const int32_t* sg = reinterpret_cast<const int32_t*>(ring + (s * 3 + 1) * kStageWords) +
                          head[1] + a * kLists * kFilterRows;
      const float* sx = ring + (s * 3 + 2) * kStageWords + head[2] + a * kLists * kFilterRows;
      mbar_wait(listed0 + 8 * s, (i / kStages) & 1);
      int start[kLists + 1];  // where each filter warp's rows begin among the adder's
      start[0] = 0;
#pragma unroll
      for (int t = 0; t < kLists; ++t)
        start[t + 1] = start[t] + counts[s * kFilters + a * kLists + t];
      for (int b = 0; b < start[kLists]; b += 32) {
        const int r = b + lane;
        int at = r;  // the row's place in the adder's rows of the stage
#pragma unroll
        for (int x = 1; x < kLists; ++x)
          if (r >= start[x]) at = r - start[x] + x * kFilterRows;
        const bool in = r < start[kLists];
        at = in ? at : 0;
        add_run_tagged(acc, tags, slice, lane, in ? sg[at] : -1, sv[at], sx[at]);
      }
      __syncwarp();  // the warp's reads of the stage are done
      if (lane < (int)n_ctas) mbar_arrive_cluster(empty0 + 8 * s, lane);
    }
  }

  __syncthreads();
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    float t = 0.f, c = 0.f;
#pragma unroll
    for (int w = 0; w < kAdders; ++w) {
      t += accs[(size_t)w * 2 * slice + j];
      c += accs[(size_t)w * 2 * slice + slice + j];
    }
    partials[lo + j] = t;
    partials[n_groups + lo + j] = c;
  }
  cluster_sync();  // no block leaves while another may still arrive on its barriers
}

// One thread per output: adds the parts' partials in part order, kMergeUnroll
// loads in flight.
__global__ void __launch_bounds__(kMergeThreads)
segagg_merge(const float* __restrict__ partials, int n_parts, int n_groups,
             float* __restrict__ sums, float* __restrict__ counts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * n_groups) return;
  const int64_t stride = 2 * (int64_t)n_groups;
  partials += (int64_t)blockIdx.y * n_parts * stride + j;
  sums += (int64_t)blockIdx.y * n_groups;
  counts += (int64_t)blockIdx.y * n_groups;
  float t = 0.f;
  int b = 0;
  for (; b + kMergeUnroll <= n_parts; b += kMergeUnroll) {
    float x[kMergeUnroll];
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) x[u] = partials[(b + u) * stride];
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) t += x[u];
  }
  for (; b < n_parts; ++b) t += partials[b * stride];
  if (j < n_groups) {
    sums[j] = t;
  } else {
    counts[j - n_groups] = t;
  }
}

cudaError_t sliced_config(int n_groups, int cluster, size_t smem, int parts, int batch,
                          cudaStream_t s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (n_groups < 1 || cluster < 1 || cluster > kClusterMax) return cudaErrorInvalidValue;
  const int slice = slice_of(n_groups, cluster);
  const int64_t window = (int64_t)cluster * slice;
  const int64_t windows = (n_groups + window - 1) / window;
  if (windows > 65535 || smem != sliced_smem(slice)) return cudaErrorInvalidValue;
  static size_t set_smem[64] = {};  // per device: the bytes already allowed
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || set_smem[device] < smem) {
    err = cudaFuncSetAttribute(segagg_sliced, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (device < 64) set_smem[device] = smem;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(parts * cluster, batch, (unsigned)windows);
  cfg.blockDim = dim3((kFilters + kAdders + 1) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// batch rows of n rows each; scratch holds batch * parts * 2 * n_groups
// floats.  cluster == 0: segagg_private with `parts` blocks a row; else
// segagg_sliced in clusters of `cluster` blocks with `smem` dynamic shared
// bytes (the wrapper's plan; a mismatch with sliced_smem is refused), one
// cluster per chunk of part_rows rows and window of groups.  Returns
// cudaGetLastError() after both launches (0 on success).
int segagg_run(int device, void* stream, const float* values, const int32_t* gid,
               const float* weights, long long n, int batch, int n_groups, float* sums,
               float* counts, float* scratch, int parts, long long part_rows, int cluster,
               long long smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster == 0) {
    const size_t bytes = (size_t)kPrivWarps * 2 * n_groups * sizeof(float);
    err = cudaFuncSetAttribute(segagg_private, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    segagg_private<<<dim3(parts, batch), kPrivThreads, bytes, s>>>(values, gid, weights, n,
                                                                   n_groups, scratch);
  } else {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = sliced_config(n_groups, cluster, (size_t)smem, parts, batch, s, cfg, attr);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, segagg_sliced, values, gid, weights, (int64_t)n, n_groups,
                               slice_of(n_groups, cluster), (int64_t)part_rows, scratch);
  }
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outs = 2 * n_groups;
  segagg_merge<<<dim3((outs + kMergeThreads - 1) / kMergeThreads, batch), kMergeThreads, 0,
                 s>>>(scratch, parts, n_groups, sums, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// One segment problem of n rows (see segagg_run).
extern "C" int segagg_launch(int device, void* stream, const float* values,
                             const int32_t* gid, const float* weights, long long n,
                             int n_groups, float* sums, float* counts, float* scratch,
                             int parts, long long part_rows, int cluster, long long smem) {
  return segagg_run(device, stream, values, gid, weights, n, 1, n_groups, sums, counts,
                    scratch, parts, part_rows, cluster, smem);
}

// How many clusters of segagg_sliced's shape can be resident on the device
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int segagg_max_clusters(int device, int n_groups, int cluster, long long smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = sliced_config(n_groups, cluster, (size_t)smem, 1, 1, 0, cfg, attr);
  cfg.gridDim.z = 1;  // one window: the clusters of one shape, whatever the width
  int count = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&count, segagg_sliced, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}
