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
// Few groups (segagg_private, up to kPrivateGroups = 1,024): one launch a
// call.  Every warp keeps copies of the sums and counts in shared memory
// (copies_of: one a lane up to 16 groups, at most 512 groups' worth
// together above: 4 at 128 groups, 1 from 512) and takes steps of 128
// consecutive rows, 4 a lane as one 16-byte load of each array (4-byte
// loads where a row of the input does not start on a 16-byte boundary: the
// same rows a lane, so the same order of additions), the next kAhead
// steps' loads in flight while a warp adds one.  A lane first sums its
// consecutive rows of one group in row order; a segmented scan over the
// lanes joins runs that cross lanes, so a step of one group (a table
// clustered on the group-by) costs one add, and rows that add nothing do
// not break a run (warp_step).  The runs left
// are added into the lane's copy: directly where a lane has its own, else
// through a byte tag a slot (in place when no two lanes of a copy hold one
// group, else add_run, as segagg_sliced's adders do).  The block adds its
// warps' copies in a fixed order; clusters of kPrivCluster blocks add
// their blocks' sums through distributed shared memory into one partial
// set a cluster; the cluster that finishes a row last (an atomic ticket in
// a workspace the kernel leaves zero) adds the row's partial sets, each
// output by up to a warp of threads in a fixed tree.  The grid is at most
// the clusters that fit on the card at once, and gives each warp at least
// kMinSteps steps of a row.
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
// Partials of segagg_sliced scale with the rows: a batch row gets `parts`
// chunks (the plan's, a function of n, n_groups and the card, never of the
// batch), the clusters of a chunk write its 2 * n_groups floats, and
// segagg_merge adds each output's partials in part order with kMergeUnroll
// loads in flight.
//
// segagg_private on an H100 80GB HBM3 at 700 W (PERF.md,
// kernels/segagg_probe.py --few; n = 2^23, half the weights zero, device
// time, L2 warm): 0.048 ms at G = 16 and 0.057-0.066 at G = 128-1,024 on
// random gids, 0.045-0.051 on sorted ones (the kernel it replaced:
// 0.071-0.088 and 0.126-0.138), against a 0.025 bound.  The loads alone
// take 0.034-0.040 (all 12 bytes a row, where the bound counts the values
// of weighted rows only); the adds of random rows are issue-bound, about
// 250 warp instructions a step, and do not hide under the loads (loading
// one to three steps ahead did not change it); the two merges 0.004-0.007.
// A copy a lane takes a third to a half less time than one copy a warp at
// G = 16; byte tags 10-18% less than add_run's match from G = 128.
// Registers (-Xptxas -v): 48-56 a thread, no spills.
//
// segagg_sliced: what it reaches and what holds it back (PERF.md has the
// times, measured by kernels/segagg_probe.py and chip_smoke.py): every block of a cluster
// still examines every row of the chunk, so the filter warps do C times the
// rows' work (slices of 4,096 groups halve it against 2,048), and a stage
// is refilled only after the slowest adder warp of the cluster is done with
// it, so three stages of 1,024 rows cover little more than one round trip
// of filter, adds, release and copy.  The copies and barriers alone take
// about 60% of the kernel's time at n = 2^23, G = 16,384; a deeper ring
// needs the shared memory the adders' copies use.
// Registers (-Xptxas -v): 40 a thread, no spills.
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
constexpr int kFinalUnroll = 16;  // segagg_private's last cluster: partial sets loaded at once

// segagg_private: clusters of kPrivCluster blocks of 8 warps, each warp
// taking steps of kStepRows rows (4 a lane), the next kAhead steps' loads in
// flight while it adds one, into copies_of(n_groups) copies of the sums a
// warp.
constexpr int kPrivThreads = 256;
constexpr int kPrivWarps = kPrivThreads / 32;
constexpr int kPrivMinBlocks = 4;  // blocks an SM the registers must allow
constexpr int kAhead = 1;  // steps a warp has loaded ahead of the one it adds
constexpr int kStepRows = 128;
constexpr int kPrivCluster = 8;
constexpr int kClusterThreads = kPrivCluster * kPrivThreads;
constexpr int kCopyGroups = 512;  // a warp's copies hold at most this many groups together
constexpr int kPrivateGroups = 1024;  // the most groups segagg_private takes
constexpr int kOutSlots = 2 * kPrivateGroups / kPrivThreads;  // outputs a thread sums, at most
constexpr int kMinSteps = 8;  // steps of a row each warp takes, at least, where rows allow

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

// Copies of the sums and counts a warp of segagg_private keeps: 32 (one a
// lane, up to 16 groups), else the most (a power of two) that hold at most
// kCopyGroups groups together; the 32 / copies lanes of a copy are
// consecutive.  Copies cut the lanes that add to one group at once.
__host__ __device__ constexpr int copies_of(int n_groups) {
  int c = 1;
  while (c < 32 && 2 * c * n_groups <= kCopyGroups) c *= 2;
  return c;
}

// Dynamic shared bytes of segagg_private: each warp's copies, and unless a
// lane has a copy of its own a byte tag a group and copy.
constexpr size_t private_smem(int n_groups) {
  const int gc = n_groups * copies_of(n_groups);
  return (size_t)kPrivWarps * ((size_t)8 * gc + (copies_of(n_groups) < 32 ? ((gc + 15) & ~15) : 0));
}

// Rows 4q .. 4q + 3 of a row of the input, as loaded.
struct Quad {
  int4 g;
  float4 v, w;
};

// kAligned: the row starts on a 16-byte boundary, so each array's four rows
// are one 16-byte load (the last quad's segment may pass the row's end; a
// 16-byte segment holding one of the array's elements lies inside its
// allocation, and the gids read past the end are set to -1).  Else four
// 4-byte loads each.  Quads at or past the row's end load nothing (gids -1).
template <bool kAligned>
__device__ __forceinline__ Quad load_quad(const float* __restrict__ values,
                                          const int32_t* __restrict__ gid,
                                          const float* __restrict__ weights, int64_t q,
                                          int64_t n) {
  Quad r;
  r.g = make_int4(-1, -1, -1, -1);
  r.v = r.w = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t i = 4 * q;
  if (i >= n) return r;
  if (kAligned) {
    r.g = __ldg(reinterpret_cast<const int4*>(gid + i));
    r.v = __ldg(reinterpret_cast<const float4*>(values + i));
    r.w = __ldg(reinterpret_cast<const float4*>(weights + i));
    if (i + 4 > n) {
      if (i + 1 >= n) r.g.y = -1;
      if (i + 2 >= n) r.g.z = -1;
      r.g.w = -1;
    }
  } else {
    int* g = &r.g.x;
    float* v = &r.v.x;
    float* w = &r.w.x;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < n) {
        g[j] = __ldg(gid + i + j);
        v[j] = __ldg(values + i + j);
        w[j] = __ldg(weights + i + j);
      }
  }
  return r;
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

// One round of adds: each lane's run (at slot k of its copy, or -1 for
// none) into the warp's copies, whose sums are gc floats and counts gc
// more; a slot's runs in lane order.  lanes: a copy a lane, no two lanes
// share a slot.
__device__ __forceinline__ void add_round(float* acc, uint8_t* tags, int gc, int lane, bool lanes,
                                          int32_t k, float p, float w) {
  if (lanes) {
    if (k >= 0) {
      acc[k] += p;
      acc[gc + k] += w;
    }
    return;
  }
  if (!__any_sync(kFull, k >= 0)) return;
  add_run_tagged(acc, tags, gc, lane, k, p, w);
}

// One warp adds a step of 128 consecutive rows, lane l holding rows 4l ..
// 4l + 3 (k = -1 where a row adds nothing), into its copy.  Rows that add
// nothing are passed over, so they do not break a run.
//  - Each lane sums its rows in row order into runs of one group: its head
//    run, its tail run (the same when the lane holds one group: "single"),
//    and any between.
//  - A segmented scan over the lanes (in a fixed tree order) joins each
//    lane's tail run with the single lanes after it that continue its
//    group, and lanes with no row pass it on: lane l's sp, sx is the open
//    run of the step's rows up to its own, whose group is its last live
//    row's.  Where no lane with rows continues a run (random gids, mostly)
//    that is each live lane's own tail run, and the scan is skipped: adding
//    +0.0 for the lanes without rows changes no bit of the sums.
//  - Lane l takes the open run of the lanes before it (lane l - 1's scan)
//    and walks its rows: a run closes where a row of another group
//    follows, and is added then, in one of four rounds (a round for each
//    row a lane holds; add_run orders each group's runs by lane).  Lane 31
//    adds the step's last open run.
// A run of one group over the whole step (a table clustered on the
// group-by) is one add.  Group g of the lane's copy is slot g * copies +
// copy (the copies interleaved, so a copy a lane has no bank conflicts).
__device__ __forceinline__ void warp_step(float* acc, uint8_t* tags, int gc, int copies,
                                          int copy, int lane, const int32_t (&k)[4],
                                          const float (&p)[4], const float (&x)[4]) {
  int32_t hk = -1, tk = -1;
  bool single = true;
  float tp = 0.f, tx = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (k[j] < 0) continue;
    if (hk < 0) hk = k[j];
    if (tk >= 0 && k[j] != tk) {
      single = false;
      tp = tx = 0.f;
    }
    tp += p[j];
    tx += x[j];
    tk = k[j];
  }
  const unsigned live = __ballot_sync(kFull, hk >= 0);
  if (live == 0) return;
  const unsigned before = live & ((1u << lane) - 1);
  const int last_live = before ? 31 - __clz(before) : 0;  // the last lane before with rows
  const int32_t prev = __shfl_sync(kFull, tk, last_live);
  const int32_t in_key = before ? prev : -1;  // the open run's group as the lane begins
  const bool joins = lane > 0 && (hk < 0 || (single && hk == in_key));
  float cp, cx;  // the open run as the lane begins
  if (__ballot_sync(kFull, hk >= 0 && joins) == 0) {
    // No lane with rows continues a run from the lanes before it (the norm
    // on random gids): each open run is the last live lane's tail run.
    cp = __shfl_sync(kFull, tp, last_live);
    cx = __shfl_sync(kFull, tx, last_live);
  } else {
    const unsigned heads = __ballot_sync(kFull, !joins);
    const int head = 31 - __clz(heads & (kFull >> (31 - lane)));
    float sp = tp, sx = tx;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float pu = __shfl_up_sync(kFull, sp, d), xu = __shfl_up_sync(kFull, sx, d);
      if (lane - d >= head) {
        sp += pu;
        sx += xu;
      }
    }
    cp = __shfl_up_sync(kFull, sp, 1);
    cx = __shfl_up_sync(kFull, sx, 1);
  }
  int32_t ck = in_key;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool closes = k[j] >= 0 && ck >= 0 && ck != k[j];
    const int32_t ek = closes ? ck : -1;
    const float ep = cp, ex = cx;
    if (k[j] >= 0) {
      if (ck == k[j]) {
        cp += p[j];
        cx += x[j];
      } else {
        ck = k[j];
        cp = p[j];
        cx = x[j];
      }
    }
    add_round(acc, tags, gc, lane, copies == 32, ek >= 0 ? ek * copies + copy : -1, ep, ex);
  }
  if (lane == 31 && ck >= 0) {
    acc[ck * copies + copy] += cp;
    acc[gc + ck * copies + copy] += cx;
  }
  __syncwarp();
}

// Gridded as (parts, batch) in clusters of kPrivCluster along x: block x of
// batch row y takes the row's steps x * kPrivWarps + warp + t * (parts *
// kPrivWarps) in order, each warp into its own copies of the
// sums and counts in shared memory.  Then the block adds its warps' copies,
// each output's in (warp, copy) order by a group of threads (a fixed
// tree, as below); the cluster adds its blocks' in rank order through
// distributed shared memory, block r the outputs r * kPrivThreads + t
// (stepping by the cluster's threads), into the cluster's partials of the
// row; and the cluster that finishes a row last (a ticket per row) adds the
// row's parts / kPrivCluster partials into sums and counts: each output by
// a group of tpo threads (as many as the cluster's threads allow, up to a
// warp), thread i adding the partials i, i + tpo, ... in order, then a
// butterfly over the group.  It sets the row's ticket back to 0.
// kCopies: copies_of(n_groups), fixed at compile time (0: read at run time).
template <bool kAligned, int kCopies>
__global__ void __launch_bounds__(kPrivThreads, kPrivMinBlocks)
segagg_private(const float* __restrict__ values, const int32_t* __restrict__ gid,
               const float* __restrict__ weights, int64_t n, int n_groups,
               float* __restrict__ partials, unsigned* __restrict__ tickets,
               float* __restrict__ sums, float* __restrict__ counts) {
  extern __shared__ __align__(16) float smem[];  // each warp's copies, then the tags
  __shared__ uint32_t s_last;
  const int row = blockIdx.y;
  values += (int64_t)row * n;
  gid += (int64_t)row * n;
  weights += (int64_t)row * n;
  const int copy = 2 * n_groups;  // outputs
  const int copies = kCopies ? kCopies : copies_of(n_groups);
  const int gc = n_groups * copies;
  for (int j = threadIdx.x; j < kPrivWarps * 2 * gc; j += kPrivThreads) smem[j] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* acc = smem + warp * 2 * gc;
  uint8_t* tags = reinterpret_cast<uint8_t*>(smem + kPrivWarps * 2 * gc) + warp * ((gc + 15) & ~15);
  const int my_copy = lane / (32 / copies);
  const int64_t n_steps = (n + kStepRows - 1) / kStepRows;
  const int64_t stride = (int64_t)gridDim.x * kPrivWarps;
  // The warp's steps s0, s0 + stride, ... in order; kAhead steps' loads in
  // flight while a step is added.
  const int64_t s0 = (int64_t)blockIdx.x * kPrivWarps + warp;
  Quad ahead[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    ahead[u] = load_quad<kAligned>(values, gid, weights, (s0 + u * stride) * 32 + lane, n);
  for (int64_t s = s0; s < n_steps; s += stride) {
    const Quad in = ahead[0];
#pragma unroll
    for (int u = 0; u + 1 < kAhead; ++u) ahead[u] = ahead[u + 1];
    ahead[kAhead - 1] =
        load_quad<kAligned>(values, gid, weights, (s + kAhead * stride) * 32 + lane, n);
    const int g[4] = {in.g.x, in.g.y, in.g.z, in.g.w};
    const float v[4] = {in.v.x, in.v.y, in.v.z, in.v.w};
    const float w[4] = {in.w.x, in.w.y, in.w.z, in.w.w};
    int32_t k[4];
    float p[4], x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = v[j] * w[j];
      x[j] = w[j];
      k[j] = (unsigned)g[j] < (unsigned)n_groups && !(x[j] == 0.f && p[j] == 0.f) ? g[j] : -1;
    }
    warp_step(acc, tags, gc, copies, my_copy, lane, k, p, x);
  }
  __syncthreads();
  // The block's sums: output j of copy c of warp w is smem[w * 2 * gc + j *
  // copies + c]; a group of tb threads (a power of two, at most a warp) adds
  // each output's, thread i the values i, i + tb, ... in (warp, copy) order,
  // then a butterfly.  They go to smem[j] once every thread has read.
  int tb = 1;
  while (tb < 32 && tb * 2 * copy <= kPrivThreads) tb *= 2;
  const int values_a_output = kPrivWarps * copies;
  float res[kOutSlots];
#pragma unroll
  for (int i = 0; i < kOutSlots; ++i) {
    const int j = warp * (32 / tb) + i * (kPrivThreads / tb) + lane / tb;
    float t = 0.f;
    if (j - lane / tb < copy) {  // the warp's first output: uniform across the warp
      if (j < copy)
        for (int v = lane % tb; v < values_a_output; v += tb)
          t += smem[(v / copies) * 2 * gc + j * copies + v % copies];
      for (int d = tb / 2; d > 0; d >>= 1) t += __shfl_xor_sync(kFull, t, d);
    }
    res[i] = t;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kOutSlots; ++i) {
    const int j = warp * (32 / tb) + i * (kPrivThreads / tb) + lane / tb;
    if (j < copy && lane % tb == 0) smem[j] = res[i];
  }
  cluster_sync();  // every block's smem[0, copy) holds its sums
  const uint32_t rank = cluster_rank();
  const int n_parts = gridDim.x / kPrivCluster;
  const int64_t rows_parts = (int64_t)row * n_parts;
  float* mine = partials + (rows_parts + cluster_id_x()) * copy;
  for (int j = rank * kPrivThreads + threadIdx.x; j < copy; j += kClusterThreads) {
    float t = __uint_as_float(ld_shared_cluster(smem + j, 0));
#pragma unroll
    for (uint32_t r = 1; r < kPrivCluster; ++r)
      t += __uint_as_float(ld_shared_cluster(smem + j, r));
    mine[j] = t;
  }
  __threadfence();  // the partials before the ticket
  cluster_sync();   // every block's partials written; no remote reads of copy 0 after this
  if (rank == 0 && threadIdx.x == 0) {
    const uint32_t last = atomicAdd(&tickets[row], 1u) == (unsigned)n_parts - 1;
    for (uint32_t r = 0; r < kPrivCluster; ++r) st_shared_cluster(&s_last, r, last);
  }
  cluster_sync();
  if (!s_last) return;
  __threadfence();
  int tpo = 1;  // threads an output
  while (tpo < 32 && tpo * 2 * copy <= kClusterThreads) tpo *= 2;
  const int u = rank * kPrivThreads + threadIdx.x;
  const int sub = lane % tpo;
  const float* src = partials + rows_parts * copy;
  for (int base = u / 32 * (32 / tpo); base < copy; base += kClusterThreads / tpo) {
    const int j = base + lane / tpo;
    float t = 0.f;
    if (j < copy) {
      int c = sub;
      for (; c + (kFinalUnroll - 1) * tpo < n_parts; c += kFinalUnroll * tpo) {
        float x[kFinalUnroll];
#pragma unroll
        for (int e = 0; e < kFinalUnroll; ++e) x[e] = __ldcg(src + (int64_t)(c + e * tpo) * copy + j);
#pragma unroll
        for (int e = 0; e < kFinalUnroll; ++e) t += x[e];
      }
      for (; c < n_parts; c += tpo) t += __ldcg(src + (int64_t)c * copy + j);
    }
    for (int d = tpo / 2; d > 0; d >>= 1) t += __shfl_xor_sync(kFull, t, d);
    if (j < copy && sub == 0) {
      if (j < n_groups) {
        sums[(int64_t)row * n_groups + j] = t;
      } else {
        counts[(int64_t)row * n_groups + j - n_groups] = t;
      }
    }
  }
  if (rank == 0 && threadIdx.x == 0) tickets[row] = 0;
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

using PrivateKernel = void (*)(const float*, const int32_t*, const float*, int64_t, int, float*,
                              unsigned*, float*, float*);

// The instance for n_groups: rows 16-byte aligned with its copies fixed at
// compile time (index 0-5), else 4-byte loads and copies read at run time
// (index 6); the same order of additions either way.
PrivateKernel private_kernel(bool aligned, int n_groups, int& index) {
  if (!aligned) {
    index = 6;
    return segagg_private<false, 0>;
  }
  switch (copies_of(n_groups)) {
    case 32: index = 5; return segagg_private<true, 32>;
    case 16: index = 4; return segagg_private<true, 16>;
    case 8: index = 3; return segagg_private<true, 8>;
    case 4: index = 2; return segagg_private<true, 4>;
    case 2: index = 1; return segagg_private<true, 2>;
    default: index = 0; return segagg_private<true, 1>;
  }
}

// The launch of segagg_private: `parts` blocks a row (whole clusters) and
// the plan's shared bytes (refused unless private_smem).  The kernel's
// shared-memory allowance is set once per device and instance.
cudaError_t private_config(int n_groups, bool aligned, size_t smem, int parts, int batch,
                           cudaStream_t s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           PrivateKernel& fn) {
  if (n_groups < 1 || n_groups > kPrivateGroups || smem != private_smem(n_groups) ||
      parts < kPrivCluster || parts % kPrivCluster != 0)
    return cudaErrorInvalidValue;
  int which = 0;
  fn = private_kernel(aligned, n_groups, which);
  static size_t set_smem[64][7] = {};  // per device and instance: the bytes already allowed
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || set_smem[device][which] < smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (device < 64) set_smem[device][which] = smem;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(parts, batch);
  cfg.blockDim = dim3(kPrivThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kPrivCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// batch rows of n rows each.  cluster == 0: segagg_private, `parts` blocks
// a row in clusters of kPrivCluster, scratch holding batch * parts /
// kPrivCluster * 2 * n_groups floats and tickets `batch` zeros (left zero),
// one launch.  Else segagg_sliced in clusters of `cluster` blocks with
// `smem` dynamic shared bytes (the wrapper's plan; a mismatch with
// sliced_smem is refused), one cluster per chunk of part_rows rows and
// window of groups, scratch holding batch * parts * 2 * n_groups floats,
// then segagg_merge.  Returns cudaGetLastError() after the launches (0 on
// success).
int segagg_run(int device, void* stream, const float* values, const int32_t* gid,
               const float* weights, long long n, int batch, int n_groups, float* sums,
               float* counts, float* scratch, unsigned* tickets, int parts, long long part_rows,
               int cluster, long long smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cluster == 0) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(values) | reinterpret_cast<uintptr_t>(gid) |
                           reinterpret_cast<uintptr_t>(weights)) & 15) == 0 &&
                         (batch == 1 || n % 4 == 0);
    PrivateKernel fn;
    err = private_config(n_groups, aligned, (size_t)smem, parts, batch, s, cfg, attr, fn);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, fn, values, gid, weights, (int64_t)n, n_groups, scratch,
                               tickets, sums, counts);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  err = sliced_config(n_groups, cluster, (size_t)smem, parts, batch, s, cfg, attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, segagg_sliced, values, gid, weights, (int64_t)n, n_groups,
                             slice_of(n_groups, cluster), (int64_t)part_rows, scratch);
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
                             unsigned* tickets, int parts, long long part_rows, int cluster,
                             long long smem) {
  return segagg_run(device, stream, values, gid, weights, n, 1, n_groups, sums, counts,
                    scratch, tickets, parts, part_rows, cluster, smem);
}

// How many clusters can be resident on the device at once
// (cudaOccupancyMaxActiveClusters): of segagg_private for n_groups when
// cluster == 0 (smem its private_smem), else of segagg_sliced's shape; or
// minus a CUDA error code.
extern "C" int segagg_max_clusters(int device, int n_groups, int cluster, long long smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int count = 0;
  if (cluster == 0) {
    PrivateKernel fn;
    err = private_config(n_groups, true, (size_t)smem, kPrivCluster, 1, 0, cfg, attr, fn);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  } else {
    err = sliced_config(n_groups, cluster, (size_t)smem, 1, 1, 0, cfg, attr);
    cfg.gridDim.z = 1;  // one window: the clusters of one shape, whatever the width
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&count, segagg_sliced, &cfg);
  }
  return err == cudaSuccess ? count : -(int)err;
}
