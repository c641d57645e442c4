// Sketch application on Hopper (sm_90a): the row keep-mask of a sketch and,
// in the same pass, the kept rows' indices in ascending order.
//
// Replaces repro/kernels/sketch_filter.py::sketch_filter_pallas
// (Pallas body _filter_kernel):
//   keep[i] = bits[bucket[i]]
// and the caller's compaction of it (np.nonzero(keep) in
// repro/core/sketch.py::_build_instance):
//   rows = the i with keep[i], ascending; k = their count.
// Rows whose bucket lies outside [0, n_ranges) are not kept.
//
// Bound on an H100: memory bandwidth.  The mask alone reads 4 bytes (i32
// bucket) and writes 1 (u8 keep flag) a row: at n = 8,388,608 rows ~42 MB,
// ~12.5 us at 3.35 TB/s.  With the rows, each kept row writes 8 more (i64).
//
// Design: the TPU has no fast gather, so its kernel contracts a one-hot
// (rows x ranges) matrix against the bitmap.  Hopper gathers well from
// shared memory: each block packs the n_ranges flags into bits of shared
// words once (at most 16 KB), then takes tiles of kTile = 4,096 rows, 16 a
// thread: four 16-byte loads of buckets (read-only path), one 16-byte store
// of keep flags.
//
// The rows come from an ordered stream compaction in the same launch, by
// decoupled look-back: within a tile, each thread counts its kept rows and
// a warp scan and a scan of the warps' totals give each its offset; the
// kept rows' tile offsets are gathered in shared memory and written out
// contiguously.  Across tiles, each tile publishes its count, then its
// inclusive prefix, in a status word of a global workspace; the tile's
// first warp reads its 32 nearest predecessors at once and sums back to the
// nearest published prefix.  Tiles are numbered by an atomic ticket in the
// order blocks take them (a block takes its next ticket while it works on
// its current tile), so a tile waits only on tiles that running blocks
// hold: the look-back cannot deadlock, and the grid is persistent (each
// block stages the flags once).  Every row lands at its prefix position:
// the result does not depend on timing.
//
// Measured on the H100 (kernels/filter_probe.py, PERF.md): release/acquire
// orderings of the status words cost 12-26% (a word carries all a tile
// needs, so relaxed .gpu-scope accesses suffice); reading 4 or 16 words a
// lane, or the whole block's 256 a step, to shorten the first wave's walk
// back cost more in registers (blocks an SM) than the walk.
//
// The workspace (kept by the wrapper per device and stream) holds two
// tickets, the count k and two arrays of status words; a call uses the pair
// of its parity and clears the other pair, which the call before it used,
// so consecutive calls on a stream never see stale status.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kMaxRanges = 1 << 17;
constexpr int kRowsSmem = kTile * 2;  // u16 tile offsets of the kept rows
constexpr int kMaxSmem = kRowsSmem + kMaxRanges / 8;
constexpr int kHeadWords = 4;  // tickets[2], count, spare
// Blocks of the compaction an SM: 8 fill it (2,048 threads) when a thread
// keeps to 32 registers; fewer leave latency the tiles' chains cannot hide.
constexpr int kMinBlocks = 8;
// Status words: value << 2 | flag; 0 is "not yet published".
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

// A status word is read and written whole and carries all a tile needs
// (no other data passes between tiles), so relaxed .gpu-scope accesses
// suffice: release and acquire would only add their fences.
__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The flags of bits[0, n_ranges) packed 32 to a shared word, by warps.
__device__ __forceinline__ void stage_bits(const uint8_t* __restrict__ bits, int n_ranges,
                                           uint32_t* s_bits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w * 32 < n_ranges; w += kWarps) {
    const int r = w * 32 + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, r < n_ranges && bits[r] != 0);
    if (lane == 0) s_bits[w] = word;
  }
}

__device__ __forceinline__ uint32_t flag(const uint32_t* s_bits, int b, int n_ranges) {
  return (unsigned)b < (unsigned)n_ranges ? (s_bits[b >> 5] >> (b & 31)) & 1u : 0u;
}

// Four flags (bits 0-3 of m) as four bytes of 0 or 1.
__device__ __forceinline__ uint32_t bytes_of(uint32_t m) {
  return (m & 1u) | ((m & 2u) << 7) | ((m & 4u) << 14) | ((m & 8u) << 21);
}

// The 16 keep flags of rows [base, base + 16) as bits of the result; also
// stores them to keep.  Rows at or past n are not kept and not stored.
__device__ __forceinline__ uint32_t filter16(const int32_t* __restrict__ bucket,
                                             const uint32_t* s_bits, int64_t base, int64_t n,
                                             int n_ranges, uint8_t* __restrict__ keep) {
  uint32_t m = 0;
  if (base + kRowsPerThread <= n) {
    const int4* src = reinterpret_cast<const int4*>(bucket + base);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = __ldg(src + q);
      m |= (flag(s_bits, v.x, n_ranges) | flag(s_bits, v.y, n_ranges) << 1 |
            flag(s_bits, v.z, n_ranges) << 2 | flag(s_bits, v.w, n_ranges) << 3)
           << (4 * q);
    }
    *reinterpret_cast<uint4*>(keep + base) =
        make_uint4(bytes_of(m), bytes_of(m >> 4), bytes_of(m >> 8), bytes_of(m >> 12));
  } else {
    for (int j = 0; j < kRowsPerThread && base + j < n; ++j) {
      const uint32_t f = flag(s_bits, bucket[base + j], n_ranges);
      keep[base + j] = (uint8_t)f;
      m |= f << j;
    }
  }
  return m;
}

// The mask alone: a grid-stride loop over tiles.
__global__ void __launch_bounds__(kThreads)
filter_kernel(const int32_t* __restrict__ bucket, const uint8_t* __restrict__ bits, int64_t n,
              int n_ranges, uint8_t* __restrict__ keep) {
  extern __shared__ uint32_t s_bits[];
  stage_bits(bits, n_ranges, s_bits);
  __syncthreads();
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
    filter16(bucket, s_bits, tile * kTile + threadIdx.x * kRowsPerThread, n, n_ranges, keep);
}

// The mask and the kept rows: persistent blocks taking tiles by ticket.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
filter_rows_kernel(const int32_t* __restrict__ bucket, const uint8_t* __restrict__ bits,
                   int64_t n, int n_ranges, uint8_t* __restrict__ keep,
                   int64_t* __restrict__ rows, unsigned long long* __restrict__ ws,
                   int64_t cap, int parity, int64_t prev_tiles) {
  extern __shared__ uint32_t smem[];
  uint16_t* s_rows = reinterpret_cast<uint16_t*>(smem);
  uint32_t* s_bits = smem + kRowsSmem / 4;
  __shared__ int s_warp[kWarps];
  __shared__ unsigned long long s_tile, s_prefix;

  unsigned long long* ticket = ws + parity;
  unsigned long long* status = ws + kHeadWords + parity * cap;
  // Clear what the previous call left in the other pair.
  unsigned long long* other = ws + kHeadWords + (1 - parity) * cap;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < prev_tiles;
       i += (int64_t)gridDim.x * kThreads)
    other[i] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) ws[1 - parity] = 0;

  stage_bits(bits, n_ranges, s_bits);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long n_tiles = (unsigned long long)((n + kTile - 1) / kTile);
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1ull);
  for (;;) {
    __syncthreads();  // also orders the staged flags and the last tile's reads of shared memory
    const unsigned long long tile = s_tile;
    if (tile >= n_tiles) break;
    // The next tile's ticket, taken now: its atomic's round trip overlaps
    // this tile (the value is first used at the end).  A tile is published
    // (its count) before its block waits on anything, so holding a ticket
    // ahead cannot stall the look-back of another tile for good.
    unsigned long long next = 0;
    if (threadIdx.x == 0) next = atomicAdd(ticket, 1ull);
    const int local = threadIdx.x * kRowsPerThread;
    const uint32_t m =
        filter16(bucket, s_bits, (int64_t)tile * kTile + local, n, n_ranges, keep);

    // Offsets within the tile: a warp scan of the threads' counts; every
    // warp then scans the warps' totals itself.
    const int cnt = __popc(m);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      total += c;
    }
    // The kept rows' tile offsets, in row order, gathered in shared memory.
    int pos = before + incl - cnt;
    for (uint32_t r = m; r; r &= r - 1) s_rows[pos++] = (uint16_t)(local + __ffs(r) - 1);

    if (warp == 0) {
      // Publish the count, then look back: lane l reads the status of tile
      // look - l, waits until each of the 32 has published, and the nearest
      // published prefix ends the walk (everything nearer adds its count).
      unsigned long long prefix = 0;
      if (lane == 0)
        st_status(&status[tile],
                  (unsigned long long)total << 2 | (tile == 0 ? kPrefix : kAggregate));
      for (long long look = (long long)tile - 1; look >= 0; look -= 32) {
        const long long t = look - lane;
        unsigned long long s = t >= 0 ? ld_status(&status[t]) : kPrefix;
        // Every earlier tile is held by a running block: wait for its count.
        while (__any_sync(0xffffffffu, (s & 3) == 0)) {
          if ((s & 3) == 0) s = ld_status(&status[t]);
        }
        const uint32_t pref = __ballot_sync(0xffffffffu, (s & 3) == kPrefix);
        const int stop = pref ? __ffs(pref) - 1 : 31;
        unsigned long long v = lane <= stop ? s >> 2 : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        prefix += v;
        if (pref) break;
      }
      if (lane == 0) {
        if (tile > 0) st_status(&status[tile], (prefix + total) << 2 | kPrefix);
        if (tile == n_tiles - 1) ws[2] = prefix + total;  // k, read by the wrapper
        s_prefix = prefix;
      }
    }
    __syncthreads();
    const unsigned long long prefix = s_prefix;
    const int64_t row0 = (int64_t)tile * kTile;
    for (int i = threadIdx.x; i < total; i += kThreads) rows[prefix + i] = row0 + s_rows[i];
    __syncthreads();
    if (threadIdx.x == 0) s_tile = next;
  }
}

// Per device (up to kDevices), set once: SM count and resident blocks of
// each kernel an SM (at the most shared memory a call may ask for).  A
// call's host time is most of a small launch's cost.
constexpr int kDevices = 64;
int g_blocks[2][kDevices];

template <typename K>
cudaError_t grid_of(K kernel, int which, int device, int smem_max, int* blocks) {
  const bool cached = device >= 0 && device < kDevices;
  if (cached && g_blocks[which][device] > 0) {
    *blocks = g_blocks[which][device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_max);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (cached) g_blocks[which][device] = *blocks;
  return cudaSuccess;
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

size_t bits_smem(int n_ranges) { return (size_t)(n_ranges + 31) / 32 * 4; }

}  // namespace

// keep must hold n bytes; bucket and keep 16-byte aligned; 1 <= n_ranges
// <= kMaxRanges.  Returns cudaGetLastError().
extern "C" int filter_launch(int device, void* stream, const int32_t* bucket, const uint8_t* bits,
                             long long n, int n_ranges, uint8_t* keep) {
  cudaError_t err = use_device(device);
  int blocks = 0;
  if (err == cudaSuccess) err = grid_of(filter_kernel, 0, device, kMaxRanges / 8, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kTile - 1) / kTile;
  filter_kernel<<<(int)(tiles < blocks ? tiles : blocks), kThreads, bits_smem(n_ranges),
                  (cudaStream_t)stream>>>(bucket, bits, n, n_ranges, keep);
  return (int)cudaGetLastError();
}

// As filter_launch, and rows (n int64s) receives the kept rows' indices in
// ascending order, ws[2] their count.  ws holds kHeadWords + 2 * cap u64
// words, cap >= the tiles of n; the pair of `parity` is clear (tickets and
// status words), and the other pair holds what the previous call left in
// its first prev_tiles status words, which this call clears.
extern "C" int filter_rows_launch(int device, void* stream, const int32_t* bucket,
                                  const uint8_t* bits, long long n, int n_ranges, uint8_t* keep,
                                  int64_t* rows, unsigned long long* ws, long long cap,
                                  int parity, long long prev_tiles) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > cap || prev_tiles > cap || (parity & ~1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  int blocks = 0;
  if (err == cudaSuccess) err = grid_of(filter_rows_kernel, 1, device, kMaxSmem, &blocks);
  if (err != cudaSuccess) return (int)err;
  filter_rows_kernel<<<(int)(tiles < blocks ? tiles : blocks), kThreads,
                       kRowsSmem + bits_smem(n_ranges), (cudaStream_t)stream>>>(
      bucket, bits, n, n_ranges, keep, rows, ws, cap, parity, prev_tiles);
  return (int)cudaGetLastError();
}
