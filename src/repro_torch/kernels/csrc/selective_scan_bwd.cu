// The backward of the selective scan of Mamba-1 on Hopper (sm_90a), with
// mamba_train's neighbours folded in as its forward (selective_scan.cu)
// folds them.
//
// Replaces no Pallas kernel: the reference differentiates mamba_train
// (repro/models/ssm.py:58-112) by autodiff through its chunked lax.scans.
// It exists because autograd of the plain scan on the card keeps every
// position's (B, di, n) float32 state and launches some twenty kernels a
// position: about 2.1 GB and 40,000 launches a row of 2,048 positions at
// jamba-1.5-large's width, a layer.
//
// For every batch row b and channel i, with h_t the states after position
// t (recomputed), walking t from the last position back from dh = 0:
//   dh[k]  = dh[k] + dy[t] c[t,k]            (dh carries dh_{t+1} decay_{t+1})
//   dc[t,k] += dy[t] h_t[k];   db[t,k] += dh[k] dt x     (sums over channels)
//   d(dt x) = sum_k dh[k] b[t,k]
//   g      = dh[k] h_{t-1}[k] decay_t[k];   da[k] += g dt;   ddt = sum_k g a[k]
//   ddt   += d(dt x) x;   dx = d(dt x) dt;   dh[k] = dh[k] decay_t[k]
// with dy the gradient of ys.  The gated entry (G) first differentiates the
// epilogue in the same thread, ys recomputed from h_t as the forward sums it:
//   s = 1 / (1 + expf(-z));   dy = dout z s;   y2 = ys + dd x
//   dz = (dout y2) (s (1 + z (1 - s)));   ddd += dy x;   dx = dy dd + d(dt x) dt
//   ddt_raw = ddt / (1 + expf(-(dt_raw + dt_bias)))   (softplus' = sigmoid)
// These are the formulas of kernels/ref.py::selective_scan_bwd_plain and
// selective_scan_gated_bwd_plain, in the same order but for the sums over
// channels and over k (d(dt x), ddt), whose order differs from torch's.
//
// The forward saves the state entering every stage of kSpan = 4 positions
// (ref.SCAN_SPAN; (B, S / 4, n, di) float32: 537 MB for one row of 2,048 at
// jamba's width).  A stage here recomputes its 4 states from the saved one
// (shared memory, a thread's own column), then walks them in reverse: two
// exponentials a state and position, one for the recompute and one for
// decay_t in the walk.
//
// Bound on an H100: the larger of the bytes of the gradient's own operands
// at 3.35 TB/s and its 2 B S di n exponentials (the states recomputed, then
// decay_t in the walk) at the special-function units' 4.18e12 a second (16
// a clock per SM, 132 SMs, 1,980 MHz).  At di 16,384, n 16, bf16, the
// exponentials bound it: 4.11 ms for 16 rows of 2,048 positions and 0.257
// ms for one, against 18 bytes a position and channel (x, z, dout, dx and
// dz 2 each; the raw dt and ddt 4 each: 2.89 and 0.18 ms).  The saved
// states the kernel also reads (16 bytes a position and channel) are this
// design's cost, not the function's, and are not in the bound.
//
// Design.  The forward's unit and pipeline, walked backwards: a unit is a
// batch row and a tile of kTile = 128 channels, a thread a channel with its
// n <= 16 rows of a, da and dh in registers (n a template parameter); a
// producer warp fills a ring of kStages stages, each one stage's x, dt (raw
// when gated), z, dout (or dys) and b and c rows and its saved state, by
// bulk copies on mbarriers, from the last stage back.  dc and db of a
// position (2 n values) are summed over a warp by a reduce-scatter of
// shuffles (lane l ends with value l; 31 shuffles), then over the four
// warps in warp order, and written as the tile's partial sums; da, ddd and
// d dt_bias are each thread's own sums over positions, written for its
// batch row.  A second launch (scan_bwd_reduce) adds the tiles' partials in
// tile order and the rows' in row order: a call makes two launches, and no
// sum depends on timing (no float atomics), so reruns give equal bits.
//
// What it reaches (chip_smoke.py phase 2, CUDA events around one call;
// PERF.md row 7b): 25.0 ms at 16 rows of 2,048 (6.1x the exponentials'
// 4.11 ms) and 3.65 ms at one row (14x its 0.257 ms: its 128 units fill
// half the card's 264 block slots, and a unit's positions are a chain).
// Not split yet: the recompute's share, the saved states' reads, the
// shuffles' (31 a position and warp) and the registers that hold it to 2
// blocks an SM (118-127, no spills).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxState = 16;  // states a channel (the forward's kMaxState)
constexpr int kCompute = 128;  // compute threads a block (4 warps), a channel each
constexpr int kThreads = kCompute + 32;  // and the producer warp
constexpr int kTile = kCompute;          // channels a unit
constexpr int kSpan = 4;       // positions a stage, and between saved states (the forward's)
constexpr int kStages = 2;     // stages in the ring
constexpr int kMinBlocks = 2;  // blocks an SM should hold (ptxas's register target)
constexpr int kValues = 32;    // a position's dc (k) and db (16 + k): one a lane
constexpr int kReduceThreads = 256;  // the second pass's blocks
static_assert(2 * kMaxState <= kValues, "dc and db of a position fill one value a lane");

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared memory, in bytes from its base: the barriers (full and empty a
// stage, full and empty of the unit's parameters), the ring (a stage: x
// [kSpan][kTile], dt [kSpan][kTile], z [kSpan][kTile] when gated, dout or
// dys [kSpan][kTile], b and c [kSpan][NP], the saved state [N][kTile]),
// the unit's parameters (a [kTile][N], dd and dt_bias [kTile] when gated),
// the recomputed states [kSpan][N][kTile] and the warps' sums of dc and db,
// two sets of [4][kSpan][kValues].
template <int N, typename T, bool G>
struct Layout {
  using TD = typename std::conditional<G, T, float>::type;  // dout (gated) or dys
  static constexpr int NP = (N + 3) / 4 * 4;
  static constexpr int xrow = kTile * (int)sizeof(T);
  static constexpr int drow = kTile * 4;
  static constexpr int grow = kTile * (int)sizeof(TD);
  static constexpr int x_off = 0;
  static constexpr int dt_off = x_off + kSpan * xrow;
  static constexpr int z_off = dt_off + kSpan * drow;
  static constexpr int g_off = z_off + (G ? kSpan * xrow : 0);
  static constexpr int b_off = g_off + kSpan * grow;
  static constexpr int c_off = b_off + kSpan * NP * 4;
  static constexpr int h_off = c_off + kSpan * NP * 4;
  static constexpr int stage = round16(h_off + N * drow);
  static constexpr int ring_off = (16 * kStages + 16 + 127) / 128 * 128;  // after the barriers
  static constexpr int a_off = ring_off + kStages * stage;
  static constexpr int dd_off = a_off + round16(kTile * N * 4);
  static constexpr int bias_off = dd_off + (G ? kTile * 4 : 0);
  static constexpr int st_off = bias_off + (G ? kTile * 4 : 0);
  static constexpr int red_off = st_off + kSpan * N * drow;
  static constexpr int bytes = red_off + 2 * (kCompute / 32) * kSpan * kValues * 4;
};

struct Args {
  const void* x;      // (B, S, di) T
  const void* z;      // gated: (B, S, di) T, position rows z_step elements apart
  long long z_step;
  const float* dt;    // (B, S, di): after the softplus, or raw when gated
  const float* bias;  // gated: dt_bias (di)
  const float* a;     // (di, n)
  const float* bm;    // (B, S, n)
  const float* cm;    // (B, S, n)
  const float* dd;    // gated: (di)
  const void* dy;     // (B, S, di): gated dout in T, else dys float32
  const float* hsave; // (B, nst, n, di): the state entering each stage
  void* dx;           // (B, S, di) T
  void* dz;           // gated: (B, S, di) T
  float* ddt;         // (B, S, di): ddt, or ddt_raw when gated
  float* part;        // (B, tiles, S, kValues): a tile's sums of dc (k) and db (16 + k)
  float* part_a;      // (B, di, n): a row's da
  float* part_dd;     // gated: (B, di): a row's ddd
  float* part_bias;   // gated: (B, di): a row's d dt_bias
  int seq, di, tiles, units, nst;
  int bulk;           // every copy 16-byte aligned: bulk copies, else plain loads
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }

// The producer warp: a unit's parameters, then its stages from the last back.
template <int N, typename T, bool G>
__device__ void produce(const Args& p, uint8_t* smem) {
  using L = Layout<N, T, G>;
  using TD = typename L::TD;
  const int lane = threadIdx.x & 31;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base, empty0 = base + 8 * kStages;
  const uint32_t pfull = base + 16 * kStages, pempty = pfull + 8;
  const T* x = static_cast<const T*>(p.x);
  const T* z = static_cast<const T*>(p.z);
  const TD* dy = static_cast<const TD*>(p.dy);
  int it = 0, j = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++j) {
    const int b = u / p.tiles, i0 = (u - b * p.tiles) * kTile;
    const int cnt = min(kTile, p.di - i0);
    const size_t row = (size_t)b * p.seq;
    if (j > 0) mbar_wait(pempty, (j - 1) & 1);  // every compute thread holds unit j - 1's a
    if (p.bulk) {
      if (lane == 0) {
        mbar_expect_tx(pfull, cnt * N * 4 + (G ? 8 * cnt : 0));
        bulk_load(base + L::a_off, p.a + (size_t)i0 * N, cnt * N * 4, pfull);
        if (G) {
          bulk_load(base + L::dd_off, p.dd + i0, cnt * 4, pfull);
          bulk_load(base + L::bias_off, p.bias + i0, cnt * 4, pfull);
        }
      }
    } else {
      float* sa = reinterpret_cast<float*>(smem + L::a_off);
      for (int e = lane; e < cnt * N; e += 32) sa[e] = p.a[(size_t)i0 * N + e];
      if (G) {
        for (int e = lane; e < cnt; e += 32) {
          reinterpret_cast<float*>(smem + L::dd_off)[e] = p.dd[i0 + e];
          reinterpret_cast<float*>(smem + L::bias_off)[e] = p.bias[i0 + e];
        }
      }
      mbar_arrive(pfull);  // one arrival a lane, after its own stores
    }
    for (int st = p.nst - 1; st >= 0; --st, ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) + 1) & 1);
      const int t0 = st * kSpan, np = min(kSpan, p.seq - t0);
      const uint32_t full = full0 + 8 * s;
      uint8_t* sg = smem + L::ring_off + s * L::stage;
      const uint32_t ssg = base + L::ring_off + s * L::stage;
      const float* hq = p.hsave + ((size_t)b * p.nst + st) * N * p.di + i0;
      if (p.bulk) {
        const uint32_t xb = cnt * (int)sizeof(T), gb = cnt * (int)sizeof(TD);
        if (lane == 0)
          mbar_expect_tx(full, np * (xb + 4 * cnt + (G ? xb : 0) + gb + 8 * N) + N * 4 * cnt);
        __syncwarp();
        if (lane < np) {  // lane q copies position t0 + q's rows
          const size_t at = (row + t0 + lane) * p.di + i0;
          bulk_load(ssg + L::x_off + lane * L::xrow, x + at, xb, full);
          bulk_load(ssg + L::dt_off + lane * L::drow, p.dt + at, 4 * cnt, full);
          if (G) bulk_load(ssg + L::z_off + lane * L::xrow, z + (row + t0 + lane) * p.z_step + i0,
                           xb, full);
          bulk_load(ssg + L::g_off + lane * L::grow, dy + at, gb, full);
        } else if (lane >= 8 && lane < 8 + N) {  // lane 8 + k copies the saved state's row k
          const int k = lane - 8;
          bulk_load(ssg + L::h_off + k * L::drow, hq + (size_t)k * p.di, 4 * cnt, full);
        } else if (lane == 31) {  // the stage's b and c rows are contiguous
          bulk_load(ssg + L::b_off, p.bm + (row + t0) * N, np * N * 4, full);
          bulk_load(ssg + L::c_off, p.cm + (row + t0) * N, np * N * 4, full);
        }
      } else {
        for (int q = 0; q < np; ++q) {
          const size_t at = (row + t0 + q) * p.di + i0;
          T* sx = reinterpret_cast<T*>(sg + L::x_off + q * L::xrow);
          float* sd = reinterpret_cast<float*>(sg + L::dt_off + q * L::drow);
          TD* sy = reinterpret_cast<TD*>(sg + L::g_off + q * L::grow);
          for (int e = lane; e < cnt; e += 32) {
            sx[e] = x[at + e];
            sd[e] = p.dt[at + e];
            sy[e] = dy[at + e];
          }
          if (G) {
            T* sz = reinterpret_cast<T*>(sg + L::z_off + q * L::xrow);
            for (int e = lane; e < cnt; e += 32) sz[e] = z[(row + t0 + q) * p.z_step + i0 + e];
          }
          for (int k = lane; k < N; k += 32) {
            reinterpret_cast<float*>(sg + L::b_off)[q * L::NP + k] = p.bm[(row + t0 + q) * N + k];
            reinterpret_cast<float*>(sg + L::c_off)[q * L::NP + k] = p.cm[(row + t0 + q) * N + k];
          }
        }
        float* sh = reinterpret_cast<float*>(sg + L::h_off);
        for (int e = lane; e < N * cnt; e += 32) {
          const int k = e / cnt, c = e - k * cnt;
          sh[k * kTile + c] = hq[(size_t)k * p.di + c];
        }
        mbar_arrive(full);  // one arrival a lane, after its own stores
      }
    }
  }
}

// One step of reduce_scatter: lanes with bit W keep values W .. 2W - 1,
// the others 0 .. W - 1, each adding its partner's copy (lane ^ W) into
// v[0 .. W - 1].  A template, so every index is a constant and v stays in
// registers.
template <int W>
__device__ __forceinline__ void scatter_step(float (&v)[kValues], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, W));
  }
  if constexpr (W > 1) scatter_step<W / 2>(v, lane);
}

// Every lane holds 32 values; afterwards lane l holds the sum over the warp
// of value l (a reduce-scatter of shuffles, the same pattern on every call).
__device__ __forceinline__ float reduce_scatter(float (&v)[kValues]) {
  scatter_step<kValues / 2>(v, threadIdx.x & 31);
  return v[0];
}

// ref.softplus of dt_raw + dt_bias, as the forward computes it.
__device__ __forceinline__ float softplus(float t) {
  return __fadd_rn(fmaxf(t, 0.f), log1pf(expf(-fabsf(t))));
}

// A compute thread: one channel of each unit, stage by stage from the last.
template <int N, typename T, bool G>
__device__ void consume(const Args& p, uint8_t* smem) {
  using L = Layout<N, T, G>;
  using TD = typename L::TD;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base, empty0 = base + 8 * kStages;
  const uint32_t pfull = base + 16 * kStages, pempty = pfull + 8;
  const int c0 = threadIdx.x, lane = c0 & 31, warp = c0 >> 5;
  float* hst = reinterpret_cast<float*>(smem + L::st_off) + c0;  // [kSpan][N][kTile]
  float* red = reinterpret_cast<float*>(smem + L::red_off);
  T* dxo = static_cast<T*>(p.dx);
  T* dzo = static_cast<T*>(p.dz);
  int it = 0, j = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++j) {
    const int b = u / p.tiles, tile = u - b * p.tiles, i0 = tile * kTile;
    const bool valid = c0 < min(kTile, p.di - i0);
    const size_t row = (size_t)b * p.seq;
    float av[N], da[N], dh[N];
    mbar_wait(pfull, j & 1);
    const float* sa = reinterpret_cast<const float*>(smem + L::a_off) + c0 * N;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      av[k] = sa[k];
      da[k] = 0.f;
      dh[k] = 0.f;
    }
    const float ddv = G ? reinterpret_cast<const float*>(smem + L::dd_off)[c0] : 0.f;
    const float biasv = G ? reinterpret_cast<const float*>(smem + L::bias_off)[c0] : 0.f;
    mbar_arrive(pempty);
    float dd_acc = 0.f, bias_acc = 0.f;
    for (int st = p.nst - 1; st >= 0; --st, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const int t0 = st * kSpan, np = min(kSpan, p.seq - t0);
      const uint8_t* sg = smem + L::ring_off + s * L::stage;
      const float* hsv = reinterpret_cast<const float*>(sg + L::h_off) + c0;
      // 1. The stage's states, forward from the saved one, as the forward
      // computes them: h_q after position t0 + q into hst[q].
      {
        float h[N];
#pragma unroll
        for (int k = 0; k < N; ++k) h[k] = hsv[k * kTile];
#pragma unroll
        for (int q = 0; q < kSpan; ++q) {
          if (q >= np) break;
          float d = reinterpret_cast<const float*>(sg + L::dt_off + q * L::drow)[c0];
          const float xv = widen(reinterpret_cast<const T*>(sg + L::x_off + q * L::xrow)[c0]);
          if (G) d = softplus(__fadd_rn(d, biasv));
          const float dx = __fmul_rn(d, xv);
          const float* sb = reinterpret_cast<const float*>(sg + L::b_off + q * L::NP * 4);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const float decay = expf(__fmul_rn(d, av[k]));
            h[k] = __fadd_rn(__fmul_rn(h[k], decay), __fmul_rn(dx, sb[k]));
            hst[(q * N + k) * kTile] = h[k];
          }
        }
      }
      // 2. The reverse walk over the stage's positions.
      float* rb = red + (it & 1) * (kCompute / 32) * kSpan * kValues;
#pragma unroll
      for (int q = kSpan - 1; q >= 0; --q) {
        if (q >= np) continue;
        const size_t at = (row + t0 + q) * p.di + i0 + c0;
        const float raw = reinterpret_cast<const float*>(sg + L::dt_off + q * L::drow)[c0];
        const float xv = widen(reinterpret_cast<const T*>(sg + L::x_off + q * L::xrow)[c0]);
        const float gin = widen(reinterpret_cast<const TD*>(sg + L::g_off + q * L::grow)[c0]);
        const float tt = __fadd_rn(raw, biasv);
        const float d = G ? softplus(tt) : raw;
        const float* ht = hst + q * N * kTile;
        const float* hp = q ? hst + (q - 1) * N * kTile : hsv;
        const float* sb = reinterpret_cast<const float*>(sg + L::b_off + q * L::NP * 4);
        const float* sc = reinterpret_cast<const float*>(sg + L::c_off + q * L::NP * 4);
        float dy, dxv = 0.f;
        if (G) {  // the skip term and the gate
          const float zv = widen(reinterpret_cast<const T*>(sg + L::z_off + q * L::xrow)[c0]);
          float y = 0.f;
#pragma unroll
          for (int k = 0; k < N; ++k) y = fmaf(ht[k * kTile], sc[k], y);
          const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-zv)));
          const float y2 = __fadd_rn(y, __fmul_rn(ddv, xv));
          dy = __fmul_rn(gin, __fmul_rn(zv, sig));
          const float dzv = __fmul_rn(__fmul_rn(gin, y2),
                                      __fmul_rn(sig, __fadd_rn(1.f, __fmul_rn(zv, __fsub_rn(1.f, sig)))));
          dd_acc = __fadd_rn(dd_acc, __fmul_rn(dy, xv));
          dxv = __fmul_rn(dy, ddv);
          if (valid) narrow(dzv, dzo + at);
        } else {
          dy = gin;
        }
        const float dtx = __fmul_rn(d, xv);
        float v[kValues], dsum = 0.f, ddt = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          dh[k] = __fadd_rn(dh[k], __fmul_rn(dy, sc[k]));
          v[k] = valid ? __fmul_rn(dy, ht[k * kTile]) : 0.f;
          v[kMaxState + k] = valid ? __fmul_rn(dh[k], dtx) : 0.f;
          dsum = __fadd_rn(dsum, __fmul_rn(dh[k], sb[k]));
          const float decay = expf(__fmul_rn(d, av[k]));
          const float g = __fmul_rn(__fmul_rn(dh[k], hp[k * kTile]), decay);
          da[k] = __fadd_rn(da[k], __fmul_rn(g, d));
          ddt = __fadd_rn(ddt, __fmul_rn(g, av[k]));
          dh[k] = __fmul_rn(dh[k], decay);
        }
#pragma unroll
        for (int k = N; k < kMaxState; ++k) v[k] = v[kMaxState + k] = 0.f;
        ddt = __fadd_rn(ddt, __fmul_rn(dsum, xv));
        dxv = __fadd_rn(dxv, __fmul_rn(dsum, d));
        if (G) {
          ddt = __fmul_rn(ddt, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-tt))));
          bias_acc = __fadd_rn(bias_acc, ddt);
        }
        rb[(warp * kSpan + q) * kValues + lane] = reduce_scatter(v);
        if (valid) {
          narrow(dxv, dxo + at);
          p.ddt[at] = ddt;
        }
      }
      mbar_arrive(empty0 + 8 * s);  // the stage's ring slot is read
      named_bar_sync(2, kCompute);  // every warp's sums of the stage are in rb
      // 3. The tile's sums of the stage: the four warps' in warp order.
      {
        const int q = c0 / kValues, e = c0 % kValues;
        if (q < np) {
          const float* r = rb + q * kValues + e;
          const int w = kSpan * kValues;
          p.part[(((size_t)b * p.tiles + tile) * p.seq + t0 + q) * kValues + e] =
              __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[w]), r[2 * w]), r[3 * w]);
        }
      }
    }
    if (valid) {  // the row's own sums over positions
      const size_t i = (size_t)b * p.di + i0 + c0;
#pragma unroll
      for (int k = 0; k < N; ++k) p.part_a[i * N + k] = da[k];
      if (G) {
        p.part_dd[i] = dd_acc;
        p.part_bias[i] = bias_acc;
      }
    }
  }
}

template <int N, typename T, bool G>
__global__ void __launch_bounds__(kThreads, kMinBlocks) scan_bwd_kernel(const Args p) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x == 0) {
    const uint32_t base = smem_u32(smem);
    const uint32_t copied = p.bulk ? 1 : 32;  // the producer's arrivals a fill
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + 8 * s, copied);
      mbar_init(base + 8 * (kStages + s), kCompute);
    }
    mbar_init(base + 16 * kStages, copied);
    mbar_init(base + 16 * kStages + 8, kCompute);
    fence_barrier_init();
  }
  named_bar_sync(1, kThreads);  // the barriers are initialised (once, before the roles split)
  if (threadIdx.x >= kCompute) {
    produce<N, T, G>(p, smem);
  } else {
    consume<N, T, G>(p, smem);
  }
}

// The second pass: dc and db (B, S, n) over the tiles in tile order, da
// (di, n) over the rows in row order, and (gated) ddd and d dt_bias (di).
__global__ void __launch_bounds__(kReduceThreads) scan_bwd_reduce(
    const float* __restrict__ part, const float* __restrict__ part_a,
    const float* __restrict__ part_dd, const float* __restrict__ part_bias, float* dcm,
    float* dbm, float* da, float* ddd, float* dbias, int batch, int seq, int di, int n,
    int tiles) {
  const long long n1 = (long long)batch * seq * n, n2 = (long long)di * n;
  const long long n3 = part_dd ? di : 0;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n1 + n2 + n3;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < n1) {
      const long long bt = e / n;
      const int k = (int)(e - bt * n), b = (int)(bt / seq), t = (int)(bt - (long long)b * seq);
      const float* q = part + ((size_t)b * tiles * seq + t) * kValues;
      float sc = 0.f, sb = 0.f;
      for (int tile = 0; tile < tiles; ++tile) {
        sc = __fadd_rn(sc, q[(size_t)tile * seq * kValues + k]);
        sb = __fadd_rn(sb, q[(size_t)tile * seq * kValues + kMaxState + k]);
      }
      dcm[e] = sc;
      dbm[e] = sb;
    } else if (e < n1 + n2) {
      const long long f = e - n1;
      float s = 0.f;
      for (int b = 0; b < batch; ++b) s = __fadd_rn(s, part_a[(size_t)b * n2 + f]);
      da[f] = s;
    } else {
      const long long i = e - n1 - n2;
      float s = 0.f, sb = 0.f;
      for (int b = 0; b < batch; ++b) {
        s = __fadd_rn(s, part_dd[(size_t)b * di + i]);
        sb = __fadd_rn(sb, part_bias[(size_t)b * di + i]);
      }
      ddd[i] = s;
      dbias[i] = sb;
    }
  }
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

constexpr int kMaxDevices = 64;

// Blocks an SM holds (cached a device), after raising the kernel's dynamic
// shared-memory limit to what it takes.
template <int N, typename T, bool G>
cudaError_t resident(int device, int* blocks) {
  static int cached[kMaxDevices] = {0};
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  const int bytes = Layout<N, T, G>::bytes;
  cudaError_t err = cudaFuncSetAttribute(scan_bwd_kernel<N, T, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, scan_bwd_kernel<N, T, G>,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (*blocks < 1) return cudaErrorInvalidConfiguration;
  if (device >= 0 && device < kMaxDevices) cached[device] = *blocks;
  return cudaSuccess;
}

template <int N, typename T, bool G>
cudaError_t launch_n(int device, cudaStream_t stream, Args p, int batch) {
  int blocks = 0, sms = 0;
  cudaError_t err = resident<N, T, G>(device, &blocks);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int grid = min(p.units, blocks * sms);
  scan_bwd_kernel<N, T, G><<<grid, kThreads, Layout<N, T, G>::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int N, typename T, bool G>
cudaError_t query_n(int device, int* out) {
  cudaError_t err = resident<N, T, G>(device, &out[0]);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, device);
  out[2] = Layout<N, T, G>::bytes;
  out[3] = kThreads;
  out[4] = kTile;
  return err;
}

// F(N, T, G, args...) for the instance of n states.
#define SCAN_DISPATCH(F, n, T, G, ...)                       \
  switch (n) {                                               \
    case 1: return F<1, T, G>(__VA_ARGS__);                  \
    case 2: return F<2, T, G>(__VA_ARGS__);                  \
    case 3: return F<3, T, G>(__VA_ARGS__);                  \
    case 4: return F<4, T, G>(__VA_ARGS__);                  \
    case 5: return F<5, T, G>(__VA_ARGS__);                  \
    case 6: return F<6, T, G>(__VA_ARGS__);                  \
    case 7: return F<7, T, G>(__VA_ARGS__);                  \
    case 8: return F<8, T, G>(__VA_ARGS__);                  \
    case 9: return F<9, T, G>(__VA_ARGS__);                  \
    case 10: return F<10, T, G>(__VA_ARGS__);                \
    case 11: return F<11, T, G>(__VA_ARGS__);                \
    case 12: return F<12, T, G>(__VA_ARGS__);                \
    case 13: return F<13, T, G>(__VA_ARGS__);                \
    case 14: return F<14, T, G>(__VA_ARGS__);                \
    case 15: return F<15, T, G>(__VA_ARGS__);                \
    case 16: return F<16, T, G>(__VA_ARGS__);                \
    default: return cudaErrorInvalidValue;                   \
  }

// A probe's build (-DSCAN_ONE_STATE_COUNT=16) compiles only that instance.
#ifdef SCAN_ONE_STATE_COUNT
#define SCAN_STATES(F, n, T, G, ...) \
  return n == SCAN_ONE_STATE_COUNT ? F<SCAN_ONE_STATE_COUNT, T, G>(__VA_ARGS__) : cudaErrorInvalidValue;
#else
#define SCAN_STATES(F, n, T, G, ...) SCAN_DISPATCH(F, n, T, G, __VA_ARGS__)
#endif

template <typename T, bool G>
cudaError_t launch_t(int device, cudaStream_t stream, const Args& p, int batch, int n) {
  SCAN_STATES(launch_n, n, T, G, device, stream, p, batch)
}

template <typename T, bool G>
cudaError_t query_t(int device, int n, int* out) {
  SCAN_STATES(query_n, n, T, G, device, out)
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The selective scan's backward: two launches, the walk and scan_bwd_reduce.
// x (B, S, di) float32 (x_dtype 0) or bfloat16 (1); dt, a, bm, cm as the
// forward takes them; hsave (B, ceil(S / 4), n, di) float32, the forward's
// saved states; all contiguous.  gated 0: dy the float32 dys (B, S, di);
// writes dx (x's dtype), ddt, and dcm, dbm (B, S, n), da (di, n); z, dd,
// dt_bias, dz, ddd, dbias and part_dd, part_bias unused.  gated 1: dt raw,
// z as the forward takes it, dy the output's gradient (B, S, di) in x's
// dtype; also writes dz (x's dtype, contiguous), ddd and dbias (di), and
// ddt is the raw dt's gradient.  Scratch: part (B, ceil(di / 128), S, 32),
// part_a (B, di, n), part_dd and part_bias (B, di), float32.  Returns the
// first launch error (cudaGetLastError()).
extern "C" int selective_scan_bwd_launch(
    int device, void* stream, int x_dtype, int gated, const void* x, const void* z,
    long long z_step, const float* dt, const float* dt_bias, const float* a, const float* bm,
    const float* cm, const float* dd, const void* dy, const float* hsave, void* dx, void* dz,
    float* ddt, float* dcm, float* dbm, float* da, float* ddd, float* dbias, float* part,
    float* part_a, float* part_dd, float* part_bias, int batch, int seq, int di, int n) {
  if (n < 1 || n > kMaxState || batch < 1 || batch > 65535 || seq < 1 || di < 1 ||
      (x_dtype & ~1) || (gated & ~1) || (gated && z_step < di))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int xs = x_dtype ? 2 : 4;
  const int tiles = (di + kTile - 1) / kTile;
  const int nst = (seq + kSpan - 1) / kSpan;
  Args p{x,  z,  z_step, dt, dt_bias, a, bm, cm, dd, dy, hsave, dx, dz, ddt, part, part_a,
         gated ? part_dd : nullptr, gated ? part_bias : nullptr, seq, di, tiles, batch * tiles,
         nst, 0};
  // Bulk copies need 16-byte aligned sources and lengths: every row of x, dt,
  // z, dy and the saved states, the tile's share of a, dd and dt_bias, and a
  // stage's b and c.
  const int ys = gated ? xs : 4;
  p.bulk = aligned(x) && aligned(dt) && aligned(a) && aligned(bm) && aligned(cm) &&
           aligned(dy) && aligned(hsave) && (di * xs) % 16 == 0 && (di * ys) % 16 == 0 &&
           di % 4 == 0 && n % 4 == 0 &&
           (!gated || (aligned(z) && aligned(dt_bias) && aligned(dd) && (z_step * xs) % 16 == 0));
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0) {
    err = gated ? launch_t<float, true>(device, s, p, batch, n)
                : launch_t<float, false>(device, s, p, batch, n);
  } else {
    err = gated ? launch_t<__nv_bfloat16, true>(device, s, p, batch, n)
                : launch_t<__nv_bfloat16, false>(device, s, p, batch, n);
  }
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)batch * seq * n + (long long)di * n + (gated ? di : 0);
  const long long want = (total + kReduceThreads - 1) / kReduceThreads;
  const int grid = (int)(want < 8LL * sms ? want : 8LL * sms);
  scan_bwd_reduce<<<grid, kReduceThreads, 0, s>>>(p.part, part_a, p.part_dd, p.part_bias, dcm,
                                                  dbm, da, ddd, dbias, batch, seq, di, n, tiles);
  return (int)cudaGetLastError();
}

// The walk's launch plan of one instance: out[0] blocks an SM holds, out[1]
// the SMs, out[2] the dynamic shared memory of a block, out[3] its threads,
// out[4] the channels of a unit.  Returns a CUDA error code.
extern "C" int selective_scan_bwd_occupancy(int device, int x_dtype, int gated, int n,
                                            int* out) {
  if (n < 1 || n > kMaxState || (x_dtype & ~1) || (gated & ~1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (x_dtype == 0) {
    err = gated ? query_t<float, true>(device, n, out) : query_t<float, false>(device, n, out);
  } else {
    err = gated ? query_t<__nv_bfloat16, true>(device, n, out)
                : query_t<__nv_bfloat16, false>(device, n, out);
  }
  return (int)err;
}
