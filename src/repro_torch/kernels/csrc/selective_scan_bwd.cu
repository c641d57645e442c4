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
// epilogue, ys recomputed from h_t:
//   s = 1 / (1 + expf(-z));   dy = dout z s;   y2 = ys + dd x
//   dz = (dout y2) (s (1 + z (1 - s)));   ddd += dy x;   dx = dy dd + d(dt x) dt
//   ddt_raw = ddt / (1 + expf(-(dt_raw + dt_bias)))   (softplus' = sigmoid)
// These are the formulas of kernels/ref.py::selective_scan_bwd_plain and
// selective_scan_gated_bwd_plain; the sums over channels, over k and over
// positions run in other (fixed) orders, FMAs contract the products into
// the sums, and decay_t = 2^(dt a log2 e) by the SFU's ex2.approx, whose
// error over the gradients' scales chip_smoke.py phase 2 reports beside
// SCAN_GRAD_TOL.
//
// The forward saves the state entering every stage of kSpan = 4 positions
// (ref.SCAN_SPAN; (B, S / 4, n, di) float32: 537 MB for one row of 2,048 at
// jamba's width); a stage here recomputes its 4 states from the saved one,
// then walks them in reverse.
//
// Bound on an H100: the larger of the bytes of the gradient's own operands
// at 3.35 TB/s and its B S di n exponentials (each decay once) at the
// special-function units' 4.18e12 a second (16 a clock per SM, 132 SMs,
// 1,980 MHz).  At di 16,384, n 16, bf16 the bytes bind: 18 a position and
// channel (x, z, dout, dx and dz 2 each; the raw dt and ddt 4 each), 2.888
// ms for 16 rows of 2,048 positions and 0.181 ms for one, against 2.054
// and 0.128 ms of exponentials.  The saved states the kernel also reads (16
// bytes a position and channel) are this design's cost, not the
// function's, and are not in the bound.
//
// Design.  The first port gave a thread a channel and its 16 states: 128
// units (a row and 128 channels) at one row, a warp a scheduler, every
// position a chain of dependent sums (y, d(dt x), ddt over k, a
// reduce-scatter of 31 shuffles), each decay computed twice.  Here:
// - a channel's states are split over kLanes = 4 lanes (lanes c, c + 8,
//   c + 16, c + 24 of a warp; each holds n / 4 states and their rows of a,
//   da and dh): a warp is 8 channels, a unit a batch row and kTile = 64
//   channels, a block 8 compute warps and a producer warp, 2 blocks an SM:
//   16 compute warps an SM at one row (256 units) as at 16;
// - the channel's own work of a position (dt's softplus and, from the same
//   exponential, its sigmoid; the gate's sigmoid, dy, d x, the epilogue's
//   gradients and the stores) is done once, by the lane whose group number
//   is the position's place in its stage, and shuffled to the other three;
// - a stage's 4 states and decays are recomputed into registers (each
//   decay once), then walked in reverse;
// - y, d(dt x) and ddt are summed over a lane's states, then over the 4
//   lanes by a reduce-scatter of 9 shuffles that leaves each position's sums
//   with its lane;
// - dc and db go to shared memory ([kSpan][kTile][2 NP + 4] float32, two
//   buffers, the padding keeping the stores and the reads free of bank
//   conflicts); once every thread has arrived on the buffer's mbarrier
//   (arrivals after the walk, the wait after the channel's gradients, so a
//   warp's lead is not lost every stage), each compute thread sums half of
//   one output's 64 channels (4 accumulators, constant offsets), a shuffle
//   adds the halves, and the tile's sums go to part (B, S, tiles, 32); a
//   second launch (scan_bwd_reduce) adds the tiles' partials in tile order
//   and the rows' da, ddd and d dt_bias in row order.  No float atomics:
//   reruns give equal bits, and a row's bits do not depend on the others
//   (but da, ddd and d dt_bias, summed over rows).
// The producer warp fills a ring of kStages stages (x, dt, z, dout, b, c
// and the saved state) by bulk copies on mbarriers, from the last stage
// back, as the first port did.
//
// What holds it (kernels/scan_probe.py --bwd --split selective): the
// issue rate.  Its loop over stages is about 709 SASS instructions a lane
// and stage (a channel and position): an issue floor of 11.4 ms at 16 rows
// of jamba's width, of which some 250 are integer and control work.  Nine
// warps a block at 2 blocks an SM cap ptxas at 96 registers (an SM
// sub-partition's 16,384 over 5 warps), so the loop spills 12 bytes and
// re-derives its indices; 112 registers cut the loop to 629 instructions
// but leave one block an SM, and dropping the producer warp (warp 0
// issuing the copies) made warp 0 every stage's straggler.
// What it reaches: see PERF.md row 7b (kernels/scan_probe.py --bwd --split
// and --paired; chip_smoke.py phase 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxState = 16;  // states a channel (the forward's kMaxState)
constexpr int kLanes = 4;      // lanes a channel, its states split among them
constexpr int kWarps = 8;      // compute warps a block
constexpr int kCompute = 32 * kWarps;    // compute threads a block
constexpr int kThreads = kCompute + 32;  // and the producer warp
constexpr int kTile = kCompute / kLanes; // channels a unit
constexpr int kSpan = 4;       // positions a stage, and between saved states (the forward's)
constexpr int kStages = 3;     // stages in the ring
constexpr int kMinBlocks = 2;  // blocks an SM should hold (ptxas's register target)
constexpr int kValues = 32;    // a position's dc (k) and db (16 + k) in part
constexpr int kReduceThreads = 256;  // the second pass's blocks
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSpan == kLanes, "a channel's lane g does position g of a stage");
static_assert(2 * kMaxState <= kValues, "dc and db of a position fill one part row");
static_assert(kCompute / 2 >= kSpan * 2 * kMaxState, "a stage's sums: two threads an output");

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared memory, in bytes from its base: the barriers (full and empty a
// stage, full and empty of the unit's parameters, two of the stages' sums
// of dc and db), the ring (a stage: x
// [kSpan][kTile], dt [kSpan][kTile], z [kSpan][kTile] when gated, dout or
// dys [kSpan][kTile], b and c [kSpan][NP], the saved state [N][kTile]),
// the unit's parameters (a [kTile][N], dd and dt_bias [kTile] when gated)
// and two buffers of a stage's dc and db, [kSpan][kTile][RV].
template <int N, typename T, bool G>
struct Layout {
  using TD = typename std::conditional<G, T, float>::type;  // dout (gated) or dys
  static constexpr int NP = (N + 3) / 4 * 4;  // states padded to kLanes lanes' shares
  static constexpr int KL = NP / kLanes;      // states a lane
  static constexpr int RV = 2 * NP + 4;       // a channel's row of dc and db (RV = 4 mod 8)
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
  static constexpr int ring_off = (16 * kStages + 32 + 127) / 128 * 128;  // after the barriers
  static constexpr int a_off = ring_off + kStages * stage;
  static constexpr int dd_off = a_off + round16(kTile * N * 4);
  static constexpr int bias_off = dd_off + (G ? kTile * 4 : 0);
  static constexpr int red_off = round16(bias_off + (G ? kTile * 4 : 0));
  static constexpr int red = kSpan * kTile * RV;  // floats a buffer
  static constexpr int bytes = red_off + 2 * red * 4;
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
  float* part;        // (B, S, tiles, kValues): a tile's sums of dc (k) and db (16 + k)
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

// 2^x on the special-function unit (ex2.approx, denormals flushed).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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
        } else if (lane == 31) {  // the stage's b and c rows are contiguous (n = NP)
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
          for (int k = lane; k < L::NP; k += 32) {  // the padding states read b = c = 0
            const bool in = k < N;
            reinterpret_cast<float*>(sg + L::b_off)[q * L::NP + k] =
                in ? p.bm[(row + t0 + q) * N + k] : 0.f;
            reinterpret_cast<float*>(sg + L::c_off)[q * L::NP + k] =
                in ? p.cm[(row + t0 + q) * N + k] : 0.f;
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

// A lane's KL consecutive floats of a row in shared memory.
template <int KL>
__device__ __forceinline__ void load_share(const float* src, float (&v)[KL]) {
  if constexpr (KL == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < KL; ++i) v[i] = src[i];
  }
}

template <int KL>
__device__ __forceinline__ void store_share(float* dst, const float (&v)[KL]) {
  if constexpr (KL == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < KL; ++i) dst[i] = v[i];
  }
}

// A compute thread: lane group g = lane / 8 of channel cb = 8 warp + lane % 8
// of each unit, holding states g KL .. g KL + KL - 1, stage by stage from
// the last.
template <int N, typename T, bool G>
__device__ void consume(const Args& p, uint8_t* smem) {
  using L = Layout<N, T, G>;
  using TD = typename L::TD;
  constexpr int KL = L::KL, NP = L::NP, RV = L::RV;
  constexpr int M = G ? 3 : 2;  // sums over k a position: (y,) d(dt x), ddt
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base, empty0 = base + 8 * kStages;
  const uint32_t pfull = base + 16 * kStages, pempty = pfull + 8;
  const uint32_t summed0 = pempty + 8;  // two: every thread's dc and db are in red[it & 1]
  const int tid = threadIdx.x, lane = tid & 31;
  const int grp = lane >> 3, cb = (tid >> 5) * 8 + (lane & 7), k0 = grp * KL;
  const int src0 = lane & 7;  // lane of group 0 of this channel
  float* red = reinterpret_cast<float*>(smem + L::red_off);
  T* dxo = static_cast<T*>(p.dx);
  T* dzo = static_cast<T*>(p.dz);
  // The stage's sums: output o = (q, v) of kSpan * 2 NP, half hf of the 64
  // channels (the halves in lanes l and l ^ 16).
  const int o = (tid >> 5) * 16 + (lane & 15), hf = (lane >> 4) & 1;
  const int oq = o / (2 * NP), ov = o - oq * (2 * NP);
  const bool summer = o < kSpan * 2 * NP && (ov < NP ? ov : ov - NP) < N;
  const int pv = ov < NP ? ov : kMaxState + ov - NP;  // its place in a part row
  int it = 0, j = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++j) {
    const int b = u / p.tiles, tile = u - b * p.tiles, i0 = tile * kTile;
    const bool valid = cb < min(kTile, p.di - i0);
    const size_t row = (size_t)b * p.seq;
    float av[KL], a2[KL], da[KL], dh[KL];
    mbar_wait(pfull, j & 1);
    const float* sa = reinterpret_cast<const float*>(smem + L::a_off) + cb * N;
#pragma unroll
    for (int kk = 0; kk < KL; ++kk) {
      av[kk] = valid && k0 + kk < N ? sa[k0 + kk] : 0.f;
      a2[kk] = av[kk] * kLog2e;
      da[kk] = 0.f;
      dh[kk] = 0.f;
    }
    const float ddv = G ? reinterpret_cast<const float*>(smem + L::dd_off)[cb] : 0.f;
    const float biasv = G ? reinterpret_cast<const float*>(smem + L::bias_off)[cb] : 0.f;
    mbar_arrive(pempty);
    float dd_acc = 0.f, bias_acc = 0.f;
    for (int st = p.nst - 1; st >= 0; --st, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const int t0 = st * kSpan, np = min(kSpan, p.seq - t0);
      const uint8_t* sg = smem + L::ring_off + s * L::stage;
      // 1. The channel's own work of this lane's position, q = grp.
      const float raw = reinterpret_cast<const float*>(sg + L::dt_off + grp * L::drow)[cb];
      const float xv = widen(reinterpret_cast<const T*>(sg + L::x_off + grp * L::xrow)[cb]);
      const float gin = widen(reinterpret_cast<const TD*>(sg + L::g_off + grp * L::grow)[cb]);
      float d = raw, dy = gin, zv = 0.f, sig = 0.f, sgt = 0.f;
      if (G) {  // softplus(tt) and its derivative sigmoid(tt) from one exp
        const float tt = raw + biasv, e = expf(-fabsf(tt)), r = __frcp_rn(1.f + e);
        d = fmaxf(tt, 0.f) + log1pf(e);
        sgt = tt >= 0.f ? r : e * r;
        zv = widen(reinterpret_cast<const T*>(sg + L::z_off + grp * L::xrow)[cb]);
        sig = __frcp_rn(1.f + __expf(-zv));
        dy = gin * (zv * sig);
      }
      // A channel off the tile's end walks zeros (its smem is stale).
      d = valid ? d : 0.f;
      dy = valid ? dy : 0.f;
      const float dtx = valid ? d * xv : 0.f;
      // 2. Every position's d, dy and dt x, from its lane.
      float dq[kSpan], yq[kSpan], xq[kSpan];
#pragma unroll
      for (int q = 0; q < kSpan; ++q) {
        dq[q] = __shfl_sync(0xffffffffu, d, q * 8 + src0);
        yq[q] = __shfl_sync(0xffffffffu, dy, q * 8 + src0);
        xq[q] = __shfl_sync(0xffffffffu, dtx, q * 8 + src0);
      }
      // 3. The stage's states and decays from the saved state, in registers.
      float h0[KL], hq[kSpan][KL], dec[kSpan][KL];
      {
        const float* hs = reinterpret_cast<const float*>(sg + L::h_off) + cb;
#pragma unroll
        for (int kk = 0; kk < KL; ++kk)
          h0[kk] = valid && k0 + kk < N ? hs[(k0 + kk) * kTile] : 0.f;
#pragma unroll
        for (int q = 0; q < kSpan; ++q) {
          if (q >= np) break;
          float bv[KL];
          load_share<KL>(reinterpret_cast<const float*>(sg + L::b_off) + q * NP + k0, bv);
#pragma unroll
          for (int kk = 0; kk < KL; ++kk) {
            dec[q][kk] = ex2(dq[q] * a2[kk]);
            hq[q][kk] = fmaf(q ? hq[q - 1][kk] : h0[kk], dec[q][kk], xq[q] * bv[kk]);
          }
        }
      }
      // 4. The reverse walk; dc and db to this stage's buffer.
      float* rb = red + (it & 1) * L::red;
      float sums[kSpan][M];
#pragma unroll
      for (int q = kSpan - 1; q >= 0; --q) {
#pragma unroll
        for (int m = 0; m < M; ++m) sums[q][m] = 0.f;
        if (q >= np) continue;
        float bv[KL], cv[KL], vc[KL], vb[KL];
        load_share<KL>(reinterpret_cast<const float*>(sg + L::b_off) + q * NP + k0, bv);
        load_share<KL>(reinterpret_cast<const float*>(sg + L::c_off) + q * NP + k0, cv);
        float y = 0.f, dsum = 0.f, gsum = 0.f;
#pragma unroll
        for (int kk = 0; kk < KL; ++kk) {
          dh[kk] = fmaf(yq[q], cv[kk], dh[kk]);
          vc[kk] = yq[q] * hq[q][kk];
          vb[kk] = dh[kk] * xq[q];
          if (G) y = fmaf(hq[q][kk], cv[kk], y);
          dsum = fmaf(dh[kk], bv[kk], dsum);
          dh[kk] = dh[kk] * dec[q][kk];
          const float g = dh[kk] * (q ? hq[q - 1][kk] : h0[kk]);
          da[kk] = fmaf(g, dq[q], da[kk]);
          gsum = fmaf(g, av[kk], gsum);
        }
        float* w = rb + (q * kTile + cb) * RV + k0;
        store_share<KL>(w, vc);
        store_share<KL>(w + NP, vb);
        if (G) sums[q][0] = y;
        sums[q][M - 2] = dsum;
        sums[q][M - 1] = gsum;
      }
      mbar_arrive(empty0 + 8 * s);  // the stage's ring slot is read
      mbar_arrive(summed0 + 8 * (it & 1));  // this thread's dc and db are in rb
      // 5. Each position's sums over the channel's 4 lanes, left with the
      // position's lane: a reduce-scatter over lane bits 4, then 3.
      float pair[2][M], tot[M];
      {
        const bool hi = grp & 2, lo = grp & 1;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float send = hi ? sums[i][m] : sums[2 + i][m];
            const float keep = hi ? sums[2 + i][m] : sums[i][m];
            pair[i][m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
          }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float send = lo ? pair[0][m] : pair[1][m];
          const float keep = lo ? pair[1][m] : pair[0][m];
          tot[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
      }
      // 6. The channel's gradients at this lane's position.
      if (grp < np) {
        const float dsum = tot[M - 2];
        float dxv = dsum * d, ddt = fmaf(dsum, xv, tot[M - 1]);
        const size_t at = (row + t0 + grp) * p.di + i0 + cb;
        if (G) {
          const float y2 = fmaf(ddv, xv, tot[0]);
          const float dzv = (gin * y2) * (sig * fmaf(zv, 1.f - sig, 1.f));
          dd_acc = fmaf(dy, xv, dd_acc);
          dxv = fmaf(dy, ddv, dxv);
          ddt = ddt * sgt;
          bias_acc += ddt;
          if (valid) narrow(dzv, dzo + at);
        }
        if (valid) {
          narrow(dxv, dxo + at);
          p.ddt[at] = ddt;
        }
      }
      mbar_wait(summed0 + 8 * (it & 1), (it >> 1) & 1);  // every thread's are
      // 7. The tile's sums of the stage over its channels, in a fixed order.
      {
        float mine = 0.f;
        if (o < kSpan * 2 * NP) {
          // Half 1 reads its channels 36..63, then 32..35: rotated by 4
          // channels, its reads fall in other banks than half 0's.
          const float* r = rb + (oq * kTile + hf * (kTile / 2)) * RV + ov;
          const float* r0 = r + 4 * hf * RV;
          const float* r1 = r0 - (kTile / 2) * hf * RV;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int jj = 0; jj < kTile / 2 - 4; ++jj) acc[jj & 3] += r0[jj * RV];
#pragma unroll
          for (int jj = kTile / 2 - 4; jj < kTile / 2; ++jj) acc[jj & 3] += r1[jj * RV];
          mine = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        }
        const float other = __shfl_xor_sync(0xffffffffu, mine, 16);
        if (summer && hf == 0 && oq < np)
          p.part[((row + t0 + oq) * p.tiles + tile) * kValues + pv] = mine + other;
      }
    }
    // The row's own sums over positions: da a lane's states; ddd and
    // d dt_bias over the channel's 4 lanes.
    if (G) {
      dd_acc += __shfl_xor_sync(0xffffffffu, dd_acc, 8);
      dd_acc += __shfl_xor_sync(0xffffffffu, dd_acc, 16);
      bias_acc += __shfl_xor_sync(0xffffffffu, bias_acc, 8);
      bias_acc += __shfl_xor_sync(0xffffffffu, bias_acc, 16);
    }
    if (valid) {
      const size_t i = (size_t)b * p.di + i0 + cb;
#pragma unroll
      for (int kk = 0; kk < KL; ++kk)
        if (k0 + kk < N) p.part_a[i * N + k0 + kk] = da[kk];
      if (G && grp == 0) {
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
    for (int i = 1; i < 4; ++i) mbar_init(base + 16 * kStages + 8 * i, kCompute);
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
      const int k = (int)(e - bt * n);
      const float* q = part + (size_t)bt * tiles * kValues;
      float sc = 0.f, sb = 0.f;
#pragma unroll 8
      for (int tile = 0; tile < tiles; ++tile) {
        sc = __fadd_rn(sc, q[(size_t)tile * kValues + k]);
        sb = __fadd_rn(sb, q[(size_t)tile * kValues + kMaxState + k]);
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
// ddt is the raw dt's gradient.  Scratch: part (B, S, ceil(di / 64), 32),
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
