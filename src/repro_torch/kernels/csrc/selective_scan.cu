// The selective scan of Mamba-1 on Hopper (sm_90a), with mamba_train's
// neighbours folded in.
//
// Replaces no Pallas kernel: it is the body of the reference's mamba_train
// (repro/models/ssm.py:58), whose outer lax.scan walks chunks of 1,024
// positions and whose inner one (`step`, :92) walks the positions of a
// chunk.  For every batch row b and channel i, from h = 0:
//   h[k] = h[k] * exp(dt[b,t,i] * a[i,k]) + (dt[b,t,i] * x[b,t,i]) * bm[b,t,k]
//   ys[b,t,i] = sum over k of h[k] * cm[b,t,k]
// with each product and sum rounded to float32 as the plain version
// (kernels/ref.py::selective_scan_plain) rounds it: no contraction into an
// FMA, and expf (not __expf, not ex2.approx on a pre-scaled argument), so
// the states equal the plain version's bit for bit; y adds its n terms in
// the order k = 0, 1, ... as one fmaf chain (the plain version's einsum
// takes cuBLAS's order), the order the first version of this kernel took,
// so ys is that version's bit for bit.
//
// Two entries launch the one kernel template (its parameter G, gated):
// - selective_scan: dt after the softplus; ys (B, S, di) float32;
// - selective_scan_gated: mamba_train from the einsum's raw dt to the gated
//   output in the model's dtype, as torch's ops at models/ssm.py round it:
//     dt  = max(dt_raw + dt_bias, 0) + log1pf(expf(-|dt_raw + dt_bias|))
//     out = ((ys + dd x) * (z * (1 / (1 + expf(-z))))) cast to x's dtype
//   with expf, log1pf and IEEE division (__fdiv_rn), the functions torch's
//   CUDA kernels for exp, log1p and sigmoid call, and no contraction, so the
//   output equals that composition around the scan-only entry bit for bit.
//   dt and ys never go through device memory as float32 tensors.
//
// Bound on an H100: the bytes of x (2 or 4 a position and channel), dt (4)
// and ys (4) at 3.35 TB/s, against B S di n exponentials at the
// special-function units' 16 a clock per SM (the CUDA C++ Programming
// Guide's throughput table, compute capability 9.0): 4.18e12 a second at
// 1,980 MHz on 132 SMs.  At jamba-1.5-large's width (di 16,384, n 16) the
// exponentials bound it: 1.60 ms of bytes against 2.05 ms of exponentials
// for 16 rows of 2,048 positions.  The gated entry moves x, the raw dt, z
// and the output (10 bytes a position and channel in bf16: 1.60 ms)
// against B S di (n + 2) exponentials (2.31 ms).  The schedulers bound it
// more tightly: expf is 8 instructions (one on the SFU), so a state and
// position costs 13 (its product with a, expf, the two products and the
// sum of h, y's fmaf), and the SASS of the loop over positions holds about
// 235 a position for 16 states (307 gated); at one issue a clock on each
// of an SM's 4 schedulers that is 3.8 ms (4.9 ms gated) at that shape.
//
// Design.  A unit of work is (batch row, tile of kTile channels); the grid
// holds as many blocks as the card keeps resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: 4 a SM, 528 for the
// 2,048 units of that shape, so the last of 4 rounds is 88% full), each
// walking units blockIdx.x, + gridDim.x, ...  A block is kCompute compute
// threads, a thread kPer adjacent channels with their n <= 16 states and
// rows of a in registers (n is a template parameter, 1 to 16, so nothing is
// guarded at run time; ptxas gives 96 registers and no spill at the
// kMinBlocks target), and one producer warp.  The producer fills a ring of
// kStages stages in shared memory, each kSpan positions of the tile's x, dt
// (and, gated, z) and the positions' b and c rows, by 1-D bulk copies
// completing on the stage's mbarrier (or, where a row is not 16-byte
// aligned, by plain loads and one arrival a lane); a unit's rows of a (and
// dd, dt_bias) come the same way into their own buffer.  The compute warps
// wait on a stage's barrier, read b and c as float4 broadcasts, x and dt
// as one load a thread, walk the stage's positions unrolled (one
// position's exponentials issue under the last one's sums), and release the
// stage by an arrival: no __syncthreads, no integer division and no global
// load on the compute warps, whose only device-memory traffic is their
// coalesced stores of y.  One named barrier over the block follows the
// barriers' initialisation.  A second template flag (H) adds the stores of
// the state entering each stage for the backward (selective_scan_bwd.cu):
// a launch that saves no states takes the instance without them, as a
// run-time test of the pointer in the stage loop cost the forward about 1%.
//
// What it reaches and what holds it back (kernels/scan_probe.py
// --selective, PERF.md row 7): about 4.85 ms at that shape, 0.68 of the
// first version's time in turns with it, 78% of the issue floor; gated 6.3
// ms against 32 ms for the ops it replaces.  Without the exponential (a
// multiply in its place) it takes half the time; reading b and c as float4
// broadcasts costs about a ninth (8 loads a position, whose latency the
// 16 warps an SM hide only in part); the copies cost about 3%.  Tried and
// slower: two channels a thread (more registers, fewer warps), 5 or 6
// blocks an SM (fewer registers: less of the loop unrolled into flight),
// 8-position or 2-position stages, a deeper ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxState = 16;  // states a channel (mirrored by selective_scan.py)
constexpr int kPer = 1;        // adjacent channels a compute thread
constexpr int kCompute = 128;  // compute threads a block (4 warps)
constexpr int kThreads = kCompute + 32;  // and the producer warp
constexpr int kTile = kCompute * kPer;   // channels a unit
constexpr int kSpan = 4;       // positions a stage
constexpr int kStages = 4;     // stages in the ring
constexpr int kMinBlocks = 4;  // blocks an SM should hold (ptxas's register target)
static_assert(kSpan < 32, "lane 31 copies a span's b and c rows");

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared memory, in bytes from its base: the barriers (full and empty a
// stage, full and empty of the unit's parameters), the ring (a stage: x
// [kSpan][kTile], dt [kSpan][kTile], z [kSpan][kTile] when gated, b and c
// [kSpan][NP]), then the unit's parameters (a [kTile][N], dd and dt_bias
// [kTile] when gated).
template <int N, typename T, bool G>
struct Layout {
  static constexpr int NP = (N + 3) / 4 * 4;
  static constexpr int xrow = kTile * (int)sizeof(T);
  static constexpr int drow = kTile * 4;
  static constexpr int x_off = 0;
  static constexpr int dt_off = x_off + kSpan * xrow;
  static constexpr int z_off = dt_off + kSpan * drow;
  static constexpr int b_off = z_off + (G ? kSpan * xrow : 0);
  static constexpr int c_off = b_off + kSpan * NP * 4;
  static constexpr int stage = round16(c_off + kSpan * NP * 4);
  static constexpr int ring_off = (16 * kStages + 16 + 127) / 128 * 128;  // after the barriers
  static constexpr int a_off = ring_off + kStages * stage;
  static constexpr int dd_off = a_off + round16(kTile * N * 4);
  static constexpr int bias_off = dd_off + (G ? kTile * 4 : 0);
  static constexpr int bytes = bias_off + (G ? kTile * 4 : 0);
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
  void* out;          // (B, S, di): float32 ys, or T when gated
  float* hsave;       // null, or (B, ceil(S / kSpan), n, di): the state entering each stage
  int seq, di, tiles, units;
  int bulk;           // every copy 16-byte aligned: bulk copies, else plain loads
  int pairs;          // kPer = 2 and di even: stores of two channels at once
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }

// kPer adjacent values from shared memory, widened.
template <typename T>
__device__ __forceinline__ void load_per(const T* p, float (&v)[kPer]) {
  if constexpr (kPer == 2 && sizeof(T) == 4) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = widen(w.x), v[kPer - 1] = widen(w.y);
  } else if constexpr (kPer == 2) {
    const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(w), v[kPer - 1] = __high2float(w);
  } else {
    v[0] = widen(p[0]);
  }
}

// The producer warp: the unit's parameters, then its stages, unit after unit.
template <int N, typename T, bool G>
__device__ void produce(const Args& p, uint8_t* smem) {
  using L = Layout<N, T, G>;
  const int lane = threadIdx.x & 31;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base, empty0 = base + 8 * kStages;
  const uint32_t pfull = base + 16 * kStages, pempty = pfull + 8;
  const T* x = static_cast<const T*>(p.x);
  const T* z = static_cast<const T*>(p.z);
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
    for (int t0 = 0; t0 < p.seq; t0 += kSpan, ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) + 1) & 1);
      const int np = min(kSpan, p.seq - t0);
      const uint32_t full = full0 + 8 * s;
      uint8_t* st = smem + L::ring_off + s * L::stage;
      const uint32_t sst = base + L::ring_off + s * L::stage;
      if (p.bulk) {
        const uint32_t xb = cnt * (int)sizeof(T);
        if (lane == 0) mbar_expect_tx(full, np * (xb + 4 * cnt + (G ? xb : 0) + 8 * N));
        __syncwarp();
        if (lane < np) {  // lane q copies position t0 + q's rows
          const size_t at = (row + t0 + lane) * p.di + i0;
          bulk_load(sst + L::x_off + lane * L::xrow, x + at, xb, full);
          bulk_load(sst + L::dt_off + lane * L::drow, p.dt + at, 4 * cnt, full);
          if (G) bulk_load(sst + L::z_off + lane * L::xrow, z + (row + t0 + lane) * p.z_step + i0,
                           xb, full);
        } else if (lane == 31) {  // the span's b and c rows are contiguous
          bulk_load(sst + L::b_off, p.bm + (row + t0) * N, np * N * 4, full);
          bulk_load(sst + L::c_off, p.cm + (row + t0) * N, np * N * 4, full);
        }
      } else {
        for (int q = 0; q < np; ++q) {
          const size_t at = (row + t0 + q) * p.di + i0;
          T* sx = reinterpret_cast<T*>(st + L::x_off + q * L::xrow);
          float* sd = reinterpret_cast<float*>(st + L::dt_off + q * L::drow);
          for (int e = lane; e < cnt; e += 32) {
            sx[e] = x[at + e];
            sd[e] = p.dt[at + e];
          }
          if (G) {
            T* sz = reinterpret_cast<T*>(st + L::z_off + q * L::xrow);
            for (int e = lane; e < cnt; e += 32) sz[e] = z[(row + t0 + q) * p.z_step + i0 + e];
          }
          for (int k = lane; k < N; k += 32) {
            reinterpret_cast<float*>(st + L::b_off)[q * L::NP + k] = p.bm[(row + t0 + q) * N + k];
            reinterpret_cast<float*>(st + L::c_off)[q * L::NP + k] = p.cm[(row + t0 + q) * N + k];
          }
        }
        mbar_arrive(full);  // one arrival a lane, after its own stores
      }
    }
  }
}

// A compute thread: kPer channels of each unit, position by position; with
// H, also the state entering each stage into p.hsave.
template <int N, typename T, bool G, bool H>
__device__ void consume(const Args& p, uint8_t* smem) {
  using L = Layout<N, T, G>;
  using Out = typename std::conditional<G, T, float>::type;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base, empty0 = base + 8 * kStages;
  const uint32_t pfull = base + 16 * kStages, pempty = pfull + 8;
  const int c0 = threadIdx.x * kPer;  // the thread's first channel in the tile
  Out* out = static_cast<Out*>(p.out);
  int it = 0, j = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++j) {
    const int b = u / p.tiles, i0 = (u - b * p.tiles) * kTile;
    const int cnt = min(kTile, p.di - i0);
    const size_t row = (size_t)b * p.seq;
    float av[kPer][N], h[kPer][N], ddv[kPer], biasv[kPer];
    mbar_wait(pfull, j & 1);
    const float* sa = reinterpret_cast<const float*>(smem + L::a_off) + c0 * N;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        av[q][k] = sa[q * N + k];
        h[q][k] = 0.f;
      }
      ddv[q] = G ? reinterpret_cast<const float*>(smem + L::dd_off)[c0 + q] : 0.f;
      biasv[q] = G ? reinterpret_cast<const float*>(smem + L::bias_off)[c0 + q] : 0.f;
    }
    mbar_arrive(pempty);
    Out* o = out + row * p.di + i0 + c0;  // position t0 + q's output, advanced a position at a time
    for (int t0 = 0; t0 < p.seq; t0 += kSpan, ++it) {
      const int s = it % kStages;
      if constexpr (H) {  // the backward's residual: the state entering this stage
        const int nst = (p.seq + kSpan - 1) / kSpan;
        float* hq = p.hsave + ((size_t)b * nst + t0 / kSpan) * N * p.di + i0 + c0;
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          if (c0 + e < cnt) {
#pragma unroll
            for (int k = 0; k < N; ++k) hq[(size_t)k * p.di + e] = h[e][k];
          }
      }
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const int np = min(kSpan, p.seq - t0);
      const uint8_t* st = smem + L::ring_off + s * L::stage;
      // Unrolled, so the exponentials of one position can issue under the
      // sums of the one before.
#pragma unroll
      for (int q = 0; q < kSpan; ++q) {
        if (q >= np) break;
        float d[kPer], xv[kPer], dx[kPer], y[kPer];
        load_per(reinterpret_cast<const float*>(st + L::dt_off + q * L::drow) + c0, d);
        load_per(reinterpret_cast<const T*>(st + L::x_off + q * L::xrow) + c0, xv);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          if (G) {  // ref.softplus of dt_raw + dt_bias
            const float t = __fadd_rn(d[e], biasv[e]);
            d[e] = __fadd_rn(fmaxf(t, 0.f), log1pf(expf(-fabsf(t))));
          }
          dx[e] = __fmul_rn(d[e], xv[e]);
          y[e] = 0.f;
        }
        const float4* sb = reinterpret_cast<const float4*>(st + L::b_off + q * L::NP * 4);
        const float4* sc = reinterpret_cast<const float4*>(st + L::c_off + q * L::NP * 4);
#pragma unroll
        for (int k4 = 0; k4 < L::NP / 4; ++k4) {
          const float4 b4 = sb[k4], c4 = sc[k4];
          const float bk[4] = {b4.x, b4.y, b4.z, b4.w}, ck[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = 4 * k4 + kk;
            if (k < N) {
#pragma unroll
              for (int e = 0; e < kPer; ++e) {
                const float decay = expf(__fmul_rn(d[e], av[e][k]));
                h[e][k] = __fadd_rn(__fmul_rn(h[e][k], decay), __fmul_rn(dx[e], bk[kk]));
                y[e] = fmaf(h[e][k], ck[kk], y[e]);
              }
            }
          }
        }
        if (G) {  // skip, gate and cast, as models/ssm.py's torch ops round them
          float zv[kPer];
          load_per(reinterpret_cast<const T*>(st + L::z_off + q * L::xrow) + c0, zv);
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-zv[e])));
            y[e] = __fmul_rn(__fadd_rn(y[e], __fmul_rn(ddv[e], xv[e])), __fmul_rn(zv[e], sig));
          }
        }
        if (kPer == 2 && p.pairs && c0 + 1 < cnt) {
          if constexpr (G && sizeof(T) == 2) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y[0], y[kPer - 1]);
          } else {
            *reinterpret_cast<float2*>(o) = make_float2(y[0], y[kPer - 1]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            if (c0 + e < cnt) narrow(y[e], o + e);
        }
        o += p.di;
      }
      mbar_arrive(empty0 + 8 * s);
    }
  }
}

template <int N, typename T, bool G, bool H>
__global__ void __launch_bounds__(kThreads, kMinBlocks) scan_kernel(const Args p) {
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
    consume<N, T, G, H>(p, smem);
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
template <int N, typename T, bool G, bool H>
cudaError_t resident(int device, int* blocks) {
  static int cached[kMaxDevices] = {0};
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  const int bytes = Layout<N, T, G>::bytes;
  cudaError_t err = cudaFuncSetAttribute(scan_kernel<N, T, G, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, scan_kernel<N, T, G, H>, kThreads,
                                                      bytes);
  if (err != cudaSuccess) return err;
  if (*blocks < 1) return cudaErrorInvalidConfiguration;
  if (device >= 0 && device < kMaxDevices) cached[device] = *blocks;
  return cudaSuccess;
}

template <int N, typename T, bool G, bool H>
cudaError_t launch_n(int device, cudaStream_t stream, Args p, int batch) {
  int blocks = 0, sms = 0;
  cudaError_t err = resident<N, T, G, H>(device, &blocks);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  p.tiles = (p.di + kTile - 1) / kTile;
  p.units = batch * p.tiles;
  const int grid = min(p.units, blocks * sms);
  scan_kernel<N, T, G, H><<<grid, kThreads, Layout<N, T, G>::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int N, typename T, bool G, bool H>
cudaError_t query_n(int device, int* out) {
  cudaError_t err = resident<N, T, G, H>(device, &out[0]);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, device);
  out[2] = Layout<N, T, G>::bytes;
  out[3] = kThreads;
  out[4] = kTile;
  return err;
}

// F(N, T, G, H, args...) for the instance of n states.
#define SCAN_DISPATCH(F, n, T, G, H, ...)                    \
  switch (n) {                                               \
    case 1: return F<1, T, G, H>(__VA_ARGS__);               \
    case 2: return F<2, T, G, H>(__VA_ARGS__);               \
    case 3: return F<3, T, G, H>(__VA_ARGS__);               \
    case 4: return F<4, T, G, H>(__VA_ARGS__);               \
    case 5: return F<5, T, G, H>(__VA_ARGS__);               \
    case 6: return F<6, T, G, H>(__VA_ARGS__);               \
    case 7: return F<7, T, G, H>(__VA_ARGS__);               \
    case 8: return F<8, T, G, H>(__VA_ARGS__);               \
    case 9: return F<9, T, G, H>(__VA_ARGS__);               \
    case 10: return F<10, T, G, H>(__VA_ARGS__);             \
    case 11: return F<11, T, G, H>(__VA_ARGS__);             \
    case 12: return F<12, T, G, H>(__VA_ARGS__);             \
    case 13: return F<13, T, G, H>(__VA_ARGS__);             \
    case 14: return F<14, T, G, H>(__VA_ARGS__);             \
    case 15: return F<15, T, G, H>(__VA_ARGS__);             \
    case 16: return F<16, T, G, H>(__VA_ARGS__);             \
    default: return cudaErrorInvalidValue;                   \
  }

// A probe's build (-DSCAN_ONE_STATE_COUNT=16) compiles only that instance.
#ifdef SCAN_ONE_STATE_COUNT
#define SCAN_STATES(F, n, T, G, H, ...) \
  return n == SCAN_ONE_STATE_COUNT ? F<SCAN_ONE_STATE_COUNT, T, G, H>(__VA_ARGS__) : cudaErrorInvalidValue;
#else
#define SCAN_STATES(F, n, T, G, H, ...) SCAN_DISPATCH(F, n, T, G, H, __VA_ARGS__)
#endif

template <typename T, bool G>
cudaError_t launch_t(int device, cudaStream_t stream, const Args& p, int batch, int n) {
  if (p.hsave) {
    SCAN_STATES(launch_n, n, T, G, true, device, stream, p, batch)
  }
  SCAN_STATES(launch_n, n, T, G, false, device, stream, p, batch)
}

// The plan of the instance that saves no states (the saving one shares its
// layout).
template <typename T, bool G>
cudaError_t query_t(int device, int n, int* out) {
  SCAN_STATES(query_n, n, T, G, false, device, out)
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (B, S, di) float32 (x_dtype 0) or bfloat16 (1); dt (B, S, di), a (di, n),
// bm and cm (B, S, n) float32; all contiguous.  gated 0: dt after the
// softplus, out the float32 ys (B, S, di); z, z_step, dt_bias and dd unused.
// gated 1: dt raw, dt_bias and dd (di) float32, z (B, S, di) in x's dtype
// with its position rows z_step elements apart (a view of the in_proj
// output), out (B, S, di) in x's dtype.  hsave null, or (B, ceil(S / 4),
// n, di) float32 for the state entering every stage of kSpan = 4 positions
// (the backward's residual, written by the instances compiled with H; the
// outputs are the same bits either way).
// 1 <= n <= kMaxState, B <= 65,535.  Returns the launch's error
// (cudaGetLastError()).
extern "C" int selective_scan_launch(int device, void* stream, int x_dtype, int gated,
                                     const void* x, const void* z, long long z_step,
                                     const float* dt, const float* dt_bias, const float* a,
                                     const float* bm, const float* cm, const float* dd,
                                     void* out, float* hsave, int batch, int seq, int di,
                                     int n) {
  if (n < 1 || n > kMaxState || batch < 1 || batch > 65535 || seq < 1 || di < 1 ||
      (x_dtype & ~1) || (gated & ~1) || (gated && z_step < di))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int xs = x_dtype ? 2 : 4;
  Args p{x, z, z_step, dt, dt_bias, a, bm, cm, dd, out, hsave, seq, di, 0, 0, 0, 0};
  // Bulk copies need 16-byte aligned sources and lengths: every row of x, dt
  // and z, the tile's share of a, dd and dt_bias, and a span's b and c.
  p.bulk = aligned(x) && aligned(dt) && aligned(a) && aligned(bm) && aligned(cm) &&
           (di * xs) % 16 == 0 && di % 4 == 0 && n % 4 == 0 &&
           (!gated || (aligned(z) && aligned(dt_bias) && aligned(dd) && (z_step * xs) % 16 == 0));
  p.pairs = kPer == 2 && di % 2 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0) {
    err = gated ? launch_t<float, true>(device, s, p, batch, n)
                : launch_t<float, false>(device, s, p, batch, n);
  } else {
    err = gated ? launch_t<__nv_bfloat16, true>(device, s, p, batch, n)
                : launch_t<__nv_bfloat16, false>(device, s, p, batch, n);
  }
  return (int)err;
}

// The launch plan of one instance: out[0] blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] the SMs, out[2]
// the dynamic shared memory of a block, out[3] its threads, out[4] the
// channels of a unit.  Returns a CUDA error code.
extern "C" int selective_scan_occupancy(int device, int x_dtype, int gated, int n, int* out) {
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
