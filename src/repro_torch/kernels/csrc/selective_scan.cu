// The selective scan of Mamba-1 on Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the body of the reference's mamba_train
// (repro/models/ssm.py:58), whose outer lax.scan walks chunks of 1,024
// positions and whose inner one (`step`, :92) walks the positions of a
// chunk.  For every batch row b and channel i, from h = 0:
//   h[k] = h[k] * exp(dt[b,t,i] * a[i,k]) + (dt[b,t,i] * x[b,t,i]) * bm[b,t,k]
//   ys[b,t,i] = sum over k of h[k] * cm[b,t,k]
// with each product and sum rounded to float32 as the plain version
// (kernels/ref.py::selective_scan_plain) rounds it: no contraction into an
// FMA, and expf (not __expf), so the states equal the plain version's bit
// for bit; y adds its n terms in the order k = 0, 1, ... (by fmaf), where
// the plain version's einsum takes cuBLAS's order.
//
// Bound on an H100: the bytes of x (2 or 4 a position and channel), dt
// (4) and ys (4) at 3.35 TB/s, against B S di n exponentials at the
// special-function units' 16 a clock per SM (the CUDA C++ Programming
// Guide's throughput table, compute capability 9.0): 4.18e12 a second at
// 1,980 MHz on 132 SMs.  At jamba-1.5-large's width (di 16,384, n 16) the
// exponentials bound it: 1.6 ms of bytes against 2.1 ms of exponentials
// for 16 rows of 2,048 positions.
//
// Design (simple first): a thread owns one (b, i) channel and keeps its n
// states and its row of a in registers (n <= kMaxState, unrolled and
// guarded), and walks the positions in order, reading x and dt one
// position ahead of the one it computes.  A block is kThreads consecutive
// channels of one batch row, so its loads and stores of a position are
// coalesced; the position's b and c rows, which every thread of the block
// reads, are staged in shared memory kSteps positions at a time.  The
// reference's chunking only bounds memory (the state crosses chunks
// unchanged), so no (B, chunk, di, n) tensor exists here and one launch
// walks all S positions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kMaxState = 16;  // states a channel (mirrored by selective_scan.py)
constexpr int kSteps = 64;     // positions of b and c staged a round

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, float* __restrict__ ys, int seq, int di, int n) {
  __shared__ float sb[kSteps][kMaxState];
  __shared__ float sc[kSteps][kMaxState];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < di;
  float av[kMaxState], h[kMaxState];
#pragma unroll
  for (int k = 0; k < kMaxState; ++k) {
    av[k] = (live && k < n) ? a[(size_t)i * n + k] : 0.f;
    h[k] = 0.f;
  }
  const size_t row = (size_t)b * seq;
  // The next position's dt and x, loaded while this one computes.
  size_t at = row * di + i;
  float d_next = live ? dt[at] : 0.f;
  float x_next = live ? widen(x[at]) : 0.f;
  for (int t0 = 0; t0 < seq; t0 += kSteps) {
    const int steps = min(kSteps, seq - t0);
    __syncthreads();  // every thread is done with the last round's rows
    for (int e = threadIdx.x; e < steps * n; e += kThreads) {
      const int t = e / n, k = e - t * n;
      sb[t][k] = bm[(row + t0 + t) * n + k];
      sc[t][k] = cm[(row + t0 + t) * n + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t, at += di) {
      const float d = d_next, xv = x_next;
      if (t0 + t + 1 < seq) {
        d_next = dt[at + di];
        x_next = widen(x[at + di]);
      }
      const float dx = __fmul_rn(d, xv);
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxState; ++k) {
        if (k < n) {
          const float decay = expf(__fmul_rn(d, av[k]));
          h[k] = __fadd_rn(__fmul_rn(h[k], decay), __fmul_rn(dx, sb[t][k]));
          y = fmaf(h[k], sc[t][k], y);
        }
      }
      ys[at] = y;
    }
  }
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// x (B, S, di) float32 (x_dtype 0) or bfloat16 (1); dt (B, S, di), a (di,
// n), bm and cm (B, S, n) float32; ys (B, S, di) float32; all contiguous.
// 1 <= n <= kMaxState, B <= 65,535.  Returns cudaGetLastError().
extern "C" int selective_scan_launch(int device, void* stream, int x_dtype, const void* x,
                                     const float* dt, const float* a, const float* bm,
                                     const float* cm, float* ys, int batch, int seq, int di,
                                     int n) {
  if (n < 1 || n > kMaxState || batch < 1 || batch > 65535 || seq < 1 || di < 1 ||
      (x_dtype & ~1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  if (x_dtype == 0) {
    scan_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, dt, a, bm, cm, ys, seq, di, n);
  } else {
    scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, dt, a, bm, cm, ys, seq, di, n);
  }
  return (int)cudaGetLastError();
}
