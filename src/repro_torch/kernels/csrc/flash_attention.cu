// Flash attention forward on Hopper (sm_90a): softmax(Q K^T / sqrt(D)) V.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (Pallas
// body _attn_kernel), and computes what repro/models/layers.py::gqa_chunked
// computes for a prefill call:
//   O[b,h,s,:] = sum_t softmax_t(scale * q[b,h,s,:] . k[b,h/g,t,:]) v[b,h/g,t,:]
// with q rows end-aligned to k (q position s + T - S), an optional causal
// mask (k_pos <= q_pos) and sliding window (k_pos > q_pos - window).  A
// masked logit is -1e30, as in the reference, so a row's masked keys weigh
// nothing once the row has seen one live key.  Query head h reads kv head
// h / kv_group (kv_group = 1 is the Pallas kernel; > 1 is grouped-query
// attention without an expanded copy of k/v).  Each tensor comes with
// element strides for its B, H and S axes (D is contiguous), so callers pass
// (B, H, S, D) or (B, S, H, D) views without a transposed copy.  Inputs f32
// or bf16; q is cast to f32 and then scaled, as the reference promotes it;
// all sums in f32; the output is divided by max(l, 1e-30) and cast to q's
// type (bf16 by round-to-nearest-even, as JAX's astype).
//
// Bound on an H100: operations.  Serving prefill (B=16, H=32, D=64,
// S=T=2048, causal) does 4*B*H*D*(live q-k pairs) = 2.75e11 flops against
// 0.54 GB of q, k, v and o: 0.28 ms at the 989 TFLOP/s bf16 tensor-core
// rate, 0.16 ms of bytes.
//
// Design (simple and right first): one block of 256 threads per (b*h, 64-row
// q tile); the heaviest q tiles (last, under a causal mask) are scheduled
// first.  The block stages its q tile (scaled, f32) in shared memory and
// walks the 64-row k tiles, skipping a tile that the causal or window mask
// rules out for every row of the q tile (the Pallas kernel's liveness test).
// Per tile it stages K, computes the 64x64 scores as a register-tiled
// product (thread (ty, tx) owns rows ty+16i and keys tx+16j), takes the row
// max and sum with shuffles inside each 16-lane row group, rescales its
// running max, normaliser and f32 accumulator, writes the probabilities to
// shared memory, stages V in the buffer K used and accumulates P.V (the
// thread owns rows ty+16i, columns tx+16j).  Row pitches are padded so every
// shared-memory access of a warp is conflict-free or a broadcast.  All
// products are f32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor
// cores), so the kernel cannot come nearer than ~15x to its bf16 bound;
// wgmma/mma.sync tiles and TMA loads are later work.  Head dims up to 256:
// compiled for padded widths 64 and 128 (stablelm's 64, 128) and 256 (any
// other width, e.g. 168); columns past D are zero in shared memory, so
// they add exactly nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16 (ty, tx)
constexpr int kPitchP = kBlockK + 16;  // rows r and r+1 of P start 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {
  long long b, h, s;
};

// Stage rows [row0, row0 + 64) of one (b, h) slice as f32 in s[r * pitch + d],
// times mul; rows past n_rows and columns past D are zero.
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(float* s, const T* __restrict__ src, long long row_stride,
                                           int row0, int n_rows, int D, float mul) {
  constexpr int pitch = DP + 1;
  for (int idx = threadIdx.x; idx < kBlockQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_rows && d < D) x = to_f32(src[row * row_stride + d]) * mul;
    s[r * pitch + d] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int n_heads, int kv_group, int S, int T_len, int D,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal, int window,
                 float scale) {
  constexpr int pitch = DP + 1;  // odd row pitch: a column read hits 16 banks
  constexpr int NJ = DP / 16;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;                     // [64][pitch], scaled q
  float* s_kv = s_q + kBlockQ * pitch;   // [64][pitch], the K tile, then the V tile
  float* s_p = s_kv + kBlockK * pitch;   // [64][kPitchP], probabilities

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads, hk = h / kv_group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int offset = T_len - S;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  stage_tile<T, DP>(s_q, qb, qs.s, q0, S, D, scale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  // Positions of the tile's first and last real q rows.
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + kBlockQ, S) - 1 + offset;
  const int n_kt = (T_len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    if (causal && k0 > q_hi) break;                                 // every key in the future
    if (window > 0 && k0 + kBlockK - 1 <= q_lo - window) continue;  // every key left of the window

    __syncthreads();  // the previous tile's V reads are done
    stage_tile<T, DP>(s_kv, kb, ks.s, k0, T_len, D, 1.f);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_q[(ty + 16 * i) * pitch + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = s_kv[(tx + 16 * j) * pitch + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q0 + r + offset;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        bool live = k_pos < T_len;
        if (causal) live = live && k_pos <= q_pos;
        if (window > 0) live = live && k_pos > q_pos - window;
        if (!live) sc[i][j] = kNegInf;
        row_max = fmaxf(row_max, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        row_sum += p;
        s_p[r * kPitchP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }

    __syncthreads();  // every K read is done and P is written
    stage_tile<T, DP>(s_kv, vb, vs.s, k0, T_len, D, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_p[(ty + 16 * i) * kPitchP + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float x = s_kv[c * pitch + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], x, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) store_as(ob + row * os.s + d, acc[i][jj] / denom);
    }
  }
}

template <typename T, int DP>
int launch_typed(cudaStream_t stream, const void* q, const void* k, const void* v, void* o,
                 int batch, int n_heads, int kv_group, int S, int T_len, int D, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal, int window, float scale) {
  const size_t smem = sizeof(float) * (2 * kBlockQ * (DP + 1) + kBlockQ * kPitchP);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * n_heads, (S + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n_heads, kv_group, S, T_len, D, qs, ks, vs, os,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(cudaStream_t stream, const void* q, const void* k, const void* v, void* o,
                 int batch, int n_heads, int kv_group, int S, int T_len, int D, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal, int window, float scale) {
  if (D <= 64)
    return launch_typed<T, 64>(stream, q, k, v, o, batch, n_heads, kv_group, S, T_len, D, qs, ks,
                               vs, os, causal, window, scale);
  if (D <= 128)
    return launch_typed<T, 128>(stream, q, k, v, o, batch, n_heads, kv_group, S, T_len, D, qs, ks,
                                vs, os, causal, window, scale);
  return launch_typed<T, 256>(stream, q, k, v, o, batch, n_heads, kv_group, S, T_len, D, qs, ks,
                              vs, os, causal, window, scale);
}

}  // namespace

extern "C" int flash_attention_block_q() { return kBlockQ; }
extern "C" int flash_attention_max_head_dim() { return 256; }

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).  Strides are in
// elements, for the B, H and S axes of each tensor; D must be contiguous.
// The caller checks shapes (1 <= D <= 256, S <= T, n_heads % kv_group == 0,
// grid limits).  Returns cudaGetLastError().
extern "C" int flash_attention_launch(int device, void* stream, int dtype, const void* q,
                                      const void* k, const void* v, void* o, int batch,
                                      int n_heads, int kv_group, int S, int T_len, int D,
                                      long long q_sb, long long q_sh, long long q_ss,
                                      long long k_sb, long long k_sh, long long k_ss,
                                      long long v_sb, long long v_sh, long long v_ss,
                                      long long o_sb, long long o_sh, long long o_ss, int causal,
                                      int window, float scale) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_width<float>(st, q, k, v, o, batch, n_heads, kv_group, S, T_len, D, qs, ks, vs,
                               os, causal, window, scale);
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(st, q, k, v, o, batch, n_heads, kv_group, S, T_len, D, qs,
                                       ks, vs, os, causal, window, scale);
  return (int)cudaErrorInvalidValue;
}
