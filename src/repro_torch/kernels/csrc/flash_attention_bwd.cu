// Flash attention backward on Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T * scale) V.
//
// Replaces no Pallas kernel: the reference trains by autodiff of its XLA
// chunk loop, repro/models/layers.py::gqa_chunked, and its Pallas forward
// (repro/kernels/flash_attention.py::flash_attention_pallas) has no
// backward.  This is the gradient XLA derives for gqa_chunked, for the
// port's training path, whose forward is csrc/flash_attention.cu.  From q,
// k, v, the forward's output o, the output's gradient dO and the forward's
// log-sum-exp lse (B, H, S; natural log, f32):
//   P  = exp(scale * Q K^T - lse)       (recomputed, never stored)
//   D  = rowsum(dO o O)                 (bwd_delta)
//   dV = P^T dO                         (bwd_dkdv)
//   dS = P o (dO V^T - D)
//   dK = scale * dS^T Q                 (bwd_dkdv)
//   dQ = scale * dS K                   (bwd_dq)
// with the forward's masks: q rows end-aligned to k (q position s + T - S),
// causal (k_pos <= q_pos), sliding window (k_pos > q_pos - window), and
// grouped kv heads (query head h reads kv head h / kv_group; dK and dV sum
// over the group's query heads).
//
// No float atomics.  bwd_dkdv owns a K/V tile of one kv head and loops over
// the group's query heads and the q tiles in ascending order; bwd_dq owns a
// q tile and loops over the k tiles in ascending order; bwd_delta reduces a
// row in one warp by a fixed shuffle tree.  Every sum runs in a fixed order,
// so reruns give equal bits (the training path's resume check needs them).
//
// Bound on an H100: operations.  The training micro-batch of stablelm-1.6b
// (B=4, H=32, S=T=2048, D=64, causal, bf16) needs 10 * B * H * D flops a
// live query-key pair (dQ, dK, dV, dP and the recomputed S), 1.7e11 flops:
// 0.17 ms at 989 TFLOP/s on the tensor cores, against 0.1 GB of bytes.
//
// Design: the simple SIMT kernel of a first port.  f32 math on the CUDA
// cores (the tensor cores are later work), inputs f32 or bf16, widened to
// f32 as they are staged in shared memory, outputs rounded to the inputs'
// type.  256 threads a block as a 16 x 16 grid (ty, tx); a tile holds TR
// rows (64, and 32 at width 256, where four 64-row f32 tiles would not fit
// in shared memory); a thread owns rows ty + 16 i and columns tx + 16 j of
// the TR x TR score tile and columns tx + 16 j of its accumulator rows.
// Padded row pitches (DP + 1, TR + 16) keep shared memory conflict-free.
// Tiles that the masks rule out for a whole tile pair are skipped; rows past
// S or T and columns past D are staged as zeros.  Each block recomputes the
// scores it needs: bwd_dkdv computes S and dP of each live pair, and bwd_dq
// again (7 products of a tile pair against the 5 the bound counts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 (ty, tx)

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Stage rows [row0, row0 + TR) of one (b, h) slice as f32 in s[r * pitch + d];
// rows past n_rows and columns past D are zero.
template <typename T, int DP, int TR>
__device__ __forceinline__ void stage(float* s, const T* __restrict__ src, long long row_stride,
                                      int row0, int n_rows, int D) {
  constexpr int pitch = DP + 1;
  for (int idx = threadIdx.x; idx < TR * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_rows && d < D) x = widen(src[row * row_stride + d]);
    s[r * pitch + d] = x;
  }
}

// Does the masks' union leave pair (q row, k row) live?
__device__ __forceinline__ bool live(int q_row, int k_row, int S, int T_len, int offset,
                                     int causal, int window) {
  if (q_row >= S || k_row >= T_len) return false;
  const int qp = q_row + offset;
  if (causal && k_row > qp) return false;
  if (window > 0 && k_row <= qp - window) return false;
  return true;
}

// May any pair of q tile [q0, q0 + TR) and k tile [k0, k0 + TR) be live?
__device__ __forceinline__ bool tile_live(int q0, int k0, int TR, int S, int T_len, int offset,
                                          int causal, int window) {
  const int q_lo = q0 + offset, q_hi = min(q0 + TR, S) - 1 + offset;
  const int k_hi = min(k0 + TR, T_len) - 1;
  if (causal && k0 > q_hi) return false;
  if (window > 0 && k_hi <= q_lo - window) return false;
  return true;
}

// D[row] = sum_d dO[row, d] * O[row, d] in f32: one warp a row, a fixed
// shuffle tree.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
          int n_heads, int S, int D, Strides os, Strides ds, long long n_rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int b = (int)(bh / n_heads), h = (int)(bh % n_heads);
  const T* orow = o + b * os.b + h * os.h + s * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + s * ds.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(widen(orow[d]), widen(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Shared-memory layout of both tile kernels: four [TR][DP + 1] tiles, two
// [TR][TR + 16] score tiles, and TR lse and TR D values.
template <int DP, int TR>
struct Smem {
  static constexpr int kPitch = DP + 1;
  static constexpr int kPitchP = TR + 16;
  static constexpr int kTile = TR * kPitch;
  static constexpr int kScore = TR * kPitchP;
  static constexpr int kFloats = 4 * kTile + 2 * kScore + 2 * TR;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// dK and dV of one K/V tile of kv head hk: every query head of its group and
// every live q tile, in ascending order.
template <typename T, int DP, int TR>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int n_heads,
         int kv_group, int S, int T_len, int D, Strides qs, Strides ks, Strides vs, Strides ds,
         Strides dks, Strides dvs, int causal, int window, float scale) {
  using L = Smem<DP, TR>;
  constexpr int RI = TR / 16;  // score rows (keys) and columns (queries) a thread
  constexpr int NJ = DP / 16;  // accumulator columns a thread
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + L::kTile;
  float* s_q = s_v + L::kTile;
  float* s_do = s_q + L::kTile;
  float* s_p = s_do + L::kTile;   // [key][query]
  float* s_ds = s_p + L::kScore;  // [key][query]
  float* s_lse = s_ds + L::kScore;
  float* s_dl = s_lse + TR;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_kv = n_heads / kv_group;
  const int b = blockIdx.x / n_kv, hk = blockIdx.x % n_kv;
  const int k0 = blockIdx.y * TR;
  const int offset = T_len - S;

  stage<T, DP, TR>(s_k, k + b * ks.b + hk * ks.h, ks.s, k0, T_len, D);
  stage<T, DP, TR>(s_v, v + b * vs.b + hk * vs.h, vs.s, k0, T_len, D);

  float acc_k[RI][NJ], acc_v[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qt = (S + TR - 1) / TR;
  for (int g = 0; g < kv_group; ++g) {
    const int h = hk * kv_group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * ds.b + h * ds.h;
    const float* lb = lse + ((long long)b * n_heads + h) * S;
    const float* dlb = delta + ((long long)b * n_heads + h) * S;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * TR;
      if (!tile_live(q0, k0, TR, S, T_len, offset, causal, window)) continue;
      __syncthreads();  // the previous tile's reads of s_q, s_do, s_p and s_ds are done
      stage<T, DP, TR>(s_q, qb, qs.s, q0, S, D);
      stage<T, DP, TR>(s_do, db, ds.s, q0, S, D);
      for (int r = threadIdx.x; r < TR; r += kThreads) {
        const bool in = q0 + r < S;
        s_lse[r] = in ? lb[q0 + r] : 0.f;
        s_dl[r] = in ? dlb[q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T of the tile: keys ty + 16 i, queries tx + 16 j.
      float sc[RI][RI], dp[RI][RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP; ++d) {
        float kk[RI], vv[RI], qq[RI], oo[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kk[i] = s_k[(ty + 16 * i) * L::kPitch + d];
          vv[i] = s_v[(ty + 16 * i) * L::kPitch + d];
          qq[i] = s_q[(tx + 16 * i) * L::kPitch + d];
          oo[i] = s_do[(tx + 16 * i) * L::kPitch + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RI; ++j) {
            sc[i][j] = fmaf(kk[i], qq[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int kr = ty + 16 * i, qc = tx + 16 * j;
          float p = 0.f;
          if (live(q0 + qc, k0 + kr, S, T_len, offset, causal, window))
            p = expf(fmaf(sc[i][j], scale, -s_lse[qc]));
          s_p[kr * L::kPitchP + qc] = p;
          s_ds[kr * L::kPitchP + qc] = p * (dp[i][j] - s_dl[qc]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's queries.
#pragma unroll 4
      for (int c = 0; c < TR; ++c) {
        float pp[RI], ss[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pp[i] = s_p[(ty + 16 * i) * L::kPitchP + c];
          ss[i] = s_ds[(ty + 16 * i) * L::kPitchP + c];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float od = s_do[c * L::kPitch + tx + 16 * j];
          const float qd = s_q[c * L::kPitch + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            acc_v[i][j] = fmaf(pp[i], od, acc_v[i][j]);
            acc_k[i][j] = fmaf(ss[i], qd, acc_k[i][j]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= T_len) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        narrow(dkb + row * dks.s + d, acc_k[i][j] * scale);
        narrow(dvb + row * dvs.s + d, acc_v[i][j]);
      }
    }
  }
}

// dQ of one q tile of head h: every live k tile, in ascending order.
template <typename T, int DP, int TR>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, int n_heads, int kv_group, int S, int T_len, int D, Strides qs,
       Strides ks, Strides vs, Strides ds, Strides dqs, int causal, int window, float scale) {
  using L = Smem<DP, TR>;
  constexpr int RI = TR / 16;
  constexpr int NJ = DP / 16;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + L::kTile;
  float* s_k = s_do + L::kTile;
  float* s_v = s_k + L::kTile;
  float* s_ds = s_v + L::kTile;  // [query][key]
  float* s_lse = s_ds + 2 * L::kScore;
  float* s_dl = s_lse + TR;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads, hk = h / kv_group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TR;  // heaviest (last, under a causal mask) first
  const int offset = T_len - S;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  stage<T, DP, TR>(s_q, q + b * qs.b + h * qs.h, qs.s, q0, S, D);
  stage<T, DP, TR>(s_do, dout + b * ds.b + h * ds.h, ds.s, q0, S, D);
  for (int r = threadIdx.x; r < TR; r += kThreads) {
    const bool in = q0 + r < S;
    s_lse[r] = in ? lse[(long long)bh * S + q0 + r] : 0.f;
    s_dl[r] = in ? delta[(long long)bh * S + q0 + r] : 0.f;
  }

  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_kt = (T_len + TR - 1) / TR;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TR;
    if (!tile_live(q0, k0, TR, S, T_len, offset, causal, window)) continue;
    __syncthreads();  // the previous tile's reads of s_k, s_v and s_ds are done
    stage<T, DP, TR>(s_k, kb, ks.s, k0, T_len, D);
    stage<T, DP, TR>(s_v, vb, vs.s, k0, T_len, D);
    __syncthreads();

    // S and dP of the tile: queries ty + 16 i, keys tx + 16 j.
    float sc[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qq[RI], oo[RI], kk[RI], vv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qq[i] = s_q[(ty + 16 * i) * L::kPitch + d];
        oo[i] = s_do[(ty + 16 * i) * L::kPitch + d];
        kk[i] = s_k[(tx + 16 * i) * L::kPitch + d];
        vv[i] = s_v[(tx + 16 * i) * L::kPitch + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          sc[i][j] = fmaf(qq[i], kk[j], sc[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int qr = ty + 16 * i, kc = tx + 16 * j;
        float ds_ = 0.f;
        if (live(q0 + qr, k0 + kc, S, T_len, offset, causal, window))
          ds_ = expf(fmaf(sc[i][j], scale, -s_lse[qr])) * (dp[i][j] - s_dl[qr]);
        s_ds[qr * L::kPitchP + kc] = ds_;
      }
    __syncthreads();

    // dQ += dS K over the tile's keys.
#pragma unroll 4
    for (int c = 0; c < TR; ++c) {
      float ss[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) ss[i] = s_ds[(ty + 16 * i) * L::kPitchP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kd = s_k[c * L::kPitch + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(ss[i], kd, acc[i][j]);
      }
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) narrow(dqb + row * dqs.s + d, acc[i][j] * scale);
    }
  }
}

int width(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int batch, n_heads, kv_group, S, T_len, D;
  Strides qs, ks, vs, os, ds, dqs, dks, dvs;
  int causal, window;
  float scale;
};

template <typename T, int DP, int TR>
int launch(cudaStream_t stream, const Args& a) {
  using L = Smem<DP, TR>;
  const long long n_rows = (long long)a.batch * a.n_heads * a.S;
  const long long delta_blocks = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  bwd_delta<T><<<(unsigned)delta_blocks, kThreads, 0, stream>>>(
      (const T*)a.o, (const T*)a.dout, a.delta, a.n_heads, a.S, a.D, a.os, a.ds, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(bwd_dkdv<T, DP, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv(a.batch * (a.n_heads / a.kv_group), (a.T_len + TR - 1) / TR);
  bwd_dkdv<T, DP, TR><<<grid_kv, kThreads, L::kBytes, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse, a.delta, (T*)a.dk,
      (T*)a.dv, a.n_heads, a.kv_group, a.S, a.T_len, a.D, a.qs, a.ks, a.vs, a.ds, a.dks, a.dvs,
      a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(bwd_dq<T, DP, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(a.batch * a.n_heads, (a.S + TR - 1) / TR);
  bwd_dq<T, DP, TR><<<grid_q, kThreads, L::kBytes, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse, a.delta, (T*)a.dq,
      a.n_heads, a.kv_group, a.S, a.T_len, a.D, a.qs, a.ks, a.vs, a.ds, a.dqs, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(cudaStream_t stream, const Args& a) {
  switch (width(a.D)) {
    case 64:
      return launch<T, 64, 64>(stream, a);
    case 128:
      return launch<T, 128, 64>(stream, a);
    default:
      return launch<T, 256, 32>(stream, a);
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16, for q, k, v, o, dout, dq, dk and dv alike.
// `strides` holds the element strides of the B, H and S axes of q, k, v, o,
// dout, dq, dk and dv in turn (24 values); D is contiguous in each.  lse and
// delta are contiguous f32 (B, H, S); delta is scratch the call overwrites.
// The caller checks shapes (1 <= D <= 256, S <= T, n_heads % kv_group == 0,
// grid limits).  Three launches on `stream`; returns the first CUDA error.
extern "C" int flash_attention_bwd_launch(int device, void* stream, int dtype, const void* q,
                                          const void* k, const void* v, const void* o,
                                          const void* dout, const float* lse, float* delta,
                                          void* dq, void* dk, void* dv, int batch, int n_heads,
                                          int kv_group, int S, int T_len, int D,
                                          const long long* strides, int causal, int window,
                                          float scale) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{q,     k,      v,        o, dout, lse,   delta, dq,    dk,    dv,    batch,
               n_heads, kv_group, S, T_len, D, st[0], st[1], st[2], st[3], st[4], st[5],
               st[6], st[7], causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? launch_width<__nv_bfloat16>(s, a) : launch_width<float>(s, a);
}
