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
//   D  = rowsum(dO o O)
//   dV = P^T dO
//   dS = P o (dO V^T - D)
//   dK = scale * dS^T Q
//   dQ = scale * dS K
// with the forward's masks: q rows end-aligned to k (q position s + T - S),
// causal (k_pos <= q_pos), sliding window (k_pos > q_pos - window), and
// grouped kv heads (query head h reads kv head h / kv_group; dK and dV sum
// over the group's query heads).  Any (B, H, S) strides, D contiguous.
//
// No float atomics, in either path: one block owns a K/V tile of one kv
// head and loops over the group's query heads and the q tiles in ascending
// order (dK, dV); one block owns a q tile and loops over the k tiles in
// ascending order (dQ); D reduces a row by a fixed shuffle tree.  Every sum
// runs in a fixed order, so reruns give equal bits (the training path's
// resume check needs them).  The path is chosen by dtype, in the wrapper
// and here; neither kernel is a fallback for the other.
//
// Bound on an H100: operations.  The training micro-batch of stablelm-1.6b
// (B=4, H=32, S=T=2048, D=64, causal, bf16) has 2.1e6 live query-key pairs a
// head.  The five products of the algorithm (S, dP, dV, dK, dQ) are 10 B H D
// flops a live pair, 1.7e11 flops: 0.174 ms at 989 TFLOP/s on the tensor
// cores, against 0.1 GB of bytes (0.03 ms).  The two kernels below compute S
// and dP twice (once for dK and dV, once for dQ): 7 products, 0.243 ms; 8
// at widths above 128, where dV and dK take two passes.
//
// bfloat16 (bwd_prep_tc, bwd_dkdv_tc, bwd_dq_tc; the training path): every
// product on the tensor cores with wgmma, bf16 operands, f32 accumulators.
//   bwd_prep_tc writes D and lse * log2(e) of each (b, h) row, padded with
//   zeros to a multiple of kRowPad rows, so the tile kernels fetch a q tile's
//   values by one aligned bulk copy.
//   bwd_dkdv_tc: a block owns 128 keys of one kv head: two consumer
//   warpgroups of 64 keys and a producer warpgroup that hands its registers
//   to them (setmaxnreg 40 / 232).  One producer thread loads the K and V
//   tile once by TMA, 128-byte swizzled, then streams Q, dO, lse*log2(e) and
//   D of each live q tile (the group's query heads in turn, the q tiles
//   ascending) through a ring of two stages.  A consumer computes
//   S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major in shared
//   memory), then in registers P^T = exp2(S^T scale log2(e) - lse log2(e))
//   (ex2.approx.ftz, as the forward) and dS^T = P^T o (dP^T - D), lse and D
//   per column.  It rounds P^T and dS^T to bf16 in registers: the wgmma
//   accumulator layout is the A-fragment layout, so they feed
//   dV += P^T dO and dK += dS^T Q straight from registers, with dO and Q
//   MN-major B operands (the transpose bit).  Computing S^T rather than S
//   is what keeps P^T and dS^T out of shared memory.
//   bwd_dq_tc is the forward's loop with one more product: a block owns 128
//   q rows of one head (two warpgroups of 64), loads Q, dO, lse and D once,
//   streams K and V through the ring, and computes S = Q K^T, dP = dO V^T,
//   P and dS in registers, then dQ += dS K (K MN-major).
//   In both, the two consumer warpgroups take turns to issue their score
//   products (named barriers, FlashAttention-3's ping-pong), so the tensor
//   cores work on one warpgroup's while the other computes its exps.
//   Widths: D is padded to 64, 128, 192 or 256 (gemma3's 168 runs at 192);
//   columns past D arrive as zeros from TMA's out-of-bounds fill, rows past
//   S or T too, and the mask rules those pairs out.  Up to 128 the dK and
//   dV accumulators of a 64-key warpgroup (32 + 32 or 64 + 64 registers a
//   thread) fit beside S^T and dP^T, and one pass computes both.  Above 128
//   they do not (96 + 96 or 128 + 128), so the q loop runs twice: dV (S^T
//   and P^T only) and then dK (S^T, dP^T, dS^T).  The alternative, D split
//   between the two warpgroups, would have each compute S^T and dP^T of the
//   same keys again.  The q tile a stage is 64 rows, 32 at width 256, and
//   the k tile of bwd_dq_tc 128 rows at width 64, 64 at 128 and 192 and 32
//   at 256, so that each kernel's tiles fit its 227 KB of shared memory and
//   its accumulators the 232 registers a consumer thread has (the plan,
//   mirrored by kernels/flash_attention.py::bwd_plan; ptxas spills 44 bytes
//   in bwd_dq_tc at width 64 and none elsewhere).
//   Masks: only a warpgroup's tile that may hold a dead pair (it straddles
//   the causal diagonal, the window edge, S or T) evaluates the mask; tile
//   pairs with no live pair are skipped, and a warpgroup whose half of a
//   live tile pair is all dead skips its products.  Blocks take the heaviest
//   work first (under a causal mask key tile 0 sees every q tile, the last q
//   tile every k tile), eight (b, kv head) at a time so that their Q and dO
//   stay in L2.
//   TMA needs 16-byte-aligned bases and strides: the wrapper copies a view
//   of q, k, v or dO that fails this (the training path's views pass).
//
// What it reaches (kernels/flash_probe.py --paired and --bwd, chip_smoke.py
// phase 2; an H100 SXM at 700 W): about 0.75 ms of device time at the
// training micro-batch (prep 0.03, dK/dV 0.42, dQ 0.30), 14x faster than
// the SIMT kernel it replaced, 4.3x the 5-product bound and 3.1x the
// 7-product one; a call's CUDA-event time, 0.83-0.89 ms, is 1.2x torch's
// SDPA backward's in the same run (0.70-0.75 ms).  1.5 ms at internlm2's
// D=128 GQA (29x faster), 0.93 ms at gemma3's window (39x).  What still
// holds it back: the work around the products.  With every product
// removed, the loops still take 0.19 ms (dK/dV) and 0.13 ms (dQ) there:
// each tile's descriptors, exps, dS, packing, the mask's branches on edge
// tiles and barriers, at two consumer warps a scheduler, issued in series
// with the products inside a warpgroup.
// Removing the exps alone saves 2-15% of a kernel, the q-tile loads 2-7%.
// Software-pipelining a warpgroup (a tile's scores issued with the previous
// tile's dV/dK or dQ products, three stages) measured slower, 0.99 ms, so
// the loop stays in order and only the two warpgroups overlap.
//
// float32 (bwd_delta, bwd_dkdv, bwd_dq; the f32 parity surface, TF32 stays
// off): the SIMT kernel of the first port.  f32 math on the CUDA cores.  256
// threads a block as a 16 x 16 grid (ty, tx); a tile holds TR rows (64, and
// 32 at width 256); a thread owns rows ty + 16 i and columns tx + 16 j of the
// TR x TR score tile and columns tx + 16 j of its accumulator rows.  Padded
// row pitches (DP + 1, TR + 16) keep shared memory conflict-free.  Tiles
// that the masks rule out for a whole tile pair are skipped; rows past S or
// T and columns past D are staged as zeros.  bwd_dkdv and bwd_dq each
// compute S and dP of each live pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 (ty, tx)

using flash::Strides;

// The SIMT kernels are instantiated for float only (bf16 takes the tc path).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }

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


// ===========================================================================
// bfloat16: the tensor-core kernels
// ===========================================================================

namespace tc {

using namespace hopper;
using namespace flash;

constexpr int kConsumers = 2;                     // warpgroups of 64 rows each
constexpr int kRows = 64 * kConsumers;            // keys (dK, dV) or q rows (dQ) a block
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kProducerRegs = 40;                 // setmaxnreg: the producer gives
constexpr int kConsumerRegs = 232;                // registers to the consumers
constexpr int kStages = 2;                        // ring depth
constexpr int kHeadGroup = 8;                     // (b, head) whose blocks run together
constexpr int kRowPad = 128;                      // lse and D rows padded to a multiple
constexpr float kLog2e = 1.4426950408889634f;

// Ping-pong: consumer warpgroup wg issues a tile's score products only after
// the other one issued its own for the tile before, so the tensor cores run
// one warpgroup's products while the other computes its exps
// (FlashAttention-3's warp-group scheduling).  Both warpgroups take every
// turn, live or not, so neither waits for a turn the other never gives.
__device__ __forceinline__ void turn_begin(int wg) { named_bar_sync(1 + wg, 256); }
__device__ __forceinline__ void turn_end(int wg) { named_bar_arrive(2 - wg, 256); }
// Warpgroup 0 takes the first turn; its last wait balances the barriers.
__device__ __forceinline__ void turns_open(int wg) {
  if (wg == 1) named_bar_arrive(1, 256);
}
__device__ __forceinline__ void turns_close(int wg) {
  if (wg == 0) named_bar_sync(1, 256);
}

int width(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256; }

// The plan of a padded width (kernels/flash_attention.py::bwd_plan).
template <int DP>
struct Plan {
  static constexpr int kChunks = DP / 64;            // 64-column (128-byte) swizzle atoms a row
  static constexpr int kPasses = DP <= 128 ? 1 : 2;  // bwd_dkdv_tc's q loops: dV and dK, or apart
  static constexpr int kBM = DP == 256 ? 32 : 64;    // bwd_dkdv_tc: q rows a stage
  static constexpr int kBN = DP == 64 ? 128 : DP == 256 ? 32 : 64;  // bwd_dq_tc: k rows a stage
};

template <int DP>
struct DkdvSmem {
  static constexpr int kKV = kRows * DP * 2;         // the K or the V tile
  static constexpr int kQ = Plan<DP>::kBM * DP * 2;  // a stage's Q or dO
  static constexpr int kRowBytes = Plan<DP>::kBM * 4;
  static constexpr int kRowsOff = 2 * kKV + kStages * 2 * kQ;  // per stage lse2, then D
  static constexpr int kBarOff = kRowsOff + kStages * 2 * kRowBytes;
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int DP>
struct DqSmem {
  static constexpr int kQ = kRows * DP * 2;          // Q or dO
  static constexpr int kKV = Plan<DP>::kBN * DP * 2;  // a stage's K or V
  static constexpr int kRowsOff = 2 * kQ + kStages * 2 * kKV;  // lse2, then D
  static constexpr int kBarOff = kRowsOff + 2 * kRows * 4;
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

// May any pair of q rows [q0, q0 + q_rows) and keys [k0, k0 + k_rows) be live?
__device__ __forceinline__ bool pair_live(int q0, int q_rows, int k0, int k_rows, int S,
                                          int T_len, int offset, int causal, int window) {
  if (q0 >= S || k0 >= T_len) return false;
  const int q_lo = q0 + offset, q_hi = min(q0 + q_rows, S) - 1 + offset;
  const int k_hi = min(k0 + k_rows, T_len) - 1;
  if (causal && k0 > q_hi) return false;
  if (window > 0 && k_hi <= q_lo - window) return false;
  return true;
}

// May any pair of them be dead (the mask must be evaluated)?
__device__ __forceinline__ bool pair_masked(int q0, int q_rows, int k0, int k_rows, int S,
                                            int T_len, int offset, int causal, int window) {
  return q0 + q_rows > S || k0 + k_rows > T_len ||
         (causal && k0 + k_rows - 1 > q0 + offset) ||
         (window > 0 && k0 <= q0 + q_rows - 1 + offset - window);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, a, b, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, a, b, scale_d);
  else
    wgmma_ss_n32(d, a, b, scale_d);
}

// d[64 x N] = A B^T over DP columns: A the 64 rows at `a` of a tile of AR
// rows, B a tile of N rows, both [chunk][rows][128 B] and K-major: 32 bytes
// along a 128-byte row a k-step, then the next 64-column chunk.
template <int DP, int N, int AR>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_ss<N>(d, desc_sw128(a + (ks / 4) * AR * 128 + (ks % 4) * 32, 16, 1024),
                desc_sw128(b + (ks / 4) * N * 128 + (ks % 4) * 32, 16, 1024), ks > 0);
}

// acc[64 x DP] += A[64 x KR] B[KR x DP]: A in registers (bf16 pairs in the
// accumulator layout), B a tile of KR rows, [chunk][KR rows][128 B], read
// MN-major: 16 rows (two 8-row atoms, 2,048 bytes) a k-step, one m64n64k16
// per 64-column chunk.
template <int DP, int KR>
__device__ __forceinline__ void issue_rs(float (&acc)[DP / 64][32],
                                         const uint32_t (&a)[KR / 16][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KR / 16; ++kk)
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      wgmma_rs_n64(acc[c], a[kk], desc_sw128(b + c * KR * 128 + kk * 2048, 1024, 1024));
}

// An accumulator [64 x N] in bf16 A fragments: k-step kk takes the 8-column
// groups 2 kk and 2 kk + 1.
template <int N>
__device__ __forceinline__ void pack(const float (&x)[N / 2], uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    f[j / 2][(j % 2) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    f[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) fence_reg(x[e]);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&x)[N][32]) {
#pragma unroll
  for (int c = 0; c < N; ++c) fence_all(x[c]);
}

template <int N>
__device__ __forceinline__ void fence_all(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(x[kk][e]);
}

// Rows row_a and row_a + 8 (of n_rows) of a [64 x DP] accumulator times
// `mul`, in bf16, columns past D dropped.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride, int row_a,
                                           int n_rows, const float (&acc)[DP / 64][32],
                                           float mul, int D, int c_thr) {
  const bool pairs = (D % 2) == 0;
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + c_thr;
      if (row_a < n_rows)
        store_pair(base + row_a * row_stride, col, D, pairs, acc[c][4 * j] * mul,
                   acc[c][4 * j + 1] * mul);
      if (row_a + 8 < n_rows)
        store_pair(base + (row_a + 8) * row_stride, col, D, pairs, acc[c][4 * j + 2] * mul,
                   acc[c][4 * j + 3] * mul);
    }
}

// lse * log2(e) and D of every row of every (b, h), zero on the padding rows
// S <= s < S_pad: 8 lanes a row, each summing columns 64 i + 8 l + j (j
// ascending, then i), then a shuffle tree; by 16-byte loads where every row
// is 16-byte aligned, else one element at a time in the same order.
__global__ void __launch_bounds__(256)
bwd_prep_tc(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ delta,
            int n_heads, int S, int S_pad, int D, Strides os, Strides ds, long long n_rows,
            int vec) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int l8 = threadIdx.x % 8;
  const long long bh = row / S_pad;
  const int s = (int)(row - bh * S_pad);
  const bool real = row < n_rows && s < S;
  float acc = 0.f;
  if (real) {
    const int b = (int)(bh / n_heads), h = (int)(bh % n_heads);
    const __nv_bfloat16* orow = o + b * os.b + h * os.h + s * os.s;
    const __nv_bfloat16* drow = dout + b * ds.b + h * ds.h + s * ds.s;
    for (int d0 = 8 * l8; d0 < D; d0 += 64) {
      if (vec) {
        const uint4 xo = *reinterpret_cast<const uint4*>(orow + d0);
        const uint4 xd = *reinterpret_cast<const uint4*>(drow + d0);
        const __nv_bfloat16* po = reinterpret_cast<const __nv_bfloat16*>(&xo);
        const __nv_bfloat16* pd = reinterpret_cast<const __nv_bfloat16*>(&xd);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc = fmaf(__bfloat162float(po[j]), __bfloat162float(pd[j]), acc);
      } else {
        for (int j = 0; j < 8 && d0 + j < D; ++j)
          acc = fmaf(__bfloat162float(orow[d0 + j]), __bfloat162float(drow[d0 + j]), acc);
      }
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && l8 == 0) {
    delta[row] = real ? acc : 0.f;
    lse2[row] = real ? lse[bh * S + s] * kLog2e : 0.f;
  }
}

// P (or P^T) of a [64 x N] score accumulator in place: exp2(x scale_log2 -
// lse2), zero where the mask rules the pair out.  Element e of 8-column group
// j is at row row_a (+8 for e >= 2), column 8 j + c_thr (+1 for odd e); lse2
// is per row (`kPerColumn` false: la, lb) or per column (true: from `col`, a
// shared-memory array).  `live(row, col)` is called only when kMasked.
template <int N, bool kMasked, bool kPerColumn, typename Live>
__device__ __forceinline__ void probs_tile(float (&x)[N / 2], float scale_log2, float la, float lb,
                                      const float* col, int c_thr, Live live) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float l0 = la, l1 = la, l2 = lb, l3 = lb;
    if constexpr (kPerColumn) {
      const float2 lc = *reinterpret_cast<const float2*>(col + 8 * j + c_thr);
      l0 = l2 = lc.x;
      l1 = l3 = lc.y;
    }
    const float l[4] = {l0, l1, l2, l3};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(fmaf(x[4 * j + e], scale_log2, -l[e]));
      if constexpr (kMasked) {
        if (!live(e >= 2 ? 8 : 0, 8 * j + c_thr + (e & 1))) p = 0.f;
      }
      x[4 * j + e] = p;
    }
  }
}

template <int N, bool kPerColumn, typename Live>
__device__ __forceinline__ void probs(bool masked, float (&x)[N / 2], float scale_log2, float la,
                                      float lb, const float* col, int c_thr, Live live) {
  if (masked)
    probs_tile<N, true, kPerColumn>(x, scale_log2, la, lb, col, c_thr, live);
  else
    probs_tile<N, false, kPerColumn>(x, scale_log2, la, lb, col, c_thr, live);
}

// dS (or dS^T) = P o (dP - D) in place in dp, D per row or per column.
template <int N, bool kPerColumn>
__device__ __forceinline__ void dscores(const float (&p)[N / 2], float (&dp)[N / 2], float da,
                                        float db, const float* col, int c_thr) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float d0 = da, d1 = da, d2 = db, d3 = db;
    if constexpr (kPerColumn) {
      const float2 dc = *reinterpret_cast<const float2*>(col + 8 * j + c_thr);
      d0 = d2 = dc.x;
      d1 = d3 = dc.y;
    }
    dp[4 * j] = p[4 * j] * (dp[4 * j] - d0);
    dp[4 * j + 1] = p[4 * j + 1] * (dp[4 * j + 1] - d1);
    dp[4 * j + 2] = p[4 * j + 2] * (dp[4 * j + 2] - d2);
    dp[4 * j + 3] = p[4 * j + 3] * (dp[4 * j + 3] - d3);
  }
}

struct Shape {
  int n_heads, kv_group, S, S_pad, T_len, D, causal, window;
  float scale, scale_log2;
};

// What a consumer warpgroup of bwd_dkdv_tc needs to walk its q loop.
struct DkdvCtx {
  uint32_t base, k_wg, v_wg;
  const uint8_t* gbase;  // generic address of `base`
  int wg, b, hk, k0, kw0, row_a, c_thr;
};

// One q loop of a bwd_dkdv_tc consumer warpgroup: every live q tile of every
// query head of the group, ascending; dV += P^T dO if kDV, dK += dS^T Q if
// kDK (dk and dv may be the same array when only one is computed).
template <int DP, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_loop(float (&dv)[DP / 64][32], float (&dk)[DP / 64][32],
                                          int& it, const DkdvCtx& x, const Shape& sh) {
  using L = DkdvSmem<DP>;
  constexpr int BM = Plan<DP>::kBM;
  const int offset = sh.T_len - sh.S;
  const int n_qt = (sh.S + BM - 1) / BM;
  const uint32_t bar0 = x.base + L::kBarOff;
  for (int gi = 0; gi < sh.kv_group; ++gi) {
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BM;
      if (!pair_live(q0, BM, x.k0, kRows, sh.S, sh.T_len, offset, sh.causal, sh.window)) continue;
      const int st = it % kStages;
      const uint32_t full = bar0 + 8 * (1 + st), empty = bar0 + 8 * (1 + kStages + st);
      mbar_wait(full, (it / kStages) & 1);
      ++it;
      turn_begin(x.wg);
      if (!pair_live(q0, BM, x.kw0, 64, sh.S, sh.T_len, offset, sh.causal, sh.window)) {
        turn_end(x.wg);
        mbar_arrive(empty);  // this warpgroup's half of the pair is all dead
        continue;
      }
      const uint32_t q_st = x.base + 2 * L::kKV + st * 2 * L::kQ, do_st = q_st + L::kQ;
      const float* lse_s = reinterpret_cast<const float*>(x.gbase + L::kRowsOff +
                                                          st * 2 * L::kRowBytes);
      const float* dl_s = lse_s + BM;
      float sT[BM / 2], dpT[kDK ? BM / 2 : 1];
      wgmma_fence();
      issue_ss<DP, BM, kRows>(sT, x.k_wg, q_st);
      wgmma_commit();
      if constexpr (kDK) {
        issue_ss<DP, BM, kRows>(dpT, x.v_wg, do_st);
        wgmma_commit();
        turn_end(x.wg);
        wgmma_wait<1>();
      } else {
        turn_end(x.wg);
        wgmma_wait<0>();
      }
      fence_all(sT);
      // S^T: rows are keys kw0 + row_a (+ 8), columns queries q0 + col.
      const bool masked =
          pair_masked(q0, BM, x.kw0, 64, sh.S, sh.T_len, offset, sh.causal, sh.window);
      const int key_a = x.kw0 + x.row_a;
      auto live = [&](int dr, int col) {
        const int key = key_a + dr, qr = q0 + col;
        if (qr >= sh.S || key >= sh.T_len) return false;
        const int qp = qr + offset;
        return !(sh.causal && key > qp) && !(sh.window > 0 && key <= qp - sh.window);
      };
      probs<BM, true>(masked, sT, sh.scale_log2, 0.f, 0.f, lse_s, x.c_thr, live);
      uint32_t pf[kDV ? BM / 16 : 1][4], dsf[kDK ? BM / 16 : 1][4];
      if constexpr (kDV) pack<BM>(sT, pf);
      if constexpr (kDK) {
        wgmma_wait<0>();
        fence_all(dpT);
        dscores<BM, true>(sT, dpT, 0.f, 0.f, dl_s, x.c_thr);
        pack<BM>(dpT, dsf);
      }
      wgmma_fence();
      if constexpr (kDV) issue_rs<DP, BM>(dv, pf, do_st);
      if constexpr (kDK) issue_rs<DP, BM>(dk, dsf, q_st);
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kDV) {
        fence_all(dv);
        fence_all(pf);
      }
      if constexpr (kDK) {
        fence_all(dk);
        fence_all(dsf);
      }
      mbar_arrive(empty);
    }
  }
}

// dK and dV of 128 keys of one kv head.  Block w takes the key tile and
// (b, kv head) of work item w: groups of kHeadGroup (b, kv head), key tile 0
// (the heaviest under a causal mask) first.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_tc(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
            int q_order, int k_order, int v_order, int do_order, const float* __restrict__ lse2,
            const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, Strides dks, Strides dvs, int n_kvbh, int n_kt,
            Shape sh) {
  using L = DkdvSmem<DP>;
  constexpr int BM = Plan<DP>::kBM;
  constexpr int kChunks = Plan<DP>::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base, s_v = base + L::kKV;
  const uint32_t bar_kv = base + L::kBarOff;
  auto bar_full = [&](int st) { return bar_kv + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_kv + 8 * (1 + kStages + st); };

  const int w = blockIdx.x;
  const int per_group = kHeadGroup * n_kt;
  const int grp = w / per_group, r = w - grp * per_group;
  const int gh = min(kHeadGroup, n_kvbh - grp * kHeadGroup);
  const int kt = r / gh, kvbh = grp * kHeadGroup + r % gh;
  const int n_kv = sh.n_heads / sh.kv_group;
  const int b = kvbh / n_kv, hk = kvbh % n_kv;
  const int k0 = kt * kRows;
  const int offset = sh.T_len - sh.S;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bar_kv, 2 * L::kKV);
      for (int c = 0; c < kChunks; ++c)
        load_box(s_k + c * kRows * 128, &tm_k, k_order, bar_kv, 64 * c, k0, hk, b);
      for (int c = 0; c < kChunks; ++c)
        load_box(s_v + c * kRows * 128, &tm_v, v_order, bar_kv, 64 * c, k0, hk, b);
      const int n_qt = (sh.S + BM - 1) / BM;
      int it = 0;
      for (int pass = 0; pass < Plan<DP>::kPasses; ++pass)
        for (int gi = 0; gi < sh.kv_group; ++gi) {
          const int h = hk * sh.kv_group + gi;
          const long long rows = ((long long)b * sh.n_heads + h) * sh.S_pad;
          for (int qt = 0; qt < n_qt; ++qt) {
            const int q0 = qt * BM;
            if (!pair_live(q0, BM, k0, kRows, sh.S, sh.T_len, offset, sh.causal, sh.window))
              continue;
            const int st = it % kStages;
            const uint32_t q_st = base + 2 * L::kKV + st * 2 * L::kQ, do_st = q_st + L::kQ;
            const uint32_t rows_st = base + L::kRowsOff + st * 2 * L::kRowBytes;
            mbar_wait(bar_empty(st), ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(bar_full(st), 2 * L::kQ + 2 * L::kRowBytes);
            for (int c = 0; c < kChunks; ++c)
              load_box(q_st + c * BM * 128, &tm_q, q_order, bar_full(st), 64 * c, q0, h, b);
            for (int c = 0; c < kChunks; ++c)
              load_box(do_st + c * BM * 128, &tm_do, do_order, bar_full(st), 64 * c, q0, h, b);
            bulk_load(rows_st, lse2 + rows + q0, L::kRowBytes, bar_full(st));
            bulk_load(rows_st + L::kRowBytes, delta + rows + q0, L::kRowBytes, bar_full(st));
            ++it;
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    DkdvCtx x;
    x.base = base;
    x.gbase = smem_raw + (base - raw);
    x.wg = wg;
    x.k_wg = s_k + wg * 64 * 128;
    x.v_wg = s_v + wg * 64 * 128;
    x.b = b;
    x.hk = hk;
    x.k0 = k0;
    x.kw0 = k0 + wg * 64;
    x.row_a = warp * 16 + lane / 4;
    x.c_thr = 2 * (lane % 4);
    __nv_bfloat16* dkb = dk + b * dks.b + hk * dks.h;
    __nv_bfloat16* dvb = dv + b * dvs.b + hk * dvs.h;
    const int row_a = x.kw0 + x.row_a;
    mbar_wait(bar_kv, 0);
    turns_open(wg);
    int it = 0;
    float acc0[kChunks][32];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc0[c][e] = 0.f;
    if constexpr (Plan<DP>::kPasses == 1) {
      float acc1[kChunks][32];
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc1[c][e] = 0.f;
      dkdv_loop<DP, true, true>(acc0, acc1, it, x, sh);
      store_rows<DP>(dvb, dvs.s, row_a, sh.T_len, acc0, 1.f, sh.D, x.c_thr);
      store_rows<DP>(dkb, dks.s, row_a, sh.T_len, acc1, sh.scale, sh.D, x.c_thr);
    } else {
      dkdv_loop<DP, true, false>(acc0, acc0, it, x, sh);
      store_rows<DP>(dvb, dvs.s, row_a, sh.T_len, acc0, 1.f, sh.D, x.c_thr);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc0[c][e] = 0.f;
      dkdv_loop<DP, false, true>(acc0, acc0, it, x, sh);
      store_rows<DP>(dkb, dks.s, row_a, sh.T_len, acc0, sh.scale, sh.D, x.c_thr);
    }
    turns_close(wg);
  }
}

// dQ of 128 q rows of one head.  Block w takes the q tile and (b, h) of work
// item w: groups of kHeadGroup (b, h), the last q tile (the heaviest under a
// causal mask) first, as the forward.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_tc(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
          int q_order, int k_order, int v_order, int do_order, const float* __restrict__ lse2,
          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, Strides dqs,
          int n_bh, int n_qt, Shape sh) {
  using L = DqSmem<DP>;
  constexpr int BN = Plan<DP>::kBN;
  constexpr int kChunks = Plan<DP>::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_q = base, s_do = base + L::kQ;
  const uint32_t s_rows = base + L::kRowsOff;
  const uint32_t bar_q = base + L::kBarOff;
  auto bar_full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8 * (1 + kStages + st); };

  const int w = blockIdx.x;
  const int per_group = kHeadGroup * n_qt;
  const int grp = w / per_group, r = w - grp * per_group;
  const int gh = min(kHeadGroup, n_bh - grp * kHeadGroup);
  const int qt = n_qt - 1 - r / gh, bh = grp * kHeadGroup + r % gh;
  const int b = bh / sh.n_heads, h = bh % sh.n_heads, hk = h / sh.kv_group;
  const int q0 = qt * kRows;
  const int offset = sh.T_len - sh.S;
  const int n_kt = (sh.T_len + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const long long rows = (long long)bh * sh.S_pad + q0;
      mbar_expect_tx(bar_q, 2 * L::kQ + 2 * kRows * 4);
      for (int c = 0; c < kChunks; ++c)
        load_box(s_q + c * kRows * 128, &tm_q, q_order, bar_q, 64 * c, q0, h, b);
      for (int c = 0; c < kChunks; ++c)
        load_box(s_do + c * kRows * 128, &tm_do, do_order, bar_q, 64 * c, q0, h, b);
      bulk_load(s_rows, lse2 + rows, kRows * 4, bar_q);
      bulk_load(s_rows + kRows * 4, delta + rows, kRows * 4, bar_q);
      int it = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BN;
        if (!pair_live(q0, kRows, k0, BN, sh.S, sh.T_len, offset, sh.causal, sh.window)) continue;
        const int st = it % kStages;
        const uint32_t k_st = base + 2 * L::kQ + st * 2 * L::kKV, v_st = k_st + L::kKV;
        mbar_wait(bar_empty(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(st), 2 * L::kKV);
        for (int c = 0; c < kChunks; ++c)
          load_box(k_st + c * BN * 128, &tm_k, k_order, bar_full(st), 64 * c, k0, hk, b);
        for (int c = 0; c < kChunks; ++c)
          load_box(v_st + c * BN * 128, &tm_v, v_order, bar_full(st), 64 * c, k0, hk, b);
        ++it;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r_local = wg * 64 + warp * 16 + lane / 4;  // rows r_local, r_local + 8
    const int c_thr = 2 * (lane % 4);
    const int qw0 = q0 + wg * 64;
    const uint32_t q_wg = s_q + wg * 64 * 128, do_wg = s_do + wg * 64 * 128;
    const float* rows_s = reinterpret_cast<const float*>(smem_raw + (s_rows - raw));
    float acc[kChunks][32];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    mbar_wait(bar_q, 0);
    const float la = rows_s[r_local], lb = rows_s[r_local + 8];
    const float da = rows_s[kRows + r_local], db = rows_s[kRows + r_local + 8];
    const int qr_a = q0 + r_local;
    turns_open(wg);
    int it = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BN;
      if (!pair_live(q0, kRows, k0, BN, sh.S, sh.T_len, offset, sh.causal, sh.window)) continue;
      const int st = it % kStages;
      const uint32_t full = bar_full(st), empty = bar_empty(st);
      mbar_wait(full, (it / kStages) & 1);
      ++it;
      turn_begin(wg);
      if (!pair_live(qw0, 64, k0, BN, sh.S, sh.T_len, offset, sh.causal, sh.window)) {
        turn_end(wg);
        mbar_arrive(empty);  // this warpgroup's half of the pair is all dead
        continue;
      }
      const uint32_t k_st = base + 2 * L::kQ + st * 2 * L::kKV, v_st = k_st + L::kKV;
      float s[BN / 2], dp[BN / 2];
      wgmma_fence();
      issue_ss<DP, BN, kRows>(s, q_wg, k_st);
      wgmma_commit();
      issue_ss<DP, BN, kRows>(dp, do_wg, v_st);
      wgmma_commit();
      turn_end(wg);
      wgmma_wait<1>();
      fence_all(s);
      // S: rows are queries qr_a (+ 8), columns keys k0 + col.
      const bool masked =
          pair_masked(qw0, 64, k0, BN, sh.S, sh.T_len, offset, sh.causal, sh.window);
      auto live = [&](int dr, int col) {
        const int qr = qr_a + dr, key = k0 + col;
        if (qr >= sh.S || key >= sh.T_len) return false;
        const int qp = qr + offset;
        return !(sh.causal && key > qp) && !(sh.window > 0 && key <= qp - sh.window);
      };
      probs<BN, false>(masked, s, sh.scale_log2, la, lb, nullptr, c_thr, live);
      wgmma_wait<0>();
      fence_all(dp);
      dscores<BN, false>(s, dp, da, db, nullptr, c_thr);
      uint32_t dsf[BN / 16][4];
      pack<BN>(dp, dsf);
      wgmma_fence();
      issue_rs<DP, BN>(acc, dsf, k_st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(dsf);
      mbar_arrive(empty);
    }
    turns_close(wg);
    store_rows<DP>(dq + b * dqs.b + h * dqs.h, dqs.s, qr_a, sh.S, acc, sh.scale, sh.D, c_thr);
  }
}

// Per device (up to kDevices), per kernel and width: whether it may take its
// shared memory.
constexpr int kDevices = 64;

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int device, bool (&set)[kDevices]) {
  const bool cached = device >= 0 && device < kDevices;
  if (cached && set[device]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (cached) set[device] = true;
  return 0;
}

template <int DP>
int launch(cudaStream_t stream, int device, const Args& a, const long long* axes) {
  using P = Plan<DP>;
  static bool dkdv_set[kDevices], dq_set[kDevices];
  const int n_bh = a.batch * a.n_heads, n_kvbh = a.batch * (a.n_heads / a.kv_group);
  const int S_pad = (a.S + kRowPad - 1) / kRowPad * kRowPad;
  const long long n_rows = (long long)n_bh * S_pad;
  float* lse2 = a.delta;  // the workspace: lse2 rows, then D rows
  float* delta = a.delta + n_rows;

  const bool vec = a.D % 8 == 0 && reinterpret_cast<uintptr_t>(a.o) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.dout) % 16 == 0 && a.os.b % 8 == 0 &&
                   a.os.h % 8 == 0 && a.os.s % 8 == 0 && a.ds.b % 8 == 0 && a.ds.h % 8 == 0 &&
                   a.ds.s % 8 == 0;
  bwd_prep_tc<<<(unsigned)((n_rows + 31) / 32), 256, 0, stream>>>(
      (const __nv_bfloat16*)a.o, (const __nv_bfloat16*)a.dout, a.lse, lse2, delta, a.n_heads,
      a.S, S_pad, a.D, a.os, a.ds, n_rows, (int)vec);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  // Tensor maps: q, k, v, dO (axes + 0, 7, 14, 21) with each kernel's boxes.
  CUtensorMap mq[2], mk[2], mv[2], mdo[2];
  const int q_box[2] = {P::kBM, kRows}, kv_box[2] = {kRows, P::kBN};
  for (int i = 0; i < 2; ++i) {
    int err = make_map(&mq[i], a.q, a.D, axes, q_box[i]);
    if (err == 0) err = make_map(&mk[i], a.k, a.D, axes + 7, kv_box[i]);
    if (err == 0) err = make_map(&mv[i], a.v, a.D, axes + 14, kv_box[i]);
    if (err == 0) err = make_map(&mdo[i], a.dout, a.D, axes + 21, q_box[i]);
    if (err != 0) return err;
  }
  const int orders[4] = {(int)axes[6], (int)axes[13], (int)axes[20], (int)axes[27]};
  const Shape sh{a.n_heads, a.kv_group, a.S, S_pad, a.T_len, a.D, a.causal, a.window, a.scale,
                 (float)((double)a.scale * 1.4426950408889634)};

  int err = allow_smem(bwd_dkdv_tc<DP>, DkdvSmem<DP>::kBytes, device, dkdv_set);
  if (err != 0) return err;
  const int n_kt = (a.T_len + kRows - 1) / kRows;
  bwd_dkdv_tc<DP><<<n_kt * n_kvbh, kThreads, DkdvSmem<DP>::kBytes, stream>>>(
      mq[0], mk[0], mv[0], mdo[0], orders[0], orders[1], orders[2], orders[3], lse2, delta,
      (__nv_bfloat16*)a.dk, (__nv_bfloat16*)a.dv, a.dks, a.dvs, n_kvbh, n_kt, sh);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  err = allow_smem(bwd_dq_tc<DP>, DqSmem<DP>::kBytes, device, dq_set);
  if (err != 0) return err;
  const int n_qt = (a.S + kRows - 1) / kRows;
  bwd_dq_tc<DP><<<n_qt * n_bh, kThreads, DqSmem<DP>::kBytes, stream>>>(
      mq[1], mk[1], mv[1], mdo[1], orders[0], orders[1], orders[2], orders[3], lse2, delta,
      (__nv_bfloat16*)a.dq, a.dqs, n_bh, n_qt, sh);
  return (int)cudaGetLastError();
}

template <int DP>
void plan(int* out) {
  out[0] = DP;
  out[1] = kRows;
  out[2] = Plan<DP>::kBM;
  out[3] = Plan<DP>::kPasses;
  out[4] = kRows;
  out[5] = Plan<DP>::kBN;
  out[6] = kRowPad;
  out[7] = kStages;
}

}  // namespace tc

}  // namespace

// The bf16 kernels' plan for head dim D: {padded width, bwd_dkdv_tc's keys a
// block, its q rows a stage, its passes, bwd_dq_tc's q rows a block, its k
// rows a stage, the workspace's row padding, the ring's stages}
// (kernels/flash_attention.py::bwd_plan mirrors it).
extern "C" void flash_attention_bwd_plan(int D, int* out) {
  switch (tc::width(D)) {
    case 64:
      return tc::plan<64>(out);
    case 128:
      return tc::plan<128>(out);
    case 192:
      return tc::plan<192>(out);
    default:
      return tc::plan<256>(out);
  }
}

// dtype 0: float32, 1: bfloat16, for q, k, v, o, dout, dq, dk and dv alike.
// `strides` holds the element strides of the B, H and S axes of q, k, v, o,
// dout, dq, dk and dv in turn (24 values); D is contiguous in each.  lse is
// contiguous f32 (B, H, S).  float32 runs the SIMT kernels (three launches):
// `ws` is scratch of B H S floats, `axes` is not read.  bfloat16 runs the
// tensor-core kernels (three launches): `ws` is scratch of 2 B H S_pad
// floats (S_pad = S rounded up to the plan's row padding), and `axes` holds
// kernels/flash_attention.py::tma_axes of q, k, v and dout in turn (28
// values), whose bases and strides are 16-byte aligned (the wrapper copies a
// view that is not).  The caller checks shapes (1 <= D <= 256, S <= T,
// n_heads % kv_group == 0, grid limits).  Returns the first CUDA error, or a
// negative code when a tensor map cannot be made.
extern "C" int flash_attention_bwd_launch(int device, void* stream, int dtype, const void* q,
                                          const void* k, const void* v, const void* o,
                                          const void* dout, const float* lse, float* ws,
                                          void* dq, void* dk, void* dv, int batch, int n_heads,
                                          int kv_group, int S, int T_len, int D,
                                          const long long* strides, const long long* axes,
                                          int causal, int window, float scale) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{q,     k,      v,        o, dout, lse,   ws,    dq,    dk,    dv,    batch,
               n_heads, kv_group, S, T_len, D, st[0], st[1], st[2], st[3], st[4], st[5],
               st[6], st[7], causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 1) return launch_width<float>(s, a);
  switch (tc::width(D)) {
    case 64:
      return tc::launch<64>(s, device, a, axes);
    case 128:
      return tc::launch<128>(s, device, a, axes);
    case 192:
      return tc::launch<192>(s, device, a, axes);
    default:
      return tc::launch<256>(s, device, a, axes);
  }
}
