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
// or bf16; all sums in f32; the output is divided by max(l, 1e-30) and cast
// to q's type (bf16 by round-to-nearest-even, as JAX's astype).  Given a
// non-null `lse`, each kernel's epilogue also writes every real row's
// log-sum-exp of its scaled logits, lse = m + log(l) in natural-log units,
// f32 (B, H, S) contiguous: the backward (csrc/flash_attention_bwd.cu)
// recomputes P = exp(scale q.k - lse) from it.  A null `lse` stores nothing.
//
// Bound on an H100: operations.  Serving prefill (B=16, H=32, D=64,
// S=T=2048, causal) does 4*B*H*D*(live q-k pairs) = 2.75e11 flops against
// 0.54 GB of q, k, v and o: 0.28 ms at the 989 TFLOP/s bf16 tensor-core
// rate, 0.16 ms of bytes.
//
// What the bf16 kernel reaches there (chip_smoke.py phase 2 on an H100 SXM
// at 700 W): about 1.1 ms, 4.0x the bound, 1.5x torch's SDPA; the f32 SIMT
// kernel took 12.7 ms.  What still holds it back, from timing variants of
// the kernel: with both products and the softmax removed, the loop still
// takes 0.63 ms -- 0.28 ms of barrier round trips and per-item q loads and
// stores, and K/V traffic, much of it L2 misses as the persistent blocks
// drift apart over the heads; and the softmax (64 exps a thread a tile on
// the special-function unit, 16 a clock an SM) overlaps the products only
// in part.
//
// Design.  The path is chosen by dtype, in the wrapper and here; neither is
// a fallback for the other.
//
// bfloat16 (flash_fwd_tc, every prefill of the serving path): both products
// on the tensor cores with wgmma (bf16 operands, f32 accumulators).  One
// persistent block of 384 threads per SM walks over (b*h, 128-row q tile)
// work items: two consumer warpgroups of 64 q rows each and one producer
// warpgroup, which hands most of its registers to the consumers (setmaxnreg
// 40 / 232).  One producer thread loads each item's q tile (bf16, never
// widened) and then its k tiles' K and V by TMA into a ring of two stages
// in shared memory, 128-byte swizzled as wgmma's descriptors read them; per
// stage one mbarrier says K arrived, one V, and two let the consumers
// release K and V apart.  The ring runs on across items, so the next item's
// q and first tiles load while this one's last products and stores finish.
// A consumer warpgroup issues S = Q K^T (m64nNk16, Q and K K-major from
// shared memory) together with the previous tile's O += P V, and takes the
// online softmax of S in registers while P V still runs.  The softmax is in
// the log2 domain (s * scale * log2(e),
// then ex2.approx.ftz), so the scale is applied to the f32 scores after the
// product, never to a bf16 q.  P is rounded to bf16 in registers -- the
// wgmma accumulator layout is the A-fragment layout, so P feeds O += P V
// straight from registers (m64n64k16 per 64 columns of D, V MN-major with
// the transpose bit).  The normaliser l sums the f32 probabilities (before
// P is rounded), as FlashAttention does.  Only k tiles that straddle the
// causal diagonal, the window edge or T evaluate the mask; tiles the masks
// rule out for the whole q tile are skipped (the Pallas liveness test); K
// rows past T and columns past D arrive as zeros from TMA's out-of-bounds
// fill.  Work items take the q tiles of eight (b, h) at a time, heaviest
// (last, under a causal mask) first, so the K and V a wave reads stay in
// L2.  Each row's sums run in a fixed order (no split over blocks, no
// atomics): reruns give equal bits.  Padded widths compiled: 64 (D <= 64),
// 128, 192 (e.g. gemma3's 168) and 256; zero columns add exactly nothing.
// The k tile is 128 rows up to width 128 and 64 above it (at 256 the O
// accumulator alone is 128 registers a thread).  TMA needs a
// 16-byte-aligned base and strides that are multiples of 16 bytes: the
// wrapper copies a view that fails this.
//
// float32 (flash_fwd_kernel, the f32 parity surface; TF32 stays off): the
// SIMT kernel of the first port.  One block of 256 threads per (b*h, 64-row
// q tile), heaviest q tiles first; the q tile (cast to f32, then scaled) is
// staged in shared memory, each 64-row k tile's scores are a register-tiled
// f32 product (thread (ty, tx) owns rows ty+16i and keys tx+16j), row max
// and sum by shuffles inside 16-lane groups, P through shared memory, V
// staged where K was; padded pitches keep shared memory conflict-free.
// Widths 64, 128 and 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "flash_common.cuh"

namespace {

using flash::Strides;

// ===========================================================================
// float32: the SIMT kernel
// ===========================================================================

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16 (ty, tx)
constexpr int kPitchP = kBlockK + 16;  // rows r and r+1 of P start 16 banks apart
constexpr float kNegInf = -1e30f;

// Stage rows [row0, row0 + 64) of one (b, h) slice in s[r * pitch + d],
// times mul; rows past n_rows and columns past D are zero.
template <int DP>
__device__ __forceinline__ void stage_tile(float* s, const float* __restrict__ src,
                                           long long row_stride, int row0, int n_rows, int D,
                                           float mul) {
  constexpr int pitch = DP + 1;
  for (int idx = threadIdx.x; idx < kBlockQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_rows && d < D) x = src[row * row_stride + d] * mul;
    s[r * pitch + d] = x;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int n_heads, int kv_group,
                 int S, int T_len, int D, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, float scale, float* __restrict__ lse) {
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = o + b * os.b + h * os.h;

  stage_tile<DP>(s_q, qb, qs.s, q0, S, D, scale);

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
    stage_tile<DP>(s_kv, kb, ks.s, k0, T_len, D, 1.f);
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
    stage_tile<DP>(s_kv, vb, vs.s, k0, T_len, D, 1.f);
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
      if (d < D) ob[row * os.s + d] = acc[i][jj] / denom;
    }
    // m and l are the row's in every lane of the 16-lane group.
    if (lse != nullptr && tx == 0) lse[(long long)bh * S + row] = m[i] + logf(l[i]);
  }
}

template <int DP>
int launch_f32(cudaStream_t stream, const void* q, const void* k, const void* v, void* o,
               int batch, int n_heads, int kv_group, int S, int T_len, int D, Strides qs,
               Strides ks, Strides vs, Strides os, int causal, int window, float scale,
               float* lse) {
  const size_t smem = sizeof(float) * (2 * kBlockQ * (DP + 1) + kBlockQ * kPitchP);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * n_heads, (S + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, n_heads, kv_group, S, T_len,
      D, qs, ks, vs, os, causal, window, scale, lse);
  return (int)cudaGetLastError();
}

int f32_width(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

// ===========================================================================
// bfloat16: the tensor-core kernel
// ===========================================================================

namespace tc {

using namespace hopper;
using namespace flash;

constexpr int kConsumers = 2;                     // warpgroups, 64 q rows each
constexpr int kBlockM = 64 * kConsumers;          // q rows a block
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kProducerRegs = 40;                 // setmaxnreg: the producer gives
constexpr int kConsumerRegs = 232;                // registers to the consumers
constexpr int kStages = 2;                        // K/V ring depth
constexpr int kHeadGroup = 8;                     // (b, h) whose q tiles are scheduled together
constexpr float kNeg = -1e30f;                    // masked logit (log2 domain)

int width(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256; }
int block_n(int DP) { return DP <= 128 ? 128 : 64; }

template <int DP>
struct Tile {
  static constexpr int kN = DP <= 128 ? 128 : 64;  // k tile rows
  static constexpr int kChunks = DP / 64;          // 64-column (128-byte) swizzle atoms a row
  static constexpr int kQBytes = kBlockM * DP * 2;
  static constexpr int kKVBytes = kN * DP * 2;     // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOffset + 8 * (2 + 4 * kStages) + 1024;  // + alignment slack
};

// a / den correctly rounded, from inv = RN(1 / den): q = RN(a inv), then
// one Newton step on the exact residual a - den q (Markstein), for den >= 1.
__device__ __forceinline__ float div_rn(float a, float den, float inv) {
  const float q = a * inv;
  return fmaf(fmaf(-den, q, a), inv, q);
}

// S = Q K^T for one warpgroup over DP / 16 k-steps: 32 bytes along a
// 128-byte row, then the next 64-column chunk.  The first step overwrites s.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<DP>::kN / 2], uint32_t q_wg,
                                         uint32_t k_st) {
  constexpr int BN = Tile<DP>::kN;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint64_t da = desc_sw128(q_wg + (ks / 4) * kBlockM * 128 + (ks % 4) * 32, 16, 1024);
    const uint64_t db = desc_sw128(k_st + (ks / 4) * BN * 128 + (ks % 4) * 32, 16, 1024);
    if constexpr (BN == 128)
      wgmma_ss_n128(s, da, db, ks > 0);
    else
      wgmma_ss_n64(s, da, db, ks > 0);
  }
}

// O += P V: 16 keys a k-step (two 8-row atoms, 2,048 bytes), one m64n64k16
// per 64-column chunk of V.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[Tile<DP>::kChunks][32],
                                         const uint32_t (&pa)[Tile<DP>::kN / 16][4],
                                         uint32_t v_st) {
  constexpr int BN = Tile<DP>::kN;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int c = 0; c < Tile<DP>::kChunks; ++c)
      wgmma_rs_n64(acc[c], pa[kk], desc_sw128(v_st + c * BN * 128 + kk * 2048, 1024, 1024));
}

// One k tile's online softmax for rows a and b of this thread, in the log2
// domain, the mask evaluated only when the tile needs it: the new running
// maxima and sums, the factors alpha that rescale O, and P in bf16 as the A
// fragments of O += P V (k-step kk takes accumulator chunks 2 kk, 2 kk + 1).
// l sums the f32 probabilities, before P is rounded.
struct Row {
  float m_a, m_b, l_a, l_b;
};

template <int BN, bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], uint32_t (&pa)[BN / 16][4],
                                             Row& row, float& alpha_a, float& alpha_b, int k0,
                                             int c_thr, int pos_a, int T_len, int causal,
                                             int window, float scale_log2) {
  float mx_a = row.m_a, mx_b = row.m_b;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if constexpr (kMasked) {
        const int kp = k0 + 8 * j + c_thr + (e & 1);
        const int qp = e < 2 ? pos_a : pos_a + 8;
        bool live = kp < T_len;
        if (causal) live = live && kp <= qp;
        if (window > 0) live = live && kp > qp - window;
        if (!live) x = kNeg;
      }
      s[4 * j + e] = x;
      if (e < 2)
        mx_a = fmaxf(mx_a, x);
      else
        mx_b = fmaxf(mx_b, x);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  alpha_a = exp2_ftz(row.m_a - mx_a);
  alpha_b = exp2_ftz(row.m_b - mx_b);
  row.m_a = mx_a;
  row.m_b = mx_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float p0 = exp2_ftz(s[4 * j] - mx_a), p1 = exp2_ftz(s[4 * j + 1] - mx_a);
    const float p2 = exp2_ftz(s[4 * j + 2] - mx_b), p3 = exp2_ftz(s[4 * j + 3] - mx_b);
    sum_a += p0 + p1;
    sum_b += p2 + p3;
    pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  row.l_a = row.l_a * alpha_a + sum_a;
  row.l_b = row.l_b * alpha_b + sum_b;
}

// The masked and unmasked softmax are separate code paths: predicated mask
// code would still take issue slots on every tile.
template <int BN>
__device__ __forceinline__ void softmax(bool masked, float (&s)[BN / 2],
                                        uint32_t (&pa)[BN / 16][4], Row& row, float& alpha_a,
                                        float& alpha_b, int k0, int c_thr, int pos_a, int T_len,
                                        int causal, int window, float scale_log2) {
  if (masked)
    softmax_tile<BN, true>(s, pa, row, alpha_a, alpha_b, k0, c_thr, pos_a, T_len, causal, window,
                           scale_log2);
  else
    softmax_tile<BN, false>(s, pa, row, alpha_a, alpha_b, k0, c_thr, pos_a, T_len, causal, window,
                            scale_log2);
}

// Work item w -> (b*h, q tile): groups of kHeadGroup (b, h), and inside a
// group the heaviest q tile (the last, under a causal mask) first.
struct Work {
  int b, h, hk, q0, kt_begin, n_tiles;
};

template <int BN>
__device__ __forceinline__ Work decode_work(int w, int n_heads, int kv_group, int n_bh, int n_qt,
                                            int S, int T_len, int causal, int window) {
  const int per_group = kHeadGroup * n_qt;
  const int g = w / per_group;
  const int r = w - g * per_group;
  const int gh = min(kHeadGroup, n_bh - g * kHeadGroup);
  const int qt = n_qt - 1 - r / gh;
  const int bh = g * kHeadGroup + r % gh;
  Work x;
  x.b = bh / n_heads;
  x.h = bh % n_heads;
  x.hk = x.h / kv_group;
  x.q0 = qt * kBlockM;
  const int q_lo = x.q0 + T_len - S;                        // first real row's position
  const int q_hi = min(x.q0 + kBlockM, S) - 1 + T_len - S;  // last real row's position
  const int n_kt = (T_len + BN - 1) / BN;
  const int kt_end = causal ? min(n_kt, q_hi / BN + 1) : n_kt;
  x.kt_begin = window > 0 ? max(0, (q_lo - window + 1) / BN) : 0;
  x.n_tiles = kt_end - x.kt_begin;  // >= 1: row q_lo sees key q_lo
  return x;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, int q_order, int k_order, int v_order,
             __nv_bfloat16* __restrict__ o, Strides os, int n_heads, int kv_group, int n_bh,
             int n_qt, int S, int T_len, int D, int causal, int window, float scale_log2,
             float* __restrict__ lse) {
  using C = Tile<DP>;
  constexpr int BN = C::kN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;                         // [chunk][128 rows][128 B]
  const uint32_t s_k = base + C::kQBytes;            // [stage][chunk][BN rows][128 B]
  const uint32_t s_v = s_k + kStages * C::kKVBytes;  // the same for V
  // Barriers: q full, q consumed; per stage K full, V full, K consumed, V consumed.
  const uint32_t bar_q = base + C::kBarOffset, bar_qe = bar_q + 8;
  auto bar_k = [&](int st) { return bar_q + 8 * (2 + st); };
  auto bar_v = [&](int st) { return bar_q + 8 * (2 + kStages + st); };
  auto bar_ke = [&](int st) { return bar_q + 8 * (2 + 2 * kStages + st); };
  auto bar_ve = [&](int st) { return bar_q + 8 * (2 + 3 * kStages + st); };
  const int n_work = n_qt * n_bh;
  const int offset = T_len - S;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 128 * kConsumers);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_ke(st), 128 * kConsumers);
      mbar_init(bar_ve(st), 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Persistent: block c takes work items c, c + gridDim.x, ...; the ring's
  // position `it` runs on across them, so the next item's q and first K/V
  // load while this one's last products and stores finish.
  if (threadIdx.x >= 128 * kConsumers) {
    // Producer warpgroup: one thread issues every load.  K and V of a stage
    // are released apart, so the next K can land while P V still reads V.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0, item = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
        const Work x =
            decode_work<BN>(w, n_heads, kv_group, n_bh, n_qt, S, T_len, causal, window);
        mbar_wait(bar_qe, (item & 1) ^ 1);  // the last item's q is no longer read
        mbar_expect_tx(bar_q, C::kQBytes);
        for (int c = 0; c < C::kChunks; ++c)
          load_box(s_q + c * kBlockM * 128, &tm_q, q_order, bar_q, 64 * c, x.q0, x.h, x.b);
        for (int i = 0; i < x.n_tiles; ++i, ++it) {
          const int st = it % kStages, row0 = (x.kt_begin + i) * BN;
          const uint32_t parity = ((it / kStages) & 1) ^ 1, off = st * C::kKVBytes;
          mbar_wait(bar_ke(st), parity);
          mbar_expect_tx(bar_k(st), C::kKVBytes);
          for (int c = 0; c < C::kChunks; ++c)
            load_box(s_k + off + c * BN * 128, &tm_k, k_order, bar_k(st), 64 * c, row0, x.hk,
                     x.b);
          mbar_wait(bar_ve(st), parity);
          mbar_expect_tx(bar_v(st), C::kKVBytes);
          for (int c = 0; c < C::kChunks; ++c)
            load_box(s_v + off + c * BN * 128, &tm_v, v_order, bar_v(st), 64 * c, row0, x.hk,
                     x.b);
        }
      }
    }
  } else {
    // Consumers.  Thread (warp w, lane l) of warpgroup wg holds, in wgmma's
    // accumulator layout, rows r_a = 64 wg + 16 w + l / 4 and r_a + 8 and,
    // in every 8-column chunk j, columns 8 j + 2 (l % 4) and the next one.
    // Tile i's S = Q K^T is issued together with tile i-1's O += P V, and
    // its softmax runs while P V is still on the tensor cores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r_local = wg * 64 + warp * 16 + lane / 4;
    const int c_thr = 2 * (lane % 4);
    const uint32_t q_wg = s_q + wg * 64 * 128;
    const bool pairs = (D % 2) == 0;

    float s[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) s[e] = 0.f;
    int it = 0, item = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
      const Work x = decode_work<BN>(w, n_heads, kv_group, n_bh, n_qt, S, T_len, causal, window);
      const int pos_a = x.q0 + r_local + offset;
      const int wg_lo = x.q0 + wg * 64 + offset, wg_hi = wg_lo + 63;
      auto masked = [&](int k0) {  // may the mask rule out a pair of this warpgroup's tile?
        return k0 + BN > T_len || (causal && k0 + BN - 1 > wg_lo) ||
               (window > 0 && k0 <= wg_hi - window);
      };
      float acc[C::kChunks][32];
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
      uint32_t pa[BN / 16][4];
      Row row{kNeg, kNeg, 0.f, 0.f};
      float alpha_a, alpha_b;

      mbar_wait(bar_q, item & 1);
      {
        const int st = it % kStages, k0 = x.kt_begin * BN;
        mbar_wait(bar_k(st), (it / kStages) & 1);
        wgmma_fence();
        issue_qk<DP>(s, q_wg, s_k + st * C::kKVBytes);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) fence_reg(s[e]);
        mbar_arrive(bar_ke(st));
        softmax<BN>(masked(k0), s, pa, row, alpha_a, alpha_b, k0, c_thr, pos_a, T_len, causal,
                    window, scale_log2);
      }
      for (int i = 1; i < x.n_tiles; ++i) {
        const int cur = it + i, st = cur % kStages, prev = (cur - 1) % kStages;
        const int k0 = (x.kt_begin + i) * BN;
        mbar_wait(bar_k(st), (cur / kStages) & 1);
        mbar_wait(bar_v(prev), ((cur - 1) / kStages) & 1);
        wgmma_fence();
        issue_qk<DP>(s, q_wg, s_k + st * C::kKVBytes);
        wgmma_commit();
        wgmma_fence();
        issue_pv<DP>(acc, pa, s_v + prev * C::kKVBytes);
        wgmma_commit();
        wgmma_wait<1>();  // S of tile i is done; P V of tile i-1 may still run
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) fence_reg(s[e]);
        mbar_arrive(bar_ke(st));
        uint32_t pn[BN / 16][4];
        softmax<BN>(masked(k0), s, pn, row, alpha_a, alpha_b, k0, c_thr, pos_a, T_len, causal,
                    window, scale_log2);
        // Pin the softmax above the wait: the compiler would sink the exps
        // below it, and then nothing overlaps P V.
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) fence_reg(pn[kk][e]);
        fence_reg(row.l_a);
        fence_reg(row.l_b);
        fence_reg(alpha_a);
        fence_reg(alpha_b);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) fence_reg(acc[c][e]);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) fence_reg(pa[kk][e]);
        mbar_arrive(bar_ve(prev));
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[c][4 * j] *= alpha_a;
            acc[c][4 * j + 1] *= alpha_a;
            acc[c][4 * j + 2] *= alpha_b;
            acc[c][4 * j + 3] *= alpha_b;
          }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
      }
      mbar_arrive(bar_qe);  // every S of this item is done: q may be replaced

      const int last = (it + x.n_tiles - 1) % kStages;
      mbar_wait(bar_v(last), ((it + x.n_tiles - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv<DP>(acc, pa, s_v + last * C::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) fence_reg(acc[c][e]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_reg(pa[kk][e]);
      mbar_arrive(bar_ve(last));
      it += x.n_tiles;

      float l_a = row.l_a, l_b = row.l_b;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      // l >= 1 on every real row (its largest logit adds exp2(0)).
      const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
      const float inv_a = __frcp_rn(den_a), inv_b = __frcp_rn(den_b);
      const int row_a = x.q0 + r_local, row_b = row_a + 8;
      __nv_bfloat16* ob = o + x.b * os.b + x.h * os.h;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + c_thr;
          if (row_a < S)
            store_pair(ob + row_a * os.s, col, D, pairs, div_rn(acc[c][4 * j], den_a, inv_a),
                       div_rn(acc[c][4 * j + 1], den_a, inv_a));
          if (row_b < S)
            store_pair(ob + row_b * os.s, col, D, pairs, div_rn(acc[c][4 * j + 2], den_b, inv_b),
                       div_rn(acc[c][4 * j + 3], den_b, inv_b));
        }
      if (lse != nullptr && c_thr == 0) {  // the row's log-sum-exp, natural log
        float* lb = lse + ((long long)x.b * n_heads + x.h) * S;
        if (row_a < S) lb[row_a] = (row.m_a + log2f(l_a)) * 0.6931471805599453f;
        if (row_b < S) lb[row_b] = (row.m_b + log2f(l_b)) * 0.6931471805599453f;
      }
    }
  }
}

// Per device (up to kDevices), set once: the SM count, and whether each
// width's kernel may take its shared memory.  Host time matters here: a
// 64-token prefill's kernel runs for tens of microseconds.
constexpr int kDevices = 64;
int g_sms[kDevices];
bool g_smem_set[4][kDevices];

template <int DP>
int launch(cudaStream_t stream, int device, const void* q, const void* k, const void* v, void* o,
           const long long* axes, int batch, int n_heads, int kv_group, int S, int T_len, int D,
           Strides os, int causal, int window, float scale_log2, float* lse) {
  using C = Tile<DP>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, axes, kBlockM);
  if (err == 0) err = make_map(&tk, k, D, axes + 7, C::kN);
  if (err == 0) err = make_map(&tv, v, D, axes + 14, C::kN);
  if (err != 0) return err;
  const bool cached = device >= 0 && device < kDevices;
  int sms = cached ? g_sms[device] : 0;  // one persistent block per SM
  if (sms == 0) {
    cudaError_t cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (cerr != cudaSuccess) return (int)cerr;
    if (cached) g_sms[device] = sms;
  }
  bool& smem_set = g_smem_set[DP / 64 - 1][cached ? device : 0];
  if (!cached || !smem_set) {
    cudaError_t cerr = cudaFuncSetAttribute(flash_fwd_tc<DP>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (cerr != cudaSuccess) return (int)cerr;
    smem_set = cached;
  }
  const int n_qt = (S + kBlockM - 1) / kBlockM;
  const int n_bh = batch * n_heads;
  const int blocks = (int)std::min<long long>((long long)n_qt * n_bh, sms);
  flash_fwd_tc<DP><<<blocks, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, (int)axes[6], (int)axes[13], (int)axes[20], (__nv_bfloat16*)o, os, n_heads,
      kv_group, n_bh, n_qt, S, T_len, D, causal, window, scale_log2, lse);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Tile constants, by dtype (0 float32, 1 bfloat16) and head dim.
extern "C" int flash_attention_block_q(int dtype) { return dtype == 1 ? tc::kBlockM : kBlockQ; }
extern "C" int flash_attention_block_k(int dtype, int D) {
  return dtype == 1 ? tc::block_n(tc::width(D)) : kBlockK;
}
extern "C" int flash_attention_padded_dim(int dtype, int D) {
  return dtype == 1 ? tc::width(D) : f32_width(D);
}
extern "C" int flash_attention_max_head_dim() { return 256; }

// float32 q, k, v and o.  Strides are in elements, for the B, H and S axes
// of each tensor; D must be contiguous.  The caller checks shapes
// (1 <= D <= 256, S <= T, n_heads % kv_group == 0, grid limits).  `lse` is
// null or f32 (B, H, S) contiguous.  Returns cudaGetLastError().
extern "C" int flash_attention_f32_launch(int device, void* stream, const void* q, const void* k,
                                          const void* v, void* o, int batch, int n_heads,
                                          int kv_group, int S, int T_len, int D, long long q_sb,
                                          long long q_sh, long long q_ss, long long k_sb,
                                          long long k_sh, long long k_ss, long long v_sb,
                                          long long v_sh, long long v_ss, long long o_sb,
                                          long long o_sh, long long o_ss, int causal, int window,
                                          float scale, float* lse) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t st = (cudaStream_t)stream;
  switch (f32_width(D)) {
    case 64:
      return launch_f32<64>(st, q, k, v, o, batch, n_heads, kv_group, S, T_len, D, qs, ks, vs,
                            os, causal, window, scale, lse);
    case 128:
      return launch_f32<128>(st, q, k, v, o, batch, n_heads, kv_group, S, T_len, D, qs, ks, vs,
                             os, causal, window, scale, lse);
    default:
      return launch_f32<256>(st, q, k, v, o, batch, n_heads, kv_group, S, T_len, D, qs, ks, vs,
                             os, causal, window, scale, lse);
  }
}

// bfloat16 q, k, v and o.  `axes` holds, for q, k and v in turn, the 7
// values {size, size, size, stride, stride, stride, order} of the row, head
// and batch axes sorted by stride (kernels/flash_attention.py::tma_axes);
// every stride of an axis longer than 1 and every base are 16-byte aligned
// (the wrapper copies a view that is not).  o's strides are in elements.
// scale_log2 = log2(e) / sqrt(D); `lse` is null or f32 (B, H, S)
// contiguous.  Returns cudaGetLastError(), or a
// negative code when the tensor maps cannot be made.
extern "C" int flash_attention_bf16_launch(int device, void* stream, const void* q,
                                           const void* k, const void* v, void* o,
                                           const long long* axes, int batch, int n_heads,
                                           int kv_group, int S, int T_len, int D,
                                           long long o_sb, long long o_sh, long long o_ss,
                                           int causal, int window, float scale_log2,
                                           float* lse) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides os{o_sb, o_sh, o_ss};
  cudaStream_t st = (cudaStream_t)stream;
  switch (tc::width(D)) {
    case 64:
      return tc::launch<64>(st, device, q, k, v, o, axes, batch, n_heads, kv_group, S,
                            T_len, D, os, causal, window, scale_log2, lse);
    case 128:
      return tc::launch<128>(st, device, q, k, v, o, axes, batch, n_heads, kv_group, S,
                             T_len, D, os, causal, window, scale_log2, lse);
    case 192:
      return tc::launch<192>(st, device, q, k, v, o, axes, batch, n_heads, kv_group, S,
                             T_len, D, os, causal, window, scale_log2, lse);
    default:
      return tc::launch<256>(st, device, q, k, v, o, axes, batch, n_heads, kv_group, S,
                             T_len, D, os, causal, window, scale_log2, lse);
  }
}
