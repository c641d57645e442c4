// The sLSTM scan of xLSTM on Hopper (sm_90a): the forward of the
// reference's _slstm_scan_p (repro/models/ssm.py:412, _slstm_scan_fwd_impl
// :356, one _slstm_cell :333 a position).
//
// Replaces no Pallas kernel: the reference steps the cell in a lax.scan.
// For every batch row b and head g, from h = c = n = 0 and m = -1e30:
//   rec[j]  = sum over u of h[u] * wr[g, u, j]              (j < 4 uh)
//   pre[j]  = (x[b, t, g 4uh + j] + rec[j]) + bias[g 4uh + j]
//   z, i, f, o = pre[0:uh], pre[uh:2uh], pre[2uh:3uh], pre[3uh:4uh]
//   logf = -(max(-f, 0) + log1p(exp(-|f|)))                  (log-sigmoid)
//   m' = max(logf + m, i);  i' = exp(i - m');  f' = exp((logf + m) - m')
//   c = f' c + i' tanh(z);  n = f' n + i';  h = sigmoid(o) c / max(n, 1e-6)
//   hs[b, t, g, :] = h
// Every step rounds to float32 as the plain version (kernels/ref.py::
// slstm_cell) rounds it, with no contraction into an FMA, except rec, whose
// order is fixed by the shape alone (Layout: `slice` and `slices`, the same
// for every plan): `slices` partial sums, each one fmaf chain over `slice`
// consecutive u from 0 (u ascending), added in slice order, rec = ((p_0 +
// p_1) + p_2) + ...  At uh = 256 that is 8 slices of 32 u.  The earlier
// design's single 256-term chain rounded otherwise, so hs is not its output
// bit for bit; tests/test_torch_ssm.py emulates this order against the
// reference within SCAN_TOL.  x, wr and bias are read in their stored dtype
// (float32 or bfloat16) and widened exactly.
//
// Bound on an H100: the recurrent product's 2 B S H uh 4uh float32
// operations at 67 TFLOP/s (1.03 ms for xlstm-350m's layer at 16 rows of
// 2,048 positions) against the bytes of x, hs and wr (0.12 ms).
//
// Design.  The recurrence is block-diagonal by head, so one thread-block
// cluster of C CTAs owns a head and a group of batch rows (slstm_scan.py::
// plan chooses C, the groups and the halves: at xlstm-350m's 4 x 256 and 16
// rows, clusters of 8, 3 groups of 5 or 6 rows in two halves, 12 clusters,
// as the card holds 15 clusters of 8 and not the 16 of 4-row groups).  CTA k
// owns units [k uh / C, (k + 1) uh / C), at most 32, with their four gate
// columns (u, uh + u, 2uh + u, 3uh + u), so the cell update needs nothing
// from a peer.  At the start each CTA copies its columns of wr into shared
// memory (row-major, in the stored dtype: 64 KB of bfloat16 or 128 KB of
// float32 at uh = 256); no position reads wr from L2 again.
//
// A group's rows form one or two halves of at most R = 4 rows, each a
// recurrence of its own (its threads, h buffers, mbarriers, named barrier).
// Each position a half:
//   1. waits on its parity's mbarrier until the cluster's h of the previous
//      position has arrived (h double-buffered by position parity);
//   2. product, on the CUDA cores in float32: a thread sums 8 gate columns
//      over its slice of u for each of the half's rows (8 R fmaf chains in
//      registers), 16-byte loads of wr and h (h a broadcast), the next 4
//      u's loaded while the current 4 are summed; each weight and h value
//      goes from shared memory to registers once for 8 R (R) products;
//   3. the cell: a thread a (row, unit) adds its four gates' partial sums
//      and updates c, n and m (in registers); it writes hs;
//   4. the exchange: the CTA's new h goes to every CTA of the cluster
//      (itself included) by st.async, 16 bytes a store where the share is
//      aligned, each completing its bytes on the receiver's mbarrier, so the
//      wait needs no cluster-scope fence.
// The two halves take turns at the product (named barriers), so one's cell
// and exchange run under the other's product.  x is loaded two positions
// ahead into registers.  Shared memory is padded to keep a second CTA off
// the SM.
//
// What holds it back (kernels/scan_probe.py's variants and clock64
// sections, PERF.md row 8): the product, about three fifths of the time; a
// thread's 4 u of 8 columns and R rows take 32 R fmaf, 32 widenings of
// bfloat16 and 4 + R shared-memory loads, and one half's 4 warps, one a
// scheduler, issue them at well under one a clock; the loads of h alone
// cost a tenth.  Delivering h to the peers costs nothing measurable, the
// cell math under a tenth.  Tried and slower on the card: one 256-term
// chain a column (shared memory delivers one word a lane a clock to 128
// FMA lanes), wr held in registers (128 a thread; ptxas spills), product
// warps apart from cell warps, two waves of 4-row groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// Mirrored by slstm_scan.py (MAX_UNITS, MAX_CLUSTER, MAX_SHARE, MAX_ROWS,
// MAX_HALVES, MAX_SMEM, ONE_PER_SM, slices_of and smem_bytes).
constexpr int kMaxUnits = 256;  // uh
constexpr int kMaxCluster = 8;  // CTAs a head (portable cluster size)
constexpr int kMaxShare = 32;   // units a CTA
constexpr int kMaxRows = 4;     // rows a half (a thread's fmaf chains: 8 a row)
constexpr int kMaxHalves = 2;
constexpr int kThreads = kMaxHalves * 4 * kMaxShare;
constexpr int kMaxSmem = 232448;
constexpr int kOnePerSm = 118784;  // two CTAs of this much do not fit an SM's 228 KB

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The product's geometry and the dynamic shared memory, in bytes from its
// base.  A half's threads split into ngroups groups of 8 gate columns times
// `slices` slices of u, `slice` u each (a multiple of 4): each thread sums
// its 8 columns over its slice for every row of the half.  Per half: two
// mbarriers, h [2][rows][uh8], the partial sums [rows][slices][cpad] and out
// [rows][share]; then the CTA's wr rows [uh][cpad] (columns 4 n .. cpad
// zero).
struct Layout {
  int share, uh8, cpad, ngroups, slice, slices, h_off, h_half, red_off, red_half, out_off,
      out_half, w_off, need;
  __host__ __device__ Layout(int uh, int cluster, int rows, int halves, int w_bytes) {
    share = (uh + cluster - 1) / cluster;
    uh8 = round_up(uh, 8);
    cpad = round_up(4 * share, 8);
    ngroups = cpad / 8;
    const int by_threads = round_up(4 * share, 32) / ngroups, by_u = (uh + 3) / 4;
    const int k = by_threads < by_u ? by_threads : by_u;
    slice = round_up((uh + k - 1) / k, 4);
    slices = (uh + slice - 1) / slice;
    h_off = 16 * kMaxHalves;
    h_half = 2 * rows * uh8 * 4;
    red_off = h_off + halves * h_half;
    red_half = rows * slices * cpad * 4;
    out_off = red_off + halves * red_half;
    out_half = round_up(rows * share * 4, 16);
    w_off = out_off + halves * out_half;
    need = w_off + round_up(uh * cpad * w_bytes, 16);
  }
};

int smem_for(int uh, int cluster, int rows, int halves, int w_bytes) {
  const int need = Layout(uh, cluster, rows, halves, w_bytes).need;
  return need > kOnePerSm ? need : kOnePerSm;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive weights of a column, as loaded (16 or 32 bytes) and widened.
template <typename TW>
struct W8;

template <>
struct W8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void widen(float (&w)[8]) const {
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x, w[5] = b.y, w[6] = b.z,
    w[7] = b.w;
  }
};

template <>
struct W8<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void widen(float (&w)[8]) const {
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[2 * k] = __uint_as_float(q[k] << 16);
      w[2 * k + 1] = __uint_as_float(q[k] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store to a peer's shared memory (addresses from map_rank), completing the
// bytes on the peer's mbarrier at `bar`.
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               ::"r"(addr), "f"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: the bytes came from peers' st.async.
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// What the backward (slstm_scan_bwd.cu) needs, written when not null: the
// gate pre-activations (B, S, 4 H uh) as x is laid out and the states c, n
// and m after each position (B, S, H, uh) as hs is, all float32.
struct Residuals {
  float* pre;
  float* c;
  float* n;
  float* m;
};

template <typename TX>
__device__ __forceinline__ TX zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// One round of the product: 4 u's weights of 8 columns and h of R rows.
template <typename TW, int R>
struct Chunk {
  W8<TW> w[4];
  float4 h[R];
  __device__ __forceinline__ void load(const TW* wq, int pitch, const float* hp, int uh8, int u) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j].load(wq + (size_t)j * pitch);
#pragma unroll
    for (int r = 0; r < R; ++r) h[r] = *reinterpret_cast<const float4*>(hp + r * uh8 + u);
  }
  // acc[r][c] += h[r][u + j] * w[u + j][c], j = 0 .. 3 in order.
  __device__ __forceinline__ void fma(float (&acc)[R][8]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float wf[8];
      w[j].widen(wf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hv = j == 0 ? h[r].x : j == 1 ? h[r].y : j == 2 ? h[r].z : h[r].w;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(hv, wf[c], acc[r][c]);
      }
    }
  }
};

// grid (C heads, groups), clusters of (C, 1, 1), halves x 4 share threads
// (rounded to warps) a CTA; group y owns rows [y B / groups, (y + 1) B /
// groups), its half p the p-th of `halves` even shares of them, at most R.
// Res: write the backward's Residuals (an instance of its own, so the
// forward without them compiles as it did before they existed).
#ifndef SLSTM_SCAN_HELPERS_ONLY
template <typename TX, typename TW, int R, bool Res>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_cluster(const TX* __restrict__ x, const TW* __restrict__ wr,
                  const TW* __restrict__ bias, float* __restrict__ hs, int batch, int seq,
                  int heads, int uh, int groups, int halves, const Residuals res) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cluster = (int)cluster_size();
  const int rank = (int)cluster_rank();
  const Layout L(uh, cluster, R, halves, (int)sizeof(TW));
  const int g = blockIdx.x / cluster;
  const int lo = rank * uh / cluster, n = (rank + 1) * uh / cluster - lo;  // this CTA's units
  const int g4 = 4 * uh;
  const int half_threads = (int)blockDim.x / halves;
  const int half = threadIdx.x / half_threads, tid = threadIdx.x % half_threads;
  const int gb0 = (int)((long long)blockIdx.y * batch / groups);
  const int grows = (int)((long long)(blockIdx.y + 1) * batch / groups) - gb0;
  const int b0 = gb0 + grows * half / halves;
  const int rows = gb0 + grows * (half + 1) / halves - b0;  // this half's rows, at most R
  float* h_s = reinterpret_cast<float*>(smem + L.h_off + half * L.h_half);
  float* red_s = reinterpret_cast<float*>(smem + L.red_off + half * L.red_half);
  float* out_s = reinterpret_cast<float*>(smem + L.out_off + half * L.out_half);
  const TW* w_s = reinterpret_cast<const TW*>(smem + L.w_off);
  const uint32_t bar0 = smem_u32(smem) + 16 * half;  // parity q's mbarrier at bar0 + 8 q
  const uint32_t bytes = (uint32_t)rows * uh * 4;  // a position's h, from the whole cluster

  for (int i = tid; i < 2 * R * L.uh8; i += half_threads) h_s[i] = 0.f;
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    if (seq >= 2) mbar_expect_tx(bar0 + 8, bytes);  // h of position 0 lands in parity 1
    if (seq >= 3) mbar_expect_tx(bar0, bytes);      // h of position 1 in parity 0
    fence_barrier_init();
  }
  // This CTA's columns of head g's wr, row-major with zero padding: read
  // once a call.  Column c < 4 n is gate c / n of unit lo + c % n.
  {
    const TW* src = wr + (size_t)g * uh * g4 + lo;
    TW* dst = reinterpret_cast<TW*>(smem + L.w_off);
    for (int i = threadIdx.x; i < uh * L.cpad; i += blockDim.x) {
      const int u = i / L.cpad, c = i % L.cpad;
      dst[i] = c < 4 * n ? src[(size_t)u * g4 + (c / n) * uh + c % n] : zero<TW>();
    }
  }
  // The product: thread tid sums columns 8 cg .. 8 cg + 7 over u in
  // [u0, u1) for each of the half's rows.
  const int cg = tid % L.ngroups, ks = tid / L.ngroups;
  const bool prod = ks < L.slices;
  const int u0 = prod ? ks * L.slice : 0, u1 = prod ? min(u0 + L.slice, uh) : 0;
  const int u4 = u0 + ((u1 - u0) & ~3);
  const TW* wq = w_s + (size_t)u0 * L.cpad + 8 * cg;
  // The cell: thread tid's (row, unit) with its four gates' x and bias.
  const bool cell = tid < rows * n;
  const int cr = cell ? tid / n : 0, ci = cell ? tid % n : 0;
  float bq[4];
  const size_t x_step = (size_t)heads * g4;
  const TX* xq = x + (size_t)(b0 + cr) * seq * x_step + g * g4 + lo + ci;
#pragma unroll
  for (int q = 0; q < 4; ++q) bq[q] = cell ? widen(bias[g * g4 + q * uh + lo + ci]) : 0.f;
  float c_st = 0.f, n_st = 0.f, m_st = -1e30f;
  // The exchange: element e of this CTA's new h (a float4 of a row where the
  // share is aligned, else a float) to peers p0, p0 + stride, ...
  const bool vec = (lo % 4 == 0) && (n % 4 == 0);
  const int width = vec ? 4 : 1, per_row = n / width, elems = rows * per_row;
  const int stride = half_threads / elems;
  const bool sender = tid < elems * stride;
  const int e = sender ? tid % elems : 0, p0 = sender ? tid / elems : 0;
  const int er = e / per_row, eu = width * (e % per_row);
  const float* src_e = out_s + er * n + eu;
  const uint32_t dst_e = smem_u32(h_s + er * L.uh8 + lo + eu);  // parity 0; + h_half / 2 for 1
  TX x_cur[4], x_next[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x_cur[q] = cell ? xq[q * uh] : zero<TX>();
    x_next[q] = cell && seq > 1 ? xq[x_step + q * uh] : zero<TX>();
  }
  // Two halves take turns at the product (named barriers 3 and 4, half 0
  // first): each one's cell and exchange run under the other's product.
  const bool turns = halves == 2;
  if (turns && half == 1) named_bar_arrive(3, 2 * half_threads);
  cluster_sync();  // every CTA's barriers are initialised, its h zeroed and wr copied

  for (int t = 0; t < seq; ++t) {
    TX x_far[4];  // position t + 2, loaded two positions ahead
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x_far[q] = cell && t + 2 < seq ? xq[(size_t)(t + 2) * x_step + q * uh] : zero<TX>();
    if (t > 0) {
      const uint32_t bar = bar0 + 8 * (t & 1);
      wait_cluster(bar, ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 < seq) mbar_expect_tx(bar, bytes);  // h of position t + 1
    }
    const float* hp = h_s + (t & 1) * R * L.uh8;
    if (turns) named_bar_sync(3 + half, 2 * half_threads);  // the other half's product is done
    if (prod) {
      float acc[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      // Rounds of 4 u, two register sets in turn: one loads while the other
      // is summed.
      const int rounds = (u4 - u0) / 4;
      Chunk<TW, R> ca, cb;
      if (rounds > 0) ca.load(wq, L.cpad, hp, L.uh8, u0);
      for (int k = 0; k + 1 < rounds; k += 2) {
        cb.load(wq + (size_t)(4 * k + 4) * L.cpad, L.cpad, hp, L.uh8, u0 + 4 * k + 4);
        ca.fma(acc);
        const int next = k + 2 < rounds ? k + 2 : k + 1;  // the last pair reloads its own
        ca.load(wq + (size_t)(4 * next) * L.cpad, L.cpad, hp, L.uh8, u0 + 4 * next);
        cb.fma(acc);
      }
      if (rounds % 2) ca.fma(acc);
      for (int u = u4; u < u1; ++u) {
        W8<TW> w1;
        w1.load(wq + (size_t)(u - u0) * L.cpad);
        float w[8];
        w1.widen(w);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float h = hp[r * L.uh8 + u];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(h, w[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float* dst = red_s + (r * L.slices + ks) * L.cpad + 8 * cg;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
    if (turns && !(half == 1 && t + 1 == seq)) named_bar_arrive(4 - half, 2 * half_threads);
    named_bar_sync(1 + half, half_threads);  // the partial sums are whole
    if (cell) {
      // rec = ((p_0 + p_1) + p_2) + ... over the slices, the four gates'
      // sums side by side.
      const float* pq = red_s + cr * L.slices * L.cpad + ci;
      float rec[4], pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) rec[q] = pq[q * n];
#pragma unroll 4
      for (int k = 1; k < L.slices; ++k) {
        float pk[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) pk[q] = pq[k * L.cpad + q * n];
#pragma unroll
        for (int q = 0; q < 4; ++q) rec[q] = __fadd_rn(rec[q], pk[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) pre[q] = __fadd_rn(__fadd_rn(widen(x_cur[q]), rec[q]), bq[q]);
      const float zt = pre[0], it = pre[1], ft = pre[2], ot = pre[3];
      const float logf = -__fadd_rn(fmaxf(-ft, 0.f), log1pf(expf(-fabsf(ft))));
      const float lm = __fadd_rn(logf, m_st);
      const float m_new = fmaxf(lm, it);
      const float i_p = expf(__fsub_rn(it, m_new));
      const float f_p = expf(__fsub_rn(lm, m_new));
      c_st = __fadd_rn(__fmul_rn(f_p, c_st), __fmul_rn(i_p, tanhf(zt)));
      n_st = __fadd_rn(__fmul_rn(f_p, n_st), i_p);
      m_st = m_new;
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-ot)));
      const float h = __fdiv_rn(__fmul_rn(sig, c_st), fmaxf(n_st, 1e-6f));
      const size_t at = ((size_t)(b0 + cr) * seq + t) * heads * uh + (size_t)g * uh + lo + ci;
      hs[at] = h;
      out_s[cr * n + ci] = h;
      if constexpr (Res) {
        float* pq = res.pre + ((size_t)(b0 + cr) * seq + t) * x_step + g * g4 + lo + ci;
#pragma unroll
        for (int q = 0; q < 4; ++q) pq[q * uh] = pre[q];
        res.c[at] = c_st;
        res.n[at] = n_st;
        res.m[at] = m_st;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) x_cur[q] = x_next[q], x_next[q] = x_far[q];
    if (t + 1 < seq) {
      named_bar_sync(1 + half, half_threads);  // out is whole; the partial sums are read
      // This CTA's h into parity (t + 1)'s buffer of every CTA of the cluster.
      const uint32_t dst = dst_e + ((t + 1) & 1) * (L.h_half / 2);
      const uint32_t bar = bar0 + 8 * ((t + 1) & 1);
      if (sender) {
        if (vec) {
          const float4 v = *reinterpret_cast<const float4*>(src_e);
          for (int k = p0; k < cluster; k += stride)
            st_async(map_rank(dst, k), v, map_rank(bar, k));
        } else {
          const float v = *src_e;
          for (int k = p0; k < cluster; k += stride)
            st_async(map_rank(dst, k), v, map_rank(bar, k));
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still address its shared memory
}

template <typename TX, typename TW, int R, bool Res>
cudaError_t launch_rows(int device, const void* x, const void* wr, const void* bias, float* hs,
                        int batch, int seq, int heads, int uh, int cluster, int groups,
                        int halves, int smem, cudaStream_t stream, int* max_clusters,
                        const Residuals& res) {
  auto fn = slstm_cluster<TX, TW, R, Res>;
  static int set_smem[64] = {};  // per device: the bytes already allowed
  cudaError_t err = cudaSuccess;
  if (device >= 64 || set_smem[device] < smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < 64) set_smem[device] = smem;
  }
  const int share = (uh + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * heads, groups);
  cfg.blockDim = dim3(halves * round_up(4 * share, 32));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, fn, &cfg);
  err = cudaLaunchKernelEx(&cfg, fn, (const TX*)x, (const TW*)wr, (const TW*)bias, hs, batch,
                           seq, heads, uh, groups, halves, res);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_types(int device, const void* x, const void* wr, const void* bias, float* hs,
                         int batch, int seq, int heads, int uh, int cluster, int groups,
                         int halves, int rows, int smem, cudaStream_t s, int* max_clusters,
                         const Residuals& res) {
  switch (rows) {
    case 1:
      return res.pre ? launch_rows<TX, TW, 1, true>(device, x, wr, bias, hs, batch, seq,
                                                      heads, uh, cluster, groups, halves, smem,
                                                      s, max_clusters, res)
                     : launch_rows<TX, TW, 1, false>(device, x, wr, bias, hs, batch, seq,
                                                       heads, uh, cluster, groups, halves, smem,
                                                       s, max_clusters, res);
    case 2:
      return res.pre ? launch_rows<TX, TW, 2, true>(device, x, wr, bias, hs, batch, seq,
                                                      heads, uh, cluster, groups, halves, smem,
                                                      s, max_clusters, res)
                     : launch_rows<TX, TW, 2, false>(device, x, wr, bias, hs, batch, seq,
                                                       heads, uh, cluster, groups, halves, smem,
                                                       s, max_clusters, res);
    case 3:
      return res.pre ? launch_rows<TX, TW, 3, true>(device, x, wr, bias, hs, batch, seq,
                                                      heads, uh, cluster, groups, halves, smem,
                                                      s, max_clusters, res)
                     : launch_rows<TX, TW, 3, false>(device, x, wr, bias, hs, batch, seq,
                                                       heads, uh, cluster, groups, halves, smem,
                                                       s, max_clusters, res);
    case 4:
      return res.pre ? launch_rows<TX, TW, 4, true>(device, x, wr, bias, hs, batch, seq,
                                                      heads, uh, cluster, groups, halves, smem,
                                                      s, max_clusters, res)
                     : launch_rows<TX, TW, 4, false>(device, x, wr, bias, hs, batch, seq,
                                                       heads, uh, cluster, groups, halves, smem,
                                                       s, max_clusters, res);
    default:
      return cudaErrorInvalidValue;
  }
}

#endif  // SLSTM_SCAN_HELPERS_ONLY

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

// The rows of the most-filled half: ceil(ceil(B / groups) / halves).
int rows_of(int batch, int groups, int halves) {
  const int group = (batch + groups - 1) / groups;
  return (group + halves - 1) / halves;
}

#ifndef SLSTM_SCAN_HELPERS_ONLY
// The launch (or, with max_clusters, the occupancy query) of one plan.
int dispatch(int device, void* stream, int x_dtype, int w_dtype, const void* x, const void* wr,
             const void* bias, float* hs, int batch, int seq, int heads, int uh, int cluster,
             int groups, int halves, int smem, int* max_clusters, const Residuals& res) {
  if (uh < 1 || uh > kMaxUnits || heads < 1 || batch < 1 || seq < 1 || (x_dtype & ~1) ||
      (w_dtype & ~1) || cluster < 1 || cluster > kMaxCluster || cluster > uh ||
      (uh + cluster - 1) / cluster > kMaxShare || (long long)cluster * heads > 0x7fffffff ||
      groups < 1 || groups > 65535 || groups > batch || halves < 1 || halves > kMaxHalves ||
      batch / groups < halves)
    return (int)cudaErrorInvalidValue;
  const int rows = rows_of(batch, groups, halves);
  if (rows > kMaxRows || smem != smem_for(uh, cluster, rows, halves, w_dtype ? 2 : 4) ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch_types<float, float>(device, x, wr, bias, hs, batch, seq, heads, uh, cluster,
                                     groups, halves, rows, smem, s, max_clusters, res);
  else if (x_dtype == 0)
    err = launch_types<float, __nv_bfloat16>(device, x, wr, bias, hs, batch, seq, heads, uh,
                                             cluster, groups, halves, rows, smem, s,
                                             max_clusters, res);
  else if (w_dtype == 0)
    err = launch_types<__nv_bfloat16, float>(device, x, wr, bias, hs, batch, seq, heads, uh,
                                             cluster, groups, halves, rows, smem, s,
                                             max_clusters, res);
  else
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(device, x, wr, bias, hs, batch, seq, heads,
                                                     uh, cluster, groups, halves, rows, smem, s,
                                                     max_clusters, res);
  return (int)err;
}
#endif  // SLSTM_SCAN_HELPERS_ONLY

}  // namespace

#ifndef SLSTM_SCAN_HELPERS_ONLY
// x (B, S, 4 H uh) of x_dtype, wr (H, uh, 4 uh) and bias (4 H uh) of
// w_dtype (0 float32, 1 bfloat16); hs (B, S, H, uh) float32; all
// contiguous.  The plan (slstm_scan.py::plan): clusters of `cluster` CTAs a
// head (1-8, at most uh, at most 32 units a CTA), `groups` groups of batch
// rows (the grid's y; B / groups >= halves), `halves` halves a CTA (1 or 2,
// at most 4 rows each), `smem` bytes of dynamic shared memory (smem_for's,
// slstm_scan.py::smem_bytes).  pre, c, n and m: all null, or the
// Residuals the backward reads (pre (B, S, 4 H uh), the others (B, S, H,
// uh), float32, contiguous); hs is the same bits either way.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan this source does
// not take.
extern "C" int slstm_scan_launch(int device, void* stream, int x_dtype, int w_dtype,
                                 const void* x, const void* wr, const void* bias, float* hs,
                                 int batch, int seq, int heads, int uh, int cluster, int groups,
                                 int halves, int smem, float* pre, float* c, float* n, float* m) {
  if ((pre == nullptr) != (c == nullptr) || (c == nullptr) != (n == nullptr) ||
      (n == nullptr) != (m == nullptr))
    return (int)cudaErrorInvalidValue;
  return dispatch(device, stream, x_dtype, w_dtype, x, wr, bias, hs, batch, seq, heads, uh,
                  cluster, groups, halves, smem, nullptr, Residuals{pre, c, n, m});
}

// How many clusters of a plan's launch can be resident on the device at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int slstm_scan_max_clusters(int device, int x_dtype, int w_dtype, int batch,
                                       int heads, int uh, int cluster, int groups, int halves,
                                       int smem) {
  int count = 0;
  const int err = dispatch(device, nullptr, x_dtype, w_dtype, nullptr, nullptr, nullptr, nullptr,
                           batch, 1, heads, uh, cluster, groups, halves, smem, &count,
                           Residuals{nullptr, nullptr, nullptr, nullptr});
  return err == 0 ? count : -err;
}
#endif  // SLSTM_SCAN_HELPERS_ONLY
