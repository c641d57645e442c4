// The backward of the sLSTM scan of xLSTM on Hopper (sm_90a): the reverse
// scan of the reference's _slstm_scan_bwd (repro/models/ssm.py:375-406).
//
// Replaces no Pallas kernel: the reference's custom VJP steps jax.vjp of
// _slstm_cell (:333) backwards in a lax.scan.  As torch ops that is some
// forty launches a position; this kernel walks every position of a call in
// one launch.  For every batch row b and head g, from the last position t
// back, with dh = dc = dn = dm = 0 after the last:
//   dh      = (dpre_{t+1} wr^T) + dhs[t]   (dpre_{t+1} wr^T = 0 at the last)
//   dpre_t, (dc, dn, dm) = the cell's backward at t from pre_t, the states
//             before and after t and (dh, dc, dn, dm) after t
//   dpre[b, t, g 4uh + :] = dpre_t
// The cell's backward is kernels/ref.py::slstm_cell_bwd, the same float32
// formulas in the same order, none contracted into an FMA: the stabilizer's
// gradient dm is carried (it cancels only in exact arithmetic), a tie of
// max(logf + m, i) splits it half and half, and clamp_min(n, 1e-6) passes
// it where n >= 1e-6.  The recurrent product dpre_t wr^T is a
// reduce-scatter over the cluster: CTA k takes its own gate columns' share
// of every unit's sum (fmaf chains over `slice` consecutive columns of its
// local order, gate then unit, added in slice order: BwdLayout) and the
// owner of a unit adds the cluster's C partials in rank order, then dhs: an
// order fixed by uh alone (tests/test_torch_ssm_train.py emulates it; the
// plain version's einsum takes cuBLAS's).  The forward kernel
// (slstm_scan.cu) writes pre_t and the states c, n, m after every position
// when a gradient is needed.  dwr = hs_prev^T dpre and dbias = sum dpre are
// one float32 matrix product a head and one sum outside the kernel
// (slstm_scan.py), as the reference's VJP takes them as einsums.
//
// Bound on an H100: the recurrent product's 2 B S H uh 4uh float32
// operations at 67 TFLOP/s (0.256 ms for xlstm-350m's layer at its training
// microbatch of 4 rows of 2,048 positions) against its bytes at 3.35 TB/s:
// 48 a position and unit (pre and dpre 16 each, the states c, n and m 12,
// dhs 4) and wr once, 0.12 ms there.
//
// Design.  The forward's cluster plan (slstm_scan.py::plan, backward=True,
// with its own clocks): one thread-block cluster of C CTAs a head and group
// of batch rows, CTA k owning units [k uh / C, (k + 1) uh / C), at most 32,
// and their four gate columns.  Each CTA holds wr's rows over its own gate
// columns, transposed (wT[c][u], 64 KB of bfloat16 at uh = 256), in shared
// memory for the call.  A position is a chain of latencies, so what does
// not depend on the carries is taken off it.  A half's threads are product
// threads and cell threads (half as many, two cells each at most):
//   1. a cell thread waits on its parity's mbarrier for the cluster's
//      partial dh of position t, adds the C partials in rank order and
//      dhs, and runs the carried part (dq = dh / nn and some twenty
//      dependent products and sums): dpre_t of its unit's four gates, to
//      device memory and to the CTA's shared dpre; it arrives on a named
//      barrier;
//   2. the product threads take dpre_t: a thread sums 8 of the head's units
//      over a slice of the CTA's columns for each row of the half (the
//      forward's Chunk, 16-byte loads of wT, dpre a broadcast); the inputs
//      are the CTA's own, so no wait on the cluster;
//   3. meanwhile the cell thread loads position t - 3's residuals (three
//      ahead, in registers) and computes t - 1's carry-free terms: the
//      exponentials, log1p, tanh and the divisions of sig, h and d_f's
//      factor (Free);
//   4. reduce-scatter: the product threads add the slices' sums in order
//      and send each unit's owner its partial by st.async on the owner's
//      mbarrier (rows x uh floats a CTA, a quarter of an all-gather of
//      dpre's 4 uh), each thread's addresses worked out once.
// Two halves of a group's rows take turns at the product (named barriers),
// so one's cell and exchange run under the other's product.
//
// What it reaches (kernels/scan_probe.py --bwd --split, CUDA events, on an
// H100 at 700 W; PERF.md row 8b): 2.87 ms at 4 rows (11x the bound) and
// 5.46 at 16 (5.3x).  Without the product 1.90 and 2.99 ms: the rest is a
// chain of latencies a position (the partials' wait, their sum and the
// carried cell, the barriers, the reduce-scatter).  The product is held
// by shared memory: without wT's loads 2.27 and 4.46 ms, without their
// widening 2.65 and 4.70, with wT widened once into float32 (twice the
// bytes) 4.17 and 6.69.  The cell's math costs 0.17 and 0.36 ms, the
// exchange across CTAs 0.14 and 0.09.
//
#define SLSTM_SCAN_HELPERS_ONLY  // the forward's helpers, not its kernels or entries
#include "slstm_scan.cu"

namespace {

// The backward's product and shared memory, in bytes from its base.  A
// CTA's inputs are its 4 share gate columns (local column c = gate c / n of
// unit lo + c % n, zero from 4 n), padded to kk = slices x slice; its
// outputs are the uh units of the head, padded to uh8.  A half's threads
// split into ngroups groups of 8 outputs times `slices` slices of `slice`
// inputs (a multiple of 4).  Per half: two mbarriers, the CTA's new dpre
// [rows][kk], the partial sums [rows][slices][uh8] and, double-buffered by
// parity, the partial dh the cluster sends this CTA [2][rows][cluster][sp]
// (sp = share rounded to 4); then wT [kk][uh8] (wT[c][u] = wr[g, u, gate
// column of c], zero outside).
struct BwdLayout {
  int share, uh8, ngroups, slice, slices, kk, sp, pre_off, pre_half, red_off, red_half,
      recv_off, recv_half, w_off, need;
  __host__ __device__ BwdLayout(int uh, int cluster, int rows, int halves, int w_bytes) {
    share = (uh + cluster - 1) / cluster;
    uh8 = round_up(uh, 8);
    ngroups = uh8 / 8;
    const int inputs = 4 * share;
    const int by_threads = round_up(inputs, 32) / ngroups, by_u = share;
    const int k = by_threads < by_u ? by_threads : by_u;
    slice = round_up((inputs + k - 1) / k, 4);
    slices = (inputs + slice - 1) / slice;
    kk = slices * slice;
    sp = round_up(share, 4);
    pre_off = 16 * kMaxHalves;
    pre_half = rows * kk * 4;
    red_off = pre_off + halves * pre_half;
    red_half = rows * slices * uh8 * 4;
    recv_off = red_off + halves * red_half;
    recv_half = 2 * rows * cluster * sp * 4;
    w_off = recv_off + halves * recv_half;
    need = w_off + round_up(kk * uh8 * w_bytes, 16);
  }
};

int bwd_smem_for(int uh, int cluster, int rows, int halves, int w_bytes) {
  const int need = BwdLayout(uh, cluster, rows, halves, w_bytes).need;
  return need > kOnePerSm ? need : kOnePerSm;
}

// One (row, unit)'s residuals at a position: pre's four gates, the states
// c, n and m after it, and dhs.
struct Res {
  float pr[4], c, n, m, dh;
  __device__ __forceinline__ void load(const float* pre, const float* cs, const float* ns,
                                       const float* ms, const float* dhs, size_t p, size_t s,
                                       int uh) {
#pragma unroll
    for (int q = 0; q < 4; ++q) pr[q] = pre[p + (size_t)q * uh];
    c = cs[s], n = ns[s], m = ms[s], dh = dhs[s];
  }
};

// What the cell's backward at a position needs beyond the carries: every
// term of ref.slstm_cell_bwd that depends on pre_t and the states around t
// alone, with the same float32 operations on the same operands.
struct Free {
  float c0, n0, c1, lm, it, i_p, f_p, tz, sig, nn, h, do_f, dz_f, df_f;
  bool live;  // n_t >= 1e-6: clamp_min passes the gradient
};

__device__ __forceinline__ Free carry_free(const Res& r, float c0, float n0, float m0) {
  Free f;
  const float zt = r.pr[0], itv = r.pr[1], ft = r.pr[2], ot = r.pr[3];
  const float logf = -__fadd_rn(fmaxf(-ft, 0.f), log1pf(expf(-fabsf(ft))));
  f.lm = __fadd_rn(logf, m0);
  f.it = itv;
  f.i_p = expf(__fsub_rn(itv, r.m));
  f.f_p = expf(__fsub_rn(f.lm, r.m));
  f.tz = tanhf(zt);
  f.sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-ot)));
  f.nn = fmaxf(r.n, 1e-6f);
  f.h = __fdiv_rn(__fmul_rn(f.sig, r.c), f.nn);
  f.do_f = __fmul_rn(f.sig, __fsub_rn(1.f, f.sig));
  f.dz_f = __fsub_rn(1.f, __fmul_rn(f.tz, f.tz));
  f.df_f = __fdiv_rn(1.f, __fadd_rn(1.f, expf(ft)));
  f.c0 = c0, f.n0 = n0, f.c1 = r.c;
  f.live = r.n >= 1e-6f;
  return f;
}

// The rest of the cell's backward, on the chain: dpre_t's four gates from
// dh and the carries after t, which become the carries before t.
__device__ __forceinline__ void carried(const Free& f, float dh, float& dc, float& dn, float& dm,
                                        float (&dp)[4]) {
  const float dq = __fdiv_rn(dh, f.nn);
  const float dc1 = __fadd_rn(dc, __fmul_rn(dq, f.sig));
  const float dn1 = __fadd_rn(dn, f.live ? -__fmul_rn(dq, f.h) : 0.f);
  const float d_o = __fmul_rn(__fmul_rn(dq, f.c1), f.do_f);
  const float df_p = __fadd_rn(__fmul_rn(dc1, f.c0), __fmul_rn(dn1, f.n0));
  const float di_p = __fadd_rn(__fmul_rn(dc1, f.tz), dn1);
  const float d_z = __fmul_rn(__fmul_rn(dc1, f.i_p), f.dz_f);
  const float gi = __fmul_rn(di_p, f.i_p), gf = __fmul_rn(df_p, f.f_p);
  const float dm1 = __fsub_rn(__fsub_rn(dm, gi), gf);
  const float tie = f.lm == f.it ? __fmul_rn(dm1, 0.5f) : 0.f;
  const float dlm = __fadd_rn(gf, f.lm > f.it ? dm1 : tie);
  dp[0] = d_z;
  dp[1] = __fadd_rn(gi, f.it > f.lm ? dm1 : tie);
  dp[2] = __fmul_rn(dlm, f.df_f);
  dp[3] = d_o;
  dc = __fmul_rn(dc1, f.f_p);
  dn = __fmul_rn(dn1, f.f_p);
  dm = dlm;
}

// A half's threads: product threads (the forward's round_up(4 share, 32))
// and cell threads (half as many, rounded to warps), each cell thread
// holding at most two (row, unit) cells.
__host__ __device__ constexpr int bwd_product_threads(int share) {
  return round_up(4 * share, 32);
}
__host__ __device__ constexpr int bwd_cell_threads(int share) {
  return round_up(bwd_product_threads(share) / 2, 32);
}
constexpr int kCells = 2;  // cells a cell thread
constexpr int kBwdThreads =
    kMaxHalves * (bwd_product_threads(kMaxShare) + bwd_cell_threads(kMaxShare));
// A product thread's items of the reduce-scatter: rows x uh / P <= 8 for
// every uh (P >= 4 share and share >= uh / 8).
constexpr int kItems = 8;

// grid (C heads, groups), clusters of (C, 1, 1), halves x (P + Q) threads a
// CTA (P product, Q cell threads a half); rows as the forward splits them.
template <typename TW, int R>
__global__ void __launch_bounds__(kBwdThreads, 1)
    slstm_bwd_cluster(const TW* __restrict__ wr, const float* __restrict__ pre,
                      const float* __restrict__ cs, const float* __restrict__ ns,
                      const float* __restrict__ ms, const float* __restrict__ dhs,
                      float* __restrict__ dpre, int batch, int seq, int heads, int uh,
                      int groups, int halves) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cluster = (int)cluster_size();
  const int rank = (int)cluster_rank();
  const BwdLayout L(uh, cluster, R, halves, (int)sizeof(TW));
  const int g = blockIdx.x / cluster;
  const int lo = rank * uh / cluster, n = (rank + 1) * uh / cluster - lo;  // this CTA's units
  const int g4 = 4 * uh;
  const int P = bwd_product_threads(L.share), Q = bwd_cell_threads(L.share);
  const int half = threadIdx.x / (P + Q), tid = threadIdx.x % (P + Q);
  const int gb0 = (int)((long long)blockIdx.y * batch / groups);
  const int grows = (int)((long long)(blockIdx.y + 1) * batch / groups) - gb0;
  const int b0 = gb0 + grows * half / halves;
  const int rows = gb0 + grows * (half + 1) / halves - b0;  // this half's rows, at most R
  float* pre_s = reinterpret_cast<float*>(smem + L.pre_off + half * L.pre_half);  // dpre_t
  float* red_s = reinterpret_cast<float*>(smem + L.red_off + half * L.red_half);
  float* recv_s = reinterpret_cast<float*>(smem + L.recv_off + half * L.recv_half);
  const TW* w_s = reinterpret_cast<const TW*>(smem + L.w_off);
  const uint32_t bar0 = smem_u32(smem) + 16 * half;  // parity q's mbarrier at bar0 + 8 q
  const uint32_t bytes = (uint32_t)rows * cluster * n * 4;  // a position's partial dh, from all
  // Named barriers: 1 + half, dpre_t written (cell threads arrive, product
  // threads wait); 5 + half, the partial sums whole (product threads); 3
  // and 4, the halves' turns at the product.
  const int ready = 1 + half, summed = 5 + half;

  for (int i = tid; i < R * L.kk; i += P + Q) pre_s[i] = 0.f;
  if (tid == P) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    if (seq >= 2) mbar_expect_tx(bar0 + 8, bytes);  // dh of the one before the last, parity 1
    if (seq >= 3) mbar_expect_tx(bar0, bytes);      // of the one before that, parity 0
    fence_barrier_init();
  }
  // This CTA's gate columns of head g's wr, transposed: wT[c][u] = wr[g, u,
  // (c / n) uh + lo + c % n], zero for c >= 4 n or u >= uh.  Read once a call.
  {
    const TW* src = wr + (size_t)g * uh * g4 + lo;
    TW* dst = reinterpret_cast<TW*>(smem + L.w_off);
    for (int i = threadIdx.x; i < L.kk * L.uh8; i += blockDim.x) {
      const int u = i / L.kk, c = i % L.kk;  // c fastest: the reads coalesce by gate
      dst[c * L.uh8 + u] =
          c < 4 * n && u < uh ? src[(size_t)u * g4 + (c / n) * uh + c % n] : zero<TW>();
    }
  }
  const bool turns = halves == 2;
  if (tid < P && turns && half == 1 && seq >= 2) named_bar_arrive(3, 2 * P);
  cluster_sync();  // every CTA's barriers are initialised, its dpre zeroed and wr copied

  if (tid < P) {
    // A product thread: units 8 cg .. 8 cg + 7 of the head over the CTA's
    // gate columns [u0, u0 + slice) for each row of the half, then its
    // items of the reduce-scatter: item e (a float4 of 4 units of a row
    // where every CTA's share is 4-aligned, else a float) goes to the CTA
    // that owns its units, into slot `rank` of its row.  The items'
    // addresses are the same at every position: worked out once.
    const int cg = tid % L.ngroups, ks = tid / L.ngroups;
    const bool prod = ks < L.slices;
    const int u0 = prod ? ks * L.slice : 0;
    const TW* wq = w_s + (size_t)u0 * L.uh8 + 8 * cg;
    const bool vec = uh % (4 * cluster) == 0;
    const int width = vec ? 4 : 1, per_row = uh / width;
    int src_of[kItems], owner_of[kItems];
    uint32_t dst_of[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = tid + j * P;
      const int er = e / per_row, u = width * (e % per_row);
      owner_of[j] = er < rows ? ((u + 1) * cluster - 1) / uh : -1;
      src_of[j] = er * L.slices * L.uh8 + u;
      dst_of[j] = smem_u32(recv_s + (er * cluster + rank) * L.sp + u - owner_of[j] * uh / cluster);
    }
    const uint32_t parity_bytes = (uint32_t)R * cluster * L.sp * 4;
    for (int it = 0; it + 1 < seq; ++it) {
      named_bar_sync(ready, P + Q);  // dpre_t is whole
      if (turns) named_bar_sync(3 + half, 2 * P);  // the other half's product is done
      if (prod) {
        float acc[R][8];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
        // Rounds of 4 columns, two register sets in turn: one loads while
        // the other is summed.
        const int rounds = L.slice / 4;
        Chunk<TW, R> ca, cb;
        ca.load(wq, L.uh8, pre_s, L.kk, u0);
        for (int k = 0; k + 1 < rounds; k += 2) {
          cb.load(wq + (size_t)(4 * k + 4) * L.uh8, L.uh8, pre_s, L.kk, u0 + 4 * k + 4);
          ca.fma(acc);
          const int next = k + 2 < rounds ? k + 2 : k + 1;  // the last pair reloads its own
          ca.load(wq + (size_t)(4 * next) * L.uh8, L.uh8, pre_s, L.kk, u0 + 4 * next);
          cb.fma(acc);
        }
        if (rounds % 2) ca.fma(acc);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float* dst = red_s + (r * L.slices + ks) * L.uh8 + 8 * cg;
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      }
      if (turns && !(half == 1 && it + 2 == seq)) named_bar_arrive(4 - half, 2 * P);
      named_bar_sync(summed, P);  // the partial sums are whole
      // This CTA's partial dh of the position before, ((s_0 + s_1) + ...)
      // over the slices, to each unit's owner: parity (it + 1)'s slot.
      const int parity = (it + 1) & 1;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (owner_of[j] < 0) continue;
        const float* src = red_s + src_of[j];
        const uint32_t dst = map_rank(dst_of[j] + parity * parity_bytes, owner_of[j]);
        const uint32_t bar = map_rank(bar0 + 8 * parity, owner_of[j]);
        if (vec) {
          float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll 4
          for (int k = 1; k < L.slices; ++k) {
            const float4 w = *reinterpret_cast<const float4*>(src + k * L.uh8);
            v = make_float4(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y), __fadd_rn(v.z, w.z),
                            __fadd_rn(v.w, w.w));
          }
          st_async(dst, v, bar);
        } else {
          float v = src[0];
          for (int k = 1; k < L.slices; ++k) v = __fadd_rn(v, src[k * L.uh8]);
          st_async(dst, v, bar);
        }
      }
    }
  } else {
    // A cell thread: cells j = q + k Q (row j / n, unit j % n), each with
    // its residuals of the next three positions in registers and its
    // carries.
    const int q = tid - P;
    bool has[kCells];
    size_t prow[kCells], srow[kCells];
    int slot[kCells], from[kCells];  // its dpre in the shared dpre (gate 0), its partials
    Res a[kCells], b[kCells], c[kCells];  // positions t, t - 1 and t - 2
    Free f[kCells];                       // position t's carry-free terms
    float dc[kCells], dn[kCells], dm[kCells];
    const size_t x_step = (size_t)heads * g4, s_step = (size_t)heads * uh;
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int j = q + k * Q, cr = j / n, ci = j % n;
      has[k] = cr < rows;
      prow[k] = (size_t)(b0 + cr) * seq * x_step + g * g4 + lo + ci;
      srow[k] = (size_t)(b0 + cr) * seq * s_step + (size_t)g * uh + lo + ci;
      slot[k] = cr * L.kk + ci;
      from[k] = cr * cluster * L.sp + ci;
      a[k] = b[k] = c[k] = Res{};
      if (has[k]) a[k].load(pre, cs, ns, ms, dhs, prow[k] + (seq - 1) * x_step,
                            srow[k] + (seq - 1) * s_step, uh);
      if (has[k] && seq >= 2) b[k].load(pre, cs, ns, ms, dhs, prow[k] + (seq - 2) * x_step,
                                        srow[k] + (seq - 2) * s_step, uh);
      if (has[k] && seq >= 3) c[k].load(pre, cs, ns, ms, dhs, prow[k] + (seq - 3) * x_step,
                                        srow[k] + (seq - 3) * s_step, uh);
      f[k] = carry_free(a[k], seq > 1 ? b[k].c : 0.f, seq > 1 ? b[k].n : 0.f,
                        seq > 1 ? b[k].m : -1e30f);
      dc[k] = dn[k] = dm[k] = 0.f;
    }
    for (int it = 0; it < seq; ++it) {
      const int t = seq - 1 - it;  // the position, from the last back
      if (it > 0) {
        const uint32_t bar = bar0 + 8 * (it & 1);
        wait_cluster(bar, ((it - 1) >> 1) & 1);
        if (q == 0 && it + 2 < seq) mbar_expect_tx(bar, bytes);  // dh of position t - 2
      }
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        if (!has[k]) continue;
        // dh = (((p_0 + p_1) + p_2) + ... + p_{C-1}) + dhs[t], p_r CTA r's
        // partial, then the cell's carried part.
        float dh = a[k].dh;
        if (it > 0) {
          const float* rq = recv_s + (it & 1) * R * cluster * L.sp + from[k];
          float pk[kMaxCluster];
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r) pk[r] = r < cluster ? rq[r * L.sp] : 0.f;
          float p = pk[0];
#pragma unroll
          for (int r = 1; r < kMaxCluster; ++r) p = r < cluster ? __fadd_rn(p, pk[r]) : p;
          dh = __fadd_rn(p, dh);
        }
        float dp[4];
        carried(f[k], dh, dc[k], dn[k], dm[k], dp);
        float* po = dpre + prow[k] + (size_t)t * x_step;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          po[gate * uh] = dp[gate];
          pre_s[slot[k] + gate * n] = dp[gate];
        }
      }
      if (it + 1 == seq) break;
      named_bar_arrive(ready, P + Q);  // dpre_t is whole: the product threads go on
      // Under the product: position t - 3's residuals are loaded and t - 1's
      // carry-free terms computed.
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        a[k] = b[k];
        b[k] = c[k];
        c[k] = Res{};
        if (has[k] && t >= 3) c[k].load(pre, cs, ns, ms, dhs, prow[k] + (t - 3) * x_step,
                                        srow[k] + (t - 3) * s_step, uh);
        if (has[k]) f[k] = carry_free(a[k], t > 1 ? b[k].c : 0.f, t > 1 ? b[k].n : 0.f,
                                      t > 1 ? b[k].m : -1e30f);
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still address its shared memory
}

template <typename TW, int R>
cudaError_t bwd_launch_rows(int device, const void* wr, const float* pre, const float* cs,
                            const float* ns, const float* ms, const float* dhs, float* dpre,
                            int batch, int seq, int heads, int uh, int cluster, int groups,
                            int halves, int smem, cudaStream_t stream, int* max_clusters) {
  auto fn = slstm_bwd_cluster<TW, R>;
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
  cfg.blockDim = dim3(halves * (bwd_product_threads(share) + bwd_cell_threads(share)));
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
  err = cudaLaunchKernelEx(&cfg, fn, (const TW*)wr, pre, cs, ns, ms, dhs, dpre, batch, seq,
                           heads, uh, groups, halves);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TW>
cudaError_t bwd_launch_types(int device, const void* wr, const float* pre, const float* cs,
                             const float* ns, const float* ms, const float* dhs, float* dpre,
                             int batch, int seq, int heads, int uh, int cluster, int groups,
                             int halves, int rows, int smem, cudaStream_t s, int* max_clusters) {
  switch (rows) {
    case 1:
      return bwd_launch_rows<TW, 1>(device, wr, pre, cs, ns, ms, dhs, dpre, batch, seq, heads,
                                    uh, cluster, groups, halves, smem, s, max_clusters);
    case 2:
      return bwd_launch_rows<TW, 2>(device, wr, pre, cs, ns, ms, dhs, dpre, batch, seq, heads,
                                    uh, cluster, groups, halves, smem, s, max_clusters);
    case 3:
      return bwd_launch_rows<TW, 3>(device, wr, pre, cs, ns, ms, dhs, dpre, batch, seq, heads,
                                    uh, cluster, groups, halves, smem, s, max_clusters);
    case 4:
      return bwd_launch_rows<TW, 4>(device, wr, pre, cs, ns, ms, dhs, dpre, batch, seq, heads,
                                    uh, cluster, groups, halves, smem, s, max_clusters);
    default:
      return cudaErrorInvalidValue;
  }
}

int bwd_dispatch(int device, void* stream, int w_dtype, const void* wr, const float* pre,
                 const float* cs, const float* ns, const float* ms, const float* dhs,
                 float* dpre, int batch, int seq, int heads, int uh, int cluster, int groups,
                 int halves, int smem, int* max_clusters) {
  if (uh < 1 || uh > kMaxUnits || heads < 1 || batch < 1 || seq < 1 || (w_dtype & ~1) ||
      cluster < 1 || cluster > kMaxCluster || cluster > uh ||
      (uh + cluster - 1) / cluster > kMaxShare || (long long)cluster * heads > 0x7fffffff ||
      groups < 1 || groups > 65535 || groups > batch || halves < 1 || halves > kMaxHalves ||
      batch / groups < halves)
    return (int)cudaErrorInvalidValue;
  const int rows = rows_of(batch, groups, halves);
  if (rows > kMaxRows || smem != bwd_smem_for(uh, cluster, rows, halves, w_dtype ? 2 : 4) ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (w_dtype == 0)
    err = bwd_launch_types<float>(device, wr, pre, cs, ns, ms, dhs, dpre, batch, seq, heads, uh,
                                  cluster, groups, halves, rows, smem, s, max_clusters);
  else
    err = bwd_launch_types<__nv_bfloat16>(device, wr, pre, cs, ns, ms, dhs, dpre, batch, seq,
                                          heads, uh, cluster, groups, halves, rows, smem, s,
                                          max_clusters);
  return (int)err;
}

}  // namespace

// The backward: wr (H, uh, 4 uh) of w_dtype (0 float32, 1 bfloat16); the
// forward's residuals pre (B, S, 4 H uh) and c, n, m (B, S, H, uh), dhs (B,
// S, H, uh) and dpre (B, S, 4 H uh) float32; all contiguous.  The plan is
// slstm_scan.py::plan(..., backward=True)'s: as the forward's, with
// bwd_smem_for's (slstm_scan.py::smem_bytes(..., backward=True)) bytes.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan this
// source does not take.
extern "C" int slstm_scan_bwd_launch(int device, void* stream, int w_dtype, const void* wr,
                                     const float* pre, const float* c, const float* n,
                                     const float* m, const float* dhs, float* dpre, int batch,
                                     int seq, int heads, int uh, int cluster, int groups,
                                     int halves, int smem) {
  return bwd_dispatch(device, stream, w_dtype, wr, pre, c, n, m, dhs, dpre, batch, seq, heads,
                      uh, cluster, groups, halves, smem, nullptr);
}

// How many clusters of a backward plan's launch can be resident at once, or
// minus a CUDA error code.
extern "C" int slstm_scan_bwd_max_clusters(int device, int w_dtype, int batch, int heads, int uh,
                                           int cluster, int groups, int halves, int smem) {
  int count = 0;
  const int err = bwd_dispatch(device, nullptr, w_dtype, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, batch, 1, heads, uh, cluster, groups,
                               halves, smem, &count);
  return err == 0 ? count : -err;
}
