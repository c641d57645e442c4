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
// it where n >= 1e-6.  The recurrent product dpre_t wr^T adds its 4 uh
// terms in `slices` fmaf chains over `slice` consecutive gate columns each,
// added in slice order (BwdLayout), an order fixed by uh alone; the plain
// version's einsum takes cuBLAS's order (tests/test_torch_ssm.py emulates
// this one).  The forward kernel (slstm_scan.cu) writes pre_t and the
// states c, n, m after every position when a gradient is needed.  dwr =
// hs_prev^T dpre and dbias = sum dpre are one float32 matrix product a head
// and one sum outside the kernel (slstm_scan.py), as the reference's VJP
// takes them as einsums.
//
// Bound on an H100: the recurrent product's 2 B S H uh 4uh float32
// operations at 67 TFLOP/s (0.256 ms for xlstm-350m's layer at its training
// microbatch of 4 rows of 2,048 positions) against its bytes at 3.35 TB/s:
// 48 a position and unit (pre and dpre 16 each, the states c, n and m 12,
// dhs 4) and wr once, 0.12 ms there.
//
// Design.  The forward's cluster plan (slstm_scan.py::plan,
// backward=True): one thread-block cluster of C CTAs a head and group of
// batch rows, CTA k owning units [k uh / C, (k + 1) uh / C), at most 32.  Each CTA holds its
// units' rows of wr over all 4 uh gate columns in shared memory,
// transposed (wT[j][u], 64 KB of bfloat16 at uh = 256), so it computes dh
// for its own units from the whole dpre_{t+1}; it computes dpre_t of its
// units' four gates (a thread a row and unit, its dc, dn and dm in
// registers) and sends them to every CTA of the cluster by st.async on the
// receivers' mbarriers (an all-gather of 4 uh values a row, where the
// forward gathers uh), one wait a position.  The product, the halves that
// take turns at it and the double-buffered exchange are the forward's
// (its W8, Chunk, st_async, wait_cluster, included below), over 4 uh inputs
// and the CTA's units as columns instead of uh inputs and 4 units' gates.
//
// What it reaches (chip_smoke.py phase 2, CUDA events around one call;
// PERF.md row 8b): 5.0 ms at 4 rows (19x the bound; the plan runs 8
// clusters of 8 CTAs, so most of the card idles, and a position's chain of
// wait, product, cell and exchange is serial) and 8.0 ms at 16 (7.8x).
// Not split yet: the exchange, four times the forward's bytes, against the
// product.

#define SLSTM_SCAN_HELPERS_ONLY  // the forward's helpers, not its kernels or entries
#include "slstm_scan.cu"

namespace {

// The backward's product and shared memory, in bytes from its base.  Inputs
// j < K = 4 uh (dpre's gate columns), outputs the CTA's `share` units padded
// to cpad; a half's threads split into ngroups groups of 8 outputs times
// `slices` slices of `slice` inputs (a multiple of 4).  Per half: two
// mbarriers, dpre [2][rows][K8], the partial sums [rows][slices][cpad] and
// the CTA's new dpre [rows][4][share]; then wT [K][cpad] (units share .. cpad
// zero).
struct BwdLayout {
  int share, k8, cpad, ngroups, slice, slices, h_off, h_half, red_off, red_half, out_off,
      out_half, w_off, need;
  __host__ __device__ BwdLayout(int uh, int cluster, int rows, int halves, int w_bytes) {
    const int kk = 4 * uh;
    share = (uh + cluster - 1) / cluster;
    k8 = round_up(kk, 8);
    cpad = round_up(share, 8);
    ngroups = cpad / 8;
    const int by_threads = round_up(4 * share, 32) / ngroups, by_u = (kk + 3) / 4;
    const int k = by_threads < by_u ? by_threads : by_u;
    slice = round_up((kk + k - 1) / k, 4);
    slices = (kk + slice - 1) / slice;
    h_off = 16 * kMaxHalves;
    h_half = 2 * rows * k8 * 4;
    red_off = h_off + halves * h_half;
    red_half = rows * slices * cpad * 4;
    out_off = red_off + halves * red_half;
    out_half = round_up(rows * 4 * share * 4, 16);
    w_off = out_off + halves * out_half;
    need = w_off + round_up(kk * cpad * w_bytes, 16);
  }
};

int bwd_smem_for(int uh, int cluster, int rows, int halves, int w_bytes) {
  const int need = BwdLayout(uh, cluster, rows, halves, w_bytes).need;
  return need > kOnePerSm ? need : kOnePerSm;
}

// grid (C heads, groups), clusters of (C, 1, 1), halves x round_up(4 share,
// 32) threads a CTA; rows as the forward splits them.
template <typename TW, int R>
__global__ void __launch_bounds__(kThreads, 1)
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
  const int half_threads = (int)blockDim.x / halves;
  const int half = threadIdx.x / half_threads, tid = threadIdx.x % half_threads;
  const int gb0 = (int)((long long)blockIdx.y * batch / groups);
  const int grows = (int)((long long)(blockIdx.y + 1) * batch / groups) - gb0;
  const int b0 = gb0 + grows * half / halves;
  const int rows = gb0 + grows * (half + 1) / halves - b0;  // this half's rows, at most R
  float* h_s = reinterpret_cast<float*>(smem + L.h_off + half * L.h_half);  // dpre_{t+1}
  float* red_s = reinterpret_cast<float*>(smem + L.red_off + half * L.red_half);
  float* out_s = reinterpret_cast<float*>(smem + L.out_off + half * L.out_half);
  const TW* w_s = reinterpret_cast<const TW*>(smem + L.w_off);
  const uint32_t bar0 = smem_u32(smem) + 16 * half;  // parity q's mbarrier at bar0 + 8 q
  const uint32_t bytes = (uint32_t)rows * g4 * 4;  // a position's dpre, from the whole cluster

  for (int i = tid; i < 2 * R * L.k8; i += half_threads) h_s[i] = 0.f;
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    if (seq >= 2) mbar_expect_tx(bar0 + 8, bytes);  // the last position's dpre lands in parity 1
    if (seq >= 3) mbar_expect_tx(bar0, bytes);      // the one before in parity 0
    fence_barrier_init();
  }
  // This CTA's units' rows of head g's wr over all gate columns, transposed:
  // wT[j][c] = wr[g, lo + c, j], zero for c >= n.  Read once a call.
  {
    const TW* src = wr + ((size_t)g * uh + lo) * g4;
    TW* dst = reinterpret_cast<TW*>(smem + L.w_off);
    for (int i = threadIdx.x; i < g4 * L.cpad; i += blockDim.x) {
      const int c = i / g4, j = i % g4;  // j fastest: the reads coalesce
      dst[j * L.cpad + c] = c < n ? src[(size_t)c * g4 + j] : zero<TW>();
    }
  }
  // The product: thread tid sums units 8 cg .. 8 cg + 7 over the gate columns
  // j in [u0, u1) for each of the half's rows.
  const int cg = tid % L.ngroups, ks = tid / L.ngroups;
  const bool prod = ks < L.slices;
  const int u0 = prod ? ks * L.slice : 0, u1 = prod ? min(u0 + L.slice, g4) : 0;
  const int u4 = u0 + ((u1 - u0) & ~3);
  const TW* wq = w_s + (size_t)u0 * L.cpad + 8 * cg;
  // The cell: thread tid's (row, unit) and its carries.
  const bool cell = tid < rows * n;
  const int cr = cell ? tid / n : 0, ci = cell ? tid % n : 0;
  const size_t x_step = (size_t)heads * g4, s_step = (size_t)heads * uh;
  const size_t prow = (size_t)(b0 + cr) * seq * x_step + g * g4 + lo + ci;
  const size_t srow = (size_t)(b0 + cr) * seq * s_step + (size_t)g * uh + lo + ci;
  float dc = 0.f, dn = 0.f, dm = 0.f;
  // The exchange: element e of this CTA's new dpre (4 gates of `n` units a
  // row; float4s where the share and the gates' offsets are aligned).
  const bool vec = (lo % 4 == 0) && (n % 4 == 0) && (uh % 4 == 0);
  const int width = vec ? 4 : 1, per_gate = n / width, per_row = 4 * per_gate;
  const int elems = rows * per_row;
  const bool turns = halves == 2;
  if (turns && half == 1) named_bar_arrive(3, 2 * half_threads);
  cluster_sync();  // every CTA's barriers are initialised, its dpre zeroed and wr copied

  for (int it = 0; it < seq; ++it) {
    const int t = seq - 1 - it;  // the position, from the last back
    float pr[4], c1 = 0.f, n1 = 0.f, m1 = 0.f, c0 = 0.f, n0 = 0.f, m0 = -1e30f, dho = 0.f;
    if (cell) {
#pragma unroll
      for (int q = 0; q < 4; ++q) pr[q] = pre[prow + (size_t)t * x_step + q * uh];
      const size_t at = srow + (size_t)t * s_step;
      c1 = cs[at], n1 = ns[at], m1 = ms[at], dho = dhs[at];
      if (t > 0) c0 = cs[at - s_step], n0 = ns[at - s_step], m0 = ms[at - s_step];
    }
    if (it > 0) {
      const uint32_t bar = bar0 + 8 * (it & 1);
      wait_cluster(bar, ((it - 1) >> 1) & 1);
      if (tid == 0 && it + 2 < seq) mbar_expect_tx(bar, bytes);  // dpre of position t - 1
    }
    const float* hp = h_s + (it & 1) * R * L.k8;
    if (turns) named_bar_sync(3 + half, 2 * half_threads);  // the other half's product is done
    if (prod) {
      float acc[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      const int rounds = (u4 - u0) / 4;
      Chunk<TW, R> ca, cb;
      if (rounds > 0) ca.load(wq, L.cpad, hp, L.k8, u0);
      for (int k = 0; k + 1 < rounds; k += 2) {
        cb.load(wq + (size_t)(4 * k + 4) * L.cpad, L.cpad, hp, L.k8, u0 + 4 * k + 4);
        ca.fma(acc);
        const int next = k + 2 < rounds ? k + 2 : k + 1;  // the last pair reloads its own
        ca.load(wq + (size_t)(4 * next) * L.cpad, L.cpad, hp, L.k8, u0 + 4 * next);
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
          const float h = hp[r * L.k8 + u];
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
    if (turns && !(half == 1 && it + 1 == seq)) named_bar_arrive(4 - half, 2 * half_threads);
    named_bar_sync(1 + half, half_threads);  // the partial sums are whole
    if (cell) {
      // dh = (((p_0 + p_1) + p_2) + ...) + dhs[t], then the cell's backward
      // (ref.slstm_cell_bwd).
      const float* pq = red_s + cr * L.slices * L.cpad + ci;
      float dh = pq[0];
#pragma unroll 4
      for (int k = 1; k < L.slices; ++k) dh = __fadd_rn(dh, pq[k * L.cpad]);
      dh = __fadd_rn(dh, dho);
      const float zt = pr[0], itv = pr[1], ft = pr[2], ot = pr[3];
      const float logf = -__fadd_rn(fmaxf(-ft, 0.f), log1pf(expf(-fabsf(ft))));
      const float lm = __fadd_rn(logf, m0);
      const float i_p = expf(__fsub_rn(itv, m1));
      const float f_p = expf(__fsub_rn(lm, m1));
      const float tz = tanhf(zt);
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-ot)));
      const float nn = fmaxf(n1, 1e-6f);
      const float h = __fdiv_rn(__fmul_rn(sig, c1), nn);
      const float dq = __fdiv_rn(dh, nn);
      const float dc1 = __fadd_rn(dc, __fmul_rn(dq, sig));
      const float dn1 = __fadd_rn(dn, n1 >= 1e-6f ? -__fmul_rn(dq, h) : 0.f);
      const float d_o = __fmul_rn(__fmul_rn(dq, c1), __fmul_rn(sig, __fsub_rn(1.f, sig)));
      const float df_p = __fadd_rn(__fmul_rn(dc1, c0), __fmul_rn(dn1, n0));
      const float di_p = __fadd_rn(__fmul_rn(dc1, tz), dn1);
      const float d_z = __fmul_rn(__fmul_rn(dc1, i_p), __fsub_rn(1.f, __fmul_rn(tz, tz)));
      const float gi = __fmul_rn(di_p, i_p), gf = __fmul_rn(df_p, f_p);
      const float dm1 = __fsub_rn(__fsub_rn(dm, gi), gf);
      const float tie = lm == itv ? __fmul_rn(dm1, 0.5f) : 0.f;
      const float dlm = __fadd_rn(gf, lm > itv ? dm1 : tie);
      const float d_i = __fadd_rn(gi, itv > lm ? dm1 : tie);
      const float d_f = __fmul_rn(dlm, __fdiv_rn(1.f, __fadd_rn(1.f, expf(ft))));
      dc = __fmul_rn(dc1, f_p);
      dn = __fmul_rn(dn1, f_p);
      dm = dlm;
      const float dp[4] = {d_z, d_i, d_f, d_o};
      float* po = dpre + prow + (size_t)t * x_step;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        po[q * uh] = dp[q];
        out_s[(cr * 4 + q) * n + ci] = dp[q];
      }
    }
    if (it + 1 < seq) {
      named_bar_sync(1 + half, half_threads);  // out is whole; the partial sums are read
      // This CTA's dpre into parity (it + 1)'s buffer of every CTA of the cluster.
      const uint32_t parity = ((it + 1) & 1) * (L.h_half / 2);
      const uint32_t bar = bar0 + 8 * ((it + 1) & 1);
      for (int e = tid; e < elems; e += half_threads) {
        const int er = e / per_row, rem = e % per_row, q = rem / per_gate;
        const int eu = width * (rem % per_gate);
        const float* src = out_s + (er * 4 + q) * n + eu;
        const uint32_t dst = smem_u32(h_s + er * L.k8 + q * uh + lo + eu) + parity;
        if (vec) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          for (int k = 0; k < cluster; ++k) st_async(map_rank(dst, k), v, map_rank(bar, k));
        } else {
          const float v = *src;
          for (int k = 0; k < cluster; ++k) st_async(map_rank(dst, k), v, map_rank(bar, k));
        }
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
