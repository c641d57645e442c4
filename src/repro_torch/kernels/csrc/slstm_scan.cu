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
// slstm_cell) rounds it, with no contraction into an FMA, except rec: the
// kernel adds its uh products in the order u = 0, 1, ... (by fmaf), where
// the plain version's einsum takes cuBLAS's order.  x, wr and bias are read
// in their stored dtype (float32 or bfloat16) and widened exactly.
//
// Bound on an H100: the recurrent product's 2 B S H uh 4uh float32
// operations at 67 TFLOP/s (1.03 ms for xlstm-350m's layer at 16 rows of
// 2,048 positions) against the bytes of x, hs and wr (0.12 ms).
//
// Design (simple first): one block a (head, batch row); the recurrence is
// block-diagonal by head, so no block waits on another.  A thread a
// pre-activation j (4 uh threads, uh <= 256): each position it takes the
// dot product of the previous h (in shared memory, read by all) with
// column j of its head's wr, streamed from L2 (a head's wr, 512 KB in
// bfloat16, stays in the 50 MB L2 across positions), and writes pre[j] to
// shared memory; after a barrier the first uh threads each update one
// unit's c, n and m (kept in registers) and write its h.  A cluster that
// holds wr in distributed shared memory is later work (ROADMAP A9).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxUnits = 256;  // uh; 4 uh threads a block (mirrored by slstm_scan.py)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TX, typename TW>
__global__ void __launch_bounds__(4 * kMaxUnits)
    slstm_kernel(const TX* __restrict__ x, const TW* __restrict__ wr,
                 const TW* __restrict__ bias, float* __restrict__ hs, int seq, int heads,
                 int uh) {
  extern __shared__ float smem[];
  float* hprev = smem;    // uh: h of the previous position
  float* pre = smem + uh;  // 4 uh: this position's pre-activations
  const int g = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int g4 = 4 * uh;
  const bool col = j < g4;
  const TW* w = wr + (size_t)g * uh * g4 + j;  // column j of head g's (uh, 4 uh)
  const float bj = col ? widen(bias[(size_t)g * g4 + j]) : 0.f;
  float c = 0.f, nn = 0.f, m = -1e30f;  // unit j's state (j < uh)
  for (int u = j; u < uh; u += blockDim.x) hprev[u] = 0.f;
  __syncthreads();
  const size_t x_row = (size_t)b * seq * heads * g4 + (size_t)g * g4;
  const size_t h_row = (size_t)b * seq * heads * uh + (size_t)g * uh;
  const size_t x_step = (size_t)heads * g4, h_step = (size_t)heads * uh;
  for (int t = 0; t < seq; ++t) {
    if (col) {
      const float xj = widen(x[x_row + t * x_step + j]);
      float rec = 0.f;
#pragma unroll 8
      for (int u = 0; u < uh; ++u) rec = fmaf(hprev[u], widen(w[(size_t)u * g4]), rec);
      pre[j] = __fadd_rn(__fadd_rn(xj, rec), bj);
    }
    __syncthreads();  // pre is whole; every thread is done reading hprev
    if (j < uh) {
      const float zt = pre[j], it = pre[uh + j], ft = pre[2 * uh + j], ot = pre[3 * uh + j];
      const float logf = -__fadd_rn(fmaxf(-ft, 0.f), log1pf(expf(-fabsf(ft))));
      const float lm = __fadd_rn(logf, m);
      const float m_new = fmaxf(lm, it);
      const float i_p = expf(__fsub_rn(it, m_new));
      const float f_p = expf(__fsub_rn(lm, m_new));
      c = __fadd_rn(__fmul_rn(f_p, c), __fmul_rn(i_p, tanhf(zt)));
      nn = __fadd_rn(__fmul_rn(f_p, nn), i_p);
      m = m_new;
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-ot)));
      const float h = __fdiv_rn(__fmul_rn(sig, c), fmaxf(nn, 1e-6f));
      hprev[j] = h;
      hs[h_row + t * h_step + j] = h;
    }
    __syncthreads();  // hprev is whole before the next product
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* wr, const void* bias, float* hs, int batch,
                   int seq, int heads, int uh, cudaStream_t stream) {
  const int threads = (4 * uh + 31) / 32 * 32;
  const size_t smem = (size_t)5 * uh * sizeof(float);
  slstm_kernel<TX, TW><<<dim3(heads, batch), threads, smem, stream>>>(
      (const TX*)x, (const TW*)wr, (const TW*)bias, hs, seq, heads, uh);
  return cudaGetLastError();
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// x (B, S, 4 H uh) of x_dtype, wr (H, uh, 4 uh) and bias (4 H uh) of
// w_dtype (0 float32, 1 bfloat16); hs (B, S, H, uh) float32; all
// contiguous.  1 <= uh <= kMaxUnits, B <= 65,535.  Returns
// cudaGetLastError().
extern "C" int slstm_scan_launch(int device, void* stream, int x_dtype, int w_dtype,
                                 const void* x, const void* wr, const void* bias, float* hs,
                                 int batch, int seq, int heads, int uh) {
  if (uh < 1 || uh > kMaxUnits || heads < 1 || heads > 65535 || batch < 1 || batch > 65535 ||
      seq < 1 || (x_dtype & ~1) || (w_dtype & ~1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch<float, float>(x, wr, bias, hs, batch, seq, heads, uh, s);
  else if (x_dtype == 0)
    err = launch<float, __nv_bfloat16>(x, wr, bias, hs, batch, seq, heads, uh, s);
  else if (w_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, wr, bias, hs, batch, seq, heads, uh, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, wr, bias, hs, batch, seq, heads, uh, s);
  return (int)err;
}
