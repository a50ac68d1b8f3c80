// The stabilised sLSTM recurrence for Hopper (sm_90a), f32.
//
// Replaces: src/repro/kernels/slstm_scan.py::slstm_scan_pallas (body
// _slstm_kernel): the scan of models/layers.py::slstm through
// ops.slstm_scan, 4 launches per xlstm-125m prefill and per decode step.
//
// The function, per (batch row, head h), for t = 0 .. S-1:
//   pre    = gates_x[b, t] (blocks z|i|f|o, each h-major) + h_{t-1} · R[h]
//   z = tanh(pre_z), i = pre_i, log f = log_sigmoid(pre_f), o = sigmoid(pre_o)
//   m_t = max(log f + m_{t-1}, i)
//   c_t = exp(log f + m_{t-1} - m_t)·c_{t-1} + exp(i - m_t)·z
//   n_t = exp(log f + m_{t-1} - m_t)·n_{t-1} + exp(i - m_t)
//   h_t = o · c_t / max(n_t, 1e-6)
// from an INITIAL STATE (h, c, n, m) operand: the Pallas kernel starts from
// zero only (and ops.py asserts it), so on a TPU xLSTM prefill and decode,
// which both carry a state, never reach it.  The zero start (n = 1e-6) is
// the wrapper's default.  log_sigmoid is the stable min(x, 0) -
// log1p(exp(-|x|)), as jax.nn.log_sigmoid; log(sigmoid(x)) gives -inf for
// x << 0 and NaN through m.
//
// What bounds it on this card: the S sequential steps, which nothing
// parallelises.  Each step reads the head's R (P x 4P f32: 590 KB at
// P 192) and does 4P² FMAs; the state is 4P floats.  The bytes it must move
// (gates in, h out, R once) are far below what S dependent steps cost.
//
// What the design does about it (the simple design; a cluster per head
// holding R in distributed shared memory is a later PR's):
//  * One block per (head, batch row), 4P threads (768 at P 192; the
//    wrapper refuses 4P > 1024).  Thread q computes column q of h · R[h]:
//    the reads of R are coalesced across q and hit L2 (the whole R, 2.36 MB
//    at xlstm-125m, stays resident) every step.
//  * h lives in shared memory; after a barrier, threads j < P combine the
//    four gates of unit j, keep (c, n, m) in registers, write h_t to the
//    output and to shared memory, and a second barrier closes the step.
//  * The next step's input gate is loaded before the step's matvec, so its
//    latency hides behind the L2 reads.
#include "common.cuh"

namespace {

constexpr int SL_MAX_THREADS = 1024;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(SL_MAX_THREADS)
slstm_scan_kernel(const float* __restrict__ gx, const float* __restrict__ r,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ hout, float* __restrict__ hf,
                  float* __restrict__ cf, float* __restrict__ nf,
                  float* __restrict__ mf, int S, int H, int P,
                  int64_t gx_sb, int64_t gx_ss, int64_t o_sb, int64_t o_ss) {
  extern __shared__ float sl_smem[];
  float* hs = sl_smem;        // [P] h_{t-1}
  float* pre = sl_smem + P;   // [4P] the step's pre-activations
  const int h = blockIdx.x, b = blockIdx.y, q = threadIdx.x;
  const int gate = q / P, j = q % P;
  const int64_t soff = ((int64_t)b * H + h) * P;
  float hv = 0.f, c = 0.f, n = 0.f, m = 0.f;
  if (q < P) {
    hv = h0[soff + q];
    c = c0[soff + q];
    n = n0[soff + q];
    m = m0[soff + q];
    hs[q] = hv;
  }
  const float* rq = r + (int64_t)h * P * 4 * P + q;   // column q of R[h]
  const int64_t r_sp = 4 * (int64_t)P;
  const float* gq = gx + b * gx_sb + (int64_t)gate * H * P + h * P + j;
  float* oq = hout + b * o_sb + h * P + q;
  float gnext = S > 0 ? gq[0] : 0.f;
  __syncthreads();
  for (int t = 0; t < S; ++t) {
    const float gt = gnext;
    if (t + 1 < S) gnext = gq[(int64_t)(t + 1) * gx_ss];
    float rec = 0.f;
#pragma unroll 8
    for (int p = 0; p < P; ++p) rec += hs[p] * rq[p * r_sp];
    pre[q] = gt + rec;
    __syncthreads();
    if (q < P) {
      const float zt = tanhf(pre[q]);
      const float ii = pre[P + q];
      const float lf = log_sigmoid(pre[2 * P + q]);
      const float ot = 1.f / (1.f + expf(-pre[3 * P + q]));
      const float m_new = fmaxf(lf + m, ii);
      const float i_p = expf(ii - m_new);
      const float f_p = expf(lf + m - m_new);
      c = f_p * c + i_p * zt;
      n = f_p * n + i_p;
      hv = ot * c / fmaxf(n, 1e-6f);
      m = m_new;
      hs[q] = hv;
      oq[(int64_t)t * o_ss] = hv;
    }
    __syncthreads();
  }
  if (q < P) {
    hf[soff + q] = hv;
    cf[soff + q] = c;
    nf[soff + q] = n;
    mf[soff + q] = m;
  }
}

}  // namespace

// gates_x (B, S, 4·H·P) f32 with a unit innermost stride; r (H, P, 4P) f32
// contiguous; h0, c0, n0, m0 and hf, cf, nf, mf (B, H, P) f32 contiguous;
// h (B, S, H·P) f32 with a unit innermost stride.  4P <= 1024.  Returns
// cudaGetLastError().
extern "C" int slstm_scan_fwd(const float* gates_x, const float* r,
                              const float* h0, const float* c0,
                              const float* n0, const float* m0, float* h,
                              float* hf, float* cf, float* nf, float* mf,
                              int B, int S, int H, int P,
                              long long gx_sb, long long gx_ss,
                              long long h_sb, long long h_ss, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || 4 * P > SL_MAX_THREADS ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 5 * (size_t)P;
  slstm_scan_kernel<<<dim3(H, B), 4 * P, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      gates_x, r, h0, c0, n0, m0, h, hf, cf, nf, mf, S, H, P, gx_sb, gx_ss,
      h_sb, h_ss);
  return (int)cudaGetLastError();
}
