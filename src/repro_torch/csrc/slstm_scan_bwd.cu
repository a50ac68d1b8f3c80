// The backward of the stabilised sLSTM recurrence for Hopper (sm_90a), f32.
//
// Replaces: no Pallas kernel.  The JAX package trains through jax.vjp of
// src/repro/kernels/ref.py::slstm_scan (its lax.scan; the Pallas
// slstm_scan_pallas defines no autodiff rule).  This is the backward of the
// port's forward kernel (csrc/slstm_scan.cu) under kernels/slstm_scan.py::
// SlstmScanFn: the training of models/layers.py::slstm, 4 launches a step
// of xlstm-125m.
//
// The function, per (batch row, head), from the pre-activations g_t (the
// wrapper recomputes them from the forward's h sequence: gates_x +
// h_{t-1}·R[h], one product for all t) and the carried cotangents (dc, dn,
// dm) and dh_t + dg_{t+1}·R[h]ᵀ, for t = S-1 .. 0:
//   h = o·c / max(n, 1e-6)         → do, and dc, dn (dn 0 where the clamp
//                                     binds, a half at the tie, as JAX's max)
//   c = f'·c_p + i'·z, n = f'·n_p + i', i' = exp(i - m), f' = exp(log f +
//   m_p - m), m = max(log f + m_p, i) (the m path as JAX differentiates it)
//   → dz, di, dlog f and the carry dc·f', dn·f', dm_p
//   dg_t = (dz·(1 - z²), di, dlog f·sigmoid(-pre_f), do·o·(1 - o))
//   dh_{t-1} += dg_t · R[h]ᵀ
// then the initial state's cotangents.  dR = Σ_t h_{t-1}ᵀ dg_t is one
// product the wrapper leaves to torch.matmul.  kernels/ref.py::
// slstm_scan_bwd is the same function in plain PyTorch.
//
// What bounds it on this card: the S dependent steps, as in the forward.
// A step's work is one (4P)-long row of dg times R[h]ᵀ (4P² FMAs a row and
// head: 147,456 at P 192) and ~60 elementwise operations a unit; the bytes
// (pre-activations, dh and dg once, R once) are far below what S dependent
// steps cost.  So a step's latency is the kernel's time.
//
// What the design does about it:
//  * One thread-block cluster of cs blocks per (batch row, head): block k
//    owns units [k·up, k·up + up), up = ceil(P / cs), computes their dg_t
//    and the same units' rows of dh_{t-1} = Σ_q dg_t[q]·R[h][p][q], for
//    which it keeps R[h]'s up rows (up × 4P f32: 74 KB at P 192, cs 8) in
//    shared memory for the whole launch.
//  * Each step's dg_t (4P floats) goes from the blocks that own its units
//    to every block of the cluster through distributed shared memory, into
//    a buffer of the step's parity; one cluster barrier a step orders the
//    stores before the reads, and the parity keeps step t + 1's stores off
//    the buffer step t still reads.
//  * A warp sums one row of the product at a time, its lanes striding the
//    4P columns, in a fixed shuffle order: deterministic.
//  * The forward's (c, n, m) are recomputed by a first, elementwise sweep
//    over t (each unit's own recurrence, no exchange) into a scratch buffer
//    (3·B·S·d f32, 75 MB at B 4, S 2048, d 768), read back in reverse by
//    the same thread: the forward saves nothing but its output h.  A
//    step's global operands are loaded during the step before it, so their
//    latency overlaps the exchange and the product.
//  * f32 on CUDA cores, no TF32.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int LB_THREADS = 256;
constexpr int LB_WARPS = LB_THREADS / 32;

struct LbArgs {
  const float* gp;      // (B, S, 4d) pre-activations, [z|i|f|o] h-major
  const float* r;       // (H, P, 4P)
  const float* c0; const float* n0; const float* m0;   // (B, d)
  const float* dh;      // (B, S, d)
  const float* dhf; const float* dcf; const float* dnf; const float* dmf;
  float* dg;            // (B, S, 4d)
  float* cnm;           // (3, B, S, d) scratch: (c, n, m) after each step
  float* dh0; float* dc0; float* dn0; float* dm0;   // (B, d)
  int B, S, H, P, cs;
};

__host__ __device__ inline int lb_up(int P, int cs) { return (P + cs - 1) / cs; }

__host__ inline size_t lb_smem_bytes(int P, int cs) {
  const int up = lb_up(P, cs);
  return sizeof(float) * ((size_t)up * 4 * P + 2 * 4 * P + up);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// d max(x, y) / dx as JAX takes it: 1 where x > y, a half at a tie
__device__ __forceinline__ float max_weight(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__global__ void __launch_bounds__(LB_THREADS)
slstm_bwd_kernel(LbArgs a) {
  extern __shared__ float lb_smem[];
  const int P = a.P, P4 = 4 * P, d = a.H * P;
  const int up = lb_up(P, a.cs);
  const int k = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int u0 = k * up, nu = max(0, min(up, P - u0));   // units owned
  float* rs = lb_smem;                   // [up][4P] R[h]'s rows u0 ..
  float* exch = rs + up * P4;            // [2][4P] dg_t by parity
  float* dhr = exch + 2 * P4;            // [up] dg_{t+1}·R[h]ᵀ, own units

  const float* rh = a.r + (int64_t)h * P * P4;
  for (int i = tid; i < up * P4; i += LB_THREADS) {
    const int pl = i / P4;
    rs[i] = pl < nu ? rh[(int64_t)(u0 + pl) * P4 + i % P4] : 0.f;
  }

  // this thread's unit (tid < nu) and its column of every (B, S, d) array
  const bool mine = tid < nu;
  const int col = h * P + u0 + tid;
  const int64_t row0 = (int64_t)b * a.S;
  const int64_t plane = (int64_t)a.B * a.S * d;
  float* cs_ = a.cnm;
  float* ns_ = a.cnm + plane;
  float* ms_ = a.cnm + 2 * plane;
  float c0 = 0.f, n0 = 0.f, m0 = 0.f;
  float dc = 0.f, dn = 0.f, dm = 0.f;
  if (mine) {
    c0 = a.c0[(int64_t)b * d + col];
    n0 = a.n0[(int64_t)b * d + col];
    m0 = a.m0[(int64_t)b * d + col];
    // the forward's (c, n, m), each unit its own recurrence
    float c = c0, n = n0, m = m0;
    for (int t = 0; t < a.S; ++t) {
      const float* g = a.gp + (row0 + t) * 4 * d + col;
      const float z = tanhf(g[0]), ii = g[d], lf = log_sigmoid(g[2 * d]);
      const float m_new = fmaxf(lf + m, ii);
      const float i_p = expf(ii - m_new), f_p = expf(lf + m - m_new);
      c = f_p * c + i_p * z;
      n = f_p * n + i_p;
      m = m_new;
      const int64_t e = (row0 + t) * d + col;
      cs_[e] = c;
      ns_[e] = n;
      ms_[e] = m;
    }
    const int64_t e = (int64_t)b * d + col;
    dhr[tid] = a.dhf ? a.dhf[e] : 0.f;
    dc = a.dcf ? a.dcf[e] : 0.f;
    dn = a.dnf ? a.dnf[e] : 0.f;
    dm = a.dmf ? a.dmf[e] : 0.f;
  }
  __syncthreads();
  cluster_barrier();                     // every block resident and set up

  const uint32_t exch_u32 = smem_u32(exch);
  // the step's operands, loaded a step ahead: the pre-activations and dh at
  // t, (c, n, m) after t and before it
  float gz = 0.f, ii = 0.f, gf = 0.f, go = 0.f, dhv = 0.f;
  float c = 0.f, n = 0.f, m = 0.f, c_p = c0, n_p = n0, m_p = m0;
  if (mine) {
    const int64_t e = (row0 + a.S - 1) * d + col;
    const float* g = a.gp + (row0 + a.S - 1) * 4 * d + col;
    gz = g[0]; ii = g[d]; gf = g[2 * d]; go = g[3 * d];
    dhv = a.dh[e];
    c = cs_[e]; n = ns_[e]; m = ms_[e];
    if (a.S > 1) { c_p = cs_[e - d]; n_p = ns_[e - d]; m_p = ms_[e - d]; }
  }
  for (int t = a.S - 1; t >= 0; --t) {
    const int par = t & 1;
    float* xb = exch + par * P4;
    if (mine) {
      const float z = tanhf(gz), lf = log_sigmoid(gf), o = sigmoid(go);
      const float dht = dhv + dhr[tid];
      const float nc = fmaxf(n, 1e-6f);
      const float d_o = dht * c / nc;
      dc += dht * o / nc;
      dn -= dht * o * c / (nc * nc) * max_weight(n, 1e-6f);
      const float aa = lf + m_p;
      const float i_p = expf(ii - m), f_p = expf(aa - m);
      const float dz = dc * i_p;
      const float d_ip = (dc * z + dn) * i_p;
      const float d_fp = (dc * c_p + dn * n_p) * f_p;
      dm -= d_ip + d_fp;
      const float w_a = max_weight(aa, ii);
      const float da = d_fp + dm * w_a;
      const float dii = d_ip + dm * (1.f - w_a);
      const float g4[4] = {dz * (1.f - z * z), dii, da * sigmoid(-gf),
                           d_o * o * (1.f - o)};
      float* dgo = a.dg + (row0 + t) * 4 * d + col;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dgo[q * d] = g4[q];
        xb[q * P + u0 + tid] = g4[q];
      }
      dc *= f_p;
      dn *= f_p;
      dm = da;
      if (t > 0) {                     // step t - 1's operands, in flight
        const int64_t e = (row0 + t - 1) * d + col;   // across the exchange
        const float* g = a.gp + (row0 + t - 1) * 4 * d + col;
        gz = g[0]; ii = g[d]; gf = g[2 * d]; go = g[3 * d];
        dhv = a.dh[e];
        c = c_p; n = n_p; m = m_p;
        if (t > 1) {
          c_p = cs_[e - d]; n_p = ns_[e - d]; m_p = ms_[e - d];
        } else {
          c_p = c0; n_p = n0; m_p = m0;
        }
      }
    }
    __syncthreads();
    // this block's 4·nu values of dg_t into every other block's buffer
    for (int i = tid; i < 4 * up * a.cs; i += LB_THREADS) {
      const int rank = i / (4 * up), j = i % (4 * up);
      const int q = j / up, pl = j % up;
      if (rank != k && pl < nu) {
        const int idx = par * P4 + q * P + u0 + pl;
        st_cluster(dsmem_addr(exch_u32 + 4 * idx, rank), exch[idx]);
      }
    }
    cluster_barrier();
    // dh_{t-1}[u0 + pl] = Σ_q dg_t[q]·R[h][u0 + pl][q], a warp a row
    for (int pl = warp; pl < nu; pl += LB_WARPS) {
      const float* rr = rs + pl * P4;
      float acc = 0.f;
      for (int q = lane; q < P4; q += 32) acc += xb[q] * rr[q];
      acc = warp_sum(acc);
      if (lane == 0) dhr[pl] = acc;
    }
    __syncthreads();
  }

  if (mine) {
    const int64_t e = (int64_t)b * d + col;
    a.dh0[e] = dhr[tid];
    a.dc0[e] = dc;
    a.dn0[e] = dn;
    a.dm0[e] = dm;
  }
}

}  // namespace

// gp, dh, dg (B, S, 4d) / (B, S, d) f32 contiguous; r (H, P, 4P); the
// initial c0, n0, m0 and the final state's cotangents dhf, dcf, dnf, dmf
// (B, d) (each of the four may be null: zero); outputs dg and the initial
// state's cotangents dh0, dc0, dn0, dm0 (B, d); scratch cnm (3, B, S, d).
// Clusters of cs blocks (1..8), up = ceil(P / cs) <= 256 units a block.
// Returns cudaGetLastError().
extern "C" int slstm_scan_bwd(const float* gp, const float* r, const float* c0,
                              const float* n0, const float* m0,
                              const float* dh, const float* dhf,
                              const float* dcf, const float* dnf,
                              const float* dmf, float* dg, float* cnm,
                              float* dh0, float* dc0, float* dn0, float* dm0,
                              int B, int S, int H, int P, int cs,
                              void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || cs < 1 || cs > 8 ||
      lb_up(P, cs) > LB_THREADS || (cs - 1) * lb_up(P, cs) >= P ||
      B > 65535 || H > 65535 || lb_smem_bytes(P, cs) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const LbArgs a{gp, r, c0, n0, m0, dh, dhf, dcf, dnf, dmf, dg, cnm,
                 dh0, dc0, dn0, dm0, B, S, H, P, cs};
  const size_t smem = lb_smem_bytes(P, cs);
  cudaError_t e = allow_smem(slstm_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, H, B);
  cfg.blockDim = dim3(LB_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, slstm_bwd_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
