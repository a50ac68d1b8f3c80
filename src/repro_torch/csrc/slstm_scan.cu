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
// P 192) and does 4P² FMAs a batch row; the state is 4P floats a row.  The
// bytes it must move (gates in, h out, R once) are far below what S
// dependent steps cost, so a step's latency is the kernel's time.
//
// Two routes (kernels/slstm_scan.py::route picks one by P):
//
// "cluster" (P >= 64) -- one thread-block cluster per (head, batch group):
//  * The cluster's cs blocks split the head's P units: block k owns units
//    [k·up, k·up + up), up = ceil(P / cs), and all four gates of each, so
//    combining the gates and updating (c, n, m) stay in the block.
//  * Its 4·up columns of R[h] live in REGISTERS for the whole launch: warp
//    w is unit w; lane l holds R[h][l + 32i][gate·P + unit] for the four
//    gates and i < NQ (read once per launch through shared memory, in runs
//    of up floats), never read again in the loop.
//  * h_{t-1} of every row of the group sits in each block's shared memory
//    (p-major, rows contiguous).  A lane multiplies each h value it reads
//    by its four gates' R values for CH rows at once, so the rows of a
//    group share one read of R; the warp then sums its 32 p slices in a
//    fixed reduce-scatter (xor 16 .. 1) that leaves each (gate, row) sum
//    on one lane, and the cell runs 32 rows a round, one per lane.
//  * Exchange: each lane's h_t goes, CH rows to a store, into the
//    next-parity h buffer of every block of the cluster (st.async), counted
//    in bytes on that block's mbarrier for the step's parity.  A block
//    waits on its own mbarrier before the next step: no cluster barrier, no
//    __syncthreads in the loop.
//  * The gates stream ahead: a cp.async ring SC_DEPTH steps deep, each lane
//    fetching the gates of the rows it updates; h goes to the output from
//    the lane that computed it.
//  * f32 on CUDA cores, no TF32; each column's dot product is summed in one
//    fixed order.  The wrapper's planner (kernels/slstm_scan.py::
//    cluster_plan) picks cs and the group's rows from the card's cluster
//    occupancy (slstm_scan_cluster_max_clusters), in the fewest waves:
//    clusters share nothing, so a grid the card cannot hold at once runs
//    in more than one.
//
// "per_row" (P < 64) -- the first port: one block per (head, batch row), 4P
// threads; thread q computes column q of h · R[h] from L2 every step, two
// __syncthreads a step.  Its steps are shorter than the cluster's exchange
// when the dot products are short.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int SL_MAX_THREADS = 1024;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// One step of the stabilised update of one (row, unit): the four gate
// pre-activations in, (c, n, m) carried, h out.
__device__ __forceinline__ float slstm_cell(float pz, float pi, float pf,
                                            float po, float& c, float& n,
                                            float& m) {
  const float zt = tanhf(pz);
  const float lf = log_sigmoid(pf);
  const float ot = 1.f / (1.f + expf(-po));
  const float m_new = fmaxf(lf + m, pi);
  const float i_p = expf(pi - m_new);
  const float f_p = expf(lf + m - m_new);
  c = f_p * c + i_p * zt;
  n = f_p * n + i_p;
  m = m_new;
  return ot * c / fmaxf(n, 1e-6f);
}

// ---------------------------------------------------------------------------
// "per_row": one block per (head, batch row)
// ---------------------------------------------------------------------------

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
      hv = slstm_cell(pre[q], pre[P + q], pre[2 * P + q], pre[3 * P + q], c,
                      n, m);
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

// ---------------------------------------------------------------------------
// "cluster": one thread-block cluster per (head, batch group)
// ---------------------------------------------------------------------------

constexpr int SC_DEPTH = 4;         // steps of gates_x in the cp.async ring
constexpr int SC_MAX_CLUSTER = 16;  // blocks a cluster (non-portable > 8)
constexpr int SC_SMEM_LIMIT = 231424;  // 226 KB: the rest of 227 KB is static

// The row stride of the h buffers and the pre-activations: the rows of a
// group, padded so that the p rows the 32 lanes read at once land on
// distinct banks (one or two rows: packed; more: ≡ 4 (mod 8), whole
// 16-byte chunks of 4 rows).
__host__ __device__ __forceinline__ int sc_hstride(int bt) {
  if (bt <= 2) return bt;
  const int r4 = (bt + 3) / 4 * 4;
  return r4 % 8 == 4 ? r4 : r4 + 4;
}
// Shared memory of a block, in floats: h_{t-1} / h_t [2][32·NQ][hstr], the
// gates ring [SC_DEPTH][4][up][bt], the state (c, n, m) [3][up][bt], the
// step's pre-activations [up][4][hstr], the R staging [32][4·up + 1]; the
// two mbarriers sit in static shared memory.
__host__ __device__ __forceinline__ int64_t sc_smem_floats(int nq, int up,
                                                           int bt) {
  const int64_t hs = sc_hstride(bt);
  return 2LL * 32 * nq * hs + (int64_t)SC_DEPTH * bt * 4 * up +
         3LL * bt * up + 4LL * up * hs + 32LL * (4 * up + 1);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

// N (1, 2 or 4) consecutive floats into block ``rank``'s shared memory at
// the same address, counted in bytes on its mbarrier ``bar`` (st.async: no
// fence, no barrier; the receiver's wait on ``bar`` sees them).
template <int N>
__device__ __forceinline__ void send(uint32_t dst, uint32_t bar, int rank,
                                     const float (&v)[N]) {
  const uint32_t a = dsmem_addr(dst, rank), m = dsmem_addr(bar, rank);
  if constexpr (N == 4) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n"
        ::"r"(a), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
        "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])), "r"(m)
        : "memory");
  } else if constexpr (N == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
        "[%0], {%1, %2}, [%3];\n"
        ::"r"(a), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
        "r"(m) : "memory");
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
        "[%0], %1, [%2];\n"
        ::"r"(a), "r"(__float_as_uint(v[0])), "r"(m) : "memory");
  }
}

// CH consecutive floats of shared memory (aligned to their size)
template <int CH>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[CH]) {
  if constexpr (CH == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (CH == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

// One stage of warp_reduce_scatter at lane distance OFF with N of the V
// values still held: N > 1 halves them (a lane keeps the half whose index
// bit matches its lane bit OFF), N = 1 adds.
template <int OFF, int N, int V>
__device__ __forceinline__ void rs_stage(float (&v)[V], int lane) {
  if constexpr (N > 1) {
    const bool hi = (lane & OFF) != 0;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = hi ? v[j] : v[j + N / 2];
      const float keep = hi ? v[j + N / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
  }
}

// Sums v[V] (V = 4, 8, 16) over the warp's 32 lanes, xor 16, 8, 4, 2, 1 in
// that order.  Lane l ends with value l >> (5 - log2 V); every lane pair
// adds in one order, so each sum is fixed.
template <int V>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[V],
                                                     int lane) {
  rs_stage<16, V, V>(v, lane);
  rs_stage<8, (V > 1 ? V / 2 : 1), V>(v, lane);
  rs_stage<4, (V > 2 ? V / 4 : 1), V>(v, lane);
  rs_stage<2, (V > 4 ? V / 8 : 1), V>(v, lane);
  rs_stage<1, (V > 8 ? V / 16 : 1), V>(v, lane);
  return v[0];
}

// NQ: rows of R a lane holds per gate (32·NQ >= P); CH: rows of the batch
// group a thread multiplies at once.  Block = up warps (32·up threads),
// grid (cs, H, groups) in clusters of cs along x.  Warp w is unit
// u = rank·up + w; lane l holds R[h][l + 32i][g·P + u] for the four gates
// g and i < NQ, so one read of h_{t-1}[p][rows] feeds 4·CH FMAs.  Step t
// reads h_{t-1} from buffer t % 2 and sends h_t into buffer (t + 1) % 2 of
// every block, counted on that block's mbarrier (t + 1) % 2; the two
// alternate, so a phase's bytes never land in the other's count (no block
// can send step t + 1 before every block has sent step t).
template <int NQ, int CH>
__global__ void __launch_bounds__(NQ >= 6 ? 768 : 1024, 1)
slstm_cluster_kernel(const float* __restrict__ gx, const float* __restrict__ r,
                     const float* __restrict__ h0, const float* __restrict__ c0,
                     const float* __restrict__ n0, const float* __restrict__ m0,
                     float* __restrict__ hout, float* __restrict__ hf,
                     float* __restrict__ cf, float* __restrict__ nf,
                     float* __restrict__ mf, int B, int S, int H, int P,
                     int up, int bt, int64_t gx_sb, int64_t gx_ss,
                     int64_t o_sb, int64_t o_ss) {
  constexpr int PP = 32 * NQ;          // rows of an h buffer (zero past P)
  constexpr int V = 4 * CH;            // the sums a lane's products feed
  constexpr int VEC = CH;              // floats a send carries
  extern __shared__ __align__(16) float sc_smem[];
  __shared__ __align__(8) uint64_t sc_bar[2];
  const int hstr = sc_hstride(bt);
  const int rstr = 4 * up + 1;                  // R staging row stride
  float* hbuf = sc_smem;                        // [2][PP][hstr]
  float* ring = hbuf + 2 * PP * hstr;           // [DEPTH][4][up][bt]
  float* st_c = ring + SC_DEPTH * 4 * up * bt;  // [up][bt] each
  float* st_n = st_c + up * bt;
  float* st_m = st_n + up * bt;
  float* pre = st_m + up * bt;                  // [up][4][hstr]
  float* rstage = pre + 4 * up * hstr;          // [32][rstr]

  const int cs = gridDim.x;
  const int rank = blockIdx.x;                  // cluster (cs, 1, 1)
  const int head = blockIdx.y;
  const int b0 = blockIdx.z * bt;
  const int nrows = min(bt, B - b0);
  const int nchunks = (nrows + CH - 1) / CH;
  const int u0 = rank * up;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, ul = tid >> 5;
  const int u = u0 + ul;
  const bool live = u < P;                      // warp-uniform
  const int64_t HP = (int64_t)H * P;

  // the state: h_{-1} of every row into buffer 0 (zero elsewhere), this
  // block's (c, n, m); the exchange's two mbarriers
  for (int e = tid; e < 2 * PP * hstr; e += nthreads) hbuf[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < nrows * P; e += nthreads) {
    const int row = e / P, p = e - row * P;
    hbuf[p * hstr + row] = h0[(b0 + row) * HP + head * P + p];
  }
  for (int e = tid; e < nrows * up; e += nthreads) {
    const int row = e / up, v = e - row * up;
    if (u0 + v < P) {
      const int64_t at = (b0 + row) * HP + head * P + u0 + v;
      st_c[v * bt + row] = c0[at];
      st_n[v * bt + row] = n0[at];
      st_m[v * bt + row] = m0[at];
    }
  }
  const uint32_t bar0 = smem_u32(&sc_bar[0]);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this lane's R, through shared memory 32 rows of the block's 4·up
  // columns at a time, so that the reads from memory are runs of up floats
  // (all of them in flight at once)
  float rr[4][NQ];
  {
    const float* rh = r + (int64_t)head * P * 4 * P + u0;
    float ld[4][NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = tid + k * nthreads;     // < 32·4·up: 4 a thread
        const int row = e / (4 * up), col = e - row * 4 * up;
        const int g = col / up, v = col - g * up, p = 32 * i + row;
        ld[k][i] = (p < P && u0 + v < P)
                       ? __ldg(rh + (int64_t)p * 4 * P + g * P + v) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) rstage[tid + k * nthreads +
                                         (tid + k * nthreads) / (4 * up)] =
          ld[k][i];
      __syncthreads();
#pragma unroll
      for (int g = 0; g < 4; ++g) rr[g][i] = rstage[lane * rstr + g * up + ul];
      __syncthreads();
    }
  }
  cluster_barrier();   // every block started, its state and barriers set

  if (live) {
    // lane j of warp ul updates rows j, j + 32, ... of unit u, and fetches
    // their gates itself (its own cp.async groups: no barrier)
    auto fetch = [&](int tt) {
      if (tt < S) {
        const uint32_t st = smem_u32(ring + (tt % SC_DEPTH) * 4 * up * bt);
        const float* src = gx + tt * gx_ss + head * P + u;
        for (int row = lane; row < nrows; row += 32)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            cp_async4(st + 4 * ((g * up + ul) * bt + row),
                      src + (b0 + row) * gx_sb + g * HP);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < SC_DEPTH - 1; ++j) fetch(j);
    const int rows = nchunks * CH;         // rows a step sends (zero past
    const int tx = 4 * P * rows;           // nrows); bytes a block receives
    const uint32_t hbuf_u32 = smem_u32(hbuf);
    float* prew = pre + ul * 4 * hstr;     // this unit's [4][hstr]
    // the sum a lane ends with: gate idx / CH, row idx % CH of the chunk
    const int idx = lane >> (V == 16 ? 1 : V == 8 ? 2 : 3);
    const bool writer = (lane & ((32 / V) - 1)) == 0;
    for (int t = 0; t < S; ++t) {
      const int cur = t & 1;
      const bool last = t + 1 == S;
      if (t > 0) mbar_wait(bar0 + 8 * cur, ((t - 1) >> 1) & 1);
      if (tid == 0 && !last) mbar_expect_tx(bar0 + 8 * (cur ^ 1), tx);
      fetch(t + SC_DEPTH - 1);
      // the pre-activations h_{t-1} · R of every row
      const float* hc = hbuf + cur * PP * hstr + lane * hstr;
      for (int ch = 0; ch < nchunks; ++ch) {
        const int r0 = ch * CH;
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          float hv[CH];
          load_rows<CH>(hc + 32 * i * hstr + r0, hv);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int j = 0; j < CH; ++j)
              acc[g * CH + j] = fmaf(rr[g][i], hv[j], acc[g * CH + j]);
        }
        const float sum = warp_reduce_scatter<V>(acc, lane);
        if (writer) prew[(idx / CH) * hstr + r0 + idx % CH] = sum;
      }
      cp_async_wait<SC_DEPTH - 1>();  // this lane's gates of step t are in
      __syncwarp();
      // the cell, 32 rows a round, and the sends of h_t: lanes 0, CH, ...
      // gather CH rows each for every block of the cluster
      const float* gst = ring + (t % SC_DEPTH) * 4 * up * bt + ul * bt;
      for (int r0 = 0; r0 < rows; r0 += 32) {
        const int row = r0 + lane;
        float h = 0.f;                  // rows past the group send zeros
        if (row < nrows) {
          const int at = ul * bt + row;
          float c = st_c[at], n = st_n[at], m = st_m[at];
          h = slstm_cell(prew[row] + gst[row],
                         prew[hstr + row] + gst[up * bt + row],
                         prew[2 * hstr + row] + gst[2 * up * bt + row],
                         prew[3 * hstr + row] + gst[3 * up * bt + row], c, n,
                         m);
          st_c[at] = c;
          st_n[at] = n;
          st_m[at] = m;
          const int64_t grow = b0 + row;
          hout[grow * o_sb + t * o_ss + head * P + u] = h;
          if (last) {
            const int64_t at_g = grow * HP + head * P + u;
            hf[at_g] = h;
            cf[at_g] = c;
            nf[at_g] = n;
            mf[at_g] = m;
          }
        }
        if (!last) {
          float v[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            v[k] = __shfl_sync(0xffffffffu, h, (lane & ~(VEC - 1)) + k);
          if (lane % VEC == 0 && row < rows) {
            const uint32_t dst = hbuf_u32 +
                4u * (uint32_t)((cur ^ 1) * PP * hstr + u * hstr + row);
            const uint32_t bar = bar0 + 8 * (cur ^ 1);
            for (int q = 0; q < cs; ++q) send<VEC>(dst, bar, q, v);
          }
        }
      }
      __syncwarp();                   // prew is read before the next step
    }
  }
  cp_async_wait<0>();
  cluster_barrier();   // no block leaves while another may still send to it
}

struct ScArgs {
  const float *gx, *r, *h0, *c0, *n0, *m0;
  float *h, *hf, *cf, *nf, *mf;
  int B, S, H, P, cs, bt;
  long long gx_sb, gx_ss, h_sb, h_ss;
};

int sc_up(int P, int cs) { return (P + cs - 1) / cs; }

// the kernel's shared memory ceiling and cluster attribute, set once
template <int NQ, int CH>
cudaError_t sc_configure() {
  auto kernel = slstm_cluster_kernel<NQ, CH>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SC_SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  return cudaSuccess;
}

void sc_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1],
               int cs, int H, int groups, int threads, int smem,
               cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(cs, H, groups);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// Launch (n == null) or count the clusters the card holds at once (n).
template <int NQ, int CH>
cudaError_t sc_run(const ScArgs& a, int* n, cudaStream_t stream) {
  const int up = sc_up(a.P, a.cs);
  const int smem = (int)(sizeof(float) * sc_smem_floats(NQ, up, a.bt));
  cudaError_t e = sc_configure<NQ, CH>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int groups = (a.B + a.bt - 1) / a.bt;
  sc_config(cfg, attr, a.cs, a.H, groups, 32 * up, smem, stream);
  if (n != nullptr)
    return cudaOccupancyMaxActiveClusters(n, slstm_cluster_kernel<NQ, CH>,
                                          &cfg);
  e = cudaLaunchKernelEx(&cfg, slstm_cluster_kernel<NQ, CH>, a.gx, a.r, a.h0,
                         a.c0, a.n0, a.m0, a.h, a.hf, a.cf, a.nf, a.mf, a.B,
                         a.S, a.H, a.P, up, a.bt, (int64_t)a.gx_sb,
                         (int64_t)a.gx_ss, (int64_t)a.h_sb, (int64_t)a.h_ss);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// rows a thread multiplies at once: 4, or the whole group below 3
template <int NQ>
cudaError_t sc_dispatch_ch(const ScArgs& a, int* n, cudaStream_t stream) {
  if (a.bt >= 3) return sc_run<NQ, 4>(a, n, stream);
  if (a.bt == 2) return sc_run<NQ, 2>(a, n, stream);
  return sc_run<NQ, 1>(a, n, stream);
}

// rows of R a lane holds per gate: the least instance with 32·NQ >= P
int sc_nq(int P) {
  const int steps[] = {1, 2, 4, 6, 8};
  for (int nq : steps)
    if (32 * nq >= P) return nq;
  return 0;
}

// The plan's rules (the wrapper's planner keeps the same ones)
bool sc_valid(const ScArgs& a) {
  if (a.B < 1 || a.S < 0 || a.H < 1 || a.P < 1 || 4 * a.P > SL_MAX_THREADS ||
      a.H > 65535 || a.cs < 1 || a.cs > SC_MAX_CLUSTER || a.bt < 1)
    return false;
  const int up = sc_up(a.P, a.cs), nq = sc_nq(a.P);
  const long long groups = (a.B + a.bt - 1) / a.bt;
  return nq > 0 && (a.cs - 1) * up < a.P &&
         32 * up <= (nq >= 6 ? 768 : 1024) && groups <= 65535 &&
         sizeof(float) * sc_smem_floats(nq, up, a.bt) <= SC_SMEM_LIMIT;
}

cudaError_t sc_dispatch(const ScArgs& a, int* n, cudaStream_t stream) {
  switch (sc_nq(a.P)) {
    case 1: return sc_dispatch_ch<1>(a, n, stream);
    case 2: return sc_dispatch_ch<2>(a, n, stream);
    case 4: return sc_dispatch_ch<4>(a, n, stream);
    case 6: return sc_dispatch_ch<6>(a, n, stream);
    default: return sc_dispatch_ch<8>(a, n, stream);
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

// The cluster route: the operands of slstm_scan_fwd, with clusters of cs
// blocks (1..16, each owning ceil(P/cs) units, none empty) over batch
// groups of bt rows (the last may be shorter).
extern "C" int slstm_scan_cluster_fwd(
    const float* gates_x, const float* r, const float* h0, const float* c0,
    const float* n0, const float* m0, float* h, float* hf, float* cf,
    float* nf, float* mf, int B, int S, int H, int P, long long gx_sb,
    long long gx_ss, long long h_sb, long long h_ss, int cs, int bt,
    void* stream) {
  ScArgs a{gates_x, r, h0, c0, n0, m0, h, hf, cf, nf, mf, B, S, H, P, cs,
           bt, gx_sb, gx_ss, h_sb, h_ss};
  if (S < 1 || !sc_valid(a)) return (int)cudaErrorInvalidValue;
  return (int)sc_dispatch(a, nullptr, static_cast<cudaStream_t>(stream));
}

// How many clusters of cs blocks over groups of bt rows at P units the
// current device holds at once, into *n (the wrapper's planner reads it).
extern "C" int slstm_scan_cluster_max_clusters(int P, int cs, int bt,
                                               int* n) {
  ScArgs a{};
  a.B = bt;
  a.S = 1;
  a.H = 1;
  a.P = P;
  a.cs = cs;
  a.bt = bt;
  if (!sc_valid(a)) return (int)cudaErrorInvalidValue;
  return (int)sc_dispatch(a, n, nullptr);
}
