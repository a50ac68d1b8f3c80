// Chunked gated linear-attention scan (Mamba-2 SSD / mLSTM core) for Hopper
// (sm_90a), f32 math.
//
// Replaces: src/repro/kernels/ssm_scan.py::ssm_scan_pallas (body
// _ssm_kernel): the prefill scan of models/layers.py::mlstm through
// ops.ssm_scan, 8 launches per xlstm-125m prefill.
//
// The function, per (batch row, head): S_t = exp(g_t)·S_{t-1} + k_t v_tᵀ,
// o_t = S_tᵀ q_t, from an initial state S_0, in chunks of C tokens.  In a
// chunk with inclusive decay sums cum_i:
//   o_i   = exp(cum_i)·(q_i · S) + Σ_{j<=i} (q_i·k_j)·exp(cum_i - cum_j)·v_j
//   S    <- exp(cum_C)·S + Σ_j exp(cum_C - cum_j)·k_j v_jᵀ
// The exponent cum_i - cum_j is masked (j > i gives 0) BEFORE exp: the JAX
// oracle exponentiates first, overflows to inf once a chunk's summed decay
// passes ~88 and multiplies inf by 0 (NaN); the Pallas kernel's `where`
// gives what this kernel gives.
//
// What bounds it on this card: at the xlstm-125m shape (H 4, dk 384,
// dv 385, chunk 64, bf16 in and out) operations, ~44 MFLOP per chunk per
// (batch row, head) against ~0.2 MB of bytes.  This first kernel runs them
// on CUDA cores in f32 (no tensor cores): right first, fast later.
//
// What the design does about it:
//  * The (dk, dv) f32 state is 591 KB at dk 384, dv 385: more than an SM's
//    shared memory (the TPU kernel kept it in VMEM).  The scan is separable
//    over value columns (o[:, c] and S[:, c] depend only on v[:, c]), so the
//    grid is (dv / 32 column tiles, H, B) and each block walks the chunks in
//    order with its (dk, 32) slice of the state in shared memory (48 KB at
//    dk 384).  Each block recomputes the chunk's C×C scores, so q·kᵀ is
//    done ceil(dv / 32) times: the price of the split, for a later PR.
//  * q and k stream through shared memory in 32-wide dk tiles (rows padded
//    to 33 floats: no bank conflicts); pass A accumulates the scores and
//    q·S in registers (16 + 8 a thread), pass B updates the state slice
//    from a second pass over the k tiles, after every read of the old state.
//  * The ragged edges (dv = 385: a 1-column last tile; dk not a multiple of
//    32; C below 64) are masked element by element with scalar loads, so
//    the v rows' 770-byte stride needs no alignment and no padding copy.
//  * The chunk's decay prefix sums come from one warp's shuffle scan.
#include "common.cuh"

namespace {

constexpr int SS_THREADS = 256;   // 16 x 16
constexpr int SS_CMAX = 64;       // tokens per chunk, at most
constexpr int SS_DVT = 32;        // value columns per block
constexpr int SS_DKT = 32;        // key dims per shared-memory tile
constexpr int SS_PAD = SS_DKT + 1;
constexpr int SS_PPAD = SS_CMAX + 1;

struct ScanArgs {
  const void* q; const void* k; const void* v;
  const float* g; const float* s0;
  void* o; float* sf;
  int B, H, S, dk, dv, chunk;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t g_sb, g_sh, g_ss, o_sb, o_sh, o_ss;
};

__host__ __device__ inline int dk_padded(int dk) {
  return (dk + SS_DKT - 1) / SS_DKT * SS_DKT;
}

__host__ inline size_t scan_smem_bytes(int dk) {
  return sizeof(float) * ((size_t)dk_padded(dk) * SS_DVT + 2 * SS_CMAX * SS_PAD +
                          SS_CMAX * SS_DVT + SS_CMAX * SS_PPAD + 3 * SS_CMAX);
}

// rows [0, C) x dims [d0, d0 + 32) of a (S, dk) slab, starting at token t0,
// into a [64][33] f32 tile; everything outside reads as zero
template <typename T>
__device__ __forceinline__ void load_dk_tile(float* __restrict__ dst,
                                             const T* __restrict__ src,
                                             int64_t ss, int t0, int C, int d0,
                                             int dk) {
#pragma unroll
  for (int r = 0; r < SS_CMAX * SS_DKT / SS_THREADS; ++r) {
    const int e = threadIdx.x + r * SS_THREADS, i = e / SS_DKT, d = e % SS_DKT;
    dst[i * SS_PAD + d] =
        (i < C && d0 + d < dk) ? to_f32(src[(int64_t)(t0 + i) * ss + d0 + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(SS_THREADS)
ssm_scan_kernel(ScanArgs a) {
  extern __shared__ float ss_smem[];
  const int dkp = dk_padded(a.dk);
  float* st = ss_smem;                       // [dkp][DVT] the state slice
  float* qs = st + dkp * SS_DVT;             // [CMAX][PAD]
  float* ks = qs + SS_CMAX * SS_PAD;         // [CMAX][PAD]
  float* vs = ks + SS_CMAX * SS_PAD;         // [CMAX][DVT]
  float* ps = vs + SS_CMAX * SS_DVT;         // [CMAX][PPAD] masked scores
  float* cum = ps + SS_CMAX * SS_PPAD;       // [CMAX] inclusive decay sums
  float* ecum = cum + SS_CMAX;               // exp(cum_i)
  float* wdec = ecum + SS_CMAX;              // exp(cum_C - cum_j)

  const int c0 = blockIdx.x * SS_DVT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ncols = min(SS_DVT, a.dv - c0);
  const int C = a.chunk;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + c0;
  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + c0;
  const float* gb = a.g + b * a.g_sb + h * a.g_sh;
  const int64_t sbase = ((int64_t)b * a.H + h) * a.dk * a.dv + c0;

  for (int i = tid; i < dkp * SS_DVT; i += SS_THREADS) {
    const int d = i / SS_DVT, c = i % SS_DVT;
    st[i] = (d < a.dk && c < ncols) ? a.s0[sbase + (int64_t)d * a.dv + c] : 0.f;
  }

  for (int t0 = 0; t0 < a.S; t0 += C) {
    if (tid < 32) {   // inclusive scan of the chunk's log decays, 2 x 32
      float g0 = tid < C ? gb[(int64_t)(t0 + tid) * a.g_ss] : 0.f;
      float g1 = tid + 32 < C ? gb[(int64_t)(t0 + tid + 32) * a.g_ss] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y0 = __shfl_up_sync(0xffffffffu, g0, off);
        const float y1 = __shfl_up_sync(0xffffffffu, g1, off);
        if (tid >= off) { g0 += y0; g1 += y1; }
      }
      g1 += __shfl_sync(0xffffffffu, g0, 31);
      cum[tid] = g0;
      cum[tid + 32] = g1;
    }
#pragma unroll
    for (int r = 0; r < SS_CMAX * SS_DVT / SS_THREADS; ++r) {
      const int e = tid + r * SS_THREADS, j = e / SS_DVT, c = e % SS_DVT;
      vs[e] = (j < C && c < ncols) ? to_f32(vb[(int64_t)(t0 + j) * a.v_ss + c]) : 0.f;
    }
    __syncthreads();
    const float total = cum[C - 1];
    if (tid < SS_CMAX) {
      ecum[tid] = tid < C ? expf(cum[tid]) : 0.f;
      wdec[tid] = tid < C ? expf(total - cum[tid]) : 0.f;
    }

    // pass A: scores q_i·k_j (i = ty + 16a, j = tx + 16b) and q_i·S[:, c]
    // (c = tx, tx + 16), over the dk tiles
    float sc[4][4], oi[4][2];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) sc[x][y] = 0.f;
      oi[x][0] = oi[x][1] = 0.f;
    }
    for (int d0 = 0; d0 < dkp; d0 += SS_DKT) {
      load_dk_tile(qs, qb, a.q_ss, t0, C, d0, a.dk);
      load_dk_tile(ks, kb, a.k_ss, t0, C, d0, a.dk);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < SS_DKT; ++d) {
        float qa[4], kv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          qa[x] = qs[(ty + 16 * x) * SS_PAD + d];
          kv[x] = ks[(tx + 16 * x) * SS_PAD + d];
        }
        const float s0v = st[(d0 + d) * SS_DVT + tx];
        const float s1v = st[(d0 + d) * SS_DVT + tx + 16];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int y = 0; y < 4; ++y) sc[x][y] += qa[x] * kv[y];
          oi[x][0] += qa[x] * s0v;
          oi[x][1] += qa[x] * s1v;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = ty + 16 * x;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int j = tx + 16 * y;
        // mask before exp: j > i never exponentiates a positive sum
        ps[i * SS_PPAD + j] = (j <= i && i < C) ? sc[x][y] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    __syncthreads();

    // o_i = exp(cum_i)·(q_i·S) + Σ_{j<=i} p_ij v_j
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = ty + 16 * x;
      if (i < C) {
        float o0 = ecum[i] * oi[x][0], o1 = ecum[i] * oi[x][1];
        for (int j = 0; j <= i; ++j) {
          const float p = ps[i * SS_PPAD + j];
          o0 += p * vs[j * SS_DVT + tx];
          o1 += p * vs[j * SS_DVT + tx + 16];
        }
        T* orow = ob + (int64_t)(t0 + i) * a.o_ss;
        if (tx < ncols) orow[tx] = from_f32<T>(o0);
        if (tx + 16 < ncols) orow[tx + 16] = from_f32<T>(o1);
      }
    }
    __syncthreads();
    for (int e = tid; e < SS_CMAX * SS_DVT; e += SS_THREADS) vs[e] *= wdec[e / SS_DVT];
    const float etot = expf(total);
    __syncthreads();

    // pass B: S[d, c] <- exp(cum_C)·S[d, c] + Σ_j k_j[d]·exp(cum_C - cum_j)·v_j[c]
    for (int d0 = 0; d0 < dkp; d0 += SS_DKT) {
      load_dk_tile(ks, kb, a.k_ss, t0, C, d0, a.dk);
      __syncthreads();
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int dd = ty + 16 * x;
        float acc0 = 0.f, acc1 = 0.f;
        for (int j = 0; j < C; ++j) {
          const float kj = ks[j * SS_PAD + dd];
          acc0 += kj * vs[j * SS_DVT + tx];
          acc1 += kj * vs[j * SS_DVT + tx + 16];
        }
        float* srow = st + (d0 + dd) * SS_DVT;
        srow[tx] = etot * srow[tx] + acc0;
        srow[tx + 16] = etot * srow[tx + 16] + acc1;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < a.dk * SS_DVT; i += SS_THREADS) {
    const int d = i / SS_DVT, c = i % SS_DVT;
    if (c < ncols) a.sf[sbase + (int64_t)d * a.dv + c] = st[i];
  }
}

template <typename T>
cudaError_t launch(const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(a.dk);
  cudaError_t err = allow_smem(ssm_scan_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.dv + SS_DVT - 1) / SS_DVT, a.H, a.B);
  ssm_scan_kernel<T><<<grid, SS_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k (B, H, S, dk), v (B, H, S, dv) and o (B, H, S, dv) in one dtype, any
// strides with a unit innermost one; log_g (B, H, S) f32, any strides;
// state and final (B, H, dk, dv) f32, contiguous.  1 <= chunk <= 64 and
// S % chunk == 0.  Returns cudaGetLastError().
extern "C" int ssm_scan_fwd(const void* q, const void* k, const void* v,
                            const float* log_g, const float* state, void* o,
                            float* final_state, int B, int H, int S, int dk,
                            int dv, int chunk,
                            long long q_sb, long long q_sh, long long q_ss,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long g_sb, long long g_sh, long long g_ss,
                            long long o_sb, long long o_sh, long long o_ss,
                            int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk < 1 || dv < 1 || chunk < 1 ||
      chunk > SS_CMAX || S % chunk != 0 || B > 65535 || H > 65535 ||
      scan_smem_bytes(dk) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const ScanArgs a{q, k, v, log_g, state, o, final_state, B, H, S, dk, dv,
                   chunk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                   v_ss, g_sb, g_sh, g_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return (int)launch<__nv_bfloat16>(a, s);
  if (dtype == DT_F32) return (int)launch<float>(a, s);
  return (int)cudaErrorInvalidValue;
}
