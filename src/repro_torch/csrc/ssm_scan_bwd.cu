// The backward of the chunked gated linear-attention scan for Hopper
// (sm_90a), f32 math on the CUDA cores.
//
// Replaces: no Pallas kernel.  The JAX package trains through jax.vjp of
// src/repro/kernels/ref.py::ssm_scan (its lax.scan over chunks; the Pallas
// ssm_scan_pallas defines no autodiff rule).  This is the backward of the
// port's forward kernels (csrc/ssm_scan.cu, csrc/ssm_scan_mma.cu) under
// kernels/ssm_scan.py::SsmScanFn, as csrc/flash_attention_bwd.cu is the
// flash forward's: the training of models/layers.py::mlstm (8 launches a
// step of xlstm-125m) and ::mamba (hymba-1.5b's 32).
//
// The function, per (batch row, head), with the chunk's inclusive decay
// sums cum_i, T = cum_C, the chunk-start state S_c and dS the gradient of
// the state after the chunk (dS_F, the final state's cotangent, at first):
//   dv_j = Σ_{i>=j} p_ij do_i + exp(T - cum_j)·dSᵀ k_j
//   dq_i = exp(cum_i)·S_c do_i + Σ_{j<=i} b_ij k_j
//   dk_j = Σ_{i>=j} b_ij q_i + exp(T - cum_j)·dS v_j
//   dS  <- exp(T)·dS + Σ_i exp(cum_i)·q_i do_iᵀ
// with p_ij = (q_i·k_j)·exp(cum_i - cum_j), b_ij = (do_i·v_j)·exp(cum_i -
// cum_j) for j <= i, the exponent masked (j > i gives 0) BEFORE exp, as in
// the forward.  The decay's gradient takes no exponent: over the whole
// sequence o depends on c_t = Σ_{s<=t} log_g_s through exp(c_t)·q_t and
// exp(-c_j)·k_j alone, so dL/dc_t = q_t·dq_t - k_t·dk_t (the full
// gradients), plus <dS_F, S_F> at the last token (the final state's
// exp(c_T) factor), and dlog_g is the reverse cumulative sum of dL/dc.
// kernels/ref.py::ssm_scan_bwd is the same function in plain PyTorch.
//
// What bounds it on this card: bytes and operations about equally.  At
// xlstm-125m's training shape (B 4, S 2048, H 4, dk 384, dv 385, chunk 64)
// the chunk form does ~5 C×C×d products a chunk (q·kᵀ, do·vᵀ, pᵀ·do, b·k,
// bᵀ·q) and ~5 C×dk×dv ones (the chunk-start state's recompute, S_c·do,
// dS·v, dSᵀ·k, the dS update): ~0.12 GFLOP a (row, head), 56 GFLOP in all
// (0.057 ms at bf16's tensor-core peak), against 196 MB of operands read
// and results written once (0.058 ms at 3.35 TB/s).  This first kernel
// runs them on the CUDA cores in f32: right first, tensor cores later.
//
// What the design does about it:
//  * The intra-chunk terms do not depend on the recurrence: a first kernel,
//    one block per (chunk, row, head), all chunks at once, forms p and b
//    (C×C, over the whole dk and dv) and from them pᵀ·do, b·k and bᵀ·q, into
//    f32 scratch.  Each is computed once, not once per column slice.
//  * The state gradient dS is (dk, dv) f32 a (row, head): 591 KB at
//    xLSTM's shape, more than a block's shared memory.  The state terms are
//    separable by value column, so the recurrent kernel's grid is (dv / 32
//    column slices, H, B), each block keeping its (dk, 32) slice of the
//    state, then of dS, in shared memory (50 KB at dk 384; 94 KB in all,
//    so two blocks share an SM and xLSTM's 208 blocks run in one wave).
//  * The chunk-start states are RECOMPUTED, not saved by the forward: each
//    block first runs the forward's state recurrence over its slice and
//    writes each chunk's start to a scratch buffer (B·H·(S/C)·dk·dv f32,
//    303 MB at the shape above, live only during the call), then walks the
//    chunks in reverse.  Saving them in the forward would hold that buffer
//    from each layer's forward to its backward (2.4 GB over xlstm-125m's 8
//    mLSTM layers) and change both forward kernels; under remat "nothing"
//    the forward runs twice anyway.
//  * dq, dk and dL/dc sum over all value columns, so the column slices
//    write f32 partials of dq and dk's state terms (13 slices × B·H·S·dk
//    each at the shape above: 1.31 GB written and read back, ~0.8 ms of
//    traffic at 3.35 TB/s; with the states and the intra terms, 1.76 GB of
//    scratch a call; summing them on chip is left to the tensor-core
//    redesign); a third kernel sums the
//    intra term and the slices' partials in a fixed order (no atomics: the
//    result is deterministic), writes dq and dk in the inputs' dtype and
//    dL/dc_t = q_t·dq_t - k_t·dk_t (f32, before the cast), one warp a
//    token; a fourth runs the reverse cumulative sum per (row, head) in
//    fixed segments.
//  * q and k stream through shared memory in dk tiles (64 wide; 16 at
//    Hymba's dk 16, a second instance), v and do in 64-wide column tiles
//    in the intra kernel.  Every product is a register tile a thread over
//    rows ty + 16x and columns tx + 16y.  The ragged edges (dv = 385: a
//    1-column last slice; dk not a multiple of the tile; C below 64) read
//    as zeros, element by element, so strided q/k halves of one buffer
//    (Hymba's C and B) need no copy.
#include "common.cuh"

namespace {

constexpr int SB_THREADS = 256;   // 16 x 16
constexpr int SB_CMAX = 64;       // tokens per chunk, at most
constexpr int SB_DVT = 32;        // value columns a block of the recurrence
constexpr int SB_TILE = 64;       // dims of an intra-kernel tile
constexpr int SB_TPAD = SB_TILE + 1;
constexpr int SB_VPAD = SB_DVT + 1;
constexpr int SB_PPAD = SB_CMAX + 1;
constexpr int SB_RED_TOKENS = SB_THREADS / 32;   // reduce: a warp a token

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* dout;
  const float* g; const float* s0; const float* dsf;   // dsf: null = zero
  void* out_dq; void* out_dk; void* out_dv; float* dg; float* ds0;
  float* states;    // (B, H, S / C, dk, dv) chunk-start states
  float* pdq;       // (NS, B, H, S, dk) the slices' state terms of dq
  float* pdk;       // the same for dk
  float* psf;       // (NS, B, H) partials of <dS_F, S_F>
  float* dcum;      // (B, H, S) dL/dc
  float* iq; float* ik;   // (B, H, S, dk) the intra terms of dq, dk
  float* iv;              // (B, H, S, dv) the intra term of dv
  int B, H, S, dk, dv, chunk, ns;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss, g_sb, g_sh, g_ss;
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int64_t dg_sb, dg_sh, dg_ss;
};

// the recurrent kernel's dk tile: 16 wide where dk fits in it (Hymba's),
// else 64
__host__ __device__ inline int rec_tile(int dk) { return dk <= 16 ? 16 : 64; }

__host__ __device__ inline int dk_padded(int dk) {
  const int t = rec_tile(dk);
  return (dk + t - 1) / t * t;
}

__host__ inline size_t intra_smem_bytes() {
  return sizeof(float) * (2 * SB_CMAX * SB_TPAD + 2 * SB_CMAX * SB_PPAD +
                          3 * SB_CMAX);
}

__host__ inline size_t rec_smem_bytes(int dk) {
  const int t = rec_tile(dk);
  return sizeof(float) *
         ((size_t)dk_padded(dk) * SB_VPAD + SB_CMAX * (t + 1) + t * SB_VPAD +
          2 * SB_CMAX * SB_VPAD + 3 * SB_CMAX + 32);
}

// rows [0, C) x dims [d0, d0 + W) of a (S, n) slab from token t0 into a
// [64][W + 1] f32 tile; everything outside reads as zero
template <int W, typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int64_t ss, int t0, int C, int d0,
                                          int n) {
#pragma unroll 4
  for (int r = 0; r < SB_CMAX * W / SB_THREADS; ++r) {
    const int e = threadIdx.x + r * SB_THREADS, i = e / W, d = e % W;
    dst[i * (W + 1) + d] =
        (i < C && d0 + d < n) ? to_f32(src[(int64_t)(t0 + i) * ss + d0 + d]) : 0.f;
  }
}

// rows [0, C) x the block's ncols value columns from token t0 into a
// [64][33] f32 tile, zeros outside
template <typename T>
__device__ __forceinline__ void load_cols(float* __restrict__ dst,
                                          const T* __restrict__ src, int64_t ss,
                                          int t0, int C, int ncols) {
#pragma unroll
  for (int r = 0; r < SB_CMAX * SB_DVT / SB_THREADS; ++r) {
    const int e = threadIdx.x + r * SB_THREADS, j = e / SB_DVT, c = e % SB_DVT;
    dst[j * SB_VPAD + c] =
        (j < C && c < ncols) ? to_f32(src[(int64_t)(t0 + j) * ss + c]) : 0.f;
  }
}

// the chunk's inclusive decay sums (one warp's shuffle scan, 2 x 32), then
// exp(cum_i) and exp(cum_C - cum_j); zeros past C.  Ends on a barrier.
__device__ __forceinline__ void chunk_decays(const float* __restrict__ gb,
                                             int64_t g_ss, int t0, int C,
                                             float* cum, float* ecum,
                                             float* wdec) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    float g0 = tid < C ? gb[(int64_t)(t0 + tid) * g_ss] : 0.f;
    float g1 = tid + 32 < C ? gb[(int64_t)(t0 + tid + 32) * g_ss] : 0.f;
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
  __syncthreads();
  if (tid < SB_CMAX) {
    const float total = cum[C - 1];
    ecum[tid] = tid < C ? expf(cum[tid]) : 0.f;
    wdec[tid] = tid < C ? expf(total - cum[tid]) : 0.f;
  }
  __syncthreads();
}

// -- the intra-chunk terms: one block a (chunk, batch row, head) ------------
// p_ij = (q_i·k_j)·exp(cum_i - cum_j), b_ij = (do_i·v_j)·exp(cum_i - cum_j)
// for j <= i (the exponent masked first); then iv = pᵀ·do, iq = b·k,
// ik = bᵀ·q, f32, into scratch
template <typename T>
__global__ void __launch_bounds__(SB_THREADS)
ssm_bwd_intra(BwdArgs a) {
  extern __shared__ float si_smem[];
  float* xt = si_smem;                       // [CMAX][TPAD]
  float* yt = xt + SB_CMAX * SB_TPAD;        // [CMAX][TPAD]
  float* ps = yt + SB_CMAX * SB_TPAD;        // [CMAX][PPAD]
  float* bs = ps + SB_CMAX * SB_PPAD;        // [CMAX][PPAD]
  float* cum = bs + SB_CMAX * SB_PPAD;       // [CMAX]
  float* ecum = cum + SB_CMAX;
  float* wdec = ecum + SB_CMAX;

  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int C = a.chunk, t0 = ci * C;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const int64_t chain = (int64_t)b * a.H + h;
  chunk_decays(a.g + b * a.g_sb + h * a.g_sh, a.g_ss, t0, C, cum, ecum, wdec);

  // q_i·k_j over the dk tiles and do_i·v_j over the dv tiles
  // (i = ty + 16x, j = tx + 16y)
  float sc[4][4], bv[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) sc[x][y] = bv[x][y] = 0.f;
  for (int d0 = 0; d0 < a.dk; d0 += SB_TILE) {
    load_tile<SB_TILE>(xt, qb, a.q_ss, t0, C, d0, a.dk);
    load_tile<SB_TILE>(yt, kb, a.k_ss, t0, C, d0, a.dk);
    __syncthreads();
    const int dn = min(SB_TILE, a.dk - d0);
#pragma unroll 4
    for (int d = 0; d < dn; ++d) {
      float xa[4], ya[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        xa[x] = xt[(ty + 16 * x) * SB_TPAD + d];
        ya[x] = yt[(tx + 16 * x) * SB_TPAD + d];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) sc[x][y] += xa[x] * ya[y];
    }
    __syncthreads();
  }
  for (int c0 = 0; c0 < a.dv; c0 += SB_TILE) {
    load_tile<SB_TILE>(xt, dob, a.do_ss, t0, C, c0, a.dv);
    load_tile<SB_TILE>(yt, vb, a.v_ss, t0, C, c0, a.dv);
    __syncthreads();
    const int cn = min(SB_TILE, a.dv - c0);
#pragma unroll 4
    for (int c = 0; c < cn; ++c) {
      float xa[4], ya[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        xa[x] = xt[(ty + 16 * x) * SB_TPAD + c];
        ya[x] = yt[(tx + 16 * x) * SB_TPAD + c];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) bv[x][y] += xa[x] * ya[y];
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
      const float dec = (j <= i && i < C) ? expf(cum[i] - cum[j]) : 0.f;
      ps[i * SB_PPAD + j] = sc[x][y] * dec;
      bs[i * SB_PPAD + j] = bv[x][y] * dec;
    }
  }
  __syncthreads();

  // iv_j = Σ_{i>=j} p_ij do_i, per 64-column tile (j = ty + 16x,
  // columns c0 + tx + 16y)
  float* ivb = a.iv + (chain * a.S + t0) * a.dv;
  for (int c0 = 0; c0 < a.dv; c0 += SB_TILE) {
    load_tile<SB_TILE>(xt, dob, a.do_ss, t0, C, c0, a.dv);
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = ty + 16 * x;
      if (j >= C) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = j; i < C; ++i) {
        const float p = ps[i * SB_PPAD + j];
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[y] += p * xt[i * SB_TPAD + tx + 16 * y];
      }
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int c = c0 + tx + 16 * y;
        if (c < a.dv) ivb[(int64_t)j * a.dv + c] = acc[y];
      }
    }
    __syncthreads();
  }

  // iq_i = Σ_{j<=i} b_ij k_j, ik_j = Σ_{i>=j} b_ij q_i, per dk tile (rows
  // ty + 16x, dims d0 + tx + 16y)
  float* iqb = a.iq + (chain * a.S + t0) * a.dk;
  float* ikb = a.ik + (chain * a.S + t0) * a.dk;
  for (int d0 = 0; d0 < a.dk; d0 += SB_TILE) {
    load_tile<SB_TILE>(xt, qb, a.q_ss, t0, C, d0, a.dk);
    load_tile<SB_TILE>(yt, kb, a.k_ss, t0, C, d0, a.dk);
    __syncthreads();
    float gq[4][4], gk[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) gq[x][y] = gk[x][y] = 0.f;
    for (int j = 0; j < C; ++j) {
      float bi[4], bj[4], kv[4], qv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        bi[x] = bs[(ty + 16 * x) * SB_PPAD + j];   // b_{i, j}, i = row
        bj[x] = bs[j * SB_PPAD + ty + 16 * x];     // b_{j, i'}, i' = row
        kv[x] = yt[j * SB_TPAD + tx + 16 * x];
        qv[x] = xt[j * SB_TPAD + tx + 16 * x];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          gq[x][y] += bi[x] * kv[y];
          gk[x][y] += bj[x] * qv[y];
        }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = ty + 16 * x;
      if (i >= C) continue;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int d = d0 + tx + 16 * y;
        if (d < a.dk) {
          iqb[(int64_t)i * a.dk + d] = gq[x][y];
          ikb[(int64_t)i * a.dk + d] = gk[x][y];
        }
      }
    }
    __syncthreads();
  }
}

// -- the recurrence: one block a (32 value columns, batch row, head) --------
// the forward sweep writes each chunk's start state; the reverse sweep
// carries the slice's dS and writes dv (complete: iv + its state term) and
// the slice's state terms of dq and dk
template <typename T, int DKT>
__global__ void __launch_bounds__(SB_THREADS, 2)
ssm_bwd_rec(BwdArgs a) {
  constexpr int RX = DKT / 16;           // a thread's rows of a tile
  constexpr int KPAD = DKT + 1;
  extern __shared__ float sb_smem[];
  const int dkp = dk_padded(a.dk);
  float* ds = sb_smem;                   // [dkp][VPAD] state, then dS
  float* kt = ds + dkp * SB_VPAD;        // [CMAX][KPAD] a k or q tile
  float* stt = kt + SB_CMAX * KPAD;      // [DKT][VPAD] a tile of S_c
  float* vs = stt + DKT * SB_VPAD;       // [CMAX][VPAD]
  float* dos = vs + SB_CMAX * SB_VPAD;   // [CMAX][VPAD]
  float* cum = dos + SB_CMAX * SB_VPAD;  // [CMAX]
  float* ecum = cum + SB_CMAX;           // exp(cum_i)
  float* wdec = ecum + SB_CMAX;          // exp(cum_C - cum_j)
  float* red = wdec + SB_CMAX;           // [32]

  const int slice = blockIdx.x, c0 = slice * SB_DVT, h = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ncols = min(SB_DVT, a.dv - c0);
  const int C = a.chunk, nc = a.S / C;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + c0;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh + c0;
  T* dvb = static_cast<T*>(a.out_dv) + b * a.dv_sb + h * a.dv_sh + c0;
  const float* gb = a.g + b * a.g_sb + h * a.g_sh;
  const int64_t chain = (int64_t)b * a.H + h;
  const int64_t sbase = chain * a.dk * a.dv + c0;
  float* stb = a.states + chain * nc * a.dk * a.dv + c0;
  const int64_t pbase = ((int64_t)slice * a.B * a.H + chain) * a.S * a.dk;
  const float* ivb = a.iv + chain * a.S * a.dv + c0;

  for (int i = tid; i < dkp * SB_VPAD; i += SB_THREADS) {
    const int d = i / SB_VPAD, c = i % SB_VPAD;
    ds[i] = (d < a.dk && c < ncols) ? a.s0[sbase + (int64_t)d * a.dv + c] : 0.f;
  }

  // -- the forward sweep: each chunk's start state into the scratch --------
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * C;
    chunk_decays(gb, a.g_ss, t0, C, cum, ecum, wdec);
    load_cols(vs, vb, a.v_ss, t0, C, ncols);
    float* dst = stb + (int64_t)ci * a.dk * a.dv;
    for (int i = tid; i < a.dk * SB_DVT; i += SB_THREADS) {
      const int d = i / SB_DVT, c = i % SB_DVT;
      if (c < ncols) dst[(int64_t)d * a.dv + c] = ds[d * SB_VPAD + c];
    }
    const float etot = expf(cum[C - 1]);
    __syncthreads();
    for (int d0 = 0; d0 < dkp; d0 += DKT) {
      load_tile<DKT>(kt, kb, a.k_ss, t0, C, d0, a.dk);
      __syncthreads();
#pragma unroll
      for (int x = 0; x < RX; ++x) {
        const int dd = ty + 16 * x;
        float acc0 = 0.f, acc1 = 0.f;
        for (int j = 0; j < C; ++j) {
          const float kw = kt[j * KPAD + dd] * wdec[j];
          acc0 += kw * vs[j * SB_VPAD + tx];
          acc1 += kw * vs[j * SB_VPAD + tx + 16];
        }
        float* srow = ds + (d0 + dd) * SB_VPAD;
        srow[tx] = etot * srow[tx] + acc0;
        srow[tx + 16] = etot * srow[tx + 16] + acc1;
      }
      __syncthreads();
    }
  }

  // the final state's term of dL/dc_T, then dS <- dS_F
  float part = 0.f;
  for (int i = tid; i < a.dk * SB_DVT; i += SB_THREADS) {
    const int d = i / SB_DVT, c = i % SB_DVT;
    float* e = ds + d * SB_VPAD + c;
    const float f = (a.dsf != nullptr && c < ncols)
                        ? a.dsf[sbase + (int64_t)d * a.dv + c] : 0.f;
    part += f * *e;
    *e = f;
  }
  part = block_reduce<false>(part, red);
  if (tid == 0) a.psf[(int64_t)slice * a.B * a.H + chain] = part;
  __syncthreads();

  // -- the reverse sweep ----------------------------------------------------
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * C;
    chunk_decays(gb, a.g_ss, t0, C, cum, ecum, wdec);
    load_cols(vs, vb, a.v_ss, t0, C, ncols);
    load_cols(dos, dob, a.do_ss, t0, C, ncols);
    const float etot = expf(cum[C - 1]);

    // pass A: k_j·dS[:, c] (j = ty + 16x, c = tx + 16y) over the dk tiles
    float kds[4][2];
#pragma unroll
    for (int x = 0; x < 4; ++x) kds[x][0] = kds[x][1] = 0.f;
    for (int d0 = 0; d0 < dkp; d0 += DKT) {
      load_tile<DKT>(kt, kb, a.k_ss, t0, C, d0, a.dk);
      __syncthreads();
      const int dn = min(DKT, a.dk - d0);
#pragma unroll 4
      for (int d = 0; d < dn; ++d) {
        const float s0v = ds[(d0 + d) * SB_VPAD + tx];
        const float s1v = ds[(d0 + d) * SB_VPAD + tx + 16];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float kr = kt[(ty + 16 * x) * KPAD + d];
          kds[x][0] += kr * s0v;
          kds[x][1] += kr * s1v;
        }
      }
      __syncthreads();
    }
    // dv_j = iv_j + exp(T - cum_j)·(k_j·dS), complete here
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = ty + 16 * x;
      if (j < C) {
        const float* ivr = ivb + (int64_t)(t0 + j) * a.dv;
        T* row = dvb + (int64_t)(t0 + j) * a.dv_ss;
        if (tx < ncols) row[tx] = from_f32<T>(ivr[tx] + wdec[j] * kds[x][0]);
        if (tx + 16 < ncols)
          row[tx + 16] = from_f32<T>(ivr[tx + 16] + wdec[j] * kds[x][1]);
      }
    }

    // pass B, per dk tile: the slice's state terms of dq (i = ty + 16x)
    // and dk (j = ty + 16x) at dims d0 + tx + 16y, then the tile's rows of
    // dS
    for (int d0 = 0; d0 < dkp; d0 += DKT) {
      load_tile<DKT>(kt, qb, a.q_ss, t0, C, d0, a.dk);
      const float* src = stb + (int64_t)ci * a.dk * a.dv;
#pragma unroll
      for (int r = 0; r < DKT * SB_DVT / SB_THREADS; ++r) {
        const int e = tid + r * SB_THREADS, d = e / SB_DVT, c = e % SB_DVT;
        stt[d * SB_VPAD + c] = (d0 + d < a.dk && c < ncols)
                                   ? src[(int64_t)(d0 + d) * a.dv + c] : 0.f;
      }
      __syncthreads();
      float sq[4][RX], sk[4][RX];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < RX; ++y) sq[x][y] = sk[x][y] = 0.f;
      for (int c = 0; c < SB_DVT; ++c) {
        float da[4], va[4], sv[RX], dsv[RX];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          da[x] = dos[(ty + 16 * x) * SB_VPAD + c];
          va[x] = vs[(ty + 16 * x) * SB_VPAD + c];
        }
#pragma unroll
        for (int y = 0; y < RX; ++y) {
          sv[y] = stt[(tx + 16 * y) * SB_VPAD + c];
          dsv[y] = ds[(d0 + tx + 16 * y) * SB_VPAD + c];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < RX; ++y) {
            sq[x][y] += da[x] * sv[y];
            sk[x][y] += va[x] * dsv[y];
          }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = ty + 16 * x;
        if (i < C) {
          float* pq = a.pdq + pbase + (int64_t)(t0 + i) * a.dk + d0;
          float* pk = a.pdk + pbase + (int64_t)(t0 + i) * a.dk + d0;
#pragma unroll
          for (int y = 0; y < RX; ++y) {
            const int dd = tx + 16 * y;
            if (d0 + dd < a.dk) {
              pq[dd] = ecum[i] * sq[x][y];
              pk[dd] = wdec[i] * sk[x][y];
            }
          }
        }
      }
      __syncthreads();                 // every read of the old dS tile done
      // dS[d][c] <- exp(T)·dS[d][c] + Σ_i exp(cum_i)·q_i[d]·do_i[c]
#pragma unroll
      for (int x = 0; x < RX; ++x) {
        const int dd = ty + 16 * x;
        float acc0 = 0.f, acc1 = 0.f;
        for (int i = 0; i < C; ++i) {
          const float qe = kt[i * KPAD + dd] * ecum[i];
          acc0 += qe * dos[i * SB_VPAD + tx];
          acc1 += qe * dos[i * SB_VPAD + tx + 16];
        }
        float* srow = ds + (d0 + dd) * SB_VPAD;
        srow[tx] = etot * srow[tx] + acc0;
        srow[tx + 16] = etot * srow[tx + 16] + acc1;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < a.dk * SB_DVT; i += SB_THREADS) {
    const int d = i / SB_DVT, c = i % SB_DVT;
    if (c < ncols) a.ds0[sbase + (int64_t)d * a.dv + c] = ds[d * SB_VPAD + c];
  }
}

// dq, dk = the intra term and the slices' state terms summed in that fixed
// order; dL/dc_t = q_t·dq_t - k_t·dk_t from the f32 sums.  A warp a token.
template <typename T>
__global__ void __launch_bounds__(SB_THREADS)
ssm_bwd_reduce(BwdArgs a) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * SB_RED_TOKENS + threadIdx.x / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (t >= a.S) return;
  const int64_t chain = (int64_t)b * a.H + h;
  const int64_t stride = (int64_t)a.B * a.H * a.S * a.dk;
  const int64_t base = (chain * a.S + t) * a.dk;
  const T* qr = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + t * a.q_ss;
  const T* kr = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + t * a.k_ss;
  T* dqr = static_cast<T*>(a.out_dq) + b * a.dq_sb + h * a.dq_sh + t * a.dq_ss;
  T* dkr = static_cast<T*>(a.out_dk) + b * a.dk_sb + h * a.dk_sh + t * a.dk_ss;
  float acc = 0.f;
  for (int d = lane; d < a.dk; d += 32) {
    float sq = a.iq[base + d], sk = a.ik[base + d];
    for (int s = 0; s < a.ns; ++s) {
      sq += a.pdq[s * stride + base + d];
      sk += a.pdk[s * stride + base + d];
    }
    acc += to_f32(qr[d]) * sq - to_f32(kr[d]) * sk;
    dqr[d] = from_f32<T>(sq);
    dkr[d] = from_f32<T>(sk);
  }
  acc = warp_sum(acc);
  if (lane == 0) a.dcum[chain * a.S + t] = acc;
}

// dlog_g_s = Σ_{t>=s} dL/dc_t + <dS_F, S_F> (the slices' partials in
// order): each thread a fixed segment of tokens, the segments' suffix sums
// by one thread.  A block a (batch row, head).
__global__ void __launch_bounds__(SB_THREADS)
ssm_bwd_gscan(BwdArgs a) {
  __shared__ float seg[SB_THREADS];
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int64_t chain = (int64_t)b * a.H + h;
  const float* dc = a.dcum + chain * a.S;
  const int per = (a.S + SB_THREADS - 1) / SB_THREADS;
  const int lo = min(a.S, tid * per), hi = min(a.S, lo + per);
  float s = 0.f;
  for (int t = lo; t < hi; ++t) s += dc[t];
  seg[tid] = s;
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < a.ns; ++i) run += a.psf[(int64_t)i * a.B * a.H + chain];
    for (int i = SB_THREADS - 1; i >= 0; --i) {
      const float x = seg[i];
      seg[i] = run;                    // the segments after i, and <dS_F, S_F>
      run += x;
    }
  }
  __syncthreads();
  float run = seg[tid];
  float* out = a.dg + b * a.dg_sb + h * a.dg_sh;
  for (int t = hi - 1; t >= lo; --t) {
    run += dc[t];
    out[(int64_t)t * a.dg_ss] = run;
  }
}

template <typename T, int DKT>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t ismem = intra_smem_bytes(), rsmem = rec_smem_bytes(a.dk);
  cudaError_t err = allow_smem(ssm_bwd_intra<T>, ismem);
  if (err != cudaSuccess) return err;
  err = allow_smem(ssm_bwd_rec<T, DKT>, rsmem);
  if (err != cudaSuccess) return err;
  ssm_bwd_intra<T><<<dim3(a.S / a.chunk, a.H, a.B), SB_THREADS, ismem,
                     stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssm_bwd_rec<T, DKT><<<dim3(a.ns, a.H, a.B), SB_THREADS, rsmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid((a.S + SB_RED_TOKENS - 1) / SB_RED_TOKENS, a.H, a.B);
  ssm_bwd_reduce<T><<<rgrid, SB_THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssm_bwd_gscan<<<dim3(a.H, a.B), SB_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(const BwdArgs& a, cudaStream_t stream) {
  return rec_tile(a.dk) == 16 ? launch<T, 16>(a, stream)
                              : launch<T, 64>(a, stream);
}

}  // namespace

// q, k (B, H, S, dk), v and do (B, H, S, dv), dq, dk, dv likewise, one
// dtype, any strides with a unit innermost one; log_g and dlog_g (B, H, S)
// f32, any strides; state, dstate_final (null: zero) and dstate (B, H, dk,
// dv) f32 contiguous.  Scratch, f32: states (B, H, S / chunk, dk, dv);
// pdq, pdk (ceil(dv / 32), B, H, S, dk); psf (ceil(dv / 32), B, H); dcum
// (B, H, S); iq, ik (B, H, S, dk); iv (B, H, S, dv).  1 <= chunk <= 64,
// S % chunk == 0.  Four launches on ``stream``; returns cudaGetLastError().
extern "C" int ssm_scan_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const float* log_g,
                            const float* state, const float* dstate_final,
                            void* dq, void* dk, void* dv, float* dlog_g,
                            float* dstate, float* states, float* pdq,
                            float* pdk, float* psf, float* dcum, float* iq,
                            float* ik, float* iv, int B, int H, int S,
                            int dk_, int dv_, int chunk,
                            long long q_sb, long long q_sh, long long q_ss,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long do_sb, long long do_sh, long long do_ss,
                            long long g_sb, long long g_sh, long long g_ss,
                            long long dq_sb, long long dq_sh, long long dq_ss,
                            long long dk_sb, long long dk_sh, long long dk_ss,
                            long long dv_sb, long long dv_sh, long long dv_ss,
                            long long dg_sb, long long dg_sh, long long dg_ss,
                            int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk_ < 1 || dv_ < 1 || chunk < 1 ||
      chunk > SB_CMAX || S % chunk != 0 || B > 65535 || H > 65535 ||
      rec_smem_bytes(dk_) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, log_g, state, dstate_final, dq, dk, dv,
                  dlog_g, dstate, states, pdq, pdk, psf, dcum, iq, ik, iv,
                  B, H, S, dk_, dv_, chunk, (dv_ + SB_DVT - 1) / SB_DVT,
                  q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                  do_sb, do_sh, do_ss, g_sb, g_sh, g_ss,
                  dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
                  dg_sb, dg_sh, dg_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return (int)launch_tile<__nv_bfloat16>(a, s);
  if (dtype == DT_F32) return (int)launch_tile<float>(a, s);
  return (int)cudaErrorInvalidValue;
}
