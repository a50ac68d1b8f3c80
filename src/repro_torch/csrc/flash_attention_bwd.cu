// Causal GQA flash-attention backward for Hopper (sm_90a), CUDA cores, f32 math.
//
// Replaces: src/repro/kernels/ref.py::flash_structured's custom VJP
// (_fs_bwd, the blockwise-recompute flash backward the JAX package trains
// through).  It is no Pallas kernel: the JAX package has no Pallas
// backward, and its Pallas forward defines no autodiff rule.  Called by
// kernels/flash_attention.py::FlashAttentionFn.backward for the training
// attention of models/layers.py (mode="train").
//
// What bounds it on this card: five S x S x hd products per (batch row,
// head), halved by the causal mask (2.5x the forward's work), against a
// few MB of Q/K/V/O/dO, so it is bound by operations.  This first version
// runs them on the CUDA cores in float32 (67 TFLOP/s peak): right first,
// tensor cores later.
//
// What the design does about it: three kernels on one stream, no atomics,
// so every gradient is the same from run to run.
//  (i)   bwd_stats_kernel, one block per (32-query tile, head, batch row):
//        recomputes each row's max and sum over its visible keys, as the
//        forward does, and writes lse = m + log(max(l, 1e-30)) and
//        delta = rowsum(dO·O) to f32 scratch (B, H, Sq).
//  (ii)  bwd_dkdv_kernel, one block per (key tile, KV head, batch row):
//        keeps its keys' dK and dV accumulators in registers (a warp owns
//        KPW keys, a lane HD/32 dims of each) and walks the query tiles
//        of every head of its group that can see them (the causal
//        diagonal and the window bound the range), recomputing
//        p = exp(s - lse) and ds = p·(dp - delta) on the fly: the GQA sum
//        is a loop, never an atomic.
//  (iii) bwd_dq_kernel, one block per (32-query tile, head, batch row):
//        the forward's layout (a warp owns 8 rows, a lane one key of a
//        32-key tile), dQ's accumulators in registers.
// Tiles are staged in shared memory as f32, rows read one per lane padded
// to HD + 4 floats (no bank conflicts in the float4 reads); 16-byte loads
// where rows allow it (common.cuh's TileLoader, in 8-row slices at HD 256),
// element loads otherwise (the proxies' hd 12/16).  The ragged edge is
// masked (rows >= Sq, keys >= Skv load as zero and are never stored);
// causal alignment is bottom-right as in the forward; a row that sees no
// key has p = 0 and contributes nothing.  Softcap: ds *= 1 - tanh² at the
// capped logit.  dQ and dK end scaled by the softmax scale.
#include "common.cuh"

namespace {

constexpr int BW_WARPS = 4;
constexpr int BW_THREADS = BW_WARPS * 32;
constexpr int BW_ROWS = 8;                    // query rows per warp (i, iii)
constexpr int BW_BQ = BW_WARPS * BW_ROWS;     // query rows per tile
constexpr int BW_BK = 32;                     // keys per tile in (i, iii)

// keys per warp in (ii): 8 up to HD 128, 4 at HD 256 (two accumulators of
// KPW x HD/32 floats a lane)
template <int HD>
__host__ __device__ constexpr int bw_kpw() { return HD > 128 ? 4 : 8; }

struct Strides {
  int64_t b, h, s;
};

template <typename T>
struct BwdArgs {
  const T *q, *k, *v, *o, *dout;
  T *dq, *dk, *dv;
  float *lse, *delta;                         // (B, H, Sq) contiguous
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int H, group, Sq, Skv, hd, causal, window, vec;
  float softcap, scale;

  // key j visible to query row i (both global indices)
  __device__ __forceinline__ bool visible(int i, int j) const {
    const int qk = i + (Skv - Sq);            // row in key coordinates
    bool ok = i < Sq && j < Skv;
    if (causal) ok = ok && j <= qk;
    if (window > 0) ok = ok && j > qk - window;
    return ok;
  }
};

// A [ROWS][HD] tile of rows at src + r·rs into f32 shared memory with row
// stride ss; rows >= nrows and dims >= hd read as zero.
template <typename T, int ROWS, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ss, const T* src,
                                          int64_t rs, int nrows, int hd,
                                          int vec) {
  if (vec) {
    constexpr int PARTS = tile_parts<HD>(), PR = ROWS / PARTS;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      TileLoader<T, PR, HD, BW_THREADS> l;
      const T* base = src + (int64_t)p * PR * rs;
      l.fetch_rows([=](int r) { return base + r * rs; }, nrows - p * PR);
      l.store(dst + p * PR * ss, ss);
    }
  } else {
    load_tile_scalar<T, ROWS, HD, BW_THREADS>(dst, ss, src, rs, nrows, hd);
  }
}

template <typename T, int HD>
constexpr size_t stats_smem() {
  return (size_t)(BW_BQ * HD + BW_BK * (HD + 4)) * sizeof(float);
}

// (i) lse and delta of every query row
template <typename T, int HD>
__global__ void __launch_bounds__(BW_THREADS) bwd_stats_kernel(BwdArgs<T> a) {
  constexpr int KST = HD + 4;
  extern __shared__ float4 bw_smem4[];
  float* qs = reinterpret_cast<float*>(bw_smem4);   // [BW_BQ][HD]
  float* ks = qs + BW_BQ * HD;                       // [BW_BK][KST]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BW_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group, off = a.Skv - a.Sq;
  const T* qb = a.q + b * a.qs.b + h * a.qs.h;
  const T* kb = a.k + b * a.ks.b + kvh * a.ks.h;

  load_tile<T, BW_BQ, HD>(qs, HD, qb + q0 * a.qs.s, a.qs.s, a.Sq - q0, a.hd,
                          a.vec);

  // delta = rowsum(dO·O), lanes over the head dim
  float delta[BW_ROWS], m[BW_ROWS], l[BW_ROWS];
#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r) {
    const int i = q0 + warp * BW_ROWS + r;
    float acc = 0.f;
    if (i < a.Sq) {
      const T* orow = a.o + b * a.os.b + h * a.os.h + i * a.os.s;
      const T* drow = a.dout + b * a.dos.b + h * a.dos.h + i * a.dos.s;
      for (int d = lane; d < a.hd; d += 32) acc += to_f32(drow[d]) * to_f32(orow[d]);
    }
    delta[r] = warp_sum(acc);
    m[r] = REPRO_NEG_INF;
    l[r] = 0.f;
  }

  const int row_lo = q0 + off;
  const int row_hi = min(q0 + BW_BQ, a.Sq) - 1 + off;
  const int kv_end = a.causal ? min(a.Skv, row_hi + 1) : a.Skv;
  const int kv_begin = a.window > 0 ? max(0, row_lo - a.window + 1) : 0;
  for (int k0 = (kv_begin / BW_BK) * BW_BK; k0 < kv_end; k0 += BW_BK) {
    __syncthreads();
    load_tile<T, BW_BK, HD>(ks, KST, kb + k0 * a.ks.s, a.ks.s, a.Skv - k0,
                            a.hd, a.vec);
    __syncthreads();
    float s[BW_ROWS];
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * KST);
    const float4* qrow = reinterpret_cast<const float4*>(qs + warp * BW_ROWS * HD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < BW_ROWS; ++r) {
        const float4 qq = qrow[r * (HD / 4) + d4];
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }
    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) {
      const bool ok = a.visible(q0 + warp * BW_ROWS + r, j);
      const float sc = ok ? apply_softcap(s[r] * a.scale, a.softcap) : REPRO_NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * expf(m[r] - m_new) + warp_sum(p);
      m[r] = m_new;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) {
      const int i = q0 + warp * BW_ROWS + r;
      if (i >= a.Sq) continue;
      const int64_t at = ((int64_t)b * a.H + h) * a.Sq + i;
      a.lse[at] = m[r] + logf(fmaxf(l[r], 1e-30f));
      a.delta[at] = delta[r];
    }
  }
}

template <typename T, int HD>
constexpr size_t dkdv_smem() {
  constexpr int BK = BW_WARPS * bw_kpw<HD>();
  return (size_t)(2 * BW_BQ * (HD + 4) + 2 * BK * HD + 2 * BW_BQ) * sizeof(float);
}

// (ii) dK and dV of a key tile, summed over the group's heads
template <typename T, int HD>
__global__ void __launch_bounds__(BW_THREADS) bwd_dkdv_kernel(BwdArgs<T> a) {
  constexpr int KPW = bw_kpw<HD>(), BK = BW_WARPS * KPW;
  constexpr int KST = HD + 4, DPL = HD / 32;
  extern __shared__ float4 bw_smem4[];
  float* qs = reinterpret_cast<float*>(bw_smem4);   // [BW_BQ][KST]
  float* dos = qs + BW_BQ * KST;                     // [BW_BQ][KST]
  float* kt = dos + BW_BQ * KST;                     // [BK][HD]
  float* vt = kt + BK * HD;                          // [BK][HD]
  float* lse_s = vt + BK * HD;                       // [BW_BQ]
  float* del_s = lse_s + BW_BQ;                      // [BW_BQ]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int off = a.Skv - a.Sq;

  load_tile<T, BK, HD>(kt, HD, a.k + b * a.ks.b + kvh * a.ks.h + k0 * a.ks.s,
                       a.ks.s, a.Skv - k0, a.hd, a.vec);
  load_tile<T, BK, HD>(vt, HD, a.v + b * a.vs.b + kvh * a.vs.h + k0 * a.vs.s,
                       a.vs.s, a.Skv - k0, a.hd, a.vec);

  float dk[KPW][DPL], dv[KPW][DPL];
#pragma unroll
  for (int r = 0; r < KPW; ++r)
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) dk[r][dd] = dv[r][dd] = 0.f;

  // query rows that see some key of the tile
  const int kmax = min(k0 + BK, a.Skv) - 1;
  const int i_begin = a.causal ? max(0, k0 - off) : 0;
  const int i_end = a.window > 0 ? min(a.Sq, kmax + a.window - off) : a.Sq;

  for (int hh = 0; hh < a.group; ++hh) {
    const int h = kvh * a.group + hh;
    const T* qb = a.q + b * a.qs.b + h * a.qs.h;
    const T* db = a.dout + b * a.dos.b + h * a.dos.h;
    const float* lse_h = a.lse + ((int64_t)b * a.H + h) * a.Sq;
    const float* del_h = a.delta + ((int64_t)b * a.H + h) * a.Sq;
    for (int q0 = (i_begin / BW_BQ) * BW_BQ; q0 < i_end; q0 += BW_BQ) {
      __syncthreads();                        // previous tile consumed
      load_tile<T, BW_BQ, HD>(qs, KST, qb + q0 * a.qs.s, a.qs.s, a.Sq - q0,
                              a.hd, a.vec);
      load_tile<T, BW_BQ, HD>(dos, KST, db + q0 * a.dos.s, a.dos.s,
                              a.Sq - q0, a.hd, a.vec);
      if (threadIdx.x < BW_BQ) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < a.Sq ? lse_h[i] : 0.f;
        del_s[threadIdx.x] = i < a.Sq ? del_h[i] : 0.f;
      }
      __syncthreads();

      // lane = query row i of the tile; the warp's KPW keys
      const int i = q0 + lane;
      float s[KPW], dp[KPW];
#pragma unroll
      for (int r = 0; r < KPW; ++r) s[r] = dp[r] = 0.f;
      const float4* qrow = reinterpret_cast<const float4*>(qs + lane * KST);
      const float4* drow = reinterpret_cast<const float4*>(dos + lane * KST);
      const float4* krows = reinterpret_cast<const float4*>(kt + warp * KPW * HD);
      const float4* vrows = reinterpret_cast<const float4*>(vt + warp * KPW * HD);
#pragma unroll 2
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 qq = qrow[d4], gg = drow[d4];
#pragma unroll
        for (int r = 0; r < KPW; ++r) {
          const float4 kk = krows[r * (HD / 4) + d4];
          const float4 vv = vrows[r * (HD / 4) + d4];
          s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
          dp[r] += gg.x * vv.x + gg.y * vv.y + gg.z * vv.z + gg.w * vv.w;
        }
      }
      float p[KPW], ds[KPW];
#pragma unroll
      for (int r = 0; r < KPW; ++r) {
        const bool ok = a.visible(i, k0 + warp * KPW + r);
        const float sc = apply_softcap(s[r] * a.scale, a.softcap);
        p[r] = ok ? expf(sc - lse_s[lane]) : 0.f;
        float g = p[r] * (dp[r] - del_s[lane]);
        if (a.softcap > 0.f) {
          const float t = sc / a.softcap;
          g *= 1.f - t * t;
        }
        ds[r] = g;
      }
      // dV += p^T dO, dK += ds^T Q over the tile's 32 rows
#pragma unroll 2
      for (int ii = 0; ii < BW_BQ; ++ii) {
        float gv[DPL], qv[DPL];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          gv[dd] = dos[ii * KST + lane * DPL + dd];
          qv[dd] = qs[ii * KST + lane * DPL + dd];
        }
#pragma unroll
        for (int r = 0; r < KPW; ++r) {
          const float pj = __shfl_sync(0xffffffffu, p[r], ii);
          const float gj = __shfl_sync(0xffffffffu, ds[r], ii);
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) {
            dv[r][dd] += pj * gv[dd];
            dk[r][dd] += gj * qv[dd];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KPW; ++r) {
    const int j = k0 + warp * KPW + r;
    if (j >= a.Skv) continue;
    T* dkrow = a.dk + b * a.dks.b + kvh * a.dks.h + j * a.dks.s;
    T* dvrow = a.dv + b * a.dvs.b + kvh * a.dvs.h + j * a.dvs.s;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane * DPL + dd;
      if (d < a.hd) {
        dkrow[d] = from_f32<T>(dk[r][dd] * a.scale);
        dvrow[d] = from_f32<T>(dv[r][dd]);
      }
    }
  }
}

template <typename T, int HD>
constexpr size_t dq_smem() {
  return (size_t)(2 * BW_BQ * HD + 2 * BW_BK * (HD + 4)) * sizeof(float);
}

// (iii) dQ of a query tile
template <typename T, int HD>
__global__ void __launch_bounds__(BW_THREADS) bwd_dq_kernel(BwdArgs<T> a) {
  constexpr int KST = HD + 4, DPL = HD / 32;
  extern __shared__ float4 bw_smem4[];
  float* qs = reinterpret_cast<float*>(bw_smem4);   // [BW_BQ][HD]
  float* dos = qs + BW_BQ * HD;                      // [BW_BQ][HD]
  float* ks = dos + BW_BQ * HD;                      // [BW_BK][KST]
  float* vs = ks + BW_BK * KST;                      // [BW_BK][KST]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BW_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.group, off = a.Skv - a.Sq;
  const T* kb = a.k + b * a.ks.b + kvh * a.ks.h;
  const T* vb = a.v + b * a.vs.b + kvh * a.vs.h;

  load_tile<T, BW_BQ, HD>(qs, HD, a.q + b * a.qs.b + h * a.qs.h + q0 * a.qs.s,
                          a.qs.s, a.Sq - q0, a.hd, a.vec);
  load_tile<T, BW_BQ, HD>(dos, HD,
                          a.dout + b * a.dos.b + h * a.dos.h + q0 * a.dos.s,
                          a.dos.s, a.Sq - q0, a.hd, a.vec);
  float lse[BW_ROWS], del[BW_ROWS], acc[BW_ROWS][DPL];
#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r) {
    const int i = q0 + warp * BW_ROWS + r;
    const int64_t at = ((int64_t)b * a.H + h) * a.Sq + i;
    lse[r] = i < a.Sq ? a.lse[at] : 0.f;
    del[r] = i < a.Sq ? a.delta[at] : 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[r][dd] = 0.f;
  }

  const int row_lo = q0 + off;
  const int row_hi = min(q0 + BW_BQ, a.Sq) - 1 + off;
  const int kv_end = a.causal ? min(a.Skv, row_hi + 1) : a.Skv;
  const int kv_begin = a.window > 0 ? max(0, row_lo - a.window + 1) : 0;
  for (int k0 = (kv_begin / BW_BK) * BW_BK; k0 < kv_end; k0 += BW_BK) {
    __syncthreads();
    load_tile<T, BW_BK, HD>(ks, KST, kb + k0 * a.ks.s, a.ks.s, a.Skv - k0,
                            a.hd, a.vec);
    load_tile<T, BW_BK, HD>(vs, KST, vb + k0 * a.vs.s, a.vs.s, a.Skv - k0,
                            a.hd, a.vec);
    __syncthreads();
    float s[BW_ROWS], dp[BW_ROWS];
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) s[r] = dp[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * KST);
    const float4* vrow = reinterpret_cast<const float4*>(vs + lane * KST);
    const float4* qrow = reinterpret_cast<const float4*>(qs + warp * BW_ROWS * HD);
    const float4* drow = reinterpret_cast<const float4*>(dos + warp * BW_ROWS * HD);
#pragma unroll 2
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = krow[d4], vv = vrow[d4];
#pragma unroll
      for (int r = 0; r < BW_ROWS; ++r) {
        const float4 qq = qrow[r * (HD / 4) + d4];
        const float4 gg = drow[r * (HD / 4) + d4];
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
        dp[r] += gg.x * vv.x + gg.y * vv.y + gg.z * vv.z + gg.w * vv.w;
      }
    }
    const int j = k0 + lane;
    float ds[BW_ROWS];
#pragma unroll
    for (int r = 0; r < BW_ROWS; ++r) {
      const bool ok = a.visible(q0 + warp * BW_ROWS + r, j);
      const float sc = apply_softcap(s[r] * a.scale, a.softcap);
      const float p = ok ? expf(sc - lse[r]) : 0.f;
      float g = p * (dp[r] - del[r]);
      if (a.softcap > 0.f) {
        const float t = sc / a.softcap;
        g *= 1.f - t * t;
      }
      ds[r] = g;
    }
    // dQ += ds K over the tile's 32 keys
#pragma unroll 2
    for (int jj = 0; jj < BW_BK; ++jj) {
      float kv[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) kv[dd] = ks[jj * KST + lane * DPL + dd];
#pragma unroll
      for (int r = 0; r < BW_ROWS; ++r) {
        const float gj = __shfl_sync(0xffffffffu, ds[r], jj);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[r][dd] += gj * kv[dd];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < BW_ROWS; ++r) {
    const int i = q0 + warp * BW_ROWS + r;
    if (i >= a.Sq) continue;
    T* row = a.dq + b * a.dqs.b + h * a.dqs.h + i * a.dqs.s;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane * DPL + dd;
      if (d < a.hd) row[d] = from_f32<T>(acc[r][dd] * a.scale);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const BwdArgs<T>& a, int B, int KH, cudaStream_t stream) {
  constexpr int BK = BW_WARPS * bw_kpw<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(bwd_stats_kernel<T, HD>, stats_smem<T, HD>());
    if (e == cudaSuccess) e = allow_smem(bwd_dkdv_kernel<T, HD>, dkdv_smem<T, HD>());
    if (e == cudaSuccess) e = allow_smem(bwd_dq_kernel<T, HD>, dq_smem<T, HD>());
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 qgrid((a.Sq + BW_BQ - 1) / BW_BQ, a.H, B);
  bwd_stats_kernel<T, HD><<<qgrid, BW_THREADS, stats_smem<T, HD>(), stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 kgrid((a.Skv + BK - 1) / BK, KH, B);
  bwd_dkdv_kernel<T, HD><<<kgrid, BW_THREADS, dkdv_smem<T, HD>(), stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<T, HD><<<qgrid, BW_THREADS, dq_smem<T, HD>(), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(BwdArgs<T> a, int B, int KH, const void* const* ptrs,
                        const long long* st, cudaStream_t stream) {
  a.q = static_cast<const T*>(ptrs[0]);
  a.k = static_cast<const T*>(ptrs[1]);
  a.v = static_cast<const T*>(ptrs[2]);
  a.o = static_cast<const T*>(ptrs[3]);
  a.dout = static_cast<const T*>(ptrs[4]);
  a.dq = static_cast<T*>(const_cast<void*>(ptrs[5]));
  a.dk = static_cast<T*>(const_cast<void*>(ptrs[6]));
  a.dv = static_cast<T*>(const_cast<void*>(ptrs[7]));
  Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int t = 0; t < 8; ++t) *all[t] = Strides{st[3 * t], st[3 * t + 1], st[3 * t + 2]};
  const int hd = a.hd, elem = (int)sizeof(T);
  // 16-byte loads: q, k, v and dout rows full width, 16-byte aligned at
  // every batch row and head too
  const auto vec_at = [&](int HD) {
    bool ok = true;
    for (int t : {0, 1, 2, 4})
      ok = ok && rows_vectorisable(ptrs[t], st[3 * t + 2], hd, HD, elem) &&
           strides_aligned(st[3 * t], st[3 * t + 1], elem);
    return (int)ok;
  };
  if (hd <= 32) {
    a.vec = vec_at(32);
    return launch<T, 32>(a, B, KH, stream);
  }
  if (hd <= 64) {
    a.vec = vec_at(64);
    return launch<T, 64>(a, B, KH, stream);
  }
  if (hd <= 128) {
    a.vec = vec_at(128);
    return launch<T, 128>(a, B, KH, stream);
  }
  a.vec = vec_at(256);
  return launch<T, 256>(a, B, KH, stream);
}

}  // namespace

// q (B,H,Sq,hd), k/v (B,KH,Skv,hd), o/dout (B,H,Sq,hd) in; dq (B,H,Sq,hd),
// dk/dv (B,KH,Skv,hd) out; lse/delta f32 scratch of B·H·Sq floats.  ``st``
// holds the (batch, head, row) strides of q, k, v, o, dout, dq, dk, dv in
// that order (24 values, any strides with a unit innermost one).  softcap
// <= 0 means no softcap.  Launches three kernels on ``stream``; returns
// cudaGetLastError() after the last (or the first error).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int H, int KH, int Sq, int Skv, int hd, const long long* st,
    int causal, int window, float softcap, float scale, int dtype,
    void* stream) {
  if (hd < 1 || hd > 256 || hd % 4 != 0 || KH < 1 || H % KH != 0 ||
      Sq < 1 || Sq > Skv || B < 1)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_BF16 || dtype == DT_F32) {
    if (dtype == DT_BF16) {
      BwdArgs<__nv_bfloat16> a{};
      a.lse = static_cast<float*>(lse);
      a.delta = static_cast<float*>(delta);
      a.H = H; a.group = H / KH; a.Sq = Sq; a.Skv = Skv; a.hd = hd;
      a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
      e = dispatch_hd<__nv_bfloat16>(a, B, KH, ptrs, st, s);
    } else {
      BwdArgs<float> a{};
      a.lse = static_cast<float*>(lse);
      a.delta = static_cast<float*>(delta);
      a.H = H; a.group = H / KH; a.Sq = Sq; a.Skv = Skv; a.hd = hd;
      a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
      e = dispatch_hd<float>(a, B, KH, ptrs, st, s);
    }
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
