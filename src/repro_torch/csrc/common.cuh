// Shared helpers for the port's CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#define REPRO_NEG_INF (-1e30f)

// dtype codes passed from Python: 0 = float32, 1 = bfloat16; a paged
// kernel's pool takes q's code (fp pool) or 2 = int8, 3 = fp8 e4m3
// (kernels/build.py DTYPES, POOL_DTYPES)
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_F8 = 3 };

typedef __nv_fp8_e4m3 fp8_t;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(fp8_t x) { return static_cast<float>(x); }

// An 8-bit pool element: stored with a per-(page, slot, head) f32 scale,
// and dequantized as to_f32(x) * scale (the JAX oracle's multiply).
template <typename T> struct IsQ8 { static constexpr bool value = false; };
template <> struct IsQ8<int8_t> { static constexpr bool value = true; };
template <> struct IsQ8<fp8_t> { static constexpr bool value = true; };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum / max over a block whose size is a multiple of 32; every thread gets
// the result.  ``red`` is 32 floats of shared memory, free on entry.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = MAX ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  const float ident = MAX ? REPRO_NEG_INF : 0.f;
  float t = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : ident;
  if (warp == 0) t = MAX ? warp_max(t) : warp_sum(t);
  if (threadIdx.x == 0) red[0] = t;
  __syncthreads();
  return red[0];
}

// Logit softcap as the reference applies it: c * tanh(s / c); c <= 0 = off.
__device__ __forceinline__ float apply_softcap(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// A [ROWS][HD] tile of T moved global -> registers -> f32 shared memory in
// 16-byte chunks, every chunk of a thread in flight at once (a tile costs
// about one memory latency, not one per element).  Needs hd == HD, rows
// 16-byte aligned; rows >= nrows read as zero.  fetch() and store() are
// split so a kernel can fetch the next tile while it computes on this one.
// An 8-bit T (16 elements a chunk) also fetches each chunk's row scale and
// stores to_f32(x) * scale.
template <typename T, int ROWS, int HD, int THREADS>
struct TileLoader {
  static constexpr bool SCALED = IsQ8<T>::value;
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements per chunk
  static constexpr int CPR = HD / EPC;              // chunks per row
  static constexpr int N = ROWS * CPR;              // chunks per tile
  static constexpr int PER = (N + THREADS - 1) / THREADS;  // per thread
  uint4 buf[PER];
  float sc[SCALED ? PER : 1];

  // chunk j of this thread exists (a tile of fewer chunks than threads:
  // 8-bit rows at HD 32 on 8 warps)
  __device__ __forceinline__ static bool has(int c) {
    return N % THREADS == 0 || c < N;
  }

  // Rows at ``row(r)`` (a pointer to row r's first element), any addressing:
  // strided for a dense cache, through a block table for a paged one;
  // ``scale(r)`` row r's scale (read for an 8-bit T only).
  template <typename RowFn, typename ScaleFn>
  __device__ __forceinline__ void fetch_rows(const RowFn& row,
                                             const ScaleFn& scale, int nrows) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = threadIdx.x + j * THREADS, r = c / CPR, e = (c % CPR) * EPC;
      const bool in = has(c) && r < nrows;
      buf[j] = in ? __ldg(reinterpret_cast<const uint4*>(row(r) + e))
                  : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (SCALED) sc[j] = in ? scale(r) : 0.f;
    }
  }

  template <typename RowFn>
  __device__ __forceinline__ void fetch_rows(const RowFn& row, int nrows) {
    fetch_rows(row, [](int) { return 1.f; }, nrows);
  }

  __device__ __forceinline__ void fetch(const T* __restrict__ src, int64_t rs,
                                        int nrows) {
    fetch_rows([=](int r) { return src + r * rs; }, nrows);
  }

  __device__ __forceinline__ void store(float* __restrict__ dst, int ss) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = threadIdx.x + j * THREADS, r = c / CPR, e = (c % CPR) * EPC;
      if (!has(c)) continue;
      const T* x = reinterpret_cast<const T*>(&buf[j]);
      float* d = dst + r * ss + e;
#pragma unroll
      for (int i = 0; i < EPC; i += 4) {
        float4 f = make_float4(to_f32(x[i]), to_f32(x[i + 1]), to_f32(x[i + 2]),
                               to_f32(x[i + 3]));
        if constexpr (SCALED) {
          f.x *= sc[j];
          f.y *= sc[j];
          f.z *= sc[j];
          f.w *= sc[j];
        }
        *reinterpret_cast<float4*>(d + i) = f;
      }
    }
  }
};

// Row slices a K/V tile of head dim HD moves in: one below HD 256, four at
// HD 256, so a thread holds no more 16-byte chunks at once than at HD 128
// (the whole tile would take the registers the row state needs: 64 f32
// accumulators a row slot at HD 256).
template <int HD>
__host__ __device__ constexpr int tile_parts() { return HD > 128 ? 4 : 1; }

// A [ROWS][HD] K and V tile pair, global -> f32 shared memory, in
// tile_parts<HD>() row slices, each slice's K and V chunks in flight
// together (at one part: TileLoader's whole tiles, as before HD 256).
// ``krow``/``vrow`` and ``ksc``/``vsc`` address row r and its scale as
// TileLoader::fetch_rows takes them; rows >= nrows read as zero.
template <typename T, int ROWS, int HD, int THREADS, typename KF, typename KS,
          typename VF, typename VS>
__device__ __forceinline__ void load_kv_tiles(float* __restrict__ ks, int kss,
                                              float* __restrict__ vs, int vss,
                                              const KF& krow, const KS& ksc,
                                              const VF& vrow, const VS& vsc,
                                              int nrows) {
  constexpr int PARTS = tile_parts<HD>(), PR = ROWS / PARTS;
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
    const int r0 = p * PR;
    TileLoader<T, PR, HD, THREADS> kl, vl;
    kl.fetch_rows([&](int r) { return krow(r0 + r); },
                  [&](int r) { return ksc(r0 + r); }, nrows - r0);
    vl.fetch_rows([&](int r) { return vrow(r0 + r); },
                  [&](int r) { return vsc(r0 + r); }, nrows - r0);
    kl.store(ks + r0 * kss, kss);
    vl.store(vs + r0 * vss, vss);
  }
}

// The element-wise fallback of TileLoader for head dims below the padded HD
// (the proxies' 12 and 16): dims >= hd and rows >= nrows read as zero; an
// 8-bit T stores to_f32(x) * scale(r).
template <typename T, int ROWS, int HD, int THREADS, typename RowFn,
          typename ScaleFn>
__device__ __forceinline__ void load_rows_scalar(float* __restrict__ dst, int ss,
                                                 const RowFn& row,
                                                 const ScaleFn& scale,
                                                 int nrows, int hd) {
#pragma unroll 8
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (r < nrows && d < hd) {
      x = to_f32(row(r)[d]);
      if constexpr (IsQ8<T>::value) x *= scale(r);
    }
    dst[r * ss + d] = x;
  }
}

template <typename T, int ROWS, int HD, int THREADS, typename RowFn>
__device__ __forceinline__ void load_rows_scalar(float* __restrict__ dst, int ss,
                                                 const RowFn& row, int nrows,
                                                 int hd) {
  load_rows_scalar<T, ROWS, HD, THREADS>(
      dst, ss, row, [](int) { return 1.f; }, nrows, hd);
}

template <typename T, int ROWS, int HD, int THREADS>
__device__ __forceinline__ void load_tile_scalar(float* __restrict__ dst, int ss,
                                                 const T* __restrict__ src,
                                                 int64_t rs, int nrows, int hd) {
  load_rows_scalar<T, ROWS, HD, THREADS>(
      dst, ss, [=](int r) { return src + r * rs; }, nrows, hd);
}

// TileLoader's condition: full-width rows, 16-byte aligned base and stride.
__host__ __forceinline__ bool rows_vectorisable(const void* p, long long rs,
                                                int hd, int HD, int elem) {
  return hd == HD && ((uintptr_t)p % 16) == 0 && (rs * elem) % 16 == 0;
}

// The same for rows reached through further strides (head, page): each of
// them must keep 16-byte alignment too.
__host__ __forceinline__ bool strides_aligned(long long s0, long long s1,
                                              int elem) {
  return (s0 * elem) % 16 == 0 && (s1 * elem) % 16 == 0;
}

// Allow a kernel more than 48 KB of dynamic shared memory (once per kernel).
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Where key s of one (batch row, KV head) lives.  Dense: base + s·ss.
// Paged: base + tbl[s / page]·sn + (s % page)·ss, base already offset to
// the KV head and tbl to the batch row's block-table entries.  An 8-bit
// pool's scale of key s: sbase + tbl[s / page]·ssn + (s % page)·sss, the
// same table entry as its page (sbase offset to the KV head).
template <typename T, bool PAGED>
struct KvRows {
  const T* base;
  const int* tbl;       // this batch row's block-table entries (paged)
  int64_t sn, ss;
  int page;
  const float* sbase;   // 8-bit pools: the scales, else unused
  int64_t ssn, sss;
  __device__ __forceinline__ const T* operator()(int s) const {
    if (!PAGED) return base + s * ss;
    const int blk = s / page;
    return base + (int64_t)__ldg(tbl + blk) * sn + (int64_t)(s - blk * page) * ss;
  }
  __device__ __forceinline__ float scale(int s) const {
    if (!PAGED) return __ldg(sbase + s * sss);
    const int blk = s / page;
    return __ldg(sbase + (int64_t)__ldg(tbl + blk) * ssn +
                 (int64_t)(s - blk * page) * sss);
  }
};

// The scale operands of a paged launch: k's and v's scale pointers and
// their (page, head, slot) strides; null for an fp pool.
struct KvScales {
  const float *k, *v;
  int64_t k_sn, k_sh, k_ss, v_sn, v_sh, v_ss;
};

// ---------------------------------------------------------------------------
// The attention body the decode and prefix-append kernels share: a block of
// WARPS warps holds up to WARPS·ATT_RPW query rows (row r in warp r % WARPS),
// walks 64-key tiles of one (batch row, KV head) and keeps each row's online
// softmax state (m, l, acc) in registers.  The mask is the TPU kernels'
// _kv_block_update one: query row r belongs to chunk token r / group, whose
// effective length is eff0 + r / group; columns < eff (and >= eff - window
// with a window) are valid; p = where(mask, exp(s - m), 0), so a fully
// masked row keeps l = 0 and acc = 0.
// ---------------------------------------------------------------------------

constexpr int ATT_BK = 64;                 // keys per tile: two per lane
constexpr int ATT_RPW = 8;                 // query rows per warp, at most

// shared memory: q rows [WARPS·ATT_RPW][HD], K tile [ATT_BK][HD + 4] (padded
// against bank conflicts in the per-lane key rows), V tile [ATT_BK][HD]
template <int HD, int WARPS>
constexpr size_t att_smem_bytes() {
  return (size_t)(WARPS * ATT_RPW * HD + ATT_BK * (HD + 4) + ATT_BK * HD) * sizeof(float);
}

template <int HD>
struct RowState {
  static constexpr int DPL = HD / 32;      // output dims per lane
  float m[ATT_RPW], l[ATT_RPW], acc[ATT_RPW][DPL];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < ATT_RPW; ++i) {
      m[i] = REPRO_NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
    }
  }
};

// Load ``rows`` query rows (row r at q + r·q_sr) into qs as f32.
template <typename T, int HD, int WARPS>
__device__ __forceinline__ void load_q_rows(float* qs, const T* q, int64_t q_sr,
                                            int rows, int hd, int vec) {
  constexpr int THREADS = WARPS * 32, MAXR = WARPS * ATT_RPW;
  if (vec) {
    TileLoader<T, MAXR, HD, THREADS> ql;
    ql.fetch(q, q_sr, rows);
    ql.store(qs, HD);
  } else {
    load_tile_scalar<T, MAXR, HD, THREADS>(qs, HD, q, q_sr, rows, hd);
  }
}

// Fold keys [k_begin, k_end) into every row's state, tile by tile; tiles
// wholly below ``lo`` (no row's window reaches them) are skipped.  T is the
// cache's element type: f32, bf16, or an 8-bit pool whose keys dequantize
// in f32 as the tile loads (krow.scale / vrow.scale).  k_begin
// is a multiple of ATT_BK or a split start; keys >= k_end are never read.
// The block's row r is row row0 + r of the chunk (a row tile keeps the
// global index in its mask).  Every bound is block-uniform (the loop holds
// __syncthreads).
template <typename T, int HD, int WARPS, bool PAGED>
__device__ __forceinline__ void attend_tiles(
    RowState<HD>& st, const float* __restrict__ qs, float* __restrict__ ks,
    float* __restrict__ vs, const KvRows<T, PAGED>& krow,
    const KvRows<T, PAGED>& vrow, int k_begin, int k_end, int lo, int rows,
    int row0, int group, int eff0, int window, float softcap, float scale,
    int hd, int vec) {
  constexpr int THREADS = WARPS * 32;
  constexpr int KST = HD + 4;
  constexpr int DPL = HD / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int k0 = k_begin; k0 < k_end; k0 += ATT_BK) {
    if (k0 + ATT_BK <= lo) continue;           // block-uniform skip
    const int nk = k_end - k0;
    __syncthreads();
    const auto kat = [&](int r) { return krow(k0 + r); };
    const auto vat = [&](int r) { return vrow(k0 + r); };
    const auto ksc = [&](int r) { return krow.scale(k0 + r); };
    const auto vsc = [&](int r) { return vrow.scale(k0 + r); };
    if (vec) {                                 // K and V both in flight
      load_kv_tiles<T, ATT_BK, HD, THREADS>(ks, KST, vs, HD, kat, ksc, vat,
                                            vsc, nk);
    } else {
      load_rows_scalar<T, ATT_BK, HD, THREADS>(ks, KST, kat, ksc, nk, hd);
      load_rows_scalar<T, ATT_BK, HD, THREADS>(vs, HD, vat, vsc, nk, hd);
    }
    __syncthreads();

    float sa[ATT_RPW], sb[ATT_RPW];
#pragma unroll
    for (int i = 0; i < ATT_RPW; ++i) sa[i] = sb[i] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(ks + lane * KST);
    const float4* kbb = reinterpret_cast<const float4*>(ks + (lane + 32) * KST);
#pragma unroll 2
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 x = ka[d4], y = kbb[d4];
#pragma unroll
      for (int i = 0; i < ATT_RPW; ++i) {
        const int r = warp + WARPS * i;
        if (r < rows) {
          const float4 qq = reinterpret_cast<const float4*>(qs + r * HD)[d4];
          sa[i] += qq.x * x.x + qq.y * x.y + qq.z * x.z + qq.w * x.w;
          sb[i] += qq.x * y.x + qq.y * y.y + qq.z * y.z + qq.w * y.w;
        }
      }
    }

    const int ca = k0 + lane, cb = k0 + lane + 32;
    float pa[ATT_RPW], pb[ATT_RPW];
#pragma unroll
    for (int i = 0; i < ATT_RPW; ++i) {
      pa[i] = pb[i] = 0.f;
      const int r = warp + WARPS * i;
      if (r >= rows) continue;                     // warp-uniform
      const int eff = eff0 + (row0 + r) / group;
      bool oka = ca < eff && ca < k_end, okb = cb < eff && cb < k_end;
      if (window > 0) {
        oka = oka && ca >= eff - window;
        okb = okb && cb >= eff - window;
      }
      const float xa = oka ? apply_softcap(sa[i] * scale, softcap) : REPRO_NEG_INF;
      const float xb = okb ? apply_softcap(sb[i] * scale, softcap) : REPRO_NEG_INF;
      const float m_new = fmaxf(st.m[i], warp_max(fmaxf(xa, xb)));
      pa[i] = oka ? expf(xa - m_new) : 0.f;
      pb[i] = okb ? expf(xb - m_new) : 0.f;
      const float alpha = expf(st.m[i] - m_new);
      st.l[i] = st.l[i] * alpha + warp_sum(pa[i] + pb[i]);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) st.acc[i][dd] *= alpha;
      st.m[i] = m_new;
    }

#pragma unroll 2
    for (int j = 0; j < 32; ++j) {
      float va[DPL], vb2[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        va[dd] = vs[j * HD + lane * DPL + dd];
        vb2[dd] = vs[(j + 32) * HD + lane * DPL + dd];
      }
#pragma unroll
      for (int i = 0; i < ATT_RPW; ++i) {
        const int r = warp + WARPS * i;
        if (r < rows) {
          const float xa = __shfl_sync(0xffffffffu, pa[i], j);
          const float xb = __shfl_sync(0xffffffffu, pb[i], j);
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) st.acc[i][dd] += xa * va[dd] + xb * vb2[dd];
        }
      }
    }
  }
}
