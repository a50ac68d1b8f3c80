// Flash-decoding over a dense KV cache for Hopper (sm_90a), split-K, f32 math.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (dense decode of the batch path, models/layers.py mode="decode", and the
// q_len > 1 token-major chunk of ops.multi_decode_attention).
//
// What bounds it on this card: bytes.  At batch 1 a row group reads its
// cache_len x hd K and V once and does ~4·hd FLOPs per (query row, key), a
// few FLOPs per byte, far below the ~295 FLOPs/byte where the tensor cores
// would become the limit.  The whole read is ~1 MB per layer at the main
// path's shapes, so launch latency and occupancy matter as much as bandwidth.
//
// What the design does about it:
//  * One block per (KV split, KV head, batch row): the group's q_len·group
//    query rows share every K/V tile the block loads (the point of the
//    kernel at batch 1), so K/V are read once per KV head, never per query
//    head.
//  * Q rows and K/V tiles move in 16-byte chunks at hd = 32, 64 or 128,
//    all of a thread's in flight at once (the proxies' hd 12/16 take an
//    element-wise path).
//  * Split-K over the cache gives the card enough blocks at batch 1 (the
//    TPU kernel's sequential KV grid axis becomes independent splits); a
//    second small kernel, one block per (query row, KV head, batch row),
//    combines the splits' (m, l, acc) partials.
//  * Per-row cache_len (a scalar broadcasts in the wrapper): splits and
//    tiles outside [lo, cache_len) are skipped; rows with cache_len == 0
//    output zeros.
//  * The mask is the TPU kernel's _kv_block_update one: query row r belongs
//    to chunk token t = r / group with eff_len = cache_len - (q_len-1) + t,
//    columns < eff_len (and >= eff_len - window with a window) are valid;
//    p = where(mask, exp(s - m), 0), so a fully masked row emits zeros, not
//    mean(V); the final acc / max(l, 1e-30); optional logit softcap.
#include "common.cuh"

namespace {

constexpr int DA_WARPS = 4;
constexpr int DA_BK = 64;                  // keys per tile: two per lane
constexpr int DA_RPW = 8;                  // query rows per warp, at most
constexpr int DA_MAX_ROWS = DA_WARPS * DA_RPW;
constexpr int DA_COMBINE_THREADS = 128;    // >= hd: one thread per output dim

template <int HD>
constexpr size_t da_smem_bytes() {
  return (size_t)(DA_MAX_ROWS * HD + DA_BK * (HD + 4) + DA_BK * HD) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(DA_WARPS * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cache_len,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int KH, int rows, int q_len, int S, int hd, int split_len,
                    int64_t q_sb, int64_t q_sh, int64_t q_sr,
                    int64_t k_sb, int64_t k_sh, int64_t k_ss,
                    int64_t v_sb, int64_t v_sh, int64_t v_ss,
                    int window, float softcap, float scale, int vec) {
  constexpr int THREADS = DA_WARPS * 32;
  constexpr int KST = HD + 4;
  constexpr int DPL = HD / 32;
  extern __shared__ float4 da_smem4[];
  float* qs = reinterpret_cast<float*>(da_smem4);   // [rows][HD]
  float* ks = qs + DA_MAX_ROWS * HD;                // [DA_BK][KST]
  float* vs = ks + DA_BK * KST;                     // [DA_BK][HD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int group = rows / q_len;
  const int len = cache_len[b];

  const T* qb = q + b * q_sb + kh * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  if (vec) {
    TileLoader<T, DA_MAX_ROWS, HD, THREADS> ql;
    ql.fetch(qb, q_sr, rows);
    ql.store(qs, HD);
  } else {
    load_tile_scalar<T, DA_MAX_ROWS, HD, THREADS>(qs, HD, qb, q_sr, rows, hd);
  }

  float m[DA_RPW], l[DA_RPW], acc[DA_RPW][DPL];
#pragma unroll
  for (int i = 0; i < DA_RPW; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  // columns any row of the group can see: [lo, len)
  const int lo = window > 0 ? max(len - window - (q_len - 1), 0) : 0;
  const int s0 = split * split_len;
  const int s1 = min(S, s0 + split_len);

  for (int k0 = s0; k0 < s1; k0 += DA_BK) {
    if (k0 + DA_BK <= lo || k0 >= len) continue;   // block-uniform skip
    __syncthreads();
    if (vec) {                                 // K and V both in flight
      TileLoader<T, DA_BK, HD, THREADS> kl, vl;
      kl.fetch(kb + k0 * k_ss, k_ss, s1 - k0);
      vl.fetch(vb + k0 * v_ss, v_ss, s1 - k0);
      kl.store(ks, KST);
      vl.store(vs, HD);
    } else {
      load_tile_scalar<T, DA_BK, HD, THREADS>(ks, KST, kb + k0 * k_ss, k_ss,
                                              s1 - k0, hd);
      load_tile_scalar<T, DA_BK, HD, THREADS>(vs, HD, vb + k0 * v_ss, v_ss,
                                              s1 - k0, hd);
    }
    __syncthreads();

    float sa[DA_RPW], sb[DA_RPW];
#pragma unroll
    for (int i = 0; i < DA_RPW; ++i) sa[i] = sb[i] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(ks + lane * KST);
    const float4* kbb = reinterpret_cast<const float4*>(ks + (lane + 32) * KST);
#pragma unroll 2
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 x = ka[d4], y = kbb[d4];
#pragma unroll
      for (int i = 0; i < DA_RPW; ++i) {
        const int r = warp + DA_WARPS * i;
        if (r < rows) {
          const float4 qq = reinterpret_cast<const float4*>(qs + r * HD)[d4];
          sa[i] += qq.x * x.x + qq.y * x.y + qq.z * x.z + qq.w * x.w;
          sb[i] += qq.x * y.x + qq.y * y.y + qq.z * y.z + qq.w * y.w;
        }
      }
    }

    const int ca = k0 + lane, cb = k0 + lane + 32;
    float pa[DA_RPW], pb[DA_RPW];
#pragma unroll
    for (int i = 0; i < DA_RPW; ++i) {
      pa[i] = pb[i] = 0.f;
      const int r = warp + DA_WARPS * i;
      if (r >= rows) continue;                     // warp-uniform
      const int eff = len - (q_len - 1) + r / group;
      bool oka = ca < eff && ca < s1, okb = cb < eff && cb < s1;
      if (window > 0) {
        oka = oka && ca >= eff - window;
        okb = okb && cb >= eff - window;
      }
      const float xa = oka ? apply_softcap(sa[i] * scale, softcap) : REPRO_NEG_INF;
      const float xb = okb ? apply_softcap(sb[i] * scale, softcap) : REPRO_NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(xa, xb)));
      pa[i] = oka ? expf(xa - m_new) : 0.f;
      pb[i] = okb ? expf(xb - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(pa[i] + pb[i]);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
      m[i] = m_new;
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
      for (int i = 0; i < DA_RPW; ++i) {
        const int r = warp + DA_WARPS * i;
        if (r < rows) {
          const float xa = __shfl_sync(0xffffffffu, pa[i], j);
          const float xb = __shfl_sync(0xffffffffu, pb[i], j);
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) acc[i][dd] += xa * va[dd] + xb * vb2[dd];
        }
      }
    }
  }

  // partials: [(b·KH + kh)·splits + split]·rows + r
#pragma unroll
  for (int i = 0; i < DA_RPW; ++i) {
    const int r = warp + DA_WARPS * i;
    if (r >= rows) continue;
    const int64_t idx = ((int64_t)(b * KH + kh) * splits + split) * rows + r;
    if (lane == 0) {
      part_ml[idx * 2] = m[i];
      part_ml[idx * 2 + 1] = l[i];
    }
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane * DPL + dd;
      if (d < hd) part_acc[idx * hd + d] = acc[i][dd];
    }
  }
}

// One block per (query row, KV head, batch row): the splits' weights
// exp(m_s - max m) go to shared memory once, then each thread sums its
// output dims over the splits with loads coalesced across dims.
template <typename T>
__global__ void __launch_bounds__(DA_COMBINE_THREADS)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ o,
                      int KH, int rows, int hd, int splits, int64_t o_sb,
                      int64_t o_sh, int64_t o_sr) {
  extern __shared__ float dc_smem[];
  float* w = dc_smem;                        // [splits]
  float* red = dc_smem + splits;             // [32]
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  // partial of split s: [(b·KH + kh)·splits + s]·rows + r
  const int64_t base = (int64_t)(b * KH + kh) * splits * rows + r;
  float mx = REPRO_NEG_INF;
  for (int s = threadIdx.x; s < splits; s += blockDim.x)
    mx = fmaxf(mx, part_ml[(base + (int64_t)s * rows) * 2]);
  mx = block_reduce<true>(mx, red);
  float lsum = 0.f;
  for (int s = threadIdx.x; s < splits; s += blockDim.x) {
    const int64_t idx = base + (int64_t)s * rows;
    const float ws = expf(part_ml[idx * 2] - mx);
    w[s] = ws;
    lsum += part_ml[idx * 2 + 1] * ws;
  }
  const float denom = fmaxf(block_reduce<false>(lsum, red), 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      a += part_acc[(base + (int64_t)s * rows) * hd + d] * w[s];
    o[b * o_sb + kh * o_sh + r * o_sr + d] = from_f32<T>(a / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cache_len, void* o, float* part_acc,
                   float* part_ml, int B, int KH, int rows, int q_len, int S,
                   int hd, const long long* st, int splits, int split_len,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = da_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(decode_split_kernel<T, HD>, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int elem = (int)sizeof(T);
  const int vec = rows_vectorisable(q, st[2], hd, HD, elem) &&
                  rows_vectorisable(k, st[5], hd, HD, elem) &&
                  rows_vectorisable(v, st[8], hd, HD, elem);
  dim3 grid(splits, KH, B);
  decode_split_kernel<T, HD><<<grid, DA_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_len, part_acc, part_ml, KH, rows,
      q_len, S, hd, split_len, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], window, softcap, scale, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t csmem = (size_t)(splits + 32) * sizeof(float);
  e = allow_smem(decode_combine_kernel<T>, csmem);
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T><<<dim3(rows, KH, B), DA_COMBINE_THREADS, csmem,
                             stream>>>(part_acc, part_ml, static_cast<T*>(o),
                                       KH, rows, hd, splits, st[9], st[10],
                                       st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const int* cache_len, void* o, float* part_acc,
                        float* part_ml, int B, int KH, int rows, int q_len,
                        int S, int hd, const long long* st, int splits,
                        int split_len, int window, float softcap, float scale,
                        cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, cache_len, o, part_acc, part_ml, B, KH, rows,
                         q_len, S, hd, st, splits, split_len, window, softcap,
                         scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, cache_len, o, part_acc, part_ml, B, KH, rows,
                         q_len, S, hd, st, splits, split_len, window, softcap,
                         scale, stream);
  return launch<T, 128>(q, k, v, cache_len, o, part_acc, part_ml, B, KH, rows,
                        q_len, S, hd, st, splits, split_len, window, softcap,
                        scale, stream);
}

}  // namespace

// q (B,KH,rows,hd) token-major rows (rows = q_len·group), k/v (B,KH,S,hd),
// cache_len (B,) int32, o (B,KH,rows,hd); any strides with a unit innermost
// one.  part_acc (B·KH·splits·rows·hd) and part_ml (B·KH·splits·rows·2) are
// f32 scratch.  split_len must be a multiple of 64.  softcap <= 0 = none.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* cache_len,
    void* o, float* part_acc, float* part_ml,
    int B, int KH, int rows, int q_len, int S, int hd,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_sr,
    int splits, int split_len, int window, float softcap, float scale,
    int dtype, void* stream) {
  if (hd < 1 || hd > 128 || hd % 4 != 0 || rows < 1 || rows > DA_MAX_ROWS ||
      q_len < 1 || rows % q_len != 0 || split_len % DA_BK != 0 ||
      splits < 1 || (long long)splits * split_len < S)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sh, q_sr, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_sr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_BF16)
    e = dispatch_hd<__nv_bfloat16>(q, k, v, cache_len, o, part_acc, part_ml, B,
                                   KH, rows, q_len, S, hd, st, splits,
                                   split_len, window, softcap, scale, s);
  else if (dtype == DT_F32)
    e = dispatch_hd<float>(q, k, v, cache_len, o, part_acc, part_ml, B, KH,
                           rows, q_len, S, hd, st, splits, split_len, window,
                           softcap, scale, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
