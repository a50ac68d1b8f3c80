// Paged prefix-append attention for chunked prefill, for Hopper (sm_90a),
// f32 math.
//
// Replaces: src/repro/kernels/decode_attention.py::
// paged_prefill_attention_pallas (body _prefill_append_kernel), over fp
// pools and over int8 / fp8 (e4m3) pools with their per-(page, slot, head)
// f32 scales: the scoring op of models/layers.py mode="prefill_append"
// through a block table (ops.paged_prefill_attention), which the chunked
// engine's fused token-budget step runs in every layer.
//
// The function: q holds a q_len-token chunk per batch row whose K/V the
// caller has just written into the page pools; chunk token t of row b sees
// the logical columns < cache_len[b] - (q_len - 1) + t (its committed
// prefix, its chunk siblings before it and itself), with a window floor
// when a window is set.  It is the chunk-causal paged_multi_decode function
// at any q_len.
//
// What bounds it on this card: at the engine's flat shape (q_len 1, a
// batch row per scheduled token, a scene's chunk rows sharing one table row)
// bytes, about 1.4 FLOPs per byte moved from device memory; for one long
// chunk (q_len 256, group 6: 1536 query rows over ~1 K keys) operations.
// This first kernel runs on CUDA cores (no wgmma): right first, fast later.
// It is the route of float32 and of the head dims the tensor-core route
// does not take (the proxies' 12/16, gemma3-1b's 256).
//
// What the design does about it, following the TPU kernel's structure:
//  * One block per (query sub-block, KV head, batch row).  A sub-block is
//    q_blk chunk tokens, q_blk·group <= 64 query rows (4 warps up to 32
//    rows, else 8; at most 8 rows per warp); the last sub-block may be
//    shorter.  Its rows share every K/V tile the block loads, so K/V are
//    read once per KV head and sub-block, never per query head.  q_blk is a
//    tile knob, not part of the function.
//  * Per-sub-block causal bounds, as the TPU kernel's: hi = the sub-block's
//    last row's effective length, lo = its first row's window floor; the
//    block walks only the 64-key tiles that intersect [lo, hi), so an early
//    sub-block of a long chunk never fetches the keys only later tokens see.
//    Chunks of any length work (the verify kernel holds at most 64 rows).
//  * No split-K: each block finishes its rows and writes acc / max(l, 1e-30)
//    straight to o.  The engine's flat shape gives B·KH blocks (528 on the
//    2B at a 264-token budget), enough to fill the card's 132 SMs.
//  * Keys resolve through the block table as they load:
//    pool[tbl[b, s / page], kh, s % page, :], any page size, 16-byte loads
//    where rows and strides allow (common.cuh's TileLoader and KvRows);
//    at hd 256 a 64-key tile moves in four 16-key slices
//    (load_kv_tiles), as in decode_attention.cu (ptxas spills at most 48
//    bytes there, in three of the 4-warp instances).
//    An 8-bit pool (the kernel templated on its element type) reads each
//    key's f32 scale through the same table entry and dequantizes the tile
//    in f32 as it loads, as decode_attention.cu does.
//  * cache_len is clipped to the table's span; keys at or past a row's
//    length are never read; rows with cache_len == 0 (and chunk tokens
//    whose effective length is <= 0) output zeros; optional logit softcap.
#include "common.cuh"

namespace {

constexpr int PP_MAX_ROWS = 8 * ATT_RPW;   // q_blk·group, 8 warps

template <typename T, typename KT, int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
prefill_append_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                      const KT* __restrict__ v, KvScales sc,
                      const int* __restrict__ tbl,
                      const int* __restrict__ cache_len, T* __restrict__ o,
                      int q_len, int q_blk, int group, int S, int page,
                      int hd, int64_t q_sb, int64_t q_sh, int64_t q_sr,
                      int64_t k_sn, int64_t k_sh, int64_t k_sp,
                      int64_t v_sn, int64_t v_sh, int64_t v_sp,
                      int64_t tbl_sb, int64_t o_sb, int64_t o_sh,
                      int64_t o_sr, int window, float softcap, float scale,
                      int vec) {
  constexpr int MAXR = WARPS * ATT_RPW;
  constexpr int DPL = HD / 32;
  extern __shared__ float4 pp_smem4[];
  float* qs = reinterpret_cast<float*>(pp_smem4);   // [rows][HD]
  float* ks = qs + MAXR * HD;                       // [ATT_BK][HD + 4]
  float* vs = ks + ATT_BK * (HD + 4);               // [ATT_BK][HD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int iq = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int t0 = iq * q_blk;                        // first chunk token
  const int nt = min(q_blk, q_len - t0);            // tokens in this block
  const int rows = nt * group;
  const int len = max(min(cache_len[b], S), 0);
  // effective length of the sub-block's first token; its last token's,
  // eff0 + nt - 1 <= len, bounds every column the block can read
  const int eff0 = len - (q_len - 1) + t0;
  const int hi = eff0 + nt - 1;
  const int lo = window > 0 ? max(eff0 - window, 0) : 0;

  const int64_t r0 = (int64_t)t0 * group;           // first query row
  const KvRows<KT, true> krow{k + kh * k_sh, tbl + b * tbl_sb, k_sn, k_sp,
                              page, sc.k + kh * sc.k_sh, sc.k_sn, sc.k_ss};
  const KvRows<KT, true> vrow{v + kh * v_sh, tbl + b * tbl_sb, v_sn, v_sp,
                              page, sc.v + kh * sc.v_sh, sc.v_sn, sc.v_ss};
  load_q_rows<T, HD, WARPS>(qs, q + b * q_sb + kh * q_sh + r0 * q_sr, q_sr,
                            rows, hd, vec);

  RowState<HD> st;
  st.init();
  if (hi > 0)
    attend_tiles<KT, HD, WARPS, true>(st, qs, ks, vs, krow, vrow,
                                     lo / ATT_BK * ATT_BK, hi, lo, rows, 0,
                                     group, eff0, window, softcap, scale, hd,
                                     vec);

  T* ob = o + b * o_sb + kh * o_sh + r0 * o_sr;
#pragma unroll
  for (int i = 0; i < ATT_RPW; ++i) {
    const int r = warp + WARPS * i;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane * DPL + dd;
      if (d < hd) ob[r * o_sr + d] = from_f32<T>(st.acc[i][dd] * inv);
    }
  }
}

// q, k, v, tbl, cache_len, o; st: q (b, h, r), k (page, h, slot),
// v (page, h, slot), o (b, h, r) strides
struct PrefillArgs {
  const void *q, *k, *v;
  KvScales sc;
  const int* tbl;
  const int* cache_len;
  void* o;
  int B, KH, q_len, group, q_blk, S, page, hd;
  long long st[12];
  long long tbl_sb;
  int window;
  float softcap, scale;
  int vec;
};

template <typename T, typename KT, int HD, int WARPS>
cudaError_t launch(const PrefillArgs& a, cudaStream_t stream) {
  constexpr size_t smem = att_smem_bytes<HD, WARPS>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(prefill_append_kernel<T, KT, HD, WARPS>, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long* st = a.st;
  const int n_q = (a.q_len + a.q_blk - 1) / a.q_blk;
  prefill_append_kernel<T, KT, HD, WARPS>
      <<<dim3(n_q, a.KH, a.B), WARPS * 32, smem, stream>>>(
          static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
          static_cast<const KT*>(a.v), a.sc, a.tbl, a.cache_len,
          static_cast<T*>(a.o), a.q_len, a.q_blk, a.group, a.S, a.page,
          a.hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
          st[8], a.tbl_sb, st[9], st[10], st[11], a.window, a.softcap,
          a.scale, a.vec);
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t dispatch_hd(const PrefillArgs& a, cudaStream_t stream) {
  if (a.q_blk * a.group <= 32) {
    if (a.hd <= 32) return launch<T, KT, 32, 4>(a, stream);
    if (a.hd <= 64) return launch<T, KT, 64, 4>(a, stream);
    if (a.hd <= 128) return launch<T, KT, 128, 4>(a, stream);
    return launch<T, KT, 256, 4>(a, stream);
  }
  if (a.hd <= 32) return launch<T, KT, 32, 8>(a, stream);
  if (a.hd <= 64) return launch<T, KT, 64, 8>(a, stream);
  if (a.hd <= 128) return launch<T, KT, 128, 8>(a, stream);
  return launch<T, KT, 256, 8>(a, stream);
}

// the pool's element type: q's (fp pool), or int8 / e4m3 with scales
template <typename T>
cudaError_t dispatch_kv(const PrefillArgs& a, int dtype, int kv,
                        cudaStream_t stream) {
  if (kv == dtype) return dispatch_hd<T, T>(a, stream);
  if (a.sc.k == nullptr || a.sc.v == nullptr) return cudaErrorInvalidValue;
  if (kv == DT_I8) return dispatch_hd<T, int8_t>(a, stream);
  if (kv == DT_F8) return dispatch_hd<T, fp8_t>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, KH, q_len·group, hd) token-major rows (row r ↦ chunk token
// r / group); k_pool/v_pool (n_pages, KH, page, hd) strided views (the
// model's (n_pages, page, KH, hd) pools passed without a copy);
// block_table (B, P) int32 with row stride tbl_sb; cache_len (B,) int32
// INCLUDING the chunk; o (B, KH, q_len·group, hd).  Any strides with a unit
// innermost one.  q_blk·group <= 64.  softcap <= 0 = none.  kv_dtype: the
// pools' element type, dtype's code for an fp pool, DT_I8 / DT_F8 for
// int8 / e4m3 pools, whose f32 scales k_scale / v_scale are
// (n_pages, KH, page) strided views (null for an fp pool).
extern "C" int paged_prefill_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale,
    const int* block_table, const int* cache_len, void* o, int B, int KH,
    int q_len, int group, int q_blk, int P, int page, int hd,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sn, long long k_sh, long long k_sp,
    long long v_sn, long long v_sh, long long v_sp,
    long long ks_sn, long long ks_sh, long long ks_sp,
    long long vs_sn, long long vs_sh, long long vs_sp, long long tbl_sb,
    long long o_sb, long long o_sh, long long o_sr,
    int window, float softcap, float scale, int dtype, int kv_dtype,
    void* stream) {
  if (hd < 1 || hd > 256 || hd % 4 != 0 || B < 1 || KH < 1 || q_len < 1 ||
      group < 1 || q_blk < 1 || q_blk * group > PP_MAX_ROWS || P < 1 ||
      page < 1 || (q_len + q_blk - 1) / q_blk > 65535 || KH > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  PrefillArgs a{q, k_pool, v_pool,
                {k_scale, v_scale, ks_sn, ks_sh, ks_sp, vs_sn, vs_sh, vs_sp},
                block_table, cache_len, o,
                B, KH, q_len, group, q_blk, P * page, page, hd,
                {q_sb, q_sh, q_sr, k_sn, k_sh, k_sp, v_sn, v_sh, v_sp,
                 o_sb, o_sh, o_sr},
                tbl_sb, window, softcap, scale, 0};
  const int hd_pad = hd <= 32 ? 32 : (hd <= 64 ? 64 : (hd <= 128 ? 128 : 256));
  const int elem = dtype == DT_BF16 ? 2 : 4;
  const int kelem = kv_dtype == DT_I8 || kv_dtype == DT_F8 ? 1 : elem;
  // 16-byte tile loads: full-width rows and every stride that reaches a
  // row (batch, head, page) keeping 16-byte alignment
  a.vec = rows_vectorisable(q, q_sr, hd, hd_pad, elem) &&
          strides_aligned(q_sb, q_sh, elem) &&
          rows_vectorisable(k_pool, k_sp, hd, hd_pad, kelem) &&
          strides_aligned(k_sn, k_sh, kelem) &&
          rows_vectorisable(v_pool, v_sp, hd, hd_pad, kelem) &&
          strides_aligned(v_sn, v_sh, kelem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)dispatch_kv<__nv_bfloat16>(a, dtype, kv_dtype, s);
  if (dtype == DT_F32) return (int)dispatch_kv<float>(a, dtype, kv_dtype, s);
  return (int)cudaErrorInvalidValue;
}
