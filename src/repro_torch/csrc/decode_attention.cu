// Flash-decoding over a dense or a paged KV cache for Hopper (sm_90a),
// split-K, f32 math on the CUDA cores: the route
// kernels/decode_attention.py::route gives float32 and the head dims other
// than 64/128 (the proxies' 12/16, gemma3-1b's 256); bf16 at hd 64/128
// takes the tensor-core kernel in decode_attention_mma.cu.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (dense decode of the batch path, models/layers.py mode="decode", and the
// q_len > 1 token-major chunk of ops.multi_decode_attention), and
// src/repro/kernels/decode_attention.py::paged_decode_attention_pallas (the
// slot path's paged decode at q_len 1 and the speculative verifier at
// q_len = gamma + 1, ops.paged_multi_decode_attention), over fp pools and
// over int8 / fp8 (e4m3) pools with their per-(page, slot, head) f32
// scales (the k_scale / v_scale operands of the TPU kernel).
//
// What bounds it on this card: bytes.  A row group reads its cache_len x hd
// K and V once and does ~4·hd FLOPs per (query row, key), a few FLOPs per
// byte, far below the ~295 FLOPs/byte where the tensor cores would become
// the limit.  The read is ~1 MB per layer and row at the main path's
// shapes, so launch latency and occupancy matter as much as bandwidth.
//
// What the design does about it:
//  * One block per (KV split, KV head and row tile, batch row): the row
//    tile's query rows share every K/V tile the block loads, so K/V are
//    read once per KV head and row tile, never per query head.  A row tile
//    holds up to 32 rows on 4 warps (dense) or up to 64 on 8 (paged: the
//    verifier's (gamma+1)·7 = 35 rows on the 7B at gamma 4); a warp holds
//    at most 8 rows.  Longer chunks (any q_len·group) take more row tiles
//    on the grid's y axis (kernels/decode_attention.py::row_tile
//    sizes them in whole chunk tokens); a tile's rows keep their global
//    index in the mask.
//  * Q rows and K/V tiles move in 16-byte chunks at hd = 32, 64, 128 or
//    256, all of a thread's in flight at once; at hd 256 a 64-key tile
//    moves in four 16-key slices (common.cuh's load_kv_tiles), so the
//    loads hold no more registers than at hd 128 beside a row state twice
//    as large (the proxies' hd 12/16 take an element-wise path).  Shared
//    memory at hd 256: 164,864 bytes a block on 4 warps, 197,632 on 8
//    (under the 227 KB opt-in), so one block an SM.  ptxas spills at most
//    128 bytes at hd 256 (the dense f32 4-warp instance; 40 in the 4-warp
//    8-bit ones, none on 8 warps), no more than the hd-128 instances'
//    160: the slices were the cut, the rows per warp stay 8.
//  * Split-K over the cache gives the card enough blocks at small batch (the
//    TPU kernel's sequential KV grid axis becomes independent splits); a
//    second small kernel, one block per (query row, KV head, batch row),
//    combines the splits' (m, l, acc) partials.  Splits past a row's length
//    leave (m = -inf, l = 0, acc = 0), which the combine weighs as zero.
//  * Paged: key s of row b lives at pool[tbl[b, s / page], s % page, kh, :]
//    (any page size, including pages smaller than the 64-key tile); each
//    token's hd vector is contiguous, so the 16-byte loads stay.  The block
//    reads its own table entries (no scalar prefetch on this card).  The
//    split plan comes from the table width, never from the lengths.
//  * 8-bit pools (the kernel templated on the pool's element type): a
//    16-byte load carries 16 keys' dims, and each key's f32 scale is read
//    through the same table entry as its page; the tile is dequantized in
//    f32 (to_f32(x) * scale, the JAX dequant route's multiply) on its way
//    to shared memory, so the attention body is the fp pool's.  It moves
//    half the bytes of a bf16 pool, plus 4 bytes a key and head.
//  * Per-row cache_len (a scalar broadcasts in the wrapper), clipped to the
//    cache: keys at or past cache_len are never read (their tile rows load
//    as zeros), and tiles outside [lo, cache_len) are skipped; rows with
//    cache_len == 0 output zeros.
//  * The mask is the TPU kernel's _kv_block_update one: query row r belongs
//    to chunk token t = r / group with eff_len = cache_len - (q_len-1) + t,
//    columns < eff_len (and >= eff_len - window with a window) are valid;
//    p = where(mask, exp(s - m), 0), so a fully masked row emits zeros, not
//    mean(V); the final acc / max(l, 1e-30); optional logit softcap.
#include "common.cuh"

namespace {

constexpr int DA_MAX_ROWS = 8 * ATT_RPW;   // 8 warps
// the combine's threads: one per output dim up to hd 128, two dims a
// thread at hd 256 (its loop strides over the head dim)
constexpr int DA_COMBINE_THREADS = 128;

template <typename T, typename KT, int HD, int WARPS, bool PAGED>
__global__ void __launch_bounds__(WARPS * 32)
decode_split_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, KvScales sc,
                    const int* __restrict__ tbl,
                    const int* __restrict__ cache_len,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int KH, int rows, int tile_rows, int q_len, int S,
                    int hd, int split_len,
                    int64_t q_sb, int64_t q_sh, int64_t q_sr,
                    int64_t k_s0, int64_t k_sh, int64_t k_ss,
                    int64_t v_s0, int64_t v_sh, int64_t v_ss,
                    int64_t tbl_sb, int page,
                    int window, float softcap, float scale, int vec) {
  constexpr int MAXR = WARPS * ATT_RPW;
  constexpr int DPL = HD / 32;
  extern __shared__ float4 da_smem4[];
  float* qs = reinterpret_cast<float*>(da_smem4);   // [rows][HD]
  float* ks = qs + MAXR * HD;                       // [ATT_BK][HD + 4]
  float* vs = ks + ATT_BK * (HD + 4);               // [ATT_BK][HD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y % KH, r0 = blockIdx.y / KH * tile_rows;
  const int nrows = min(tile_rows, rows - r0);      // this row tile's rows
  const int splits = gridDim.x;
  const int group = rows / q_len;
  const int len = min(cache_len[b], S);

  // dense: k_s0 is the batch stride; paged: the page stride
  const KvRows<KT, PAGED> krow{k + (PAGED ? 0 : b * k_s0) + kh * k_sh,
                               tbl + b * tbl_sb, k_s0, k_ss, page,
                               sc.k + kh * sc.k_sh, sc.k_sn, sc.k_ss};
  const KvRows<KT, PAGED> vrow{v + (PAGED ? 0 : b * v_s0) + kh * v_sh,
                               tbl + b * tbl_sb, v_s0, v_ss, page,
                               sc.v + kh * sc.v_sh, sc.v_sn, sc.v_ss};
  load_q_rows<T, HD, WARPS>(qs, q + b * q_sb + kh * q_sh + r0 * q_sr, q_sr,
                            nrows, hd, vec);

  RowState<HD> st;
  st.init();
  // columns any row of the group can see: [lo, len); this split's share
  // ends at s1 (never a key >= len)
  const int lo = window > 0 ? max(len - window - (q_len - 1), 0) : 0;
  const int s0 = split * split_len;
  const int s1 = min(len, s0 + split_len);
  attend_tiles<KT, HD, WARPS, PAGED>(st, qs, ks, vs, krow, vrow, s0, s1, lo,
                                    nrows, r0, group, len - (q_len - 1),
                                    window, softcap, scale, hd, vec);

  // partials: [(b·KH + kh)·splits + split]·rows + r, r the global row
#pragma unroll
  for (int i = 0; i < ATT_RPW; ++i) {
    const int lr = warp + WARPS * i;
    if (lr >= nrows) continue;
    const int r = r0 + lr;
    const int64_t idx = ((int64_t)(b * KH + kh) * splits + split) * rows + r;
    if (lane == 0) {
      part_ml[idx * 2] = st.m[i];
      part_ml[idx * 2 + 1] = st.l[i];
    }
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane * DPL + dd;
      if (d < hd) part_acc[idx * hd + d] = st.acc[i][dd];
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

// The launch arguments both entry points share.  st: q (b, h, r), k (0, h,
// s), v (0, h, s), o (b, h, r) strides, where k/v's "0" stride is the batch
// stride (dense) or the page stride (paged) and "s" steps one key (dense)
// or one slot within a page (paged).
struct DecodeArgs {
  const void *q, *k, *v;
  KvScales sc;
  const int* tbl;
  const int* cache_len;
  void* o;
  float *part_acc, *part_ml;
  int B, KH, rows, tile_rows, q_len, S, hd;
  long long st[12];
  long long tbl_sb;
  int page, splits, split_len, window;
  float softcap, scale;
  int vec;
};

template <typename T, typename KT, int HD, int WARPS, bool PAGED>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  constexpr size_t smem = att_smem_bytes<HD, WARPS>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e =
        allow_smem(decode_split_kernel<T, KT, HD, WARPS, PAGED>, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long* st = a.st;
  const int row_tiles = (a.rows + a.tile_rows - 1) / a.tile_rows;
  decode_split_kernel<T, KT, HD, WARPS, PAGED>
      <<<dim3(a.splits, a.KH * row_tiles, a.B), WARPS * 32, smem, stream>>>(
          static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
          static_cast<const KT*>(a.v), a.sc, a.tbl, a.cache_len, a.part_acc,
          a.part_ml, a.KH, a.rows, a.tile_rows, a.q_len, a.S, a.hd,
          a.split_len, st[0],
          st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], a.tbl_sb,
          a.page, a.window, a.softcap, a.scale, a.vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t csmem = (size_t)(a.splits + 32) * sizeof(float);
  e = allow_smem(decode_combine_kernel<T>, csmem);
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T><<<dim3(a.rows, a.KH, a.B), DA_COMBINE_THREADS,
                             csmem, stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.o), a.KH, a.rows, a.hd,
      a.splits, st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T, typename KT, bool PAGED>
cudaError_t dispatch_hd(const DecodeArgs& a, cudaStream_t stream) {
  if (a.tile_rows <= 32) {
    if (a.hd <= 32) return launch<T, KT, 32, 4, PAGED>(a, stream);
    if (a.hd <= 64) return launch<T, KT, 64, 4, PAGED>(a, stream);
    if (a.hd <= 128) return launch<T, KT, 128, 4, PAGED>(a, stream);
    return launch<T, KT, 256, 4, PAGED>(a, stream);
  }
  if (!PAGED) return cudaErrorInvalidValue;   // dense row tiles: <= 32
  if (a.hd <= 32) return launch<T, KT, 32, 8, PAGED>(a, stream);
  if (a.hd <= 64) return launch<T, KT, 64, 8, PAGED>(a, stream);
  if (a.hd <= 128) return launch<T, KT, 128, 8, PAGED>(a, stream);
  return launch<T, KT, 256, 8, PAGED>(a, stream);
}

// the pool's element type: q's (fp pool), or int8 / e4m3 with scales
// (paged only)
template <typename T, bool PAGED>
cudaError_t dispatch_kv(const DecodeArgs& a, int dtype, int kv,
                        cudaStream_t stream) {
  if (kv == dtype) return dispatch_hd<T, T, PAGED>(a, stream);
  if constexpr (PAGED) {
    if (a.sc.k == nullptr || a.sc.v == nullptr) return cudaErrorInvalidValue;
    if (kv == DT_I8) return dispatch_hd<T, int8_t, true>(a, stream);
    if (kv == DT_F8) return dispatch_hd<T, fp8_t, true>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <bool PAGED>
int run(DecodeArgs& a, int dtype, int kv, void* stream) {
  const int max_rows = PAGED ? DA_MAX_ROWS : 32;
  if (a.hd < 1 || a.hd > 256 || a.hd % 4 != 0 || a.rows < 1 ||
      a.tile_rows < 1 || a.tile_rows > max_rows || a.q_len < 1 ||
      a.rows % a.q_len != 0 || a.KH < 1 ||
      (long long)a.KH * ((a.rows + a.tile_rows - 1) / a.tile_rows) > 65535 ||
      a.split_len % ATT_BK != 0 || a.splits < 1 ||
      (long long)a.splits * a.split_len < a.S || (PAGED && a.page < 1))
    return (int)cudaErrorInvalidValue;
  const int hd_pad =
      a.hd <= 32 ? 32 : (a.hd <= 64 ? 64 : (a.hd <= 128 ? 128 : 256));
  const int elem = dtype == DT_BF16 ? 2 : 4;
  const int kelem = kv == DT_I8 || kv == DT_F8 ? 1 : elem;
  // 16-byte tile loads: full-width rows and every stride that reaches a
  // row (head, page or batch) keeping 16-byte alignment
  a.vec = rows_vectorisable(a.q, a.st[2], a.hd, hd_pad, elem) &&
          strides_aligned(a.st[0], a.st[1], elem) &&
          rows_vectorisable(a.k, a.st[5], a.hd, hd_pad, kelem) &&
          strides_aligned(a.st[3], a.st[4], kelem) &&
          rows_vectorisable(a.v, a.st[8], a.hd, hd_pad, kelem) &&
          strides_aligned(a.st[6], a.st[7], kelem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)dispatch_kv<__nv_bfloat16, PAGED>(a, dtype, kv, s);
  if (dtype == DT_F32) return (int)dispatch_kv<float, PAGED>(a, dtype, kv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,KH,rows,hd) token-major rows (rows = q_len·group, any count, in
// row tiles of tile_rows <= 32), k/v (B,KH,S,hd), cache_len (B,) int32, o
// (B,KH,rows,hd); any strides with a unit innermost one.  part_acc
// (B·KH·splits·rows·hd) and part_ml (B·KH·splits·rows·2) are f32 scratch.
// split_len must be a multiple of 64.  softcap <= 0 = none.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* cache_len,
    void* o, float* part_acc, float* part_ml,
    int B, int KH, int rows, int tile_rows, int q_len, int S, int hd,
    long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_sr,
    int splits, int split_len, int window, float softcap, float scale,
    int dtype, void* stream) {
  DecodeArgs a{q, k, v, {nullptr, nullptr, 0, 0, 0, 0, 0, 0}, nullptr,
               cache_len, o, part_acc, part_ml,
               B, KH, rows, tile_rows, q_len, S, hd,
               {q_sb, q_sh, q_sr, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                o_sb, o_sh, o_sr},
               0, 1, splits, split_len, window, softcap, scale, 0};
  return run<false>(a, dtype, dtype, stream);
}

// The paged form: k_pool/v_pool (n_pages, KH, page, hd) strided views (the
// model's (n_pages, page, KH, hd) pools passed without a copy), block_table
// (B, P) int32 with row stride tbl_sb, S = P·page.  Row tiles of
// tile_rows <= 64.  kv_dtype: the pools' element type, dtype's code for an
// fp pool, DT_I8 / DT_F8 for int8 / e4m3 pools, whose f32 scales k_scale /
// v_scale are (n_pages, KH, page) strided views (strides ks_*/vs_*; null
// for an fp pool).  The rest as decode_attention_fwd.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale,
    const int* block_table, const int* cache_len, void* o, float* part_acc,
    float* part_ml, int B, int KH, int rows, int tile_rows, int q_len, int P,
    int page,
    int hd, long long q_sb, long long q_sh, long long q_sr,
    long long k_sn, long long k_sh, long long k_sp,
    long long v_sn, long long v_sh, long long v_sp,
    long long ks_sn, long long ks_sh, long long ks_sp,
    long long vs_sn, long long vs_sh, long long vs_sp, long long tbl_sb,
    long long o_sb, long long o_sh, long long o_sr,
    int splits, int split_len, int window, float softcap, float scale,
    int dtype, int kv_dtype, void* stream) {
  DecodeArgs a{q, k_pool, v_pool,
               {k_scale, v_scale, ks_sn, ks_sh, ks_sp, vs_sn, vs_sh, vs_sp},
               block_table, cache_len, o, part_acc,
               part_ml, B, KH, rows, tile_rows, q_len, P * page, hd,
               {q_sb, q_sh, q_sr, k_sn, k_sh, k_sp, v_sn, v_sh, v_sp,
                o_sb, o_sh, o_sr},
               tbl_sb, page, splits, split_len, window, softcap, scale, 0};
  return run<true>(a, dtype, kv_dtype, stream);
}
