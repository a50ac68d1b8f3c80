// Flash-decoding over a dense or a paged KV cache, and paged prefix-append
// attention (chunked prefill), on Hopper's tensor cores (sm_90a): one
// launch per call, K/V through a cp.async ring, QK^T and PV on mma.sync.
// bfloat16 in and out, float32 accumulation; head dims 64, 128 and 256
// (gemma3-1b's) in all three modes.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (dense decode of the batch path and the drafter, and the q_len > 1 chunk
// of ops.multi_decode_attention), ::paged_decode_attention_pallas (the
// slot path's paged decode at q_len 1 and the speculative verifier at
// q_len = gamma + 1) and ::paged_prefill_attention_pallas (the chunked
// engine's fused step, through paged_prefill_attention_mma_fwd), the two
// paged ones over bf16 pools and over int8 / fp8 (e4m3) pools with their
// per-(page, slot, head) f32 scales (the TPU kernels' k_scale / v_scale
// operands), on the routes each wrapper's ``route`` gives bf16: hd
// 64/128/256.  float32 and the other head dims stay on decode_attention.cu
// and paged_prefill_attention.cu.
//
// What bounds it on this card: bytes for decode.  A (batch row, KV head)
// reads its cache_len x hd K and V once, ~1 MB per layer at the main path's
// lengths, and does 4·hd FLOPs per (query row, key): a few FLOPs per byte.
// At B 1 the whole call moves ~1-4 MB, a microsecond of bandwidth, so what
// it costs is latency: launches, dependent round trips to memory, and the
// merge of the key splits.  A prefix-append chunk (256 tokens x group 6
// over ~1 K keys) does ~1.4 GFLOP on ~1 MB of distinct K/V: operations,
// which is why its tiles run on the tensor cores too.
//
// What the design does about it:
//  * One launch.  The key splits of one (batch row, KV head, row tile) are
//    the blocks of one thread-block cluster (grid x = splits = cluster
//    size, at most 16).  Each block folds its keys into (m, l, acc) and
//    leaves them in its shared memory; after a cluster barrier the blocks
//    read each other's partials through distributed shared memory and each
//    merges and writes a share of the output.  No f32 partials in device
//    memory, no second kernel, no scratch: the wrapper allocates only o.
//  * Loads overlap compute.  K/V tiles of 64 keys stay bf16 and go straight
//    to shared memory in 16-byte cp.async.cg copies (no registers) into a
//    ring of three stages; the next two tiles are in flight while one is
//    computed.  A split holds several tiles; a launch takes the most
//    splits whose clusters all fit on the card at once
//    (kernels/decode_attention.py::cluster_plan, on the card's occupancy
//    from decode_attention_mma_max_clusters), so no cluster waits for a
//    second wave.  Keys at or past the
//    split's end (never past cache_len) are zero-filled through cp.async's
//    src-size operand, so no address is formed from a block-table entry
//    past a row's length and the NaN trash page is never read.
//  * Paged pools through the block table at any page size: every 16-byte
//    copy computes its key's page (a block reads its own table entries);
//    pages smaller than the tile are fine, as TMA's boxes would not be.
//    A thread reads its rows' table entries together before their copies
//    (read one per copy, each after the previous copy, they cost a round
//    trip to memory per 16 bytes).
//  * Tensor cores.  The row tile's query rows (token-major, q_len·group)
//    are packed into 16-row fragments held in registers as mma A operands,
//    loaded once (at hd 256 staged once in shared memory and read by
//    ldmatrix at each k-step: see Resources); rows past the tile are zero
//    and never stored.  S = QK^T
//    runs as mma.sync.m16n8k16 (bf16, f32 accumulate) with K fragments
//    from ldmatrix; PV with p re-packed from the S accumulators into bf16
//    A fragments (as FlashAttention-2) and V fragments from ldmatrix.trans.
//    Shared memory rows are XOR-swizzled by 16-byte chunk, so ldmatrix
//    reads no bank twice.  One fragment (the decode step's 6-7 rows): the
//    four warps each take 16 keys of every tile; two fragments: two warps
//    each, 32 keys; three or four (35 or 63 verify rows): a warp each, all
//    64 keys.  Every fragment reads the same K/V tile in shared memory, so
//    K/V leave device memory once per (b, kh, row tile).  The warps'
//    partials merge in shared memory before the cluster merge.
//  * The mask is the TPU kernel's _kv_block_update one: query row r (its
//    global index in the chunk) belongs to chunk token t = r / group, with
//    eff = cache_len - (q_len - 1) + t; columns < eff (and >= eff - window
//    with a window) are valid; softcap before the mask; p = where(mask,
//    exp(s - m), 0), so fully masked rows and cache_len == 0 emit zeros;
//    the final acc / max(l, 1e-30); per-row cache_len clipped to the cache.
//    Softmax runs in base 2 (s·log2 e, ex2.approx, p below 2^-126 flushed
//    to zero).  A warp whose rows all see every key of its share of a tile
//    skips the mask for that tile.
//  * Prefix-append (MODE MD_PREFILL) keeps all of the above and adds:
//    - per-row-tile causal bounds, as the TPU kernel's per-sub-block
//      skipping: a tile walks only keys [lo, hi), hi its rows' largest
//      effective length, lo their smallest window floor, and its key
//      splits share that range in whole tiles, so no block of an early
//      row tile fetches the keys only later tokens see;
//    - an optional tile plan for the engine's flat shape (q_len 1, one
//      batch row per scheduled token, a chunk's tokens as consecutive
//      rows on copies of one table row): entry i names a first batch row
//      and a token count, and its rows (each with its own cache_len) share
//      one row tile and the first row's table row, so a scene's prefix
//      leaves memory once per (run, KV head, row tile) instead of once per
//      token.  The grid spans the plan's fixed length; empty entries exit,
//      and rows in no entry (the engine's padding rows) are not written.
//
//  * 8-bit pools (KT int8_t or fp8_t; paged modes only): the ring holds
//    the stored bytes (a 16-byte cp.async carries 16 keys' dims) and each
//    key's K and V scale (4-byte cp.async.ca, through the table entry of
//    its page); after its copies land, each thread converts its own chunks
//    to bf16 into one shared K/V tile in the swizzled layout the ldmatrix
//    steps read, exactly (every int8 in [-127, 127] and every e4m3 value
//    is a bf16 value), so the mma steps are the bf16 pool's.  The scales
//    commute out of the products, JAX's native_dot algebra used for both
//    types: dot(q, k·s) = dot(q, k)·s scales S's columns by k_scale in f32
//    after QK^T, and dot(p, v·s) = dot(p·s^T, v) scales p's columns by
//    v_scale before the bf16 pack (l sums the unscaled p).  A tile moves
//    hd + 4 bytes a key and head for K and for V, against 2·hd in bf16.
//
// What it rounds: p (for 8-bit pools p·v_scale) to bf16 before PV, so it
// is held to |got - want| <= 1e-5 + 2^-6·|want| + 2^-8·A with A =
// attention(q, k, |v|) (flash's tensor-core bound; k, v dequantized for an
// 8-bit pool), not to two bf16 ulps of the f32 plain version.
//
// Resources at hd 128: 96 KB of ring (3 x 32 KB) plus 1 KB of (m, l), two
// blocks an SM; the partials reuse the ring after the last tile.  At hd 64
// half of that, four blocks an SM.  An 8-bit pool: a 49.5 KB ring (3 x
// (16 KB + 512 B of scales)) and a 32 KB converted tile at hd 128.
// At hd 256 registers bind, not shared memory: a thread's f32 output
// accumulator is 128 registers and its Q fragments would be 64 more, with
// S (up to 32) past the 255 a thread may hold.  So Q is staged once per
// block (64 rows x 512 B = 32 KB, the K tiles' swizzled layout) and each
// k-step reads its A operand by ldmatrix.  The bf16 layout is 3 x 64 KB
// of ring + 32 KB of Q + 1 KB of (m, l) = 230,400 of the 232,448 bytes a
// block may use (the 67.6 KB of partials reuse the ring): one block an
// SM, which cluster_plan reads from the card's occupancy.  An 8-bit pool:
// 3 x 32.5 KB of ring + a 64 KB converted tile + Q, ~195 KB.  The layout
// is the mode's no more than the pool's: paged decode (gemma3-1b's slot
// step at q_len 1, its verifier at q_len γ+1: 20 rows at γ 4, 40 at γ 9)
// takes the same hd-256 body, staging and table reads as prefix-append.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MD_BK = 64;          // keys per K/V tile
constexpr int MD_WARPS = 4;
constexpr int MD_THREADS = 32 * MD_WARPS;
constexpr int MD_STAGES = 3;
constexpr int MD_MAX_ROWS = 16 * MD_WARPS;   // four 16-row fragments
constexpr int MD_MAX_CLUSTER = 16;
constexpr float MD_LOG2E = 1.4426950408889634f;
constexpr float MD_MASKED = REPRO_NEG_INF;   // a masked logit (base 2)

// what a launch scores: dense decode, paged decode, paged prefix-append
enum { MD_DENSE = 0, MD_PAGED = 1, MD_PREFILL = 2 };

// the most dynamic shared memory one block may use on this card
constexpr int MD_SMEM_MAX = 232448;

// Q8: an 8-bit pool, whose stage holds the stored K, V tiles and their
// scales, converted to one bf16 K/V tile at CVT_OFF.  QS (hd 256): the
// row tile's Q is staged once at Q_OFF, in the K tiles' swizzled layout,
// and read by ldmatrix at every k-step, instead of living in registers.
template <int HD, bool Q8 = false>
struct MdLayout {
  static constexpr int CHUNKS = HD / 8;               // 16 B bf16 chunks
  static constexpr int TILE_BYTES = MD_BK * HD * 2;   // one bf16 K or V tile
  static constexpr int RAW_BYTES = Q8 ? MD_BK * HD : TILE_BYTES;  // stored
  static constexpr int SCALE_OFF = 2 * RAW_BYTES;     // Q8: [K, V][64] f32
  static constexpr int STAGE_BYTES = 2 * RAW_BYTES + (Q8 ? 2 * MD_BK * 4 : 0);
  static constexpr int RING_BYTES = MD_STAGES * STAGE_BYTES;
  static constexpr int CVT_OFF = RING_BYTES;          // Q8: K then V, bf16
  static constexpr int CVT_BYTES = Q8 ? 2 * TILE_BYTES : 0;
  static constexpr int PST = HD + 8;                  // f32 partial row
  static constexpr int PART_BYTES = MD_WARPS * 16 * PST * 4;
  static_assert(PART_BYTES <= RING_BYTES + CVT_BYTES,
                "partials reuse the ring");
  static constexpr bool QS = HD > 128;
  static constexpr int Q_OFF = RING_BYTES + CVT_BYTES;  // QS: [64][HD] bf16
  static constexpr int Q_BYTES = QS ? MD_MAX_ROWS * HD * 2 : 0;
  static constexpr int WML_OFF = Q_OFF + Q_BYTES;     // [warp][16][2]
  static constexpr int ML_OFF = WML_OFF + MD_WARPS * 16 * 2 * 4;  // [64][2]
  static constexpr int BYTES = ML_OFF + MD_MAX_ROWS * 2 * 4;
  static_assert(BYTES <= MD_SMEM_MAX, "one block's shared memory");
};

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes 16 zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared (an 8-bit pool's scale); src_bytes 0 writes a
// zero and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 16 stored 8-bit elements -> 16 bf16 (two 16-byte chunks), exactly
template <typename KT>
__device__ __forceinline__ void cvt16_bf16(const uint4& raw, uint4& lo,
                                           uint4& hi) {
  const KT* x = reinterpret_cast<const KT*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack_bf16(to_f32(x[2 * i]), to_f32(x[2 * i + 1]));
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// 2^x, flushing results below 2^-126 to zero (the softmax's p)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte chunk ``ch`` of tile row ``row`` (HD bf16 a row),
// XOR-swizzled so the 8 rows an ldmatrix phase reads hit 8 bank groups.
template <int HD>
__device__ __forceinline__ uint32_t tile_off(int row, int ch) {
  return row * (HD * 2) + ((ch ^ (row & 7)) << 4);
}

// KS key slices per tile: warp w takes 16-row fragment w / KS and keys
// [(w % KS)·64/KS, +64/KS) of every tile.  KT: the cache's element type,
// bf16, or int8_t / fp8_t for an 8-bit pool (paged modes) with scales sc.
template <int HD, int KS, int MODE, typename KT>
__global__ void __launch_bounds__(MD_THREADS)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const KT* __restrict__ k,
                  const KT* __restrict__ v, KvScales sc,
                  const int* __restrict__ tbl,
                  const int* __restrict__ cache_len,
                  const int* __restrict__ plan,
                  __nv_bfloat16* __restrict__ o, int B, int KH, int rows,
                  int tile_rows, int q_len, int S, int split_len,
                  int64_t q_sb, int64_t q_sh, int64_t q_sr, int64_t k_s0,
                  int64_t k_sh, int64_t k_ss, int64_t v_s0, int64_t v_sh,
                  int64_t v_ss, int64_t tbl_sb, int64_t plan_st, int page,
                  int64_t o_sb, int64_t o_sh, int64_t o_sr, int window,
                  float softcap, float scale) {
  constexpr bool Q8 = IsQ8<KT>::value;
  using L = MdLayout<HD, Q8>;
  constexpr bool PAGED = MODE != MD_DENSE;
  static_assert(!Q8 || PAGED, "8-bit caches are paged");
  constexpr int SW = MD_BK / KS;     // keys per warp per tile
  constexpr int NB = SW / 8;         // S n-blocks of 8 keys
  constexpr int KD = HD / 16;        // k-steps over hd (QK^T)
  constexpr int ND = HD / 8;         // n-blocks of 8 dims (PV)
  extern __shared__ __align__(128) unsigned char md_smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x;
  const int kh = blockIdx.y % KH, tile = blockIdx.y / KH;
  const int group = rows / q_len;
  // The row tile: rows [r0, r0 + nrows) of batch row b; with a plan (q_len
  // 1) the group rows of each of nt consecutive batch rows from b on, which
  // share b's table row.  An empty plan entry: the whole cluster leaves.
  const bool planned = MODE == MD_PREFILL && plan != nullptr;
  int b, r0, nrows;
  if (planned) {
    b = plan[tile];
    const int nt = plan[plan_st + tile];
    r0 = 0;
    nrows = nt * group;
    if (nt < 1 || b < 0 || b > B - nt || nrows > tile_rows) return;
  } else {
    b = blockIdx.z;
    r0 = tile * tile_rows;
    nrows = min(tile_rows, rows - r0);
  }
  const int nfrag = (nrows + 15) / 16;
  const int len = min(cache_len[b], S);
  const int frag = warp / KS, slice = warp % KS;
  const bool active = frag < nfrag;                 // warp-uniform

  // row r of the tile: its batch row, its row there, and the keys it sees
  // (a planned row its own cache_len, q_len being 1)
  auto batch_of = [&](int r) { return planned ? b + r / group : b; };
  auto row_of = [&](int r) { return planned ? r % group : r0 + r; };
  auto eff_of = [&](int r) {
    if (planned) return min(cache_len[b + r / group], S);
    return len - (q_len - 1) + (r0 + r) / group;
  };

  // this thread's two rows of its fragment (local to the row tile)
  const int ra = frag * 16 + (lane >> 2), rb = ra + 8;
  const bool oka = active && ra < nrows, okb = active && rb < nrows;
  const int effa = oka ? eff_of(ra) : 0, effb = okb ? eff_of(rb) : 0;

  // the smallest and largest effective length of the warp's rows: a key
  // tile that every one of them sees whole needs no mask
  int wmin = oka ? effa : 0x7fffffff, wmax = oka ? effa : 0;
  if (okb) {
    wmin = min(wmin, effb);
    wmax = max(wmax, effb);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, off));
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
  }
  const float sl2e = scale * MD_LOG2E;

  // Q A fragments, loaded once; rows past the tile are zero.  At hd 256
  // (L::QS) Q is staged in shared memory below instead: these 64
  // registers a thread, with acc's 128, would not fit.
  uint32_t qf[L::QS ? 1 : KD][4];
  if constexpr (!L::QS) {
    const __nv_bfloat16* qa =
        oka ? q + (int64_t)batch_of(ra) * q_sb + kh * q_sh +
                  (int64_t)row_of(ra) * q_sr
            : q;
    const __nv_bfloat16* qb =
        okb ? q + (int64_t)batch_of(rb) * q_sb + kh * q_sh +
                  (int64_t)row_of(rb) * q_sr
            : q;
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const __nv_bfloat16* pa = qa + kd * 16 + c;
      const __nv_bfloat16* pb = qb + kd * 16 + c;
      qf[kd][0] = oka ? *reinterpret_cast<const uint32_t*>(pa) : 0u;
      qf[kd][1] = okb ? *reinterpret_cast<const uint32_t*>(pb) : 0u;
      qf[kd][2] = oka ? *reinterpret_cast<const uint32_t*>(pa + 8) : 0u;
      qf[kd][3] = okb ? *reinterpret_cast<const uint32_t*>(pb + 8) : 0u;
    }
  }

  // this split's keys [kb, s1), never a key >= the longest row's length;
  // the table entries [pf0, pf1) it may read
  int kb, s1, pf0, pf1;
  if (MODE == MD_PREFILL) {
    // per-row-tile causal bounds: keys [lo, hi) some row of the tile sees
    // (hi its largest effective length, lo its smallest window floor),
    // shared by the cluster's splits (grid x = cluster size) in whole tiles
    int hi = 0, emin = 0x7fffffff;
    for (int r = lane; r < nrows; r += 32) {
      const int e = eff_of(r);
      hi = max(hi, e);
      emin = min(emin, e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      emin = min(emin, __shfl_xor_sync(0xffffffffu, emin, off));
    }
    const int lo = window > 0 ? max(emin - window, 0) : 0;
    const int cs = static_cast<int>(gridDim.x);
    const int per = (max(hi - lo, 0) + cs * MD_BK - 1) / (cs * MD_BK) * MD_BK;
    kb = lo + split * per;
    s1 = min(hi, kb + per);
    pf0 = kb;
    pf1 = max(s1, kb);
  } else {
    // keys any row of the chunk can see: [lo, len)
    const int lo = window > 0 ? max(len - window - (q_len - 1), 0) : 0;
    const int s0 = split * split_len;
    s1 = min(len, s0 + split_len);
    kb = max(s0, lo);
    pf0 = s0;
    pf1 = min(s0 + split_len, S);
  }
  const int ntile = kb < s1 ? (s1 - kb + MD_BK - 1) / MD_BK : 0;

  const KT* kbase = k + (PAGED ? 0 : b * k_s0) + kh * k_sh;
  const KT* vbase = v + (PAGED ? 0 : b * v_s0) + kh * v_sh;
  const float* ksbase = sc.k + kh * sc.k_sh;     // 8-bit pools' scales
  const float* vsbase = sc.v + kh * sc.v_sh;
  const int* trow = tbl + b * tbl_sb;
  const uint32_t ring = smem_u32(md_smem);
  if (PAGED) {
    // this split's block-table entries, on their way to L1 (an entry is
    // used only below the length)
    const int e0 = pf0 / page;
    const int e1 = (pf1 + page - 1) / page;
    for (int e = e0 + 16 * threadIdx.x; e < e1; e += 16 * MD_THREADS)
      prefetch_l1(trow + e);
    if (threadIdx.x == 0 && e1 > e0) prefetch_l1(trow + e1 - 1);
  }

  // Tile i (keys kb + 64i ..) into stage i % STAGES; always one commit.
  // A thread copies 16-byte chunk ch of the same RPT rows of K and of V;
  // with a block table it reads the rows' entries first, all together, so
  // its copies wait on one round trip to memory per tile rather than one
  // per copy (each copy's "memory" clobber keeps the compiler from
  // hoisting a later table read above an earlier copy).  An 8-bit row is
  // RCH = HD / 16 chunks; the thread of chunk 0 of a row also copies the
  // row's K and V scales.  A bf16 row at hd 256 is 32 chunks: a thread
  // copies chunks ch and ch + 16 of its rows, so it holds 8 rows' table
  // entries a tile, not 16 (which, beside acc, spill).
  constexpr int RCH = Q8 ? HD / 16 : L::CHUNKS;          // chunks a row
  constexpr int CPT = !Q8 && HD > 128 ? 2 : 1;           // a thread's, a row
  constexpr int TPR = RCH / CPT;                         // threads a row
  constexpr int RPT = MD_BK * TPR / MD_THREADS;          // 8 at hd 128
  constexpr int ROW_STEP = MD_THREADS / TPR;
  constexpr int EPC = Q8 ? 16 : 8;                       // elements a chunk
  const int ch = threadIdx.x % TPR, row0 = threadIdx.x / TPR;
  auto load_tile = [&](int i) {
    if (i < ntile) {
      const int t0 = kb + i * MD_BK;
      const uint32_t st = ring + (i % MD_STAGES) * L::STAGE_BYTES;
      int pg[RPT];
      if (PAGED) {
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int key = t0 + row0 + j * ROW_STEP;
          pg[j] = key < s1 ? __ldg(trow + key / page) : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int row = row0 + j * ROW_STEP, key = t0 + row;
        const KT *ks = kbase, *vs = vbase;
        const float *kss = ksbase, *vss = vsbase;
        int bytes = 0;
        if (key < s1) {
          int64_t ko, vo;
          if (PAGED) {
            const int slot = key % page;
            ko = (int64_t)pg[j] * k_s0 + (int64_t)slot * k_ss;
            vo = (int64_t)pg[j] * v_s0 + (int64_t)slot * v_ss;
            if (Q8) {
              kss = ksbase + (int64_t)pg[j] * sc.k_sn + (int64_t)slot * sc.k_ss;
              vss = vsbase + (int64_t)pg[j] * sc.v_sn + (int64_t)slot * sc.v_ss;
            }
          } else {
            ko = (int64_t)key * k_ss;
            vo = (int64_t)key * v_ss;
          }
          ks = kbase + ko + ch * EPC;
          vs = vbase + vo + ch * EPC;
          bytes = 16;
        }
        if constexpr (Q8) {
          // stored rows unswizzled (each thread reads back its own chunks)
          cp_async16(st + row * HD + ch * 16, ks, bytes);
          cp_async16(st + L::RAW_BYTES + row * HD + ch * 16, vs, bytes);
          if (ch == 0) {
            cp_async4(st + L::SCALE_OFF + row * 4, kss, bytes / 4);
            cp_async4(st + L::SCALE_OFF + (MD_BK + row) * 4, vss, bytes / 4);
          }
        } else if constexpr (CPT == 1) {
          cp_async16(st + tile_off<HD>(row, ch), ks, bytes);
          cp_async16(st + L::TILE_BYTES + tile_off<HD>(row, ch), vs, bytes);
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int cc = ch + c * TPR;
            cp_async16(st + tile_off<HD>(row, cc), ks + c * TPR * EPC, bytes);
            cp_async16(st + L::TILE_BYTES + tile_off<HD>(row, cc),
                       vs + c * TPR * EPC, bytes);
          }
        }
      }
    }
    cp_async_commit();
  };

  float m[2] = {MD_MASKED, MD_MASKED}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // QS: the row tile's fragments' rows into shared memory, 16-byte chunks
  // in the K tiles' swizzled layout, rows past the tile zero; they ride in
  // tile 0's commit group, so the first wait covers them
  if constexpr (L::QS) {
    const uint32_t qtile = ring + L::Q_OFF;
    for (int e = threadIdx.x; e < nfrag * 16 * L::CHUNKS; e += MD_THREADS) {
      const int r = e / L::CHUNKS, c = e % L::CHUNKS;
      const bool ok = r < nrows;
      cp_async16(qtile + tile_off<HD>(r, c),
                 ok ? q + (int64_t)batch_of(r) * q_sb + kh * q_sh +
                          (int64_t)row_of(r) * q_sr + c * 8
                    : q,
                 ok ? 16 : 0);
    }
  }

#pragma unroll
  for (int i = 0; i < MD_STAGES; ++i) load_tile(i);

  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<MD_STAGES - 1>();
    const int stage = (i % MD_STAGES) * L::STAGE_BYTES;   // its offset
    if constexpr (Q8) {
      // this thread's own chunks of tile i (visible to it after the wait)
      // to bf16 in the converted tile, which every warp finished reading
      // at the end of the last iteration
      const unsigned char* raw = md_smem + stage;
      unsigned char* cvt = md_smem + L::CVT_OFF;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int row = row0 + j * ROW_STEP;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const uint4 x = *reinterpret_cast<const uint4*>(
              raw + kv * L::RAW_BYTES + row * HD + ch * 16);
          uint4 lo, hi;
          cvt16_bf16<KT>(x, lo, hi);
          unsigned char* t = cvt + kv * L::TILE_BYTES;
          *reinterpret_cast<uint4*>(t + tile_off<HD>(row, 2 * ch)) = lo;
          *reinterpret_cast<uint4*>(t + tile_off<HD>(row, 2 * ch + 1)) = hi;
        }
      }
    }
    __syncthreads();                   // tile i landed (and converted)
    if (active) {
      const uint32_t ks = ring + (Q8 ? L::CVT_OFF : stage);
      const uint32_t vs = ks + L::TILE_BYTES;
      // an 8-bit pool's per-key scales of tile i: K at [0, 64), V at
      // [64, 128)
      const float* kscl =
          reinterpret_cast<const float*>(md_smem + stage + L::SCALE_OFF);
      const int key0 = slice * SW;        // this warp's first key in the tile

      // S = Q K^T over this warp's SW keys
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      // two loops, not one over a chosen A operand: the hd-64/128 one keeps
      // its earlier form (a shared loop changed that code and slowed their
      // dense decode)
      if constexpr (L::QS) {
        // this lane's row of the fragment's A operand in staged Q (the four
        // 8x8 matrices: rows 0-7 / 8-15 by lane bit 3, k halves by bit 4)
        const uint32_t qtile = ring + L::Q_OFF;
        const int qrow = frag * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t qa[4];
          ldmatrix_x4(qa, qtile + tile_off<HD>(qrow, kd * 2 + (lane >> 4)));
#pragma unroll
          for (int n2 = 0; n2 < NB / 2; ++n2) {
            const int row = key0 + n2 * 16 + (lane & 7) + ((lane >> 4) << 3);
            const int ch = kd * 2 + ((lane >> 3) & 1);
            uint32_t kf[4];
            ldmatrix_x4(kf, ks + tile_off<HD>(row, ch));
            mma_bf16(s[2 * n2], qa, kf[0], kf[1]);
            mma_bf16(s[2 * n2 + 1], qa, kf[2], kf[3]);
          }
        }
      } else {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
          for (int n2 = 0; n2 < NB / 2; ++n2) {
            const int row = key0 + n2 * 16 + (lane & 7) + ((lane >> 4) << 3);
            const int ch = kd * 2 + ((lane >> 3) & 1);
            uint32_t kf[4];
            ldmatrix_x4(kf, ks + tile_off<HD>(row, ch));
            mma_bf16(s[2 * n2], qf[kd], kf[0], kf[1]);
            mma_bf16(s[2 * n2 + 1], qf[kd], kf[2], kf[3]);
          }
        }
      }
      // column c of s[n][j]: key0 + n·8 + 2·(lane & 3) + (j & 1)
      if constexpr (Q8) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float2 kc = *reinterpret_cast<const float2*>(
              kscl + key0 + n * 8 + 2 * (lane & 3));
          s[n][0] *= kc.x;
          s[n][1] *= kc.y;
          s[n][2] *= kc.x;
          s[n][3] *= kc.y;
        }
      }

      // mask, softcap, online softmax in base 2 (rows ra: s[.][0..1], rb:
      // s[.][2..3]); the row max reduces over the lane quad
      const int t0 = kb + i * MD_BK + key0;
      float mx[2] = {MD_MASKED, MD_MASKED};
      if (softcap <= 0.f && t0 + SW <= min(s1, wmin) &&
          (window <= 0 || t0 >= wmax - window)) {
        // every row sees all of the warp's keys of this tile
#pragma unroll
        for (int n = 0; n < NB; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[n][j] *= sl2e;
            mx[j >> 1] = fmaxf(mx[j >> 1], s[n][j]);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = t0 + n * 8 + 2 * (lane & 3) + (j & 1);
            const int eff = j < 2 ? effa : effb;
            bool ok = c < s1 && c < eff;
            if (window > 0) ok = ok && c >= eff - window;
            float x = s[n][j] * scale;
            if (softcap > 0.f) x = softcap * tanhf(x / softcap);
            x = ok ? x * MD_LOG2E : MD_MASKED;
            s[n][j] = x;
            mx[j >> 1] = fmaxf(mx[j >> 1], x);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h]);
        alpha[h] = ex2(m[h] - mn);
        m[h] = mn;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = s[n][j];
          const float p = x > 0.5f * MD_MASKED ? ex2(x - m[j >> 1]) : 0.f;
          s[n][j] = p;
          l[j >> 1] += p;
        }
      }

      // O += P V: the S accumulators of keys 16kk..16kk+15 are the A
      // fragment of k-step kk, rounded to bf16
      if constexpr (Q8) {               // p·v_scale, column by column
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float2 vc = *reinterpret_cast<const float2*>(
              kscl + MD_BK + key0 + n * 8 + 2 * (lane & 3));
          s[n][0] *= vc.x;
          s[n][1] *= vc.y;
          s[n][2] *= vc.x;
          s[n][3] *= vc.y;
        }
      }
#pragma unroll
      for (int kk = 0; kk < SW / 16; ++kk) {
        uint32_t pf[4];
        pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const int row = key0 + kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + tile_off<HD>(row, n2 * 2 + (lane >> 4)));
          mma_bf16(acc[2 * n2], pf, vf[0], vf[1]);
          mma_bf16(acc[2 * n2 + 1], pf, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                   // tile i consumed: refill its stage
    load_tile(i + MD_STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free: partials reuse it

  float* part = reinterpret_cast<float*>(md_smem);             // [w][16][PST]
  float* wml = reinterpret_cast<float*>(md_smem + L::WML_OFF);  // [w][16][2]
  float* ml = reinterpret_cast<float*>(md_smem + L::ML_OFF);    // [64][2]
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const int la = lane >> 2, c = 2 * (lane & 3);
    float* pw = part + warp * 16 * L::PST;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(pw + la * L::PST + n * 8 + c) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(pw + (la + 8) * L::PST + n * 8 + c) =
          make_float2(acc[n][2], acc[n][3]);
    }
    if ((lane & 3) == 0) {
      wml[(warp * 16 + la) * 2] = m[0];
      wml[(warp * 16 + la) * 2 + 1] = l[0];
      wml[(warp * 16 + la + 8) * 2] = m[1];
      wml[(warp * 16 + la + 8) * 2 + 1] = l[1];
    }
  }
  __syncthreads();
  // the block's (m, l) per row, merged over its KS key slices
  for (int r = threadIdx.x; r < nfrag * 16; r += MD_THREADS) {
    const int w0 = (r >> 4) * KS, rr = r & 15;
    float mm = MD_MASKED;
#pragma unroll
    for (int s = 0; s < KS; ++s) mm = fmaxf(mm, wml[((w0 + s) * 16 + rr) * 2]);
    float ll = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s)
      ll += wml[((w0 + s) * 16 + rr) * 2 + 1] *
            exp2f(wml[((w0 + s) * 16 + rr) * 2] - mm);
    ml[r * 2] = mm;
    ml[r * 2 + 1] = ll;
  }
  if (KS > 1) {
    __syncthreads();
    // acc merged over the key slices into the fragment's first warp slot
    for (int e = threadIdx.x; e < nfrag * 16 * HD; e += MD_THREADS) {
      const int r = e / HD, d = e % HD, w0 = (r >> 4) * KS, rr = r & 15;
      const float mm = ml[r * 2];
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s)
        a += part[((w0 + s) * 16 + rr) * L::PST + d] *
             exp2f(wml[((w0 + s) * 16 + rr) * 2] - mm);
      part[(w0 * 16 + rr) * L::PST + d] = a;
    }
  }
  cluster.sync();                      // every block's partial is visible

  // the cluster merge: rank j writes elements j·THREADS + t, stepping by
  // cluster size · THREADS, of this row tile's nrows x HD outputs; every
  // rank's (m, l, acc) of an element is read at once
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank * MD_THREADS + threadIdx.x; e < nrows * HD;
       e += cs * MD_THREADS) {
    const int r = e / HD, d = e % HD;
    const int slot = ((r >> 4) * KS * 16 + (r & 15)) * L::PST + d;
    float mj[MD_MAX_CLUSTER], lj[MD_MAX_CLUSTER], aj[MD_MAX_CLUSTER];
#pragma unroll
    for (int j = 0; j < MD_MAX_CLUSTER; ++j) {
      if (j < cs) {
        const float* mlj = cluster.map_shared_rank(ml, j);
        mj[j] = mlj[r * 2];
        lj[j] = mlj[r * 2 + 1];
        aj[j] = cluster.map_shared_rank(part, j)[slot];
      }
    }
    float mm = MD_MASKED;
#pragma unroll
    for (int j = 0; j < MD_MAX_CLUSTER; ++j)
      if (j < cs) mm = fmaxf(mm, mj[j]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int j = 0; j < MD_MAX_CLUSTER; ++j) {
      if (j < cs) {
        const float w = exp2f(mj[j] - mm);
        ll += lj[j] * w;
        a += aj[j] * w;
      }
    }
    o[(int64_t)batch_of(r) * o_sb + kh * o_sh + (int64_t)row_of(r) * o_sr +
      d] = __float2bfloat16(a / fmaxf(ll, 1e-30f));
  }
  cluster.sync();                      // no block leaves while read
}

struct MdArgs {
  const void *q, *k, *v;
  KvScales sc;          // 8-bit pools' scales (null for bf16)
  const int* tbl;
  const int* cache_len;
  const int* plan;      // prefix-append's tile plan, or null
  void* o;
  int B, KH, rows, tile_rows, q_len, S, hd;
  long long st[12];     // q (b, h, r), k (0, h, s), v (0, h, s), o (b, h, r)
  long long tbl_sb, plan_st;
  int n_plan, page, splits, split_len, window;
  float softcap, scale;
};

// the grid's row tiles: the plan's entries, or the rows' tiles
int md_tiles(const MdArgs& a) {
  if (a.plan != nullptr) return a.n_plan;
  return a.tile_rows > 0 ? (a.rows + a.tile_rows - 1) / a.tile_rows : 0;
}

template <int HD, typename KT>
constexpr int md_bytes() {
  return MdLayout<HD, IsQ8<KT>::value>::BYTES;
}

// the kernel's shared memory and cluster attributes, set once
template <int HD, int KS, int MODE, typename KT>
cudaError_t md_configure() {
  auto kernel = decode_mma_kernel<HD, KS, MODE, KT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        md_bytes<HD, KT>());
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  return cudaSuccess;
}

// A launch of grid (splits, y, z) in clusters of ``splits`` blocks; attr
// holds the cluster attribute cfg points at.
template <int HD, typename KT>
void md_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1],
               int splits, int y, int z, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(splits, y, z);
  cfg.blockDim = dim3(MD_THREADS);
  cfg.dynamicSmemBytes = md_bytes<HD, KT>();
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <int HD, int KS, int MODE, typename KT>
cudaError_t md_launch(const MdArgs& a, cudaStream_t stream) {
  auto kernel = decode_mma_kernel<HD, KS, MODE, KT>;
  cudaError_t e = md_configure<HD, KS, MODE, KT>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  md_config<HD, KT>(cfg, attr, a.splits, a.KH * md_tiles(a),
                    a.plan ? 1 : a.B, stream);
  const long long* st = a.st;
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const KT*>(a.k), static_cast<const KT*>(a.v), a.sc, a.tbl,
      a.cache_len, a.plan,
      static_cast<__nv_bfloat16*>(a.o), a.B, a.KH, a.rows, a.tile_rows,
      a.q_len, a.S, a.split_len, (int64_t)st[0], (int64_t)st[1],
      (int64_t)st[2], (int64_t)st[3], (int64_t)st[4], (int64_t)st[5],
      (int64_t)st[6], (int64_t)st[7], (int64_t)st[8], (int64_t)a.tbl_sb,
      (int64_t)a.plan_st, a.page, (int64_t)st[9], (int64_t)st[10],
      (int64_t)st[11], a.window, a.softcap, a.scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the key slices per tile follow the row tile's fragment count
template <int HD, int MODE, typename KT>
cudaError_t md_dispatch_ks(const MdArgs& a, cudaStream_t stream) {
  const int frags = (a.tile_rows + 15) / 16;
  if (frags == 1) return md_launch<HD, 4, MODE, KT>(a, stream);
  if (frags == 2) return md_launch<HD, 2, MODE, KT>(a, stream);
  return md_launch<HD, 1, MODE, KT>(a, stream);
}

// how many clusters of ``splits`` blocks of one instance the card holds
// at once
template <int HD, int KS, int MODE, typename KT>
cudaError_t md_max_clusters(int splits, int* n) {
  cudaError_t e = md_configure<HD, KS, MODE, KT>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  md_config<HD, KT>(cfg, attr, splits, 1, 1, nullptr);
  return cudaOccupancyMaxActiveClusters(
      n, decode_mma_kernel<HD, KS, MODE, KT>, &cfg);
}

// the instance md_dispatch_ks launches for row tiles of tile_rows
template <int HD, int MODE, typename KT>
cudaError_t md_max_clusters_ks(int tile_rows, int splits, int* n) {
  const int frags = (tile_rows + 15) / 16;
  if (frags == 1) return md_max_clusters<HD, 4, MODE, KT>(splits, n);
  if (frags == 2) return md_max_clusters<HD, 2, MODE, KT>(splits, n);
  return md_max_clusters<HD, 1, MODE, KT>(splits, n);
}

// the head dims every mode takes: 64, 128 and 256 (whose instances stage Q
// in shared memory)
constexpr bool md_takes_hd(int hd) {
  return hd == 64 || hd == 128 || hd == 256;
}

template <int MODE, typename KT>
cudaError_t md_max_clusters_hd(int hd, int tile_rows, int splits, int* n) {
  if (hd == 64) return md_max_clusters_ks<64, MODE, KT>(tile_rows, splits, n);
  if (hd == 256)
    return md_max_clusters_ks<256, MODE, KT>(tile_rows, splits, n);
  return md_max_clusters_ks<128, MODE, KT>(tile_rows, splits, n);
}

// the pool's element type: bf16 (DT_BF16), int8 (DT_I8) or e4m3 (DT_F8),
// the 8-bit ones for the paged modes only; anything else fails
template <int MODE>
cudaError_t md_max_clusters_kv(int kv, int hd, int tile_rows, int splits,
                               int* n) {
  if (kv == DT_BF16)
    return md_max_clusters_hd<MODE, __nv_bfloat16>(hd, tile_rows, splits, n);
  if constexpr (MODE != MD_DENSE) {
    if (kv == DT_I8)
      return md_max_clusters_hd<MODE, int8_t>(hd, tile_rows, splits, n);
    if (kv == DT_F8)
      return md_max_clusters_hd<MODE, fp8_t>(hd, tile_rows, splits, n);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, typename KT>
cudaError_t md_dispatch_hd(const MdArgs& a, cudaStream_t s) {
  if (a.hd == 64) return md_dispatch_ks<64, MODE, KT>(a, s);
  if (a.hd == 256) return md_dispatch_ks<256, MODE, KT>(a, s);
  return md_dispatch_ks<128, MODE, KT>(a, s);
}

template <int MODE>
int md_run(const MdArgs& a, int kv, void* stream) {
  const long long tiles = md_tiles(a);
  // decode splits cover [0, S) in split_len keys; prefix-append's share
  // each tile's own key range (split_len unused)
  const bool splits_cover =
      MODE == MD_PREFILL ||
      (a.split_len >= 1 && (long long)a.splits * a.split_len >= a.S);
  if (!md_takes_hd(a.hd) || a.B < 1 || a.rows < 1 ||
      a.tile_rows < 1 || a.tile_rows > MD_MAX_ROWS || a.q_len < 1 ||
      a.rows % a.q_len != 0 || a.KH < 1 || tiles < 1 ||
      a.KH * tiles > 65535 || a.B > 65535 || a.splits < 1 ||
      a.splits > MD_MAX_CLUSTER || !splits_cover ||
      (MODE != MD_DENSE && a.page < 1) ||
      (a.plan != nullptr && (MODE != MD_PREFILL || a.q_len != 1)))
    return (int)cudaErrorInvalidValue;
  // cp.async and the Q loads: 16-byte aligned bases (the wrapper checks
  // the strides of the dimensions it uses)
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv == DT_BF16) return (int)md_dispatch_hd<MODE, __nv_bfloat16>(a, s);
  if constexpr (MODE != MD_DENSE) {
    if (a.sc.k == nullptr || a.sc.v == nullptr)
      return (int)cudaErrorInvalidValue;
    if (kv == DT_I8) return (int)md_dispatch_hd<MODE, int8_t>(a, s);
    if (kv == DT_F8) return (int)md_dispatch_hd<MODE, fp8_t>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 only, hd 64, 128 or 256.  q (B,KH,rows,hd) token-major rows (rows =
// q_len·group) in row tiles of tile_rows <= 64; k/v (B,KH,S,hd); cache_len
// (B,) int32; o (B,KH,rows,hd).  Unit innermost strides; q/k/v bases and
// the strides of dimensions larger than 1 16-byte aligned.  splits (<= 16)
// blocks per cluster, each over split_len keys, splits·split_len >= S.
// softcap <= 0 = none.
extern "C" int decode_attention_mma_fwd(
    const void* q, const void* k, const void* v, const int* cache_len,
    void* o, int B, int KH, int rows, int tile_rows, int q_len, int S,
    int hd, long long q_sb, long long q_sh, long long q_sr, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_sr,
    int splits, int split_len, int window, float softcap, float scale,
    void* stream) {
  MdArgs a{q, k, v, {nullptr, nullptr, 0, 0, 0, 0, 0, 0}, nullptr,
           cache_len, nullptr, o, B, KH, rows, tile_rows,
           q_len, S, hd, {q_sb, q_sh, q_sr, k_sb, k_sh, k_ss, v_sb, v_sh,
                          v_ss, o_sb, o_sh, o_sr},
           0, 0, 0, 1, splits, split_len, window, softcap, scale};
  return md_run<MD_DENSE>(a, DT_BF16, stream);
}

// The paged form: k_pool/v_pool (n_pages, KH, page, hd) strided views,
// block_table (B, P) int32 with row stride tbl_sb, S = P·page.  kv_dtype:
// the pools' element type, DT_BF16, or DT_I8 / DT_F8 for int8 / e4m3
// pools, whose f32 scales k_scale / v_scale are (n_pages, KH, page)
// strided views (strides ks_* / vs_*; null for bf16 pools).  The rest as
// decode_attention_mma_fwd.
extern "C" int paged_decode_attention_mma_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale,
    const int* block_table, const int* cache_len, void* o, int B, int KH,
    int rows, int tile_rows, int q_len, int P, int page, int hd,
    long long q_sb, long long q_sh, long long q_sr, long long k_sn,
    long long k_sh, long long k_sp, long long v_sn, long long v_sh,
    long long v_sp, long long ks_sn, long long ks_sh, long long ks_sp,
    long long vs_sn, long long vs_sh, long long vs_sp, long long tbl_sb,
    long long o_sb, long long o_sh, long long o_sr, int splits,
    int split_len, int window, float softcap, float scale, int kv_dtype,
    void* stream) {
  MdArgs a{q, k_pool, v_pool,
           {k_scale, v_scale, ks_sn, ks_sh, ks_sp, vs_sn, vs_sh, vs_sp},
           block_table, cache_len, nullptr, o, B, KH,
           rows, tile_rows, q_len, P * page, hd,
           {q_sb, q_sh, q_sr, k_sn, k_sh, k_sp, v_sn, v_sh, v_sp,
            o_sb, o_sh, o_sr},
           tbl_sb, 0, 0, page, splits, split_len, window, softcap, scale};
  return md_run<MD_PAGED>(a, kv_dtype, stream);
}

// Paged prefix-append (chunked prefill): the paged form's operands, with
// cache_len INCLUDING the chunk, and each row tile walking only the keys
// its rows see, split over the cluster's ``splits`` blocks.  Without a plan
// (plan null) the row tiles are tile_rows rows of each batch row.  With
// one (q_len 1): plan[i] is the first batch row of entry i and
// plan[plan_st + i] its row count, i < n_plan, consecutive rows sharing
// the first one's table row, at most tile_rows / group of them; an entry
// with count 0 is empty, and rows in no entry are not written.  Pools and
// scales as paged_decode_attention_mma_fwd's.
extern "C" int paged_prefill_attention_mma_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale,
    const int* block_table, const int* cache_len, const int* plan, void* o,
    int B, int KH, int rows, int tile_rows, int q_len, int P, int page,
    int hd, long long q_sb, long long q_sh, long long q_sr, long long k_sn,
    long long k_sh, long long k_sp, long long v_sn, long long v_sh,
    long long v_sp, long long ks_sn, long long ks_sh, long long ks_sp,
    long long vs_sn, long long vs_sh, long long vs_sp, long long tbl_sb,
    long long o_sb, long long o_sh, long long o_sr, int n_plan,
    long long plan_st, int splits, int window, float softcap, float scale,
    int kv_dtype, void* stream) {
  MdArgs a{q, k_pool, v_pool,
           {k_scale, v_scale, ks_sn, ks_sh, ks_sp, vs_sn, vs_sh, vs_sp},
           block_table, cache_len, plan, o, B, KH, rows,
           tile_rows, q_len, P * page, hd,
           {q_sb, q_sh, q_sr, k_sn, k_sh, k_sp, v_sn, v_sh, v_sp,
            o_sb, o_sh, o_sr},
           tbl_sb, plan_st, n_plan, page, splits, 0, window, softcap, scale};
  return md_run<MD_PREFILL>(a, kv_dtype, stream);
}

// How many clusters of ``splits`` blocks (1..16) of the kernel in mode
// ``mode`` (0 dense, 1 paged, 2 prefix-append) at head dim hd, row tiles
// of tile_rows and cache element type kv_dtype (DT_BF16, or DT_I8 / DT_F8
// in the paged modes) fit on the current device at once, into *n: the
// wrappers plan their key splits with it.
extern "C" int decode_attention_mma_max_clusters(int mode, int hd,
                                                 int tile_rows, int splits,
                                                 int kv_dtype, int* n) {
  if (mode < MD_DENSE || mode > MD_PREFILL || !md_takes_hd(hd) ||
      tile_rows < 1 || tile_rows > MD_MAX_ROWS || splits < 1 ||
      splits > MD_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (mode == MD_DENSE)
    e = md_max_clusters_kv<MD_DENSE>(kv_dtype, hd, tile_rows, splits, n);
  else if (mode == MD_PAGED)
    e = md_max_clusters_kv<MD_PAGED>(kv_dtype, hd, tile_rows, splits, n);
  else
    e = md_max_clusters_kv<MD_PREFILL>(kv_dtype, hd, tile_rows, splits, n);
  return (int)e;
}
