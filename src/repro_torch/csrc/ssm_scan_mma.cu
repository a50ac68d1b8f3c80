// Chunked gated linear-attention scan (Mamba-2 SSD / mLSTM core) on
// Hopper's tensor cores (sm_90a): bf16 q, k, v and o, an f32 state.
//
// Replaces: src/repro/kernels/ssm_scan.py::ssm_scan_pallas (body
// _ssm_kernel) on the route kernels/ssm_scan.py::route gives bf16 with
// dk % 16 == 0 and dk <= 384: the prefill scan of models/layers.py::mlstm
// through ops.ssm_scan, 8 launches per xlstm-125m prefill.  float32, and
// every other dk, stays on ssm_scan.cu (CUDA cores).
//
// The function, per (batch row, head), is ssm_scan.cu's: S_t =
// exp(g_t)·S_{t-1} + k_t v_tᵀ, o_t = S_tᵀ q_t, from an f32 initial state,
// in chunks of C <= 64 tokens with inclusive decay sums cum_i:
//   o_i  = exp(cum_i)·(q_i · S) + Σ_{j<=i} (q_i·k_j)·exp(cum_i - cum_j)·v_j
//   S   <- exp(cum_C)·S + Σ_j exp(cum_C - cum_j)·k_j v_jᵀ
// with the exponent cum_i - cum_j masked (j > i gives 0) BEFORE exp.
//
// What bounds it on this card: the chunks of a sequence are a chain (each
// needs the state the one before left), and each link is ~44 MFLOP per
// (batch row, head) at the xlstm-125m shape (dk 384, dv 385, C 64) against
// ~0.2 MB of bytes: operations, on few (batch row, head) chains (16 at
// B 4, H 4), so the time is the chain's length times a link's latency on
// the SMs a chain can use.
//
// What the design does about it:
//  * One thread-block cluster per (batch row, head), its cs blocks (5-16
//    at dv 385, the wrapper's plan) splitting the value columns: the scan
//    separates over them (o[:, c] and S[:, c] depend only on v[:, c]), so
//    block r owns a run of 16-column m-tiles of dv (dv 385 is 25 m-tiles,
//    the last holding the normaliser's column of ones alone; columns past
//    dv are zero and never stored).  Up to five m-tiles a block let
//    clusters of 5-6 blocks hold all 16 chains of the B 4 prefill on the
//    card at once (clusters of 7-8: 15 at once, so two waves).
//  * Each block keeps its (dk, columns) f32 slice of the state in
//    REGISTERS for the whole sequence, as the accumulators of the state
//    update: warp w holds m-tile w / 2 and half w % 2 of dk, 96 floats a
//    thread at dk 384.  The state is kept transposed (Sᵀ: columns x dk),
//    so that its accumulator fragments are, as they stand, the A operand
//    fragments of q·S computed as Sᵀ·qᵀ (FlashAttention-2's reuse of P's
//    accumulators): the state never leaves the registers between chunks.
//  * q·kᵀ once per chunk per (batch row, head): its 20 16x8 tiles on or
//    below the diagonal are split over the cluster's warps (the idle ones,
//    past their block's m-tiles, where there are enough: then no warp
//    with a q·S to do waits on them), masked and decayed in f32, and
//    every block's tiles are all-gathered into every block's shared
//    memory with st.async, counted in bytes on the receiver's mbarrier
//    (one per parity of the chunk, as csrc/slstm_scan.cu exchanges h): no
//    cluster barrier in the loop.  Every block also sends each block a
//    4-byte token a chunk on the same barrier, so a block sends chunk
//    t + 2's tiles into a buffer only after every block's chunk t + 1
//    arrived, which each block sends only after it has read chunk t's,
//    even a block that computes no tile (without the tokens nothing holds
//    the others back to its pace: on a long sequence it falls two chunks
//    behind and its buffer is overwritten).
//  * Every product on mma.sync.m16n8k16 (bf16 operands, f32 accumulate).
//    q, k and v are bf16 and enter as they are (their products are exact);
//    the f32 operands (the state, the scores P and exp(cum_C - cum_j)·v_j)
//    enter as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), a
//    relative residual of ~2^-17, so the f32 state keeps its tolerance and
//    o is the f32 result rounded once to bf16.  That doubles the mma count
//    of those three products.
//  * q and k (64 x dk bf16 a chunk) reach every block of the cluster by
//    TMA, from tensor maps the host encodes per call: boxes of 64 columns
//    x the chunk's tokens, 128-byte swizzle (ldmatrix reads no bank
//    twice), six a tile at dk 384 (16-byte cp.async copies, ~24 a thread
//    a chunk, and a bulk copy a row were slower); k is double-buffered
//    and fetched a chunk ahead, q as soon as the chunk's last read of it
//    is done, and k serves both the scores and the state update from
//    shared memory.  v and o are read and written element by element
//    (their rows are 770 bytes apart at dv 385, which no 16-byte copy
//    takes): v into registers at the top of the chunk, stored to shared
//    memory after q·S; the decays a chunk ahead.
//  * q·S over a dk half is a partial sum; the two warps of an m-tile swap
//    the halves of the chunk's tokens they do not own through shared
//    memory, and each finishes (P·V, the output) on its own 32 tokens.
//  * Clusters share nothing, so a grid with more clusters than the card
//    holds at once runs in more than one wave.
//
// Resources at dk 384: 218,656 bytes of dynamic shared memory (1 KB of it
// to align the boxes), one block (320 threads, 168 registers a thread,
// ~30 bytes of spills) an SM.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int SM_C = 64;               // tokens per chunk, at most
constexpr int SM_WARPS = 10;
constexpr int SM_THREADS = 32 * SM_WARPS;
constexpr int SM_MAX_MT = SM_WARPS / 2;    // 16-column m-tiles a block owns
constexpr int SM_MAX_DK = 384;
constexpr int SM_MAX_KS = SM_MAX_DK / 32;  // dk k-steps of a warp's half
constexpr int SM_MAX_CLUSTER = 16;
constexpr int SM_TILES = 20;           // 16x8 score tiles touching j <= i
constexpr int SM_TILE_BYTES = 32 * 4 * 4;  // a tile's st.async bytes a block
constexpr int SM_PBYTES = SM_TILES * SM_TILE_BYTES;  // received per chunk
constexpr int SM_PSTR = SM_C + 8;      // bf16 row stride of P: 144 B
constexpr int SM_VCOLS = 16 * SM_MAX_MT;   // v columns a block holds
constexpr int SM_VSTR = SM_VCOLS + 8;  // bf16 row stride of v: 176 B
constexpr int SM_VPER = SM_C * SM_VCOLS / 2 / SM_THREADS;  // v pairs a thread
constexpr int SM_CUMS = 3 * SM_C + 4;  // cum, exp(cum), w, exp(total)

struct MmaArgs {
  const __nv_bfloat16 *q, *k, *v;
  const float *g, *s0;
  __nv_bfloat16* o;
  float* sf;
  int B, H, S, dk, dv, chunk, cs;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t g_sb, g_sh, g_ss, o_sb, o_sh, o_ss;
};

// Shared memory, in bytes, at dk: q and k [2] as TMA writes them (boxes of
// 64 columns x 64 rows, 128 B a row, 128-byte swizzle), P hi and lo [2
// parities][64][72] each, v [64][88] (bf16); the q·S partials [10
// warps][4][32][4] and the chunk sums [2][SM_CUMS] (f32); 1 KB of room to
// align the boxes to 1 KB.
constexpr int SM_BOX_BYTES = SM_C * 128;
__host__ __device__ inline int q_boxes(int dk) { return (dk + TMA_BOX_COLS - 1) / TMA_BOX_COLS; }
__host__ __device__ inline int q_bytes(int dk) { return q_boxes(dk) * SM_BOX_BYTES; }
constexpr int SM_P_BYTES = SM_C * SM_PSTR * 2;
constexpr int SM_V_BYTES = SM_C * SM_VSTR * 2;
constexpr int SM_RED_BYTES = SM_WARPS * 4 * 32 * 4 * 4;
__host__ inline size_t mma_smem_bytes(int dk) {
  return 1024 + 3 * (size_t)q_bytes(dk) + 4 * SM_P_BYTES + SM_V_BYTES +
         SM_RED_BYTES + 2 * SM_CUMS * 4;
}

// The byte offset of 16-byte chunk ``ch`` of row ``r`` in a q or k tile:
// box ch / 8, 128-byte swizzle (the chunk's index XOR the row's low bits,
// so the 8 rows an ldmatrix phase reads hit 8 bank groups)
__device__ __forceinline__ uint32_t qk_off(int r, int ch) {
  return (uint32_t)((ch >> 3) * SM_BOX_BYTES + r * 128 +
                    (((ch & 7) ^ (r & 7)) << 4));
}

// orders this thread's (and, after a barrier, the block's) earlier
// generic-proxy accesses to shared memory before its later TMA writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi): x0 in
// the low half of each (the fragment's lower column)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// --- the cluster exchange (as csrc/slstm_scan.cu) ---------------------------

// 4 bytes to the shared::cluster address ``dst``, counted on the mbarrier
// at the shared::cluster address ``bar`` (both in one block of the cluster)
__device__ __forceinline__ void send4(uint32_t dst, uint32_t bar, uint32_t v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n"
      ::"r"(dst), "r"(v), "r"(bar) : "memory");
}

// ---------------------------------------------------------------------------

// Score tile t (0..19) of the chunk's lower triangle: 16 rows from 16·it,
// 8 columns from 8·jt, jt <= 2·it + 1.
__device__ __forceinline__ void score_tile(int t, int& it, int& jt) {
  it = t < 2 ? 0 : t < 6 ? 1 : t < 12 ? 2 : 3;
  jt = t - it * (it + 1);
}

// Tokens [t0, t0 + C) of (batch row b, head h) of a q or k map into a tile
// (its boxes of 64 columns; columns past dk read as zero), counted on
// ``bar``; one thread issues it.
__device__ __forceinline__ void fetch_tile(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int t0, int C, int dk,
                                           int h, int b) {
  fence_proxy_async();
  mbar_expect_tx(bar, q_boxes(dk) * C * 128);
  for (int i = 0; i < q_boxes(dk); ++i)
    tma_load(dst + i * SM_BOX_BYTES, map, bar, TMA_BOX_COLS * i, t0, h, b);
}

// The chunk's decay sums (one warp), from its log decays g0 = g[lane], g1
// = g[lane + 32] (zero past C): cum_i (inclusive; cum_i for i >= C is the
// chunk's total), exp(cum_i) (0 past C), w_j = exp(total - cum_j) (0 past
// C) and exp(total).
__device__ __forceinline__ void chunk_sums(float* cs_, float g0, float g1,
                                           int C, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y0 = __shfl_up_sync(0xffffffffu, g0, off);
    const float y1 = __shfl_up_sync(0xffffffffu, g1, off);
    if (lane >= off) { g0 += y0; g1 += y1; }
  }
  g1 += __shfl_sync(0xffffffffu, g0, 31);
  const float total = __shfl_sync(0xffffffffu, g1, 31);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    const float c = h ? g1 : g0;
    cs_[i] = c;
    cs_[SM_C + i] = i < C ? expf(c) : 0.f;
    cs_[2 * SM_C + i] = i < C ? expf(total - c) : 0.f;
  }
  if (lane == 0) cs_[3 * SM_C] = expf(total);
}

// grid (cs, H, B) in clusters of (cs, 1, 1); block r of a cluster owns the
// m-tiles [mt0, mt0 + nmt) of dv.  Warp w: m-tile w / 2 of the block, dk
// half w % 2 (k-steps [kb, kb + nks)), chunk tokens [32·(w % 2), +32);
// warps past the block's m-tiles only load v and score.  Thread 0 issues
// the TMA loads, warp 0 computes the chunk sums.
__global__ void __launch_bounds__(SM_THREADS, 1)
ssm_scan_mma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap, MmaArgs a) {
  extern __shared__ __align__(16) unsigned char sm_smem[];
  // mbarriers: the scores of each chunk parity, k of each buffer, q
  __shared__ __align__(8) uint64_t sm_bar[5];
  // a token from each block of the cluster a chunk, by parity (below)
  __shared__ uint32_t sm_token[2][SM_MAX_CLUSTER];
  const int dk = a.dk, C = a.chunk;
  unsigned char* tiles =
      sm_smem + ((1024 - (smem_u32(sm_smem) & 1023)) & 1023);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tiles);
  __nv_bfloat16* ks = qs + q_bytes(dk) / 2;              // [2] tiles
  __nv_bfloat16* ph = ks + q_bytes(dk);                  // [2][64][72]
  __nv_bfloat16* pl = ph + 2 * SM_C * SM_PSTR;           // [2][64][72]
  __nv_bfloat16* vs = pl + 2 * SM_C * SM_PSTR;           // [64][88]
  float* red = reinterpret_cast<float*>(vs + SM_C * SM_VSTR);
  float* sums = red + SM_RED_BYTES / 4;                  // [2][SM_CUMS]

  const int cs = a.cs, rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;               // fragment row, col
  const int n_mt = (a.dv + 15) / 16, base = n_mt / cs, extra = n_mt % cs;
  const int nmt = base + (rank >= cs - extra);           // the last blocks
  const int mt0 = rank * base + max(0, rank - (cs - extra));   // take +1
  const int mtl = warp >> 1, half = warp & 1;
  const bool active = mtl < nmt;
  const int nk = dk / 16;                                // dk k-steps
  const int kb = half ? (nk + 1) / 2 : 0;
  const int nks = half ? nk / 2 : (nk + 1) / 2;
  const int col0 = 16 * (mt0 + mtl);                     // the warp's m-tile
  // the scores' slots: the cluster's idle warps (past their block's
  // m-tiles; they have no q·S to do) where there are five or more, so at
  // most four tiles each; else every warp, block t % cs, the last warps
  // first.  A block may have no tile: the tokens below keep it in step.
  int n_slots = 0, slot = -1;
  for (int r = 0; r < cs; ++r) {
    if (r == rank && !active) slot = n_slots + warp - 2 * nmt;
    n_slots += SM_WARPS - 2 * (base + (r >= cs - extra));
  }
  if (n_slots < 5) {
    n_slots = cs * SM_WARPS;
    slot = rank + cs * (SM_WARPS - 1 - warp);
  }
  const int vcols = min(16 * nmt, a.dv - 16 * mt0);      // the block's columns

  const __nv_bfloat16* vb = a.v + b * a.v_sb + h * a.v_sh + 16 * mt0;
  __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
  const float* gb = a.g + b * a.g_sb + h * a.g_sh;
  const int64_t sbase = ((int64_t)b * a.H + h) * dk * a.dv;
  const int nchunks = a.S / C;
  const uint32_t qs_u = smem_u32(qs), ks_u = smem_u32(ks);
  const uint32_t ph_u = smem_u32(ph), pl_u = smem_u32(pl), vs_u = smem_u32(vs);
  const uint32_t bar0 = smem_u32(&sm_bar[0]);            // P: bar0 + 8·par
  const uint32_t kbar = bar0 + 16, qbar = bar0 + 32;     // k: kbar + 8·buf

  // the chunk's v columns of the block, two adjacent ones a register
  uint32_t vr[SM_VPER];
  auto load_v = [&](int t0) {
#pragma unroll
    for (int r = 0; r < SM_VPER; ++r) {
      const int e = tid + r * SM_THREADS, j = e / (SM_VCOLS / 2);
      const int c = 2 * (e - j * (SM_VCOLS / 2));
      const __nv_bfloat16* row = vb + (int64_t)(t0 + j) * a.v_ss + c;
      const uint32_t x0 = (j < C && c < vcols) ? __bfloat16_as_ushort(row[0]) : 0u;
      const uint32_t x1 = (j < C && c + 1 < vcols) ? __bfloat16_as_ushort(row[1]) : 0u;
      vr[r] = x0 | (x1 << 16);
    }
  };
  // warp 0's log decays of a chunk (into registers a chunk ahead)
  float g0 = 0.f, g1 = 0.f;
  auto load_g = [&](int t0) {
    g0 = lane < C ? gb[(int64_t)(t0 + lane) * a.g_ss] : 0.f;
    g1 = lane + 32 < C ? gb[(int64_t)(t0 + lane + 32) * a.g_ss] : 0.f;
  };

  // zero the tiles (rows past C are never fetched); the mbarriers; chunk
  // 0's q, k, v and sums; then the state slice into registers
  {
    uint4* z = reinterpret_cast<uint4*>(tiles);
    const int n16 = (3 * q_bytes(dk) + 4 * SM_P_BYTES + SM_V_BYTES) / 16;
    for (int e = tid; e < n16; e += SM_THREADS) z[e] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    fetch_tile(qs_u, &qmap, qbar, 0, C, dk, h, b);
    fetch_tile(ks_u, &kmap, kbar, 0, C, dk, h, b);
  }
  if (warp == 0) {
    load_g(0);
    chunk_sums(sums, g0, g1, C, lane);
    if (nchunks > 1) load_g(C);
  }
  // st[kl][e][x]: Sᵀ[col][d], col = col0 + gq (+8 for x >= 2), d =
  // 16(kb + kl) + 8e + 2cq (+1 for odd x)
  float st[SM_MAX_KS][2][4];
#pragma unroll
  for (int kl = 0; kl < SM_MAX_KS; ++kl)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = col0 + gq + 8 * (x >> 1);
        const int d = 16 * (kb + kl) + 8 * e + 2 * cq + (x & 1);
        st[kl][e][x] = (active && kl < nks && col < a.dv)
                           ? a.s0[sbase + (int64_t)d * a.dv + col] : 0.f;
      }
  cluster_barrier();   // every block started, its barriers set

  for (int ci = 0; ci < nchunks; ++ci) {
    const int par = ci & 1, t0 = ci * C;
    const float* cum = sums + par * SM_CUMS;
    const uint32_t kc_u = ks_u + par * q_bytes(dk);
    mbar_wait(kbar + 8 * par, (ci >> 1) & 1);   // k and q of the chunk
    mbar_wait(qbar, ci & 1);
    __syncthreads();   // and the chunk before is done
    load_v(t0);        // stored after q·S: the latency hides behind it
    if (tid == 0) {
      // every block's tiles of the chunk, and a token from every block: a
      // block sends chunk t + 2's into a buffer only after every block's
      // chunk t + 1 arrived, which each block sends only after it has read
      // chunk t's, so no block runs two chunks ahead of another, whichever
      // warps compute the tiles
      mbar_expect_tx(bar0 + 8 * par, SM_PBYTES + 4 * cs);
      const uint32_t tok = smem_u32(&sm_token[par][rank]);
      for (int q = 0; q < cs; ++q)
        send4(dsmem_addr(tok, q), dsmem_addr(bar0 + 8 * par, q), 0u);
    }
    if (tid == 0 && ci + 1 < nchunks)
      fetch_tile(ks_u + (par ^ 1) * q_bytes(dk), &kmap, kbar + 8 * (par ^ 1),
                 t0 + C, C, dk, h, b);

    // the scores: tile t on slot t % n_slots, masked and decayed in f32,
    // split, sent to every block
    for (int t = slot; t >= 0 && t < SM_TILES; t += n_slots) {
      int it, jt;
      score_tile(t, it, jt);
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      const int qr = 16 * it + (lane & 15), kr = 8 * jt + (lane & 7);
      for (int kk = 0; kk < nk; kk += 2) {   // two chains of sums
        uint32_t af[4], bf[2];
        ldmatrix_x4(af, qs_u + qk_off(qr, 2 * kk + (lane >> 4)));
        ldmatrix_x2(bf, kc_u + qk_off(kr, 2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s0, af, bf[0], bf[1]);
        if (kk + 1 < nk) {
          ldmatrix_x4(af, qs_u + qk_off(qr, 2 * kk + 2 + (lane >> 4)));
          ldmatrix_x2(bf, kc_u + qk_off(kr, 2 * kk + 2 + ((lane >> 3) & 1)));
          mma_bf16(s1, af, bf[0], bf[1]);
        }
      }
      const int i0 = 16 * it + gq, j0 = 8 * jt + 2 * cq;
      float p[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = i0 + 8 * (x >> 1), j = j0 + (x & 1);
        p[x] = (j <= i && i < C) ? (s0[x] + s1[x]) * expf(cum[i] - cum[j])
                                 : 0.f;
      }
      uint32_t hi0, lo0, hi1, lo1;
      split2(p[0], p[1], hi0, lo0);
      split2(p[2], p[3], hi1, lo1);
      const uint32_t off0 =
          (uint32_t)(par * SM_C * SM_PSTR + i0 * SM_PSTR + j0) * 2;
      const uint32_t off1 = off0 + 8 * SM_PSTR * 2;
      for (int q = 0; q < cs; ++q) {
        const uint32_t rh = dsmem_addr(ph_u, q), rl = dsmem_addr(pl_u, q);
        const uint32_t rb = dsmem_addr(bar0 + 8 * par, q);
        send4(rh + off0, rb, hi0);
        send4(rl + off0, rb, lo0);
        send4(rh + off1, rb, hi1);
        send4(rl + off1, rb, lo1);
      }
    }

    // q·S over the warp's dk half: Sᵀ (hi + lo, from the state's own
    // accumulators) times qᵀ, in two passes of 32 tokens: first the other
    // half's (to the partner warp, through shared memory), then its own
    float oa[4][4];
    const int qrow = (lane & 7) + 8 * (lane >> 4), qch = (lane >> 3) & 1;
    float4* redw = reinterpret_cast<float4*>(red) + warp * 4 * 32;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int tok = 32 * (pass ? half : 1 - half);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) oa[n][x] = 0.f;
      if (active) {
#pragma unroll
        for (int kl = 0; kl < SM_MAX_KS; ++kl) {
          if (kl < nks) {
            uint32_t ahi[4], alo[4];
            split2(st[kl][0][0], st[kl][0][1], ahi[0], alo[0]);
            split2(st[kl][0][2], st[kl][0][3], ahi[1], alo[1]);
            split2(st[kl][1][0], st[kl][1][1], ahi[2], alo[2]);
            split2(st[kl][1][2], st[kl][1][3], ahi[3], alo[3]);
#pragma unroll
            for (int tp = 0; tp < 2; ++tp) {
              uint32_t bq[4];
              ldmatrix_x4(bq, qs_u + qk_off(tok + 16 * tp + qrow,
                                            2 * (kb + kl) + qch));
              mma_bf16(oa[2 * tp], ahi, bq[0], bq[1]);
              mma_bf16(oa[2 * tp], alo, bq[0], bq[1]);
              mma_bf16(oa[2 * tp + 1], ahi, bq[2], bq[3]);
              mma_bf16(oa[2 * tp + 1], alo, bq[2], bq[3]);
            }
          }
        }
      }
      if (pass == 0)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          redw[n * 32 + lane] = make_float4(oa[n][0], oa[n][1], oa[n][2],
                                            oa[n][3]);
    }
#pragma unroll
    for (int r = 0; r < SM_VPER; ++r) {
      const int e = tid + r * SM_THREADS, j = e / (SM_VCOLS / 2);
      reinterpret_cast<uint32_t*>(vs)[(j * SM_VSTR) / 2 + e - j * (SM_VCOLS / 2)] =
          vr[r];
    }
    __syncthreads();   // partials and v in; q of this chunk read
    if (tid == 0 && ci + 1 < nchunks)
      fetch_tile(qs_u, &qmap, qbar, t0 + C, C, dk, h, b);
    if (warp == 0 && ci + 1 < nchunks) {
      chunk_sums(sums + (par ^ 1) * SM_CUMS, g0, g1, C, lane);
      if (ci + 2 < nchunks) load_g(t0 + 2 * C);
    }

    if (active) {
      const float4* redp = reinterpret_cast<const float4*>(red) +
                           (warp ^ 1) * 4 * 32;
      const float* ecum = cum + SM_C;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 pv = redp[n * 32 + lane];
        const int i = 32 * half + 8 * n + 2 * cq;
        oa[n][0] = (oa[n][0] + pv.x) * ecum[i];
        oa[n][1] = (oa[n][1] + pv.y) * ecum[i + 1];
        oa[n][2] = (oa[n][2] + pv.z) * ecum[i];
        oa[n][3] = (oa[n][3] + pv.w) * ecum[i + 1];
      }
      // vᵀ fragments of the m-tile, 16 tokens j a k-step (ldmatrix.trans of
      // v's [j][column] rows)
      const uint32_t vrow = vs_u + (uint32_t)(((lane & 7) + 8 * (lane >> 4)) *
                                              SM_VSTR + 16 * mtl +
                                              8 * ((lane >> 3) & 1)) * 2;

      // P·V on the warp's tokens, once every block's scores are in
      mbar_wait(bar0 + 8 * par, (ci >> 1) & 1);
      const uint32_t prow = (uint32_t)((par * SM_C + (lane & 7)) * SM_PSTR +
                                       8 * ((lane >> 3) & 1)) * 2 +
                            ((lane >> 4) ? pl_u : ph_u);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk > 32 * half + 31) break;   // j > i for all its tokens
        uint32_t av[4];
        ldmatrix_x4_trans(av, vrow + (uint32_t)(16 * kk * SM_VSTR) * 2);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (16 * kk <= 32 * half + 8 * n + 7) {   // j <= i in the n-tile
            uint32_t bp[4];
            ldmatrix_x4(bp, prow + (uint32_t)((32 * half + 8 * n) * SM_PSTR +
                                              16 * kk) * 2);
            mma_bf16(oa[n], av, bp[0], bp[1]);
            mma_bf16(oa[n], av, bp[2], bp[3]);
          }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int tn = 4 * half + n;       // the 8-token n-tile
        const int i = 8 * tn + 2 * cq;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int col = col0 + gq + 8 * (x >> 1), ii = i + (x & 1);
          if (col < a.dv && ii < C)
            ob[(int64_t)(t0 + ii) * a.o_ss + col] = __float2bfloat16(oa[n][x]);
        }
      }

      // the state: Sᵀ <- exp(total)·Sᵀ + (w ∘ v)ᵀ (hi + lo) · k over the
      // warp's dk half
      const float etot = cum[3 * SM_C];
      const float* w = cum + 2 * SM_C;
#pragma unroll
      for (int kl = 0; kl < SM_MAX_KS; ++kl)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int x = 0; x < 4; ++x) st[kl][e][x] *= etot;
      const int krow = (lane & 7) + 8 * ((lane >> 3) & 1), kch = lane >> 4;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= C) break;
        const int j = 16 * kk + 2 * cq;
        const float w0 = w[j], w1 = w[j + 1], w2 = w[j + 8], w3 = w[j + 9];
        uint32_t av[4], ahi[4], alo[4];
        ldmatrix_x4_trans(av, vrow + (uint32_t)(16 * kk * SM_VSTR) * 2);
        const float2 v0 = unpack2(av[0]), v1 = unpack2(av[1]);
        const float2 v2 = unpack2(av[2]), v3 = unpack2(av[3]);
        split2(v0.x * w0, v0.y * w1, ahi[0], alo[0]);
        split2(v1.x * w0, v1.y * w1, ahi[1], alo[1]);
        split2(v2.x * w2, v2.y * w3, ahi[2], alo[2]);
        split2(v3.x * w2, v3.y * w3, ahi[3], alo[3]);
#pragma unroll
        for (int kl = 0; kl < SM_MAX_KS; ++kl)
          if (kl < nks) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, kc_u + qk_off(16 * kk + krow,
                                                2 * (kb + kl) + kch));
            mma_bf16(st[kl][0], ahi, bk[0], bk[1]);
            mma_bf16(st[kl][0], alo, bk[0], bk[1]);
            mma_bf16(st[kl][1], ahi, bk[2], bk[3]);
            mma_bf16(st[kl][1], alo, bk[2], bk[3]);
          }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int kl = 0; kl < SM_MAX_KS; ++kl)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int col = col0 + gq + 8 * (x >> 1);
          const int d = 16 * (kb + kl) + 8 * e + 2 * cq + (x & 1);
          if (kl < nks && col < a.dv)
            a.sf[sbase + (int64_t)d * a.dv + col] = st[kl][e][x];
        }
  }
  cluster_barrier();   // no block leaves while another may still send to it
}

// The plan's rules (the wrapper's planner keeps the same ones): every
// block owns 1..SM_MAX_MT m-tiles of dv.
bool mma_valid(const MmaArgs& a) {
  const int n_mt = (a.dv + 15) / 16;
  return a.B >= 1 && a.H >= 1 && a.S >= 1 && a.dk >= 16 && a.dk % 16 == 0 &&
         a.dk <= SM_MAX_DK && a.dv >= 1 && a.chunk >= 1 && a.chunk <= SM_C &&
         a.S % a.chunk == 0 && a.B <= 65535 && a.H <= 65535 && a.cs >= 1 &&
         a.cs <= SM_MAX_CLUSTER && a.cs <= n_mt &&
         a.cs * SM_MAX_MT >= n_mt;
}

// Launch (maps given) or count the clusters the card holds at once (n).
cudaError_t mma_run(const MmaArgs& a, int* n, cudaStream_t stream,
                    const CUtensorMap* qm = nullptr,
                    const CUtensorMap* km = nullptr) {
  const int smem = (int)mma_smem_bytes(a.dk);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)mma_smem_bytes(SM_MAX_DK));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ssm_scan_mma_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(a.cs, a.H, a.B);
  cfg.blockDim = dim3(SM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (n != nullptr)
    return cudaOccupancyMaxActiveClusters(n, ssm_scan_mma_kernel, &cfg);
  cudaError_t e = cudaLaunchKernelEx(&cfg, ssm_scan_mma_kernel, *qm, *km, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// q, k (B, H, S, dk) bf16 with 16-byte aligned bases and strides and a unit
// innermost one (TMA); v (B, H, S, dv) and o (B, H, S, dv) bf16, any
// strides with a unit innermost one; log_g (B, H, S) f32, any strides;
// state and final (B, H, dk, dv) f32, contiguous.  16 <= dk <= 384,
// dk % 16 == 0; 1 <= chunk <= 64, S % chunk == 0; clusters of cs blocks
// (1..16), each owning 1..5 16-column m-tiles of dv.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernel does
// not take (the wrapper checks first and raises with the reason).
extern "C" int ssm_scan_mma_fwd(const void* q, const void* k, const void* v,
                                const float* log_g, const float* state,
                                void* o, float* final_state, int B, int H,
                                int S, int dk, int dv, int chunk, int cs,
                                long long q_sb, long long q_sh, long long q_ss,
                                long long k_sb, long long k_sh, long long k_ss,
                                long long v_sb, long long v_sh, long long v_ss,
                                long long g_sb, long long g_sh, long long g_ss,
                                long long o_sb, long long o_sh, long long o_ss,
                                void* stream) {
  const MmaArgs a{static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), log_g, state,
                  static_cast<__nv_bfloat16*>(o), final_state, B, H, S, dk,
                  dv, chunk, cs, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                  v_sh, v_ss, g_sb, g_sh, g_ss, o_sb, o_sh, o_ss};
  if (!mma_valid(a)) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km;
  if (!make_map(&qm, enc, q, B, H, S, dk, q_sb, q_sh, q_ss, chunk) ||
      !make_map(&km, enc, k, B, H, S, dk, k_sb, k_sh, k_ss, chunk))
    return (int)cudaErrorInvalidValue;
  return (int)mma_run(a, nullptr, static_cast<cudaStream_t>(stream), &qm, &km);
}

// How many clusters of cs blocks at dk the current device holds at once,
// into *n (the wrapper's planner reads it).
extern "C" int ssm_scan_mma_max_clusters(int dk, int dv, int cs, int* n) {
  MmaArgs a{};
  a.B = a.H = a.S = a.chunk = 1;
  a.dk = dk;
  a.dv = dv;
  a.cs = cs;
  if (!mma_valid(a)) return (int)cudaErrorInvalidValue;
  return (int)mma_run(a, n, nullptr);
}
