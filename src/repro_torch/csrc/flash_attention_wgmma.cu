// Causal GQA flash-attention forward on Hopper's tensor cores (sm_90a):
// wgmma for QK^T and PV, TMA for the Q, K and V tiles.  bfloat16 in and
// out, float32 accumulation; head dims 64 and 128.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the prefill of [regions | prompt] in models/layers.py, mode="prefill"),
// on the route kernels/flash_attention.py::route gives bf16 at hd 64/128.
// float32 and the other head dims stay on flash_attention.cu.
//
// What bounds it on this card: operations.  At the 7B's shape (B 1, H 28,
// Sq = Skv = 1025, hd 128, causal) the two products are 4·hd·H·S(S+1)/2 =
// 7.54 GFLOP against ~4 MB of Q/K/V/O: 0.0076 ms at 989 TFLOP/s (bf16
// dense), 0.0012 ms at 3.35 TB/s.
//
// What the design does about it:
//  * S = Q·K^T and O += P·V run as wgmma.mma_async m64nNk16 (bf16 in, f32
//    accumulate).  S: A = the Q tile, B = the K tile, both from shared
//    memory, K-major (hd contiguous).  PV: A = P from registers, B = the V
//    tile from shared memory, N-major (V is [key][hd]), transpose bit set.
//  * One block per (64-query tile, head, batch row).  Consumer warpgroups
//    own the 64 rows; the last warp is the producer: its lane 0 loads Q
//    once and keeps K/V tiles (64 keys) in flight through TMA into a ring
//    of stages, an mbarrier per stage for "K full", "V full" and "empty".
//  * The block shape follows the grid (Layout, launch): a grid of at
//    least two blocks per SM (the 7B: 28 heads x 17 tiles = 476) takes one
//    consumer warpgroup and two stages per block, 80 KB at hd 128, two
//    blocks per SM, one block's softmax beside the other's products.  A
//    smaller grid (the 2B: 204 blocks) takes two consumer warpgroups per
//    block that take its K/V tiles in turn (four stages) and merge their
//    (m, l, acc) at the end: the heaviest block's chain of tiles, the
//    critical path there, halves.
//  * The tensor maps take the operands' own strides (the model's (B, S, H,
//    hd) tensors arrive as (B, H, S, hd) views): no copy.  Tiles are 64
//    columns wide (128 B) with 128-byte swizzling; an hd-128 tile is two
//    such boxes and the wgmma descriptors step between them.  TMA zero-
//    fills rows past Sq/Skv, so the ragged edge needs no padding; keys
//    >= Skv are still masked (a zero key scores 0, not -inf).
//  * Softmax runs on the accumulator fragments in base 2: a thread holds
//    two rows (16·warp + lane/4 and +8); row max and sum reduce over the
//    lane quad.  p is rounded to bf16 into the A fragments of the PV wgmma
//    (the S fragment of keys 16j..16j+15 is the A fragment of k-step j,
//    pair by pair).  l is summed from the f32 p.
//  * Only tiles that cross the causal diagonal, the window floor or Skv
//    are masked; tiles above the diagonal or below the window are never
//    loaded (block-uniform bounds).  The grid runs heads fastest and the
//    last (heaviest) query tiles first, so the causal tail does not
//    straggle.
//  * Causal alignment is bottom-right (row i sees keys <= i + Skv - Sq),
//    the plain version's; p = where(mask, exp(s - m), 0) and the final
//    acc / max(l, 1e-30) as the TPU kernel; logit softcap (applied before
//    the mask) and sliding window are kept.
//
// For training it also writes each row's logsumexp (lse, the JAX
// package's residual (q, k, v, out, lse) of ref._fs_fwd): the tensor-core
// backward (flash_attention_bwd_wgmma.cu) reads it instead of recomputing
// QK^T.  Inference passes a null lse and writes nothing more.
//
// What it rounds: p to bf16 before PV (as every flash kernel and SDPA do),
// so it is held to |got - want| <= 1e-5 + 2^-6·|want| + 2^-8·A with
// A = attention(q, k, |v|), not to two bf16 ulps of the f32 plain version.
// bf16's unit roundoff is 2^-8, so 2^-8·A is the worst case of the p
// rounding alone; the roundings take both signs, and the shares of the
// bound measured on the card (chip_smoke.py, phases 2 and 4) are what
// show the bound holds with room.
//
// Host side: the three tensor maps are encoded on every call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
// -lcuda); the wrapper checks TMA's rules (16-byte aligned base and
// strides) and raises before the launch.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int WG_BQ = WG_ROWS;     // query rows per block
constexpr int WG_BK = WG_ROWS;     // keys per K/V tile
constexpr int BOX_COLS = 64;       // 64 bf16 = 128 B, one swizzle span
static_assert(BOX_COLS == TMA_BOX_COLS, "make_map cuts boxes of BOX_COLS");

// NWG consumer warpgroups share the block's 64 query rows and take its K/V
// tiles in turn (tile i to warpgroup i % NWG); one producer warp follows
// them.  NWG 1: two K/V stages, two blocks per SM.  NWG 2: four stages
// (two per warpgroup), one block per SM, and warpgroup 1 hands its
// partial (m, l, acc) to warpgroup 0 at the end.
template <int HD, int NWG>
struct Layout {
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int STAGES = 2 * NWG;
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int Q_BOX = WG_BQ * 128;        // bytes of one 64-col box
  static constexpr int KV_BOX = WG_BK * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[S], v_full[S], empty[S]; then warpgroup 1's hand-over
  static constexpr int MERGE_OFF = BAR_OFF + 8 * (1 + 3 * STAGES);
  static constexpr int BYTES =
      MERGE_OFF + (NWG > 1 ? 128 * (HD / 2 + 4) * 4 : 0);
  static constexpr int ALLOC = BYTES + 1024;       // room to align to 1 KB
};

// One thread's two query rows and the softmax on its S fragment: element
// j sits at row qk + 8·((j >> 1) & 1) (in key coordinates) and key column
// k0 + 8·(j / 4) + c0 + (j & 1).
struct Rows {
  int qk, c0, Skv, causal, window, row_lo, row_hi;
  float softcap, scale;

  // Scale, softcap, then mask (only a tile that crosses the diagonal, the
  // window floor or Skv) in base 2; fold the tile into (m, l); leave p
  // (f32) in s.  m starts at a finite -1e30 and masked scores are -inf, so
  // a row masked so far keeps alpha = 1 and p = 0: p = where(mask,
  // exp(s - m), 0).
  __device__ __forceinline__ void softmax(float (&s)[32], float (&m)[2],
                                          float (&l)[2], float (&alpha)[2],
                                          int k0) const {
    bool need_mask = k0 + WG_BK > Skv;
    if (causal) need_mask |= k0 + WG_BK - 1 > row_lo;
    if (window > 0) need_mask |= k0 <= row_hi - window;
    const float sl2 = scale * LOG2E, cap_l2 = softcap * LOG2E;
    const float over_cap = softcap > 0.f ? scale / softcap : 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = softcap > 0.f ? cap_l2 * tanhf(s[j] * over_cap) : s[j] * sl2;
      if (need_mask) {
        const int col = k0 + 8 * (j / 4) + c0 + (j & 1);
        const int row = qk + 8 * ((j >> 1) & 1);
        bool ok = col < Skv;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        x = ok ? x : -INFINITY;
      }
      s[j] = x;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {             // the row's four lanes
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      s[j] = fast_exp2(s[j] - m[r]);
      l[r] += s[j];
    }
  }
};

// --- the kernel ------------------------------------------------------------------

template <int HD, int NWG>
__global__ void __launch_bounds__(Layout<HD, NWG>::THREADS, 3 - NWG)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int group, int Sq, int Skv, int64_t o_sb, int64_t o_sh,
                   int64_t o_ss, int causal, int window, float softcap,
                   float scale) {
  using L = Layout<HD, NWG>;
  constexpr int ND = HD / 2;                  // O floats per thread
  extern __shared__ uint8_t wg_smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(wg_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms need 1 KB
  const uint32_t sq = base, sk = base + L::K_OFF, sv = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + L::STAGES + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * L::STAGES + s); };

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;   // heaviest first
  const int kvh = h / group;
  const int off = Skv - Sq;                   // bottom-right causal offset

  // keys this block can see, in key coordinates (block-uniform)
  const int row_lo = q0 + off;
  const int row_hi = min(q0 + WG_BQ, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, row_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, row_lo - window + 1) : 0;
  const int t_begin = kv_begin / WG_BK;
  const int n_tiles = max(0, (kv_end + WG_BK - 1) / WG_BK - t_begin);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128);               // the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * NWG) {
    // ---- producer: the last warp, one lane ----
    if (tid == 128 * NWG) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < L::BOXES; ++c)
        tma_load(sq + c * L::Q_BOX, &qmap, q_full, c * BOX_COLS, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % L::STAGES, k0 = (t_begin + i) * WG_BK;
        if (i >= L::STAGES) mbar_wait(empty(st), ((i / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(st), L::KV_BYTES);
        for (int c = 0; c < L::BOXES; ++c)
          tma_load(sk + st * L::KV_BYTES + c * L::KV_BOX, &kmap, k_full(st),
                   c * BOX_COLS, k0, kvh, b);
        mbar_expect_tx(v_full(st), L::KV_BYTES);
        for (int c = 0; c < L::BOXES; ++c)
          tma_load(sv + st * L::KV_BYTES + c * L::KV_BOX, &vmap, v_full(st),
                   c * BOX_COLS, k0, kvh, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes tiles wg, wg + NWG, ... ----
  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int r0 = 16 * warp + (lane >> 2);     // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);              // and columns 8i + c0 + {0, 1}
  const Rows rows{q0 + r0 + off, c0, Skv, causal, window, row_lo, row_hi,
                  softcap, scale};
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  float s[32], alpha[2];
  uint32_t pa[4][4];

  mbar_wait(q_full, 0);
  for (int i = wg; i < n_tiles; i += NWG) {
    const int st = i % L::STAGES, par = (i / L::STAGES) & 1;
    mbar_wait(k_full(st), par);
    wgmma_tile_abt<HD>(s, sq, sk + st * L::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    rows.softmax(s, m, l, alpha, (t_begin + i) * WG_BK);
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j] *= alpha[(j >> 1) & 1];
    to_a_fragments(s, pa);
    mbar_wait(v_full(st), par);
    wgmma_tile_pb<HD>(acc, pa, sv + st * L::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    u32_fence(pa);                            // PV read pa until here
    mbar_arrive(empty(st));
  }

  if (NWG > 1) {
    // warpgroup 1's thread of the same index holds the same rows and
    // columns: it hands over (m, l, acc) and warpgroup 0 folds them in
    float* mg = reinterpret_cast<float*>(wg_smem_raw + (base - raw) +
                                         L::MERGE_OFF) + (tid & 127) * (ND + 4);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < ND; ++j) mg[j] = acc[j];
      mg[ND] = m[0]; mg[ND + 1] = m[1]; mg[ND + 2] = l[0]; mg[ND + 3] = l[1];
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");   // consumers only
    if (wg == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = mg[ND + r], mm = fmaxf(m[r], m1);
      a0[r] = fast_exp2(m[r] - mm);
      a1[r] = fast_exp2(m1 - mm);
      l[r] = l[r] * a0[r] + mg[ND + 2 + r] * a1[r];
      m[r] = mm;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
      acc[j] = acc[j] * a0[(j >> 1) & 1] + mg[j] * a1[(j >> 1) & 1];
  }

  // final acc / max(l, 1e-30); l reduces over the lane quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  // the backward's residual: lse = m·ln 2 + log(l) per row (m is in base
  // 2), rows of lse_rows(Sq) floats, the padding past Sq written as 0
  if (lse != nullptr && (lane & 3) == 0) {
    float* lrow = lse + ((int64_t)b * gridDim.x + h) * lse_rows(Sq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + r0 + 8 * r;
      lrow[qi] = qi < Sq ? m[r] * LN2 + logf(l[r]) : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* orow = o + b * o_sb + h * o_sh + qi * o_ss;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const float x0 = acc[4 * i + 2 * r] / l[r];
      const float x1 = acc[4 * i + 2 * r + 1] / l[r];
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + c0) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// --- host side ---------------------------------------------------------------------

template <int HD, int NWG>
cudaError_t launch_nwg(const CUtensorMap& qm, const CUtensorMap& km,
                       const CUtensorMap& vm, void* o, float* lse, int B,
                       int H, int group, int Sq, int Skv, const long long* ost,
                       int causal, int window, float softcap, float scale,
                       cudaStream_t stream) {
  using L = Layout<HD, NWG>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(flash_wgmma_kernel<HD, NWG>, L::ALLOC);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(H, (Sq + WG_BQ - 1) / WG_BQ, B);
  flash_wgmma_kernel<HD, NWG><<<grid, L::THREADS, L::ALLOC, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, group, Sq, Skv,
      ost[0], ost[1], ost[2], causal, window, softcap, scale);
  return cudaGetLastError();
}

// A grid that fills two blocks per SM takes one consumer warpgroup per
// block (two blocks share an SM, one's softmax beside the other's
// products).  A smaller grid (the 2B's 12 heads x 17 tiles = 204 blocks on
// 132 SMs) leaves the heaviest block's chain of tiles as the critical
// path: two warpgroups per block then take its tiles in turn, halving it.
template <int HD>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, void* o, float* lse, int B, int H,
                   int group, int Sq, int Skv, const long long* ost, int causal,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)H * B * ((Sq + WG_BQ - 1) / WG_BQ);
  if (blocks >= 2ll * sms)
    return launch_nwg<HD, 1>(qm, km, vm, o, lse, B, H, group, Sq, Skv, ost,
                             causal, window, softcap, scale, stream);
  return launch_nwg<HD, 2>(qm, km, vm, o, lse, B, H, group, Sq, Skv, ost,
                           causal, window, softcap, scale, stream);
}

}  // namespace

// q (B,H,Sq,hd), k/v (B,KH,Skv,hd), o (B,H,Sq,hd), all bfloat16, hd 64 or
// 128; element strides with a unit innermost one.  q, k and v need 16-byte
// aligned bases and strides (TMA); o is written with 4-byte stores.  lse,
// when not null, receives each row's logsumexp (natural log, f32) in rows
// of lse_rows(Sq) floats, (B, H, lse_rows(Sq)) contiguous, the padding 0:
// the residual the tensor-core backward reads.  Inference passes null.
// softcap <= 0 means no softcap.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernel does not take (the wrapper
// checks first and raises with the reason).
extern "C" int flash_attention_wgmma_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int KH, int Sq, int Skv, int hd,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float softcap, float scale, void* stream) {
  if ((hd != 64 && hd != 128) || KH < 1 || H % KH != 0 || Sq < 1 || Sq > Skv)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, enc, q, B, H, Sq, hd, q_sb, q_sh, q_ss, WG_BQ) ||
      !make_map(&km, enc, k, B, KH, Skv, hd, k_sb, k_sh, k_ss, WG_BK) ||
      !make_map(&vm, enc, v, B, KH, Skv, hd, v_sb, v_sh, v_ss, WG_BK))
    return (int)cudaErrorInvalidValue;
  const long long ost[3] = {o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = hd == 64
      ? launch<64>(qm, km, vm, o, static_cast<float*>(lse), B, H, H / KH, Sq,
                   Skv, ost, causal, window, softcap, scale, s)
      : launch<128>(qm, km, vm, o, static_cast<float*>(lse), B, H, H / KH,
                    Sq, Skv, ost, causal, window, softcap, scale, s);
  return (int)e;
}
