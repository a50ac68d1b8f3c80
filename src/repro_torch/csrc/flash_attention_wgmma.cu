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

constexpr int WG_BQ = 64;          // query rows per block
constexpr int WG_BK = 64;          // keys per K/V tile
constexpr int BOX_COLS = 64;       // 64 bf16 = 128 B, one swizzle span
static_assert(BOX_COLS == TMA_BOX_COLS, "make_map cuts boxes of BOX_COLS");
constexpr float LOG2E = 1.4426950408889634f;

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

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// --- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major tiles (Q, K):
// 8-row core groups 1024 B apart (SBO), LBO unused.  N-major tiles (V):
// 8-key groups 1024 B apart (SBO), 64-column atoms LBO apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (it sees only the issuing asm).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void u32_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory
// (both K-major, 128-byte swizzle); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (four bf16
// pairs per thread), B from shared memory N-major (transposed, 128-byte
// swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (four bf16
// pairs per thread), B from shared memory N-major (transposed, 128-byte
// swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

// 2^x on the SFU (ex2.approx.ftz: ~2 ulp, results below 2^-126 flush to
// 0); exp2f adds a denormal fix-up per element.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one K tile, over hd in k-steps of 16 (32 B inside a 128-B
// swizzle row; hd 128 steps into the second 64-column box at k-step 4).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sq,
                                         uint32_t ks) {
  reg_fence(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t box = kk / 4, within = (kk % 4) * 32;
    wgmma_ss_n64(s, sw128_desc(sq + box * WG_BQ * 128 + within, 16, 1024),
                 sw128_desc(ks + box * WG_BK * 128 + within, 16, 1024),
                 kk > 0);
  }
}

// O += P V of one V tile, over its keys in k-steps of 16 (16 rows of
// 128 B); hd 128 spans both 64-column boxes through LBO.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&pa)[WG_BK / 16][4],
                                         uint32_t vs) {
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk)
    wgmma_rs(acc, pa[kk], sw128_desc(vs + kk * 16 * 128, WG_BK * 128, 1024));
}

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

// p (f32, in the S fragment) rounded to bf16 into the A fragments of the
// PV wgmma: the S fragment of keys 16kk..16kk+15 is k-step kk's A
// fragment, pair by pair.
__device__ __forceinline__ void to_a_fragments(const float (&p)[32],
                                               uint32_t (&pa)[WG_BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < 32; j += 2) pa[j / 8][(j % 8) / 2] = pack_bf16(p[j], p[j + 1]);
}

// --- the kernel ------------------------------------------------------------------

template <int HD, int NWG>
__global__ void __launch_bounds__(Layout<HD, NWG>::THREADS, 3 - NWG)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, int group, int Sq, int Skv,
                   int64_t o_sb, int64_t o_sh, int64_t o_ss, int causal,
                   int window, float softcap, float scale) {
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
  uint32_t pa[WG_BK / 16][4];

  mbar_wait(q_full, 0);
  for (int i = wg; i < n_tiles; i += NWG) {
    const int st = i % L::STAGES, par = (i / L::STAGES) & 1;
    mbar_wait(k_full(st), par);
    issue_qk<HD>(s, sq, sk + st * L::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    rows.softmax(s, m, l, alpha, (t_begin + i) * WG_BK);
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j] *= alpha[(j >> 1) & 1];
    to_a_fragments(s, pa);
    mbar_wait(v_full(st), par);
    issue_pv<HD>(acc, pa, sv + st * L::KV_BYTES);
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
                       const CUtensorMap& vm, void* o, int B, int H,
                       int group, int Sq, int Skv, const long long* ost,
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
      qm, km, vm, static_cast<__nv_bfloat16*>(o), group, Sq, Skv, ost[0],
      ost[1], ost[2], causal, window, softcap, scale);
  return cudaGetLastError();
}

// A grid that fills two blocks per SM takes one consumer warpgroup per
// block (two blocks share an SM, one's softmax beside the other's
// products).  A smaller grid (the 2B's 12 heads x 17 tiles = 204 blocks on
// 132 SMs) leaves the heaviest block's chain of tiles as the critical
// path: two warpgroups per block then take its tiles in turn, halving it.
template <int HD>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, void* o, int B, int H, int group,
                   int Sq, int Skv, const long long* ost, int causal,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)H * B * ((Sq + WG_BQ - 1) / WG_BQ);
  if (blocks >= 2ll * sms)
    return launch_nwg<HD, 1>(qm, km, vm, o, B, H, group, Sq, Skv, ost,
                             causal, window, softcap, scale, stream);
  return launch_nwg<HD, 2>(qm, km, vm, o, B, H, group, Sq, Skv, ost, causal,
                           window, softcap, scale, stream);
}

}  // namespace

// q (B,H,Sq,hd), k/v (B,KH,Skv,hd), o (B,H,Sq,hd), all bfloat16, hd 64 or
// 128; element strides with a unit innermost one.  q, k and v need 16-byte
// aligned bases and strides (TMA); o is written with 4-byte stores.
// softcap <= 0 means no softcap.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernel does not take (the wrapper
// checks first and raises with the reason).
extern "C" int flash_attention_wgmma_fwd(
    const void* q, const void* k, const void* v, void* o,
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
      ? launch<64>(qm, km, vm, o, B, H, H / KH, Sq, Skv, ost, causal, window,
                   softcap, scale, s)
      : launch<128>(qm, km, vm, o, B, H, H / KH, Sq, Skv, ost, causal, window,
                    softcap, scale, s);
  return (int)e;
}
