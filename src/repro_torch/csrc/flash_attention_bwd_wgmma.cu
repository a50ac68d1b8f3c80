// Causal GQA flash-attention backward on Hopper's tensor cores (sm_90a):
// wgmma for the products, TMA for the tiles.  bfloat16 in and out, float32
// accumulation; head dims 64 and 128.
//
// Replaces: src/repro/kernels/ref.py::flash_structured's custom VJP
// (_fs_bwd, the blockwise-recompute flash backward the JAX package trains
// through; the JAX package has no Pallas backward), on the route
// kernels/flash_attention.py::bwd_route gives bf16 at hd 64/128 (the 2B's
// and the 7B's training).  float32 and the other head dims stay on
// flash_attention_bwd.cu (CUDA cores).
//
// What bounds it on this card: operations.  The gradient needs five
// S x S x hd products per (batch row, head) over the causal half (S, dP,
// dV, dK, dQ: 2.5x the forward's two), against a few MB of Q/K/V/O/dO.  At
// the 2B's det batch (B 4, H 12, KH 2, S 2048, hd 128) that is 129 GFLOP:
// 0.130 ms at 989 TFLOP/s (bf16 dense), 0.015 ms at 3.35 TB/s.
//
// What the design does about it: three launches on one stream (four when
// the group's heads are split), no atomics, so every gradient is the same
// bits from run to run.
//  (i)   bwd_delta_kernel: delta = rowsum(dO·O) in f32, a warp a row
//        (memory-bound: dO and O read once).  lse is not recomputed: the
//        forward (flash_attention_wgmma.cu) wrote it, the JAX package's
//        residual (q, k, v, out, lse).
//  (ii)  bwd_dkdv_kernel, one block per (64-key tile, KV head, batch row,
//        split of the group's heads), the key tiles most queries see
//        first.  The tile's K and V stay in shared memory; the producer
//        warp keeps (Q, dO, lse, delta) tiles of 64 query rows in flight
//        through TMA, a ring of stages with mbarriers as in the forward.
//        The (query tile, head) pairs are a loop, so the GQA sum over a
//        block's heads needs neither an atomic nor scratch.  Per pair:
//        S^T = K·Q^T and dP^T = V·dO^T (SS wgmma, both K-major), P^T =
//        exp(S^T - lse) and dS^T = P^T∘(dP^T - delta) in f32 on the
//        accumulator fragments (softcap factor 1 - tanh², masks only on
//        tiles that cross the diagonal, the window floor or an edge), then
//        dV += P^T·dO and dK += dS^T·Q (RS wgmma: P and dS rounded to bf16
//        into A fragments, dO and Q read N-major through the transpose bit,
//        as V in the forward's PV).  The block holds dK and dV in
//        registers (242 a thread at hd 128: one block a SM).  Unsplit, the
//        causal mask gives the first key tile Sq/64 times the last one's
//        work, and at the 2B's vqa/cls shape (136 blocks) the pass lasts
//        as long as its heaviest block (measured on an H100: 0.218 ms,
//        2.1 µs for each of that block's 102 pairs).  Split over d blocks
//        (the wrapper's ``bwd_splits`` picks d), the chain shortens d-fold
//        (0.133 ms at d 2); each block writes f32 partials and
//  (ii') bwd_dkdv_sum_kernel adds them in split order and rounds to bf16.
//  (iii) bwd_dq_kernel, the forward's layout: one block per (64-query tile,
//        head, batch row), the heaviest query tiles first; Q and dO loaded
//        once, K/V tiles through the forward's TMA ring; S = Q·K^T and
//        dP = dO·V^T (SS), dS in f32, dQ += dS·K (RS, K N-major).
// It does seven products where a kernel that summed dQ with atomics would
// do five: determinism costs 40% more work.  Query tiles outside a key
// tile's causal or window range, and key tiles outside a query tile's, are
// never loaded.  lse and delta are rows of lse_rows(Sq) floats, so each
// tile's 64 values are one bulk copy; a padded row is masked.  dK and dQ
// end scaled by the softmax scale.
//
// What it rounds: P and dS to bf16 before the three RS products (as SDPA's
// and every flash backward do), so it is held to |got - want| <= 1e-4·G +
// 2^-6·|want| + 2^-8·A, A the same products over absolute values
// (chip_smoke.py's check_bwd_wgmma): bf16's unit roundoff is 2^-8, so
// 2^-8·A is the worst case of the two roundings alone.
//
// Host side: the four tensor maps (Q, K, V, dO) are encoded on every call
// (sm90.cuh's make_map); the wrapper checks TMA's 16-byte rule and the lse
// layout and raises before the launch.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BT = WG_ROWS;                 // rows of every tile (queries, keys)
constexpr int ROWS_BYTES = 2 * BT * 4;      // a tile's lse and delta, f32

// --- (i) delta ------------------------------------------------------------------

constexpr int DELTA_WARPS = 8;

// delta = rowsum(dO·O) of every row of (B, H, lse_rows(Sq)), 0 past Sq.
template <int HD>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 float* __restrict__ delta, int H, int Sq, long long n_rows,
                 int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t d_sb,
                 int64_t d_sh, int64_t d_ss) {
  const long long row =
      (long long)blockIdx.x * DELTA_WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31, rows = lse_rows(Sq);
  const int i = (int)(row % rows);
  const long long bh = row / rows;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float acc = 0.f;
  if (i < Sq) {
    const __nv_bfloat16* orow = o + b * o_sb + h * o_sh + i * o_ss;
    const __nv_bfloat16* drow = dout + b * d_sb + h * d_sh + i * d_ss;
#pragma unroll
    for (int d = 2 * lane; d < HD; d += 64) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(orow + d));
      const float2 g = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(drow + d));
      acc += a.x * g.x + a.y * g.y;
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// --- what the two product kernels share ----------------------------------------

struct Mask {
  int Sq, Skv, off, causal, window;

  // key j visible to query row i (tile coordinates added in)
  __device__ __forceinline__ bool visible(int i, int j) const {
    bool ok = i < Sq && j < Skv;
    if (causal) ok = ok && j <= i + off;
    if (window > 0) ok = ok && j > i + off - window;
    return ok;
  }

  // does the (query tile q0, key tile k0) pair hold an invisible pair?
  __device__ __forceinline__ bool crosses(int q0, int k0) const {
    bool need = q0 + BT > Sq || k0 + BT > Skv;
    if (causal) need |= k0 + BT - 1 > q0 + off;
    if (window > 0) need |= k0 <= q0 + BT - 1 + off - window;
    return need;
  }
};

// One element of the gradient's recompute from the raw score s = q·k:
// returns p = exp(x - lse) (0 where masked) and leaves ds = p·(dp - delta)
// (times 1 - tanh² under a softcap) in dp.  x is the scaled, capped logit.
__device__ __forceinline__ float grad_elem(float s, float& dp, float lse,
                                           float delta, float softcap,
                                           float scale, bool ok) {
  float x = s * scale, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dcap = 1.f - t * t;
  }
  const float p = ok ? fast_exp2((x - lse) * LOG2E) : 0.f;
  dp = p * (dp - delta) * dcap;
  return p;
}

// --- (ii) dK and dV by key tile --------------------------------------------------

// One consumer warpgroup takes the block's (query tile, head) pairs; one
// producer warp follows it.
template <int HD>
struct KvLayout {
  static constexpr int THREADS = 128 + 32;
  static constexpr int STAGES = 2;
  static constexpr int TILE = (HD / 64) * WG_BOX;   // one 64-row tile
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = TILE;
  static constexpr int STAGE_OFF = 2 * TILE;        // stage s: Q, then dO
  static constexpr int ROWS_OFF = STAGE_OFF + STAGES * 2 * TILE;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * ROWS_BYTES;
  // kv_full, full[S], empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;        // room to align to 1 KB
};

// Block (kvh·splits + split, b, z): key tile z (z 0, the one the most
// query tiles see, first) of KV head kvh, and the group's heads split,
// split + splits, ...  With splits 1 it writes dK (scaled) and dV in bf16;
// else its f32 sums go to ``part`` (dK then dV, each (splits, B, KH, Skv,
// hd)) for bwd_dkdv_sum_kernel.
template <int HD>
__global__ void __launch_bounds__(KvLayout<HD>::THREADS, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap domap,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                int H, int group, int splits, Mask mk, int64_t dk_sb,
                int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh,
                int64_t dv_ss, float softcap, float scale) {
  using L = KvLayout<HD>;
  constexpr int ND = HD / 2;                  // dK (and dV) floats per thread
  constexpr int BOXES = HD / 64;
  extern __shared__ uint8_t bw_smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(bw_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = bw_smem_raw + (base - raw);
  const uint32_t sk = base + L::K_OFF, sv = base + L::V_OFF;
  const uint32_t kv_full = base + L::BAR_OFF;
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + L::STAGES + s); };
  auto q_tile = [&](int s) { return base + L::STAGE_OFF + s * 2 * L::TILE; };
  auto do_tile = [&](int s) { return q_tile(s) + L::TILE; };

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x / splits, split = blockIdx.x % splits;
  const int b = blockIdx.y, k0 = blockIdx.z * BT;
  const int KH = gridDim.x / splits, heads = group / splits;
  const int R = lse_rows(mk.Sq);

  // query rows that see some key of the tile (block-uniform)
  const int kmax = min(k0 + BT, mk.Skv) - 1;
  const int i_begin = mk.causal ? max(0, k0 - mk.off) : 0;
  const int i_end = mk.window > 0 ? min(mk.Sq, kmax + mk.window - mk.off)
                                  : mk.Sq;
  const int t_begin = i_begin / BT;
  const int n_t = i_end > i_begin ? (i_end + BT - 1) / BT - t_begin : 0;
  const int n_pairs = heads * n_t;            // heads fastest

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);               // the consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer: the last warp, one lane ----
    if (tid == 128 && n_pairs > 0) {
      mbar_expect_tx(kv_full, 2 * L::TILE);
      for (int c = 0; c < BOXES; ++c) {
        tma_load(sk + c * WG_BOX, &kmap, kv_full, c * 64, k0, kvh, b);
        tma_load(sv + c * WG_BOX, &vmap, kv_full, c * 64, k0, kvh, b);
      }
      for (int i = 0; i < n_pairs; ++i) {
        const int st = i % L::STAGES;
        if (i >= L::STAGES) mbar_wait(empty(st), ((i / L::STAGES) & 1) ^ 1);
        const int q0 = (t_begin + i / heads) * BT;
        const int h = kvh * group + split + splits * (i % heads);
        mbar_expect_tx(full(st), 2 * L::TILE + ROWS_BYTES);
        for (int c = 0; c < BOXES; ++c) {
          tma_load(q_tile(st) + c * WG_BOX, &qmap, full(st), c * 64, q0, h,
                   b);
          tma_load(do_tile(st) + c * WG_BOX, &domap, full(st), c * 64, q0,
                   h, b);
        }
        const long long at = ((long long)b * H + h) * R + q0;
        const uint32_t rows = base + L::ROWS_OFF + st * ROWS_BYTES;
        bulk_load(rows, lse + at, BT * 4, full(st));
        bulk_load(rows + BT * 4, delta + at, BT * 4, full(st));
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, the tile's 64 keys ----
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = 16 * warp + (lane >> 2);     // this thread's keys: r0, r0 + 8
  const int c0 = 2 * (lane & 3);              // its queries: 8i + c0 + {0, 1}
  float dka[ND], dva[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) dka[j] = dva[j] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4], da[4][4];

  if (n_pairs > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_pairs; ++i) {
    const int st = i % L::STAGES, par = (i / L::STAGES) & 1;
    const int q0 = (t_begin + i / heads) * BT;
    mbar_wait(full(st), par);
    wgmma_tile_abt<HD>(s, sk, q_tile(st));     // S^T = K Q^T
    wgmma_tile_abt<HD>(dp, sv, do_tile(st));   // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    const float* lse_s =
        reinterpret_cast<const float*>(gbase + L::ROWS_OFF + st * ROWS_BYTES);
    const float* del_s = lse_s + BT;
    const bool need = mk.crosses(q0, k0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * (j / 4) + c0 + (j & 1);
      const bool ok = !need ||
          mk.visible(q0 + col, k0 + r0 + 8 * ((j >> 1) & 1));
      s[j] = grad_elem(s[j], dp[j], lse_s[col], del_s[col], softcap, scale,
                       ok);
    }
    to_a_fragments(s, pa);
    to_a_fragments(dp, da);
    wgmma_tile_pb<HD>(dva, pa, do_tile(st));   // dV += P^T dO
    wgmma_tile_pb<HD>(dka, da, q_tile(st));    // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dva);
    reg_fence(dka);
    u32_fence(pa);
    u32_fence(da);
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    if (key >= mk.Skv) continue;
    if (part != nullptr) {
      const int64_t n = (int64_t)splits * gridDim.y * KH * mk.Skv * HD;
      float* krow = part + ((((int64_t)split * gridDim.y + b) * KH + kvh) *
                                mk.Skv + key) * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int j = 4 * i + 2 * r;
        *reinterpret_cast<float2*>(krow + 8 * i + c0) =
            make_float2(dka[j], dka[j + 1]);
        *reinterpret_cast<float2*>(krow + n + 8 * i + c0) =
            make_float2(dva[j], dva[j + 1]);
      }
      continue;
    }
    __nv_bfloat16* krow = dk + b * dk_sb + kvh * dk_sh + key * dk_ss;
    __nv_bfloat16* vrow = dv + b * dv_sb + kvh * dv_sh + key * dv_ss;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int j = 4 * i + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * i + c0) =
          __floats2bfloat162_rn(dka[j] * scale, dka[j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * i + c0) =
          __floats2bfloat162_rn(dva[j], dva[j + 1]);
    }
  }
}

// dK = scale·Σ_split part_k, dV = Σ_split part_v in split order (so the
// bits do not depend on which block finished first), four elements a
// thread, rounded to bf16.
template <int HD>
__global__ void __launch_bounds__(256)
bwd_dkdv_sum_kernel(const float* __restrict__ part,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int KH, int Skv,
                    int splits, long long n_quads, int64_t dk_sb,
                    int64_t dk_sh, int64_t dk_ss, int64_t dv_sb,
                    int64_t dv_sh, int64_t dv_ss, float scale) {
  const long long qd = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (qd >= n_quads) return;
  const long long e = 4 * qd, per = 4 * n_quads;    // one split's floats
  const int d = (int)(e % HD);
  const long long row = e / HD;                     // (b, kvh, key)
  const int key = (int)(row % Skv);
  const int kvh = (int)((row / Skv) % KH), b = (int)(row / Skv / KH);
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * per + e);
    const float4 y = *reinterpret_cast<const float4*>(
        part + (splits + s) * per + e);
    sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
    sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
  }
  __nv_bfloat162* krow = reinterpret_cast<__nv_bfloat162*>(
      dk + b * dk_sb + kvh * dk_sh + key * dk_ss + d);
  __nv_bfloat162* vrow = reinterpret_cast<__nv_bfloat162*>(
      dv + b * dv_sb + kvh * dv_sh + key * dv_ss + d);
  krow[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  krow[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
  vrow[0] = __floats2bfloat162_rn(sv.x, sv.y);
  vrow[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// --- (iii) dQ by query tile ------------------------------------------------------

template <int HD>
struct QLayout {
  static constexpr int THREADS = 128 + 32;
  static constexpr int STAGES = 2;
  static constexpr int TILE = (HD / 64) * WG_BOX;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = TILE;
  static constexpr int STAGE_OFF = 2 * TILE;        // stage s: K, then V
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * 2 * TILE;
  // qd_full, full[S], empty[S]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;
};

template <int HD>
__global__ void __launch_bounds__(QLayout<HD>::THREADS, 2)
bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap domap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int H, int group, Mask mk,
              int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, float softcap,
              float scale) {
  using L = QLayout<HD>;
  constexpr int ND = HD / 2;
  constexpr int BOXES = HD / 64;
  extern __shared__ uint8_t bw_smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(bw_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base + L::Q_OFF, sdo = base + L::DO_OFF;
  const uint32_t qd_full = base + L::BAR_OFF;
  auto full = [&](int s) { return qd_full + 8u * (1 + s); };
  auto empty = [&](int s) { return qd_full + 8u * (1 + L::STAGES + s); };
  auto k_tile = [&](int s) { return base + L::STAGE_OFF + s * 2 * L::TILE; };
  auto v_tile = [&](int s) { return k_tile(s) + L::TILE; };

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BT;   // heaviest first
  const int kvh = h / group;

  // keys this block can see, in key coordinates (block-uniform)
  const int row_lo = q0 + mk.off;
  const int row_hi = min(q0 + BT, mk.Sq) - 1 + mk.off;
  const int kv_end = mk.causal ? min(mk.Skv, row_hi + 1) : mk.Skv;
  const int kv_begin = mk.window > 0 ? max(0, row_lo - mk.window + 1) : 0;
  const int t_begin = kv_begin / BT;
  const int n_tiles = max(0, (kv_end + BT - 1) / BT - t_begin);

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer: the last warp, one lane ----
    if (tid == 128) {
      mbar_expect_tx(qd_full, 2 * L::TILE);
      for (int c = 0; c < BOXES; ++c) {
        tma_load(sq + c * WG_BOX, &qmap, qd_full, c * 64, q0, h, b);
        tma_load(sdo + c * WG_BOX, &domap, qd_full, c * 64, q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % L::STAGES, k0 = (t_begin + i) * BT;
        if (i >= L::STAGES) mbar_wait(empty(st), ((i / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::TILE);
        for (int c = 0; c < BOXES; ++c) {
          tma_load(k_tile(st) + c * WG_BOX, &kmap, full(st), c * 64, k0, kvh,
                   b);
          tma_load(v_tile(st) + c * WG_BOX, &vmap, full(st), c * 64, k0, kvh,
                   b);
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, the block's 64 query rows ----
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = 16 * warp + (lane >> 2);     // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);              // its keys: 8i + c0 + {0, 1}
  const long long at = ((long long)b * H + h) * lse_rows(mk.Sq) + q0 + r0;
  const float lse_r[2] = {lse[at], lse[at + 8]};
  const float del_r[2] = {delta[at], delta[at + 8]};
  float dqa[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) dqa[j] = 0.f;
  float s[32], dp[32];
  uint32_t da[4][4];

  mbar_wait(qd_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % L::STAGES, par = (i / L::STAGES) & 1;
    const int k0 = (t_begin + i) * BT;
    mbar_wait(full(st), par);
    wgmma_tile_abt<HD>(s, sq, k_tile(st));     // S = Q K^T
    wgmma_tile_abt<HD>(dp, sdo, v_tile(st));   // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    const bool need = mk.crosses(q0, k0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const bool ok = !need ||
          mk.visible(q0 + r0 + 8 * r, k0 + 8 * (j / 4) + c0 + (j & 1));
      grad_elem(s[j], dp[j], lse_r[r], del_r[r], softcap, scale, ok);
    }
    to_a_fragments(dp, da);
    wgmma_tile_pb<HD>(dqa, da, k_tile(st));    // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dqa);
    u32_fence(da);
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= mk.Sq) continue;
    __nv_bfloat16* row = dq + b * dq_sb + h * dq_sh + qi * dq_ss;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int j = 4 * i + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + c0) =
          __floats2bfloat162_rn(dqa[j] * scale, dqa[j + 1] * scale);
    }
  }
}

// --- host side ---------------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int HD>
cudaError_t launch(const Maps& m, const void* o, const void* dout, void* dq,
                   void* dk, void* dv, const float* lse, float* delta,
                   float* part, int splits, int B, int H, int KH, Mask mk,
                   const long long* st, float softcap, float scale,
                   cudaStream_t stream) {
  using KL = KvLayout<HD>;
  using QL = QLayout<HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(bwd_dkdv_kernel<HD>, KL::ALLOC);
    if (e == cudaSuccess) e = allow_smem(bwd_dq_kernel<HD>, QL::ALLOC);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int group = H / KH;
  const long long n_rows = (long long)B * H * lse_rows(mk.Sq);
  bwd_delta_kernel<HD><<<(unsigned)((n_rows + DELTA_WARPS - 1) / DELTA_WARPS),
                         DELTA_WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, H, mk.Sq, n_rows,
      st[9], st[10], st[11], st[12], st[13], st[14]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  const dim3 kgrid(KH * splits, B, (mk.Skv + BT - 1) / BT);
  bwd_dkdv_kernel<HD><<<kgrid, KL::THREADS, KL::ALLOC, stream>>>(
      m.q, m.k, m.v, m.dout, lse, delta, dkb, dvb, splits > 1 ? part : nullptr,
      H, group, splits, mk, st[18], st[19], st[20], st[21], st[22], st[23],
      softcap, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (splits > 1) {
    const long long n_quads = (long long)B * KH * mk.Skv * HD / 4;
    bwd_dkdv_sum_kernel<HD><<<(unsigned)((n_quads + 255) / 256), 256, 0,
                              stream>>>(
        part, dkb, dvb, KH, mk.Skv, splits, n_quads, st[18], st[19], st[20],
        st[21], st[22], st[23], scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const dim3 qgrid(H, B, (mk.Sq + BT - 1) / BT);
  bwd_dq_kernel<HD><<<qgrid, QL::THREADS, QL::ALLOC, stream>>>(
      m.q, m.k, m.v, m.dout, lse, delta, static_cast<__nv_bfloat16*>(dq), H,
      group, mk, st[15], st[16], st[17], softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,hd), k/v (B,KH,Skv,hd), o/dout (B,H,Sq,hd) in; dq (B,H,Sq,hd),
// dk/dv (B,KH,Skv,hd) out; all bfloat16, hd 64 or 128.  ``st`` holds the
// (batch, head, row) strides of q, k, v, o, dout, dq, dk, dv in that order
// (24 values, element strides with a unit innermost one); q, k, v and dout
// need 16-byte aligned bases and strides (TMA), o, dq, dk and dv 4-byte
// ones.  lse: the forward's residual, (B, H, lse_rows(Sq)) f32 contiguous
// and 16-byte aligned (flash_attention_wgmma_fwd writes it); delta: f32
// scratch of the same shape; splits: how many blocks share the group's
// heads in the dK/dV pass (a divisor of H / KH; the wrapper picks it), and
// with splits > 1 part: f32 scratch of 2·splits·B·KH·Skv·hd floats,
// 16-byte aligned (null otherwise).  softcap <= 0 means no softcap.  Launches three kernels on ``stream`` (four with
// splits); returns cudaGetLastError() after the last (or the first error),
// or cudaErrorInvalidValue for what it does not take (the wrapper checks
// first and raises with the reason).
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* delta, void* part, int splits, int B, int H, int KH, int Sq,
    int Skv, int hd, const long long* st, int causal, int window,
    float softcap, float scale, void* stream) {
  if ((hd != 64 && hd != 128) || B < 1 || KH < 1 || H % KH != 0 || Sq < 1 ||
      Sq > Skv || splits < 1 || (H / KH) % splits != 0 ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  Maps m;
  if (!make_map(&m.q, enc, q, B, H, Sq, hd, st[0], st[1], st[2], BT) ||
      !make_map(&m.k, enc, k, B, KH, Skv, hd, st[3], st[4], st[5], BT) ||
      !make_map(&m.v, enc, v, B, KH, Skv, hd, st[6], st[7], st[8], BT) ||
      !make_map(&m.dout, enc, dout, B, H, Sq, hd, st[12], st[13], st[14], BT))
    return (int)cudaErrorInvalidValue;
  const Mask mk{Sq, Skv, Skv - Sq, causal, window};
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      hd == 64 ? launch<64>(m, o, dout, dq, dk, dv, l, d, p, splits, B, H,
                            KH, mk, st, softcap, scale, s)
               : launch<128>(m, o, dout, dq, dk, dv, l, d, p, splits, B, H,
                             KH, mk, st, softcap, scale, s);
  return (int)e;
}
