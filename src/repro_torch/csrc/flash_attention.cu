// Causal GQA flash-attention forward for Hopper (sm_90a), CUDA cores, f32 math.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the prefill of [regions | prompt] in models/layers.py, mode="prefill"),
// on the route kernels/flash_attention.py::route gives float32 and head
// dims other than 64/128 (the proxies' 12 and 16, gemma3-1b's 256); bf16 at
// hd 64/128, the other full-width models' prefill, runs
// flash_attention_wgmma.cu.
//
// What bounds it on this card: the work is ~2·2·hd·S²/2 FLOPs per head
// against a few MB of Q/K/V, so it is bound by operations.  It runs them
// on the CUDA cores in float32 (67 TFLOP/s peak): exact enough that the
// card's float32 decisions match the CPU's, which TF32 tensor cores would
// not be.
//
// What the design does about it:
//  * One block per (32-query tile, head, batch row): the TPU kernel's
//    sequential KV grid axis becomes a loop inside the block, with the
//    online-softmax state (m, l, acc) in registers, four warps x 8 rows.
//  * K/V are read at KV head h / group (never replicated); blocks of one
//    group share them through L2.
//  * KV tiles above the causal diagonal and below the window are skipped.
//  * Q/K/V tiles are staged in shared memory as f32 (K rows padded to
//    hd + 4 floats so the float4 reads of 8 lanes hit distinct banks):
//    98,816 bytes a block at hd 256, under the 227 KB opt-in.
//    At hd = 32, 64, 128 or 256 they move in 16-byte chunks, all of a
//    thread's in flight at once; up to hd 128 the next K/V tile is fetched
//    into registers while the block computes on this one.  At hd 256 there
//    is no such prefetch: the row state alone is 64 f32 accumulators a
//    thread (acc[8][8]), and a prefetched f32 K/V pair would add 128
//    registers more, so each tile is loaded when its turn comes, in four
//    8-row slices (common.cuh's load_kv_tiles), K's and V's chunks of a
//    slice in flight together (ptxas on sm_90a: 255 registers and 8
//    bytes of spill in f32, 246 and none in bf16).  The proxies' hd
//    12/16 take an element-wise path.
//  * The ragged edge (Sq = 1025 is no multiple of any tile) is masked in the
//    kernel: rows >= Sq are computed on zeros and never stored, keys >= Skv
//    are masked.  The model's sequence is never padded.
//  * Causal alignment is bottom-right (row i sees keys <= i + Skv - Sq), the
//    plain version's; it equals the Pallas kernel's top-left one at
//    Sq == Skv, the only case the model calls.
//  * p = where(mask, exp(s - m), 0) and the final acc / max(l, 1e-30), as
//    the TPU kernel; logit softcap and sliding window are kept.
#include "common.cuh"

namespace {

constexpr int FA_WARPS = 4;
constexpr int FA_ROWS = 8;                    // query rows per warp
constexpr int FA_BQ = FA_WARPS * FA_ROWS;     // query rows per block
constexpr int FA_BK = 32;                     // keys per tile: one per lane

template <int HD>
constexpr size_t fa_smem_bytes() {
  return (size_t)(FA_BQ * HD + FA_BK * (HD + 4) + FA_BK * HD) * sizeof(float);
}

// HD is the head dim rounded up to 32, 64, 128 or 256; dims >= hd are zero.
// Up to HD 128 the next K/V tile waits in registers while the block works
// on this one; at HD 256 a tile loads when its turn comes.
template <typename T, int HD>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int group, int Sq, int Skv, int hd,
                 int64_t q_sb, int64_t q_sh, int64_t q_ss,
                 int64_t k_sb, int64_t k_sh, int64_t k_ss,
                 int64_t v_sb, int64_t v_sh, int64_t v_ss,
                 int64_t o_sb, int64_t o_sh, int64_t o_ss,
                 int causal, int window, float softcap, float scale,
                 int vec) {
  constexpr int THREADS = FA_WARPS * 32;
  constexpr int KST = HD + 4;                 // padded K row stride
  constexpr int DPL = HD / 32;                // output dims per lane
  extern __shared__ float4 fa_smem4[];
  float* qs = reinterpret_cast<float*>(fa_smem4);   // [FA_BQ][HD]
  float* ks = qs + FA_BQ * HD;                       // [FA_BK][KST]
  float* vs = ks + FA_BK * KST;                      // [FA_BK][HD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int off = Skv - Sq;                   // bottom-right causal offset

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  if (vec) {
    TileLoader<T, FA_BQ, HD, THREADS> ql;
    ql.fetch(qb + q0 * q_ss, q_ss, Sq - q0);
    ql.store(qs, HD);
  } else {
    load_tile_scalar<T, FA_BQ, HD, THREADS>(qs, HD, qb + q0 * q_ss, q_ss,
                                            Sq - q0, hd);
  }

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][DPL];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    m[r] = REPRO_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[r][dd] = 0.f;
  }

  // keys this block can see, in key coordinates
  const int row_lo = q0 + off;
  const int row_hi = min(q0 + FA_BQ, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, row_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, row_lo - window + 1) : 0;
  const int t_begin = kv_begin / FA_BK;
  const int t_end = (kv_end + FA_BK - 1) / FA_BK;

  // vectorised path up to HD 128: tile t + 1 is in flight in registers
  // while the block computes on tile t
  constexpr bool PREFETCH = HD <= 128;
  TileLoader<T, PREFETCH ? FA_BK : 1, HD, THREADS> kl, vl;
  if (PREFETCH && vec && t_begin < t_end) {
    const int k0 = t_begin * FA_BK;
    kl.fetch(kb + k0 * k_ss, k_ss, Skv - k0);
    vl.fetch(vb + k0 * v_ss, v_ss, Skv - k0);
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();                          // previous tile consumed
    if (vec && PREFETCH) {
      kl.store(ks, KST);
      vl.store(vs, HD);
    } else if (vec) {                         // HD 256: 8-row slices
      const T* kt = kb + k0 * k_ss;
      const T* vt = vb + k0 * v_ss;
      const auto one = [](int) { return 1.f; };
      load_kv_tiles<T, FA_BK, HD, THREADS>(
          ks, KST, vs, HD, [=](int r) { return kt + r * k_ss; }, one,
          [=](int r) { return vt + r * v_ss; }, one, Skv - k0);
    } else {
      load_tile_scalar<T, FA_BK, HD, THREADS>(ks, KST, kb + k0 * k_ss, k_ss,
                                              Skv - k0, hd);
      load_tile_scalar<T, FA_BK, HD, THREADS>(vs, HD, vb + k0 * v_ss, v_ss,
                                              Skv - k0, hd);
    }
    __syncthreads();
    if (PREFETCH && vec && t + 1 < t_end) {
      const int k1 = k0 + FA_BK;
      kl.fetch(kb + k1 * k_ss, k_ss, Skv - k1);
      vl.fetch(vb + k1 * v_ss, v_ss, Skv - k1);
    }

    float s[FA_ROWS];
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * KST);
    const float4* qrow = reinterpret_cast<const float4*>(qs + warp * FA_ROWS * HD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) {
        const float4 qq = qrow[r * (HD / 4) + d4];
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    const int kj = k0 + lane;
    float p[FA_ROWS];
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
      const int qk = q0 + warp * FA_ROWS + r + off;   // row in key coordinates
      bool ok = kj < Skv;
      if (causal) ok = ok && kj <= qk;
      if (window > 0) ok = ok && kj > qk - window;
      const float sc = ok ? apply_softcap(s[r] * scale, softcap) : REPRO_NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sc));
      p[r] = ok ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[r][dd] *= alpha;
      m[r] = m_new;
    }

#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      float vv[DPL];
      const float* vrow = vs + j * HD + lane * DPL;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) vv[dd] = vrow[dd];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[r][dd] += pj * vv[dd];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int qi = q0 + warp * FA_ROWS + r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + b * o_sb + h * o_sh + qi * o_ss;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane * DPL + dd;
      if (d < hd) orow[d] = from_f32<T>(acc[r][dd] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int group, int Sq, int Skv, int hd,
                   const long long* st, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = fa_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(flash_fwd_kernel<T, HD>, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int elem = (int)sizeof(T);
  const int vec = rows_vectorisable(q, st[2], hd, HD, elem) &&
                  rows_vectorisable(k, st[5], hd, HD, elem) &&
                  rows_vectorisable(v, st[8], hd, HD, elem);
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, FA_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, Sq, Skv, hd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, softcap, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int group, int Sq, int Skv, int hd,
                        const long long* st, int causal, int window,
                        float softcap, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, B, H, group, Sq, Skv, hd, st, causal,
                         window, softcap, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, H, group, Sq, Skv, hd, st, causal,
                         window, softcap, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, H, group, Sq, Skv, hd, st, causal,
                          window, softcap, scale, stream);
  return launch<T, 256>(q, k, v, o, B, H, group, Sq, Skv, hd, st, causal,
                        window, softcap, scale, stream);
}

}  // namespace

// q (B,H,Sq,hd), k/v (B,KH,Skv,hd), o (B,H,Sq,hd); any strides with a unit
// innermost one.  softcap <= 0 means no softcap.  Returns cudaGetLastError().
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int KH, int Sq, int Skv, int hd,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float softcap, float scale, int dtype,
    void* stream) {
  if (hd < 1 || hd > 256 || hd % 4 != 0 || KH < 1 || H % KH != 0 ||
      Sq < 1 || Sq > Skv)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_BF16)
    e = dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, H / KH, Sq, Skv, hd, st,
                                   causal, window, softcap, scale, s);
  else if (dtype == DT_F32)
    e = dispatch_hd<float>(q, k, v, o, B, H, H / KH, Sq, Skv, hd, st, causal,
                           window, softcap, scale, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
