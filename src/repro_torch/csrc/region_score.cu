// Eq. (2) region scoring for Hopper (sm_90a): K(x^r) = sum_i sum_j cos(V_i, E_j).
//
// Replaces: src/repro/kernels/region_score.py::region_score_pallas
// (OffloadPipeline.multiscale_view -> core/region_attention.score_regions).
//
// What bounds it on this card: bytes.  On the main path Nv = Ne = 1 and
// D = 1536, R = 1024: the kernel reads V once (3 MB in bf16) and does
// ~3·D FLOPs per region, so it is a fused normalise-and-dot reduction whose
// bound is the memory read (about a microsecond); launch latency dominates.
//
// What the design does about it:
//  * One block per (region, batch row); every byte of V is read once, with
//    consecutive threads on consecutive elements.
//  * The all-pairs cosine sum factorises: sum_i sum_j vn_i . en_j =
//    (sum_i vn_i) . (sum_j en_j), so each block builds the two normalised
//    row sums in shared memory and takes one dot product; no Nv x Ne matmul.
//  * Normalisation follows the plain version (ref.region_score and the JAX
//    oracle): x / (||x|| + 1e-6), in float32.  The Pallas kernel uses
//    x * rsqrt(||x||^2 + 1e-12) instead; the two differ by ~1e-6 relative
//    for unit-scale rows, inside the stated tolerance.
//  * E is tiny (Ne x D) and re-read by every block from L2.
#include "common.cuh"

namespace {

constexpr int RS_THREADS = 256;

// acc[d] += row[d] / (||row|| + 1e-6) for one row of D elements
template <typename T>
__device__ void add_normalised(const T* __restrict__ row, float* acc, int D,
                               float* red) {
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float x = to_f32(row[d]);
    ss += x * x;
  }
  const float denom = sqrtf(block_reduce<false>(ss, red)) + 1e-6f;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    acc[d] += to_f32(row[d]) / denom;
}

template <typename T>
__global__ void __launch_bounds__(RS_THREADS)
region_score_kernel(const T* __restrict__ v, const T* __restrict__ e,
                    float* __restrict__ out, int R, int Nv, int Ne, int D,
                    int64_t v_sb, int64_t v_sr, int64_t v_sn,
                    int64_t e_sb, int64_t e_sn) {
  extern __shared__ float rs_smem[];
  float* ebar = rs_smem;                 // [D]
  float* vbar = rs_smem + D;             // [D]
  float* red = rs_smem + 2 * D;          // [32]
  const int r = blockIdx.x, b = blockIdx.y;
  for (int d = threadIdx.x; d < D; d += blockDim.x) ebar[d] = vbar[d] = 0.f;
  // each thread only ever touches its own d's of ebar/vbar: no sync needed
  for (int j = 0; j < Ne; ++j) add_normalised(e + b * e_sb + j * e_sn, ebar, D, red);
  for (int i = 0; i < Nv; ++i)
    add_normalised(v + b * v_sb + r * v_sr + i * v_sn, vbar, D, red);
  float dot = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) dot += vbar[d] * ebar[d];
  dot = block_reduce<false>(dot, red);
  if (threadIdx.x == 0) out[(int64_t)b * R + r] = dot;
}

template <typename T>
cudaError_t launch(const void* v, const void* e, float* out, int B, int R,
                   int Nv, int Ne, int D, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(2 * D + 32) * sizeof(float);
  cudaError_t err = allow_smem(region_score_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  region_score_kernel<T><<<dim3(R, B), RS_THREADS, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(e), out, R, Nv, Ne, D,
      st[0], st[1], st[2], st[3], st[4]);
  return cudaGetLastError();
}

}  // namespace

// v (B,R,Nv,D), e (B,Ne,D) with a unit innermost stride; out (B,R) f32,
// contiguous.  Returns cudaGetLastError().
extern "C" int region_score_fwd(const void* v, const void* e, float* out,
                                int B, int R, int Nv, int Ne, int D,
                                long long v_sb, long long v_sr, long long v_sn,
                                long long e_sb, long long e_sn, int dtype,
                                void* stream) {
  if (B < 1 || R < 1 || Nv < 1 || Ne < 1 || D < 1 ||
      (size_t)(2 * D + 32) * sizeof(float) > 227 * 1024 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[5] = {v_sb, v_sr, v_sn, e_sb, e_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(v, e, out, B, R, Nv, Ne, D, st, s);
  if (dtype == DT_F32)
    return (int)launch<float>(v, e, out, B, R, Nv, Ne, D, st, s);
  return (int)cudaErrorInvalidValue;
}
