// Eq. (2) region scoring for Hopper (sm_90a): K(x^r) = sum_i sum_j cos(V_i, E_j).
//
// Replaces: src/repro/kernels/region_score.py::region_score_pallas
// (OffloadPipeline.multiscale_view -> core/region_attention.score_regions).
//
// The algebra.  With en_j = e_j / (||e_j|| + 1e-6) and the plain version's
// vn_i = v_i / (||v_i|| + 1e-6) (kernels/ref.py, the JAX oracle), the
// all-pairs sum factorises:
//     score[b, r] = sum_i (v_i . ebar_b) / (||v_i|| + 1e-6),
//     ebar_b      = sum_j e_j / (||e_j|| + 1e-6).
// That is (Nv + Ne)·D multiply-adds, not Nv·Ne·D: no matmul is left, so the
// Pallas kernel's MXU product has no counterpart here.  One read of a V row
// gives both running sums a lane needs, v·ebar and v·v; no normalised copy
// of the row is kept and the row is never read twice.  All arithmetic is
// f32.  The plain version divides each row before its dot product, this
// kernel after it: the two differ by a few f32 roundings of values of the
// score's own size (|score| <= Nv·Ne), ~1e-7 relative, far inside
// TOL_REGION (1e-5 absolute); the Pallas kernel's x·rsqrt(||x||² + 1e-12)
// differs from both by ~1e-6 relative on unit-scale rows.
//
// What bounds it on this card: bytes, and at the main path's size the
// latency of one pass.  On the path B = 1, R = 1024, Nv = Ne = 1, D = 1536
// bf16: 3.15 MB read once is 0.94 µs at 3.35 TB/s, ~4·D FLOPs a region.
//
// What the design does about latency:
//  * A warp per (batch row, region), W warps (W regions of one batch row) a
//    block, the grid flattened over B·ceil(R/W) on x (one wave of 128
//    blocks on the path).  A row's sums end in warp_sum's xor butterfly:
//    no block barrier on the V side.
//  * Every load of a row is issued before any arithmetic on it: 16-byte
//    ld.global.nc a lane (6 a lane at D 1536 bf16) into registers, before
//    the block's barriers, so V's device-memory latency overlaps the E
//    chain (E's loads, its norms, the barriers, ebar).  Warps that hold no
//    E row issue them first thing, the Ne that do right after their E
//    norms.  Rows longer than one register piece (PIECE units a warp) and
//    Nv > 1 run as a stream of pieces over two register buffers: the next
//    piece's loads are in flight while the current one is reduced.
//  * ebar once per block, in shared memory (D floats), not once per region:
//    the warps take E's rows and write each row's norm to shared memory;
//    after a barrier every thread sums its entries of ebar in j order (the
//    result does not depend on the schedule); a second barrier publishes
//    it.  Those are the kernel's only two block barriers.  ebar is stored
//    unit-minor, so the V side's shared-memory reads are free of bank
//    conflicts.  ebar and the Ne norms must fit 227 KB: D + Ne <= 58112.
//  * The vector path needs 16-byte aligned bases and strides and D a
//    multiple of 8 (bf16) or 4 (f32); any other operand (an odd D, bf16 at
//    D 300, an unaligned view) takes the scalar path of the same template,
//    one element a load.
#include <type_traits>

#include "common.cuh"

namespace {

// regions (warps) a block: 4, 16 and 32 were no faster at the main path's
// shape on an H100
constexpr int RS_WARPS = 8;
constexpr int RS_THREADS = 32 * RS_WARPS;
constexpr int RS_SMEM_LIMIT = 227 * 1024;
constexpr int EBAR_AT_ONCE = 8;             // ebar entries a thread sums at once

// A lane's share of a row, in load units: 16 bytes (VEC) or one element.
template <typename T, bool VEC>
struct Units {
  using U = typename std::conditional<VEC, uint4, T>::type;
  static constexpr int EPU = VEC ? 16 / (int)sizeof(T) : 1;  // elements a unit
  static constexpr int UPL = VEC ? 8 : 16;    // units a lane holds a piece
  static constexpr int PIECE = 32 * UPL;      // units a warp holds a piece

  __device__ static U load(const T* __restrict__ p) {
    if constexpr (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
    else return __ldg(p);
  }
  __device__ static U zero() {
    if constexpr (VEC) return make_uint4(0u, 0u, 0u, 0u);
    else return from_f32<T>(0.f);
  }

  // buf[j] = unit (piece·PIECE + j·32 + lane) of ``row``: neighbouring
  // lanes on neighbouring units; units past the row read as zero
  __device__ static void fetch(U (&buf)[UPL], const T* __restrict__ row,
                               int piece, int n_units, int lane) {
#pragma unroll
    for (int j = 0; j < UPL; ++j) {
      const int u = piece * PIECE + j * 32 + lane;
      buf[j] = u < n_units ? load(row + (int64_t)u * EPU) : zero();
    }
  }

  // dot += x·ebar and ss += x·x over the piece's units; ebar == nullptr
  // takes ss alone.  ebar is stored unit-minor (element k of unit u at
  // k·n_units + u), so a warp's 32 lanes read 32 consecutive floats: no
  // bank conflict (in d order, lanes 8 floats apart would conflict 8-way).
  __device__ static void accumulate(const U (&buf)[UPL],
                                    const float* __restrict__ ebar, int piece,
                                    int n_units, int lane, float& dot,
                                    float& ss) {
#pragma unroll
    for (int j = 0; j < UPL; ++j) {
      const int u = piece * PIECE + j * 32 + lane;
      if (u >= n_units) break;
      const T* x = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
      for (int k = 0; k < EPU; ++k) {
        const float f = to_f32(x[k]);
        ss += f * f;
        if (ebar) dot += f * ebar[k * n_units + u];
      }
    }
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(RS_THREADS)
region_score_kernel(const T* __restrict__ v, const T* __restrict__ e,
                    float* __restrict__ out, int R, int Nv, int Ne, int D,
                    int64_t v_sb, int64_t v_sr, int64_t v_sn,
                    int64_t e_sb, int64_t e_sn) {
  using X = Units<T, VEC>;
  extern __shared__ float rs_smem[];
  float* ebar = rs_smem;                    // [D], unit-minor
  float* den = rs_smem + D;                 // [Ne]: ||e_j|| + 1e-6
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blocks_per_row = (R + RS_WARPS - 1) / RS_WARPS;
  const int b = blockIdx.x / blocks_per_row;
  const int r = (blockIdx.x - b * blocks_per_row) * RS_WARPS + warp;
  const bool live = r < R;                  // the last block's spare warps
  const int n_units = D / X::EPU;
  const int pieces_per_row = (n_units + X::PIECE - 1) / X::PIECE;
  const int pieces = Nv * pieces_per_row;
  const T* vr = v + b * v_sb + r * v_sr;
  const T* eb = e + b * e_sb;
  auto row_of = [&](int p) { return vr + (p / pieces_per_row) * v_sn; };

  typename X::U cur[X::UPL], nxt[X::UPL];
  // V's first piece in flight before anything else in the warps that hold
  // no row of E; the warps that do issue it right after their E norms, so
  // that their wait on E is not a wait on V too (measured faster on an
  // H100 with a cold L2)
  const bool e_warp = warp < Ne;
  if (live && !e_warp) X::fetch(cur, row_of(0), 0, n_units, lane);

  // ebar: the rows' norms (warps over j, nxt as the scratch buffer) ...
  for (int j = warp; j < Ne; j += RS_WARPS) {
    float ss = 0.f, unused = 0.f;
    for (int p = 0; p < pieces_per_row; ++p) {
      X::fetch(nxt, eb + j * e_sn, p, n_units, lane);
      X::accumulate(nxt, nullptr, p, n_units, lane, unused, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) den[j] = sqrtf(ss) + 1e-6f;
  }
  if (live && e_warp) X::fetch(cur, row_of(0), 0, n_units, lane);
  __syncthreads();
  // ... then each thread's entries, EBAR_AT_ONCE loads in flight, summed in
  // j order; entry i of the unit-minor layout is element (i % n_units)·EPU
  // + i / n_units
  for (int i0 = threadIdx.x; i0 < D; i0 += RS_THREADS * EBAR_AT_ONCE) {
    float acc[EBAR_AT_ONCE] = {};
    for (int j = 0; j < Ne; ++j) {
      const float dj = den[j];
#pragma unroll
      for (int q = 0; q < EBAR_AT_ONCE; ++q) {
        const int i = i0 + q * RS_THREADS;
        if (i < D)
          acc[q] += to_f32(__ldg(eb + j * e_sn + (i % n_units) * X::EPU +
                                 i / n_units)) / dj;
      }
    }
#pragma unroll
    for (int q = 0; q < EBAR_AT_ONCE; ++q)
      if (i0 + q * RS_THREADS < D) ebar[i0 + q * RS_THREADS] = acc[q];
  }
  __syncthreads();
  if (!live) return;

  // the stream of pieces: piece p + 1 loads while piece p is reduced
  float dot = 0.f, ss = 0.f, score = 0.f;
  auto reduce = [&](const typename X::U (&buf)[X::UPL], int p) {
    const int c = p % pieces_per_row;
    X::accumulate(buf, ebar, c, n_units, lane, dot, ss);
    if (c == pieces_per_row - 1) {          // a row's last piece
      dot = warp_sum(dot);
      ss = warp_sum(ss);
      score += dot / (sqrtf(ss) + 1e-6f);
      dot = ss = 0.f;
    }
  };
  for (int p = 0; p < pieces; p += 2) {
    if (p + 1 < pieces)
      X::fetch(nxt, row_of(p + 1), (p + 1) % pieces_per_row, n_units, lane);
    reduce(cur, p);
    if (p + 1 >= pieces) break;
    if (p + 2 < pieces)
      X::fetch(cur, row_of(p + 2), (p + 2) % pieces_per_row, n_units, lane);
    reduce(nxt, p + 1);
  }
  if (lane == 0) out[(int64_t)b * R + r] = score;
}

template <typename T, bool VEC>
cudaError_t launch(const void* v, const void* e, float* out, int B, int R,
                   int Nv, int Ne, int D, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(D + Ne) * sizeof(float);
  cudaError_t err = allow_smem(region_score_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = B * ((R + RS_WARPS - 1) / RS_WARPS);
  region_score_kernel<T, VEC><<<blocks, RS_THREADS, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(e), out, R, Nv, Ne, D,
      st[0], st[1], st[2], st[3], st[4]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* v, const void* e, float* out, int B, int R,
                     int Nv, int Ne, int D, const long long* st,
                     cudaStream_t stream) {
  constexpr int elem = (int)sizeof(T);
  // full-width 16-byte units: aligned bases, strides and a whole number of
  // units a row
  const bool vec = D % (16 / elem) == 0 &&
                   rows_vectorisable(v, st[2], D, D, elem) &&
                   rows_vectorisable(e, st[4], D, D, elem) &&
                   strides_aligned(st[0], st[1], elem) &&
                   strides_aligned(st[3], 0, elem);
  return vec ? launch<T, true>(v, e, out, B, R, Nv, Ne, D, st, stream)
             : launch<T, false>(v, e, out, B, R, Nv, Ne, D, st, stream);
}

__global__ void empty_kernel() {}

}  // namespace

// v (B,R,Nv,D), e (B,Ne,D) with a unit innermost stride (the stride of a
// size-1 dimension may be passed as 0); out (B,R) f32, contiguous.
// Returns cudaGetLastError().
extern "C" int region_score_fwd(const void* v, const void* e, float* out,
                                int B, int R, int Nv, int Ne, int D,
                                long long v_sb, long long v_sr, long long v_sn,
                                long long e_sb, long long e_sn, int dtype,
                                void* stream) {
  if (B < 1 || R < 1 || Nv < 1 || Ne < 1 || D < 1 ||
      ((long long)D + Ne) * (long long)sizeof(float) > RS_SMEM_LIMIT ||
      (long long)B * ((R + RS_WARPS - 1) / RS_WARPS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long st[5] = {v_sb, v_sr, v_sn, e_sb, e_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)dispatch<__nv_bfloat16>(v, e, out, B, R, Nv, Ne, D, st, s);
  if (dtype == DT_F32)
    return (int)dispatch<float>(v, e, out, B, R, Nv, Ne, D, st, s);
  return (int)cudaErrorInvalidValue;
}

// An empty kernel on region_score_fwd's grid for (B, R): the launch floor
// a microsecond-scale kernel cannot go under.
extern "C" int region_score_empty(int B, int R, void* stream) {
  const int blocks = B * ((R + RS_WARPS - 1) / RS_WARPS);
  empty_kernel<<<blocks, RS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
