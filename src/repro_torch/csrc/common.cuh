// Shared helpers for the port's CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define REPRO_NEG_INF (-1e30f)

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum / max over a block whose size is a multiple of 32; every thread gets
// the result.  ``red`` is 32 floats of shared memory, free on entry.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = MAX ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  const float ident = MAX ? REPRO_NEG_INF : 0.f;
  float t = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : ident;
  if (warp == 0) t = MAX ? warp_max(t) : warp_sum(t);
  if (threadIdx.x == 0) red[0] = t;
  __syncthreads();
  return red[0];
}

// Logit softcap as the reference applies it: c * tanh(s / c); c <= 0 = off.
__device__ __forceinline__ float apply_softcap(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// A [ROWS][HD] tile of T moved global -> registers -> f32 shared memory in
// 16-byte chunks, every chunk of a thread in flight at once (a tile costs
// about one memory latency, not one per element).  Needs hd == HD, rows
// 16-byte aligned; rows >= nrows read as zero.  fetch() and store() are
// split so a kernel can fetch the next tile while it computes on this one.
template <typename T, int ROWS, int HD, int THREADS>
struct TileLoader {
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements per chunk
  static constexpr int CPR = HD / EPC;              // chunks per row
  static constexpr int PER = ROWS * CPR / THREADS;  // chunks per thread
  static_assert(ROWS * CPR % THREADS == 0, "tile must split evenly");
  uint4 buf[PER];

  // Rows at ``row(r)`` (a pointer to row r's first element), any addressing:
  // strided for a dense cache, through a block table for a paged one.
  template <typename RowFn>
  __device__ __forceinline__ void fetch_rows(const RowFn& row, int nrows) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = threadIdx.x + j * THREADS, r = c / CPR, e = (c % CPR) * EPC;
      buf[j] = r < nrows ? __ldg(reinterpret_cast<const uint4*>(row(r) + e))
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void fetch(const T* __restrict__ src, int64_t rs,
                                        int nrows) {
    fetch_rows([=](int r) { return src + r * rs; }, nrows);
  }

  __device__ __forceinline__ void store(float* __restrict__ dst, int ss) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = threadIdx.x + j * THREADS, r = c / CPR, e = (c % CPR) * EPC;
      const T* x = reinterpret_cast<const T*>(&buf[j]);
      float* d = dst + r * ss + e;
#pragma unroll
      for (int i = 0; i < EPC; i += 4)
        *reinterpret_cast<float4*>(d + i) =
            make_float4(to_f32(x[i]), to_f32(x[i + 1]), to_f32(x[i + 2]), to_f32(x[i + 3]));
    }
  }
};

// The element-wise fallback of TileLoader for head dims below the padded HD
// (the proxies' 12 and 16): dims >= hd and rows >= nrows read as zero.
template <typename T, int ROWS, int HD, int THREADS, typename RowFn>
__device__ __forceinline__ void load_rows_scalar(float* __restrict__ dst, int ss,
                                                 const RowFn& row, int nrows,
                                                 int hd) {
#pragma unroll 8
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    dst[r * ss + d] = (r < nrows && d < hd) ? to_f32(row(r)[d]) : 0.f;
  }
}

template <typename T, int ROWS, int HD, int THREADS>
__device__ __forceinline__ void load_tile_scalar(float* __restrict__ dst, int ss,
                                                 const T* __restrict__ src,
                                                 int64_t rs, int nrows, int hd) {
  load_rows_scalar<T, ROWS, HD, THREADS>(
      dst, ss, [=](int r) { return src + r * rs; }, nrows, hd);
}

// TileLoader's condition: full-width rows, 16-byte aligned base and stride.
__host__ __forceinline__ bool rows_vectorisable(const void* p, long long rs,
                                                int hd, int HD, int elem) {
  return hd == HD && ((uintptr_t)p % 16) == 0 && (rs * elem) % 16 == 0;
}

// The same for rows reached through further strides (head, page): each of
// them must keep 16-byte alignment too.
__host__ __forceinline__ bool strides_aligned(long long s0, long long s1,
                                              int elem) {
  return (s0 * elem) % 16 == 0 && (s1 * elem) % 16 == 0;
}

// Allow a kernel more than 48 KB of dynamic shared memory (once per kernel).
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
