// Tile helpers of the attention kernels that stream (64, head_dim) tiles of
// q, k, v through shared memory on the CUDA cores (the int8 core of
// attention_core.cuh, the Longformer global_kv_grad_kernel): the tile load,
// the two tile products, half-warp reductions, the rounded exp and the
// head-dim dispatch.
//
// A block runs kThreads = 256 threads as (ty, tx) = (tid / 16, tid % 16);
// in a (64, 64) score tile thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4), and in a (64, HD) tile rows ty + 16 i and columns
// tx + 16 j (j < HD / 16). The 16 threads of a row sit in one half-warp.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace spk {

constexpr int kTile = 64;       // query rows (or keys) a block owns, and the tile it streams
constexpr int kPS = kTile + 1;  // row stride of the (64, 64) score tiles in shared memory

template <int HD>
struct Geometry {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  static constexpr int S = HD + 1;  // row stride of the (64, HD) tiles: conflict-free columns
  static constexpr int TD = HD / 16;  // head-dim columns a thread owns
  static constexpr int kTileFloats = kTile * S;
};

// (64, HD) rows [row0, row0 + 64) of one head, from the (L, HD) slab `src`
// (q, k or v of one (head, sequence)), to float; rows outside [0, L) read as
// zero.
template <typename T, int HD>
__device__ __forceinline__ void load_head_tile(float* dst, const T* __restrict__ src, int row0,
                                               int L) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int l = row0 + r;
    dst[r * Geometry<HD>::S + d] = (l >= 0 && l < L) ? to_f32(src[(size_t)l * HD + d]) : 0.0f;
  }
}

// acc[i][j] = sum_d X[ty + 16 i][d] * Y[tx + 16 j][d] over two (64, HD) tiles
template <int HD>
__device__ __forceinline__ void tile_dot(const float* X, const float* Y, float (&acc)[4][4]) {
  constexpr int S = Geometry<HD>::S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = X[(ty + 16 * i) * S + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) yv[j] = Y[(tx + 16 * j) * S + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
}

// o[i][j] += sum_c P[ty + 16 i][c] * Z[c][tx + 16 j] over a (64, 64) score
// tile and a (64, HD) tile
template <int HD>
__device__ __forceinline__ void tile_accumulate(const float* P, const float* Z,
                                                float (&o)[4][Geometry<HD>::TD]) {
  constexpr int S = Geometry<HD>::S;
  constexpr int TD = Geometry<HD>::TD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
  for (int c = 0; c < kTile; ++c) {
    float z[TD];
#pragma unroll
    for (int j = 0; j < TD; ++j) z[j] = Z[c * S + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = P[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) o[i][j] = fmaf(p, z[j], o[i][j]);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// e = exp(s - m) with s - m and the result rounded to T (the TPU's
// compute-dtype exp)
template <typename T>
__device__ __forceinline__ float rounded_exp(float s, float m) {
  return round_to<T>(expf(round_to<T>(s - m)));
}

// dispatch on the head dim; Launch is a generic lambda taking an
// std::integral_constant<int, HD>
template <typename Launch>
cudaError_t with_head_dim(int hd, Launch launch) {
  switch (hd) {
    case 16:
      return launch(std::integral_constant<int, 16>{});
    case 32:
      return launch(std::integral_constant<int, 32>{});
    case 64:
      return launch(std::integral_constant<int, 64>{});
    case 128:
      return launch(std::integral_constant<int, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace spk
