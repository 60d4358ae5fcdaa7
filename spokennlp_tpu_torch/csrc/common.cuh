// Shared device code of the fused encoder kernels (attention_block.cu,
// mlp_block.cu): dtype conversion, the activation table, warp sums, a SIMT
// tiled GEMM and the GEMM whose epilogue adds bias and residual and applies
// LayerNorm over whole rows.
//
// All arithmetic accumulates in float32. Element types are float or
// __nv_bfloat16; a value stored in the element type is rounded exactly where
// the JAX kernels call `.astype(x.dtype)`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace spk {

constexpr int kThreads = 256;  // every kernel here runs 256 threads a block
constexpr int kTileK = 16;     // depth of one GEMM k-step
constexpr float kNegInf = -1e9f;  // additive mask, as the JAX kernels use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16(v);
  }
}

// the value an `.astype(T)` leaves behind, back in float32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Activation codes; the Python table ACTIVATION_CODES (ops/cuda/int8_matmul.py)
// maps names onto them. "gelu" is the tanh form, as in the TPU kernels.
enum Activation : int { kActNone = 0, kActGeluTanh = 1, kActRelu = 2, kActSilu = 3 };

__device__ __forceinline__ float apply_activation(float x, int act) {
  switch (act) {
    case kActGeluTanh: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kActRelu:
      return fmaxf(x, 0.0f);
    case kActSilu:
      return x / (1.0f + expf(-x));
    default:
      return x;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One BM x BN output tile of C = A (M, K) . B (K, N), both row-major, on
// 256 threads. Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and
// columns tx + 16 j of the tile: the strided ownership keeps shared-memory
// reads free of bank conflicts (A reads broadcast, B reads are consecutive).
// A is staged transposed (As[k][m], padded by one) so its stores do not
// conflict either. Out-of-range rows, columns and depths read as zero.
template <int BM, int BN, typename T>
struct TileGemm {
  static_assert(BM % 16 == 0 && BN % 16 == 0, "tile must be a multiple of 16");
  static constexpr int TM = BM / 16;
  static constexpr int TN = BN / 16;
  static constexpr int kAStride = BM + 1;
  static constexpr int kSmemFloats = kTileK * kAStride + kTileK * BN;

  __device__ static void run(const T* __restrict__ A, const T* __restrict__ B, int M, int N,
                             int K, int row0, int col0, float (&acc)[TM][TN],
                             float* __restrict__ smem) {
    float* As = smem;
    float* Bs = smem + kTileK * kAStride;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kTileK) {
      for (int e = tid; e < BM * kTileK; e += kThreads) {
        const int m = e / kTileK, k = e % kTileK;
        const int gm = row0 + m, gk = k0 + k;
        As[k * kAStride + m] = (gm < M && gk < K) ? to_f32(A[(size_t)gm * K + gk]) : 0.0f;
      }
      for (int e = tid; e < kTileK * BN; e += kThreads) {
        const int k = e / BN, n = e % BN;
        const int gk = k0 + k, gn = col0 + n;
        Bs[k * BN + n] = (gk < K && gn < N) ? to_f32(B[(size_t)gk * N + gn]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTileK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k * kAStride + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k * BN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
};

// out = act(A . W + bias), stored in T. Grid (ceil(N / 64), ceil(M / 64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemm_bias_act_kernel(const T* __restrict__ A, const T* __restrict__ W,
                         const float* __restrict__ bias, T* __restrict__ out, int M, int N, int K,
                         int act) {
  using G = TileGemm<64, 64, T>;
  __shared__ float smem[G::kSmemFloats];
  const int row0 = blockIdx.y * 64, col0 = blockIdx.x * 64;
  float acc[G::TM][G::TN];
  G::run(A, W, M, N, K, row0, col0, acc, smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int m = row0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < G::TN; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = from_f32<T>(apply_activation(acc[i][j] + bias[n], act));
    }
  }
}

// Rows of the residual-LayerNorm GEMM a block owns, and its column tile.
constexpr int kLnRows = 32;
constexpr int kLnCols = 128;

// out = LayerNorm(resid + A . W + bias) * ln_scale + ln_bias over rows of
// width N, or out = A . W + bias when fuse_ln == 0. One block owns kLnRows
// whole rows: it walks the N columns tile by tile, writes the pre-norm rows
// in float32 to `rows` (M, N), then normalises each row with one warp
// (two-pass mean and variance in float32). The block reads back only what
// it wrote, while it is still in L2; holding the rows in shared memory
// instead (98 KB at N=768) let only two blocks onto an SM and ran at a third
// of the plain GEMM's rate. Grid (ceil(M / kLnRows)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemm_bias_residual_ln_kernel(const T* __restrict__ A, const T* __restrict__ W,
                                 const float* __restrict__ bias, const T* __restrict__ resid,
                                 const float* __restrict__ ln_scale,
                                 const float* __restrict__ ln_bias, float* rows,
                                 T* __restrict__ out, int M, int N, int K, float eps,
                                 int fuse_ln) {
  using G = TileGemm<kLnRows, kLnCols, T>;
  __shared__ float smem[G::kSmemFloats];
  const int row0 = blockIdx.x * kLnRows;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int col0 = 0; col0 < N; col0 += kLnCols) {
    float acc[G::TM][G::TN];
    G::run(A, W, M, N, K, row0, col0, acc, smem);
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const int m = row0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < G::TN; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c >= N) continue;
        float v = acc[i][j] + bias[c];
        if (fuse_ln) v += to_f32(resid[(size_t)m * N + c]);
        rows[(size_t)m * N + c] = v;
      }
    }
  }
  __syncthreads();  // makes the block's global writes visible to the block

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kLnRows; r += kThreads / 32) {
    const int m = row0 + r;
    if (m >= M) break;
    const float* row = rows + (size_t)m * N;
    T* o = out + (size_t)m * N;
    if (!fuse_ln) {
      for (int c = lane; c < N; c += 32) o[c] = from_f32<T>(row[c]);
      continue;
    }
    float s = 0.0f;
    for (int c = lane; c < N; c += 32) s += row[c];
    const float mean = warp_sum(s) / N;
    float ss = 0.0f;
    for (int c = lane; c < N; c += 32) {
      const float d = row[c] - mean;
      ss += d * d;
    }
    const float inv = rsqrtf(warp_sum(ss) / N + eps);
    for (int c = lane; c < N; c += 32)
      o[c] = from_f32<T>((row[c] - mean) * inv * ln_scale[c] + ln_bias[c]);
  }
}

template <typename T>
inline cudaError_t launch_residual_ln(const T* A, const T* W, const float* bias, const T* resid,
                                      const float* ln_scale, const float* ln_bias, float* rows,
                                      T* out, int M, int N, int K, float eps, int fuse_ln,
                                      cudaStream_t stream) {
  const dim3 grid((M + kLnRows - 1) / kLnRows);
  gemm_bias_residual_ln_kernel<T><<<grid, kThreads, 0, stream>>>(
      A, W, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, eps, fuse_ln);
  return cudaGetLastError();
}

}  // namespace spk
