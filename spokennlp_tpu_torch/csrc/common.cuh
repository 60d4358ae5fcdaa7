// Shared device code of the encoder kernels: dtype conversion, the
// activation table and its derivative, warp sums, a counter-based Philox
// generator for dropout, a SIMT tiled GEMM (either operand may be read
// transposed), the q/k/v scatter and the row LayerNorm. The tile functions
// built on them (the GEMM with bias and activation, the QKV projection, the
// GEMM whose epilogue adds bias and residual and applies LayerNorm over whole
// rows, the weight gradient that reduces over all rows) live in bf16_gemm.cuh
// beside the tensor-core tile their bf16 instantiations run. The inference kernels' bodies are device functions of one tile or row
// block, so the whole-stack kernel (stack_block.cu) runs the same code on the
// same tiles.
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

// Allow `kernel` `smem` bytes of dynamic shared memory (above 48 KB a launch
// needs it).
template <typename KernelPtr>
cudaError_t prepare(KernelPtr kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

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

// (act(x), act'(x)) with one transcendental, the derivative being that of
// the form computed above (tanh GELU for "gelu"); the training kernels'
// counterpart of _act_and_grad in ops/pallas/train_blocks.py.
__device__ __forceinline__ void activation_and_grad(float x, int act, float& h, float& dh) {
  switch (act) {
    case kActGeluTanh: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      const float t = tanhf(c * (x + 0.044715f * x * x * x));
      h = 0.5f * x * (1.0f + t);
      dh = 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * x * x);
      return;
    }
    case kActRelu:
      h = fmaxf(x, 0.0f);
      dh = x > 0.0f ? 1.0f : 0.0f;
      return;
    case kActSilu: {
      const float s = 1.0f / (1.0f + expf(-x));
      h = x * s;
      dh = s * (1.0f + x * (1.0f - s));
      return;
    }
    default:
      h = x;
      dh = 1.0f;
  }
}

// Philox4x32-10 (Salmon et al., SC 2011) on the counter (c0, c1, c2, c3)
// under the key (seed, 0); returns the first of its four output words.
// Dropout draws one word per (sequence, head, query row, key column), so the
// backward pass regenerates the forward's mask from the same counters. The
// numpy twin is ops/cuda/train_blocks.py philox_bits.
__host__ __device__ __forceinline__ uint32_t philox_bits(uint32_t seed, uint32_t c0,
                                                         uint32_t c1, uint32_t c2,
                                                         uint32_t c3) {
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
    const uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
    const uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

// keep iff bits >= thr, thr = min(int(rate * 2^32), 2^32 - 1): P(keep) = 1 - rate
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t thr, int b, int h, int row,
                                             int col) {
  return philox_bits(seed, (uint32_t)b, (uint32_t)h, (uint32_t)row, (uint32_t)col) >= thr;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One BM x BN output tile of C = A . B on 256 threads, A (M, K) and B (K, N)
// as matrices; A is stored row-major (M, K), or (K, M) when kTransA, and B
// row-major (K, N), or (N, K) when kTransB. Thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty + 16 i and columns tx + 16 j of the tile: the
// strided ownership keeps shared-memory reads free of bank conflicts (A reads
// broadcast, B reads are consecutive). A is staged as As[k][m], padded by
// one, and a transposed B as Bs[k][n] padded by one, so the stores do not
// conflict either; global reads walk the operand's contiguous index.
// Out-of-range rows, columns and depths read as zero. With kColSumB, threads
// tid < BN also sum their column of B over the whole depth into `bsum`
// (the bias gradient of a weight-gradient GEMM, for free).
template <int BM, int BN, typename T, bool kTransA = false, bool kTransB = false,
          bool kColSumB = false>
struct TileGemm {
  static_assert(BM % 16 == 0 && BN % 16 == 0, "tile must be a multiple of 16");
  static constexpr int TM = BM / 16;
  static constexpr int TN = BN / 16;
  static constexpr int kAStride = BM + 1;
  static constexpr int kBStride = kTransB ? BN + 1 : BN;
  static constexpr int kSmemFloats = kTileK * kAStride + kTileK * kBStride;

  // A and B carry no __restrict__: the persistent stack kernel reads
  // buffers that an earlier phase of the same launch wrote, which the
  // read-only (non-coherent) load path must not serve.
  __device__ static void run(const T* A, const T* B, int M, int N, int K, int row0, int col0,
                             float (&acc)[TM][TN], float* __restrict__ smem,
                             float* bsum = nullptr) {
    float* As = smem;
    float* Bs = smem + kTileK * kAStride;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    float col_sum = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kTileK) {
      if constexpr (kTransA) {
        for (int e = tid; e < BM * kTileK; e += kThreads) {
          const int k = e / BM, m = e % BM;
          const int gm = row0 + m, gk = k0 + k;
          As[k * kAStride + m] = (gm < M && gk < K) ? to_f32(A[(size_t)gk * M + gm]) : 0.0f;
        }
      } else {
        for (int e = tid; e < BM * kTileK; e += kThreads) {
          const int m = e / kTileK, k = e % kTileK;
          const int gm = row0 + m, gk = k0 + k;
          As[k * kAStride + m] = (gm < M && gk < K) ? to_f32(A[(size_t)gm * K + gk]) : 0.0f;
        }
      }
      if constexpr (kTransB) {
        for (int e = tid; e < kTileK * BN; e += kThreads) {
          const int n = e / kTileK, k = e % kTileK;
          const int gk = k0 + k, gn = col0 + n;
          Bs[k * kBStride + n] = (gk < K && gn < N) ? to_f32(B[(size_t)gn * K + gk]) : 0.0f;
        }
      } else {
        for (int e = tid; e < kTileK * BN; e += kThreads) {
          const int k = e / BN, n = e % BN;
          const int gk = k0 + k, gn = col0 + n;
          Bs[k * kBStride + n] = (gk < K && gn < N) ? to_f32(B[(size_t)gk * N + gn]) : 0.0f;
        }
      }
      __syncthreads();
      if constexpr (kColSumB) {
        if (tid < BN) {
#pragma unroll
          for (int k = 0; k < kTileK; ++k) col_sum += Bs[k * kBStride + tid];
        }
      }
#pragma unroll
      for (int k = 0; k < kTileK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k * kAStride + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k * kBStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if constexpr (kColSumB) {
      if (tid < BN && bsum != nullptr && col0 + tid < N) bsum[col0 + tid] = col_sum;
    }
  }
};

// Store one projected value of column n (slot s = n / HN, head, dim) and row
// m = b * L + l into the (slots, B, nh, L, hd) layout.
template <typename T>
__device__ __forceinline__ void store_qkv(T* qkv, float v, int m, int n, int B, int L, int nh,
                                          int hd) {
  const int HN = nh * hd;
  const int b = m / L, l = m - b * L;
  const int s = n / HN, r = n - s * HN;
  const int h = r / hd, d = r - h * hd;
  qkv[((((size_t)s * B + b) * nh + h) * L + l) * hd + d] = from_f32<T>(v);
}

// Rows of the SIMT residual-LayerNorm GEMM a block owns, and its column tile
// (bf16_gemm.cuh has the tensor-core tile's).
constexpr int kLnRows = 32;
constexpr int kLnCols = 128;

// The second half of the row-owning epilogue: rows [row0, row0 + kRows)
// of `rows` (M, N) float32, which this block wrote, normalised into out, one
// warp a row (two-pass mean and variance in float32), or copied when fuse_ln
// is 0. The block's threads must have passed a __syncthreads() since writing.
template <typename T, int kRows = kLnRows>
__device__ __forceinline__ void ln_rows(const float* rows, const float* ln_scale,
                                        const float* ln_bias, T* out, int M, int N, float eps,
                                        int fuse_ln, int row0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
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

}  // namespace spk
