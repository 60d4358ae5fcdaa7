// Device code of the W8A8 paths (int8_matmul.cu, attention_block.cu,
// mlp_block.cu, stack_block.cu, sliding_block.cu, bigbird_block.cu): the row
// quantiser, an int8 tiled GEMM on __dp4a with an int32 accumulator, and the
// epilogues the encoder needs (dequant + bias + activation, the same
// quantised again with one static scale, the q/k/v scatter, and residual +
// LayerNorm over whole rows with per-head-group scales).
//
// Quantisation follows spokennlp_tpu/ops/pallas/int8_matmul.py
// rowquant_in_kernel: s = max(absmax, 1e-6) * (1 / 127), q = clip(rint(x *
// (1 / s)), -127, 127), rounding half to even (rintf, never roundf). The
// dequant epilogue is (float(acc) * s_x) * s_w + b with every product and sum
// rounded on its own (__fmul_rn, __fadd_rn), so no fused multiply-add makes
// it differ from the plain PyTorch version. The library is built without
// fast-math, so 1.0f / s is the IEEE quotient.
//
// The accumulator is exact: |acc| <= K * 127^2 (4.95e7 at K = 3072) fits
// int32; only the conversion to float32 rounds.
#pragma once

#include "common.cuh"

namespace spk {

constexpr int kTileK8 = 32;                 // int8 depth of one GEMM k-step
constexpr int kRowWords = kTileK8 / 4 + 1;  // a staged row in 32-bit words, padded by one

__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

// Quantise one (row, group) of src (M, K): the group's W = K / G columns from
// g * W, with one warp. Writes dst (M, K) int8 and scales[row * G + g].
template <typename Tin>
__device__ __forceinline__ void rowquant_item(const Tin* src, int K, int G, int row, int g,
                                              int8_t* dst, float* scales) {
  const int lane = threadIdx.x % 32, W = K / G;
  const Tin* x = src + (size_t)row * K + (size_t)g * W;
  int8_t* q = dst + (size_t)row * K + (size_t)g * W;
  float amax = 0.0f;
  for (int c = lane; c < W; c += 32) amax = fmaxf(amax, fabsf(to_f32(x[c])));
  amax = warp_max(amax);
  const float s = __fmul_rn(fmaxf(amax, 1e-6f), 1.0f / 127.0f);
  const float inv = 1.0f / s;
  for (int c = lane; c < W; c += 32) {
    const float v = rintf(__fmul_rn(to_f32(x[c]), inv));
    q[c] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (lane == 0) scales[(size_t)row * G + g] = s;
}

// The items [first, M * G) with stride `step`, one warp each: a grid of
// blocks calls it with first = blockIdx.x * warps + warp.
template <typename Tin>
__device__ __forceinline__ void rowquant_items(const Tin* src, int M, int K, int G, int8_t* dst,
                                               float* scales, int first, int step) {
  for (int item = first; item < M * G; item += step)
    rowquant_item<Tin>(src, K, G, item / G, item % G, dst, scales);
}

// Grid (ceil(M * G / 8)): one warp per (row, group).
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
    rowquant_kernel(const Tin* src, int M, int K, int G, int8_t* dst, float* scales) {
  constexpr int kWarps = kThreads / 32;
  rowquant_items<Tin>(src, M, K, G, dst, scales, blockIdx.x * kWarps + threadIdx.x / 32,
                      gridDim.x * kWarps);
}

template <typename Tin>
inline cudaError_t launch_rowquant(const Tin* src, int M, int K, int G, int8_t* dst,
                                   float* scales, cudaStream_t stream) {
  if (G <= 0 || K % G) return cudaErrorInvalidValue;
  const int warps = kThreads / 32;
  rowquant_kernel<Tin><<<(M * G + warps - 1) / warps, kThreads, 0, stream>>>(src, M, K, G, dst,
                                                                             scales);
  return cudaGetLastError();
}

// One BM x BN tile of the int32 product A[:, k_lo:k_hi] . B[k_lo:k_hi, :] of
// int8 A (M, K) and B (K, N), both row-major, on 256 threads; K, k_lo and
// k_hi are multiples of 4. Thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j, as in TileGemm. A k-step stages 32 deep: A as As[m][word] (four
// consecutive k of a row in one 32-bit word), B transposed and packed the
// same way as Bs[n][word], rows padded to 9 words so the 16 threads of a
// half-warp read 16 banks; __dp4a then multiplies four k at once. No
// __restrict__ on A and B, for the reason TileGemm gives.
template <int BM, int BN>
struct TileGemmI8 {
  static_assert(BM % 16 == 0 && BN % 16 == 0, "tile must be a multiple of 16");
  static constexpr int TM = BM / 16;
  static constexpr int TN = BN / 16;
  static constexpr int kSmemWords = (BM + BN) * kRowWords;

  __device__ static void run(const int8_t* A, const int8_t* B, int M, int N, int K, int k_lo,
                             int k_hi, int row0, int col0, int (&acc)[TM][TN],
                             int* __restrict__ smem) {
    int* As = smem;
    int* Bs = smem + BM * kRowWords;
    constexpr int kWords = kTileK8 / 4;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;

    for (int k0 = k_lo; k0 < k_hi; k0 += kTileK8) {
      for (int e = tid; e < BM * kWords; e += kThreads) {
        const int m = e / kWords, w = e % kWords;
        const int gm = row0 + m, gk = k0 + 4 * w;
        As[m * kRowWords + w] =
            (gm < M && gk < k_hi) ? *reinterpret_cast<const int*>(A + (size_t)gm * K + gk) : 0;
      }
      for (int e = tid; e < BN * kWords; e += kThreads) {
        const int n = e % BN, w = e / BN;
        const int gn = col0 + n, gk = k0 + 4 * w;
        uint32_t packed = 0;
        if (gn < N && gk < k_hi) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            packed |= (uint32_t)(uint8_t)B[(size_t)(gk + i) * N + gn] << (8 * i);
        }
        Bs[n * kRowWords + w] = (int)packed;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        int a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * kRowWords + w];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[(tx + 16 * j) * kRowWords + w];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
};

// out = act(dequant(A8 . W8) + bias) in Tout for the 64 x 64 tile at (row0,
// col0): sa (M,) row scales, sw (N,) column scales, bias (N,) or null.
template <typename Tout>
__device__ __forceinline__ void gemm_act_tile_i8(const int8_t* A, const float* sa,
                                                 const int8_t* W, const float* sw,
                                                 const float* bias, Tout* out, int M, int N,
                                                 int K, int act, int row0, int col0, int* smem) {
  using G = TileGemmI8<64, 64>;
  int acc[G::TM][G::TN];
  G::run(A, W, M, N, K, 0, K, row0, col0, acc, smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int m = row0 + ty + 16 * i;
    if (m >= M) continue;
    const float s = sa[m];
#pragma unroll
    for (int j = 0; j < G::TN; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n >= N) continue;
      float v = dequant(acc[i][j], s, sw[n]);
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      out[(size_t)m * N + n] = from_f32<Tout>(apply_activation(v, act));
    }
  }
}

// Grid (ceil(N / 64), ceil(M / 64)).
template <typename Tout>
__global__ void __launch_bounds__(kThreads)
    gemm_act_i8_kernel(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                       const float* bias, Tout* out, int M, int N, int K, int act) {
  __shared__ int smem[TileGemmI8<64, 64>::kSmemWords];
  gemm_act_tile_i8<Tout>(A, sa, W, sw, bias, out, M, N, K, act, blockIdx.y * 64,
                         blockIdx.x * 64, smem);
}

template <typename Tout>
inline cudaError_t launch_gemm_i8(const int8_t* A, const float* sa, const int8_t* W,
                                  const float* sw, const float* bias, Tout* out, int M, int N,
                                  int K, int act, cudaStream_t stream) {
  if (K % 4) return cudaErrorInvalidValue;
  const dim3 grid((N + 63) / 64, (M + 63) / 64);
  gemm_act_i8_kernel<Tout><<<grid, kThreads, 0, stream>>>(A, sa, W, sw, bias, out, M, N, K, act);
  return cudaGetLastError();
}

// The W8A8 MLP's first product under a static intermediate scale (the TPU
// kernel's static_h_scale) for the 64 x 64 tile at (row0, col0): h =
// act(dequant(A8 . W8) + bias) in float32, then q = clip(rint(h * (1 / s)),
// -127, 127) with the one per-tensor scale s = *hs, stored int8: no row
// absmax, and h never leaves the registers. The tiles of the first column
// also write s as every row's scale, for the second product's dequant.
__device__ __forceinline__ void gemm_act_quant_tile_i8(const int8_t* A, const float* sa,
                                                       const int8_t* W, const float* sw,
                                                       const float* bias, const float* hs,
                                                       int8_t* out, float* out_scales, int M,
                                                       int N, int K, int act, int row0, int col0,
                                                       int* smem) {
  using G = TileGemmI8<64, 64>;
  int acc[G::TM][G::TN];
  G::run(A, W, M, N, K, 0, K, row0, col0, acc, smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float s = *hs, inv = 1.0f / s;
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int m = row0 + ty + 16 * i;
    if (m >= M) continue;
    if (col0 == 0 && tx == 0) out_scales[m] = s;
    const float sr = sa[m];
#pragma unroll
    for (int j = 0; j < G::TN; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n >= N) continue;
      float v = dequant(acc[i][j], sr, sw[n]);
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      const float q = rintf(__fmul_rn(apply_activation(v, act), inv));
      out[(size_t)m * N + n] = static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
    }
  }
}

// Grid (ceil(N / 64), ceil(M / 64)). out and out_scales must not alias A and
// sa: other blocks still read those.
template <int kUnused = 0>
__global__ void __launch_bounds__(kThreads)
    gemm_act_quant_i8_kernel(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                             const float* bias, const float* hs, int8_t* out, float* out_scales,
                             int M, int N, int K, int act) {
  __shared__ int smem[TileGemmI8<64, 64>::kSmemWords];
  gemm_act_quant_tile_i8(A, sa, W, sw, bias, hs, out, out_scales, M, N, K, act, blockIdx.y * 64,
                         blockIdx.x * 64, smem);
}

inline cudaError_t launch_gemm_act_quant_i8(const int8_t* A, const float* sa, const int8_t* W,
                                            const float* sw, const float* bias, const float* hs,
                                            int8_t* out, float* out_scales, int M, int N, int K,
                                            int act, cudaStream_t stream) {
  if (K % 4) return cudaErrorInvalidValue;
  const dim3 grid((N + 63) / 64, (M + 63) / 64);
  gemm_act_quant_i8_kernel<><<<grid, kThreads, 0, stream>>>(A, sa, W, sw, bias, hs, out,
                                                            out_scales, M, N, K, act);
  return cudaGetLastError();
}

// The W8A8 projection of the 64 x 64 tile at (row0, col0) of x8 . w8 with
// w8 (H, slots nh hd): dequant + bias, slot 0 times sm_scale (1 keeps it
// unscaled), in T, scattered to (slots, B, nh, L, hd): q, k, v with slots =
// 3, the Longformer global k, v with slots = 2 and sm_scale = 1.
template <typename T>
__device__ __forceinline__ void qkv_proj_tile_i8(const int8_t* x8, const float* sx,
                                                 const int8_t* w8, const float* sw,
                                                 const float* bias, T* qkv, int B, int L, int H,
                                                 int nh, int hd, float sm_scale, int row0,
                                                 int col0, int* smem, int slots = 3) {
  using G = TileGemmI8<64, 64>;
  const int M = B * L, HN = nh * hd, N = slots * HN;
  int acc[G::TM][G::TN];
  G::run(x8, w8, M, N, H, 0, H, row0, col0, acc, smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int m = row0 + ty + 16 * i;
    if (m >= M) continue;
    const float s = sx[m];
#pragma unroll
    for (int j = 0; j < G::TN; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n >= N) continue;
      float v = __fadd_rn(dequant(acc[i][j], s, sw[n]), bias[n]);
      if (n < HN) v = __fmul_rn(v, sm_scale);
      store_qkv<T>(qkv, v, m, n, B, L, nh, hd);
    }
  }
}

// Grid (ceil(slots nh hd / 64), ceil(B L / 64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    qkv_proj_i8_kernel(const int8_t* x8, const float* sx, const int8_t* w8, const float* sw,
                       const float* bias, T* qkv, int B, int L, int H, int nh, int hd,
                       float sm_scale, int slots) {
  __shared__ int smem[TileGemmI8<64, 64>::kSmemWords];
  qkv_proj_tile_i8<T>(x8, sx, w8, sw, bias, qkv, B, L, H, nh, hd, sm_scale, blockIdx.y * 64,
                      blockIdx.x * 64, smem, slots);
}

template <typename T>
inline cudaError_t launch_qkv_proj_i8(const int8_t* x8, const float* sx, const int8_t* w8,
                                      const float* sw, const float* bias, T* qkv, int B, int L,
                                      int H, int nh, int hd, float sm_scale,
                                      cudaStream_t stream, int slots = 3) {
  if (H % 4) return cudaErrorInvalidValue;
  const dim3 grid((slots * nh * hd + 63) / 64, (B * L + 63) / 64);
  qkv_proj_i8_kernel<T><<<grid, kThreads, 0, stream>>>(x8, sx, w8, sw, bias, qkv, B, L, H, nh, hd,
                                                       sm_scale, slots);
  return cudaGetLastError();
}

// The W8A8 twin of residual_ln_rowblock for the kLnRows rows from row0:
// v = sum over the G groups of dequant(A8[:, group] . W8[group, :]) with the
// group's row scales sa (M, G) and column scales sw (G, N), bias added to the
// first group's part (the TPU kernel's order: part_0 + b, then + part_g),
// then + resid and LayerNorm (or v alone when fuse_ln == 0). Each group of
// K / G depth is its own int32 product, as on the TPU, where every head
// group quantised its ctx columns on its own.
template <typename T>
__device__ __forceinline__ void residual_ln_rowblock_i8(
    const int8_t* A, const float* sa, const int8_t* W, const float* sw, const float* bias,
    const T* resid, const float* ln_scale, const float* ln_bias, float* rows, T* out, int M,
    int N, int K, int G, float eps, int fuse_ln, int row0, int* smem) {
  using Gm = TileGemmI8<kLnRows, kLnCols>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, W_ = K / G;
  for (int col0 = 0; col0 < N; col0 += kLnCols) {
    float v[Gm::TM][Gm::TN];
    for (int g = 0; g < G; ++g) {
      int acc[Gm::TM][Gm::TN];
      Gm::run(A, W, M, N, K, g * W_, (g + 1) * W_, row0, col0, acc, smem);
#pragma unroll
      for (int i = 0; i < Gm::TM; ++i) {
        const int m = row0 + ty + 16 * i;
        const float s = m < M ? sa[(size_t)m * G + g] : 0.0f;
#pragma unroll
        for (int j = 0; j < Gm::TN; ++j) {
          const int c = col0 + tx + 16 * j;
          const float part = c < N ? dequant(acc[i][j], s, sw[(size_t)g * N + c]) : 0.0f;
          v[i][j] = g == 0 ? __fadd_rn(part, c < N ? bias[c] : 0.0f) : __fadd_rn(v[i][j], part);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Gm::TM; ++i) {
      const int m = row0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < Gm::TN; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c >= N) continue;
        float r = v[i][j];
        if (fuse_ln) r = __fadd_rn(r, to_f32(resid[(size_t)m * N + c]));
        rows[(size_t)m * N + c] = r;
      }
    }
  }
  __syncthreads();  // makes the block's global writes visible to the block
  ln_rows<T>(rows, ln_scale, ln_bias, out, M, N, eps, fuse_ln, row0);
}

// Grid (ceil(M / kLnRows)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_ln_i8_kernel(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                          const float* bias, const T* resid, const float* ln_scale,
                          const float* ln_bias, float* rows, T* out, int M, int N, int K, int G,
                          float eps, int fuse_ln) {
  __shared__ int smem[TileGemmI8<kLnRows, kLnCols>::kSmemWords];
  residual_ln_rowblock_i8<T>(A, sa, W, sw, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, G,
                             eps, fuse_ln, blockIdx.x * kLnRows, smem);
}

template <typename T>
inline cudaError_t launch_residual_ln_i8(const int8_t* A, const float* sa, const int8_t* W,
                                         const float* sw, const float* bias, const T* resid,
                                         const float* ln_scale, const float* ln_bias, float* rows,
                                         T* out, int M, int N, int K, int G, float eps,
                                         int fuse_ln, cudaStream_t stream) {
  if (G <= 0 || K % G || (K / G) % 4) return cudaErrorInvalidValue;
  residual_ln_i8_kernel<T><<<(M + kLnRows - 1) / kLnRows, kThreads, 0, stream>>>(
      A, sa, W, sw, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, G, eps, fuse_ln);
  return cudaGetLastError();
}

}  // namespace spk
