// Device code of the W8A8 paths (int8_matmul.cu, attention_block.cu,
// mlp_block.cu, stack_block.cu, sliding_block.cu, bigbird_block.cu,
// ponet_block.cu): the row quantiser, an int8 GEMM tile on the tensor cores
// (mma.sync m16n8k32 s8 with int32 accumulators), and the epilogues the
// encoder needs (dequant + bias + activation, the same quantised again with
// one static scale, the q/k/v scatter, and residual + LayerNorm over whole
// rows with per-head-group scales).
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
// int32, and the tensor cores' s8 product accumulates in int32 exactly, as
// __dp4a did; only the conversion to float32 rounds. So the tile gives the
// same int32 sums whatever its shape, and every epilogue the same outputs.
//
// The tile (TileGemmI8). A is (M, K) row-major int8; the weight B is
// K-major, (N, K) int8 with each output column's K bytes contiguous (the
// wrappers hand the (K, N) weights over transposed, once a call). A k-stage
// is 64 deep: both operands' 64-byte row slices are copied into shared
// memory by cp.async, 16 bytes a copy (4 where K, k_lo or a base pointer is
// not a multiple of 16), into a ring of three stages, so two stages are in
// flight while the warps multiply the third (61.4 KB for a 128 x 128 tile).
// Staged rows are padded by 16 bytes, to an odd number of 16-byte units:
// the 8 row addresses of one ldmatrix phase then fall on 8 distinct 16-byte
// bank groups. Fragments are read with ldmatrix (its b16 form reads
// four consecutive int8 of a K-major row as one element, which is the
// m16n8k32 s8 fragment as it stands) and multiplied by mma.sync; the 8 warps
// of a block stand 2 x 4, each owning a (BM / 2) x (BN / 4) sub-tile of
// m16 x n8 fragments. Rows past M, columns past N and the part of a stage
// past k_hi (a k-tail, or the end of a head group) are zero-filled through
// cp.async's source size, so they add nothing to the sums.
//
// What bounds it. The encoder's products are hundreds of operations a byte,
// so bound by the tensor cores' int8 rate (1,979 TOPS dense). mma.sync
// reaches only part of it: each warp issues its own ldmatrix and mma, and a
// block waits at one barrier a 64-deep stage. wgmma with TMA, which Hopper
// needs for its full rate, is later work; the epilogues here already work
// on the accumulator fragments, which it keeps in the same places.
#pragma once

#include "bf16_gemm.cuh"

namespace spk {

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

// The tile's shape, chosen by timing kernels 5, 2 and 3 W8A8 at other depths,
// ring lengths and row counts on the card (PERF.md, "Tile shape").
constexpr int kTileK8 = 64;   // int8 depth of one k-stage (32-byte mma k-steps)
constexpr int kStages8 = 3;   // k-stages in the shared-memory ring
constexpr int kRowBytes8 = kTileK8 + 16;  // a staged row, padded by 16 bytes
static_assert(kTileK8 % 32 == 0 && kStages8 >= 2, "whole mma k-steps, a ring of two or more");
// The output tiles: (kGemmRows8 x kGemmCols8) for the GEMM, 2b and
// projection kernels; the residual-LayerNorm blocks own kLnRows8 whole rows
// and walk them kLnCols8 columns at a time (their own constants: kLnRowsB and
// kLnColsB in bf16_gemm.cuh shape the float kernels).
constexpr int kGemmRows8 = 128, kGemmCols8 = 128;
constexpr int kLnRows8 = 64, kLnCols8 = 128;

// One BM x BN tile of the int32 product A[:, k_lo:k_hi] . B[:, k_lo:k_hi]^T
// of int8 A (M, K) and K-major B (N, K), on 256 threads (the file's header
// describes it); K, k_lo and k_hi are multiples of 4. acc[mi][ni][e] is the
// sum at tile row row(mi, e) and column col(ni, e). smem holds kSmemBytes,
// 16-byte aligned; the tile leaves it free (all copies landed, every warp
// past its last read) when it returns.
template <int BM, int BN>
struct TileGemmI8 {
  static constexpr int kWarpsN = 4;                     // warps stand 2 x 4
  static constexpr int WM = BM / 2, WN = BN / kWarpsN;  // a warp's sub-tile
  static_assert(kThreads == 256, "the warps stand 2 x 4");
  static_assert(WM % 16 == 0 && WN % 16 == 0 && WM >= 32 && WN >= 32,
                "a warp owns at least 32 x 32, in m16 x n16 steps");
  static constexpr int MI = WM / 16, NI = WN / 8;  // m16 and n8 fragments a warp
  static constexpr int kStageBytes = (BM + BN) * kRowBytes8;
  static constexpr int kSmemBytes = kStages8 * kStageBytes;
  using Acc = int[MI][NI][4];

  __device__ static int row(int mi, int e) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return (warp / kWarpsN) * WM + mi * 16 + lane / 4 + 8 * (e / 2);
  }

  __device__ static int col(int ni, int e) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return (warp % kWarpsN) * WN + ni * 8 + 2 * (lane % 4) + e % 2;
  }

  // f(r, c, acc at (r, c), acc at (r, c + 1)) for each pair of neighbouring
  // columns a thread holds (c even), in tile coordinates
  template <typename F>
  __device__ static void for_pairs(const Acc& acc, F&& f) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          f(row(mi, 2 * h), col(ni, 0), acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  }

  // Copy rows [r0, r0 + R) x columns [k0, k0 + kTileK8) of X (rows, K) into dst,
  // zero past `rows` and past k_hi.
  template <int R, bool kVec16>
  __device__ static void stage(const int8_t* X, int rows, int K, int r0, int k0, int k_hi,
                               unsigned char* dst) {
    constexpr int kBytes = kVec16 ? 16 : 4, kPerRow = kTileK8 / kBytes, kCopies = R * kPerRow;
#pragma unroll
    for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kCopies % kThreads && e >= kCopies) break;
      const int r = e / kPerRow, c = e % kPerRow;
      const int gr = r0 + r, gk = k0 + kBytes * c;
      const int bytes = gr < rows ? max(0, min(kBytes, k_hi - gk)) : 0;
      const int8_t* src = bytes > 0 ? X + (size_t)gr * K + gk : X;
      const uint32_t d = smem_addr(dst + r * kRowBytes8 + kBytes * c);
      if constexpr (kVec16) {
        cp_async16(d, src, bytes);
      } else {
        cp_async4(d, src, bytes);
      }
    }
  }

  template <bool kVec16>
  __device__ static void pipeline(const int8_t* A, const int8_t* B, int M, int N, int K, int k_lo,
                                  int k_hi, int row0, int col0, Acc& acc, unsigned char* smem) {
    const int nk = (k_hi - k_lo + kTileK8 - 1) / kTileK8;
    const auto load = [&](int kt) {
      unsigned char* s = smem + (kt % kStages8) * kStageBytes;
      const int k0 = k_lo + kt * kTileK8;
      stage<BM, kVec16>(A, M, K, row0, k0, k_hi, s);
      stage<BN, kVec16>(B, N, K, col0, k0, k_hi, s + BM * kRowBytes8);
    };
#pragma unroll
    for (int s = 0; s < kStages8 - 1; ++s) {
      if (s < nk) load(s);
      cp_async_commit();
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // ldmatrix.x4 row addresses: A's four 8 x 16-byte matrices are (rows
    // 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31) of an m16 x
    // k32 fragment; B's are (n 0-7, k 0-15), (0-7, 16-31), (8-15, 0-15),
    // (8-15, 16-31) of two n8 x k32 fragments
    const int a_off = ((warp / kWarpsN) * WM + lane % 16) * kRowBytes8 + (lane / 16) * 16;
    const int b_off = (BM + (warp % kWarpsN) * WN + lane % 8 + 8 * (lane / 16)) * kRowBytes8 +
                      ((lane / 8) % 2) * 16;
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages8 - 2>();  // stage kt has landed
      __syncthreads();                // and every warp is done with stage kt - 1's slot
      if (kt + kStages8 - 1 < nk) load(kt + kStages8 - 1);
      cp_async_commit();
      const uint32_t base = smem_addr(smem + (kt % kStages8) * kStageBytes);
#pragma unroll
      for (int ks = 0; ks < kTileK8 / 32; ++ks) {
        uint32_t a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4(base + a_off + mi * 16 * kRowBytes8 + ks * 32, a[mi]);
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(base + b_off + nj * 16 * kRowBytes8 + ks * 32, r);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  __device__ static void run(const int8_t* A, const int8_t* B, int M, int N, int K, int k_lo,
                             int k_hi, int row0, int col0, Acc& acc, unsigned char* smem) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    const bool vec16 = K % 16 == 0 && k_lo % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) % 16 == 0;
    if (vec16) {
      pipeline<true>(A, B, M, N, K, k_lo, k_hi, row0, col0, acc, smem);
    } else {
      pipeline<false>(A, B, M, N, K, k_lo, k_hi, row0, col0, acc, smem);
    }
  }
};

using GemmTileI8 = TileGemmI8<kGemmRows8, kGemmCols8>;
using LnTileI8 = TileGemmI8<kLnRows8, kLnCols8>;

// out = act(dequant(A8 . W8) + bias) in Tout for the GemmTileI8 tile at
// (row0, col0): W8 (N, K) K-major, sa (M,) row scales, sw (N,) column
// scales, bias (N,) or null.
template <typename Tout>
__device__ __forceinline__ void gemm_act_tile_i8(const int8_t* A, const float* sa,
                                                 const int8_t* W, const float* sw,
                                                 const float* bias, Tout* out, int M, int N,
                                                 int K, int act, int row0, int col0,
                                                 unsigned char* smem) {
  using G = GemmTileI8;
  G::Acc acc;
  G::run(A, W, M, N, K, 0, K, row0, col0, acc, smem);
  G::for_pairs(acc, [&](int r, int c, int a0, int a1) {
    const int m = row0 + r, n = col0 + c;
    if (m >= M || n >= N) return;
    const bool both = n + 1 < N;
    const float s = sa[m];
    float v0 = dequant(a0, s, sw[n]), v1 = both ? dequant(a1, s, sw[n + 1]) : 0.0f;
    if (bias != nullptr) {
      v0 = __fadd_rn(v0, bias[n]);
      if (both) v1 = __fadd_rn(v1, bias[n + 1]);
    }
    store_pair(out, (size_t)m * N + n, apply_activation(v0, act),
               both ? apply_activation(v1, act) : 0.0f, both);
  });
}

// Grid (ceil(N / kGemmCols8), ceil(M / kGemmRows8)), GemmTileI8::kSmemBytes
// of dynamic shared memory.
template <typename Tout>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_act_i8_kernel(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                       const float* bias, Tout* out, int M, int N, int K, int act) {
  extern __shared__ __align__(16) unsigned char smem_i8[];
  gemm_act_tile_i8<Tout>(A, sa, W, sw, bias, out, M, N, K, act, blockIdx.y * kGemmRows8,
                         blockIdx.x * kGemmCols8, smem_i8);
}

template <typename Tout>
inline cudaError_t launch_gemm_i8(const int8_t* A, const float* sa, const int8_t* W,
                                  const float* sw, const float* bias, Tout* out, int M, int N,
                                  int K, int act, cudaStream_t stream) {
  if (K % 4) return cudaErrorInvalidValue;
  constexpr int smem = GemmTileI8::kSmemBytes;
  const cudaError_t err = prepare(gemm_act_i8_kernel<Tout>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kGemmCols8 - 1) / kGemmCols8, (M + kGemmRows8 - 1) / kGemmRows8);
  gemm_act_i8_kernel<Tout><<<grid, kThreads, smem, stream>>>(A, sa, W, sw, bias, out, M, N, K,
                                                             act);
  return cudaGetLastError();
}

// The W8A8 MLP's first product under a static intermediate scale (the TPU
// kernel's static_h_scale) for the GemmTileI8 tile at (row0, col0): h =
// act(dequant(A8 . W8) + bias) in float32, then q = clip(rint(h * (1 / s)),
// -127, 127) with the one per-tensor scale s = *hs, stored int8: no row
// absmax, and h never leaves the registers. The tiles of the first column
// also write s as every row's scale, for the second product's dequant.
__device__ __forceinline__ void gemm_act_quant_tile_i8(const int8_t* A, const float* sa,
                                                       const int8_t* W, const float* sw,
                                                       const float* bias, const float* hs,
                                                       int8_t* out, float* out_scales, int M,
                                                       int N, int K, int act, int row0, int col0,
                                                       unsigned char* smem) {
  using G = GemmTileI8;
  G::Acc acc;
  G::run(A, W, M, N, K, 0, K, row0, col0, acc, smem);
  const float s = *hs, inv = 1.0f / s;
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = row0 + G::row(mi, e), n = col0 + G::col(ni, e);
        if (m >= M) continue;
        if (n == 0) out_scales[m] = s;  // the one thread of the row's column 0
        if (n >= N) continue;
        float v = dequant(acc[mi][ni][e], sa[m], sw[n]);
        if (bias != nullptr) v = __fadd_rn(v, bias[n]);
        const float q = rintf(__fmul_rn(apply_activation(v, act), inv));
        out[(size_t)m * N + n] = static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
      }
}

// Grid (ceil(N / kGemmCols8), ceil(M / kGemmRows8)), GemmTileI8::kSmemBytes
// of dynamic shared memory. out and out_scales must not alias A and sa:
// other blocks still read those.
template <int kUnused = 0>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_act_quant_i8_kernel(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                             const float* bias, const float* hs, int8_t* out, float* out_scales,
                             int M, int N, int K, int act) {
  extern __shared__ __align__(16) unsigned char smem_i8[];
  gemm_act_quant_tile_i8(A, sa, W, sw, bias, hs, out, out_scales, M, N, K, act,
                         blockIdx.y * kGemmRows8, blockIdx.x * kGemmCols8, smem_i8);
}

inline cudaError_t launch_gemm_act_quant_i8(const int8_t* A, const float* sa, const int8_t* W,
                                            const float* sw, const float* bias, const float* hs,
                                            int8_t* out, float* out_scales, int M, int N, int K,
                                            int act, cudaStream_t stream) {
  if (K % 4) return cudaErrorInvalidValue;
  constexpr int smem = GemmTileI8::kSmemBytes;
  const cudaError_t err = prepare(gemm_act_quant_i8_kernel<>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kGemmCols8 - 1) / kGemmCols8, (M + kGemmRows8 - 1) / kGemmRows8);
  gemm_act_quant_i8_kernel<><<<grid, kThreads, smem, stream>>>(A, sa, W, sw, bias, hs, out,
                                                               out_scales, M, N, K, act);
  return cudaGetLastError();
}

// The W8A8 projection of the GemmTileI8 tile at (row0, col0) of x8 . w8
// with w8 (slots nh hd, H) K-major: dequant + bias, slot 0 times sm_scale (1
// keeps it unscaled), in T, scattered to (slots, B, nh, L, hd): q, k, v with
// slots = 3, the Longformer global k, v with slots = 2 and sm_scale = 1.
template <typename T>
__device__ __forceinline__ void qkv_proj_tile_i8(const int8_t* x8, const float* sx,
                                                 const int8_t* w8, const float* sw,
                                                 const float* bias, T* qkv, int B, int L, int H,
                                                 int nh, int hd, float sm_scale, int row0,
                                                 int col0, unsigned char* smem, int slots = 3) {
  using G = GemmTileI8;
  const int M = B * L, HN = nh * hd, N = slots * HN;
  G::Acc acc;
  G::run(x8, w8, M, N, H, 0, H, row0, col0, acc, smem);
  // n and n + 1 (n even) are neighbours d, d + 1 of one head: hd is even
  G::for_pairs(acc, [&](int r, int c, int a0, int a1) {
    const int m = row0 + r, n = col0 + c;
    if (m >= M || n >= N) return;
    const float s = sx[m];
    float v0 = __fadd_rn(dequant(a0, s, sw[n]), bias[n]);
    float v1 = __fadd_rn(dequant(a1, s, sw[n + 1]), bias[n + 1]);
    if (n < HN) {
      v0 = __fmul_rn(v0, sm_scale);
      v1 = __fmul_rn(v1, sm_scale);
    }
    const int b = m / L, l = m - b * L, sl = n / HN, rr = n - sl * HN, h = rr / hd, d = rr - h * hd;
    store_pair(qkv, ((((size_t)sl * B + b) * nh + h) * L + l) * hd + d, v0, v1, true);
  });
}

// Grid (ceil(slots nh hd / kGemmCols8), ceil(B L / kGemmRows8)),
// GemmTileI8::kSmemBytes of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    qkv_proj_i8_kernel(const int8_t* x8, const float* sx, const int8_t* w8, const float* sw,
                       const float* bias, T* qkv, int B, int L, int H, int nh, int hd,
                       float sm_scale, int slots) {
  extern __shared__ __align__(16) unsigned char smem_i8[];
  qkv_proj_tile_i8<T>(x8, sx, w8, sw, bias, qkv, B, L, H, nh, hd, sm_scale,
                      blockIdx.y * kGemmRows8, blockIdx.x * kGemmCols8, smem_i8, slots);
}

template <typename T>
inline cudaError_t launch_qkv_proj_i8(const int8_t* x8, const float* sx, const int8_t* w8,
                                      const float* sw, const float* bias, T* qkv, int B, int L,
                                      int H, int nh, int hd, float sm_scale,
                                      cudaStream_t stream, int slots = 3) {
  if (H % 4) return cudaErrorInvalidValue;
  constexpr int smem = GemmTileI8::kSmemBytes;
  const cudaError_t err = prepare(qkv_proj_i8_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((slots * nh * hd + kGemmCols8 - 1) / kGemmCols8,
                  (B * L + kGemmRows8 - 1) / kGemmRows8);
  qkv_proj_i8_kernel<T><<<grid, kThreads, smem, stream>>>(x8, sx, w8, sw, bias, qkv, B, L, H, nh,
                                                          hd, sm_scale, slots);
  return cudaGetLastError();
}

// The W8A8 twin of residual_ln_rowblock for the kLnRows8 rows from row0:
// v = sum over the G groups of dequant(A8[:, group] . W8[:, group]^T) with
// W8 (N, K) K-major (head group g is its K-columns [g K / G, (g + 1) K /
// G)), the group's row scales sa (M, G) and column scales sw (G, N), bias
// added to the first group's part (the TPU kernel's order: part_0 + b, then
// + part_g), then + resid and LayerNorm (or v alone when fuse_ln == 0). Each
// group of K / G depth is its own int32 product, as on the TPU, where every
// head group quantised its ctx columns on its own. The block walks its rows'
// N columns kLnCols8 at a time, writes the pre-norm rows in float32 to
// `rows` (M, N) and normalises them (ln_rows), as the float twin does.
template <typename T>
__device__ __forceinline__ void residual_ln_rowblock_i8(
    const int8_t* A, const float* sa, const int8_t* W, const float* sw, const float* bias,
    const T* resid, const float* ln_scale, const float* ln_bias, float* rows, T* out, int M,
    int N, int K, int G, float eps, int fuse_ln, int row0, unsigned char* smem) {
  using Gm = LnTileI8;
  const int W_ = K / G;
  for (int col0 = 0; col0 < N; col0 += kLnCols8) {
    float v[Gm::MI][Gm::NI][4];
    for (int g = 0; g < G; ++g) {
      Gm::Acc acc;
      Gm::run(A, W, M, N, K, g * W_, (g + 1) * W_, row0, col0, acc, smem);
#pragma unroll
      for (int mi = 0; mi < Gm::MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = row0 + Gm::row(mi, e);
          const float s = m < M ? sa[(size_t)m * G + g] : 0.0f;
#pragma unroll
          for (int ni = 0; ni < Gm::NI; ++ni) {
            const int c = col0 + Gm::col(ni, e);
            const float part = c < N ? dequant(acc[mi][ni][e], s, sw[(size_t)g * N + c]) : 0.0f;
            v[mi][ni][e] = g == 0 ? __fadd_rn(part, c < N ? bias[c] : 0.0f)
                                  : __fadd_rn(v[mi][ni][e], part);
          }
        }
    }
#pragma unroll
    for (int mi = 0; mi < Gm::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < Gm::NI; ++ni) {
          const int m = row0 + Gm::row(mi, 2 * h), c = col0 + Gm::col(ni, 0);
          if (m >= M || c >= N) continue;
          const bool both = c + 1 < N;
          const size_t i = (size_t)m * N + c;
          float r0 = v[mi][ni][2 * h], r1 = v[mi][ni][2 * h + 1];
          if (fuse_ln) {
            r0 = __fadd_rn(r0, to_f32(resid[i]));
            if (both) r1 = __fadd_rn(r1, to_f32(resid[i + 1]));
          }
          store_pair(rows, i, r0, r1, both);
        }
  }
  __syncthreads();  // makes the block's global writes visible to the block
  ln_rows<T, kLnRows8>(rows, ln_scale, ln_bias, out, M, N, eps, fuse_ln, row0);
}

// Grid (ceil(M / kLnRows8)), LnTileI8::kSmemBytes of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    residual_ln_i8_kernel(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                          const float* bias, const T* resid, const float* ln_scale,
                          const float* ln_bias, float* rows, T* out, int M, int N, int K, int G,
                          float eps, int fuse_ln) {
  extern __shared__ __align__(16) unsigned char smem_i8[];
  residual_ln_rowblock_i8<T>(A, sa, W, sw, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, G,
                             eps, fuse_ln, blockIdx.x * kLnRows8, smem_i8);
}

template <typename T>
inline cudaError_t launch_residual_ln_i8(const int8_t* A, const float* sa, const int8_t* W,
                                         const float* sw, const float* bias, const T* resid,
                                         const float* ln_scale, const float* ln_bias, float* rows,
                                         T* out, int M, int N, int K, int G, float eps,
                                         int fuse_ln, cudaStream_t stream) {
  if (G <= 0 || K % G || (K / G) % 4) return cudaErrorInvalidValue;
  constexpr int smem = LnTileI8::kSmemBytes;
  const cudaError_t err = prepare(residual_ln_i8_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  residual_ln_i8_kernel<T><<<(M + kLnRows8 - 1) / kLnRows8, kThreads, smem, stream>>>(
      A, sa, W, sw, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, G, eps, fuse_ln);
  return cudaGetLastError();
}

}  // namespace spk
