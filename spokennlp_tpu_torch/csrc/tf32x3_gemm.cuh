// Kernel 9's float32 products on the tensor cores: TileGemmTf32x3, a
// float32 GEMM tile on mma.sync m16n8k8 TF32 with float32 sums, three
// products a fragment pair (3xTF32), and the two launchers of kernel 9's
// float32 mode (ponet_block.cu): its five projections (launch_gemm_f32tc)
// and its out projection with the residual-LayerNorm epilogue
// (launch_residual_ln_f32tc). Every other float32 caller keeps common.cuh's
// SIMT tile.
//
// Replaces no TPU kernel of its own: it is the product tile of kernel 9's
// float32 mode (spokennlp_tpu/ops/pallas/ponet_block.py, the jnp.dot of
// _ponet_block_kernel in float32), which ran on the CUDA cores.
//
// The split. TF32 keeps 10 of float32's 23 mantissa bits, so one TF32
// product of float32 operands errs by about 5e-4 of each term. Each operand
// x is split into big = tf32(x) and small = tf32(x - big) (cvt.rna: to
// nearest, ties away from zero), and a product takes
//   acc += small_a . big_b;  acc += big_a . small_b;  acc += big_a . big_b
// (the small terms first; small_a . small_b, about 2^-22 of a term, is left
// out), each TF32 x TF32 product exact in float32. That keeps about
// float32's accuracy (2^-21 or so of a term) at a third of the TF32 tensor
// cores' rate: 495 / 3 = 165 TFLOP/s against 67 on the CUDA cores. Bias,
// residual and LayerNorm are float32 as on the SIMT tile (bf16_gemm.cuh's
// gemm_bias_act_mma and residual_ln_mma epilogues); only the products'
// precision and the order of the float32 sums change.
//
// The tile. It multiplies A (M, K) row-major by B (K, N) row-major, as the
// forward weights are stored, on 256 threads: 8 warps standing 2 x 4, each
// owning a (BM / 2) x (BN / 4) sub-tile of m16 x n8 fragments. A k-stage
// is 32 floats deep (four k8 steps); each stage's slices of A and B are
// copied into shared memory by cp.async into a ring of three stages, 16
// bytes a copy where K, N and the base pointers allow it, else 4; rows past
// M, columns past N and depth past K are zero-filled through the copy's
// source size. Staged A rows are padded to 36 floats: an odd number of
// 16-byte units, so the 8 row addresses of one ldmatrix phase fall on 8
// distinct bank groups; ldmatrix (no .trans) reads A's fragments, each
// 8 x 8 b16 matrix being 8 rows of 4 floats, which is a TF32 A fragment's
// layout. B's fragments run along k down a column of the row-major slice,
// which ldmatrix (16-bit transposes only) cannot read, so each lane reads
// its two 32-bit values itself; staged B rows are padded to BN + 8 floats,
// so that the 32 lanes of one fragment load (k = t, n = g) fall on 32
// distinct banks. Each k8 step splits the warp's B fragments once and
// keeps them for its m16 tiles, and splits each A fragment once for its n8
// tiles.
//
// What bounds it. Kernel 9 at PoNet-base (B=8, L=4096, H=768) does 232 GFLOP
// of products: 1.41 ms at 165 TFLOP/s. mma.sync reaches part of the tensor
// cores' rate (wgmma takes TF32 only from K-major operands in shared
// memory, which needs a transposed weight copy: later work).
#pragma once

#include "bf16_gemm.cuh"

namespace spk {

constexpr int kTileKF = 32;  // floats of a k-stage
constexpr int kStagesF = 3;

template <int BM, int BN>
struct TileGemmTf32x3 {
  static constexpr int kRows = BM, kCols = BN;
  static constexpr int kWarpsN = 4;                     // warps stand 2 x 4
  static constexpr int WM = BM / 2, WN = BN / kWarpsN;  // a warp's sub-tile
  static_assert(kThreads == 256, "the warps stand 2 x 4");
  static_assert(WM % 16 == 0 && WN % 8 == 0, "a warp owns m16 x n8 steps");
  static constexpr int MI = WM / 16, NI = WN / 8;  // m16 and n8 fragments a warp
  static constexpr int kARow = kTileKF + 4;        // floats: 9 16-byte units
  static constexpr int kBRow = BN + 8;             // floats: 8 mod 32 banks
  static_assert(kARow % 8 == 4 && kBRow % 32 == 8, "conflict-free fragment reads");
  static constexpr int kAFloats = BM * kARow;
  static constexpr int kStageFloats = kAFloats + kTileKF * kBRow;
  static constexpr int kSmemBytes = kStagesF * kStageFloats * (int)sizeof(float);
  using Acc = float[MI][NI][4];

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

  // (big, small) of x: big = tf32(x), small = tf32(x - big)
  __device__ static void split(float x, uint32_t& big, uint32_t& small) {
    big = tf32_rna(x);
    small = tf32_rna(x - __uint_as_float(big));
  }

  // Copy R rows of W floats of X (rows, cols), from (r0, c0), into dst (rows
  // of `pitch` floats), zero past `rows` and `cols`, by cp.async of kBytes
  // (16: four floats, or 4: one). `cols` is X's stride too.
  template <int R, int W, int kBytes>
  __device__ static void stage(const float* X, int rows, int cols, int r0, int c0, int pitch,
                               float* dst) {
    constexpr int kElems = kBytes / 4, kPerRow = W / kElems, kCopies = R * kPerRow;
#pragma unroll
    for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kCopies % kThreads && e >= kCopies) break;
      const int r = e / kPerRow, c = e % kPerRow;
      const int gr = r0 + r, gc = c0 + kElems * c;
      const int n = gr < rows ? max(0, min(kElems, cols - gc)) : 0;
      const float* src = n > 0 ? X + (size_t)gr * cols + gc : X;
      const uint32_t d = smem_addr(dst + r * pitch + kElems * c);
      if constexpr (kBytes == 16) {
        cp_async16(d, src, 4 * n);
      } else {
        cp_async4(d, src, 4 * n);
      }
    }
  }

  template <int kBytes>
  __device__ static void pipeline(const float* A, const float* B, int M, int N, int K, int row0,
                                  int col0, Acc& acc, float* smem) {
    const int nk = (K + kTileKF - 1) / kTileKF;
    const auto load = [&](int kt) {
      float* s = smem + (kt % kStagesF) * kStageFloats;
      const int k0 = kt * kTileKF;
      stage<BM, kTileKF, kBytes>(A, M, K, row0, k0, kARow, s);
      stage<kTileKF, BN, kBytes>(B, K, N, k0, col0, kBRow, s + kAFloats);
    };
#pragma unroll
    for (int s = 0; s < kStagesF - 1; ++s) {
      if (s < nk) load(s);
      cp_async_commit();
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int wm0 = (warp / kWarpsN) * WM, wn0 = (warp % kWarpsN) * WN;
    // ldmatrix.x4 row addresses of A's four 8 x 4-float matrices (rows 0-7,
    // k 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7): a0, a1, a2, a3 of a
    // TF32 m16 x k8 fragment; B's values (k t, n g) and (k t + 4, n g)
    const int a_off = (wm0 + lane % 16) * kARow + (lane / 16) * 4;
    const int b_off = kAFloats + t * kBRow + wn0 + g;
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStagesF - 2>();  // stage kt has landed
      __syncthreads();                // and every warp is done with stage kt - 1's slot
      if (kt + kStagesF - 1 < nk) load(kt + kStagesF - 1);
      cp_async_commit();
      const float* st = smem + (kt % kStagesF) * kStageFloats;
      const uint32_t base = smem_addr(st);
#pragma unroll
      for (int ks = 0; ks < kTileKF / 8; ++ks) {
        uint32_t bb[NI][2], bs[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const float* b = st + b_off + ks * 8 * kBRow + ni * 8;
          split(b[0], bb[ni][0], bs[ni][0]);
          split(b[4 * kBRow], bb[ni][1], bs[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          uint32_t r[4], ab[4], as[4];
          ldmatrix_x4(base + 4 * (a_off + mi * 16 * kARow + ks * 8), r);
#pragma unroll
          for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), ab[i], as[i]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            mma_tf32(acc[mi][ni], as, bb[ni][0], bb[ni][1]);
            mma_tf32(acc[mi][ni], ab, bs[ni][0], bs[ni][1]);
            mma_tf32(acc[mi][ni], ab, bb[ni][0], bb[ni][1]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // acc = A[row0 .., :] . B[:, col0 ..] over the tile; smem holds
  // kSmemBytes, 16-byte aligned, and is free again when it returns
  __device__ static void run(const float* A, const float* B, int M, int N, int K, int row0,
                             int col0, Acc& acc, unsigned char* smem) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    float* s = reinterpret_cast<float*>(smem);
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B);
    if (K % 4 == 0 && N % 4 == 0 && ptrs % 16 == 0) {
      pipeline<16>(A, B, M, N, K, row0, col0, acc, s);
    } else {
      pipeline<4>(A, B, M, N, K, row0, col0, acc, s);
    }
  }
};

using GemmTileF32 = TileGemmTf32x3<128, 128>;
using LnTileF32 = TileGemmTf32x3<64, 128>;

namespace {  // one copy a translation unit: ponet_block.cu includes this file

// out = act(A . W + bias) (M, N) float32, W (K, N); grid (ceil(N / 128),
// ceil(M / 128)), GemmTileF32::kSmemBytes of dynamic shared memory
__global__ void __launch_bounds__(kThreads, 2)
    gemm_bias_act_f32tc_kernel(const float* __restrict__ A, const float* __restrict__ W,
                               const float* __restrict__ bias, float* __restrict__ out, int M,
                               int N, int K, int act) {
  extern __shared__ __align__(16) unsigned char smem_f32tc[];
  gemm_bias_act_mma<GemmTileF32, float>(A, W, bias, out, M, N, K, act, nullptr,
                                        blockIdx.y * GemmTileF32::kRows,
                                        blockIdx.x * GemmTileF32::kCols, smem_f32tc);
}

// out = LayerNorm(resid + A . W + bias) (or A . W + bias when fuse_ln is 0)
// for 64 whole rows a block; grid (ceil(M / 64)), LnTileF32::kSmemBytes
__global__ void __launch_bounds__(kThreads, 2)
    residual_ln_f32tc_kernel(const float* __restrict__ A, const float* __restrict__ W,
                             const float* __restrict__ bias, const float* __restrict__ resid,
                             const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                             float* rows, float* __restrict__ out, int M, int N, int K, float eps,
                             int fuse_ln) {
  extern __shared__ __align__(16) unsigned char smem_f32tc_ln[];
  residual_ln_mma<LnTileF32, float>(A, W, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, eps,
                                    fuse_ln, blockIdx.x * LnTileF32::kRows, smem_f32tc_ln);
}

}  // namespace

// launch_gemm (bias, activation, no gate) for kernel 9's float32 products
inline cudaError_t launch_gemm_f32tc(const float* A, const float* W, const float* bias,
                                     float* out, int M, int N, int K, int act,
                                     cudaStream_t stream) {
  using G = GemmTileF32;
  const cudaError_t err = prepare(gemm_bias_act_f32tc_kernel, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G::kCols - 1) / G::kCols, (M + G::kRows - 1) / G::kRows);
  gemm_bias_act_f32tc_kernel<<<grid, kThreads, G::kSmemBytes, stream>>>(A, W, bias, out, M, N, K,
                                                                       act);
  return cudaGetLastError();
}

// launch_residual_ln for kernel 9's float32 out projection
inline cudaError_t launch_residual_ln_f32tc(const float* A, const float* W, const float* bias,
                                            const float* resid, const float* ln_scale,
                                            const float* ln_bias, float* rows, float* out, int M,
                                            int N, int K, float eps, int fuse_ln,
                                            cudaStream_t stream) {
  using G = LnTileF32;
  const cudaError_t err = prepare(residual_ln_f32tc_kernel, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  residual_ln_f32tc_kernel<<<(M + G::kRows - 1) / G::kRows, kThreads, G::kSmemBytes, stream>>>(
      A, W, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, eps, fuse_ln);
  return cudaGetLastError();
}

}  // namespace spk
