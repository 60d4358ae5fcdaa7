// The float32 products on the tensor cores: TileGemmTf32x3, a float32 GEMM
// tile on mma.sync m16n8k8 TF32 with float32 sums, three products a fragment
// pair (3xTF32). bf16_gemm.cuh takes it for every float32 product of its
// tile functions, kernels and launchers (TileFor): the forward products of
// kernels 1-3, 7-9 and of rows 10-13's training forwards, the products their
// backwards recompute, the backwards' products with a weight read transposed
// (dctx = g Wo^T, dx = dproj W^T, the MLP's dpre = (g W2^T) act' and dx =
// dpre W1^T) and their weight gradients (dW = X^T dY). The float32
// attention cores (attention_core.cuh; the rows and gradient kernels of rows
// 10, 12 and 13 and kernels 7 and 8) take the same split and mma.sync shape
// (ptx.cuh tf32_split, mma_tf32x3) on their own tiles; the Longformer global
// rows stay on the CUDA cores in float32.
//
// Replaces no TPU kernel of its own: it is the product tile of the float32
// modes of the TPU kernels under spokennlp_tpu/ops/pallas/ that this port's
// float32 GEMMs replace (the jnp.dot of attention_block.py, mlp_block.py,
// stack_block.py, sliding_block.py, bigbird_block_kernel.py, ponet_block.py,
// train_blocks.py, train_sliding.py and train_bigbird.py in float32), which
// ran on the CUDA cores.
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
// activation, gate, residual and LayerNorm are float32 (bf16_gemm.cuh's
// epilogues, shared with the bf16 tile); a weight gradient's bias gradient is
// the plain float32 column sum of the staged dY, never a TF32 product. The
// tensor cores' float32 sums truncate, so the tile's error grows with the
// depth: about 3e-5 of a product in norm at 4608.
//
// The tile. It multiplies A (M, K) by B (K, N) on 256 threads: 8 warps
// standing 2 x 4, each owning a (BM / 2) x (BN / 4) sub-tile of m16 x n8
// fragments. A is stored row-major (M, K), or (K, M) when kTransA (the
// weight gradient's X^T); B row-major (K, N), as the forward weights, or (N,
// K) when kTransB (a weight read transposed). A k-stage is 32 floats deep
// (four k8 steps); each stage's slices of A and B are copied into shared
// memory by cp.async into a ring of three stages, 16 bytes a copy where the
// stored widths and the base pointers allow it, else 4; rows past M, columns
// past N and depth past the k-range's end are zero-filled through the
// copy's source size. An operand whose stored rows run along k (A (M, K), B
// (N, K)) is staged as 32-float rows padded to 36 floats: an odd number of
// 16-byte units, so the 8 row addresses of one ldmatrix phase fall on 8
// distinct bank groups; ldmatrix (no .trans) reads its fragments, each 8 x
// 8 b16 matrix being 8 rows of 4 floats, which is a TF32 fragment's layout
// (A: m16 x k8; B: two n8 x k8 fragments a load). An operand whose stored
// rows run along m or n (A (K, M), B (K, N)) has its fragments down a
// column of the staged slice, which ldmatrix (16-bit transposes only)
// cannot read, so each lane reads its 32-bit values itself; those rows are
// padded to BM + 8 or BN + 8 floats, so that the 32 lanes of one fragment
// load (k = t, m or n = g) fall on 32 distinct banks. Each k8 step splits
// the warp's B fragments once and keeps them for its m16 tiles, and splits
// each A fragment once for its n8 tiles.
//
// What bounds it. Kernel 9 at PoNet-base (B=8, L=4096, H=768) does 232 GFLOP
// of products: 1.41 ms at 165 TFLOP/s; kernel 2 at BERT-base (M = 16384,
// H=768, I=3072) 155 GFLOP: 0.94 ms; row 11's backward five products of 387
// GFLOP: 2.34 ms. mma.sync reaches part of the tensor cores' rate (wgmma
// takes TF32 only from K-major operands in shared memory, which needs a
// transposed weight copy: later work).
#pragma once

#include "ptx.cuh"

namespace spk {

constexpr int kTileKF = 32;  // floats of a k-stage
constexpr int kStagesF = 3;

// One BM x BN tile of the product (the file's header describes it).
// acc[mi][ni][e] is the sum at tile row row(mi, e) and column col(ni, e).
// The sum runs over k in [k_begin, K); a k_begin above 0 (a range of the
// rows a weight gradient sums) needs K to be no stride, that is kTransA and
// !kTransB. smem holds kSmemBytes, 16-byte aligned; the tile leaves it free
// (all copies landed, every warp past its last read) when it returns.
template <int BM, int BN, bool kTransA = false, bool kTransB = false>
struct TileGemmTf32x3 {
  static constexpr int kRows = BM, kCols = BN;
  static constexpr int kWarpsN = 4;                     // warps stand 2 x 4
  static constexpr int WM = BM / 2, WN = BN / kWarpsN;  // a warp's sub-tile
  static_assert(kThreads == 256, "the warps stand 2 x 4");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "a warp owns m16 x n16 steps");
  static_assert(!kTransA || !kTransB, "no caller reads both operands transposed");
  static constexpr int MI = WM / 16, NI = WN / 8;  // m16 and n8 fragments a warp
  // staged rows: 32-float rows of A (m) or of a transposed B (n), or rows
  // of BM (A stored (K, M)) or BN (B stored (K, N)) floats, each padded
  static constexpr int kKRow = kTileKF + 4;  // floats: 9 16-byte units
  static constexpr int kARow = kTransA ? BM + 8 : kKRow;
  static constexpr int kBRow = kTransB ? kKRow : BN + 8;
  static_assert(kKRow % 8 == 4 && (BM + 8) % 32 == 8 && (BN + 8) % 32 == 8,
                "conflict-free fragment reads");
  static constexpr int kAFloats = (kTransA ? kTileKF : BM) * kARow;
  static constexpr int kStageFloats = kAFloats + (kTransB ? BN : kTileKF) * kBRow;
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
    tf32_split(x, big, small);
  }

  // Copy R rows of W floats of X (rows, cols), from (r0, c0), into dst (rows
  // of `pitch` floats), zero past `rows` and `cols`, by cp.async of kBytes
  // (16: four floats, or 4: one). `cols` is X's stride too; `rows` only
  // bounds.
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

  // With bsum != null (kTransA and !kTransB only), the threads also sum each
  // of B's staged columns over the k-range in float32, as TileGemmBf16 does
  // (bf16_gemm.cuh): thread t takes column t % BN of rows (t / BN) kSumRows
  // to (t / BN + 1) kSumRows - 1 of each stage, and the 256 / BN partial
  // sums of a column are added in order at the end into bsum[col0 + c], for
  // the columns below N.
  template <int kBytes>
  __device__ static void pipeline(const float* A, const float* B, int M, int N, int K,
                                  int k_begin, int row0, int col0, Acc& acc, float* smem,
                                  float* bsum) {
    const int nk = max(0, (K - k_begin + kTileKF - 1) / kTileKF);
    const auto load = [&](int kt) {
      float* s = smem + (kt % kStagesF) * kStageFloats;
      const int k0 = k_begin + kt * kTileKF;
      if constexpr (kTransA) {
        stage<kTileKF, BM, kBytes>(A, K, M, k0, row0, kARow, s);
      } else {
        stage<BM, kTileKF, kBytes>(A, M, K, row0, k0, kARow, s);
      }
      if constexpr (kTransB) {
        stage<BN, kTileKF, kBytes>(B, N, K, col0, k0, kBRow, s + kAFloats);
      } else {
        stage<kTileKF, BN, kBytes>(B, K, N, k0, col0, kBRow, s + kAFloats);
      }
    };
#pragma unroll
    for (int s = 0; s < kStagesF - 1; ++s) {
      if (s < nk) load(s);
      cp_async_commit();
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int wm0 = (warp / kWarpsN) * WM, wn0 = (warp % kWarpsN) * WN;
    // A stored (M, K): ldmatrix.x4 row addresses of A's four 8 x 4-float
    // matrices (rows 0-7, k 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7): a0,
    // a1, a2, a3 of a TF32 m16 x k8 fragment. A stored (K, M): the lane's
    // (k t, m g). B stored (K, N): the lane's (k t, n g), b0, and (k t + 4,
    // n g), b1. B stored (N, K): ldmatrix.x4 row addresses of (n 0-7, k
    // 0-3), (0-7, 4-7), (8-15, 0-3), (8-15, 4-7): b0 and b1 of two n8
    // fragments.
    const int a_off = kTransA ? t * kARow + wm0 + g : (wm0 + lane % 16) * kARow + (lane / 16) * 4;
    const int b_off =
        kAFloats + (kTransB ? (wn0 + (lane / 16) * 8 + lane % 8) * kBRow + ((lane / 8) % 2) * 4
                            : t * kBRow + wn0 + g);
    constexpr int kSumRows = kTileKF * BN / kThreads;  // rows of a column a thread sums
    float col_sum = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStagesF - 2>();  // stage kt has landed
      __syncthreads();                // and every warp is done with stage kt - 1's slot
      if (kt + kStagesF - 1 < nk) load(kt + kStagesF - 1);
      cp_async_commit();
      const float* st = smem + (kt % kStagesF) * kStageFloats;
      const uint32_t base = smem_addr(st);
      if constexpr (kTransA && !kTransB) {
        if (bsum != nullptr) {
          const float* c = st + kAFloats + (threadIdx.x / BN) * kSumRows * kBRow + threadIdx.x % BN;
#pragma unroll
          for (int k = 0; k < kSumRows; ++k) col_sum += c[k * kBRow];
        }
      }
#pragma unroll
      for (int ks = 0; ks < kTileKF / 8; ++ks) {
        uint32_t bb[NI][2], bs[NI][2];
        if constexpr (kTransB) {
#pragma unroll
          for (int nj = 0; nj < NI / 2; ++nj) {
            uint32_t r[4];
            ldmatrix_x4(base + 4 * (b_off + nj * 16 * kBRow + ks * 8), r);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              split(__uint_as_float(r[i]), bb[2 * nj + i / 2][i % 2], bs[2 * nj + i / 2][i % 2]);
          }
        } else {
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const float* b = st + b_off + ks * 8 * kBRow + ni * 8;
            split(b[0], bb[ni][0], bs[ni][0]);
            split(b[4 * kBRow], bb[ni][1], bs[ni][1]);
          }
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          uint32_t r[4], ab[4], as[4];
          if constexpr (kTransA) {
            const float* a = st + a_off + ks * 8 * kARow + mi * 16;
            r[0] = __float_as_uint(a[0]);
            r[1] = __float_as_uint(a[8]);
            r[2] = __float_as_uint(a[4 * kARow]);
            r[3] = __float_as_uint(a[4 * kARow + 8]);
          } else {
            ldmatrix_x4(base + 4 * (a_off + mi * 16 * kARow + ks * 8), r);
          }
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
    if constexpr (kTransA && !kTransB) {
      if (bsum != nullptr) {  // the partial sums of each column, added in a fixed order
        static_assert(kThreads % BN == 0 && kTileKF % (kThreads / BN) == 0, "whole columns");
        smem[threadIdx.x] = col_sum;
        __syncthreads();
        if (threadIdx.x < BN && col0 + (int)threadIdx.x < N) {
          float v = 0.0f;
#pragma unroll
          for (int p = 0; p < kThreads / BN; ++p) v += smem[threadIdx.x + p * BN];
          bsum[col0 + threadIdx.x] = v;
        }
        __syncthreads();
      }
    }
  }

  // acc = A . B over the tile at (row0, col0) and the k-range [k_begin, K);
  // bsum: the column sums of pipeline, or null
  __device__ static void run(const float* A, const float* B, int M, int N, int K, int row0,
                             int col0, Acc& acc, unsigned char* smem, int k_begin = 0,
                             float* bsum = nullptr) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    float* s = reinterpret_cast<float*>(smem);
    // the stored widths of A and B
    const int wa = kTransA ? M : K, wb = kTransB ? K : N;
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B);
    if (wa % 4 == 0 && wb % 4 == 0 && ptrs % 16 == 0) {
      pipeline<16>(A, B, M, N, K, k_begin, row0, col0, acc, s, bsum);
    } else {
      pipeline<4>(A, B, M, N, K, k_begin, row0, col0, acc, s, bsum);
    }
  }
};

}  // namespace spk
