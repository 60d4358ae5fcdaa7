// The float modes' GEMMs (attention_block.cu, mlp_block.cu, stack_block.cu,
// sliding_block.cu, bigbird_block.cu, ponet_block.cu and the training
// kernels): the three forward tile functions every caller shares, out =
// act(A . W + bias) * gate (W as stored, or read transposed by the backward
// passes), the q/k/v projection with its scatter, and A . W + bias +
// residual with a LayerNorm over whole rows, with their kernels and
// launchers; and the backward passes' weight gradient dW = X^T . dY with the
// bias gradient, summed over all rows.
//
// In bfloat16 their products run on the tensor cores (TileGemmBf16 below:
// mma.sync m16n8k16 bf16 with float32 sums). In float32 the three tile
// functions and the weight gradient run common.cuh's SIMT TileGemm, as
// before the tensor-core tile existed, so the float32 modes of kernels 1-3,
// 7, 8 and 10-13 are unchanged by a bit; kernel 9's float32 products alone
// take tf32x3_gemm.cuh's 3xTF32 tensor-core tile, through its own
// launchers (launch_gemm_f32tc, launch_residual_ln_f32tc), which run the
// epilogues below on that tile (gemm_bias_act_mma, residual_ln_mma). Bias,
// activation, residual and LayerNorm are float32 in every mode, and a value
// is rounded to the element type exactly where the SIMT version rounds it:
// only the order of the float32 sums differs (a bf16 x bf16 product is
// exact in float32) and, on the 3xTF32 tile, the products' precision.
//
// The tile (TileGemmBf16). It multiplies A (M, K) by B (K, N), each stored
// as its caller holds it: A row-major (M, K), or (K, M) for the weight
// gradient's X^T; B row-major (K, N), as the forward weights, or (N, K) for
// a weight read transposed. No operand is copied into another layout:
// ldmatrix reads the mma's fragments from either, with .trans where the
// stored rows run along k (A stored (K, M), B stored (K, N)) and without it
// where they run along m or n. A k-stage is 32 deep (two k16 mma steps): the
// stage's slices of A and B are copied into shared memory by cp.async into a
// ring of three stages, so two stages are in flight while the warps
// multiply the third. Copies are 16 bytes where both stored widths and base
// pointers allow 8-element copies, else 4 bytes (2 elements); an odd width
// takes a synchronous path that stages element by element through the same
// ring. Staged rows are padded by 16 bytes to an odd number of 16-byte units
// (a 32-deep row: 80 bytes; a row of BM or BN: 2 BM + 16 or 2 BN + 16), so
// the 8 row addresses of one ldmatrix phase fall on 8 distinct 16-byte bank
// groups. The 8 warps of a block stand 2 x 4, each owning a (BM / 2) x (BN /
// 4) sub-tile of m16 x n8 fragments. Rows past M, columns past N and depth
// past the k-range's end are zero-filled through the copy's source size, so
// they add nothing to the sums.
//
// What bounds it. At BERT-base the encoder's products are hundreds of
// operations a byte, so bound by the tensor cores' bf16 rate (989 TFLOP/s
// dense). mma.sync reaches part of it (each warp issues its own ldmatrix and
// mma, and a block waits at one barrier a stage); wgmma with TMA is later
// work, and the epilogues here already work on the accumulator fragments,
// which it keeps in the same places.
//
// The weight gradient (weight_grad_kernel) sums over all B*L rows, a long
// k-walk onto a small output: dWo (768 x 768) is 36 tiles of 128 x 128 for
// 132 SMs. So its bf16 instantiation splits the rows into `splits` fixed
// ranges (grid z), each block writing its range's partial tile into a
// float32 workspace from the wrapper's allocator, and weight_grad_reduce_kernel
// adds the partials in split order: no atomics, the same bits on every run.
// The bias gradient comes from the same pass, as float32 column sums of the
// staged dY slices in the blocks of the first tile row.
#pragma once

#include "ptx.cuh"

namespace spk {

// The tile's shape: 32-deep stages in a ring of three; (kGemmRowsB x
// kGemmColsB) output tiles for the GEMM and projection kernels; the
// residual-LayerNorm blocks own kLnRowsB whole rows and walk them kLnColsB
// columns at a time.
constexpr int kTileKB = 32;
constexpr int kStagesB = 3;
constexpr int kARowBytesB = 2 * kTileKB + 16;  // a staged A row, padded by 16 bytes
constexpr int kGemmRowsB = 128, kGemmColsB = 128;
constexpr int kLnRowsB = 64, kLnColsB = 128;
static_assert(kTileKB % 16 == 0 && kStagesB >= 2, "whole mma k-steps, a ring of two or more");

// Whether a GEMM of element type T runs on the tensor cores: bf16
template <typename T>
__host__ __device__ constexpr bool on_tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// One BM x BN tile of the float32 product A . B of bf16 A (M, K) and B (K,
// N) on 256 threads (the file's header describes it): A stored row-major (M,
// K), or (K, M) when kTransA; B stored row-major (K, N), or (N, K) when
// kTransB. acc[mi][ni][e] is the sum at tile row row(mi, e) and column
// col(ni, e). The sum runs over k in [k_begin, K); a k_begin above 0 (a
// range of the rows a weight gradient sums) needs K to be no stride, that
// is kTransA and !kTransB. smem holds kSmemBytes, 16-byte aligned; the tile
// leaves it free (all copies landed, every warp past its last read) when it
// returns. A and B carry no __restrict__: the stack kernel reads buffers
// that an earlier phase of the same launch wrote.
template <int BM, int BN, bool kTransA = false, bool kTransB = false>
struct TileGemmBf16 {
  using bf16 = __nv_bfloat16;
  static constexpr int kRows = BM, kCols = BN;
  static constexpr int kWarpsN = 4;                     // warps stand 2 x 4
  static constexpr int WM = BM / 2, WN = BN / kWarpsN;  // a warp's sub-tile
  static_assert(kThreads == 256, "the warps stand 2 x 4");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "a warp owns m16 x n16 steps");
  static_assert(!kTransB || !kTransA, "no caller reads both operands transposed");
  static constexpr int MI = WM / 16, NI = WN / 8;  // m16 and n8 fragments a warp
  // staged rows: 32-deep rows of A (m) or of a transposed B (n), padded; or
  // rows of BM (A stored (K, M)) or BN (B stored (K, N)) elements, padded
  static constexpr int kARowBytes = kTransA ? 2 * BM + 16 : kARowBytesB;
  static constexpr int kBRowBytes = kTransB ? kARowBytesB : 2 * BN + 16;
  static constexpr int kABytes = (kTransA ? kTileKB : BM) * kARowBytes;
  static constexpr int kStageBytes = kABytes + (kTransB ? BN : kTileKB) * kBRowBytes;
  static constexpr int kSmemBytes = kStagesB * kStageBytes;
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

  // Copy R rows of W elements of X (rows, cols), from (r0, c0), into dst
  // (rows of `pitch` bytes), zero past `rows` and `cols`: by cp.async of
  // kBytes (16 or 4), or with kBytes == 2 element by element. `cols` is X's
  // stride too; `rows` only bounds.
  template <int R, int W, int kBytes>
  __device__ static void stage(const bf16* X, int rows, int cols, int r0, int c0, int pitch,
                               unsigned char* dst) {
    constexpr int kElems = kBytes / 2, kPerRow = W / kElems, kCopies = R * kPerRow;
#pragma unroll
    for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kCopies % kThreads && e >= kCopies) break;
      const int r = e / kPerRow, c = e % kPerRow;
      const int gr = r0 + r, gc = c0 + kElems * c;
      const int n = gr < rows ? max(0, min(kElems, cols - gc)) : 0;
      const bf16* src = n > 0 ? X + (size_t)gr * cols + gc : X;
      unsigned char* d = dst + r * pitch + kBytes * c;
      if constexpr (kBytes == 2) {
        *reinterpret_cast<bf16*>(d) = n > 0 ? *src : __float2bfloat16(0.0f);
      } else if constexpr (kBytes == 16) {
        cp_async16(smem_addr(d), src, 2 * n);
      } else {
        cp_async4(smem_addr(d), src, 2 * n);
      }
    }
  }

  // With bsum != null (kTransA and !kTransB only), the threads also sum each
  // of B's staged columns over the k-range in float32: thread t takes
  // column t % BN of rows (t / BN) kSumRows to (t / BN + 1) kSumRows - 1 of
  // each stage, and the 256 / BN partial sums of a column are added in
  // order at the end into bsum[col0 + c], for the columns below N.
  template <int kBytes>
  __device__ static void pipeline(const bf16* A, const bf16* B, int M, int N, int K, int k_begin,
                                  int row0, int col0, Acc& acc, unsigned char* smem,
                                  float* bsum) {
    const int nk = max(0, (K - k_begin + kTileKB - 1) / kTileKB);
    const auto load = [&](int kt) {
      unsigned char* s = smem + (kt % kStagesB) * kStageBytes;
      const int k0 = k_begin + kt * kTileKB;
      if constexpr (kTransA) {
        stage<kTileKB, BM, kBytes>(A, K, M, k0, row0, kARowBytes, s);
      } else {
        stage<BM, kTileKB, kBytes>(A, M, K, row0, k0, kARowBytes, s);
      }
      if constexpr (kTransB) {
        stage<BN, kTileKB, kBytes>(B, N, K, col0, k0, kBRowBytes, s + kABytes);
      } else {
        stage<kTileKB, BN, kBytes>(B, K, N, k0, col0, kBRowBytes, s + kABytes);
      }
    };
#pragma unroll
    for (int s = 0; s < kStagesB - 1; ++s) {
      if (s < nk) load(s);
      cp_async_commit();
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm0 = (warp / kWarpsN) * WM, wn0 = (warp % kWarpsN) * WN;
    // ldmatrix.x4 row addresses. A's four 8 x 8 matrices are (rows 0-7, k
    // 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) of an m16 x k16
    // fragment; B's are (k 0-7, n 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
    // 8-15): b0 and b1 of two n8 fragments. A stored (K, M) and B stored (K,
    // N) are read with .trans from their k rows; A stored (M, K) and B stored
    // (N, K) without it, from their m or n rows.
    int a_off, b_off;
    if constexpr (kTransA) {
      a_off = (lane % 8 + (lane / 16) * 8) * kARowBytes + (wm0 + ((lane / 8) % 2) * 8) * 2;
    } else {
      a_off = (wm0 + lane % 16) * kARowBytes + (lane / 16) * 16;
    }
    if constexpr (kTransB) {
      b_off = kABytes + (wn0 + lane % 8 + (lane / 16) * 8) * kBRowBytes + ((lane / 8) % 2) * 16;
    } else {
      b_off = kABytes + (lane % 16) * kBRowBytes + (wn0 + (lane / 16) * 8) * 2;
    }
    constexpr int kSumRows = kTileKB * BN / kThreads;  // rows of a column a thread sums
    float col_sum = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStagesB - 2>();  // stage kt has landed
      __syncthreads();                // and every warp is done with stage kt - 1's slot
      if (kt + kStagesB - 1 < nk) load(kt + kStagesB - 1);
      cp_async_commit();
      const unsigned char* stage_ptr = smem + (kt % kStagesB) * kStageBytes;
      const uint32_t base = smem_addr(stage_ptr);
      if constexpr (kTransA && !kTransB) {
        if (bsum != nullptr) {
          const unsigned char* c = stage_ptr + kABytes + (threadIdx.x / BN) * kSumRows * kBRowBytes +
                                   (threadIdx.x % BN) * 2;
#pragma unroll
          for (int k = 0; k < kSumRows; ++k)
            col_sum += __bfloat162float(*reinterpret_cast<const bf16*>(c + k * kBRowBytes));
        }
      }
#pragma unroll
      for (int ks = 0; ks < kTileKB / 16; ++ks) {
        uint32_t a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if constexpr (kTransA) {
            ldmatrix_x4_trans(base + a_off + ks * 16 * kARowBytes + mi * 32, a[mi]);
          } else {
            ldmatrix_x4(base + a_off + mi * 16 * kARowBytes + ks * 32, a[mi]);
          }
        }
        // B two n8 fragments at a time, each used as soon as it is read, so
        // that only four of B's registers are live beside the accumulators
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t r[4];
          if constexpr (kTransB) {
            ldmatrix_x4(base + b_off + nj * 16 * kBRowBytes + ks * 32, r);
          } else {
            ldmatrix_x4_trans(base + b_off + ks * 16 * kBRowBytes + nj * 32, r);
          }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][2 * nj], a[mi], r[0], r[1]);
            mma_bf16(acc[mi][2 * nj + 1], a[mi], r[2], r[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (kTransA && !kTransB) {
      if (bsum != nullptr) {  // the partial sums of each column, added in a fixed order
        static_assert(kThreads % BN == 0 && kTileKB % (kThreads / BN) == 0, "whole columns");
        float* part = reinterpret_cast<float*>(smem);
        part[threadIdx.x] = col_sum;
        __syncthreads();
        if (threadIdx.x < BN && col0 + (int)threadIdx.x < N) {
          float v = 0.0f;
#pragma unroll
          for (int p = 0; p < kThreads / BN; ++p) v += part[threadIdx.x + p * BN];
          bsum[col0 + threadIdx.x] = v;
        }
        __syncthreads();
      }
    }
  }

  // bsum: the column sums of pipeline, or null
  __device__ static void run(const bf16* A, const bf16* B, int M, int N, int K, int row0,
                             int col0, Acc& acc, unsigned char* smem, int k_begin = 0,
                             float* bsum = nullptr) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    // the stored widths of A and B
    const int wa = kTransA ? M : K, wb = kTransB ? K : N;
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B);
    if (wa % 8 == 0 && wb % 8 == 0 && ptrs % 16 == 0) {
      pipeline<16>(A, B, M, N, K, k_begin, row0, col0, acc, smem, bsum);
    } else if (wa % 2 == 0 && wb % 2 == 0 && ptrs % 4 == 0) {
      pipeline<4>(A, B, M, N, K, k_begin, row0, col0, acc, smem, bsum);
    } else {
      pipeline<2>(A, B, M, N, K, k_begin, row0, col0, acc, smem, bsum);
    }
  }
};

using GemmTileB = TileGemmBf16<kGemmRowsB, kGemmColsB>;
using LnTileB = TileGemmBf16<kLnRowsB, kLnColsB>;
// the backward passes' tiles: a weight read transposed, and the weight
// gradient X^T . dY
using GemmTileTransB = TileGemmBf16<kGemmRowsB, kGemmColsB, false, true>;
using WgradTileB = TileGemmBf16<kGemmRowsB, kGemmColsB, true, false>;

// The output tiles of the three tile functions for element type T: the
// tensor-core tile's in bf16, the SIMT tile's (64 x 64, kLnRows rows) else.
template <typename T>
__host__ __device__ constexpr int gemm_tile_rows() {
  return on_tensor_cores<T>() ? kGemmRowsB : 64;
}

template <typename T>
__host__ __device__ constexpr int gemm_tile_cols() {
  return on_tensor_cores<T>() ? kGemmColsB : 64;
}

template <typename T>
__host__ __device__ constexpr int ln_tile_rows() {
  return on_tensor_cores<T>() ? kLnRowsB : kLnRows;
}

// The shared memory the tile functions take: the tensor-core ring (dynamic,
// above 48 KB) or the SIMT staging
template <typename T, bool kTransW = false>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return on_tensor_cores<T>()
             ? (size_t)TileGemmBf16<kGemmRowsB, kGemmColsB, false, kTransW>::kSmemBytes
             : sizeof(float) * TileGemm<64, 64, T, false, kTransW>::kSmemFloats;
}

template <typename T>
__host__ __device__ constexpr size_t ln_smem_bytes() {
  return on_tensor_cores<T>() ? (size_t)LnTileB::kSmemBytes
                              : sizeof(float) * TileGemm<kLnRows, kLnCols, T>::kSmemFloats;
}

// the least blocks an SM of a tile kernel: two for the tensor-core tile (128
// registers a thread), none (ptxas's own choice, as before it) for the SIMT
template <typename T>
__host__ __device__ constexpr int gemm_min_blocks() {
  return on_tensor_cores<T>() ? 2 : 0;
}

// out[i] = v0 and, when `both`, out[i + 1] = v1: one 4- or 8-byte store
// where i is even, which the callers' row-major outputs of even width give
template <typename T>
__device__ __forceinline__ void store_pair(T* out, size_t i, float v0, float v1, bool both) {
  if (both && i % 2 == 0) {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(v0, v1);
    }
    return;
  }
  out[i] = from_f32<T>(v0);
  if (both) out[i + 1] = from_f32<T>(v1);
}

// gemm_bias_act_tile on a tensor-core tile G of T (TileGemmBf16, or
// tf32x3_gemm.cuh's TileGemmTf32x3): the output tile at (row0, col0), smem
// holding G::kSmemBytes, 16-byte aligned
template <typename G, typename T>
__device__ __forceinline__ void gemm_bias_act_mma(const T* A, const T* W, const float* bias,
                                                  T* out, int M, int N, int K, int act,
                                                  const float* gate, int row0, int col0,
                                                  unsigned char* smem) {
  typename G::Acc acc;
  G::run(A, W, M, N, K, row0, col0, acc, smem);
  G::for_pairs(acc, [&](int r, int c, float a0, float a1) {
    const int m = row0 + r, n = col0 + c;
    if (m >= M || n >= N) return;
    const bool both = n + 1 < N;
    float v0 = apply_activation(a0 + (bias != nullptr ? bias[n] : 0.0f), act);
    float v1 = both ? apply_activation(a1 + (bias != nullptr ? bias[n + 1] : 0.0f), act) : 0.0f;
    if (gate != nullptr) {
      v0 *= gate[(size_t)m * N + n];
      if (both) v1 *= gate[(size_t)m * N + n + 1];
    }
    store_pair(out, (size_t)m * N + n, v0, v1, both);
  });
}

// out = act(A . W + bias) * gate, stored in T, for the output tile at (row0,
// col0) (gemm_tile_rows x gemm_tile_cols). W is (K, N), or (N, K) read
// transposed when kTransW; bias (N,) and gate (M, N) float32 may be null.
// `smem` holds gemm_smem_bytes<T, kTransW>(), 16-byte aligned.
template <typename T, bool kTransW = false>
__device__ __forceinline__ void gemm_bias_act_tile(const T* A, const T* W, const float* bias,
                                                   T* out, int M, int N, int K, int act,
                                                   const float* gate, int row0, int col0,
                                                   float* smem) {
  if constexpr (on_tensor_cores<T>()) {
    gemm_bias_act_mma<TileGemmBf16<kGemmRowsB, kGemmColsB, false, kTransW>>(
        A, W, bias, out, M, N, K, act, gate, row0, col0, reinterpret_cast<unsigned char*>(smem));
  } else {
    using G = TileGemm<64, 64, T, false, kTransW>;
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
        if (n >= N) continue;
        float v = apply_activation(acc[i][j] + (bias != nullptr ? bias[n] : 0.0f), act);
        if (gate != nullptr) v *= gate[(size_t)m * N + n];
        out[(size_t)m * N + n] = from_f32<T>(v);
      }
    }
  }
}

// Grid (ceil(N / gemm_tile_cols), ceil(M / gemm_tile_rows)); the tensor-core
// tile takes gemm_smem_bytes of dynamic shared memory, the SIMT tile static.
template <typename T, bool kTransW = false>
__global__ void __launch_bounds__(kThreads, gemm_min_blocks<T>())
    gemm_bias_act_kernel(const T* __restrict__ A, const T* __restrict__ W,
                         const float* __restrict__ bias, T* __restrict__ out, int M, int N, int K,
                         int act, const float* __restrict__ gate = nullptr) {
  constexpr int BM = gemm_tile_rows<T>(), BN = gemm_tile_cols<T>();
  if constexpr (on_tensor_cores<T>()) {
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    gemm_bias_act_tile<T, kTransW>(A, W, bias, out, M, N, K, act, gate, blockIdx.y * BM,
                                   blockIdx.x * BN, reinterpret_cast<float*>(smem_bf16));
  } else {
    __shared__ float smem[TileGemm<64, 64, T, false, kTransW>::kSmemFloats];
    gemm_bias_act_tile<T, kTransW>(A, W, bias, out, M, N, K, act, gate, blockIdx.y * BM,
                                   blockIdx.x * BN, smem);
  }
}

// The dynamic shared memory a tile kernel launches with (after allowing it)
template <typename T, typename Kernel>
cudaError_t tile_smem(Kernel kernel, size_t bytes, size_t* smem) {
  *smem = on_tensor_cores<T>() ? bytes : 0;
  return *smem ? prepare(kernel, *smem) : cudaSuccess;
}

template <typename T, bool kTransW = false>
inline cudaError_t launch_gemm(const T* A, const T* W, const float* bias, T* out, int M, int N,
                               int K, int act, const float* gate, cudaStream_t stream) {
  constexpr int BM = gemm_tile_rows<T>(), BN = gemm_tile_cols<T>();
  size_t smem = 0;
  const cudaError_t err = tile_smem<T>(gemm_bias_act_kernel<T, kTransW>,
                                       gemm_smem_bytes<T, kTransW>(), &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bias_act_kernel<T, kTransW><<<grid, kThreads, smem, stream>>>(A, W, bias, out, M, N, K,
                                                                     act, gate);
  return cudaGetLastError();
}

// The output tile at (row0, col0) of (M=B*L, H) . (H, slots*nh*hd) + bias,
// scattered to (slots, B, nh, L, hd), slot 0 scaled by sm_scale (1 keeps it
// unscaled): q, k, v with slots = 3. `smem` as for gemm_bias_act_tile.
template <typename T>
__device__ __forceinline__ void qkv_proj_tile(const T* x, const T* w, const float* bias, T* qkv,
                                              int B, int L, int H, int nh, int hd,
                                              float sm_scale, int slots, int row0, int col0,
                                              float* smem) {
  const int M = B * L, HN = nh * hd, N = slots * HN;
  if constexpr (on_tensor_cores<T>()) {
    using G = GemmTileB;
    G::Acc acc;
    G::run(x, w, M, N, H, row0, col0, acc, reinterpret_cast<unsigned char*>(smem));
    G::for_pairs(acc, [&](int r, int c, float a0, float a1) {
      const int m = row0 + r, n = col0 + c;
      if (m >= M || n >= N) return;
      float v0 = a0 + bias[n];
      if (n < HN) v0 *= sm_scale;
      if (n + 1 >= N) {
        store_qkv<T>(qkv, v0, m, n, B, L, nh, hd);
        return;
      }
      float v1 = a1 + bias[n + 1];
      if (n + 1 < HN) v1 *= sm_scale;
      if (hd % 2 == 0) {  // n even: d and d + 1 of one head, neighbours in qkv
        const int b = m / L, l = m - b * L, s = n / HN, rr = n - s * HN, h = rr / hd;
        store_pair(qkv, ((((size_t)s * B + b) * nh + h) * L + l) * hd + (rr - h * hd), v0, v1,
                   true);
      } else {
        store_qkv<T>(qkv, v0, m, n, B, L, nh, hd);
        store_qkv<T>(qkv, v1, m, n + 1, B, L, nh, hd);
      }
    });
  } else {
    using G = TileGemm<64, 64, T>;
    float acc[G::TM][G::TN];
    G::run(x, w, M, N, H, row0, col0, acc, smem);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const int m = row0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < G::TN; ++j) {
        const int n = col0 + tx + 16 * j;
        if (n >= N) continue;
        float v = acc[i][j] + bias[n];
        if (n < HN) v *= sm_scale;
        store_qkv<T>(qkv, v, m, n, B, L, nh, hd);
      }
    }
  }
}

// Grid (ceil(slots*nh*hd / gemm_tile_cols), ceil(B*L / gemm_tile_rows)).
template <typename T>
__global__ void __launch_bounds__(kThreads, gemm_min_blocks<T>())
    qkv_proj_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ qkv, int B, int L, int H,
                    int nh, int hd, float sm_scale, int slots) {
  constexpr int BM = gemm_tile_rows<T>(), BN = gemm_tile_cols<T>();
  if constexpr (on_tensor_cores<T>()) {
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    qkv_proj_tile<T>(x, w, bias, qkv, B, L, H, nh, hd, sm_scale, slots, blockIdx.y * BM,
                     blockIdx.x * BN, reinterpret_cast<float*>(smem_bf16));
  } else {
    __shared__ float smem[TileGemm<64, 64, T>::kSmemFloats];
    qkv_proj_tile<T>(x, w, bias, qkv, B, L, H, nh, hd, sm_scale, slots, blockIdx.y * BM,
                     blockIdx.x * BN, smem);
  }
}

template <typename T>
inline cudaError_t launch_qkv_proj(const T* x, const T* w, const float* bias, T* qkv, int B, int L,
                                   int H, int nh, int hd, float sm_scale, cudaStream_t stream,
                                   int slots = 3) {
  constexpr int BM = gemm_tile_rows<T>(), BN = gemm_tile_cols<T>();
  size_t smem = 0;
  const cudaError_t err = tile_smem<T>(qkv_proj_kernel<T>, gemm_smem_bytes<T>(), &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((slots * nh * hd + BN - 1) / BN, (B * L + BM - 1) / BM);
  qkv_proj_kernel<T><<<grid, kThreads, smem, stream>>>(x, w, bias, qkv, B, L, H, nh, hd, sm_scale,
                                                       slots);
  return cudaGetLastError();
}

// out = LayerNorm(resid + A . W + bias) * ln_scale + ln_bias over rows of
// width N, or out = A . W + bias when fuse_ln == 0, for the ln_tile_rows<T>
// whole rows from row0. The block walks the N columns tile by tile, writes
// the pre-norm rows in float32 to `rows` (M, N), then normalises each row
// with one warp (ln_rows). The block reads back only what it wrote, while it
// is still in L2; holding the rows in shared memory instead (98 KB at N=768)
// let only two blocks onto an SM and ran at a third of the plain GEMM's
// rate. `smem` holds ln_smem_bytes<T>(), 16-byte aligned.
// residual_ln_rowblock on a tensor-core tile G of T (TileGemmBf16, or
// tf32x3_gemm.cuh's TileGemmTf32x3): the G::kRows whole rows from row0,
// walked G::kCols columns at a time, then normalised; smem holding
// G::kSmemBytes, 16-byte aligned
template <typename G, typename T>
__device__ __forceinline__ void residual_ln_mma(const T* A, const T* W, const float* bias,
                                                const T* resid, const float* ln_scale,
                                                const float* ln_bias, float* rows, T* out, int M,
                                                int N, int K, float eps, int fuse_ln, int row0,
                                                unsigned char* smem) {
  for (int col0 = 0; col0 < N; col0 += G::kCols) {
    typename G::Acc acc;
    G::run(A, W, M, N, K, row0, col0, acc, smem);
    G::for_pairs(acc, [&](int r, int c, float a0, float a1) {
      const int m = row0 + r, n = col0 + c;
      if (m >= M || n >= N) return;
      const bool both = n + 1 < N;
      const size_t i = (size_t)m * N + n;
      float v0 = a0 + bias[n], v1 = both ? a1 + bias[n + 1] : 0.0f;
      if (fuse_ln) {
        v0 += to_f32(resid[i]);
        if (both) v1 += to_f32(resid[i + 1]);
      }
      store_pair(rows, i, v0, v1, both);
    });
  }
  __syncthreads();  // makes the block's global writes visible to the block
  ln_rows<T, G::kRows>(rows, ln_scale, ln_bias, out, M, N, eps, fuse_ln, row0);
}

template <typename T>
__device__ __forceinline__ void residual_ln_rowblock(const T* A, const T* W, const float* bias,
                                                     const T* resid, const float* ln_scale,
                                                     const float* ln_bias, float* rows, T* out,
                                                     int M, int N, int K, float eps, int fuse_ln,
                                                     int row0, float* smem) {
  if constexpr (on_tensor_cores<T>()) {
    residual_ln_mma<LnTileB>(A, W, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, eps,
                             fuse_ln, row0, reinterpret_cast<unsigned char*>(smem));
  } else {
    using G = TileGemm<kLnRows, kLnCols, T>;
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
    ln_rows<T, kLnRows>(rows, ln_scale, ln_bias, out, M, N, eps, fuse_ln, row0);
  }
}

// Grid (ceil(M / ln_tile_rows<T>)).
template <typename T>
__global__ void __launch_bounds__(kThreads, gemm_min_blocks<T>())
    gemm_bias_residual_ln_kernel(const T* __restrict__ A, const T* __restrict__ W,
                                 const float* __restrict__ bias, const T* __restrict__ resid,
                                 const float* __restrict__ ln_scale,
                                 const float* __restrict__ ln_bias, float* rows,
                                 T* __restrict__ out, int M, int N, int K, float eps,
                                 int fuse_ln) {
  if constexpr (on_tensor_cores<T>()) {
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    residual_ln_rowblock<T>(A, W, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, eps,
                            fuse_ln, blockIdx.x * kLnRowsB, reinterpret_cast<float*>(smem_bf16));
  } else {
    __shared__ float smem[TileGemm<kLnRows, kLnCols, T>::kSmemFloats];
    residual_ln_rowblock<T>(A, W, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, eps,
                            fuse_ln, blockIdx.x * kLnRows, smem);
  }
}

template <typename T>
inline cudaError_t launch_residual_ln(const T* A, const T* W, const float* bias, const T* resid,
                                      const float* ln_scale, const float* ln_bias, float* rows,
                                      T* out, int M, int N, int K, float eps, int fuse_ln,
                                      cudaStream_t stream) {
  constexpr int R = ln_tile_rows<T>();
  size_t smem = 0;
  const cudaError_t err = tile_smem<T>(gemm_bias_residual_ln_kernel<T>, ln_smem_bytes<T>(),
                                       &smem);
  if (err != cudaSuccess) return err;
  gemm_bias_residual_ln_kernel<T><<<(M + R - 1) / R, kThreads, smem, stream>>>(
      A, W, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, eps, fuse_ln);
  return cudaGetLastError();
}

// Weight gradient dW = X^T . dY (Hin, N) in float32, summed over the M rows
// of X (M, Hin) and dY (M, N), and with db != null the bias gradient db =
// sum over rows of dY (N,). Nothing is shared between blocks: no atomics,
// and the same sums in the same order on every run.
//   float32: each block owns one 64 x 64 tile of dW and walks all M rows
//            itself on the SIMT tile; the blocks of the first tile row also
//            write their columns of db, summed from the dY tiles they stage
//            anyway. Grid (ceil(N / 64), ceil(Hin / 64)); rows_per_split and
//            the strides are not read.
//   bf16:    each block owns one 128 x 128 tile of dW (WgradTileB) and the
//            rows [z rows_per_split, (z + 1) rows_per_split) for z =
//            blockIdx.z, and writes its partial tile to dW + z w_stride (and
//            the first tile row its partial db to db + z b_stride). Grid
//            (ceil(N / 128), ceil(Hin / 128), splits).
template <typename T>
__global__ void __launch_bounds__(kThreads, gemm_min_blocks<T>())
    weight_grad_kernel(const T* __restrict__ X, const T* __restrict__ dY, float* __restrict__ dW,
                       float* __restrict__ db, int M, int Hin, int N, int rows_per_split,
                       size_t w_stride, size_t b_stride) {
  if constexpr (on_tensor_cores<T>()) {
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    using G = WgradTileB;
    const int row0 = blockIdx.y * kGemmRowsB, col0 = blockIdx.x * kGemmColsB;
    const int k_begin = blockIdx.z * rows_per_split;
    const int k_end = min(M, k_begin + rows_per_split);
    float* out = dW + blockIdx.z * w_stride;
    float* bsum = blockIdx.y == 0 && db != nullptr ? db + blockIdx.z * b_stride : nullptr;
    G::Acc acc;
    G::run(X, dY, Hin, N, k_end, row0, col0, acc, smem_bf16, k_begin, bsum);
    G::for_pairs(acc, [&](int r, int c, float a0, float a1) {
      const int h = row0 + r, n = col0 + c;
      if (h < Hin && n < N) store_pair(out, (size_t)h * N + n, a0, a1, n + 1 < N);
    });
  } else {
    using G = TileGemm<64, 64, T, true, false, true>;
    __shared__ float smem[G::kSmemFloats];
    const int row0 = blockIdx.y * 64, col0 = blockIdx.x * 64;
    float acc[G::TM][G::TN];
    G::run(X, dY, Hin, N, M, row0, col0, acc, smem, blockIdx.y == 0 ? db : nullptr);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const int h = row0 + ty + 16 * i;
      if (h >= Hin) continue;
#pragma unroll
      for (int j = 0; j < G::TN; ++j) {
        const int n = col0 + tx + 16 * j;
        if (n < N) dW[(size_t)h * N + n] = acc[i][j];
      }
    }
  }
}

namespace {  // a kernel that is no template gets one copy a translation unit

// dW[i] = sum over z of ws[z w_stride + i] (i < Hin N) and db[j] = sum over
// z of ws[splits w_stride + z b_stride + j] (j < N), z in order from 0
__global__ void weight_grad_reduce_kernel(const float* __restrict__ ws, int splits,
                                          size_t w_stride, size_t b_stride,
                                          float* __restrict__ dW, size_t n_w,
                                          float* __restrict__ db, int N) {
  const size_t total = n_w + (db != nullptr ? (size_t)N : 0);
  const float* wsb = ws + splits * w_stride;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.0f;
    if (i < n_w) {
      for (int z = 0; z < splits; ++z) v += ws[z * w_stride + i];
      dW[i] = v;
    } else {
      for (int z = 0; z < splits; ++z) v += wsb[z * b_stride + (i - n_w)];
      db[i - n_w] = v;
    }
  }
}

}  // namespace

// The float32 workspace of a bf16 weight gradient over `splits` row ranges
// (none for one range): each range's partial dW, then each one's partial db,
// each padded to a multiple of 4 floats. ops/cuda/train_blocks.py
// weight_grad_workspace is its Python twin.
inline size_t weight_grad_workspace_floats(int splits, int Hin, int N) {
  const auto pad4 = [](size_t n) { return (n + 3) / 4 * 4; };
  return splits > 1 ? (size_t)splits * (pad4((size_t)Hin * N) + pad4((size_t)N)) : 0;
}

// dW (Hin, N) and db (N,) of X (M, Hin) and dY (M, N), the rows cut into
// `splits` ranges of whole 32-row stages in bf16 (ws: a workspace of at least
// ws_floats >= weight_grad_workspace_floats(splits, Hin, N) floats when
// splits > 1); float32 ignores splits and ws.
template <typename T>
inline cudaError_t launch_weight_grad(const T* X, const T* dY, float* dW, float* db, float* ws,
                                      size_t ws_floats, int splits, int M, int Hin, int N,
                                      cudaStream_t stream) {
  if constexpr (!on_tensor_cores<T>()) {
    const dim3 grid((N + 63) / 64, (Hin + 63) / 64);
    weight_grad_kernel<T><<<grid, kThreads, 0, stream>>>(X, dY, dW, db, M, Hin, N, M, 0, 0);
    return cudaGetLastError();
  } else {
    const int stages = max(1, (M + kTileKB - 1) / kTileKB);
    const int per_split = (stages + max(1, splits) - 1) / max(1, splits) * kTileKB;
    splits = max(1, (M + per_split - 1) / per_split);  // no empty range
    if (splits > 1 && (ws == nullptr || ws_floats < weight_grad_workspace_floats(splits, Hin, N)))
      return cudaErrorInvalidValue;
    size_t smem = 0;
    cudaError_t err = tile_smem<T>(weight_grad_kernel<T>, WgradTileB::kSmemBytes, &smem);
    if (err != cudaSuccess) return err;
    const size_t w_stride = ((size_t)Hin * N + 3) / 4 * 4, b_stride = ((size_t)N + 3) / 4 * 4;
    const dim3 grid((N + kGemmColsB - 1) / kGemmColsB, (Hin + kGemmRowsB - 1) / kGemmRowsB,
                    splits);
    float* wsb = db != nullptr && splits > 1 ? ws + splits * w_stride : db;
    weight_grad_kernel<T><<<grid, kThreads, smem, stream>>>(
        X, dY, splits > 1 ? ws : dW, wsb, M, Hin, N, per_split, w_stride, b_stride);
    if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
    const size_t total = (size_t)Hin * N + N;
    const int blocks = (int)min((total + kThreads - 1) / kThreads, (size_t)1056);
    weight_grad_reduce_kernel<<<blocks, kThreads, 0, stream>>>(ws, splits, w_stride, b_stride, dW,
                                                               (size_t)Hin * N, db, N);
    return cudaGetLastError();
  }
}

}  // namespace spk
