// Training MLP core for the H100 (sm_90a), forward and backward:
//   y = act(x W1 + b1) W2 + b2
// with "gelu" in its tanh form and its exact derivative, as the TPU kernel
// computes them. Residual, LayerNorm and hidden-state dropout stay in
// PyTorch.
//
// Replaces the TPU kernels of spokennlp_tpu/ops/pallas/train_blocks.py,
// mlp_block_train: _mlp_train_fwd_kernel and _mlp_train_bwd_kernel (the
// custom VJP of make_mlp_train).
//
// What bounds it here. At BERT-base (M = 32 * 512 rows, H=768, I=3072) the
// forward is 155 GFLOP and the backward 309 GFLOP plus the recomputed
// forward product, against 30 MB (forward) and 60 MB (backward) of inputs,
// weights and outputs in bf16: bound by arithmetic. In bf16 every product,
// forward and backward, runs bf16_gemm.cuh's tensor-core tile: the forward's
// two, the recomputed x W1 with its act' epilogue, the two products with a
// weight read transposed (its (N, K) rows are the mma's column fragments)
// and the two weight gradients, whose sums over the rows are split into
// fixed row ranges summed in order. The float32 modes keep the SIMT tile on
// the CUDA cores, unchanged.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// kept both weight matrices in VMEM, the (rows, I) intermediate in registers,
// and summed dW1, db1, dW2, db2 over its sequential grid of row blocks in its
// output buffers. Here:
//   forward  1. h = act(x W1 + b1) rounded to the element type, where the
//               TPU kernel rounds it, stored (M, I);
//            2. y = h W2 + b2.
//   backward 1. pre = x W1 + b1 recomputed; h (rounded) and act'(pre) in
//               float32 from one tanh (activation_and_grad, common.cuh), in
//               the epilogue on the accumulators;
//            2. dpre = (g W2^T) act'(pre), rounded;
//            3. dx = dpre W1^T;
//            4. dW1 = x^T dpre with db1, and dW2 = h^T g with db2, in
//               weight_grad_kernel (bf16_gemm.cuh): a block owns a tile of
//               the weight gradient and a fixed range of the M rows, and the
//               ranges' partial sums are added in order after it, so the
//               sums over rows need no atomics and come out the same on
//               every run.
// The (M, I) intermediates (h, and in the backward act' and dpre) make a
// round trip through device memory; keeping them on chip is later work.
#include "bf16_gemm.cuh"

namespace spk {
namespace {

// pre = x W1 + b1; h = act(pre) stored rounded in T, hgrad = act'(pre) in
// float32. Grid (ceil(I / gemm_tile_cols), ceil(M / gemm_tile_rows)); bf16
// takes gemm_smem_bytes of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads, gemm_min_blocks<T>())
    act_and_grad_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ b1, T* __restrict__ h,
                        float* __restrict__ hgrad, int M, int H, int I, int act) {
  if constexpr (on_tensor_cores<T>()) {
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    using G = GemmTileB;
    const int row0 = blockIdx.y * kGemmRowsB, col0 = blockIdx.x * kGemmColsB;
    G::Acc acc;
    G::run(x, w1, M, I, H, row0, col0, acc, smem_bf16);
    G::for_pairs(acc, [&](int r, int c, float a0, float a1) {
      const int m = row0 + r, n = col0 + c;
      if (m >= M || n >= I) return;
      const bool both = n + 1 < I;
      float h0, d0, h1 = 0.0f, d1 = 0.0f;
      activation_and_grad(a0 + b1[n], act, h0, d0);
      if (both) activation_and_grad(a1 + b1[n + 1], act, h1, d1);
      store_pair(h, (size_t)m * I + n, h0, h1, both);
      store_pair(hgrad, (size_t)m * I + n, d0, d1, both);
    });
  } else {
    using G = TileGemm<64, 64, T>;
    __shared__ float smem[G::kSmemFloats];
    const int row0 = blockIdx.y * 64, col0 = blockIdx.x * 64;
    float acc[G::TM][G::TN];
    G::run(x, w1, M, I, H, row0, col0, acc, smem);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const int m = row0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < G::TN; ++j) {
        const int n = col0 + tx + 16 * j;
        if (n >= I) continue;
        float hv, dh;
        activation_and_grad(acc[i][j] + b1[n], act, hv, dh);
        h[(size_t)m * I + n] = from_f32<T>(hv);
        hgrad[(size_t)m * I + n] = dh;
      }
    }
  }
}

template <typename T>
cudaError_t mlp_train_fwd(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
                          T* h_buf, T* out, int M, int H, int I, int act, cudaStream_t stream) {
  cudaError_t err = launch_gemm<T>(x, w1, b1, h_buf, M, I, H, act, nullptr, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(h_buf, w2, b2, out, M, H, I, kActNone, nullptr, stream);
}

template <typename T>
cudaError_t mlp_train_bwd(const T* x, const T* w1, const float* b1, const T* w2, const T* g,
                          T* h_buf, float* hgrad_buf, T* dpre_buf, T* dx, float* dw1, float* db1,
                          float* dw2, float* db2, float* ws, size_t ws_floats, int splits, int M,
                          int H, int I, int act, cudaStream_t stream) {
  constexpr int BM = gemm_tile_rows<T>(), BN = gemm_tile_cols<T>();
  size_t smem = 0;
  cudaError_t err = tile_smem<T>(act_and_grad_kernel<T>, gemm_smem_bytes<T>(), &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((I + BN - 1) / BN, (M + BM - 1) / BM);
  act_and_grad_kernel<T><<<grid, kThreads, smem, stream>>>(x, w1, b1, h_buf, hgrad_buf, M, H, I,
                                                           act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dpre = (g W2^T) act'(pre), rounded (W2 is (I, H): read transposed)
  err = launch_gemm<T, true>(g, w2, nullptr, dpre_buf, M, I, H, kActNone, hgrad_buf, stream);
  if (err != cudaSuccess) return err;
  // dx = dpre W1^T (W1 is (H, I): read transposed)
  err = launch_gemm<T, true>(dpre_buf, w1, nullptr, dx, M, H, I, kActNone, nullptr, stream);
  if (err != cudaSuccess) return err;
  // dW1 and dW2 have the same tiles, so the same splits; one after the other
  // on the stream, they share the workspace
  err = launch_weight_grad<T>(x, dpre_buf, dw1, db1, ws, ws_floats, splits, M, H, I, stream);
  if (err != cudaSuccess) return err;
  return launch_weight_grad<T>(h_buf, g, dw2, db2, ws, ws_floats, splits, M, I, H, stream);
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (x, weights, g, h_buf, dpre_buf and the
// outputs out/dx); biases, hgrad_buf and the weight/bias gradients are
// float32; act is an ACTIVATION_CODES value. The backward's ws (ws_floats
// float32) is the weight gradients' workspace for `splits` row ranges
// (launch_weight_grad, bf16_gemm.cuh; bf16 only). Each entry returns the
// first CUDA error, or 0.
extern "C" int spk_mlp_train_fwd(int dtype, const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* h_buf, void* out, int M,
                                 int H, int I, int act, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b1_ = static_cast<const float*>(b1);
  const auto b2_ = static_cast<const float*>(b2);
  cudaError_t err;
  if (dtype == 0) {
    err = spk::mlp_train_fwd<float>(static_cast<const float*>(x), static_cast<const float*>(w1),
                                    b1_, static_cast<const float*>(w2), b2_,
                                    static_cast<float*>(h_buf), static_cast<float*>(out), M, H,
                                    I, act, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    err = spk::mlp_train_fwd<bf>(static_cast<const bf*>(x), static_cast<const bf*>(w1), b1_,
                                 static_cast<const bf*>(w2), b2_, static_cast<bf*>(h_buf),
                                 static_cast<bf*>(out), M, H, I, act, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int spk_mlp_train_bwd(int dtype, const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* g, void* h_buf, void* hgrad_buf,
                                 void* dpre_buf, void* dx, void* dw1, void* db1, void* dw2,
                                 void* db2, void* ws, size_t ws_floats, int splits, int M, int H,
                                 int I, int act, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b1_ = static_cast<const float*>(b1);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err;
  if (dtype == 0) {
    err = spk::mlp_train_bwd<float>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1_,
        static_cast<const float*>(w2), static_cast<const float*>(g), f(h_buf), f(hgrad_buf),
        f(dpre_buf), f(dx), f(dw1), f(db1), f(dw2), f(db2), f(ws), ws_floats, splits, M, H, I,
        act, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    const auto t = [](void* p) { return static_cast<bf*>(p); };
    err = spk::mlp_train_bwd<bf>(static_cast<const bf*>(x), static_cast<const bf*>(w1), b1_,
                                 static_cast<const bf*>(w2), static_cast<const bf*>(g), t(h_buf),
                                 f(hgrad_buf), t(dpre_buf), t(dx), f(dw1), f(db1), f(dw2),
                                 f(db2), f(ws), ws_floats, splits, M, H, I, act, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The training backwards' weight gradient alone, as they launch it
// (launch_weight_grad, bf16_gemm.cuh): dw (Hin, N) and db (N,) float32 of x
// (M, Hin) and dy (M, N) in the element type, over `splits` row ranges in
// bf16 with the workspace ws (ws_floats float32). Returns the first CUDA
// error, or 0.
extern "C" int spk_weight_grad(int dtype, const void* x, const void* dy, void* dw, void* db,
                               void* ws, size_t ws_floats, int splits, int M, int Hin, int N,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err;
  if (dtype == 0) {
    err = spk::launch_weight_grad<float>(static_cast<const float*>(x),
                                         static_cast<const float*>(dy), f(dw), f(db), f(ws),
                                         ws_floats, splits, M, Hin, N, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    err = spk::launch_weight_grad<bf>(static_cast<const bf*>(x), static_cast<const bf*>(dy),
                                      f(dw), f(db), f(ws), ws_floats, splits, M, Hin, N, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
