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
// weights and outputs in bf16: bound by arithmetic. Every product, forward
// and backward, runs on the tensor cores, on bf16_gemm.cuh's tile of the
// element type (bf16's mma.sync tile, or tf32x3_gemm.cuh's 3xTF32 tile in
// float32): the forward's two, the recomputed x W1 with its act' epilogue,
// the two products with a weight read transposed (its (N, K) rows are the
// mma's column fragments) and the two weight gradients, whose sums over the
// rows are split into fixed row ranges summed in order.
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
//               launch_weight_grad (bf16_gemm.cuh): a block owns a tile of
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
// float32: the forward's first product (gemm_bias_act_kernel) on the same
// tile, in the same k-order and with the same bias sum, so h has the
// forward's bits. Grid (ceil(I / kGemmColsB), ceil(M / kGemmRowsB)),
// GemmTile<T>::kSmemBytes of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    act_and_grad_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ b1, T* __restrict__ h,
                        float* __restrict__ hgrad, int M, int H, int I, int act) {
  using G = GemmTile<T>;
  extern __shared__ __align__(16) unsigned char smem_act[];
  const int row0 = blockIdx.y * G::kRows, col0 = blockIdx.x * G::kCols;
  typename G::Acc acc;
  G::run(x, w1, M, I, H, row0, col0, acc, smem_act);
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
  using G = GemmTile<T>;
  cudaError_t err = prepare(act_and_grad_kernel<T>, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((I + G::kCols - 1) / G::kCols, (M + G::kRows - 1) / G::kRows);
  act_and_grad_kernel<T><<<grid, kThreads, G::kSmemBytes, stream>>>(x, w1, b1, h_buf, hgrad_buf,
                                                                    M, H, I, act);
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
// (launch_weight_grad, bf16_gemm.cuh). Each entry returns the
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
// (M, Hin) and dy (M, N) in the element type, over `splits` row ranges with
// the workspace ws (ws_floats float32). Returns the first CUDA error, or 0.
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

// One forward tile kernel of bf16_gemm.cuh alone, on the tile of its element
// type (dtype: 0 = float32, 1 = bfloat16 of A, W, resid and out); no model
// path calls it. which 0: out (M, N) = act(A (M, K) . W (K, N) + bias) *
// gate (gemm_bias_act_kernel; bias (N,) and gate (M, N) float32 may be
// null). 1: out (M, N) = LayerNorm(resid + A . W + bias) * ln_scale + ln_bias
// (gemm_bias_residual_ln_kernel; rows (M, N) float32 scratch), or A . W +
// bias when ln_scale and resid are null. 2: the q/k/v projection of A (M, K) by W (K, N
// = 3 nh hd) + bias into out (3, 1, nh, M, hd), q scaled by sm_scale
// (qkv_proj_kernel). 3: as 0 with W (N, K) read transposed, the training
// backwards' products (launch_gemm<T, true>). Returns the first CUDA error,
// or 0.
extern "C" int spk_forward_tile(int dtype, int which, const void* A, const void* W,
                                const void* bias, const void* gate, const void* resid,
                                const void* ln_scale, const void* ln_bias, void* rows, void* out,
                                int M, int N, int K, int act, int nh, float sm_scale, float eps,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (which == 2 && (nh <= 0 || N % (3 * nh))) ||
      (which == 1 && (ln_scale == nullptr) != (resid == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto zero) -> cudaError_t {
    using T = decltype(zero);
    const T* a = static_cast<const T*>(A);
    const T* w = static_cast<const T*>(W);
    T* o = static_cast<T*>(out);
    switch (which) {
      case 0:
        return spk::launch_gemm<T>(a, w, f(bias), o, M, N, K, act, f(gate), s);
      case 1:
        return spk::launch_residual_ln<T>(a, w, f(bias), static_cast<const T*>(resid),
                                          f(ln_scale), f(ln_bias), static_cast<float*>(rows), o,
                                          M, N, K, eps, ln_scale != nullptr, s);
      case 2:
        return spk::launch_qkv_proj<T>(a, w, f(bias), o, 1, M, K, nh, N / (3 * nh), sm_scale, s);
      case 3:
        return spk::launch_gemm<T, true>(a, w, f(bias), o, M, N, K, act, f(gate), s);
      default:
        return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return static_cast<int>(run(0.0f));
  if (dtype == 1) return static_cast<int>(run(__nv_bfloat16()));
  return static_cast<int>(cudaErrorInvalidValue);
}
