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
// weights and outputs in bf16: bound by arithmetic. In bf16 the forward's two
// products run bf16_gemm.cuh's tensor-core tile; the rest (the float32
// modes, the backward's products and the recomputed act') are SIMT kernels
// on the CUDA cores in float32, whose move to the tensor cores is later
// work.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// kept both weight matrices in VMEM, the (rows, I) intermediate in registers,
// and summed dW1, db1, dW2, db2 over its sequential grid of row blocks in its
// output buffers. Here:
//   forward  1. h = act(x W1 + b1) rounded to the element type, where the
//               TPU kernel rounds it, stored (M, I);
//            2. y = h W2 + b2.
//   backward 1. pre = x W1 + b1 recomputed; h (rounded) and act'(pre) in
//               float32 from one tanh (activation_and_grad, common.cuh);
//            2. dpre = (g W2^T) act'(pre), rounded;
//            3. dx = dpre W1^T;
//            4. dW1 = x^T dpre with db1, and dW2 = h^T g with db2, in
//               weight_grad_kernel (common.cuh): one block per tile of the
//               weight gradient walks all M rows, so the sums over rows need
//               no atomics and come out the same on every run.
// The (M, I) intermediates (h, and in the backward act' and dpre) make a
// round trip through device memory; keeping them on chip is later work.
#include "bf16_gemm.cuh"

namespace spk {
namespace {

// pre = x W1 + b1; h = act(pre) stored rounded in T, hgrad = act'(pre) in
// float32. Grid (ceil(I / 64), ceil(M / 64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    act_and_grad_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ b1, T* __restrict__ h,
                        float* __restrict__ hgrad, int M, int H, int I, int act) {
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
                          float* dw2, float* db2, int M, int H, int I, int act,
                          cudaStream_t stream) {
  const dim3 grid((I + 63) / 64, (M + 63) / 64);
  act_and_grad_kernel<T><<<grid, kThreads, 0, stream>>>(x, w1, b1, h_buf, hgrad_buf, M, H, I,
                                                        act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dpre = (g W2^T) act'(pre), rounded (W2 is (I, H): read transposed)
  err = launch_gemm<T, true>(g, w2, nullptr, dpre_buf, M, I, H, kActNone, hgrad_buf, stream);
  if (err != cudaSuccess) return err;
  // dx = dpre W1^T (W1 is (H, I): read transposed)
  err = launch_gemm<T, true>(dpre_buf, w1, nullptr, dx, M, H, I, kActNone, nullptr, stream);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad<T>(x, dpre_buf, dw1, db1, M, H, I, stream);
  if (err != cudaSuccess) return err;
  return launch_weight_grad<T>(h_buf, g, dw2, db2, M, I, H, stream);
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (x, weights, g, h_buf, dpre_buf and the
// outputs out/dx); biases, hgrad_buf and the weight/bias gradients are
// float32; act is an ACTIVATION_CODES value. Each entry returns the first
// CUDA error, or 0.
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
                                 void* db2, int M, int H, int I, int act, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b1_ = static_cast<const float*>(b1);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err;
  if (dtype == 0) {
    err = spk::mlp_train_bwd<float>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1_,
        static_cast<const float*>(w2), static_cast<const float*>(g), f(h_buf), f(hgrad_buf),
        f(dpre_buf), f(dx), f(dw1), f(db1), f(dw2), f(db2), M, H, I, act, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    const auto t = [](void* p) { return static_cast<bf*>(p); };
    err = spk::mlp_train_bwd<bf>(static_cast<const bf*>(x), static_cast<const bf*>(w1), b1_,
                                 static_cast<const bf*>(w2), static_cast<const bf*>(g), t(h_buf),
                                 f(hgrad_buf), t(dpre_buf), t(dx), f(dw1), f(db1), f(dw2),
                                 f(db2), M, H, I, act, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
