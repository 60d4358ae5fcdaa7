// Fused MLP half-layer for the H100 (sm_90a):
//   out = LayerNorm(x + act(x W1 + b1) W2 + b2)
// with "gelu" in its tanh form, as the TPU kernel computes it.
//
// Replaces the TPU kernel spokennlp_tpu/ops/pallas/mlp_block.py,
// fused_mlp_block (_mlp_block_kernel), in its float modes and its W8A8 modes
// (quantized=True, with static_h_scale False or True).
//
// What bounds it here. At BERT-base (M = 32 * 512 rows, H=768, I=3072) the
// block is 155 GFLOP against about 60 MB of input, weights and output in
// bfloat16, plus 200 MB for the intermediate's round trip below: some 600
// operations a byte, so it is bound by arithmetic. In bfloat16 both products
// run on the tensor cores (bf16_gemm.cuh's mma.sync bf16 tile, float32
// sums), in float32 too (tf32x3_gemm.cuh's 3xTF32 tile on the TF32 tensor
// cores, three TF32 products a pair of operands).
// In W8A8 both products run on the tensor cores (int8_gemm.cuh's mma.sync s8
// tile, weights handed over K-major): the tile's issue rate and barriers
// bound them, and the float32 intermediate's round trip below (about 0.2 ms
// at this shape) and the row-quant passes become a visible share; wgmma with
// TMA is later work.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// kept both weight matrices resident in VMEM and the (rows, I) intermediate
// in registers for each block of rows. A Hopper block has at most 227 KB of
// shared memory, so the block is a chain of launches:
//   1. gemm_bias_act: act(x W1 + b1), stored in the element type as (M, I),
//      which is where the TPU kernel rounds it before the second product;
//   2. gemm_bias_residual_ln: h W2 + b2 + x and the LayerNorm, with one block
//      owning whole rows (bf16_gemm.cuh).
// In W8A8 the TPU kernel row-quantises the intermediate in float32, before
// any rounding, over all I columns. Those columns are spread over many
// column tiles here, so a block that owned whole rows would have to hold
// (rows, 3072) float32 or compute them twice; instead the W1 product writes
// act(x W1 + b1) in float32 to a scratch, one row-quant launch (a warp a
// row) takes each row's absmax and quantises it, and the second product
// reads int8:
//   rowquant(x) -> int8 x W1 (float32 out) -> rowquant(h) -> int8 h W2 +
//   b2 + x and LayerNorm.
// The intermediate (M * I elements) and the pre-norm rows make one round
// trip through device memory (or L2); keeping them on chip is later work.
//
// With a static intermediate scale (static_h_scale: one per-tensor scale s,
// estimated by the wrapper from a row sample, as the TPU kernel's caller
// does) nothing needs a row's absmax, so the W1 product's epilogue quantises
// act(x W1 + b1) with s in registers and writes int8 (M * I bytes, not a
// float32 scratch and a row-quant pass):
//   rowquant(x) -> int8 x W1, act, quantise by s -> int8 h W2 + b2 + x and
//   LayerNorm.
#include "int8_gemm.cuh"

namespace spk {
namespace {

template <typename T>
cudaError_t mlp_block(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
                      const float* ln_scale, const float* ln_bias, T* h_buf, float* ln_buf, T* out,
                      int M, int H, int I, int act, float eps, cudaStream_t stream) {
  const cudaError_t err = launch_gemm<T>(x, w1, b1, h_buf, M, I, H, act, nullptr, stream);
  if (err != cudaSuccess) return err;
  return launch_residual_ln<T>(h_buf, w2, b2, x, ln_scale, ln_bias, ln_buf, out, M, H, I, eps,
                               1, stream);
}

// Per-row intermediate scales (hs null): x8 (M, I) int8 and scales (M) hold
// first the quantised x, then the quantised intermediate; h_buf (M, I) is
// float32. Static scale (hs: the one float32 scale on the device): x8 (M, H
// + I) and scales (2 M) hold x's and the intermediate's side by side, since
// the fused epilogue writes one while other blocks still read the other;
// h_buf is unused.
template <typename T>
cudaError_t mlp_block_w8a8(const T* x, int8_t* x8, float* scales, const int8_t* w1,
                           const float* sw1, const float* b1, const int8_t* w2, const float* sw2,
                           const float* b2, const float* ln_scale, const float* ln_bias,
                           const float* hs, float* h_buf, float* ln_buf, T* out, int M, int H,
                           int I, int act, float eps, cudaStream_t stream) {
  cudaError_t err = launch_rowquant<T>(x, M, H, 1, x8, scales, stream);
  if (err != cudaSuccess) return err;
  if (hs != nullptr) {
    int8_t* h8 = x8 + (size_t)M * H;
    err = launch_gemm_act_quant_i8(x8, scales, w1, sw1, b1, hs, h8, scales + M, M, I, H, act,
                                   stream);
    if (err != cudaSuccess) return err;
    return launch_residual_ln_i8<T>(h8, scales + M, w2, sw2, b2, x, ln_scale, ln_bias, ln_buf,
                                    out, M, H, I, 1, eps, 1, stream);
  }
  err = launch_gemm_i8<float>(x8, scales, w1, sw1, b1, h_buf, M, I, H, act, stream);
  if (err != cudaSuccess) return err;
  err = launch_rowquant<float>(h_buf, M, I, 1, x8, scales, stream);
  if (err != cudaSuccess) return err;
  return launch_residual_ln_i8<T>(x8, scales, w2, sw2, b2, x, ln_scale, ln_bias, ln_buf, out, M,
                                  H, I, 1, eps, 1, stream);
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (x, weights, h_buf and out); biases,
// LayerNorm parameters and ln_buf (M, H) are float32; act is an
// ACTIVATION_CODES value.
// Returns the first CUDA error, or 0.
extern "C" int spk_mlp_block(int dtype, const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* ln_scale,
                             const void* ln_bias, void* h_buf, void* ln_buf, void* out, int M,
                             int H, int I, int act, float eps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b1_ = static_cast<const float*>(b1);
  const auto b2_ = static_cast<const float*>(b2);
  const auto lns = static_cast<const float*>(ln_scale);
  const auto lnb = static_cast<const float*>(ln_bias);
  cudaError_t err;
  if (dtype == 0) {
    err = spk::mlp_block<float>(static_cast<const float*>(x), static_cast<const float*>(w1), b1_,
                                static_cast<const float*>(w2), b2_, lns, lnb,
                                static_cast<float*>(h_buf), static_cast<float*>(ln_buf),
                                static_cast<float*>(out), M, H, I, act, eps, s);
  } else if (dtype == 1) {
    err = spk::mlp_block<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1), b1_,
        static_cast<const __nv_bfloat16*>(w2), b2_, lns, lnb,
        static_cast<__nv_bfloat16*>(h_buf), static_cast<float*>(ln_buf),
        static_cast<__nv_bfloat16*>(out), M, H, I, act, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The W8A8 modes: x and out as above; w1 (I, H) and w2 (H, I) int8, K-major
// (the (K, N) weights transposed), with per-column scales sw1 (I) and sw2
// (H). h_scale null: per-row intermediate scales, x8 (M, I) int8, scales (M)
// and h_buf (M, I) float32 are scratch.
// h_scale (one float32 on the device): the static intermediate scale, x8
// (M, H + I) and scales (2 M) are scratch and h_buf may be null.
extern "C" int spk_mlp_block_w8a8(int dtype, const void* x, void* x8, void* scales,
                                  const void* w1, const void* sw1, const void* b1, const void* w2,
                                  const void* sw2, const void* b2, const void* ln_scale,
                                  const void* ln_bias, const void* h_scale, void* h_buf,
                                  void* ln_buf, void* out, int M, int H, int I, int act, float eps,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto q8 = static_cast<int8_t*>(x8);
  const auto sc = static_cast<float*>(scales);
  const auto w1_ = static_cast<const int8_t*>(w1);
  const auto w2_ = static_cast<const int8_t*>(w2);
  const auto sw1_ = static_cast<const float*>(sw1);
  const auto sw2_ = static_cast<const float*>(sw2);
  const auto b1_ = static_cast<const float*>(b1);
  const auto b2_ = static_cast<const float*>(b2);
  const auto lns = static_cast<const float*>(ln_scale);
  const auto lnb = static_cast<const float*>(ln_bias);
  const auto hs = static_cast<const float*>(h_scale);
  const auto hb = static_cast<float*>(h_buf);
  const auto lb = static_cast<float*>(ln_buf);
  cudaError_t err;
  if (dtype == 0) {
    using T = float;
    err = spk::mlp_block_w8a8<T>(static_cast<const T*>(x), q8, sc, w1_, sw1_, b1_, w2_, sw2_, b2_,
                                 lns, lnb, hs, hb, lb, static_cast<T*>(out), M, H, I, act, eps, s);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    err = spk::mlp_block_w8a8<T>(static_cast<const T*>(x), q8, sc, w1_, sw1_, b1_, w2_, sw2_, b2_,
                                 lns, lnb, hs, hb, lb, static_cast<T*>(out), M, H, I, act, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
