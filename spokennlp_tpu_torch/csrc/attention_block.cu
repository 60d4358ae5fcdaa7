// Fused attention block for the H100 (sm_90a):
//   out = LayerNorm(x + (softmax_masked(q k^T) v) Wo + bo)
// with q = (x Wq + bq) * sm_scale, k = x Wk + bk, v = x Wv + bv, and the
// segment-id mask allowed = (seg_q == seg_k) & (seg_k > 0): 0 marks padding,
// equal ids attend, which covers padding and window packing alike.
//
// Replaces the TPU kernel spokennlp_tpu/ops/pallas/attention_block.py,
// fused_attention_block (_attn_block_kernel, and _attn_block_kernel_multi,
// which computes the same function S sequences a grid step), in its float
// modes and its W8A8 mode (quantized=True), with the float attention core or
// the int8 one (core_int8 = "qk", "av" or "both").
//
// What bounds it here. At BERT-base (B=32, L=512, H=768, 12 heads of 64) a
// layer's attention block is about 103 GFLOP: 56% in the QKV projection, 25%
// in the two attention products and 19% in the output projection. That is
// far above the card's ratio of operations to bytes, so the block is bound by
// arithmetic. In bfloat16 the attention core (attention_core.cuh's mma.sync
// m16n8k16 bf16 core) and both projections (bf16_gemm.cuh's mma.sync bf16
// tile) run on the tensor cores, and in W8A8 the projections run the int8
// tile (int8_gemm.cuh's mma.sync s8 tile, weights handed over K-major). The
// float32 projections run tf32x3_gemm.cuh's 3xTF32 tile on the TF32 tensor
// cores; the float32 core stays on the CUDA cores (float32 FMA). Moving the
// tiles onto wgmma is later work.
//
// What the design does about the TPU kernel's assumptions. On the TPU one
// grid step owned a whole (sequence, head group), kept q, k and v in VMEM
// and summed ctx . Wo over head groups in a scratch buffer across sequential
// grid steps. Hopper blocks run in parallel and carry nothing from one to
// the next, so the block is a chain of launches:
//   1. the QKV projection (bf16_gemm.cuh, or int8_gemm.cuh after a row-quant
//      launch of x in W8A8): one GEMM over all B*L rows, bias added, q
//      scaled by sm_scale, stored in the element type as (3, B, nh, L, hd);
//   2. the attention core (attention_core.cuh): one block per (query tile of
//      128 rows in bf16, 64 in float32, head, sequence), exp in the element
//      type as on the TPU; with
//      core_int8, a launch of the q/k scales per (sequence, head group) and
//      one of v's column scales, then the int8 core (__dp4a products, two
//      passes over the keys);
//   3. in W8A8, a row-quant launch of ctx over each head group's HB*hd
//      columns (the TPU quantised each group's ctx in its own grid step);
//   4. ctx . Wo + bo + x and the LayerNorm, with one block owning whole rows
//      so the norm needs no second launch; in W8A8 each head group is its
//      own int32 product with its own scales, summed in float32 in the TPU
//      kernel's order.
// q, k, v, ctx and the pre-norm rows make one round trip through device
// memory (or L2) each; keeping them on chip is later work.
#include "attention_core.cuh"
#include "int8_gemm.cuh"

namespace spk {
namespace {

template <typename T>
cudaError_t attention_block(const T* hidden, const int32_t* seg, const T* wqkv, const float* bqkv,
                            const T* wo, const float* bo, const float* ln_scale,
                            const float* ln_bias, T* qkv_buf, T* ctx_buf, float* ln_buf, T* out,
                            int B, int L, int H, int nh, int hd, float sm_scale, float eps,
                            int fuse_ln, cudaStream_t stream) {
  const int M = B * L, HN = nh * hd;
  cudaError_t err = launch_qkv_proj<T>(hidden, wqkv, bqkv, qkv_buf, B, L, H, nh, hd, sm_scale,
                                       stream);
  if (err != cudaSuccess) return err;
  err = launch_attn_core<T, T>(qkv_buf, seg, ctx_buf, B, L, nh, hd, block_layout(B, L, nh, hd),
                               1.0f, stream);
  if (err != cudaSuccess) return err;
  return launch_residual_ln<T>(ctx_buf, wo, bo, hidden, ln_scale, ln_bias, ln_buf, out, M, H, HN,
                               eps, fuse_ln, stream);
}

// W8A8: x8 (M, max(H, nh hd)) int8 and scales (M * G) float32 hold first
// the quantised x, then the quantised ctx of the G head groups. core: 0 the
// float core, else CoreInt8 flags (1 qk, 2 av, 3 both) with core_scales (2 B
// G + B nh hd floats) as scratch.
template <typename T>
cudaError_t attention_block_w8a8(const T* hidden, const int32_t* seg, int8_t* x8, float* scales,
                                 const int8_t* wqkv, const float* swqkv, const float* bqkv,
                                 const int8_t* wo, const float* swo, const float* bo,
                                 const float* ln_scale, const float* ln_bias, T* qkv_buf,
                                 T* ctx_buf, float* ln_buf, T* out, float* core_scales, int B,
                                 int L, int H, int nh, int hd, int G, int core, float sm_scale,
                                 float eps, int fuse_ln, cudaStream_t stream) {
  const int M = B * L, HN = nh * hd;
  if (G <= 0 || nh % G) return cudaErrorInvalidValue;
  cudaError_t err = launch_rowquant<T>(hidden, M, H, 1, x8, scales, stream);
  if (err != cudaSuccess) return err;
  err = launch_qkv_proj_i8<T>(x8, scales, wqkv, swqkv, bqkv, qkv_buf, B, L, H, nh, hd, sm_scale,
                              stream);
  if (err != cudaSuccess) return err;
  const CoreLayout lay = block_layout(B, L, nh, hd);
  err = core ? launch_attn_core_i8<T>(qkv_buf, seg, ctx_buf, B, L, nh, hd, nh / G, core, lay,
                                      core_scales, stream)
             : launch_attn_core<T, T>(qkv_buf, seg, ctx_buf, B, L, nh, hd, lay, 1.0f, stream);
  if (err != cudaSuccess) return err;
  err = launch_rowquant<T>(ctx_buf, M, HN, G, x8, scales, stream);
  if (err != cudaSuccess) return err;
  return launch_residual_ln_i8<T>(x8, scales, wo, swo, bo, hidden, ln_scale, ln_bias, ln_buf, out,
                                  M, H, HN, G, eps, fuse_ln, stream);
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (hidden, weights, qkv_buf, ctx_buf and
// out); biases, LayerNorm parameters and ln_buf (B*L, H) are float32.
// ln_scale and ln_bias may be null when fuse_ln == 0. Returns the first CUDA
// error, or 0.
extern "C" int spk_attention_block(int dtype, const void* hidden, const void* seg,
                                   const void* wqkv, const void* bqkv, const void* wo,
                                   const void* bo, const void* ln_scale, const void* ln_bias,
                                   void* qkv_buf, void* ctx_buf, void* ln_buf, void* out, int B,
                                   int L, int H, int nh, int hd, float sm_scale, float eps,
                                   int fuse_ln, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  const auto bq = static_cast<const float*>(bqkv);
  const auto bo_ = static_cast<const float*>(bo);
  const auto lns = static_cast<const float*>(ln_scale);
  const auto lnb = static_cast<const float*>(ln_bias);
  const auto lb = static_cast<float*>(ln_buf);
  cudaError_t err;
  if (dtype == 0) {
    using T = float;
    err = spk::attention_block<T>(static_cast<const T*>(hidden), sg, static_cast<const T*>(wqkv),
                                  bq, static_cast<const T*>(wo), bo_, lns, lnb,
                                  static_cast<T*>(qkv_buf), static_cast<T*>(ctx_buf), lb,
                                  static_cast<T*>(out), B, L, H, nh, hd, sm_scale, eps, fuse_ln,
                                  s);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    err = spk::attention_block<T>(static_cast<const T*>(hidden), sg, static_cast<const T*>(wqkv),
                                  bq, static_cast<const T*>(wo), bo_, lns, lnb,
                                  static_cast<T*>(qkv_buf), static_cast<T*>(ctx_buf), lb,
                                  static_cast<T*>(out), B, L, H, nh, hd, sm_scale, eps, fuse_ln,
                                  s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The W8A8 mode. dtype as above for hidden, qkv_buf, ctx_buf and out;
// wqkv (3 nh hd, H) and wo (H, nh hd) are int8, K-major (the (K, N)
// weights transposed), with per-column scales swqkv (3 nh hd) and swo (G,
// H), one row of scales per head group (head group g is wo's K-columns
// [g nh hd / G, (g + 1) nh hd / G)); x8 (B*L,
// max(H, nh hd)) int8 and scales (B*L*G) float32 are scratch. core: 0 for
// the float attention core, 1 ("qk"), 2 ("av") or 3 ("both") for the int8
// one, which takes core_scales (2 B G + B nh hd floats) as scratch (null
// with core 0).
extern "C" int spk_attention_block_w8a8(int dtype, const void* hidden, const void* seg, void* x8,
                                        void* scales, const void* wqkv, const void* swqkv,
                                        const void* bqkv, const void* wo, const void* swo,
                                        const void* bo, const void* ln_scale,
                                        const void* ln_bias, void* qkv_buf, void* ctx_buf,
                                        void* ln_buf, void* out, void* core_scales, int B, int L,
                                        int H, int nh, int hd, int G, int core, float sm_scale,
                                        float eps, int fuse_ln, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  const auto q8 = static_cast<int8_t*>(x8);
  const auto sc = static_cast<float*>(scales);
  const auto w = static_cast<const int8_t*>(wqkv);
  const auto sw = static_cast<const float*>(swqkv);
  const auto bq = static_cast<const float*>(bqkv);
  const auto wo8 = static_cast<const int8_t*>(wo);
  const auto swo_ = static_cast<const float*>(swo);
  const auto bo_ = static_cast<const float*>(bo);
  const auto lns = static_cast<const float*>(ln_scale);
  const auto lnb = static_cast<const float*>(ln_bias);
  const auto lb = static_cast<float*>(ln_buf);
  const auto cs = static_cast<float*>(core_scales);
  cudaError_t err;
  if (dtype == 0) {
    using T = float;
    err = spk::attention_block_w8a8<T>(static_cast<const T*>(hidden), sg, q8, sc, w, sw, bq, wo8,
                                       swo_, bo_, lns, lnb, static_cast<T*>(qkv_buf),
                                       static_cast<T*>(ctx_buf), lb, static_cast<T*>(out), cs, B,
                                       L, H, nh, hd, G, core, sm_scale, eps, fuse_ln, s);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    err = spk::attention_block_w8a8<T>(static_cast<const T*>(hidden), sg, q8, sc, w, sw, bq, wo8,
                                       swo_, bo_, lns, lnb, static_cast<T*>(qkv_buf),
                                       static_cast<T*>(ctx_buf), lb, static_cast<T*>(out), cs, B,
                                       L, H, nh, hd, G, core, sm_scale, eps, fuse_ln, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The attention core alone, as both modes above launch it (step 2, with no
// int8 core): qkv_buf (3, B, nh, L, hd) as the QKV projection leaves it, q
// already scaled; ctx_buf (B*L, nh hd); dtype as above, the exponent taken
// in it. Times the core at the block's own launch. Returns the first CUDA
// error, or 0.
extern "C" int spk_attention_core(int dtype, const void* qkv_buf, const void* seg, void* ctx_buf,
                                  int B, int L, int nh, int hd, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  const spk::CoreLayout lay = spk::block_layout(B, L, nh, hd);
  cudaError_t err;
  if (dtype == 0) {
    using T = float;
    err = spk::launch_attn_core<T, T>(static_cast<const T*>(qkv_buf), sg, static_cast<T*>(ctx_buf),
                                      B, L, nh, hd, lay, 1.0f, s);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    err = spk::launch_attn_core<T, T>(static_cast<const T*>(qkv_buf), sg, static_cast<T*>(ctx_buf),
                                      B, L, nh, hd, lay, 1.0f, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* spk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
