// Fused BigBird attention block for the H100 (sm_90a), inference:
//   out = LayerNorm(x + attn(x) Wo + bo)
// with attn the ITC block-sparse attention of bigbird_attention.cuh (window
// blocks, global columns, random blocks from a static table, global rows
// dense over every real key).
//
// Replaces the TPU kernel spokennlp_tpu/ops/pallas/bigbird_block_kernel.py,
// fused_bigbird_attention_block (_bigbird_block_kernel), in its float modes
// and its W8A8 mode (quantized=True).
//
// What bounds it here. At BigBird-base's serving shape (B=4, L=4096, H=768,
// 12 heads of 64, blocks of 64, 2 global and 3 random blocks) a layer's block
// is about 77 GFLOP of projections (q, k, v, out) and 30 GFLOP of attention
// (at most 8 key blocks a query block, 64 for the two global blocks)
// against some 30 MB of inputs, weights and output: bound by arithmetic.
// In bf16 the projections and the out-LN run bf16_gemm.cuh's tensor-core
// tile and the rows kernel attention_rows_mma.cuh's tensor-core body (S and
// P.V on mma.sync, the mask, exponent and sums on the fragments); float32
// keeps the rows kernel on the CUDA cores.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// ran one grid step per sequence, kept q, k, v of the whole sequence in VMEM
// (with a block of zero rows on each side for the window slabs), read the
// random block ids from SMEM and walked the query blocks in a loop, then ran
// the global rows densely. Hopper blocks run in parallel and hold far less,
// so the block is launches over the whole batch:
//   1. sliding_count_kernel: n_valid of each sequence (the suffix-padding
//      contract turns the mask into one count, as on the TPU);
//   2. qkv_proj_kernel (bf16_gemm.cuh): q (scaled), k, v to (3, B, nh, L, hd);
//   3. bigbird_rows_kernel: per (64 query rows, head, sequence) the key tiles
//      of its pieces, two passes (max, then exp and P.V); a tile of a global
//      block walks every real key instead, so the global rows need no launch
//      of their own and no sparse pass that the TPU kernel overwrote;
//   4. gemm_bias_residual_ln_kernel (bf16_gemm.cuh): ctx . Wo + bo + x and the
//      LayerNorm.
// The random table (and its validity flags) lives on the device, built once
// per pattern by the wrapper; a block reads its own entries.
//
// W8A8 (the TPU kernel's quantized=True): the QKV and output projections run
// int8 x int8 -> int32 (int8_gemm.cuh) with weights quantised per output
// column in the wrapper, x quantised per row once, and ctx kept in float32
// up to its own row quantisation, as the TPU kernel quantised its float32
// ctx scratch:
//   rowquant(x) -> int8 q, k, v -> the rows kernel (float32 ctx) ->
//   rowquant(ctx) -> int8 ctx . Wo + bo + x and the LayerNorm.
// The projections are about 7 of every 10 operations at the serving shape;
// they run on the tensor cores (int8_gemm.cuh's mma.sync s8 tile, weights
// K-major), and the rows kernel runs the bf16 tensor-core body with a
// float32 ctx (Tc = float).
#include "bigbird_attention.cuh"

namespace spk {
namespace {

template <typename T>
cudaError_t bigbird_block(const T* hidden, const int32_t* mask, const int32_t* rand,
                          const int32_t* rok, const T* wqkv, const float* bqkv, const T* wo,
                          const float* bo, const float* ln_scale, const float* ln_bias,
                          int32_t* counts, T* qkv_buf, T* ctx_buf, float* ln_buf, T* out, int B,
                          int L, int H, int nh, int hd, int C, int G, int R, float sm_scale,
                          float eps, int fuse_ln, cudaStream_t stream) {
  cudaError_t err = bigbird_projections<T>(hidden, mask, wqkv, bqkv, counts, qkv_buf, B, L, H, nh,
                                           hd, sm_scale, stream);
  if (err != cudaSuccess) return err;
  const BigBird bb = make_bigbird(L, C, G, R, rand, rok);
  err = bigbird_attention<T, false>(bb, nullptr, counts, qkv_buf, nullptr, ctx_buf, nullptr, B, nh,
                                    hd, 0u, 1.0f, stream);
  if (err != cudaSuccess) return err;
  return launch_residual_ln<T>(ctx_buf, wo, bo, hidden, ln_scale, ln_bias, ln_buf, out, B * L, H,
                               nh * hd, eps, fuse_ln, stream);
}

// W8A8: x8 (B L, max(H, nh hd)) int8 and scales (B L) float32 hold first
// the quantised x, then the quantised ctx; ctx_buf (B L, nh hd) is float32.
template <typename T>
cudaError_t bigbird_block_w8a8(const T* hidden, const int32_t* mask, const int32_t* rand,
                               const int32_t* rok, int8_t* x8, float* scales, const int8_t* wqkv,
                               const float* swqkv, const float* bqkv, const int8_t* wo,
                               const float* swo, const float* bo, const float* ln_scale,
                               const float* ln_bias, int32_t* counts, T* qkv_buf, float* ctx_buf,
                               float* ln_buf, T* out, int B, int L, int H, int nh, int hd, int C,
                               int G, int R, float sm_scale, float eps, int fuse_ln,
                               cudaStream_t stream) {
  const int M = B * L, HN = nh * hd;
  // the Longformer block's W8A8 projections without global rows: the mask
  // stands in for the global mask, and counts holds (n_valid, 0)
  cudaError_t err = sliding_projections_w8a8<T>(hidden, mask, mask, x8, scales, wqkv, swqkv, bqkv,
                                                nullptr, nullptr, nullptr, counts, qkv_buf,
                                                nullptr, B, L, H, nh, hd, 0, 0, sm_scale, stream);
  if (err != cudaSuccess) return err;
  const BigBird bb = make_bigbird(L, C, G, R, rand, rok);
  err = bigbird_attention<T, false, float>(bb, nullptr, counts, qkv_buf, nullptr, ctx_buf, nullptr,
                                           B, nh, hd, 0u, 1.0f, stream);
  if (err != cudaSuccess) return err;
  if ((err = launch_rowquant<float>(ctx_buf, M, HN, 1, x8, scales, stream)) != cudaSuccess)
    return err;
  return launch_residual_ln_i8<T>(x8, scales, wo, swo, bo, hidden, ln_scale, ln_bias, ln_buf, out,
                                  M, H, HN, 1, eps, fuse_ln, stream);
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (hidden, weights, the q/k/v and ctx
// buffers and out); mask (B, L), rand and rok (nb, max(R, 1)) and counts
// (B, 2) int32; biases, LayerNorm parameters and ln_buf (B*L, H) float32.
// wqkv (H, 3 nh hd), wo (nh hd, H). Returns the first CUDA error, or 0.
extern "C" int spk_bigbird_block(int dtype, const void* hidden, const void* mask, const void* rand,
                                 const void* rok, const void* wqkv, const void* bqkv,
                                 const void* wo, const void* bo, const void* ln_scale,
                                 const void* ln_bias, void* counts, void* qkv_buf, void* ctx_buf,
                                 void* ln_buf, void* out, int B, int L, int H, int nh, int hd,
                                 int C, int G, int R, float sm_scale, float eps, int fuse_ln,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto run = [&](auto tag) {
    using F = decltype(tag);
    const auto c = [](const void* p) { return static_cast<const F*>(p); };
    const auto m = [](void* p) { return static_cast<F*>(p); };
    return spk::bigbird_block<F>(c(hidden), i32(mask), i32(rand), i32(rok), c(wqkv), f32(bqkv),
                                 c(wo), f32(bo), f32(ln_scale), f32(ln_bias),
                                 static_cast<int32_t*>(counts), m(qkv_buf), m(ctx_buf),
                                 static_cast<float*>(ln_buf), m(out), B, L, H, nh, hd, C, G, R,
                                 sm_scale, eps, fuse_ln, s);
  };
  cudaError_t err = dtype == 0   ? run(float{})
                    : dtype == 1 ? run(__nv_bfloat16{})
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The W8A8 mode. dtype as above for hidden, qkv_buf and out; wqkv (3 nh hd,
// H) and wo (H, nh hd) int8, K-major, with per-column scales swqkv and swo;
// x8 (B L, max(H, nh hd)) int8, scales (B L) and ctx_buf (B L, nh hd)
// float32 are scratch.
extern "C" int spk_bigbird_block_w8a8(int dtype, const void* hidden, const void* mask,
                                      const void* rand, const void* rok, void* x8, void* scales,
                                      const void* wqkv, const void* swqkv, const void* bqkv,
                                      const void* wo, const void* swo, const void* bo,
                                      const void* ln_scale, const void* ln_bias, void* counts,
                                      void* qkv_buf, void* ctx_buf, void* ln_buf, void* out, int B,
                                      int L, int H, int nh, int hd, int C, int G, int R,
                                      float sm_scale, float eps, int fuse_ln, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto run = [&](auto tag) {
    using F = decltype(tag);
    return spk::bigbird_block_w8a8<F>(
        static_cast<const F*>(hidden), i32(mask), i32(rand), i32(rok), static_cast<int8_t*>(x8),
        static_cast<float*>(scales), i8(wqkv), f32(swqkv), f32(bqkv), i8(wo), f32(swo), f32(bo),
        f32(ln_scale), f32(ln_bias), static_cast<int32_t*>(counts), static_cast<F*>(qkv_buf),
        static_cast<float*>(ctx_buf), static_cast<float*>(ln_buf), static_cast<F*>(out), B, L, H,
        nh, hd, C, G, R, sm_scale, eps, fuse_ln, s);
  };
  const cudaError_t err = dtype == 0   ? run(float{})
                          : dtype == 1 ? run(__nv_bfloat16{})
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// bigbird_rows_kernel alone, on (3, B, nh, L, hd) q (scaled), k, v in qkv,
// counts (B, 2) int32 and the pattern's rand and rok (nb, max(R, 1)) int32,
// into ctx (B, L, nh hd) and, with grad, the row statistics (3, B, nh, L)
// float32 (dctx (B, L, nh hd) read). dtype and ctx_f32 as for
// spk_sliding_rows; seed (1,) int32 may be null when thr is 0. parts: the
// tiles launched, 1 the global ones, 2 the others, 3 both (as the blocks
// launch them). Returns the first CUDA error, or 0.
extern "C" int spk_bigbird_rows(int dtype, int ctx_f32, int grad, const void* qkv,
                                const void* counts, const void* rand, const void* rok,
                                const void* seed, const void* dctx, void* ctx, void* stats, int B,
                                int L, int nh, int hd, int C, int G, int R, unsigned thr,
                                float keep_prob, int parts, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const spk::BigBird bb = spk::make_bigbird(L, C, G, R, i32(rand), i32(rok));
  const auto run = [&](auto t_tag, auto c_tag, auto grad_c) {
    using T = decltype(t_tag);
    using Tc = decltype(c_tag);
    return spk::bigbird_attention<T, decltype(grad_c)::value, Tc>(
        bb, i32(seed), i32(counts), static_cast<const T*>(qkv), static_cast<const T*>(dctx),
        static_cast<Tc*>(ctx), static_cast<float*>(stats), B, nh, hd, thr, keep_prob, s,
        parts);
  };
  using bf16 = __nv_bfloat16;
  using Yes = std::true_type;
  using No = std::false_type;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = grad ? run(float{}, float{}, Yes{}) : run(float{}, float{}, No{});
  } else if (dtype == 1 && ctx_f32) {
    if (!grad) err = run(bf16{}, float{}, No{});
  } else if (dtype == 1) {
    err = grad ? run(bf16{}, bf16{}, Yes{}) : run(bf16{}, bf16{}, No{});
  }
  return static_cast<int>(err);
}
