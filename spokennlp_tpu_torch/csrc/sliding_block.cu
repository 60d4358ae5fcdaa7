// Fused Longformer attention block for the H100 (sm_90a), inference:
//   out = LayerNorm(x + attn(x) Wo + bo)
// with attn the sliding-window + global-token attention of
// sliding_attention.cuh (band |i - j| <= C over real keys, G global columns,
// global rows replaced through the *_global projections).
//
// Replaces the TPU kernel spokennlp_tpu/ops/pallas/sliding_block.py,
// fused_sliding_attention_block (_sliding_block_kernel), in its float modes
// and its W8A8 mode (quantized=True).
//
// What bounds it here. At the Longformer-base recipe (B=8, L=2048, H=768,
// 12 heads of 64, window 512, CLS global) a layer's block is about 116 GFLOP
// of projections (local q, k, v, global k, v, out) and 26 GFLOP of band
// attention (2C + 1 keys a row) against some 60 MB of inputs, weights and
// output: bound by arithmetic. In bf16 the projections and the out-LN run
// bf16_gemm.cuh's tensor-core tile and band_rows_kernel attention_rows_mma.cuh's
// tensor-core body (S and P.V on mma.sync, the mask, exponent and sums on the
// fragments), and global_rows_kernel global_rows_mma.cuh's (the global
// query, S and P.V on mma.sync, the keys split over the warps); float32
// runs the same kernels as 3xTF32 on mma.sync TF32 (tf32x3_gemm.cuh's tile,
// the 3xTF32 siblings of both attention bodies, the global rows' keys split
// further over a cluster of blocks).
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// ran one grid step per sequence, kept q, k, v of the whole sequence in VMEM
// with C rows of zero padding on each side, and walked C-row chunks over a
// (C, 3C) band. Hopper blocks run in parallel and hold far less, so the
// block is launches over the whole batch:
//   1. sliding_count_kernel: n_valid and n_glob of each sequence (the
//      suffix-padding / prefix-globals contract turns both masks into two
//      counts, as on the TPU);
//   2. qkv_proj_kernel (bf16_gemm.cuh): local q (scaled), k, v, and with global
//      rows the global k, v over all rows, to (slots, B, nh, L, hd);
//   3. band_rows_kernel: per (64 query rows, head, sequence) the 64 + 2C
//      band keys in 64-key tiles (tiles with no real, non-global key are
//      skipped) and the global-column tile, two passes (max, then exp and
//      P.V): the band never leaves the block;
//   4. global_rows_kernel: per (16 global rows, head, sequence) their
//      query projected from x and attention over all real keys, written
//      over the local rows; only tiles that hold a row g < n_glob run
//      (float32: a cluster of blocks a tile, each over a range of keys);
//   5. gemm_bias_residual_ln_kernel (bf16_gemm.cuh): ctx . Wo + bo + x and the
//      LayerNorm.
//
// W8A8 (the TPU kernel's quantized=True). The local q, k, v, the global k,
// v, the global query and the output projection run int8 x int8 -> int32
// with weights quantised per output column (in the wrapper) and one row
// quantisation of x shared by all of them, as on the TPU, where the global
// query of row g took the same x8[g] and its scale:
//   rowquant(x) -> int8 q, k, v (int8_gemm.cuh) -> int8 kg, vg -> band rows
//   -> global rows (the int32 product x8[g] . Wgq8 in the block) -> rowquant
//   of the float32 ctx -> int8 ctx . Wo + bo + x and the LayerNorm.
// ctx stays float32 up to its row quantisation: the TPU kernel held it in a
// float32 scratch and quantised that, rounding to the element type only in
// its float modes. The projections are 7 of every 8 operations at the
// recipe's shape, here on the tensor cores (int8_gemm.cuh's mma.sync s8
// tile, weights K-major); the global query stays an exact int32 loop on
// the CUDA cores in global_rows_kernel (one live row a sequence on the main
// paths, too small for a tile), and the band and global rows run their
// tensor-core bodies (bf16 with a float32 ctx, Tc = float, or 3xTF32 on
// float32 activations).
#include "sliding_attention.cuh"

namespace spk {
namespace {

template <typename T>
cudaError_t sliding_block(const T* hidden, const int32_t* mask, const int32_t* glob,
                          const T* wqkv, const float* bqkv, const T* wgq,
                          const float* bgq, const T* wgkv, const float* bgkv, const T* wo,
                          const float* bo, const float* ln_scale, const float* ln_bias,
                          int32_t* counts, T* qkv_buf, T* gkv_buf, T* ctx_buf, float* ln_buf,
                          T* out, int B, int L, int H, int nh, int hd, int C, int G,
                          int global_rows, float sm_scale, float eps, int fuse_ln,
                          cudaStream_t stream) {
  cudaError_t err = sliding_projections<T>(hidden, mask, glob, wqkv, bqkv, wgkv, bgkv, counts,
                                           qkv_buf, gkv_buf, B, L, H, nh, hd, G, global_rows,
                                           sm_scale, stream);
  if (err != cudaSuccess) return err;
  err = sliding_attention<T, false>(hidden, nullptr, wgq, bgq, counts, qkv_buf, gkv_buf, nullptr,
                                    ctx_buf, nullptr, nullptr, nullptr, nullptr, B, L, H, nh, hd,
                                    C, G, global_rows, 0, sm_scale, 0u, 1.0f, stream);
  if (err != cudaSuccess) return err;
  return launch_residual_ln<T>(ctx_buf, wo, bo, hidden, ln_scale, ln_bias, ln_buf, out, B * L, H,
                               nh * hd, eps, fuse_ln, stream);
}

// W8A8: x8 (B L, max(H, nh hd)) int8 and scales (B L) float32 hold first
// the quantised x (read by the projections and the global rows), then the
// quantised ctx; ctx_buf (B L, nh hd) is float32.
template <typename T>
cudaError_t sliding_block_w8a8(const T* hidden, const int32_t* mask, const int32_t* glob,
                               int8_t* x8, float* scales, const int8_t* wqkv, const float* swqkv,
                               const float* bqkv, const int8_t* wgq, const float* swgq,
                               const float* bgq, const int8_t* wgkv, const float* swgkv,
                               const float* bgkv, const int8_t* wo, const float* swo,
                               const float* bo, const float* ln_scale, const float* ln_bias,
                               int32_t* counts, T* qkv_buf, T* gkv_buf, float* ctx_buf,
                               float* ln_buf, T* out, int B, int L, int H, int nh, int hd, int C,
                               int G, int global_rows, float sm_scale, float eps, int fuse_ln,
                               cudaStream_t stream) {
  const int M = B * L, HN = nh * hd;
  cudaError_t err = sliding_projections_w8a8<T>(hidden, mask, glob, x8, scales, wqkv, swqkv, bqkv,
                                                wgkv, swgkv, bgkv, counts, qkv_buf, gkv_buf, B, L,
                                                H, nh, hd, G, global_rows, sm_scale, stream);
  if (err != cudaSuccess) return err;
  const QuantQuery qq{x8, scales, wgq, swgq};
  err = sliding_attention<T, false, float>(hidden, nullptr, nullptr, bgq, counts, qkv_buf, gkv_buf,
                                           nullptr, ctx_buf, nullptr, nullptr, nullptr, nullptr, B,
                                           L, H, nh, hd, C, G, global_rows, 0, sm_scale, 0u, 1.0f,
                                           stream, qq);
  if (err != cudaSuccess) return err;
  if ((err = launch_rowquant<float>(ctx_buf, M, HN, 1, x8, scales, stream)) != cudaSuccess)
    return err;
  return launch_residual_ln_i8<T>(x8, scales, wo, swo, bo, hidden, ln_scale, ln_bias, ln_buf, out,
                                  M, H, HN, 1, eps, fuse_ln, stream);
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (hidden, weights, the q/k/v and ctx
// buffers and out); mask and glob (B, L) int32, biases,
// LayerNorm parameters and ln_buf (B*L, H) float32, counts (B, 2) int32.
// wqkv (H, 3 nh hd), wgq (H, nh hd), wgkv (H, 2 nh hd), wo (nh hd, H).
// Without global rows wgq, bgq, wgkv, bgkv and gkv_buf may be null.
// Returns the first CUDA error, or 0.
extern "C" int spk_sliding_block(int dtype, const void* hidden, const void* mask, const void* glob,
                                 const void* wqkv, const void* bqkv,
                                 const void* wgq, const void* bgq, const void* wgkv,
                                 const void* bgkv, const void* wo, const void* bo,
                                 const void* ln_scale, const void* ln_bias, void* counts,
                                 void* qkv_buf, void* gkv_buf, void* ctx_buf, void* ln_buf,
                                 void* out, int B, int L, int H, int nh, int hd, int C, int G,
                                 int global_rows, float sm_scale, float eps, int fuse_ln,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err;
  if (dtype == 0) {
    using F = float;
    const auto c = [](const void* p) { return static_cast<const F*>(p); };
    const auto m = [](void* p) { return static_cast<F*>(p); };
    err = spk::sliding_block<F>(c(hidden), i32(mask), i32(glob), c(wqkv), f32(bqkv),
                                c(wgq), f32(bgq), c(wgkv), f32(bgkv), c(wo), f32(bo),
                                f32(ln_scale), f32(ln_bias), static_cast<int32_t*>(counts),
                                m(qkv_buf), m(gkv_buf), m(ctx_buf), static_cast<float*>(ln_buf),
                                m(out), B, L, H, nh, hd, C, G, global_rows, sm_scale, eps,
                                fuse_ln, s);
  } else if (dtype == 1) {
    using F = __nv_bfloat16;
    const auto c = [](const void* p) { return static_cast<const F*>(p); };
    const auto m = [](void* p) { return static_cast<F*>(p); };
    err = spk::sliding_block<F>(c(hidden), i32(mask), i32(glob), c(wqkv), f32(bqkv),
                                c(wgq), f32(bgq), c(wgkv), f32(bgkv), c(wo), f32(bo),
                                f32(ln_scale), f32(ln_bias), static_cast<int32_t*>(counts),
                                m(qkv_buf), m(gkv_buf), m(ctx_buf), static_cast<float*>(ln_buf),
                                m(out), B, L, H, nh, hd, C, G, global_rows, sm_scale, eps,
                                fuse_ln, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The W8A8 mode. dtype as above for hidden, qkv_buf, gkv_buf and out; wqkv
// (3 nh hd, H), wgkv (2 nh hd, H) and wo (H, nh hd) int8, K-major (the
// tile's operands), and wgq (H, nh hd) int8 as it stands (the global query's
// own loop reads it), with per-column scales swqkv, swgq, swgkv and swo;
// biases, LayerNorm parameters and ln_buf float32; x8 (B L, max(H, nh hd))
// int8, scales (B L) and ctx_buf (B L, nh hd) float32 are scratch. Without
// global rows wgq, swgq, bgq, wgkv, swgkv, bgkv and gkv_buf may be null.
extern "C" int spk_sliding_block_w8a8(int dtype, const void* hidden, const void* mask,
                                      const void* glob, void* x8, void* scales, const void* wqkv,
                                      const void* swqkv, const void* bqkv, const void* wgq,
                                      const void* swgq, const void* bgq, const void* wgkv,
                                      const void* swgkv, const void* bgkv, const void* wo,
                                      const void* swo, const void* bo, const void* ln_scale,
                                      const void* ln_bias, void* counts, void* qkv_buf,
                                      void* gkv_buf, void* ctx_buf, void* ln_buf, void* out, int B,
                                      int L, int H, int nh, int hd, int C, int G, int global_rows,
                                      float sm_scale, float eps, int fuse_ln, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto run = [&](auto tag) {
    using F = decltype(tag);
    const auto m = [](void* p) { return static_cast<F*>(p); };
    return spk::sliding_block_w8a8<F>(
        static_cast<const F*>(hidden), i32(mask), i32(glob), static_cast<int8_t*>(x8),
        static_cast<float*>(scales), i8(wqkv), f32(swqkv), f32(bqkv), i8(wgq), f32(swgq), f32(bgq),
        i8(wgkv), f32(swgkv), f32(bgkv), i8(wo), f32(swo), f32(bo), f32(ln_scale), f32(ln_bias),
        static_cast<int32_t*>(counts), m(qkv_buf), m(gkv_buf), static_cast<float*>(ctx_buf),
        static_cast<float*>(ln_buf), m(out), B, L, H, nh, hd, C, G, global_rows, sm_scale, eps,
        fuse_ln, s);
  };
  const cudaError_t err = dtype == 0   ? run(float{})
                          : dtype == 1 ? run(__nv_bfloat16{})
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// band_rows_kernel alone, on (3, B, nh, L, hd) q (scaled), k, v in qkv and
// counts (B, 2) int32, into ctx (B, L, nh hd) and, with grad, the row
// statistics (3, B, nh, L) float32 (dctx (B, L, nh hd) read, rows below
// n_glob as zero). dtype: 0 = float32, 1 = bfloat16 (qkv, dctx and ctx);
// ctx_f32: a float32 ctx from bfloat16 q, k, v (the W8A8 blocks' mode, no
// grad). seed (1,) int32 may be null when thr is 0. Returns the first CUDA
// error, or 0.
extern "C" int spk_sliding_rows(int dtype, int ctx_f32, int grad, const void* qkv,
                                const void* counts, const void* seed, const void* dctx, void* ctx,
                                void* stats, int B, int L, int nh, int hd, int C, unsigned thr,
                                float keep_prob, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto run = [&](auto t_tag, auto c_tag, auto grad_c) {
    using T = decltype(t_tag);
    using Tc = decltype(c_tag);
    return spk::with_head_dim(hd, [&](auto hd_c) {
      return spk::launch_band_rows<T, decltype(hd_c)::value, decltype(grad_c)::value, Tc>(
          static_cast<const T*>(qkv), i32(counts), i32(seed), static_cast<const T*>(dctx),
          static_cast<Tc*>(ctx), static_cast<float*>(stats), B, L, nh, C, thr, keep_prob, s);
    });
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

// global_rows_kernel alone: x (B, L, H), wgq (H, nh hd), bgq (nh hd)
// float32, kg, vg in gkv (2, B, nh, L, hd) and counts (B, 2) int32, into
// ctx rows g < n_glob of (B, L, nh hd) and qg (B, nh, G, hd); with grad
// also the global rows' statistics gstats (3, B, nh, G) float32 and dqg
// rows g < n_glob (row stride ld), from dctx (B, L, nh hd). dtype: 0 =
// float32, 1 = bfloat16 (x, wgq, gkv, dctx, qg, dqg and ctx); ctx_f32: the
// W8A8 blocks' mode (kg, vg in the element type, a float32 ctx, no grad),
// the query from x8 (B L, H) int8 with row scales sx (B L) and wgq8 (H, nh
// hd) int8 with column scales swgq (x and wgq unused). seed (1,) int32 may be null when
// thr is 0. Returns the first CUDA error, or 0.
extern "C" int spk_sliding_global_rows(int dtype, int ctx_f32, int grad, const void* x,
                                       const void* wgq, const void* bgq, const void* gkv,
                                       const void* counts, const void* seed, const void* dctx,
                                       void* ctx, void* qg, void* gstats, void* dqg,
                                       const void* x8, const void* sx, const void* wgq8,
                                       const void* swgq, int B, int L, int H, int nh, int hd,
                                       int G, int ld, float sm_scale, unsigned thr,
                                       float keep_prob, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const spk::QuantQuery qq{static_cast<const int8_t*>(x8), static_cast<const float*>(sx),
                           static_cast<const int8_t*>(wgq8), static_cast<const float*>(swgq)};
  const auto run = [&](auto t_tag, auto c_tag, auto grad_c) {
    using T = decltype(t_tag);
    using Tc = decltype(c_tag);
    return spk::with_head_dim(hd, [&](auto hd_c) {
      return spk::launch_global_rows<T, decltype(hd_c)::value, decltype(grad_c)::value, Tc>(
          static_cast<const T*>(x), static_cast<const T*>(wgq), static_cast<const float*>(bgq),
          static_cast<const T*>(gkv), i32(counts), i32(seed), static_cast<const T*>(dctx),
          static_cast<Tc*>(ctx), static_cast<T*>(qg), static_cast<float*>(gstats),
          static_cast<T*>(dqg), B, L, H, nh, G, ld, sm_scale, thr, keep_prob, qq, s);
    });
  };
  using bf16 = __nv_bfloat16;
  using Yes = std::true_type;
  using No = std::false_type;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {  // ctx_f32: the W8A8 blocks' query on float32 activations
    if (!(ctx_f32 && grad)) err = grad ? run(float{}, float{}, Yes{}) : run(float{}, float{}, No{});
  } else if (dtype == 1 && ctx_f32) {
    if (!grad) err = run(bf16{}, float{}, No{});
  } else if (dtype == 1) {
    err = grad ? run(bf16{}, bf16{}, Yes{}) : run(bf16{}, bf16{}, No{});
  }
  return static_cast<int>(err);
}
