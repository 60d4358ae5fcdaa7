// Longformer attention (sliding window + prefix global tokens) on the H100:
// the pieces the inference block (sliding_block.cu) and the training block
// (train_sliding.cu) share.
//
// Semantics, per sequence b with n_valid real tokens (padding is a suffix)
// and n_glob global tokens (a prefix of at most G positions), window
// C = attention_window / 2, q = (x Wq + bq) * sm_scale, k, v = x Wk + bk,
// x Wv + bv, all three rounded to the element type:
//   - row r attends to band keys j with |j - r| <= C, n_glob <= j < n_valid,
//     and to the G global columns: the LOCAL k and v of positions g < G,
//     allowed where g < n_glob; one softmax (one max) over both;
//   - rows r < n_glob are then replaced by full attention through the global
//     projections: qg = (x Wgq + bgq) * sm_scale of the row, kg, vg = x Wgk
//     + bgk, x Wgv + bgv of every key j < n_valid.
// e = exp(s - m) is taken on s - m rounded to the element type and rounded
// again, the denominator sums e in float32, and with dropout at rate p a
// probability is kept iff its Philox bits are >= thr and the kept ones are
// divided by (1 - p). A row with no allowed key (only padding rows far from
// any real token) gets a zero context.
//
// Dropout draws one Philox word per probability from three counter spaces
// that never meet (the second counter word carries the head and a tag):
//   band keys        (b, h,           row, key)
//   global columns   (b, h | 1 << 16, row, g)
//   global rows      (b, h | 2 << 16, g,   key)
// so the backward pass regenerates every mask from the seed.
//
// Layouts: qkv (3, B, nh, L, hd) and gkv (2, B, nh, L, hd) in the element
// type, q pre-scaled; ctx (B, L, nh*hd) in its own type Tc (the element type,
// or float32 in W8A8, where the TPU kernel row-quantised the float32 ctx);
// counts (B, 2) int32 = (n_valid, n_glob); row statistics (3, B, nh, L)
// float32 = (m, D, rowsum(dp p_eff)). Nothing of size (L, 3C) or (L, L) is
// written to device memory: a block recomputes the scores of the tiles it
// streams.
#pragma once

#include "attention_rows_mma.cuh"
#include "attention_tiles.cuh"
#include "global_rows_mma.cuh"
#include "int8_gemm.cuh"

namespace spk {

constexpr uint32_t kGlobalColStream = 1u << 16;
constexpr uint32_t kGlobalRowStream = 2u << 16;

__device__ __forceinline__ bool keep_prob_bits(uint32_t seed, uint32_t thr, int b, uint32_t h_tag,
                                               int row, int col) {
  return thr == 0u ||
         philox_bits(seed, (uint32_t)b, h_tag, (uint32_t)row, (uint32_t)col) >= thr;
}

// the band part of the mask: a real, non-global key within C of the row
__device__ __forceinline__ bool band_allowed(int row, int key, int C, int n_glob, int n_valid) {
  const int d = key - row;
  return key >= n_glob && key < n_valid && d <= C && d >= -C;
}

// the 64-key tiles that hold the band of query rows [q0, q0 + 64): tile t
// starts at q0 - C + 64 t, t < band_tiles(C)
__host__ __device__ __forceinline__ int band_tiles(int C) { return (kTile + 2 * C + kTile - 1) / kTile; }

// whether keys [k0, k0 + 64) hold any real, non-global key
__device__ __forceinline__ bool band_tile_live(int k0, int n_glob, int n_valid) {
  return k0 + kTile > n_glob && k0 < n_valid;
}

// sum over the 256 threads of a block; `red` holds 8 floats
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

// counts[b] = (real tokens, global tokens capped at G; 0 without global
// rows). Grid (B). A template, as every kernel of this header, so that the
// two files that include it link.
template <int kUnused = 0>
__global__ void __launch_bounds__(kThreads)
    sliding_count_kernel(const int32_t* __restrict__ mask, const int32_t* __restrict__ glob,
                         int32_t* __restrict__ counts, int L, int G, int global_rows) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x;
  float nv = 0.0f, ng = 0.0f;
  for (int l = threadIdx.x; l < L; l += kThreads) {
    nv += mask[(size_t)b * L + l] > 0 ? 1.0f : 0.0f;
    ng += glob[(size_t)b * L + l] > 0 ? 1.0f : 0.0f;
  }
  nv = block_sum(nv, red);
  ng = block_sum(ng, red);
  if (threadIdx.x == 0) {
    counts[2 * b] = (int)nv;
    counts[2 * b + 1] = global_rows ? min((int)ng, G) : 0;
  }
}

// The local rows of one (64 query rows, head, sequence): pass 1 takes the
// row maxima over the band tiles and the global-column tile, pass 2 forms e,
// D = sum e and ctx = (kept e) . v / (D keep_prob), stored rounded to Tc in
// (B, L, nh*hd). With kGrad (the backward) it also forms dp = dctx . v^T,
// with the cotangent of global rows taken as zero, and writes the row
// statistics (m, D, rowsum(dp p_eff)). Grid (ceil(L / 64), nh, B), 128
// threads: attention_rows_mma.cuh's tensor-core body, bf16 or float32 on
// 3xTF32, with the same callbacks (the band tiles, then the global-column
// tile).
template <typename T, int HD, bool kGrad, typename Tc = T>
__global__ void __launch_bounds__(kGradThreads, core_min_blocks<T, HD>())
    band_rows_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ counts,
                     const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                     Tc* __restrict__ ctx, float* __restrict__ stats, int B, int L, int nh, int C,
                     uint32_t thr, float keep_prob) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)L * HD, HN = (size_t)nh * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const int n_valid = counts[2 * b], n_glob = counts[2 * b + 1];
  const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;  // null without dropout
  const int nbt = band_tiles(C);  // then the global-column tile
  rows_tile<HD, kGrad>(
      Q, Q + (size_t)B * nh * head, Q + 2 * (size_t)B * nh * head,
      kGrad ? dctx + (size_t)b * L * HN + (size_t)h * HD : nullptr, HN, n_glob, q0, L, L,
      nbt + (n_glob > 0 ? 1 : 0),
      [&](int t, KeyTile& kt) {
        const bool gcol = t == nbt;
        kt.k0 = gcol ? 0 : q0 - C + kTile * t;
        kt.k_end = gcol ? n_glob : n_valid;
        kt.tag = gcol ? kGlobalColStream : 0u;
        kt.col_off = 0;
        return gcol || band_tile_live(kt.k0, n_glob, n_valid);
      },
      [&](const KeyTile& kt, int row, int key) {
        return kt.tag ? key < n_glob : band_allowed(row, key, C, n_glob, n_valid);
      },
      [&](const KeyTile& kt, int row, int key) {
        return keep_prob_bits(seed, thr, b, h | kt.tag, row, key);
      },
      keep_prob, ctx + (size_t)b * L * HN + (size_t)h * HD, HN,
      kGrad ? stats + ((size_t)b * nh + h) * L : nullptr, (size_t)B * nh * L,
      reinterpret_cast<unsigned char*>(smem));
}

// The W8A8 global query: x8 (B L, H) int8 with row scales sx (the block's
// one row quantisation of x) and the global query weights w8 (H, nh hd) int8
// with column scales sw. Null x8: the float query from x and wgq.
struct QuantQuery {
  const int8_t* x8 = nullptr;
  const float* sx = nullptr;
  const int8_t* w8 = nullptr;
  const float* sw = nullptr;
};

// The global rows g < n_glob of (head, sequence): qg from x and the global
// query weights (in W8A8 from the int8 rows of x and int8 weights: qq),
// full attention over the real keys through kg and vg, and ctx rows g
// replaced. qg goes to qg_buf (B, nh, G, hd) where it is not null (always
// with kGrad). With kGrad it also writes the row statistics (m, D,
// rowsum(dp p_eff)) to gstats (3, B, nh, G) and d(x Wgq + bgq) = dS . kg *
// sm_scale to row g of dqg (row stride ld). 128 threads, on the tensor
// cores in both element types (global_rows_mma.cuh): bf16 grid (ceil(G /
// 16), nh, B), a block for 16 global rows of a (head, sequence); float32
// (3xTF32) the same rows on a cluster of kGlobCluster blocks, grid
// (kGlobCluster ceil(G / 16), nh, B). Blocks whose rows all lie at or
// beyond n_glob return.
template <typename T, int HD, bool kGrad, typename Tc = T>
__global__ void __launch_bounds__(kGradThreads, grad_min_blocks<T, HD>())
    global_rows_kernel(const T* __restrict__ x, const T* __restrict__ wgq,
                       const float* __restrict__ bgq, const T* __restrict__ gkv,
                       const int32_t* __restrict__ counts, const int32_t* __restrict__ seed_ptr,
                       const T* __restrict__ dctx, Tc* __restrict__ ctx, T* __restrict__ qg_buf,
                       float* __restrict__ gstats, T* __restrict__ dqg, int B, int L, int H,
                       int nh, int G, int ld, float sm_scale, uint32_t thr, float keep_prob,
                       QuantQuery qq) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;  // null without dropout
  const uint32_t tag = blockIdx.y | kGlobalRowStream;
  const auto keep = [&](int row, int key) { return keep_prob_bits(seed, thr, b, tag, row, key); };
  unsigned char* s = reinterpret_cast<unsigned char*>(smem);
  if constexpr (std::is_same<T, float>::value) {
    static_assert(std::is_same<Tc, float>::value, "the float32 body stores a float32 ctx");
    global_rows_tile_tf32<HD, kGrad>(x, wgq, bgq, gkv, counts, thr != 0u, keep, dctx, ctx,
                                     qg_buf, gstats, dqg, B, L, H, nh, G, ld, sm_scale, keep_prob,
                                     qq.x8, qq.sx, qq.w8, qq.sw, s);
  } else {
    global_rows_tile_mma<HD, kGrad, Tc>(x, wgq, bgq, gkv, counts, thr != 0u, keep, dctx, ctx,
                                        qg_buf, gstats, dqg, B, L, H, nh, G, ld, sm_scale,
                                        keep_prob, qq.x8, qq.sx, qq.w8, qq.sw, s);
  }
}

// global_rows_kernel over the (2, B, nh, L, hd) kg, vg in gkv: float32 in
// clusters of (kGlobCluster, 1, 1) blocks
template <typename T, int HD, bool kGrad, typename Tc>
cudaError_t launch_global_rows(const T* x, const T* wgq, const float* bgq, const T* gkv,
                               const int32_t* counts, const int32_t* seed, const T* dctx, Tc* ctx,
                               T* qg_buf, float* gstats, T* dqg, int B, int L, int H, int nh,
                               int G, int ld, float sm_scale, uint32_t thr, float keep_prob,
                               const QuantQuery& qq, cudaStream_t stream) {
  auto rows = global_rows_kernel<T, HD, kGrad, Tc>;
  const int tiles = (G + kGlobRows - 1) / kGlobRows;
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = global_rows_smem_tf32<HD, kGrad>();
    cudaError_t e = prepare(rows, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = kGlobCluster;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles * kGlobCluster, nh, B);
    cfg.blockDim = dim3(kGradThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, rows, x, wgq, bgq, gkv, counts, seed, dctx, ctx, qg_buf, gstats,
                           dqg, B, L, H, nh, G, ld, sm_scale, thr, keep_prob, qq);
    return e != cudaSuccess ? e : cudaGetLastError();
  } else {
    constexpr size_t smem = global_rows_smem_mma<HD, kGrad>();
    const cudaError_t e = prepare(rows, smem);
    if (e != cudaSuccess) return e;
    rows<<<dim3(tiles, nh, B), kGradThreads, smem, stream>>>(x, wgq, bgq, gkv, counts, seed, dctx,
                                                             ctx, qg_buf, gstats, dqg, B, L, H,
                                                             nh, G, ld, sm_scale, thr, keep_prob,
                                                             qq);
    return cudaGetLastError();
  }
}

// counts, q, k, v and (with global rows) kg, vg. wqkv (H, 3 nh hd) and
// wgkv (H, 2 nh hd) in the element type, biases float32.
template <typename T>
cudaError_t sliding_projections(const T* hidden, const int32_t* mask, const int32_t* glob,
                                const T* wqkv, const float* bqkv, const T* wgkv,
                                const float* bgkv, int32_t* counts, T* qkv_buf, T* gkv_buf, int B,
                                int L, int H, int nh, int hd, int G, int global_rows,
                                float sm_scale, cudaStream_t stream) {
  sliding_count_kernel<><<<B, kThreads, 0, stream>>>(mask, glob, counts, L, G, global_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_qkv_proj<T>(hidden, wqkv, bqkv, qkv_buf, B, L, H, nh, hd, sm_scale, stream);
  if (err != cudaSuccess || !global_rows) return err;
  return launch_qkv_proj<T>(hidden, wgkv, bgkv, gkv_buf, B, L, H, nh, hd, 1.0f, stream, 2);
}

// The W8A8 twin of sliding_projections: counts, one row quantisation of x
// into x8 (B L, H) and sx (B L), then q, k, v and (with global rows) kg, vg
// from int8 weights wqkv (3 nh hd, H) and wgkv (2 nh hd, H), K-major, with
// per-column scales.
template <typename T>
cudaError_t sliding_projections_w8a8(const T* hidden, const int32_t* mask, const int32_t* glob,
                                     int8_t* x8, float* sx, const int8_t* wqkv,
                                     const float* swqkv, const float* bqkv, const int8_t* wgkv,
                                     const float* swgkv, const float* bgkv, int32_t* counts,
                                     T* qkv_buf, T* gkv_buf, int B, int L, int H, int nh, int hd,
                                     int G, int global_rows, float sm_scale,
                                     cudaStream_t stream) {
  sliding_count_kernel<><<<B, kThreads, 0, stream>>>(mask, glob, counts, L, G, global_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = launch_rowquant<T>(hidden, B * L, H, 1, x8, sx, stream)) != cudaSuccess) return err;
  err = launch_qkv_proj_i8<T>(x8, sx, wqkv, swqkv, bqkv, qkv_buf, B, L, H, nh, hd, sm_scale,
                              stream);
  if (err != cudaSuccess || !global_rows) return err;
  return launch_qkv_proj_i8<T>(x8, sx, wgkv, swgkv, bgkv, gkv_buf, B, L, H, nh, hd, 1.0f, stream,
                               2);
}

// band_rows_kernel over (3, B, nh, L, hd) q, k, v
template <typename T, int HD, bool kGrad, typename Tc>
cudaError_t launch_band_rows(const T* qkv_buf, const int32_t* counts, const int32_t* seed,
                             const T* dctx, Tc* ctx_buf, float* stats, int B, int L, int nh,
                             int C, uint32_t thr, float keep_prob, cudaStream_t stream) {
  auto band = band_rows_kernel<T, HD, kGrad, Tc>;
  constexpr size_t smem = rows_tiles_bytes<T, HD, kGrad>();
  const cudaError_t e = prepare(band, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((L + kTile - 1) / kTile, nh, B);
  band<<<grid, kGradThreads, smem, stream>>>(qkv_buf, counts, seed, dctx, ctx_buf, stats, B, L, nh,
                                             C, thr, keep_prob);
  return cudaGetLastError();
}

// The attention of the projected q, k, v into ctx (of type Tc): the band
// rows, then the global rows over them (their query from qq in W8A8). With
// kGrad, the backward's recomputation: also the row statistics, qg, the
// global rows' statistics and their dqg.
template <typename T, bool kGrad, typename Tc = T>
cudaError_t sliding_attention(const T* hidden, const int32_t* seed, const T* wgq, const float* bgq,
                              const int32_t* counts, const T* qkv_buf, const T* gkv_buf,
                              const T* dctx, Tc* ctx_buf, float* stats, T* qg_buf, float* gstats,
                              T* dqg, int B, int L, int H, int nh, int hd, int C, int G,
                              int global_rows, int ld, float sm_scale, uint32_t thr,
                              float keep_prob, cudaStream_t stream,
                              const QuantQuery& qq = QuantQuery{}) {
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    cudaError_t e = launch_band_rows<T, HD, kGrad, Tc>(qkv_buf, counts, seed, dctx, ctx_buf,
                                                          stats, B, L, nh, C, thr, keep_prob,
                                                          stream);
    if (e != cudaSuccess || !global_rows) return e;
    return launch_global_rows<T, HD, kGrad, Tc>(hidden, wgq, bgq, gkv_buf, counts, seed, dctx,
                                                 ctx_buf, qg_buf, gstats, dqg, B, L, H, nh, G, ld,
                                                 sm_scale, thr, keep_prob, qq, stream);
  });
}

}  // namespace spk
