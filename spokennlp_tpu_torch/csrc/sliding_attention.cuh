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

// sum and max over the 256 threads of a block; `red` holds 8 floats
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

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t = fmaxf(t, red[w]);
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

template <int HD>
size_t global_rows_smem_bytes(int L) {
  return sizeof(float) * (2 * (size_t)L + 2 * HD + kThreads + kThreads / 32);
}

// The global rows g < n_glob of (head, sequence): qg from x and the global
// query weights (in W8A8 from the int8 rows of x and int8 weights: qq),
// full attention over the real keys through kg and vg, and ctx rows g
// replaced. qg (rounded) goes to qg_buf (B, nh, G, hd) where it is not
// null (always with kGrad). With kGrad it also writes the row statistics
// (m, D, rowsum(dp p_eff)) to gstats (3, B, nh, G) and d(x Wgq + bgq) = dS
// . kg * sm_scale, rounded, to row g of dqg (row stride ld). bf16 runs
// global_rows_mma.cuh's tensor-core body: grid (ceil(G / 16), nh, B) of
// 128 threads, a block for 16 global rows. float32 runs the CUDA-core body
// below: grid (G, nh, B) of 256 threads, a block for one row. Blocks whose
// rows all lie at or beyond n_glob return.
template <typename T, int HD, bool kGrad, typename Tc = T>
__global__ void __launch_bounds__(grad_threads<T>(), grad_min_blocks<T, HD>())
    global_rows_kernel(const T* __restrict__ x, const T* __restrict__ wgq,
                       const float* __restrict__ bgq, const T* __restrict__ gkv,
                       const int32_t* __restrict__ counts, const int32_t* __restrict__ seed_ptr,
                       const T* __restrict__ dctx, Tc* __restrict__ ctx, T* __restrict__ qg_buf,
                       float* __restrict__ gstats, T* __restrict__ dqg, int B, int L, int H,
                       int nh, int G, int ld, float sm_scale, uint32_t thr, float keep_prob,
                       QuantQuery qq) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!std::is_same<T, float>::value) {
    const int b = blockIdx.z;
    const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;  // null without dropout
    const uint32_t tag = blockIdx.y | kGlobalRowStream;
    global_rows_tile_mma<HD, kGrad, Tc>(
        x, wgq, bgq, gkv, counts, thr != 0u,
        [&](int row, int key) { return keep_prob_bits(seed, thr, b, tag, row, key); }, dctx, ctx,
        qg_buf, gstats, dqg, B, L, H, nh, G, ld, sm_scale, keep_prob, qq.x8, qq.sx, qq.w8, qq.sw,
        reinterpret_cast<unsigned char*>(smem));
    return;
  } else {
  constexpr int P = kThreads / HD;  // threads that share a head-dim column
  float* ebuf = smem;          // scores, then e
  float* dpbuf = ebuf + L;     // dp, then dS
  float* qs = dpbuf + L;       // qg
  float* dcs = qs + HD;        // the row's cotangent
  float* part = dcs + HD;      // (P, HD) partial sums
  float* red = part + kThreads;

  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_valid = counts[2 * b], n_glob = counts[2 * b + 1];
  if (g >= n_glob) return;
  const int tid = threadIdx.x, d = tid % HD, p = tid / HD;
  const int HN = nh * HD;
  const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;  // null without dropout
  const T* KG = gkv + (((size_t)0 * B + b) * nh + h) * (size_t)L * HD;
  const T* VG = gkv + (((size_t)1 * B + b) * nh + h) * (size_t)L * HD;
  const size_t grow = (size_t)b * L + g;

  // qg = round((x_g Wgq + bgq) * sm_scale); in W8A8 the int32 product of
  // the quantised row and weights, dequantised as the projections are
  if (qq.x8 != nullptr) {
    int acc = 0;
    for (int k = p; k < H; k += P)
      acc += (int)qq.x8[grow * H + k] * (int)qq.w8[(size_t)k * HN + h * HD + d];
    part[tid] = __int_as_float(acc);
  } else {
    float acc = 0.0f;
    for (int k = p; k < H; k += P) acc = fmaf(to_f32(x[grow * H + k]), to_f32(wgq[(size_t)k * HN + h * HD + d]), acc);
    part[tid] = acc;
  }
  __syncthreads();
  if (tid < HD) {
    float sum = 0.0f;
    if (qq.x8 != nullptr) {
      int isum = 0;
      for (int i = 0; i < P; ++i) isum += __float_as_int(part[i * HD + tid]);
      sum = dequant(isum, qq.sx[grow], qq.sw[h * HD + tid]);
    } else {
      for (int i = 0; i < P; ++i) sum += part[i * HD + tid];
    }
    const float q = round_to<T>(__fmul_rn(__fadd_rn(sum, bgq[h * HD + tid]), sm_scale));
    qs[tid] = q;
    if (qg_buf != nullptr) qg_buf[(((size_t)b * nh + h) * G + g) * HD + tid] = from_f32<T>(q);
    if constexpr (kGrad) dcs[tid] = to_f32(dctx[grow * HN + h * HD + tid]);
  }
  __syncthreads();

  // scores (and dp) over the real keys, their maximum
  float mx = -CUDART_INF_F;
  for (int key = tid; key < n_valid; key += kThreads) {
    const T* kr = KG + (size_t)key * HD;
    float s = 0.0f;
#pragma unroll 8
    for (int i = 0; i < HD; ++i) s = fmaf(qs[i], to_f32(kr[i]), s);
    ebuf[key] = s;
    mx = fmaxf(mx, s);
    if constexpr (kGrad) {
      const T* vr = VG + (size_t)key * HD;
      float dp = 0.0f;
#pragma unroll 8
      for (int i = 0; i < HD; ++i) dp = fmaf(dcs[i], to_f32(vr[i]), dp);
      dpbuf[key] = dp;
    }
  }
  const float m = block_max(mx, red);
  float dsum = 0.0f;
  for (int key = tid; key < n_valid; key += kThreads) {
    const float e = rounded_exp<T>(ebuf[key], m);
    ebuf[key] = e;
    dsum += e;
  }
  const float D = block_sum(dsum, red);  // ends in __syncthreads: ebuf is complete
  const float denom = D * keep_prob;

  // ctx_g = (kept e) . vg / denom; with kGrad also rowsum(dp p_eff)
  float o = 0.0f, rs = 0.0f;
  for (int key = p; key < n_valid; key += P) {
    const bool keep = keep_prob_bits(seed, thr, b, h | kGlobalRowStream, g, key);
    const float pe = keep ? ebuf[key] : 0.0f;
    o = fmaf(pe, to_f32(VG[(size_t)key * HD + d]), o);
    if (kGrad && d == 0) rs = fmaf(pe, dpbuf[key], rs);
  }
  __syncthreads();
  part[tid] = o;
  __syncthreads();
  if (tid < HD) {
    float sum = 0.0f;
    for (int i = 0; i < P; ++i) sum += part[i * HD + tid];
    ctx[grow * HN + h * HD + tid] = from_f32<Tc>(D > 0.0f ? sum / denom : 0.0f);
  }
  if constexpr (kGrad) {
    const float rs_sum = block_sum(rs, red);
    const float rsn = D > 0.0f ? rs_sum / denom : 0.0f;
    // dS = round(p_eff dp - p rs) into dpbuf
    for (int key = tid; key < n_valid; key += kThreads) {
      const bool keep = keep_prob_bits(seed, thr, b, h | kGlobalRowStream, g, key);
      const float e = ebuf[key];
      const float pe = keep ? e / denom : 0.0f;  // D > 0 wherever a key is real
      dpbuf[key] = round_to<T>(pe * dpbuf[key] - (e / D) * rsn);
    }
    __syncthreads();
    float dq = 0.0f;
    for (int key = p; key < n_valid; key += P)
      dq = fmaf(dpbuf[key], to_f32(KG[(size_t)key * HD + d]), dq);
    part[tid] = dq;
    __syncthreads();
    if (tid < HD) {
      float sum = 0.0f;
      for (int i = 0; i < P; ++i) sum += part[i * HD + tid];
      dqg[grow * ld + h * HD + tid] = from_f32<T>(sum * sm_scale);
    }
    if (tid == 0) {
      const size_t r = ((size_t)b * nh + h) * G + g, plane = (size_t)B * nh * G;
      gstats[r] = m;
      gstats[plane + r] = D;
      gstats[2 * plane + r] = rsn;
    }
  }
  }
}

// global_rows_kernel over the (2, B, nh, L, hd) kg, vg in gkv
template <typename T, int HD, bool kGrad, typename Tc>
cudaError_t launch_global_rows(const T* x, const T* wgq, const float* bgq, const T* gkv,
                               const int32_t* counts, const int32_t* seed, const T* dctx, Tc* ctx,
                               T* qg_buf, float* gstats, T* dqg, int B, int L, int H, int nh,
                               int G, int ld, float sm_scale, uint32_t thr, float keep_prob,
                               const QuantQuery& qq, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  auto rows = global_rows_kernel<T, HD, kGrad, Tc>;
  const size_t smem = kF32 ? global_rows_smem_bytes<HD>(L) : global_rows_smem_mma<HD, kGrad>();
  const cudaError_t e = prepare(rows, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(kF32 ? G : (G + kGlobRows - 1) / kGlobRows, nh, B);
  rows<<<grid, grad_threads<T>(), smem, stream>>>(x, wgq, bgq, gkv, counts, seed, dctx, ctx,
                                                   qg_buf, gstats, dqg, B, L, H, nh, G, ld,
                                                   sm_scale, thr, keep_prob, qq);
  return cudaGetLastError();
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
