// Training attention block for the H100 (sm_90a), forward and backward:
//   out = (dropout(softmax(q k^T * sm_scale + mask)) v) Wo + bo
// with q, k, v = x Wq + bq, x Wk + bk, x Wv + bv rounded to the element
// type, the additive segment-id mask of attention_block.cu (0 = padding,
// equal ids attend; -1e9 on masked keys) and dropout on the probabilities.
// Residual, LayerNorm and hidden-state dropout stay in PyTorch.
//
// Replaces the TPU kernels of spokennlp_tpu/ops/pallas/train_blocks.py,
// attention_block_train: _attn_train_fwd_kernel and _attn_train_bwd_kernel
// (the custom VJP of make_attention_train).
//
// Numerics follow the TPU kernel: q, k, v rounded to the element type;
// scores in float32; e = exp(s - m) taken on s - m rounded to the element
// type and rounded again (the TPU takes the exp in the compute dtype), with m
// the row's maximum over ALL keys, so each block makes one pass for m and a
// second for the rest; the denominator D = sum e in float32, times
// keep_prob; ctx = (dropped e) . v / (D keep_prob), rounded. The backward
// uses dS = (p_eff dp - p rowsum(dp p_eff)) sm_scale with p = e / D and
// p_eff = keep e / (D keep_prob), rounds dq, dk and dv to the element type
// before dx and the weight gradients, and returns the weight and bias
// gradients in float32, summed over the batch.
//
// Dropout. keep iff philox_bits(seed, sequence, head, row, col) >= thr
// (common.cuh), so the backward regenerates the forward's mask from the same
// counters and nothing but the inputs and the seed is saved between the two
// passes, as on the TPU. spk_dropout_mask writes the same mask for the
// plain version to replay.
//
// What bounds it here. At BERT-base (B=32, L=512, H=768, 12 heads of 64) the
// forward is about 103 GFLOP and the backward, which recomputes the forward,
// about three times that, against some 25 MB (forward) and 50 MB (backward)
// of inputs, weights and outputs in bf16: bound by arithmetic. In bf16 every
// product runs on the tensor cores: the projections on bf16_gemm.cuh's tile,
// forward and backward (dctx and dx with a weight read transposed, the two
// weight gradients); attn_rows on attention_rows_mma.cuh's body (S, dP and
// P V on mma.sync, over every key tile of the sequence, the score scaled
// and masked with the TPU kernel's -1e9, the rounded exponent and the Philox
// draw on the fragments); attn_dkv and attn_dq on attention_grad_mma.cuh's
// (S^T, dP^T, dk, dv on mma.sync, the softmax gradient on the fragments,
// each dS stored once in bf16 for the dq pass, which only multiplies). What
// stays on the CUDA cores is the work on each of the B nh L^2 (row, key)
// pairs: the mask, the exponent and its roundings, a Philox-4x32-10 draw.
// float32 runs the three cores' SIMT bodies (256 threads, float32 copies of
// the tiles, attention_tiles.cuh), unchanged.
// In float32 every product, forward and backward, runs tf32x3_gemm.cuh's
// 3xTF32 tensor-core tile through the same launchers; the projections the
// backward recomputes take the forward's kernel and tile, so it
// differentiates the forward's own values.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// ran one grid step per sequence, kept q, k, v and the (L, L) probabilities
// of one head in VMEM, and summed the weight gradients over the sequential
// batch grid in its output buffers. Hopper blocks run in parallel and carry
// nothing from one to the next, so the work is split:
//   forward  1. qkv_proj_kernel (bf16_gemm.cuh), unscaled q, to (3, B, nh, L, hd);
//            2. attn_rows_kernel: one block per (64 query rows, head,
//               sequence), two passes over 64-key tiles (the row's true
//               maximum first), writes ctx (B, L, Hn);
//            3. ctx . Wo + bo (gemm_bias_act_kernel, bf16_gemm.cuh).
//   backward 1. q, k, v recomputed; dctx = g . Wo^T rounded;
//            2. attn_rows_kernel again, now also writing the row statistics
//               m, D and rowsum(dp p_eff) per query row, and ctx for dWo;
//            3. attn_dkv_kernel: per (KEY tile, head, sequence), dk and dv
//               summed over all query tiles it streams. Each block owns its
//               keys' rows of dk and dv, so the sum over query tiles is a
//               loop inside one block: no atomics, no partial buffers, and
//               the same order on every run. In bf16 it also stores every
//               dS tile (dense_ds_tile: B nh (L / 64)^2 tiles, 201 MB at
//               B=32, L=512, from the wrapper's allocator);
//            4. attn_dq_kernel: per (query tile, head, sequence), dq summed
//               over the key tiles it streams (in bf16 over those dS
//               tiles; in float32 it forms dS again);
//            5. dx = [dq dk dv] . Wqkv^T in one GEMM;
//            6. dWqkv = x^T [dq dk dv] and dWo = ctx^T g in
//               launch_weight_grad (bf16_gemm.cuh): each block owns a tile
//               of the weight gradient and a fixed range of the B*L rows,
//               whose partial sums are added in order after it, so the
//               batch sum is deterministic too; the bias gradients come from
//               the same pass.
// The probabilities are recomputed in the backward instead of being stored
// (twice in bf16: rows, dkv; three times in float32): only bf16's dS tiles
// touch device memory.
#include "attention_rows_mma.cuh"
#include "bf16_gemm.cuh"

namespace spk {
namespace {

// the masked, scaled score of one (query, key) pair, as the TPU kernel
// forms it: dot * sm_scale + (allowed ? 0 : -1e9)
__device__ __forceinline__ float masked_score(float dot, float sm_scale, int seg_q, int seg_k) {
  return dot * sm_scale + ((seg_q == seg_k && seg_k > 0) ? 0.0f : kNegInf);
}

// the segment ids of a sequence's key tiles (64 a tile, 0 past L), staged
// beside the bf16 rows kernel's tiles
__host__ __device__ constexpr size_t seg_ids_bytes(int L) {
  return sizeof(int) * (size_t)((L + kTile - 1) / kTile) * kTile;
}

// shared memory of the rows kernel: in float32 four (64, HD) float tiles, a
// (64, 64) score tile and the key tile's segment ids; in bf16
// attention_rows_mma.cuh's staged tiles and the sequence's segment ids
template <typename T, int HD, bool kGrad>
size_t rows_smem_bytes(int L) {
  if constexpr (std::is_same<T, float>::value) {
    return sizeof(float) * (4 * (size_t)Geometry<HD>::kTileFloats + (size_t)kTile * kPS) +
           sizeof(int) * kTile;
  } else {
    return rows_smem_mma<HD, kGrad>() + seg_ids_bytes(L);
  }
}

// Rows of one (query tile, head, sequence): m = max over all keys, then
// D = sum e, ctx = (keep e) . v / (D keep_prob), stored rounded to (B, L, Hn).
// With kGrad it also forms dp = dctx . v^T and writes the row statistics
// (m, D, rowsum(dp p_eff)) to stats (3, B, nh, L) for the dq and dk/dv
// kernels. Grid (ceil(L / 64), nh, B). bf16 runs attention_rows_mma.cuh's
// tensor-core body (128 threads) over every key tile of the sequence, each
// score scaled and masked as masked_score does; float32 the CUDA-core body
// below (256 threads).
template <typename T, int HD, bool kGrad>
__global__ void __launch_bounds__(grad_threads<T>(), grad_min_blocks<T, HD>())
    attn_rows_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ seg,
                     const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                     T* __restrict__ ctx, float* __restrict__ stats, int B, int L, int nh,
                     float sm_scale, uint32_t thr, float keep_prob) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!std::is_same<T, float>::value) {
    const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
    const size_t head = (size_t)L * HD, HN = (size_t)nh * HD;
    const T* Q = qkv + ((size_t)b * nh + h) * head;
    const int32_t* seg_b = seg + (size_t)b * L;
    const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;
    const int nt = (L + kTile - 1) / kTile;
    int* seg_s = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem) +
                                        rows_smem_mma<HD, kGrad>());
    for (int i = threadIdx.x; i < nt * kTile; i += kGradThreads) seg_s[i] = i < L ? seg_b[i] : 0;
    // (the body's first barrier comes before its first read of seg_s)
    rows_tile_mma<HD, kGrad>(
        Q, Q + (size_t)B * nh * head, Q + 2 * (size_t)B * nh * head,
        kGrad ? dctx + (size_t)b * L * HN + (size_t)h * HD : nullptr, HN, 0, q0, L, L, nt,
        [&](int i, KeyTile& kt) {
          kt.k0 = kTile * i;
          kt.k_end = L;
          kt.tag = 0u;
          kt.col_off = 0;
          return true;
        },
        [&](const KeyTile&, int, int key) { return key < L; },
        [&](const KeyTile&, int row, int key) {
          return thr == 0u || dropout_keep(seed, thr, b, h, row, key);
        },
        keep_prob, ctx + (size_t)b * L * HN + (size_t)h * HD, HN,
        kGrad ? stats + ((size_t)b * nh + h) * L : nullptr, (size_t)B * nh * L,
        reinterpret_cast<unsigned char*>(smem), [&](const KeyTile&, int row, int key, float x) {
          return masked_score(x, sm_scale, seg_s[row], seg_s[key]);
        });
    return;
  } else {
  using G = Geometry<HD>;
  float* Qs = smem;
  float* Ks = Qs + G::kTileFloats;
  float* Vs = Ks + G::kTileFloats;
  float* dCs = Vs + G::kTileFloats;
  float* Ps = dCs + G::kTileFloats;
  int* seg_k = reinterpret_cast<int*>(Ps + kTile * kPS);

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t head = (size_t)L * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const T* K = qkv + (((size_t)1 * B + b) * nh + h) * head;
  const T* V = qkv + (((size_t)2 * B + b) * nh + h) * head;
  const int32_t* seg_b = seg + (size_t)b * L;
  const uint32_t seed = (uint32_t)seed_ptr[0];

  load_head_tile<T, HD>(Qs, Q, q0, L);
  if constexpr (kGrad) load_row_tile<T, HD>(dCs, dctx, b, h, q0, L, nh);
  int seg_q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = q0 + ty + 16 * i;
    seg_q[i] = l < L ? seg_b[l] : 0;
  }

  // pass 1: the row maxima over every key of the sequence
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -CUDART_INF_F;
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    load_head_tile<T, HD>(Ks, K, k0, L);
    if (threadIdx.x < kTile) seg_k[threadIdx.x] = k0 + threadIdx.x < L ? seg_b[k0 + threadIdx.x] : 0;
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (k0 + c < L) m[i] = fmaxf(m[i], masked_score(s[i][j], sm_scale, seg_q[i], seg_k[c]));
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = half_warp_max(m[i]);

  // pass 2: e, the denominator, (keep e) . v and, with kGrad, rowsum(dp keep e)
  float D[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float o[4][G::TD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < G::TD; ++j) o[i][j] = 0.0f;
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    load_head_tile<T, HD>(Ks, K, k0, L);
    load_head_tile<T, HD>(Vs, V, k0, L);
    if (threadIdx.x < kTile) seg_k[threadIdx.x] = k0 + threadIdx.x < L ? seg_b[k0 + threadIdx.x] : 0;
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(Qs, Ks, s);
    if constexpr (kGrad) tile_dot<HD>(dCs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        float e = 0.0f;
        if (key < L) e = rounded_exp<T>(masked_score(s[i][j], sm_scale, seg_q[i], seg_k[c]), m[i]);
        D[i] += e;
        const float pe = (thr == 0u || dropout_keep(seed, thr, b, h, row, key)) ? e : 0.0f;
        if constexpr (kGrad) rs[i] = fmaf(pe, dp[i][j], rs[i]);
        Ps[(ty + 16 * i) * kPS + c] = pe;
      }
    }
    __syncthreads();
    tile_accumulate<HD>(Ps, Vs, o);
  }

  const size_t row_stride = (size_t)nh * HD;
  const size_t plane = (size_t)B * nh * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d_sum = half_warp_sum(D[i]);
    const float rs_sum = kGrad ? half_warp_sum(rs[i]) : 0.0f;
    const int l = q0 + ty + 16 * i;
    if (l >= L) continue;
    const float denom = d_sum * keep_prob;
    T* out = ctx + ((size_t)b * L + l) * row_stride + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < G::TD; ++j) out[tx + 16 * j] = from_f32<T>(o[i][j] / denom);
    if (kGrad && tx == 0) {
      const size_t r = ((size_t)b * nh + h) * L + l;
      stats[r] = m[i];
      stats[plane + r] = d_sum;
      stats[2 * plane + r] = rs_sum / denom;
    }
  }
  }
}

// dS of one (query, key) pair, rounded to T, and p_eff: the softmax-with-
// dropout backward of the TPU kernel, dS = (p_eff dp - p rs) sm_scale
template <typename T>
__device__ __forceinline__ void score_grad(float s, float dp, float m, float d_sum, float rs,
                                           bool keep, float sm_scale, float keep_prob,
                                           float& ds, float& p_eff) {
  const float e = rounded_exp<T>(s, m);
  const float p = e / d_sum;
  p_eff = keep ? e / (d_sum * keep_prob) : 0.0f;
  ds = round_to<T>((p_eff * dp - p * rs) * sm_scale);
}

// The first element of the stored dS tile of (query tile qt, key tile kt)
// of (b, h) = bh, with nt tiles a sequence: (64 keys, 64 query rows), keys
// major, as attention_grad_mma.cuh's dq pass reads it
__host__ __device__ __forceinline__ size_t dense_ds_tile(int bh, int qt, int kt, int nt) {
  return (((size_t)bh * nt + qt) * nt + kt) * (size_t)kDsTile;
}

template <typename T, int HD>
constexpr size_t dq_smem_bytes() {
  if constexpr (std::is_same<T, float>::value) {
    return sizeof(float) * (4 * (size_t)Geometry<HD>::kTileFloats + (size_t)kTile * kPS) +
           sizeof(int) * kTile;
  } else {
    return grad_dq_smem_mma<HD>();
  }
}

// dq of one (query tile, head, sequence): sum over key tiles of dS . k,
// stored rounded into the (B*L, 3, nh, hd) gradient at slot 0.
// Grid (ceil(L / 64), nh, B). float32 on the CUDA cores (256 threads)
// forms dS itself; bf16 on the tensor cores (128 threads,
// attention_grad_mma.cuh) reads the dS tiles attn_dkv_kernel stored in
// ds_in (dense_ds_tile).
template <typename T, int HD>
__global__ void __launch_bounds__(grad_threads<T>(), grad_min_blocks<T, HD>())
    attn_dq_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ seg,
                   const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                   const float* __restrict__ stats, const T* __restrict__ ds_in,
                   T* __restrict__ dqkv, int B, int L, int nh, float sm_scale, uint32_t thr,
                   float keep_prob) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!std::is_same<T, float>::value) {
    using Mm = GradMma<HD>;
    unsigned char* ring = reinterpret_cast<unsigned char*>(smem);  // stage s: k, then dS
    const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
    const T* K = qkv + (((size_t)1 * B + b) * nh + h) * (size_t)L * HD;
    const int nt = (L + kTile - 1) / kTile;
    const T* tiles = ds_in + dense_ds_tile(b * nh + h, blockIdx.x, 0, nt);
    const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
    const bool live = q0 + 16 * warp < L;  // warp-uniform
    float dq[HD / 8][4];
    zero_acc<HD>(dq);
    const GradLane<HD> lane;
    const auto stage_of = [&](int st) { return ring + st * grad_dq_stage_bytes<HD>(); };
    grad_ring(
        nt, [](int t) { return t; },
        [&](int st, int t) {
          stage_grad_rows<HD>(K, HD, kTile * t, 0, L, stage_of(st));
          stage_ds_tile(tiles + (size_t)t * kDsTile, stage_of(st) + Mm::kTileBytes);
        },
        [&](int st, int) {
          if (live)
            dq_from_ds_tile<HD>(smem_addr(stage_of(st) + Mm::kTileBytes), smem_addr(stage_of(st)),
                                lane, dq);
        });
    if (!live) return;
    const size_t row_stride = (size_t)3 * nh * HD;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int l = hi ? r_hi : r_lo;
      if (l < L)
        store_acc_row<HD>(dq, hi, dqkv + ((size_t)b * L + l) * row_stride + (size_t)h * HD,
                          [](float v) { return v; });
    }
    return;
  } else {
  using G = Geometry<HD>;
  float* Qs = smem;
  float* Ks = Qs + G::kTileFloats;
  float* Vs = Ks + G::kTileFloats;
  float* dCs = Vs + G::kTileFloats;
  float* Ps = dCs + G::kTileFloats;
  int* seg_k = reinterpret_cast<int*>(Ps + kTile * kPS);

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t head = (size_t)L * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const T* K = qkv + (((size_t)1 * B + b) * nh + h) * head;
  const T* V = qkv + (((size_t)2 * B + b) * nh + h) * head;
  const int32_t* seg_b = seg + (size_t)b * L;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const size_t plane = (size_t)B * nh * L;

  load_head_tile<T, HD>(Qs, Q, q0, L);
  load_row_tile<T, HD>(dCs, dctx, b, h, q0, L, nh);
  int seg_q[4];
  float m[4], d_sum[4], rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = q0 + ty + 16 * i;
    const size_t r = ((size_t)b * nh + h) * L + (l < L ? l : 0);
    seg_q[i] = l < L ? seg_b[l] : 0;
    m[i] = stats[r];
    d_sum[i] = stats[plane + r];
    rs[i] = stats[2 * plane + r];
  }
  float dq[4][G::TD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < G::TD; ++j) dq[i][j] = 0.0f;

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    load_head_tile<T, HD>(Ks, K, k0, L);
    load_head_tile<T, HD>(Vs, V, k0, L);
    if (threadIdx.x < kTile) seg_k[threadIdx.x] = k0 + threadIdx.x < L ? seg_b[k0 + threadIdx.x] : 0;
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(Qs, Ks, s);
    tile_dot<HD>(dCs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        float ds = 0.0f, p_eff = 0.0f;
        if (key < L && row < L) {
          const bool keep = thr == 0u || dropout_keep(seed, thr, b, h, row, key);
          score_grad<T>(masked_score(s[i][j], sm_scale, seg_q[i], seg_k[c]), dp[i][j], m[i],
                        d_sum[i], rs[i], keep, sm_scale, keep_prob, ds, p_eff);
        }
        Ps[(ty + 16 * i) * kPS + c] = ds;
      }
    }
    __syncthreads();
    tile_accumulate<HD>(Ps, Ks, dq);
  }

  const size_t row_stride = (size_t)3 * nh * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = q0 + ty + 16 * i;
    if (l >= L) continue;
    T* out = dqkv + ((size_t)b * L + l) * row_stride + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < G::TD; ++j) out[tx + 16 * j] = from_f32<T>(dq[i][j]);
  }
  }
}

// a ring stage of the bf16 dk/dv pass: q's tile, dctx's, then the 64 rows'
// m, D, rowsum(dp p_eff) and segment ids
template <int HD>
__host__ __device__ constexpr size_t dense_dkv_stage_bytes() {
  return 2 * (size_t)GradMma<HD>::kTileBytes + 4 * kTile * sizeof(float);
}

template <typename T, int HD>
constexpr size_t dkv_smem_bytes() {
  if constexpr (std::is_same<T, float>::value) {
    return sizeof(float) * (4 * (size_t)Geometry<HD>::kTileFloats + 2 * (size_t)kTile * kPS +
                            3 * (size_t)kTile) +
           sizeof(int) * kTile;
  } else {
    return 2 * (size_t)GradMma<HD>::kTileBytes + 2 * dense_dkv_stage_bytes<HD>();
  }
}

// dk and dv of one (KEY tile, head, sequence): sums over every query tile of
// dS^T . q and round(p_eff)^T . dctx, stored rounded into the (B*L, 3, nh,
// hd) gradient at slots 1 and 2. Grid (ceil(L / 64), nh, B). In float32
// (256 threads) thread (ty, tx) owns keys ty + 16 i and, in the score
// tiles, queries tx + 16 j; in bf16 (128 threads) warp w owns keys 16 w ..
// 16 w + 15 and forms S^T = k q^T and dP^T = v dctx^T on the tensor cores
// (attention_grad_mma.cuh), whose dS^T and p_eff^T are the A fragments of dk
// += dS^T q and dv += p_eff^T dctx; it also stores every dS in ds_out's
// tiles, which attn_dq_kernel reads (dense_ds_tile).
template <typename T, int HD>
__global__ void __launch_bounds__(grad_threads<T>(), grad_min_blocks<T, HD>())
    attn_dkv_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ seg,
                    const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                    const float* __restrict__ stats, T* __restrict__ ds_out,
                    T* __restrict__ dqkv, int B, int L, int nh, float sm_scale, uint32_t thr,
                    float keep_prob) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!std::is_same<T, float>::value) {
    using Mm = GradMma<HD>;
    unsigned char* Ks = reinterpret_cast<unsigned char*>(smem);
    unsigned char* Vs = Ks + Mm::kTileBytes;
    unsigned char* ring = Vs + Mm::kTileBytes;  // stage s: q, dctx, m, D, rowsum, segment ids
    const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
    const size_t head = (size_t)L * HD, HN = (size_t)nh * HD;
    const T* Q = qkv + ((size_t)b * nh + h) * head;
    const T* K = Q + (size_t)B * nh * head;
    const T* V = K + (size_t)B * nh * head;
    const int32_t* seg_b = seg + (size_t)b * L;
    const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;
    const size_t plane = (size_t)B * nh * L;
    const float* st0 = stats + ((size_t)b * nh + h) * L;
    const int nt = (L + kTile - 1) / kTile;

    stage_grad_rows<HD>(K, HD, k0, 0, L, Ks);
    stage_grad_rows<HD>(V, HD, k0, 0, L, Vs);
    const int key_lo = k0 + 16 * warp + g, key_hi = key_lo + 8;
    const int sk_lo = key_lo < L ? seg_b[key_lo] : 0, sk_hi = key_hi < L ? seg_b[key_hi] : 0;
    const bool live = k0 + 16 * warp < L;  // warp-uniform
    float dk[HD / 8][4], dv[HD / 8][4];
    zero_acc<HD>(dk);
    zero_acc<HD>(dv);
    const GradLane<HD> lane;
    const auto stage_of = [&](int st) { return ring + st * dense_dkv_stage_bytes<HD>(); };
    grad_ring(
        nt, [](int t) { return t; },
        [&](int st, int t) {
          unsigned char* sp = stage_of(st);
          const int q0 = kTile * t;
          stage_grad_rows<HD>(Q, HD, q0, 0, L, sp);
          stage_grad_rows<HD>(dctx + (size_t)b * L * HN + (size_t)h * HD, HN, q0, 0, L,
                              sp + Mm::kTileBytes);
          float* sf = reinterpret_cast<float*>(sp + 2 * Mm::kTileBytes);
          stage_grad_stats(st0, q0, 0, L, sf);
          stage_grad_stats(st0 + plane, q0, 0, L, sf + kTile);
          stage_grad_stats(st0 + 2 * plane, q0, 0, L, sf + 2 * kTile);
          // the rows' segment ids, copied as 4-byte words (0 past L)
          stage_grad_stats(reinterpret_cast<const float*>(seg_b), q0, 0, L, sf + 3 * kTile);
        },
        [&](int st, int t) {
          if (!live) return;
          const int q0 = kTile * t;
          const unsigned char* sp = stage_of(st);
          const float* m_s = reinterpret_cast<const float*>(sp + 2 * Mm::kTileBytes);
          const float* d_s = m_s + kTile;
          const float* rs_s = d_s + kTile;
          const int* sq_s = reinterpret_cast<const int*>(rs_s + kTile);
          T* ds_tile = ds_out + dense_ds_tile(b * nh + h, t, blockIdx.x, nt);
          grad_tile_mma<HD>(
              smem_addr(Ks), smem_addr(Vs), smem_addr(sp), smem_addr(sp + Mm::kTileBytes), lane,
              [&](float sc, float dp, int hi, int col, float& pe) {
                const int key = hi ? key_hi : key_lo, row = q0 + col;
                if (row >= L || key >= L) return 0.0f;
                const bool keep = thr == 0u || dropout_keep(seed, thr, b, h, row, key);
                float ds;
                score_grad<T>(masked_score(sc, sm_scale, sq_s[col], hi ? sk_hi : sk_lo), dp,
                              m_s[col], d_s[col], rs_s[col], keep, sm_scale, keep_prob, ds, pe);
                return ds;
              },
              // dS of rows (col, col + 1) at the key, into the tile of
              // (query tile t, this key tile)
              [&](int hi, int col, float d0, float d1) {
                const int key = hi ? key_hi : key_lo;
                *reinterpret_cast<__nv_bfloat162*>(ds_tile + (key - k0) * kTile + col) =
                    __floats2bfloat162_rn(d0, d1);
              },
              dk, dv);
        });
    if (!live) return;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int l = hi ? key_hi : key_lo;
      if (l >= L) continue;
      T* out = dqkv + ((size_t)b * L + l) * 3 * HN + (size_t)h * HD;
      store_acc_row<HD>(dk, hi, out + HN, [](float v) { return v; });
      store_acc_row<HD>(dv, hi, out + 2 * HN, [](float v) { return v; });
    }
    return;
  } else {
  using G = Geometry<HD>;
  float* Ks = smem;
  float* Vs = Ks + G::kTileFloats;
  float* Qs = Vs + G::kTileFloats;
  float* dCs = Qs + G::kTileFloats;
  float* dSs = dCs + G::kTileFloats;
  float* Pes = dSs + kTile * kPS;
  float* m_s = Pes + kTile * kPS;
  float* d_s = m_s + kTile;
  float* rs_s = d_s + kTile;
  int* seg_qs = reinterpret_cast<int*>(rs_s + kTile);

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t head = (size_t)L * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const T* K = qkv + (((size_t)1 * B + b) * nh + h) * head;
  const T* V = qkv + (((size_t)2 * B + b) * nh + h) * head;
  const int32_t* seg_b = seg + (size_t)b * L;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const size_t plane = (size_t)B * nh * L;
  const size_t stat0 = ((size_t)b * nh + h) * L;

  load_head_tile<T, HD>(Ks, K, k0, L);
  load_head_tile<T, HD>(Vs, V, k0, L);
  int seg_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    seg_k[i] = key < L ? seg_b[key] : 0;
  }
  float dk[4][G::TD], dv[4][G::TD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < G::TD; ++j) dk[i][j] = dv[i][j] = 0.0f;

  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();
    load_head_tile<T, HD>(Qs, Q, q0, L);
    load_row_tile<T, HD>(dCs, dctx, b, h, q0, L, nh);
    if (threadIdx.x < kTile) {
      const int l = q0 + threadIdx.x;
      const bool in = l < L;
      seg_qs[threadIdx.x] = in ? seg_b[l] : 0;
      m_s[threadIdx.x] = in ? stats[stat0 + l] : 0.0f;
      d_s[threadIdx.x] = in ? stats[plane + stat0 + l] : 1.0f;
      rs_s[threadIdx.x] = in ? stats[2 * plane + stat0 + l] : 0.0f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(Ks, Qs, s);   // s[i][j]: key ty + 16 i, query tx + 16 j
    tile_dot<HD>(Vs, dCs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, row = q0 + c;
        float ds = 0.0f, p_eff = 0.0f;
        if (key < L && row < L) {
          const bool keep = thr == 0u || dropout_keep(seed, thr, b, h, row, key);
          score_grad<T>(masked_score(s[i][j], sm_scale, seg_qs[c], seg_k[i]), dp[i][j], m_s[c],
                        d_s[c], rs_s[c], keep, sm_scale, keep_prob, ds, p_eff);
        }
        dSs[(ty + 16 * i) * kPS + c] = ds;
        Pes[(ty + 16 * i) * kPS + c] = round_to<T>(p_eff);
      }
    }
    __syncthreads();
    tile_accumulate<HD>(dSs, Qs, dk);
    tile_accumulate<HD>(Pes, dCs, dv);
  }

  const size_t row_stride = (size_t)3 * nh * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = k0 + ty + 16 * i;
    if (l >= L) continue;
    T* out = dqkv + ((size_t)b * L + l) * row_stride + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < G::TD; ++j) {
      out[(size_t)nh * HD + tx + 16 * j] = from_f32<T>(dk[i][j]);
      out[(size_t)2 * nh * HD + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
  }
}

// attn_rows_kernel over (3, B, nh, L, hd) q, k, v into ctx (B, L, nh hd)
// and, with kGrad, the statistics (3, B, nh, L) from dctx (B, L, nh hd)
template <typename T, bool kGrad>
cudaError_t launch_rows(const T* qkv_buf, const int32_t* seg, const int32_t* seed, const T* dctx,
                        T* ctx_buf, float* stats, int B, int L, int nh, int hd, float sm_scale,
                        uint32_t thr, float keep_prob, cudaStream_t stream) {
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    const size_t smem = rows_smem_bytes<T, HD, kGrad>(L);
    auto kernel = attn_rows_kernel<T, HD, kGrad>;
    const cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((L + kTile - 1) / kTile, nh, B);
    kernel<<<grid, grad_threads<T>(), smem, stream>>>(qkv_buf, seg, seed, dctx, ctx_buf, stats, B,
                                                      L, nh, sm_scale, thr, keep_prob);
    return cudaGetLastError();
  });
}

// which gradient kernels launch_grad_cores runs
constexpr int kGradDkv = 1, kGradDq = 2, kGradBoth = 3;

// The backward's gradient kernels after the statistics pass: attn_dkv_kernel
// (dk, dv and, in bf16, every dS tile into ds_buf), then attn_dq_kernel (in
// bf16 from those tiles), into dqkv (B*L, 3, nh, hd)
template <typename T>
cudaError_t launch_grad_cores(int which, const T* qkv_buf, const int32_t* seg,
                              const int32_t* seed, const T* dctx, const float* stats, T* ds_buf,
                              T* dqkv, int B, int L, int nh, int hd, float sm_scale, uint32_t thr,
                              float keep_prob, cudaStream_t stream) {
  if (std::is_same<T, __nv_bfloat16>::value && ds_buf == nullptr) return cudaErrorInvalidValue;
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    const dim3 grid((L + kTile - 1) / kTile, nh, B);
    constexpr int threads = grad_threads<T>();
    cudaError_t e = cudaSuccess;
    if (which & kGradDkv) {
      // bf16: a ragged last tile leaves dS entries that no warp writes,
      // which the dq pass reads as zero
      if (ds_buf != nullptr && L % kTile) {
        const int nt = (L + kTile - 1) / kTile;
        e = cudaMemsetAsync(ds_buf, 0, dense_ds_tile(B * nh, 0, 0, nt) * sizeof(T), stream);
        if (e != cudaSuccess) return e;
      }
      auto dkv = attn_dkv_kernel<T, HD>;
      if ((e = prepare(dkv, dkv_smem_bytes<T, HD>())) != cudaSuccess) return e;
      dkv<<<grid, threads, dkv_smem_bytes<T, HD>(), stream>>>(
          qkv_buf, seg, seed, dctx, stats, ds_buf, dqkv, B, L, nh, sm_scale, thr, keep_prob);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    if (which & kGradDq) {
      auto dq = attn_dq_kernel<T, HD>;
      if ((e = prepare(dq, dq_smem_bytes<T, HD>())) != cudaSuccess) return e;
      dq<<<grid, threads, dq_smem_bytes<T, HD>(), stream>>>(
          qkv_buf, seg, seed, dctx, stats, ds_buf, dqkv, B, L, nh, sm_scale, thr, keep_prob);
      e = cudaGetLastError();
    }
    return e;
  });
}

template <typename T>
cudaError_t attention_train_fwd(const T* hidden, const int32_t* seg, const int32_t* seed,
                                const T* wqkv, const float* bqkv, const T* wo, const float* bo,
                                T* qkv_buf, T* ctx_buf, T* out, int B, int L, int H, int nh,
                                int hd, float sm_scale, uint32_t thr, float keep_prob,
                                cudaStream_t stream) {
  const int M = B * L, HN = nh * hd;
  cudaError_t err = launch_qkv_proj<T>(hidden, wqkv, bqkv, qkv_buf, B, L, H, nh, hd, 1.0f, stream);
  if (err != cudaSuccess) return err;
  err = launch_rows<T, false>(qkv_buf, seg, seed, nullptr, ctx_buf, nullptr, B, L, nh, hd,
                              sm_scale, thr, keep_prob, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(ctx_buf, wo, bo, out, M, H, HN, kActNone, nullptr, stream);
}

template <typename T>
cudaError_t attention_train_bwd(const T* hidden, const int32_t* seg, const int32_t* seed,
                                const T* wqkv, const float* bqkv, const T* wo, const T* g,
                                T* qkv_buf, T* dctx_buf, T* ctx_buf, float* stats, T* dqkv,
                                T* ds_buf, T* dx, float* dwqkv, float* dbqkv, float* dwo,
                                float* dbo, float* ws, size_t ws_floats, int splits_proj,
                                int splits_out,
                                int B, int L, int H, int nh, int hd, float sm_scale, uint32_t thr,
                                float keep_prob, cudaStream_t stream) {
  const int M = B * L, HN = nh * hd;
  cudaError_t err = launch_qkv_proj<T>(hidden, wqkv, bqkv, qkv_buf, B, L, H, nh, hd, 1.0f, stream);
  if (err != cudaSuccess) return err;
  // dctx = g . Wo^T, rounded (Wo is (Hn, H): read transposed)
  err = launch_gemm<T, true>(g, wo, nullptr, dctx_buf, M, HN, H, kActNone, nullptr, stream);
  if (err != cudaSuccess) return err;
  err = launch_rows<T, true>(qkv_buf, seg, seed, dctx_buf, ctx_buf, stats, B, L, nh, hd,
                             sm_scale, thr, keep_prob, stream);
  if (err != cudaSuccess) return err;
  err = launch_grad_cores<T>(kGradBoth, qkv_buf, seg, seed, dctx_buf, stats, ds_buf, dqkv, B, L,
                             nh, hd, sm_scale, thr, keep_prob, stream);
  if (err != cudaSuccess) return err;
  // dx = [dq dk dv] . Wqkv^T (Wqkv is (H, 3 Hn): read transposed)
  err = launch_gemm<T, true>(dqkv, wqkv, nullptr, dx, M, H, 3 * HN, kActNone, nullptr, stream);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad<T>(hidden, dqkv, dwqkv, dbqkv, ws, ws_floats, splits_proj, M, H,
                              3 * HN, stream);
  if (err != cudaSuccess) return err;
  return launch_weight_grad<T>(ctx_buf, g, dwo, dbo, ws, ws_floats, splits_out, M, HN, H, stream);
}

// keep[b, h, row, col] = 1 where the kernels keep the probability
__global__ void dropout_mask_kernel(const int32_t* __restrict__ seed_ptr, uint8_t* __restrict__ keep,
                                    int B, int nh, int L, uint32_t thr) {
  const size_t n = (size_t)B * nh * L * L;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int col = (int)(i % L);
    const int row = (int)((i / L) % L);
    const int h = (int)((i / ((size_t)L * L)) % nh);
    const int b = (int)(i / ((size_t)L * L * nh));
    keep[i] = dropout_keep(seed, thr, b, h, row, col) ? 1 : 0;
  }
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (hidden, weights, g, the buffers and the
// outputs dx/out); biases, stats and the weight/bias gradients are float32;
// seg is int32 (B, L) and seed one int32 on the card. thr = 0 turns dropout
// off. The backward's ws (ws_floats float32) is the weight gradients'
// workspace for splits_proj (dWqkv) and splits_out (dWo) row ranges
// (launch_weight_grad, bf16_gemm.cuh); its ds_buf (bf16; null in
// float32) holds B nh ceil(L / 64)^2 dS tiles of 64 x 64 (dense_ds_tile).
// Each entry returns the first CUDA error, or 0.
extern "C" int spk_attention_train_fwd(int dtype, const void* hidden, const void* seg,
                                       const void* seed, const void* wqkv, const void* bqkv,
                                       const void* wo, const void* bo, void* qkv_buf,
                                       void* ctx_buf, void* out, int B, int L, int H, int nh,
                                       int hd, float sm_scale, unsigned int thr, float keep_prob,
                                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  const auto sd = static_cast<const int32_t*>(seed);
  const auto bq = static_cast<const float*>(bqkv);
  const auto bo_ = static_cast<const float*>(bo);
  cudaError_t err;
  if (dtype == 0) {
    err = spk::attention_train_fwd<float>(
        static_cast<const float*>(hidden), sg, sd, static_cast<const float*>(wqkv), bq,
        static_cast<const float*>(wo), bo_, static_cast<float*>(qkv_buf),
        static_cast<float*>(ctx_buf), static_cast<float*>(out), B, L, H, nh, hd, sm_scale, thr,
        keep_prob, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    err = spk::attention_train_fwd<bf>(
        static_cast<const bf*>(hidden), sg, sd, static_cast<const bf*>(wqkv), bq,
        static_cast<const bf*>(wo), bo_, static_cast<bf*>(qkv_buf), static_cast<bf*>(ctx_buf),
        static_cast<bf*>(out), B, L, H, nh, hd, sm_scale, thr, keep_prob, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int spk_attention_train_bwd(int dtype, const void* hidden, const void* seg,
                                       const void* seed, const void* wqkv, const void* bqkv,
                                       const void* wo, const void* g, void* qkv_buf,
                                       void* dctx_buf, void* ctx_buf, void* stats, void* dqkv,
                                       void* ds_buf, void* dx, void* dwqkv, void* dbqkv,
                                       void* dwo, void* dbo,
                                       void* ws, size_t ws_floats, int splits_proj,
                                       int splits_out, int B, int L, int H, int nh, int hd,
                                       float sm_scale, unsigned int thr, float keep_prob,
                                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  const auto sd = static_cast<const int32_t*>(seed);
  const auto bq = static_cast<const float*>(bqkv);
  const auto st = static_cast<float*>(stats);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err;
  if (dtype == 0) {
    err = spk::attention_train_bwd<float>(
        static_cast<const float*>(hidden), sg, sd, static_cast<const float*>(wqkv), bq,
        static_cast<const float*>(wo), static_cast<const float*>(g), f(qkv_buf), f(dctx_buf),
        f(ctx_buf), st, f(dqkv), nullptr, f(dx), f(dwqkv), f(dbqkv), f(dwo), f(dbo), f(ws),
        ws_floats, splits_proj, splits_out, B, L, H, nh, hd, sm_scale, thr, keep_prob, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    const auto t = [](void* p) { return static_cast<bf*>(p); };
    err = spk::attention_train_bwd<bf>(
        static_cast<const bf*>(hidden), sg, sd, static_cast<const bf*>(wqkv), bq,
        static_cast<const bf*>(wo), static_cast<const bf*>(g), t(qkv_buf), t(dctx_buf),
        t(ctx_buf), st, t(dqkv), t(ds_buf), t(dx), f(dwqkv), f(dbqkv), f(dwo), f(dbo), f(ws),
        ws_floats, splits_proj, splits_out, B, L, H, nh, hd, sm_scale, thr, keep_prob, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// attn_rows_kernel alone on a (3, B, nh, L, hd) qkv buffer (q unscaled):
// ctx (B, L, nh hd) in the element type and, with grad = 1, the statistics
// (3, B, nh, L) float32 from dctx (B, L, nh hd). No model path calls it.
extern "C" int spk_attention_rows(int dtype, int grad, const void* qkv, const void* seg,
                                  const void* seed, const void* dctx, void* ctx, void* stats,
                                  int B, int L, int nh, int hd, float sm_scale, unsigned int thr,
                                  float keep_prob, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  const auto sd = static_cast<const int32_t*>(seed);
  const auto st = static_cast<float*>(stats);
  cudaError_t err;
  if (dtype == 0) {
    const auto q = static_cast<const float*>(qkv);
    const auto dc = static_cast<const float*>(dctx);
    const auto c = static_cast<float*>(ctx);
    err = grad ? spk::launch_rows<float, true>(q, sg, sd, dc, c, st, B, L, nh, hd, sm_scale, thr,
                                               keep_prob, s)
               : spk::launch_rows<float, false>(q, sg, sd, dc, c, st, B, L, nh, hd, sm_scale,
                                                thr, keep_prob, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    const auto q = static_cast<const bf*>(qkv);
    const auto dc = static_cast<const bf*>(dctx);
    const auto c = static_cast<bf*>(ctx);
    err = grad ? spk::launch_rows<bf, true>(q, sg, sd, dc, c, st, B, L, nh, hd, sm_scale, thr,
                                            keep_prob, s)
               : spk::launch_rows<bf, false>(q, sg, sd, dc, c, st, B, L, nh, hd, sm_scale, thr,
                                             keep_prob, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The backward's gradient kernels alone, after spk_attention_rows with
// grad = 1: which = 1 runs attn_dkv_kernel (dk, dv into slots 1 and 2 of
// dqkv (B*L, 3, nh, hd); in bf16 also every dS tile into ds_buf), 2
// attn_dq_kernel (dq into slot 0; in bf16 from ds_buf), 3 both. No model
// path calls it.
extern "C" int spk_attention_grad(int dtype, int which, const void* qkv, const void* seg,
                                  const void* seed, const void* dctx, const void* stats,
                                  void* ds_buf, void* dqkv, int B, int L, int nh, int hd,
                                  float sm_scale, unsigned int thr, float keep_prob,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  const auto sd = static_cast<const int32_t*>(seed);
  const auto st = static_cast<const float*>(stats);
  if (which < 1 || which > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = spk::launch_grad_cores<float>(
        which, static_cast<const float*>(qkv), sg, sd, static_cast<const float*>(dctx), st,
        nullptr, static_cast<float*>(dqkv), B, L, nh, hd, sm_scale, thr, keep_prob, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    err = spk::launch_grad_cores<bf>(
        which, static_cast<const bf*>(qkv), sg, sd, static_cast<const bf*>(dctx), st,
        static_cast<bf*>(ds_buf), static_cast<bf*>(dqkv), B, L, nh, hd, sm_scale, thr, keep_prob,
        s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// keep (B, nh, L, L) uint8: the mask the attention kernels apply for this
// seed and threshold.
extern "C" int spk_dropout_mask(const void* seed, void* keep, int B, int nh, int L,
                                unsigned int thr, void* stream) {
  spk::dropout_mask_kernel<<<1024, spk::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seed), static_cast<uint8_t*>(keep), B, nh, L, thr);
  return static_cast<int>(cudaGetLastError());
}
