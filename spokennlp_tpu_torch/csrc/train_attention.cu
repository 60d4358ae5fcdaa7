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
// product of the projections runs bf16_gemm.cuh's tensor-core tile, forward
// and backward (dctx and dx with a weight read transposed, the two weight
// gradients); the attention cores (attn_rows, attn_dq, attn_dkv) are SIMT
// kernels on the CUDA cores in float32, whose move to the tensor cores is
// later work.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// ran one grid step per sequence, kept q, k, v and the (L, L) probabilities
// of one head in VMEM, and summed the weight gradients over the sequential
// batch grid in its output buffers. Hopper blocks run in parallel and carry
// nothing from one to the next, so the work is split:
//   forward  1. qkv_proj_kernel (common.cuh), unscaled q, to (3, B, nh, L, hd);
//            2. attn_rows_kernel: one block per (64 query rows, head,
//               sequence), two passes over 64-key tiles, writes ctx (B, L, Hn);
//            3. ctx . Wo + bo (gemm_bias_act_kernel, common.cuh).
//   backward 1. q, k, v recomputed; dctx = g . Wo^T rounded;
//            2. attn_rows_kernel again, now also writing the row statistics
//               m, D and rowsum(dp p_eff) per query row, and ctx for dWo;
//            3. attn_dq_kernel: per (query tile, head, sequence), dq summed
//               over the key tiles it streams;
//            4. attn_dkv_kernel: per (KEY tile, head, sequence), dk and dv
//               summed over all query tiles it streams. Each block owns its
//               keys' rows of dk and dv, so the sum over query tiles is a
//               loop inside one block: no atomics, no partial buffers, and
//               the same order on every run;
//            5. dx = [dq dk dv] . Wqkv^T in one GEMM;
//            6. dWqkv = x^T [dq dk dv] and dWo = ctx^T g in
//               weight_grad_kernel (bf16_gemm.cuh): each block owns a tile
//               of the weight gradient and a fixed range of the B*L rows,
//               whose partial sums are added in order after it, so the
//               batch sum is deterministic too; the bias gradients come from
//               the same pass.
// The probabilities are recomputed three times in the backward (rows, dq,
// dkv) instead of being stored: (B, nh, L, L) never touches device memory.
#include "attention_tiles.cuh"
#include "bf16_gemm.cuh"

namespace spk {
namespace {

// the masked, scaled score of one (query, key) pair, as the TPU kernel
// forms it: dot * sm_scale + (allowed ? 0 : -1e9)
__device__ __forceinline__ float masked_score(float dot, float sm_scale, int seg_q, int seg_k) {
  return dot * sm_scale + ((seg_q == seg_k && seg_k > 0) ? 0.0f : kNegInf);
}

template <int HD>
constexpr size_t rows_smem_bytes() {
  return sizeof(float) * (4 * (size_t)Geometry<HD>::kTileFloats + (size_t)kTile * kPS) +
         sizeof(int) * kTile;
}

// Rows of one (query tile, head, sequence): m = max over all keys, then
// D = sum e, ctx = (keep e) . v / (D keep_prob), stored rounded to (B, L, Hn).
// With kGrad it also forms dp = dctx . v^T and writes the row statistics
// (m, D, rowsum(dp p_eff)) to stats (3, B, nh, L) for the dq and dk/dv
// kernels. Grid (ceil(L / 64), nh, B).
template <typename T, int HD, bool kGrad>
__global__ void __launch_bounds__(kThreads)
    attn_rows_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ seg,
                     const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                     T* __restrict__ ctx, float* __restrict__ stats, int B, int L, int nh,
                     float sm_scale, uint32_t thr, float keep_prob) {
  using G = Geometry<HD>;
  extern __shared__ float smem[];
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

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * (size_t)Geometry<HD>::kTileFloats + (size_t)kTile * kPS) +
         sizeof(int) * kTile;
}

// dq of one (query tile, head, sequence): sum over key tiles of dS . k,
// stored rounded into the (B*L, 3, nh, hd) gradient at slot 0.
// Grid (ceil(L / 64), nh, B).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    attn_dq_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ seg,
                   const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                   const float* __restrict__ stats, T* __restrict__ dqkv, int B, int L, int nh,
                   float sm_scale, uint32_t thr, float keep_prob) {
  using G = Geometry<HD>;
  extern __shared__ float smem[];
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

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * (size_t)Geometry<HD>::kTileFloats + 2 * (size_t)kTile * kPS +
                          3 * (size_t)kTile) +
         sizeof(int) * kTile;
}

// dk and dv of one (KEY tile, head, sequence): sums over every query tile of
// dS^T . q and round(p_eff)^T . dctx, stored rounded into the (B*L, 3, nh,
// hd) gradient at slots 1 and 2. Thread (ty, tx) owns keys ty + 16 i and, in
// the score tiles, queries tx + 16 j. Grid (ceil(L / 64), nh, B).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    attn_dkv_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ seg,
                    const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                    const float* __restrict__ stats, T* __restrict__ dqkv, int B, int L, int nh,
                    float sm_scale, uint32_t thr, float keep_prob) {
  using G = Geometry<HD>;
  extern __shared__ float smem[];
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

template <typename T>
cudaError_t attention_train_fwd(const T* hidden, const int32_t* seg, const int32_t* seed,
                                const T* wqkv, const float* bqkv, const T* wo, const float* bo,
                                T* qkv_buf, T* ctx_buf, T* out, int B, int L, int H, int nh,
                                int hd, float sm_scale, uint32_t thr, float keep_prob,
                                cudaStream_t stream) {
  const int M = B * L, HN = nh * hd;
  cudaError_t err = launch_qkv_proj<T>(hidden, wqkv, bqkv, qkv_buf, B, L, H, nh, hd, 1.0f, stream);
  if (err != cudaSuccess) return err;
  err = with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    constexpr size_t smem = rows_smem_bytes<HD>();
    auto kernel = attn_rows_kernel<T, HD, false>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((L + kTile - 1) / kTile, nh, B);
    kernel<<<grid, kThreads, smem, stream>>>(qkv_buf, seg, seed, nullptr, ctx_buf, nullptr, B, L,
                                             nh, sm_scale, thr, keep_prob);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(ctx_buf, wo, bo, out, M, H, HN, kActNone, nullptr, stream);
}

template <typename T>
cudaError_t attention_train_bwd(const T* hidden, const int32_t* seg, const int32_t* seed,
                                const T* wqkv, const float* bqkv, const T* wo, const T* g,
                                T* qkv_buf, T* dctx_buf, T* ctx_buf, float* stats, T* dqkv,
                                T* dx, float* dwqkv, float* dbqkv, float* dwo, float* dbo,
                                float* ws, size_t ws_floats, int splits_proj, int splits_out,
                                int B, int L, int H, int nh, int hd, float sm_scale, uint32_t thr,
                                float keep_prob, cudaStream_t stream) {
  const int M = B * L, HN = nh * hd;
  cudaError_t err = launch_qkv_proj<T>(hidden, wqkv, bqkv, qkv_buf, B, L, H, nh, hd, 1.0f, stream);
  if (err != cudaSuccess) return err;
  // dctx = g . Wo^T, rounded (Wo is (Hn, H): read transposed)
  err = launch_gemm<T, true>(g, wo, nullptr, dctx_buf, M, HN, H, kActNone, nullptr, stream);
  if (err != cudaSuccess) return err;
  err = with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    const dim3 grid((L + kTile - 1) / kTile, nh, B);
    auto rows = attn_rows_kernel<T, HD, true>;
    cudaError_t e = prepare(rows, rows_smem_bytes<HD>());
    if (e != cudaSuccess) return e;
    rows<<<grid, kThreads, rows_smem_bytes<HD>(), stream>>>(
        qkv_buf, seg, seed, dctx_buf, ctx_buf, stats, B, L, nh, sm_scale, thr, keep_prob);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    auto dq = attn_dq_kernel<T, HD>;
    if ((e = prepare(dq, dq_smem_bytes<HD>())) != cudaSuccess) return e;
    dq<<<grid, kThreads, dq_smem_bytes<HD>(), stream>>>(qkv_buf, seg, seed, dctx_buf, stats,
                                                         dqkv, B, L, nh, sm_scale, thr,
                                                         keep_prob);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    auto dkv = attn_dkv_kernel<T, HD>;
    if ((e = prepare(dkv, dkv_smem_bytes<HD>())) != cudaSuccess) return e;
    dkv<<<grid, kThreads, dkv_smem_bytes<HD>(), stream>>>(qkv_buf, seg, seed, dctx_buf, stats,
                                                           dqkv, B, L, nh, sm_scale, thr,
                                                           keep_prob);
    return cudaGetLastError();
  });
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
// (launch_weight_grad, bf16_gemm.cuh; bf16 only). Each entry returns the
// first CUDA error, or 0.
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
                                       void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
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
        f(ctx_buf), st, f(dqkv), f(dx), f(dwqkv), f(dbqkv), f(dwo), f(dbo), f(ws), ws_floats,
        splits_proj, splits_out, B, L, H, nh, hd, sm_scale, thr, keep_prob, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    const auto t = [](void* p) { return static_cast<bf*>(p); };
    err = spk::attention_train_bwd<bf>(
        static_cast<const bf*>(hidden), sg, sd, static_cast<const bf*>(wqkv), bq,
        static_cast<const bf*>(wo), static_cast<const bf*>(g), t(qkv_buf), t(dctx_buf),
        t(ctx_buf), st, t(dqkv), t(dx), f(dwqkv), f(dbqkv), f(dwo), f(dbo), f(ws), ws_floats,
        splits_proj, splits_out, B, L, H, nh, hd, sm_scale, thr, keep_prob, s);
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
