// Training Longformer attention block for the H100 (sm_90a), forward and
// backward:
//   out = attn(x) Wo + bo
// with attn the sliding-window + global-token attention of
// sliding_attention.cuh and dropout on the band, global-column and
// global-row probabilities. Residual, LayerNorm and hidden-state dropout
// stay in PyTorch.
//
// Replaces the TPU kernels of spokennlp_tpu/ops/pallas/train_sliding.py,
// sliding_attention_block_train: _sliding_train_fwd_kernel and
// _sliding_train_bwd_kernel (the custom VJP of make_sliding_attention_train).
//
// Numerics follow the TPU kernel: q pre-scaled and rounded, k, v, kg, vg and
// qg rounded; e = exp(s - m) rounded as in sliding_attention.cuh; the
// backward forms dS = round(p_eff dp - p rowsum(dp p_eff)) over the band and
// the global columns together, rounds dq before scaling it by sm_scale, sums
// dk and dv over every row that reaches a key in float32 before rounding
// them, and returns the weight and bias gradients in float32 summed over the
// batch. The banded rows' cotangent is zero on global rows, whose gradient
// flows through the *_global projections instead.
//
// What bounds it here. At the recipe's micro-batch (B=2, L=2048, H=768, 12
// heads of 64, window 512) the forward is about 36 GFLOP and the backward,
// which recomputes the forward's projections and attention, about 100 GFLOP,
// against some 20 MB (forward) and 50 MB (backward) of inputs, weights and
// outputs in bf16: bound by arithmetic. In bf16 every product of the
// projections runs bf16_gemm.cuh's tensor-core tile, forward and backward
// (dctx and dx with a weight read transposed, the two weight gradients), and
// the backward's gradient kernels band_dq and band_dkv run
// attention_grad_mma.cuh's tensor-core body (S, dP and the dq, dk, dv
// products on mma.sync; the softmax gradient with its Philox draw on the
// fragments in registers). The band rows kernel (the forward's attention
// and the backward's statistics pass) runs attention_rows_mma.cuh's
// tensor-core body (S, dP and P.V on mma.sync; the mask, the rounded
// exponent and the Philox draw on the fragments), and global_rows_kernel
// global_rows_mma.cuh's (the global query, S, dP, P.V and dS . kg on
// mma.sync, the keys split over the warps). global_kv_grad_kernel, whose G
// global rows are a small share of the work, stays a SIMT kernel on the
// CUDA cores.
// In float32 every product, forward and backward, runs on the tensor cores
// as 3xTF32 (each float32 operand split into two TF32 parts, three mma.sync
// m16n8k8 products in float32): the projections on tf32x3_gemm.cuh's tile
// through the same launchers (the projections the backward recomputes take
// the forward's kernel and tile, so it differentiates the forward's own
// values), the band rows kernel and the gradient kernels on the float32
// siblings of the same bodies (rows_tile_tf32, grad_tile_tf32,
// dq_from_ds_tile_tf32; 128 threads, the same callbacks), each dS stored
// once in float32 for the dq pass (503 MB at B=8, L=2048, window 512), and
// global_rows_kernel on global_rows_tile_tf32 (a cluster of blocks a
// (head, sequence), each over a range of its keys). global_kv_grad_kernel
// stays on the CUDA cores in both dtypes.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// ran one grid step per sequence, summed dk and dv of overlapping bands into
// a VMEM buffer chunk after chunk and the weight gradients over the
// sequential batch grid. Hopper blocks run in parallel, so:
//   forward  the launches of sliding_block.cu with dropout, then ctx . Wo +
//            bo (gemm_bias_act_kernel, bf16_gemm.cuh);
//   backward 1. counts and projections recomputed; dctx = g . Wo^T rounded;
//            2. band_rows_kernel<kGrad>: ctx again (for dWo) and the row
//               statistics (m, D, rowsum(dp p_eff));
//            3. global_rows_kernel<kGrad>: the global rows' ctx, statistics,
//               qg and d(qg), written as slot 3 of the projection gradient;
//            4. band_dkv_kernel: per (KEY tile, head, sequence) dk and dv
//               summed over the query tiles whose band covers it and, for
//               the tile that holds the global keys, over every query row's
//               global columns. Each block owns its keys: no atomics, the
//               same order on every run. It also stores each dS once, in
//               the element type (sliding_ds_tiles);
//            5. band_dq_kernel: per (query tile, head, sequence) dq over the
//               band and global-column tiles, from those dS tiles;
//            6. global_kv_grad_kernel: per (key tile, head, sequence) dkg and
//               dvg summed over the (at most G) global rows;
//            7. dx = [dq dk dv dqg dkg dvg] . [Wqkv Wg]^T in one GEMM, and
//               d[Wqkv Wg] = x^T [dq ... dvg] and dWo = ctx^T g in
//               launch_weight_grad (bf16_gemm.cuh): each block owns a tile
//               of a weight gradient and a fixed range of the B*L rows,
//               whose partial sums are added in order after it, so the batch
//               sum is deterministic; the bias gradients come from the same
//               pass.
// Saved between the passes: the inputs and the seed only; the scores and
// probabilities are recomputed tile by tile in each kernel (dS passes from
// step 4 to step 5 through device memory).
#include "attention_grad_mma.cuh"
#include "sliding_attention.cuh"

namespace spk {
namespace {

// The first stored dS tile of query tile qt of (b, h) = bh: a query tile
// holds band_tiles(C) band tiles, then the global-column tile.
__host__ __device__ __forceinline__ size_t sliding_ds_tiles(int bh, int qt, int L, int C) {
  return ((size_t)bh * ((L + kTile - 1) / kTile) + qt) * (band_tiles(C) + 1) * (size_t)kDsTile;
}

// dS of one (row, key) pair, rounded to T, and p_eff, from the row's
// statistics; the softmax-with-dropout backward of the TPU kernel
template <typename T>
__device__ __forceinline__ void sliding_score_grad(float s, float dp, float m, float d_sum,
                                                   float rs, bool keep, float keep_prob,
                                                   float& ds, float& p_eff) {
  const float e = rounded_exp<T>(s, m);
  p_eff = keep ? e / (d_sum * keep_prob) : 0.0f;
  ds = round_to<T>(p_eff * dp - (e / d_sum) * rs);
}

// dq of one (query tile, head, sequence): sum over the band and global-column
// tiles of dS . k, from the dS tiles band_dkv_kernel stored in ds_in
// (sliding_ds_tiles); stored as round(round(dq) * sm_scale) into slot 0 of
// dproj (B*L rows of stride ld). Grid (ceil(L / 64), nh, B), 128 threads on
// the tensor cores (attention_grad_mma.cuh: bf16, or float32 on 3xTF32).
template <typename T, int HD>
__global__ void __launch_bounds__(kGradThreads, core_min_blocks<T, HD>())
    band_dq_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ counts,
                   const T* __restrict__ ds_in, T* __restrict__ dproj, int B, int L, int nh,
                   int C, int ld, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
  const T* K = qkv + (((size_t)1 * B + b) * nh + h) * (size_t)L * HD;
  const T* tiles = ds_in + sliding_ds_tiles(b * nh + h, blockIdx.x, L, C);
  const int n_valid = counts[2 * b], n_glob = counts[2 * b + 1];
  const int nbt = band_tiles(C), nt = nbt + (n_glob > 0 ? 1 : 0);  // the last: global columns
  const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
  const bool live = q0 + 16 * warp < L;  // warp-uniform
  float dq[HD / 8][4];
  zero_acc<HD>(dq);
  const auto k0_of = [&](int t) { return t == nbt ? 0 : q0 - C + kTile * t; };
  dq_from_ds_tiles<T, HD>(
      K, L, nt,
      [&](int t) {
        while (t < nt && t != nbt && !band_tile_live(k0_of(t), n_glob, n_valid)) ++t;
        return t;
      },
      k0_of, [&](int t) { return tiles + (size_t)t * kDsTile; }, live,
      reinterpret_cast<unsigned char*>(smem), dq);
  if (!live) return;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int l = hi ? r_hi : r_lo;
    if (l < L)
      store_acc_row<HD>(dq, hi, dproj + ((size_t)b * L + l) * ld + (size_t)h * HD,
                        [&](float v) { return round_to<T>(v) * sm_scale; });
  }
}

// The dk/dv pass's block order: block (blockIdx.x, y, z) of the grid
// (ceil(L / 64), nh, B), taken in linear order (x fastest), works on key
// tile x of (head h, sequence b) with the first key tile of every (head,
// sequence) first, then the others. The first key tile holds the global
// columns (n_glob <= 16) and walks every query tile of the sequence besides
// its band's (41 query tiles at L=2048, window 512, against 9): in grid
// order the last heads' ones started late and ran on alone at the end of the
// launch; started first, they run beside the short tiles.
__device__ __forceinline__ void first_tile_first(int nh, int& x, int& h, int& b) {
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + nh * blockIdx.z);
  const int n_first = nh * gridDim.z;
  int hb;
  if (lin < n_first) {
    x = 0;
    hb = lin;
  } else {
    const int r = lin - n_first;
    x = 1 + r % (gridDim.x - 1);
    hb = r / (gridDim.x - 1);
  }
  h = hb % nh;
  b = hb / nh;
}

// dk and dv of one (KEY tile, head, sequence): sums of dS^T . q and
// round(p_eff)^T . dctx over the query tiles whose band reaches the keys,
// and, when the tile holds global keys (k0 < n_glob), over every query
// tile's global columns; stored rounded into slots 1 and 2 of dproj. Grid
// (ceil(L / 64), nh, B) in first_tile_first's order, 128 threads: warp w
// owns keys 16 w .. 16 w + 15 and forms S^T = k q^T and dP^T = v dctx^T on
// the tensor cores (attention_grad_mma.cuh: bf16, or float32 on 3xTF32),
// whose dS^T and p_eff^T are the A fragments of dk += dS^T q and dv +=
// p_eff^T dctx; it also stores every dS, in the element type, in ds_out's
// tiles, which band_dq_kernel reads (sliding_ds_tiles).
template <typename T, int HD>
__global__ void __launch_bounds__(kGradThreads, core_min_blocks<T, HD>())
    band_dkv_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                    const float* __restrict__ stats, T* __restrict__ ds_out,
                    T* __restrict__ dproj, int B, int L, int nh, int C, int ld, uint32_t thr,
                    float keep_prob) {
  extern __shared__ __align__(16) float smem[];
  constexpr size_t kTileB = grad_tile_bytes<T, HD>();
  unsigned char* Ks = reinterpret_cast<unsigned char*>(smem);
  unsigned char* Vs = Ks + kTileB;
  unsigned char* ring = Vs + kTileB;  // stage s: q, dctx, then m, D, rowsum
  int x, h, b;
  first_tile_first(nh, x, h, b);
  const int k0 = x * kTile;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
  const size_t head = (size_t)L * HD, HN = (size_t)nh * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const T* K = qkv + (((size_t)1 * B + b) * nh + h) * head;
  const T* V = qkv + (((size_t)2 * B + b) * nh + h) * head;
  const int n_valid = counts[2 * b], n_glob = counts[2 * b + 1];
  const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;
  const size_t plane = (size_t)B * nh * L;
  const float* st0 = stats + ((size_t)b * nh + h) * L;
  T* ds_bh = ds_out + sliding_ds_tiles(b * nh + h, 0, L, C);  // query tile qt's at qt (nbt + 1)

  stage_tile<HD>(K, HD, k0, 0, L, Ks);
  stage_tile<HD>(V, HD, k0, 0, L, Vs);
  const int key_lo = k0 + 16 * warp + g, key_hi = key_lo + 8;
  const bool live = k0 + 16 * warp < L;  // warp-uniform
  float dk[HD / 8][4], dv[HD / 8][4];
  zero_acc<HD>(dk);
  zero_acc<HD>(dv);
  // band query tiles (when the keys hold a real, non-global one), then, for
  // the tile of the global keys, every query tile for the global columns
  const int nbt = band_tiles(C);
  const int n_band = band_tile_live(k0, n_glob, n_valid) ? nbt : 0;
  const int n = n_band + (k0 < n_glob ? (L + kTile - 1) / kTile : 0);
  const auto q0_of = [&](int t) { return t >= n_band ? kTile * (t - n_band) : k0 - C + kTile * t; };
  const auto stage_of = [&](int s) { return ring + s * grad_dkv_stage<T, HD>(); };
  grad_ring(
      n,
      [&](int t) {
        for (; t < n; ++t)
          if (q0_of(t) + kTile > 0 && q0_of(t) < L) break;
        return t;
      },
      [&](int s, int t) {
        unsigned char* st = stage_of(s);
        const int q0 = q0_of(t);
        stage_tile<HD>(Q, HD, q0, 0, L, st);
        stage_tile<HD>(dctx + (size_t)b * L * HN + (size_t)h * HD, HN, q0, n_glob, L, st + kTileB);
        float* sf = reinterpret_cast<float*>(st + 2 * kTileB);
        stage_grad_stats(st0, q0, 0, L, sf);
        stage_grad_stats(st0 + plane, q0, 0, L, sf + kTile);
        stage_grad_stats(st0 + 2 * plane, q0, 0, L, sf + 2 * kTile);
      },
      [&](int s, int t) {
        if (!live) return;
        const bool gcol = t >= n_band;
        const int q0 = q0_of(t);
        const unsigned char* st = stage_of(s);
        const float* m_s = reinterpret_cast<const float*>(st + 2 * kTileB);
        const float* d_s = m_s + kTile;
        const float* rs_s = d_s + kTile;
        grad_tile<T, HD>(
            Ks, Vs, st, st + kTileB,
            [&](float sc, float dp, int hi, int col, float& pe) {
              const int key = hi ? key_hi : key_lo, row = q0 + col;
              const bool ok = row >= 0 && row < L &&
                              (gcol ? key < n_glob : band_allowed(row, key, C, n_glob, n_valid));
              if (!ok) return 0.0f;
              const bool keep = gcol
                                    ? keep_prob_bits(seed, thr, b, h | kGlobalColStream, row, key)
                                    : keep_prob_bits(seed, thr, b, h, row, key);
              float ds;
              sliding_score_grad<T>(sc, dp, m_s[col], d_s[col], rs_s[col], keep, keep_prob, ds,
                                    pe);
              return ds;
            },
            // dS of rows (row, row + 1) at key into the dq pass's tile of
            // the row's query tile: the band tile that holds the key, or the
            // global-column tile
            [&](int hi, int col, float d0, float d1) {
              const int key = hi ? key_hi : key_lo, row = q0 + col;
              if (row < 0 || row >= L) return;
              int t = nbt, kin = key;
              if (!gcol) {
                const int off = key - (row - row % kTile) + C;
                if (off < 0 || off >= kTile * nbt) return;  // no band tile of the row's: masked
                t = off / kTile;
                kin = off % kTile;
              }
              store_pair(ds_bh + (size_t)((row / kTile) * (nbt + 1) + t) * kDsTile + kin * kTile +
                             row % kTile,
                         d0, d1);
            },
            dk, dv);
      });
  if (!live) return;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int l = hi ? key_hi : key_lo;
    if (l >= L) continue;
    T* out = dproj + ((size_t)b * L + l) * ld + (size_t)h * HD;
    store_acc_row<HD>(dk, hi, out + HN, [](float v) { return v; });
    store_acc_row<HD>(dv, hi, out + 2 * HN, [](float v) { return v; });
  }
}

template <int HD>
size_t gkv_smem_bytes(int G) {
  return sizeof(float) * (2 * (size_t)G * HD + 3 * (size_t)G + 2 * (size_t)Geometry<HD>::kTileFloats +
                          2 * (size_t)G * kTile);
}

// dkg and dvg of one (key tile, head, sequence): sums over the global rows
// g < n_glob of dS[g, key] qg[g] and round(p_eff[g, key]) dctx[g], with the
// global rows' statistics; stored rounded into slots 4 and 5 of dproj (zero
// without global tokens). Grid (ceil(L / 64), nh, B).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    global_kv_grad_kernel(const T* __restrict__ qg_buf, const T* __restrict__ gkv,
                          const int32_t* __restrict__ counts, const int32_t* __restrict__ seed_ptr,
                          const T* __restrict__ dctx, const float* __restrict__ gstats,
                          T* __restrict__ dproj, int B, int L, int nh, int G, int ld,
                          uint32_t thr, float keep_prob) {
  using Geo = Geometry<HD>;
  constexpr int S = Geo::S;
  extern __shared__ float smem[];
  float* Qg = smem;            // (G, HD)
  float* dCg = Qg + G * HD;    // (G, HD)
  float* st = dCg + G * HD;    // (3, G)
  float* Ks = st + 3 * G;      // (64, HD + 1)
  float* Vs = Ks + Geo::kTileFloats;
  float* dSg = Vs + Geo::kTileFloats;  // (G, 64)
  float* Peg = dSg + G * kTile;        // (G, 64)

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_valid = counts[2 * b], n_glob = counts[2 * b + 1];
  const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;
  const size_t HN = (size_t)nh * HD;
  const T* KG = gkv + (((size_t)0 * B + b) * nh + h) * (size_t)L * HD;
  const T* VG = gkv + (((size_t)1 * B + b) * nh + h) * (size_t)L * HD;

  for (int e = threadIdx.x; e < n_glob * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    Qg[e] = to_f32(qg_buf[(((size_t)b * nh + h) * G + g) * HD + d]);
    dCg[e] = to_f32(dctx[((size_t)b * L + g) * HN + (size_t)h * HD + d]);
  }
  if (threadIdx.x < n_glob) {
    const size_t r = ((size_t)b * nh + h) * G + threadIdx.x, plane = (size_t)B * nh * G;
    st[threadIdx.x] = gstats[r];
    st[G + threadIdx.x] = gstats[plane + r];
    st[2 * G + threadIdx.x] = gstats[2 * plane + r];
  }
  load_head_tile<T, HD>(Ks, KG, k0, L);
  load_head_tile<T, HD>(Vs, VG, k0, L);
  __syncthreads();

  for (int e = threadIdx.x; e < n_glob * kTile; e += kThreads) {
    const int g = e / kTile, c = e % kTile, key = k0 + c;
    float ds = 0.0f, p_eff = 0.0f;
    if (key < n_valid) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        s = fmaf(Qg[g * HD + d], Ks[c * S + d], s);
        dp = fmaf(dCg[g * HD + d], Vs[c * S + d], dp);
      }
      const bool keep = keep_prob_bits(seed, thr, b, h | kGlobalRowStream, g, key);
      sliding_score_grad<T>(s, dp, st[g], st[G + g], st[2 * G + g], keep, keep_prob, ds, p_eff);
    }
    dSg[e] = ds;
    Peg[e] = round_to<T>(p_eff);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i, l = k0 + c;
    if (l >= L) continue;
    float dk[Geo::TD], dv[Geo::TD];
#pragma unroll
    for (int j = 0; j < Geo::TD; ++j) dk[j] = dv[j] = 0.0f;
    for (int g = 0; g < n_glob; ++g) {
      const float ds = dSg[g * kTile + c], pe = Peg[g * kTile + c];
#pragma unroll
      for (int j = 0; j < Geo::TD; ++j) {
        dk[j] = fmaf(ds, Qg[g * HD + tx + 16 * j], dk[j]);
        dv[j] = fmaf(pe, dCg[g * HD + tx + 16 * j], dv[j]);
      }
    }
    T* out = dproj + ((size_t)b * L + l) * ld + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < Geo::TD; ++j) {
      out[4 * HN + tx + 16 * j] = from_f32<T>(dk[j]);
      out[5 * HN + tx + 16 * j] = from_f32<T>(dv[j]);
    }
  }
}

template <typename T>
cudaError_t sliding_train_fwd(const T* hidden, const int32_t* mask, const int32_t* glob,
                              const int32_t* seed, const T* wqkv, const float* bqkv, const T* wgq,
                              const float* bgq, const T* wgkv, const float* bgkv, const T* wo,
                              const float* bo, int32_t* counts, T* qkv_buf, T* gkv_buf,
                              T* ctx_buf, T* out, int B, int L, int H, int nh, int hd, int C,
                              int G, int global_rows, float sm_scale, uint32_t thr,
                              float keep_prob, cudaStream_t stream) {
  cudaError_t err = sliding_projections<T>(hidden, mask, glob, wqkv, bqkv, wgkv, bgkv, counts,
                                           qkv_buf, gkv_buf, B, L, H, nh, hd, G, global_rows,
                                           sm_scale, stream);
  if (err != cudaSuccess) return err;
  err = sliding_attention<T, false>(hidden, seed, wgq, bgq, counts, qkv_buf, gkv_buf, nullptr,
                                    ctx_buf, nullptr, nullptr, nullptr, nullptr, B, L, H, nh, hd,
                                    C, G, global_rows, 0, sm_scale, thr, keep_prob, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(ctx_buf, wo, bo, out, B * L, H, nh * hd, kActNone, nullptr, stream);
}

template <typename T>
cudaError_t sliding_train_bwd(const T* hidden, const int32_t* mask, const int32_t* glob,
                              const int32_t* seed, const T* wqkv, const float* bqkv, const T* wgq,
                              const float* bgq, const T* wgkv, const float* bgkv, const T* wo,
                              const T* w_all, const T* g, int32_t* counts, T* qkv_buf,
                              T* gkv_buf, T* ctx_buf, T* dctx_buf, float* stats, float* gstats,
                              T* qg_buf, T* dproj, T* ds_buf, T* dx, float* dw_all,
                              float* db_all, float* dwo, float* dbo, float* ws, size_t ws_floats,
                              int splits_proj, int splits_out, int B, int L, int H, int nh, int hd,
                              int C, int G, int global_rows, float sm_scale, uint32_t thr,
                              float keep_prob, cudaStream_t stream) {
  const int M = B * L, HN = nh * hd, ld = (global_rows ? 6 : 3) * HN;
  cudaError_t err = sliding_projections<T>(hidden, mask, glob, wqkv, bqkv, wgkv, bgkv, counts,
                                           qkv_buf, gkv_buf, B, L, H, nh, hd, G, global_rows,
                                           sm_scale, stream);
  if (err != cudaSuccess) return err;
  // dctx = g . Wo^T, rounded (Wo is (Hn, H): read transposed)
  err = launch_gemm<T, true>(g, wo, nullptr, dctx_buf, M, HN, H, kActNone, nullptr, stream);
  if (err != cudaSuccess) return err;
  if (global_rows) {
    // d(qg) is written on the global rows only: the rest of slot 3 is zero
    err = cudaMemset2DAsync(dproj + 3 * HN, (size_t)ld * sizeof(T), 0, (size_t)HN * sizeof(T), M,
                            stream);
    if (err != cudaSuccess) return err;
  }
  err = sliding_attention<T, true>(hidden, seed, wgq, bgq, counts, qkv_buf, gkv_buf, dctx_buf,
                                   ctx_buf, stats, qg_buf, gstats, dproj + 3 * HN, B, L, H, nh,
                                   hd, C, G, global_rows, ld, sm_scale, thr, keep_prob, stream);
  if (err != cudaSuccess) return err;
  if (ds_buf == nullptr) return cudaErrorInvalidValue;
  err = with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    const dim3 grid((L + kTile - 1) / kTile, nh, B);
    cudaError_t e = cudaSuccess;
    if (C % kTile || L % kTile) {
      // tiles that no block fills whole: what the dk/dv pass leaves stays zero
      e = cudaMemsetAsync(ds_buf, 0, sliding_ds_tiles(B * nh, 0, L, C) * sizeof(T), stream);
      if (e != cudaSuccess) return e;
    }
    auto dkv = band_dkv_kernel<T, HD>;
    if ((e = prepare(dkv, grad_dkv_smem<T, HD>())) != cudaSuccess) return e;
    dkv<<<grid, kGradThreads, grad_dkv_smem<T, HD>(), stream>>>(
        qkv_buf, counts, seed, dctx_buf, stats, ds_buf, dproj, B, L, nh, C, ld, thr, keep_prob);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    auto dq = band_dq_kernel<T, HD>;
    if ((e = prepare(dq, grad_dq_smem<T, HD>())) != cudaSuccess) return e;
    dq<<<grid, kGradThreads, grad_dq_smem<T, HD>(), stream>>>(qkv_buf, counts, ds_buf, dproj, B,
                                                                L, nh, C, ld, sm_scale);
    if ((e = cudaGetLastError()) != cudaSuccess || !global_rows) return e;
    auto gkv = global_kv_grad_kernel<T, HD>;
    const size_t smem = gkv_smem_bytes<HD>(G);
    if ((e = prepare(gkv, smem)) != cudaSuccess) return e;
    gkv<<<grid, kThreads, smem, stream>>>(qg_buf, gkv_buf, counts, seed, dctx_buf, gstats, dproj,
                                          B, L, nh, G, ld, thr, keep_prob);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  // dx = dproj . [Wqkv Wg]^T ([Wqkv Wg] is (H, ld): read transposed)
  err = launch_gemm<T, true>(dproj, w_all, nullptr, dx, M, H, ld, kActNone, nullptr, stream);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad<T>(hidden, dproj, dw_all, db_all, ws, ws_floats, splits_proj, M, H, ld,
                              stream);
  if (err != cudaSuccess) return err;
  return launch_weight_grad<T>(ctx_buf, g, dwo, dbo, ws, ws_floats, splits_out, M, HN, H, stream);
}

// The three keep masks of one seed, as the kernels draw them: band (B, nh,
// L / C, C, 3C) at (row = i C + ci, key = i C - C + cj, wrapped to 32 bits),
// global columns (B, nh, L, G), global rows (B, nh, G, L).
__global__ void sliding_mask_kernel(const int32_t* __restrict__ seed_ptr, uint8_t* __restrict__ band,
                                    uint8_t* __restrict__ gcol, uint8_t* __restrict__ grow, int B,
                                    int nh, int L, int C, int G, uint32_t thr) {
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const size_t n_band = (size_t)B * nh * L * 3 * C, n_g = (size_t)B * nh * L * G;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_band + 2 * n_g;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n_band) {
      const int cj = (int)(i % (3 * C));
      const size_t r = i / (3 * C);  // (b, h, row)
      const int row = (int)(r % L), h = (int)((r / L) % nh), b = (int)(r / ((size_t)L * nh));
      const int key = row - row % C - C + cj;
      band[i] = keep_prob_bits(seed, thr, b, h, row, key);
    } else if (i < n_band + n_g) {
      const size_t j = i - n_band;
      const int g = (int)(j % G);
      const size_t r = j / G;
      const int row = (int)(r % L), h = (int)((r / L) % nh), b = (int)(r / ((size_t)L * nh));
      gcol[j] = keep_prob_bits(seed, thr, b, h | kGlobalColStream, row, g);
    } else {
      const size_t j = i - n_band - n_g;
      const int key = (int)(j % L);
      const size_t r = j / L;
      const int g = (int)(r % G), h = (int)((r / G) % nh), b = (int)(r / ((size_t)G * nh));
      grow[j] = keep_prob_bits(seed, thr, b, h | kGlobalRowStream, g, key);
    }
  }
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (hidden, weights, g, the element-type
// buffers and out/dx); mask, glob (B, L), seed (1,) and counts (B, 2) int32;
// biases, stats (3, B, nh, L), gstats (3, B, nh, G) and the weight and bias
// gradients float32. wqkv (H, 3 nh hd), wgq (H, nh hd), wgkv (H, 2 nh hd),
// wo (nh hd, H), w_all = [wqkv wg] (H, ld); dproj (B*L, ld) with ld = 6 nh hd
// (3 nh hd without global rows), qg_buf (B, nh, G, hd). thr = 0 turns dropout
// off (seed may then be null). ds_buf (the element type) holds B nh
// ceil(L / 64) (band_tiles(C) + 1) tiles of 64 x 64 dS that the dk/dv pass
// writes and the dq pass reads. Each entry returns the first CUDA error, or
// 0.
extern "C" int spk_sliding_train_fwd(int dtype, const void* hidden, const void* mask,
                                     const void* glob, const void* seed, const void* wqkv,
                                     const void* bqkv, const void* wgq, const void* bgq,
                                     const void* wgkv, const void* bgkv, const void* wo,
                                     const void* bo, void* counts, void* qkv_buf, void* gkv_buf,
                                     void* ctx_buf, void* out, int B, int L, int H, int nh,
                                     int hd, int C, int G, int global_rows, float sm_scale,
                                     unsigned int thr, float keep_prob, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto run = [&](auto tag) {
    using F = decltype(tag);
    const auto c = [](const void* p) { return static_cast<const F*>(p); };
    const auto m = [](void* p) { return static_cast<F*>(p); };
    return spk::sliding_train_fwd<F>(c(hidden), i32(mask), i32(glob), i32(seed), c(wqkv),
                                     f32(bqkv), c(wgq), f32(bgq), c(wgkv), f32(bgkv), c(wo),
                                     f32(bo), static_cast<int32_t*>(counts), m(qkv_buf),
                                     m(gkv_buf), m(ctx_buf), m(out), B, L, H, nh, hd, C, G,
                                     global_rows, sm_scale, thr, keep_prob, s);
  };
  cudaError_t err = dtype == 0   ? run(float{})
                    : dtype == 1 ? run(__nv_bfloat16{})
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int spk_sliding_train_bwd(int dtype, const void* hidden, const void* mask,
                                     const void* glob, const void* seed, const void* wqkv,
                                     const void* bqkv, const void* wgq, const void* bgq,
                                     const void* wgkv, const void* bgkv, const void* wo,
                                     const void* w_all, const void* g, void* counts,
                                     void* qkv_buf, void* gkv_buf, void* ctx_buf, void* dctx_buf,
                                     void* stats, void* gstats, void* qg_buf, void* dproj,
                                     void* ds_buf, void* dx, void* dw_all, void* db_all,
                                     void* dwo, void* dbo,
                                     void* ws, size_t ws_floats, int splits_proj, int splits_out,
                                     int B, int L, int H, int nh, int hd, int C, int G,
                                     int global_rows, float sm_scale, unsigned int thr,
                                     float keep_prob, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto mf = [](void* p) { return static_cast<float*>(p); };
  const auto run = [&](auto tag) {
    using F = decltype(tag);
    const auto c = [](const void* p) { return static_cast<const F*>(p); };
    const auto m = [](void* p) { return static_cast<F*>(p); };
    return spk::sliding_train_bwd<F>(
        c(hidden), i32(mask), i32(glob), i32(seed), c(wqkv), f32(bqkv), c(wgq), f32(bgq),
        c(wgkv), f32(bgkv), c(wo), c(w_all), c(g), static_cast<int32_t*>(counts), m(qkv_buf),
        m(gkv_buf), m(ctx_buf), m(dctx_buf), mf(stats), mf(gstats), m(qg_buf), m(dproj),
        m(ds_buf), m(dx),
        mf(dw_all), mf(db_all), mf(dwo), mf(dbo), mf(ws), ws_floats, splits_proj, splits_out, B,
        L, H, nh, hd, C, G, global_rows, sm_scale, thr, keep_prob, s);
  };
  cudaError_t err = dtype == 0   ? run(float{})
                    : dtype == 1 ? run(__nv_bfloat16{})
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// band (B, nh, L / C, C, 3C), gcol (B, nh, L, G), grow (B, nh, G, L) uint8:
// where the training kernels keep a probability for this seed and threshold.
extern "C" int spk_sliding_dropout_mask(const void* seed, void* band, void* gcol, void* grow,
                                        int B, int nh, int L, int C, int G, unsigned int thr,
                                        void* stream) {
  spk::sliding_mask_kernel<<<1024, spk::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seed), static_cast<uint8_t*>(band), static_cast<uint8_t*>(gcol),
      static_cast<uint8_t*>(grow), B, nh, L, C, G, thr);
  return static_cast<int>(cudaGetLastError());
}
