// Training BigBird attention block for the H100 (sm_90a), forward and
// backward:
//   out = attn(x) Wo + bo
// with attn the ITC block-sparse attention of bigbird_attention.cuh and
// dropout on the window, global-column, random and global-row
// probabilities. Residual, LayerNorm and hidden-state dropout stay in
// PyTorch.
//
// Replaces the TPU kernels of spokennlp_tpu/ops/pallas/train_bigbird.py,
// bigbird_attention_block_train: _bigbird_train_fwd_kernel and
// _bigbird_train_bwd_kernel (the custom VJP of make_bigbird_attention_train).
//
// Numerics follow the TPU kernel: q pre-scaled and rounded, k, v rounded;
// e = exp(s - m) rounded as in bigbird_attention.cuh; the backward forms
// dS = round(p_eff dp - p rowsum(dp p_eff)) over all pieces of a row
// together, takes the global rows' dq from their dense pass, rounds dq before
// scaling it by sm_scale, sums dk and dv over every row that reaches a key in
// float32 before rounding them, and returns the weight and bias gradients in
// float32 summed over the batch.
//
// What bounds it here. At the recipe's micro-batch (B=2, L=2048, H=768, 12
// heads of 64, blocks of 64) the forward is about 27 GFLOP and the backward,
// which recomputes the forward's projections and attention, about 80 GFLOP,
// against some 15 MB (forward) and 40 MB (backward) of inputs, weights and
// outputs in bf16: bound by arithmetic. In bf16 every product of the
// projections runs bf16_gemm.cuh's tensor-core tile, forward and backward
// (dctx and dx with a weight read transposed, the two weight gradients), and
// the backward's gradient kernels bigbird_dq and bigbird_dkv run
// attention_grad_mma.cuh's tensor-core body (S, dP and the dq, dk, dv
// products on mma.sync; the softmax gradient with its Philox draw on the
// fragments in registers). The rows kernel (the forward's attention and the
// backward's statistics pass) runs attention_rows_mma.cuh's tensor-core body
// (S, dP and P.V on mma.sync; the mask, the rounded exponent and the Philox
// draw on the fragments); float32 runs every attention kernel on the CUDA
// cores.
// In float32 every product, forward and backward, runs tf32x3_gemm.cuh's
// 3xTF32 tensor-core tile through the same launchers; the projections the
// backward recomputes take the forward's kernel and tile, so it
// differentiates the forward's own values.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// ran one grid step per sequence and scatter-added each query block's dk and
// dv into a VMEM accumulator at its window, global and random key blocks,
// and summed the weight gradients over the sequential batch grid. Hopper
// blocks run in parallel, so every sum has one owner:
//   forward  the launches of bigbird_block.cu with dropout, then ctx . Wo +
//            bo (gemm_bias_act_kernel, bf16_gemm.cuh);
//   backward 1. counts and projections recomputed; dctx = g . Wo^T rounded;
//            2. bigbird_rows_kernel<kGrad>: ctx again (for dWo) and the row
//               statistics (m, D, rowsum(dp p_eff)) of every row, the global
//               rows' from their dense pass;
//            3. bigbird_dkv_kernel: per (KEY tile, head, sequence) dk and dv
//               summed over the query tiles that reach it: the window blocks
//               around it, the query blocks whose random entries hold it (an
//               inverse table, built on the host from the same static table),
//               every non-global block when it is a global block, and the
//               global rows. Each block owns its keys: no atomics, the same
//               order on every run. In bf16 it also stores each dS once
//               (bigbird_ds_tile);
//            4. bigbird_dq_kernel: per (query tile, head, sequence) dq over
//               the key tiles the forward visited, from those dS tiles in
//               bf16;
//            5. dx = [dq dk dv] . Wqkv^T in one GEMM, and dWqkv = x^T [dq dk
//               dv] and dWo = ctx^T g in launch_weight_grad (bf16_gemm.cuh):
//               each block owns a tile of a weight gradient and a fixed range
//               of the B*L rows, whose partial sums are added in order after
//               it, so the batch sum is deterministic; the bias gradients
//               come from the same pass.
// Saved between the passes: the inputs and the seed only; the scores and
// probabilities are recomputed tile by tile in each kernel (in bf16, dS
// passes from step 3 to step 4 through device memory).
#include "attention_grad_mma.cuh"
#include "bigbird_attention.cuh"

namespace spk {
namespace {

// The stored dS tile of query tile qt (the grid's first index) and key-tile
// slot t (key_tile's t) of (b, h) = bh: the G S query tiles of the global
// rows hold ceil(L / 64) slots each, the others (3 + G + R) S.
__host__ __device__ __forceinline__ size_t bigbird_ds_tile(const BigBird& bb, size_t bh, int qt,
                                                          int t) {
  const int gq = bb.G * bb.S, nkt = (bb.L + kTile - 1) / kTile, K = (3 + bb.G + bb.R) * bb.S;
  const size_t per = (size_t)gq * nkt + (size_t)(bb.nb * bb.S - gq) * K;
  return (bh * per + (qt < gq ? (size_t)qt * nkt + t : (size_t)gq * nkt + (size_t)(qt - gq) * K + t)) *
         kDsTile;
}

template <typename T, int HD>
constexpr size_t bigbird_dq_smem_bytes() {
  if constexpr (std::is_same<T, float>::value) {
    return sizeof(float) * (4 * (size_t)Geometry<HD>::kTileFloats + (size_t)kTile * kPS);
  } else {
    return grad_dq_smem_mma<HD>();
  }
}

// dS of one (row, key) pair, rounded to T, and p_eff, from the row's
// statistics; the softmax-with-dropout backward of the TPU kernel
template <typename T>
__device__ __forceinline__ void bigbird_score_grad(float s, float dp, float m, float d_sum,
                                                   float rs, bool keep, float keep_prob,
                                                   float& ds, float& p_eff) {
  const float e = rounded_exp<T>(s, m);
  p_eff = keep ? e / (d_sum * keep_prob) : 0.0f;
  ds = round_to<T>(p_eff * dp - (e / d_sum) * rs);
}

// dq of one (query tile, head, sequence): sum over the key tiles of dS . k;
// stored as round(round(dq) * sm_scale) into slot 0 of dproj (B*L rows of
// stride ld). Grid (nb S, nh, B). float32 on the CUDA cores (256 threads)
// forms dS itself; bf16 on the tensor cores (128 threads,
// attention_grad_mma.cuh) reads the dS tiles bigbird_dkv_kernel stored in
// ds_in (bigbird_ds_tile).
template <typename T, int HD>
__global__ void __launch_bounds__(grad_threads<T>(), grad_min_blocks<T, HD>())
    bigbird_dq_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ counts, BigBird bb,
                      const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                      const float* __restrict__ stats, const T* __restrict__ ds_in,
                      T* __restrict__ dproj, int B, int nh, int ld, float sm_scale, uint32_t thr,
                      float keep_prob) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!std::is_same<T, float>::value) {
    using Mm = GradMma<HD>;
    unsigned char* ring = reinterpret_cast<unsigned char*>(smem);  // stage s: k, then dS
    int i, q0, q_end;
    block_tile(bb, blockIdx.x, i, q0, q_end);
    const int h = blockIdx.y, b = blockIdx.z, L = bb.L;
    const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
    const T* K = qkv + (((size_t)1 * B + b) * nh + h) * (size_t)L * HD;
    const int n_valid = counts[2 * b];
    const int nt = key_tiles(bb, i, n_valid);
    const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
    const bool live = q0 + 16 * warp < q_end;  // warp-uniform
    float dq[HD / 8][4];
    zero_acc<HD>(dq);
    const GradLane<HD> lane;
    const auto stage_of = [&](int s) { return ring + s * grad_dq_stage_bytes<HD>(); };
    grad_ring(
        nt,
        [&](int t) {
          KeyTile kt;
          while (t < nt && !key_tile(bb, i, t, n_valid, kt)) ++t;
          return t;
        },
        [&](int s, int t) {
          KeyTile kt;
          key_tile(bb, i, t, n_valid, kt);
          stage_grad_rows<HD>(K, HD, kt.k0, 0, L, stage_of(s));
          stage_ds_tile(ds_in + bigbird_ds_tile(bb, (size_t)b * nh + h, blockIdx.x, t),
                        stage_of(s) + Mm::kTileBytes);
        },
        [&](int s, int t) {
          if (live)
            dq_from_ds_tile<HD>(smem_addr(stage_of(s) + Mm::kTileBytes), smem_addr(stage_of(s)),
                                lane, dq);
        });
    if (!live) return;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int l = hi ? r_hi : r_lo;
      if (l < q_end)
        store_acc_row<HD>(dq, hi, dproj + ((size_t)b * L + l) * ld + (size_t)h * HD,
                          [&](float v) { return round_to<T>(v) * sm_scale; });
    }
    return;
  } else {
  using G = Geometry<HD>;
  float* Qs = smem;
  float* Ks = Qs + G::kTileFloats;
  float* Vs = Ks + G::kTileFloats;
  float* dCs = Vs + G::kTileFloats;
  float* Ps = dCs + G::kTileFloats;

  int i, q0, q_end;
  block_tile(bb, blockIdx.x, i, q0, q_end);
  const int h = blockIdx.y, b = blockIdx.z, L = bb.L;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t head = (size_t)L * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const T* K = qkv + (((size_t)1 * B + b) * nh + h) * head;
  const T* V = qkv + (((size_t)2 * B + b) * nh + h) * head;
  const int n_valid = counts[2 * b];
  const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;
  const size_t plane = (size_t)B * nh * L;
  const int nt = key_tiles(bb, i, n_valid);

  load_head_tile<T, HD>(Qs, Q, q0, L);
  load_row_tile<T, HD>(dCs, dctx, b, h, q0, L, nh);
  float m[4], d_sum[4], rs[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int l = q0 + ty + 16 * a;
    const size_t r = ((size_t)b * nh + h) * L + (l < q_end ? l : q0);
    m[a] = stats[r];
    d_sum[a] = stats[plane + r];
    rs[a] = stats[2 * plane + r];
  }
  float dq[4][G::TD];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < G::TD; ++c) dq[a][c] = 0.0f;

  for (int t = 0; t < nt; ++t) {
    KeyTile kt;
    if (!key_tile(bb, i, t, n_valid, kt)) continue;
    __syncthreads();
    load_head_tile<T, HD>(Ks, K, kt.k0, L);
    load_head_tile<T, HD>(Vs, V, kt.k0, L);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(Qs, Ks, s);
    tile_dot<HD>(dCs, Vs, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c, key = kt.k0 + col;
        float ds = 0.0f, p_eff;
        if (row < q_end && key < kt.k_end) {
          const bool keep = keep_prob_bits(seed, thr, b, h | kt.tag, row, key + kt.col_off);
          bigbird_score_grad<T>(s[a][c], dp[a][c], m[a], d_sum[a], rs[a], keep, keep_prob, ds,
                                p_eff);
        }
        Ps[(ty + 16 * a) * kPS + col] = ds;
      }
    }
    __syncthreads();
    tile_accumulate<HD>(Ps, Ks, dq);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int l = q0 + ty + 16 * a;
    if (l >= q_end) continue;
    T* out = dproj + ((size_t)b * L + l) * ld + (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < G::TD; ++c)
      out[tx + 16 * c] = from_f32<T>(round_to<T>(dq[a][c]) * sm_scale);
  }
  }
}

template <typename T, int HD>
constexpr size_t bigbird_dkv_smem_bytes() {
  if constexpr (std::is_same<T, float>::value) {
    return sizeof(float) * (4 * (size_t)Geometry<HD>::kTileFloats + 2 * (size_t)kTile * kPS +
                            3 * (size_t)kTile);
  } else {
    return grad_dkv_smem_mma<HD>();
  }
}

// One query tile that reaches a key block: its block, its first row, the
// dropout tag and the offset from key to the counter's column.
struct QueryTile {
  int i, q0;
  uint32_t tag;
  int col_off;
};

// The query tiles that reach key block j, in a fixed order: the window
// blocks j - 1, j, j + 1 (j >= G), the random entries of the inverse table,
// every non-global block (j < G: the global columns), and the global rows.
// Tile t of them; false when it does not exist. The same for every thread of
// a block.
__device__ __forceinline__ bool query_tile_of(const BigBird& bb, const int32_t* inv_off,
                                              const int32_t* inv, int j, int t, QueryTile& qt) {
  const int S = bb.S;
  const int n_win = j >= bb.G ? 3 * S : 0;
  const int n_rand = (inv_off[j + 1] - inv_off[j]) * S;
  const int n_gcol = j < bb.G ? (bb.nb - bb.G) * S : 0;
  qt.tag = 0u;
  qt.col_off = 0;
  int sub;
  if (t < n_win) {
    qt.i = j - 1 + t / S;
    sub = t % S;
    if (qt.i < bb.G || qt.i >= bb.nb) return false;
  } else if ((t -= n_win) < n_rand) {
    const int e = inv[inv_off[j] + t / S];
    const int r = e % bb.R;
    qt.i = e / bb.R;
    sub = t % S;
    qt.tag = kRandomStream;
    qt.col_off = (r - j) * bb.C;
  } else if ((t -= n_rand) < n_gcol) {
    qt.i = bb.G + t / S;
    sub = t % S;
    qt.tag = kGlobalColStream;
  } else {
    t -= n_gcol;
    qt.i = t / S;
    sub = t % S;
    qt.tag = kGlobalRowStream;
  }
  qt.q0 = qt.i * bb.C + sub * kTile;
  return true;
}

// dk and dv of one (KEY tile, head, sequence): sums of dS^T . q and
// round(p_eff)^T . dctx over the query tiles that reach its keys, stored
// rounded into slots 1 and 2 of dproj. Grid (nb S, nh, B). In float32 (256
// threads) thread (ty, tx) owns keys ty + 16 a and, in the score tiles,
// queries tx + 16 c; in bf16 (128 threads) warp w owns keys 16 w .. 16 w +
// 15 and forms S^T = k q^T and dP^T = v dctx^T on the tensor cores, whose
// dS^T and p_eff^T are the A fragments of dk += dS^T q and dv += p_eff^T
// dctx; it also stores every dS in ds_out's tiles, which bigbird_dq_kernel
// reads (bigbird_ds_tile).
template <typename T, int HD>
__global__ void __launch_bounds__(grad_threads<T>(), grad_min_blocks<T, HD>())
    bigbird_dkv_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ counts, BigBird bb,
                       const int32_t* __restrict__ inv_off, const int32_t* __restrict__ inv,
                       const int32_t* __restrict__ seed_ptr, const T* __restrict__ dctx,
                       const float* __restrict__ stats, T* __restrict__ ds_out,
                       T* __restrict__ dproj, int B, int nh, int ld, uint32_t thr,
                       float keep_prob) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!std::is_same<T, float>::value) {
    using Mm = GradMma<HD>;
    unsigned char* Ks = reinterpret_cast<unsigned char*>(smem);
    unsigned char* Vs = Ks + Mm::kTileBytes;
    unsigned char* ring = Vs + Mm::kTileBytes;  // stage s: q, dctx, then m, D, rowsum
    int j, k0, k_end;
    block_tile(bb, blockIdx.x, j, k0, k_end);
    const int h = blockIdx.y, b = blockIdx.z, L = bb.L, S = bb.S;
    const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
    const size_t head = (size_t)L * HD, HN = (size_t)nh * HD;
    const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
    const T* K = qkv + (((size_t)1 * B + b) * nh + h) * head;
    const T* V = qkv + (((size_t)2 * B + b) * nh + h) * head;
    const int n_valid = counts[2 * b];
    const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;
    const size_t plane = (size_t)B * nh * L;
    const float* st0 = stats + ((size_t)b * nh + h) * L;
    const int key_end = min(k_end, n_valid);

    stage_grad_rows<HD>(K, HD, k0, 0, L, Ks);
    stage_grad_rows<HD>(V, HD, k0, 0, L, Vs);
    const int key_lo = k0 + 16 * warp + g, key_hi = key_lo + 8;
    const bool live = k0 + 16 * warp < k_end;  // warp-uniform
    float dk[HD / 8][4], dv[HD / 8][4];
    zero_acc<HD>(dk);
    zero_acc<HD>(dv);
    const GradLane<HD> lane;
    // no real key here: nothing reaches the tile
    const int nq = k0 < n_valid ? (j >= bb.G ? 3 * S : 0) + (inv_off[j + 1] - inv_off[j]) * S +
                                      (j < bb.G ? (bb.nb - bb.G) * S : 0) + bb.G * S
                                : 0;
    const auto stage_of = [&](int s) { return ring + s * grad_dkv_stage_bytes<HD>(); };
    grad_ring(
        nq,
        [&](int t) {
          QueryTile qt;
          while (t < nq && !query_tile_of(bb, inv_off, inv, j, t, qt)) ++t;
          return t;
        },
        [&](int s, int t) {
          QueryTile qt;
          query_tile_of(bb, inv_off, inv, j, t, qt);
          const int q_end = min(qt.q0 + kTile, (qt.i + 1) * bb.C);
          unsigned char* st = stage_of(s);
          stage_grad_rows<HD>(Q, HD, qt.q0, 0, L, st);
          stage_grad_rows<HD>(dctx + (size_t)b * L * HN + (size_t)h * HD, HN, qt.q0, 0, L,
                              st + Mm::kTileBytes);
          float* sf = reinterpret_cast<float*>(st + 2 * Mm::kTileBytes);
          stage_grad_stats(st0, qt.q0, 0, q_end, sf);
          stage_grad_stats(st0 + plane, qt.q0, 0, q_end, sf + kTile);
          stage_grad_stats(st0 + 2 * plane, qt.q0, 0, q_end, sf + 2 * kTile);
        },
        [&](int s, int t) {
          if (!live) return;
          QueryTile qt;
          query_tile_of(bb, inv_off, inv, j, t, qt);
          const int q_end = min(qt.q0 + kTile, (qt.i + 1) * bb.C);
          const unsigned char* st = stage_of(s);
          const float* m_s = reinterpret_cast<const float*>(st + 2 * Mm::kTileBytes);
          const float* d_s = m_s + kTile;
          const float* rs_s = d_s + kTile;
          grad_tile_mma<HD>(
              smem_addr(Ks), smem_addr(Vs), smem_addr(st), smem_addr(st + Mm::kTileBytes), lane,
              [&](float sc, float dp, int hi, int col, float& pe) {
                const int key = hi ? key_hi : key_lo, row = qt.q0 + col;
                if (row >= q_end || key >= key_end) return 0.0f;
                const bool keep = keep_prob_bits(seed, thr, b, h | qt.tag, row, key + qt.col_off);
                float ds;
                bigbird_score_grad<T>(sc, dp, m_s[col], d_s[col], rs_s[col], keep, keep_prob, ds,
                                      pe);
                return ds;
              },
              // dS of rows (row, row + 1) at key into the dq pass's tile of
              // this query tile and the key's tile in its key_tile order
              [&](int hi, int col, float d0, float d1) {
                const int key = hi ? key_hi : key_lo;
                if (key >= k_end) return;
                int t = key / kTile, kin = key % kTile;  // a global row: every key tile
                if (qt.tag != kGlobalRowStream) {
                  const int piece = qt.tag == kGlobalColStream ? 3 + j
                                    : qt.tag == kRandomStream ? 3 + bb.G + qt.col_off / bb.C + j
                                                              : j - qt.i + 1;
                  t = piece * S + blockIdx.x % S;
                  kin = key - k0;
                }
                const int qtile = qt.i * S + (qt.q0 - qt.i * bb.C) / kTile;
                T* dst = ds_out + bigbird_ds_tile(bb, (size_t)b * nh + h, qtile, t) +
                         kin * kTile + col;
                *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(d0, d1);
              },
              dk, dv);
        });
    if (!live) return;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int l = hi ? key_hi : key_lo;
      if (l >= k_end) continue;
      T* out = dproj + ((size_t)b * L + l) * ld + (size_t)h * HD;
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

  int j, k0, k_end;
  block_tile(bb, blockIdx.x, j, k0, k_end);
  const int h = blockIdx.y, b = blockIdx.z, L = bb.L, S = bb.S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t head = (size_t)L * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const T* K = qkv + (((size_t)1 * B + b) * nh + h) * head;
  const T* V = qkv + (((size_t)2 * B + b) * nh + h) * head;
  const int n_valid = counts[2 * b];
  const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;
  const size_t plane = (size_t)B * nh * L;
  const size_t stat0 = ((size_t)b * nh + h) * L;
  const int key_end = min(k_end, n_valid);

  load_head_tile<T, HD>(Ks, K, k0, L);
  load_head_tile<T, HD>(Vs, V, k0, L);
  float dk[4][G::TD], dv[4][G::TD];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < G::TD; ++c) dk[a][c] = dv[a][c] = 0.0f;

  // no real key here: nothing reaches the tile
  const int nq = k0 < n_valid ? (j >= bb.G ? 3 * S : 0) + (inv_off[j + 1] - inv_off[j]) * S +
                                    (j < bb.G ? (bb.nb - bb.G) * S : 0) + bb.G * S
                              : 0;
  for (int t = 0; t < nq; ++t) {
    QueryTile qt;
    if (!query_tile_of(bb, inv_off, inv, j, t, qt)) continue;
    const int q_end = min(qt.q0 + kTile, (qt.i + 1) * bb.C);
    __syncthreads();
    load_head_tile<T, HD>(Qs, Q, qt.q0, L);
    load_row_tile<T, HD>(dCs, dctx, b, h, qt.q0, L, nh);
    if (threadIdx.x < kTile) {
      const int l = qt.q0 + threadIdx.x;
      const bool in = l < q_end;
      m_s[threadIdx.x] = in ? stats[stat0 + l] : 0.0f;
      d_s[threadIdx.x] = in ? stats[plane + stat0 + l] : 1.0f;
      rs_s[threadIdx.x] = in ? stats[2 * plane + stat0 + l] : 0.0f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(Ks, Qs, s);  // s[a][c]: key ty + 16 a, query tx + 16 c
    tile_dot<HD>(Vs, dCs, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int key = k0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c, row = qt.q0 + col;
        float ds = 0.0f, p_eff = 0.0f;
        if (row < q_end && key < key_end) {
          const bool keep = keep_prob_bits(seed, thr, b, h | qt.tag, row, key + qt.col_off);
          bigbird_score_grad<T>(s[a][c], dp[a][c], m_s[col], d_s[col], rs_s[col], keep,
                                keep_prob, ds, p_eff);
        }
        dSs[(ty + 16 * a) * kPS + col] = ds;
        Pes[(ty + 16 * a) * kPS + col] = round_to<T>(p_eff);
      }
    }
    __syncthreads();
    tile_accumulate<HD>(dSs, Qs, dk);
    tile_accumulate<HD>(Pes, dCs, dv);
  }

  const size_t HN = (size_t)nh * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int l = k0 + ty + 16 * a;
    if (l >= k_end) continue;
    T* out = dproj + ((size_t)b * L + l) * ld + (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < G::TD; ++c) {
      out[HN + tx + 16 * c] = from_f32<T>(dk[a][c]);
      out[2 * HN + tx + 16 * c] = from_f32<T>(dv[a][c]);
    }
  }
  }
}

template <typename T>
cudaError_t bigbird_train_fwd(const T* hidden, const int32_t* mask, const int32_t* rand,
                              const int32_t* rok, const int32_t* seed, const T* wqkv,
                              const float* bqkv, const T* wo, const float* bo, int32_t* counts,
                              T* qkv_buf, T* ctx_buf, T* out, int B, int L, int H, int nh, int hd,
                              int C, int G, int R, float sm_scale, uint32_t thr, float keep_prob,
                              cudaStream_t stream) {
  cudaError_t err = bigbird_projections<T>(hidden, mask, wqkv, bqkv, counts, qkv_buf, B, L, H, nh,
                                           hd, sm_scale, stream);
  if (err != cudaSuccess) return err;
  const BigBird bb = make_bigbird(L, C, G, R, rand, rok);
  err = bigbird_attention<T, false>(bb, seed, counts, qkv_buf, nullptr, ctx_buf, nullptr, B, nh, hd,
                                    thr, keep_prob, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(ctx_buf, wo, bo, out, B * L, H, nh * hd, kActNone, nullptr, stream);
}

template <typename T>
cudaError_t bigbird_train_bwd(const T* hidden, const int32_t* mask, const int32_t* rand,
                              const int32_t* rok, const int32_t* inv_off, const int32_t* inv,
                              const int32_t* seed, const T* wqkv, const float* bqkv, const T* wo,
                              const T* g, int32_t* counts, T* qkv_buf, T* ctx_buf, T* dctx_buf,
                              float* stats, T* dproj, T* ds_buf, T* dx, float* dwqkv,
                              float* dbqkv, float* dwo, float* dbo, float* ws, size_t ws_floats,
                              int splits_proj, int splits_out, int B, int L, int H, int nh, int hd,
                              int C, int G, int R, float sm_scale, uint32_t thr, float keep_prob,
                              cudaStream_t stream) {
  const int M = B * L, HN = nh * hd, ld = 3 * HN;
  cudaError_t err = bigbird_projections<T>(hidden, mask, wqkv, bqkv, counts, qkv_buf, B, L, H, nh,
                                           hd, sm_scale, stream);
  if (err != cudaSuccess) return err;
  // dctx = g . Wo^T, rounded (Wo is (Hn, H): read transposed)
  err = launch_gemm<T, true>(g, wo, nullptr, dctx_buf, M, HN, H, kActNone, nullptr, stream);
  if (err != cudaSuccess) return err;
  const BigBird bb = make_bigbird(L, C, G, R, rand, rok);
  err = bigbird_attention<T, true>(bb, seed, counts, qkv_buf, dctx_buf, ctx_buf, stats, B, nh, hd,
                                   thr, keep_prob, stream);
  if (err != cudaSuccess) return err;
  err = with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    const dim3 grid(bb.nb * bb.S, nh, B);
    constexpr int threads = grad_threads<T>();
    cudaError_t e = cudaSuccess;
    if (ds_buf != nullptr && C % kTile) {  // bf16
      // tiles that no block fills whole: what the dk/dv pass leaves stays zero
      e = cudaMemsetAsync(ds_buf, 0, bigbird_ds_tile(bb, (size_t)B * nh, 0, 0) * sizeof(T),
                          stream);
      if (e != cudaSuccess) return e;
    }
    auto dkv = bigbird_dkv_kernel<T, HD>;
    if ((e = prepare(dkv, bigbird_dkv_smem_bytes<T, HD>())) != cudaSuccess) return e;
    dkv<<<grid, threads, bigbird_dkv_smem_bytes<T, HD>(), stream>>>(
        qkv_buf, counts, bb, inv_off, inv, seed, dctx_buf, stats, ds_buf, dproj, B, nh, ld, thr,
        keep_prob);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    auto dq = bigbird_dq_kernel<T, HD>;
    if ((e = prepare(dq, bigbird_dq_smem_bytes<T, HD>())) != cudaSuccess) return e;
    dq<<<grid, threads, bigbird_dq_smem_bytes<T, HD>(), stream>>>(
        qkv_buf, counts, bb, seed, dctx_buf, stats, ds_buf, dproj, B, nh, ld, sm_scale, thr,
        keep_prob);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  // dx = dproj . Wqkv^T (Wqkv is (H, 3 Hn): read transposed)
  err = launch_gemm<T, true>(dproj, wqkv, nullptr, dx, M, H, ld, kActNone, nullptr, stream);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad<T>(hidden, dproj, dwqkv, dbqkv, ws, ws_floats, splits_proj, M, H, ld,
                              stream);
  if (err != cudaSuccess) return err;
  return launch_weight_grad<T>(ctx_buf, g, dwo, dbo, ws, ws_floats, splits_out, M, HN, H, stream);
}

// The four keep masks of one seed, as the kernels draw them: window (B, nh,
// nb, C, 3C) at (row = i C + ci, key = i C - C + cj, wrapped to 32 bits),
// global columns (B, nh, L, GC) at (row, key), random (B, nh, L, RC) at
// (row, column r C + c), global rows (B, nh, GC, L) at (row, key); GC = G C,
// RC = R C.
__global__ void bigbird_mask_kernel(const int32_t* __restrict__ seed_ptr,
                                    uint8_t* __restrict__ win, uint8_t* __restrict__ gcol,
                                    uint8_t* __restrict__ rnd, uint8_t* __restrict__ grow, int B,
                                    int nh, int L, int C, int G, int R, uint32_t thr) {
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const size_t GC = (size_t)G * C, RC = (size_t)R * C;
  const size_t rows = (size_t)B * nh * L;
  const size_t n_win = rows * 3 * C, n_g = rows * GC, n_r = rows * RC;
  for (size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x; x < n_win + 2 * n_g + n_r;
       x += (size_t)gridDim.x * blockDim.x) {
    if (x < n_win) {
      const int cj = (int)(x % (3 * C));
      const size_t r = x / (3 * C);  // (b, h, row)
      const int row = (int)(r % L), h = (int)((r / L) % nh), b = (int)(r / ((size_t)L * nh));
      win[x] = keep_prob_bits(seed, thr, b, h, row, row - row % C - C + cj);
    } else if (x < n_win + n_g) {
      const size_t y = x - n_win;
      const int key = (int)(y % GC);
      const size_t r = y / GC;
      const int row = (int)(r % L), h = (int)((r / L) % nh), b = (int)(r / ((size_t)L * nh));
      gcol[y] = keep_prob_bits(seed, thr, b, h | kGlobalColStream, row, key);
    } else if (x < n_win + n_g + n_r) {
      const size_t y = x - n_win - n_g;
      const int col = (int)(y % RC);
      const size_t r = y / RC;
      const int row = (int)(r % L), h = (int)((r / L) % nh), b = (int)(r / ((size_t)L * nh));
      rnd[y] = keep_prob_bits(seed, thr, b, h | kRandomStream, row, col);
    } else {
      const size_t y = x - n_win - n_g - n_r;
      const int key = (int)(y % L);
      const size_t r = y / L;
      const int row = (int)(r % GC), h = (int)((r / GC) % nh), b = (int)(r / (GC * nh));
      grow[y] = keep_prob_bits(seed, thr, b, h | kGlobalRowStream, row, key);
    }
  }
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (hidden, weights, g, the element-type
// buffers and out/dx); mask (B, L), rand and rok (nb, max(R, 1)), inv_off
// (nb + 1), inv, seed (1,) and counts (B, 2) int32; biases, stats (3, B, nh,
// L) and the weight and bias gradients float32. wqkv (H, 3 nh hd), wo (nh hd,
// H); dproj (B*L, 3 nh hd). thr = 0 turns dropout off (seed may then be
// null). ds_buf (bf16; null in float32) holds the 64 x 64 dS tiles of
// bigbird_ds_tile (B nh (G S ceil(L / 64) + (nb - G) S
// (3 + G + R) S) of them) that the dk/dv pass writes and the dq pass reads.
// Each entry returns the first CUDA error, or 0.
extern "C" int spk_bigbird_train_fwd(int dtype, const void* hidden, const void* mask,
                                     const void* rand, const void* rok, const void* seed,
                                     const void* wqkv, const void* bqkv, const void* wo,
                                     const void* bo, void* counts, void* qkv_buf, void* ctx_buf,
                                     void* out, int B, int L, int H, int nh, int hd, int C, int G,
                                     int R, float sm_scale, unsigned int thr, float keep_prob,
                                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto run = [&](auto tag) {
    using F = decltype(tag);
    const auto c = [](const void* p) { return static_cast<const F*>(p); };
    const auto m = [](void* p) { return static_cast<F*>(p); };
    return spk::bigbird_train_fwd<F>(c(hidden), i32(mask), i32(rand), i32(rok), i32(seed),
                                     c(wqkv), f32(bqkv), c(wo), f32(bo),
                                     static_cast<int32_t*>(counts), m(qkv_buf), m(ctx_buf),
                                     m(out), B, L, H, nh, hd, C, G, R, sm_scale, thr, keep_prob,
                                     s);
  };
  cudaError_t err = dtype == 0   ? run(float{})
                    : dtype == 1 ? run(__nv_bfloat16{})
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int spk_bigbird_train_bwd(int dtype, const void* hidden, const void* mask,
                                     const void* rand, const void* rok, const void* inv_off,
                                     const void* inv, const void* seed, const void* wqkv,
                                     const void* bqkv, const void* wo, const void* g,
                                     void* counts, void* qkv_buf, void* ctx_buf, void* dctx_buf,
                                     void* stats, void* dproj, void* ds_buf, void* dx,
                                     void* dwqkv,
                                     void* dbqkv, void* dwo, void* dbo, void* ws,
                                     size_t ws_floats, int splits_proj, int splits_out, int B,
                                     int L, int H, int nh, int hd, int C, int G, int R,
                                     float sm_scale, unsigned int thr, float keep_prob,
                                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto mf = [](void* p) { return static_cast<float*>(p); };
  const auto run = [&](auto tag) {
    using F = decltype(tag);
    const auto c = [](const void* p) { return static_cast<const F*>(p); };
    const auto m = [](void* p) { return static_cast<F*>(p); };
    return spk::bigbird_train_bwd<F>(
        c(hidden), i32(mask), i32(rand), i32(rok), i32(inv_off), i32(inv), i32(seed), c(wqkv),
        f32(bqkv), c(wo), c(g), static_cast<int32_t*>(counts), m(qkv_buf), m(ctx_buf),
        m(dctx_buf), mf(stats), m(dproj), m(ds_buf), m(dx), mf(dwqkv), mf(dbqkv), mf(dwo),
        mf(dbo), mf(ws),
        ws_floats, splits_proj, splits_out, B, L, H, nh, hd, C, G, R, sm_scale, thr, keep_prob, s);
  };
  cudaError_t err = dtype == 0   ? run(float{})
                    : dtype == 1 ? run(__nv_bfloat16{})
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// win (B, nh, nb, C, 3C), gcol (B, nh, L, GC), rnd (B, nh, L, RC), grow (B,
// nh, GC, L) uint8: where the training kernels keep a probability for this
// seed and threshold.
extern "C" int spk_bigbird_dropout_mask(const void* seed, void* win, void* gcol, void* rnd,
                                        void* grow, int B, int nh, int L, int C, int G, int R,
                                        unsigned int thr, void* stream) {
  spk::bigbird_mask_kernel<<<1024, spk::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seed), static_cast<uint8_t*>(win), static_cast<uint8_t*>(gcol),
      static_cast<uint8_t*>(rnd), static_cast<uint8_t*>(grow), B, nh, L, C, G, R, thr);
  return static_cast<int>(cudaGetLastError());
}
