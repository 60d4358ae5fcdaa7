// BigBird attention (ITC block-sparse) on the H100: the pieces the inference
// block (bigbird_block.cu) and the training block (train_bigbird.cu) share.
//
// Semantics, per sequence b with n_valid real tokens (padding is a suffix),
// blocks of C rows, nb = L / C blocks, G global blocks, R random blocks a
// query block, q = (x Wq + bq) * sm_scale, k, v = x Wk + bk, x Wv + bv, all
// three rounded to the element type:
//   - a row of block i >= G attends to the real keys of the window blocks
//     i - 1, i, i + 1 (those in [G, nb)), of the G global blocks and of its R
//     random blocks (rand[i, r], where rok[i, r] is 1), one softmax (one max)
//     over all of them; every key counts once: the random blocks never repeat
//     a window or global block (the table's first-occurrence dedup is the rok
//     flag), and the window skips the global blocks, which have their own
//     columns;
//   - a row of block i < G (a global row) attends to every real key.
// e = exp(s - m) is taken on s - m rounded to the element type and rounded
// again (the TPU kernel's compute-dtype exp), the denominator sums e in
// float32, and with dropout at rate p a probability is kept iff its Philox
// bits are >= thr and the kept ones are divided by (1 - p). A row with no
// allowed key (only with no real token at all) gets a zero context.
//
// Dropout draws one Philox word per probability from four counter spaces
// that never meet (the second counter word carries the head and a tag):
//   window keys      (b, h,           row, key)
//   global columns   (b, h | 1 << 16, row, key)        key < G C
//   global rows      (b, h | 2 << 16, row, key)        row < G C
//   random blocks    (b, h | 3 << 16, row, r C + c)    key = rand[i, r] C + c
// so the backward pass regenerates every mask from the seed.
//
// Work is cut into 64-row tiles: a block of C rows spans S = ceil(C / 64)
// query tiles (the last one short when 64 does not divide C), and each piece
// of C keys S key tiles. At BigBird-base's block of 64 a piece is one tile.
// A query tile of a global block walks the key tiles of [0, n_valid); one of
// another block walks its (3 + G + R) S pieces' tiles, skipping those with no
// allowed key. Layouts: qkv (3, B, nh, L, hd) in the element type, q
// pre-scaled; ctx (B, L, nh*hd) in its type Tc (the element type, or
// float32 in W8A8); counts (B, 2) int32 (n_valid, 0); row
// statistics (3, B, nh, L) float32 = (m, D, rowsum(dp p_eff)). Nothing of
// size (L, K C) or (L, L) is written to device memory.
#pragma once

#include "sliding_attention.cuh"

namespace spk {

constexpr uint32_t kRandomStream = 3u << 16;

// The static pattern of one call: rand and rok (nb, R) int32 on the device.
struct BigBird {
  int L, C, nb, G, R, S;
  const int32_t* rand;
  const int32_t* rok;
};

inline BigBird make_bigbird(int L, int C, int G, int R, const int32_t* rand, const int32_t* rok) {
  return BigBird{L, C, L / C, G, R, (C + kTile - 1) / kTile, rand, rok};
}

// Tile x of the grid's first axis: block i and its rows [r0, r_end).
__device__ __forceinline__ void block_tile(const BigBird& bb, int x, int& i, int& r0, int& r_end) {
  i = x / bb.S;
  r0 = i * bb.C + (x % bb.S) * kTile;
  r_end = min(r0 + kTile, (i + 1) * bb.C);
}

// The rows kernel's block order: block (blockIdx.x, y, z) of the grid
// (nb S, nh, B), taken in linear order (x fastest), works on query tile x of
// (head h, sequence b) with the G S tiles of the global blocks of every
// (head, sequence) first, then the others. A global tile walks every real
// key (up to 8 times the tiles of another at BigBird-base): in grid order
// the last heads' global tiles started late and ran on alone at the end of
// the launch (on the H100 the launch without them took 46 % of its time,
// PERF.md); started first, they run beside the short tiles.
__device__ __forceinline__ void global_first(const BigBird& bb, int nh, int& x, int& h, int& b) {
  const int gs = bb.G * bb.S, per = bb.nb * bb.S;
  const int lin = blockIdx.x + per * (blockIdx.y + nh * blockIdx.z);
  const int n_global = gs * nh * gridDim.z;
  int hb;
  if (lin < n_global) {
    x = lin % gs;
    hb = lin / gs;
  } else {
    const int r = lin - n_global, rest = per - gs;
    x = gs + r % rest;
    hb = r / rest;
  }
  h = hb % nh;
  b = hb / nh;
}

__device__ __forceinline__ int key_tiles(const BigBird& bb, int i, int n_valid) {
  return i < bb.G ? (n_valid + kTile - 1) / kTile : (3 + bb.G + bb.R) * bb.S;
}

// Key tile t of query block i (attention_rows_mma.cuh's KeyTile: keys
// [k0, k_end) allowed); false when it holds no allowed key. The same for
// every thread of a block.
__device__ __forceinline__ bool key_tile(const BigBird& bb, int i, int t, int n_valid,
                                         KeyTile& kt) {
  kt.tag = 0u;
  kt.col_off = 0;
  if (i < bb.G) {  // a global row: every real key
    kt.k0 = t * kTile;
    kt.k_end = min(kt.k0 + kTile, n_valid);
    kt.tag = kGlobalRowStream;
    return kt.k0 < kt.k_end;
  }
  const int p = t / bb.S, sub = t % bb.S;
  int j;
  if (p < 3) {
    j = i - 1 + p;
    if (j < 0 || j < bb.G || j >= bb.nb) return false;
  } else if (p < 3 + bb.G) {
    j = p - 3;
    kt.tag = kGlobalColStream;
  } else {
    const int r = p - 3 - bb.G;
    if (!bb.rok[i * bb.R + r]) return false;
    j = bb.rand[i * bb.R + r];
    kt.tag = kRandomStream;
    kt.col_off = (r - j) * bb.C;
  }
  kt.k0 = j * bb.C + sub * kTile;
  kt.k_end = min(min(kt.k0 + kTile, (j + 1) * bb.C), n_valid);
  return kt.k0 < kt.k_end;
}

// The rows of one query tile (block, head, sequence): pass 1 takes the row
// maxima over the allowed keys of every key tile, pass 2 forms e, D = sum e
// and ctx = (kept e) . v / (D keep_prob), stored rounded to Tc in (B, L,
// nh*hd). With kGrad (the backward) it also forms dp = dctx . v^T and writes
// the row statistics (m, D, rowsum(dp p_eff)). Grid (nb S, nh, B), taken in
// global_first's order, 128 threads: attention_rows_mma.cuh's tensor-core
// body, bf16 or float32 on 3xTF32, with the same callbacks (key_tile's
// tiles).
template <typename T, int HD, bool kGrad, typename Tc = T>
__global__ void __launch_bounds__(kGradThreads, core_min_blocks<T, HD>())
    bigbird_rows_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ counts,
                        BigBird bb, const int32_t* __restrict__ seed_ptr,
                        const T* __restrict__ dctx, Tc* __restrict__ ctx,
                        float* __restrict__ stats, int B, int nh, uint32_t thr, float keep_prob) {
  extern __shared__ __align__(16) float smem[];
  int x, h, b, i, q0, q_end;
  global_first(bb, nh, x, h, b);
  block_tile(bb, x, i, q0, q_end);
  const int L = bb.L;
  const size_t head = (size_t)L * HD, HN = (size_t)nh * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const int n_valid = counts[2 * b];
  const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;  // null without dropout
  rows_tile<HD, kGrad>(
      Q, Q + (size_t)B * nh * head, Q + 2 * (size_t)B * nh * head,
      kGrad ? dctx + (size_t)b * L * HN + (size_t)h * HD : nullptr, HN, 0, q0, q_end, L,
      key_tiles(bb, i, n_valid),
      [&](int t, KeyTile& kt) { return key_tile(bb, i, t, n_valid, kt); },
      [&](const KeyTile& kt, int row, int key) { return key < kt.k_end; },
      [&](const KeyTile& kt, int row, int key) {
        return keep_prob_bits(seed, thr, b, h | kt.tag, row, key + kt.col_off);
      },
      keep_prob, ctx + (size_t)b * L * HN + (size_t)h * HD, HN,
      kGrad ? stats + ((size_t)b * nh + h) * L : nullptr, (size_t)B * nh * L,
      reinterpret_cast<unsigned char*>(smem));
}

// counts and q, k, v; wqkv (H, 3 nh hd) in the element type, bqkv float32.
template <typename T>
cudaError_t bigbird_projections(const T* hidden, const int32_t* mask, const T* wqkv,
                                const float* bqkv, int32_t* counts, T* qkv_buf, int B, int L,
                                int H, int nh, int hd, float sm_scale, cudaStream_t stream) {
  // the mask stands in for the global mask: with global_rows = 0 the kernel
  // counts the real tokens only
  sliding_count_kernel<><<<B, kThreads, 0, stream>>>(mask, mask, counts, L, 0, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_qkv_proj<T>(hidden, wqkv, bqkv, qkv_buf, B, L, H, nh, hd, sm_scale, stream);
}

// The attention of the projected q, k, v into ctx (of type Tc); with kGrad
// also the row statistics.
template <typename T, bool kGrad, typename Tc = T>
cudaError_t bigbird_attention(const BigBird& bb, const int32_t* seed, const int32_t* counts,
                              const T* qkv_buf, const T* dctx, Tc* ctx_buf, float* stats, int B,
                              int nh, int hd, uint32_t thr, float keep_prob,
                              cudaStream_t stream) {
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    auto rows = bigbird_rows_kernel<T, HD, kGrad, Tc>;
    constexpr size_t smem = rows_tiles_bytes<T, HD, kGrad>();
    cudaError_t e = prepare(rows, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(bb.nb * bb.S, nh, B);
    rows<<<grid, kGradThreads, smem, stream>>>(qkv_buf, counts, bb, seed, dctx, ctx_buf, stats, B,
                                               nh, thr, keep_prob);
    return cudaGetLastError();
  });
}

}  // namespace spk
