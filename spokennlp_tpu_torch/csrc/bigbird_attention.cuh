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
// A query tile of a global block walks the key tiles of [0, n_valid) (in
// bf16 split over a cluster of blocks where L is long: global_cluster); one
// of another block walks its (3 + G + R) S pieces' tiles, skipping those
// with no allowed key (bigbird_rows_kernel).
// Layouts: qkv (3, B, nh, L, hd) in the element type, q pre-scaled; ctx (B,
// L, nh*hd) in its type Tc (the element type, or float32 in W8A8); counts (B,
// 2) int32 (n_valid, 0); row statistics (3, B, nh, L) float32 = (m, D,
// rowsum(dp p_eff)). Nothing of size (L, K C) or (L, L) is written to device
// memory.
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

// The global tiles' cluster: a global query tile walks the key tiles of
// [0, n_valid), up to ceil(L / 64), where another walks (3 + G + R) S; in
// bf16, where that is more, its key tiles are split over a cluster of
// kGlobalCluster blocks. The launch is bound by the blocks' throughput, not
// by a long walk left alone at its end: each block of a cluster stages its
// query tile, fills its ring and waits at three cluster barriers, so more
// blocks a tile add work. On the H100 (rows_core_turns.py; PERF.md) clusters
// of 2 read best in bf16 at kernel 8's L=4096 and row 13's L=2048, beside
// 1, 4 and 8. float32 keeps one block a tile: its launch with clusters of 2
// read slower than one block's. It depends on L alone, so a row's sums run
// in the same order at any batch.
constexpr int kGlobalCluster = 2;

template <typename T>
inline int global_cluster(const BigBird& bb) {
  if (std::is_same<T, float>::value) return 1;
  const int walk = (bb.L + kTile - 1) / kTile, window = (3 + bb.G + bb.R) * bb.S;
  return walk > window ? kGlobalCluster : 1;
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
// the row statistics (m, D, rowsum(dp p_eff)). attention_rows_mma.cuh's
// tensor-core body, bf16 or float32 on 3xTF32, with the same callbacks
// (key_tile's tiles), 128 threads. global: query tile `tile` of the G S
// global tiles of every (head, sequence), else window tile `tile` of the
// (nb - G) S others, walking its (3 + G + R) S pieces. kCluster (global
// tiles only): the tile's key tiles split over the kGlobalCluster blocks
// of a cluster, this one walking the rank-th of the contiguous ranges
// (ClusterRows: the rows' maxima taken over the cluster before pass 2, D,
// O and rs added in rank order into rank 0, which stores them); else one
// block walks them all.
template <typename T, int HD, bool kGrad, bool kCluster, typename Tc>
__device__ __forceinline__ void bigbird_tile(const T* qkv, const int32_t* counts,
                                             const BigBird& bb, const int32_t* seed_ptr,
                                             const T* dctx, Tc* ctx, float* stats, int B, int nh,
                                             uint32_t thr, float keep_prob, bool global, int tile,
                                             unsigned char* smem) {
  const int per = (global ? bb.G : bb.nb - bb.G) * bb.S;  // tiles a (head, sequence)
  const int hb = tile / per, h = hb % nh, b = hb / nh, L = bb.L;
  int i, q0, q_end;
  block_tile(bb, (global ? 0 : bb.G * bb.S) + tile % per, i, q0, q_end);
  const size_t head = (size_t)L * HD, HN = (size_t)nh * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const int n_valid = counts[2 * b];
  const uint32_t seed = thr ? (uint32_t)seed_ptr[0] : 0u;  // null without dropout
  // the key tiles [t0, t0 + n) of this block
  int t0 = 0, n = key_tiles(bb, i, n_valid);
  std::conditional_t<kCluster, ClusterRows, WholeRows> split{};
  if constexpr (kCluster) {
    constexpr int cs = kGlobalCluster;
    const int rank = cluster_rank();
    t0 = rank * n / cs;
    n = (rank + 1) * n / cs - t0;
    float* xch = reinterpret_cast<float*>(smem + rows_tiles_bytes<T, HD, kGrad>());
    split = ClusterRows{xch, rank, cs};
  }
  rows_tile<HD, kGrad>(
      Q, Q + (size_t)B * nh * head, Q + 2 * (size_t)B * nh * head,
      kGrad ? dctx + (size_t)b * L * HN + (size_t)h * HD : nullptr, HN, 0, q0, q_end, L, n,
      [&](int t, KeyTile& kt) { return key_tile(bb, i, t0 + t, n_valid, kt); },
      [&](const KeyTile& kt, int row, int key) { return key < kt.k_end; },
      [&](const KeyTile& kt, int row, int key) {
        return keep_prob_bits(seed, thr, b, h | kt.tag, row, key + kt.col_off);
      },
      keep_prob, ctx + (size_t)b * L * HN + (size_t)h * HD, HN,
      kGrad ? stats + ((size_t)b * nh + h) * L : nullptr, (size_t)B * nh * L, smem, RawScore{},
      split);
}

// One launch, its blocks in linear order (blockIdx.x): the n_global global
// query tiles of every (head, sequence) first, then the n_window others. A
// global tile walks up to 8 times the key tiles of another at L=4096:
// started first, the global tiles run beside the window tiles and no long
// walk runs on alone at the end of the launch. With kSplit the launch is in
// clusters of kGlobalCluster blocks, each cluster a unit of work: a global
// tile whose key tiles its blocks split (ClusterRows), or kGlobalCluster
// window tiles, one a block (the last unit's spare blocks return). Without
// it, one block a tile and one body for both kinds (with a copy of the
// float32 body for each, the launch read 1.52 ms against the parent's 1.27
// at kernel 8's shape on the H100: PERF.md). Dynamic shared memory:
// rows_tiles_bytes, and with kSplit ClusterRows' 3 kTile floats.
template <typename T, int HD, bool kGrad, bool kSplit, typename Tc = T>
__global__ void __launch_bounds__(kGradThreads, core_min_blocks<T, HD>())
    bigbird_rows_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ counts,
                        BigBird bb, const int32_t* __restrict__ seed_ptr,
                        const T* __restrict__ dctx, Tc* __restrict__ ctx,
                        float* __restrict__ stats, int B, int nh, uint32_t thr, float keep_prob,
                        int n_global, int n_window) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* s = reinterpret_cast<unsigned char*>(smem);
  if constexpr (kSplit) {
    constexpr int cs = kGlobalCluster;
    const int unit = blockIdx.x / cs;
    if (unit < n_global) {
      bigbird_tile<T, HD, kGrad, true>(qkv, counts, bb, seed_ptr, dctx, ctx, stats, B, nh, thr,
                                       keep_prob, true, unit, s);
      return;
    }
    const int tile = (unit - n_global) * cs + blockIdx.x % cs;
    if (tile >= n_window) return;
    bigbird_tile<T, HD, kGrad, false>(qkv, counts, bb, seed_ptr, dctx, ctx, stats, B, nh, thr,
                                      keep_prob, false, tile, s);
  } else {
    const int x = blockIdx.x;
    const bool global = x < n_global;
    bigbird_tile<T, HD, kGrad, false>(qkv, counts, bb, seed_ptr, dctx, ctx, stats, B, nh, thr,
                                      keep_prob, global, global ? x : x - n_global, s);
  }
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
// also the row statistics: one bigbird_rows_kernel launch, in clusters where
// global_cluster<T>(bb) splits the global tiles, else one block a tile.
// parts: which tiles, 1 the global ones, 2 the others, 3 both (every caller
// but a measurement); the others alone launch one block a tile.
template <typename T, bool kGrad, typename Tc = T>
cudaError_t bigbird_attention(const BigBird& bb, const int32_t* seed, const int32_t* counts,
                              const T* qkv_buf, const T* dctx, Tc* ctx_buf, float* stats, int B,
                              int nh, int hd, uint32_t thr, float keep_prob, cudaStream_t stream,
                              int parts = 3) {
  if (parts < 1 || parts > 3) return cudaErrorInvalidValue;
  const int n_global = parts & 1 ? bb.G * bb.S * nh * B : 0;
  const int n_window = parts & 2 ? (bb.nb - bb.G) * bb.S * nh * B : 0;
  if (n_global + n_window == 0) return cudaSuccess;
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    constexpr size_t smem = rows_tiles_bytes<T, HD, kGrad>();
    cudaError_t e;
    if constexpr (!std::is_same<T, float>::value) {  // float32 never splits (global_cluster)
      if (n_global > 0 && global_cluster<T>(bb) > 1) {
        constexpr int cs = kGlobalCluster;
        auto rows = bigbird_rows_kernel<T, HD, kGrad, true, Tc>;
        constexpr size_t xsmem = smem + 3 * kTile * sizeof(float);
        e = prepare(rows, xsmem);
        if (e != cudaSuccess) return e;
        cudaLaunchAttribute cluster[1];
        cluster[0].id = cudaLaunchAttributeClusterDimension;
        cluster[0].val.clusterDim.x = cs;
        cluster[0].val.clusterDim.y = 1;
        cluster[0].val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((n_global + (n_window + cs - 1) / cs) * cs);
        cfg.blockDim = dim3(kGradThreads);
        cfg.dynamicSmemBytes = xsmem;
        cfg.stream = stream;
        cfg.attrs = cluster;
        cfg.numAttrs = 1;
        e = cudaLaunchKernelEx(&cfg, rows, qkv_buf, counts, bb, seed, dctx, ctx_buf, stats, B, nh,
                               thr, keep_prob, n_global, n_window);
        return e != cudaSuccess ? e : cudaGetLastError();
      }
    }
    auto rows = bigbird_rows_kernel<T, HD, kGrad, false, Tc>;
    e = prepare(rows, smem);
    if (e != cudaSuccess) return e;
    rows<<<n_global + n_window, kGradThreads, smem, stream>>>(
        qkv_buf, counts, bb, seed, dctx, ctx_buf, stats, B, nh, thr, keep_prob, n_global,
        n_window);
    return cudaGetLastError();
  });
}

}  // namespace spk
