// The bf16 gradient passes of the training attention backwards on the
// tensor cores, shared by the dense (train_attention.cu), Longformer
// (train_sliding.cu) and BigBird (train_bigbird.cu) gradient kernels.
//
// A block runs kGradWarps = 4 warps over 64 rows of "its" side: keys in the
// dk/dv pass, query rows in the dq pass. Warp w owns rows 16 w .. 16 w +
// 15; in the m16n8 fragments of its products lane (g, t) = (lane / 4, lane
// % 4) holds rows g and g + 8, columns 2 t and 2 t + 1 of each n8 tile. The
// other side streams in 64-row tiles, staged in bf16 through a two-stage
// cp.async ring (rows padded to an odd number of 16-byte units, as
// CoreMma's, so the 8 addresses of an ldmatrix phase fall on distinct
// banks). The dk/dv pass (grad_tile_mma), in chunks of 32 query columns:
//   S^T = k q^T and dP^T = v dctx^T on mma.sync m16n8k16 bf16 with float32
//   sums from ldmatrix fragments;
//   the caller's softmax-with-dropout gradient on each accumulator element
//   in registers, from the element's (key, row) in the fragment: dS rounded
//   to bf16, and p_eff;
//   dS^T and p_eff^T packed into A fragments with bf16_pair: the
//   accumulator layout of an m16n8 tile is the A layout of an m16k8 slice,
//   and dS is a bf16 value, so its pack is exact (p_eff is rounded by it);
//   dk += dS^T q and dv += p_eff^T dctx, with q and dctx read as k16 x n8
//   fragments through ldmatrix.trans;
//   each dS stored once, in bf16, for the dq pass.
// The dq pass (dq_from_ds_tile) reads those dS tiles as A fragments
// (ldmatrix.trans) and forms dq += dS k. The products are those of the
// CUDA-core bodies but for the order of the float32 sums; every rounding
// point stays where it was. The rows kernels' bf16 body
// (attention_rows_mma.cuh) stages its tiles through the same ring and reads
// them with the same ldmatrix offsets.
//
// float32 has siblings of both passes on the same warps, ring and callbacks
// (grad_tile_tf32, dq_from_ds_tile_tf32): every product as 3xTF32 on
// mma.sync m16n8k8 (ptx.cuh tf32_split, mma_tf32x3; the split of
// tf32x3_gemm.cuh), the tiles staged as float32 rows padded to HD + 4 floats
// (an odd number of 16-byte units, for ldmatrix). The first products read
// both operands through ldmatrix: an 8 x 8 b16 matrix is 8 rows of 4 floats,
// a TF32 fragment. The second products take dS^T and p_eff^T from the
// accumulators as they stand: the accumulator holds columns 2 t and 2 t + 1
// of an n8 tile where a TF32 A fragment wants k = t and t + 4, so each k8
// step takes the tile's columns in the order (0, 2, 4, 6, 1, 3, 5, 7), and
// the lane reads q's (or dctx's) rows 2 t and 2 t + 1, column g, for its B
// fragment: 32-bit loads, which the padding keeps on 32 distinct banks. dS
// is stored once in float32 for the dq pass (twice the bf16 tiles' bytes,
// 402 MB at B=32, L=512 for row 10), which reads it and k through 32-bit
// loads from rows padded to 72 and HD + 8 floats.
#pragma once

#include "attention_core.cuh"

namespace spk {

constexpr int kGradWarps = 4;
constexpr int kGradThreads = 32 * kGradWarps;

// the least resident blocks an SM that a bf16 tensor-core attention kernel
// is compiled for (its launch bounds' second argument): 4 up to head dim 64,
// which caps a thread at 128 registers (on the H100, rows 12 and 13's
// gradient kernels ran 1.27 x and 1.11 x faster than at ptxas's own 186-246
// registers, PERF.md); at head dim 128 the accumulators alone take 128 and
// shared memory holds two blocks an SM, so ptxas chooses; 0 for the float32
// global rows kernel (global_rows_mma.cuh's 3xTF32 body), whose shared
// memory holds one block an SM at head dim 64
template <typename T, int HD>
__host__ __device__ constexpr int grad_min_blocks() {
  return std::is_same<T, float>::value || HD > 64 ? 0 : 4;
}

// the same for the rows and gradient kernels of rows 10, 12 and 13 and
// kernels 7 and 8 in both element types: float32 on 3xTF32 two, which its
// shared memory allows at head dim 64 (up to 255 registers a thread)
template <typename T, int HD>
__host__ __device__ constexpr int core_min_blocks() {
  return std::is_same<T, float>::value ? 2 : grad_min_blocks<T, HD>();
}

template <int HD>
struct GradMma {
  static_assert(HD % 16 == 0, "whole k16 steps");
  static constexpr int kRowBytes = 2 * HD + 16;  // an odd number of 16-byte units
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kChunks = HD / 8;  // 16-byte copies a staged row
  static constexpr int ND = HD / 8;       // n8 tiles of a (16, HD) accumulator
  static_assert(kRowBytes % 32 == 16, "odd 16-byte row stride");
};

// rows [r0, r0 + 64) of a bf16 slab X (row stride `stride` elements) into
// dst, rows outside [lo, hi) zero-filled through the copy's source size
template <int HD>
__device__ __forceinline__ void stage_grad_rows(const __nv_bfloat16* X, size_t stride, int r0,
                                                int lo, int hi, unsigned char* dst) {
  using M = GradMma<HD>;
  for (int e = threadIdx.x; e < kTile * M::kChunks; e += kGradThreads) {
    const int r = e / M::kChunks, c = e % M::kChunks, l = r0 + r;
    const bool in = l >= lo && l < hi;
    cp_async16(smem_addr(dst + r * M::kRowBytes + 16 * c), in ? X + (size_t)l * stride + 8 * c : X,
               in ? 16 : 0);
  }
}

// 64 float32 row statistics from src[r0 ..] into dst, rows outside [lo,
// hi) zero
__device__ __forceinline__ void stage_grad_stats(const float* src, int r0, int lo, int hi,
                                                 float* dst) {
  for (int i = threadIdx.x; i < kTile; i += kGradThreads) {
    const int l = r0 + i;
    const bool in = l >= lo && l < hi;
    cp_async4(smem_addr(dst + i), in ? src + l : src, in ? 4 : 0);
  }
}

// The block's walk over its live tiles of the other side, t in [0, n) in
// order: next(t) is the first live tile >= t (n when none is left, the
// same for every thread), load(stage, t) stages tile t into ring slot
// `stage`, body(stage, t) computes on it. Whatever the caller staged before
// the call lands with the first tile.
template <typename Next, typename Load, typename Body>
__device__ __forceinline__ void grad_ring(int n, Next next, Load load, Body body) {
  int t = next(0);
  if (t < n) load(0, t);
  cp_async_commit();
  int stage = 0;
  while (t < n) {
    const int tn = next(t + 1);
    if (tn < n) load(stage ^ 1, tn);  // its slot was freed by the barrier ending the last tile
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and what came before it) has landed
    __syncthreads();
    body(stage, t);
    __syncthreads();  // every warp is done with slot `stage`
    t = tn;
    stage ^= 1;
  }
  cp_async_wait<0>();
}

// Per-lane ldmatrix offsets (bytes) into a staged tile: the warp's A rows
// (four 8 x 8 matrices (rows 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
// 8-15) of an m16 x k16 fragment), the B rows as stored (two n8 x k16
// fragments: (cols 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)) and
// transposed (two k16 x n8 fragments: (rows 0-7, d 0-7), (8-15, 0-7), (0-7,
// 8-15), (8-15, 8-15)).
template <int HD>
struct GradLane {
  int a, b, bt;
  __device__ __forceinline__ GradLane() {
    constexpr int RB = GradMma<HD>::kRowBytes;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    a = (16 * warp + lane % 16) * RB + (lane / 16) * 16;
    b = (lane % 8 + 8 * (lane / 16)) * RB + ((lane / 8) % 2) * 16;
    bt = (lane % 8 + 8 * ((lane / 8) % 2)) * RB + (lane / 16) * 16;
  }
};

// One 64-column tile for the warp's 16 rows (keys). as_ / ap: shared-memory
// addresses of the A tiles of X and Y (the block's own k and v), bs / bp:
// of the staged B tiles (q and dctx). grad(x, y, hi, col, pe) returns the
// element's dS (a bf16 value) and sets pe (p_eff) of row g + 8 hi, column
// col in [0, 64); sink(hi, col, ds0, ds1) then receives the dS of columns
// col and col + 1 (col even). acc0 += dS . B_s and acc1 += p_eff . B_p.
template <int HD, typename Grad, typename Sink>
__device__ __forceinline__ void grad_tile_mma(uint32_t as_, uint32_t ap, uint32_t bs, uint32_t bp,
                                              const GradLane<HD>& lane, Grad grad, Sink sink,
                                              float (&acc0)[HD / 8][4],
                                              float (&acc1)[HD / 8][4]) {
  constexpr int RB = GradMma<HD>::kRowBytes;
  constexpr int KS = HD / 16;  // k16 steps of the first products
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int c = 0; c < kTile / 32; ++c) {
    float x[4][4], y[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], ad[4];
      ldmatrix_x4(as_ + lane.a + kk * 32, a);
      ldmatrix_x4(ap + lane.a + kk * 32, ad);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int off = lane.b + (32 * c + 16 * nj) * RB + kk * 32;
        uint32_t r[4];
        ldmatrix_x4(bs + off, r);
        mma_bf16(x[2 * nj], a, r[0], r[1]);
        mma_bf16(x[2 * nj + 1], a, r[2], r[3]);
        ldmatrix_x4(bp + off, r);
        mma_bf16(y[2 * nj], ad, r[0], r[1]);
        mma_bf16(y[2 * nj + 1], ad, r[2], r[3]);
      }
    }
    // the gradient on the fragments: x becomes dS, y p_eff
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = 0.0f;
        x[j][e] = grad(x[j][e], y[j][e], e / 2, 32 * c + 8 * j + 2 * t + e % 2, pe);
        y[j][e] = pe;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) sink(hi, 32 * c + 8 * j + 2 * t, x[j][2 * hi], x[j][2 * hi + 1]);
    // second products: 16 columns of the tile a k-step
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t a[4] = {bf16_pair(x[2 * ks][0], x[2 * ks][1]),
                             bf16_pair(x[2 * ks][2], x[2 * ks][3]),
                             bf16_pair(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                             bf16_pair(x[2 * ks + 1][2], x[2 * ks + 1][3])};
      const uint32_t ap2[4] = {bf16_pair(y[2 * ks][0], y[2 * ks][1]),
                               bf16_pair(y[2 * ks][2], y[2 * ks][3]),
                               bf16_pair(y[2 * ks + 1][0], y[2 * ks + 1][1]),
                               bf16_pair(y[2 * ks + 1][2], y[2 * ks + 1][3])};
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        const int off = lane.bt + (32 * c + 16 * ks) * RB + dn * 32;
        uint32_t r[4];
        ldmatrix_x4_trans(bs + off, r);
        mma_bf16(acc0[2 * dn], a, r[0], r[1]);
        mma_bf16(acc0[2 * dn + 1], a, r[2], r[3]);
        ldmatrix_x4_trans(bp + off, r);
        mma_bf16(acc1[2 * dn], ap2, r[0], r[1]);
        mma_bf16(acc1[2 * dn + 1], ap2, r[2], r[3]);
      }
    }
  }
}

// dS written once. The dk/dv pass, which forms every (row, key) dS that the
// dq pass needs, stores it in bf16, one (64 keys, 64 query rows) tile (keys
// major) for each (query tile, key tile) the dq pass visits; the dq pass
// reads dS instead of forming S, dP, the exponent and the dropout draw
// again (on the H100 the dq pass forming them took 1.0-1.2 ms at B=8, L=2048,
// reading them 0.11-0.13, PERF.md). kDsRowBytes pads a staged tile's rows
// as kRowBytes does.
constexpr int kDsTile = kTile * kTile;  // elements of a stored dS tile
constexpr int kDsRowBytes = 2 * kTile + 16;
constexpr int kDsTileBytes = kTile * kDsRowBytes;

__device__ __forceinline__ void stage_ds_tile(const __nv_bfloat16* src, unsigned char* dst) {
  constexpr int kChunks = kTile / 8;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kGradThreads) {
    const int r = e / kChunks, c = e % kChunks;
    cp_async16(smem_addr(dst + r * kDsRowBytes + 16 * c), src + r * kTile + 8 * c, 16);
  }
}

// acc += dS . K over one staged (64 keys, 64 rows) dS tile at ds and the
// (64 keys, HD) k tile at ks, for the warp's 16 rows: dS's A fragments
// through ldmatrix.trans of the keys-major tile (matrices (rows 0-7, keys
// 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)), k's B fragments as in
// grad_tile_mma
template <int HD>
__device__ __forceinline__ void dq_from_ds_tile(uint32_t ds, uint32_t ks, const GradLane<HD>& lane,
                                                float (&acc)[HD / 8][4]) {
  constexpr int RB = GradMma<HD>::kRowBytes;
  const int l = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t a_addr =
      ds + (l % 8 + 8 * (l / 16)) * kDsRowBytes + (16 * warp + 8 * ((l / 8) % 2)) * 2;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4_trans(a_addr + kk * 16 * kDsRowBytes, a);
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t r[4];
      ldmatrix_x4_trans(ks + lane.bt + kk * 16 * RB + dn * 32, r);
      mma_bf16(acc[2 * dn], a, r[0], r[1]);
      mma_bf16(acc[2 * dn + 1], a, r[2], r[3]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void zero_acc(float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
}

// row g + 8 hi of the warp's accumulator into dst (a bf16 row of HD),
// each element through f
template <int HD, typename F>
__device__ __forceinline__ void store_acc_row(const float (&acc)[HD / 8][4], int hi,
                                              __nv_bfloat16* dst, F f) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n + 2 * t) =
        __floats2bfloat162_rn(f(acc[n][2 * hi]), f(acc[n][2 * hi + 1]));
}

// ---------------------------------------------------------------- float32

// The float32 tiles: rows of HD floats padded to HD + 4 (kRowFloats), and
// the dq pass's k tile padded to HD + 8, so that the lanes' 32-bit reads of
// column g in rows t and t + 4 fall on distinct banks.
template <int HD>
struct GradTf32 {
  static_assert(HD % 8 == 0, "whole k8 steps");
  static constexpr int kRowFloats = HD + 4;
  static constexpr int kRowBytes = 4 * kRowFloats;
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kKRowFloats = HD + 8;
  static constexpr int kKTileBytes = kTile * 4 * kKRowFloats;
  static_assert(kRowFloats % 8 == 4, "odd 16-byte row stride");
};

// rows [r0, r0 + 64) of a float32 slab X (row stride `stride` elements)
// into dst as rows of kPitch floats, rows outside [lo, hi) zero-filled
// through the copy's source size
template <int HD, int kPitch = HD + 4>
__device__ __forceinline__ void stage_f32_rows(const float* X, size_t stride, int r0, int lo,
                                               int hi, unsigned char* dst) {
  constexpr int kChunks = HD / 4;  // 16-byte copies a row
  for (int e = threadIdx.x; e < kTile * kChunks; e += kGradThreads) {
    const int r = e / kChunks, c = e % kChunks, l = r0 + r;
    const bool in = l >= lo && l < hi;
    cp_async16(smem_addr(dst + r * 4 * kPitch + 16 * c), in ? X + (size_t)l * stride + 4 * c : X,
               in ? 16 : 0);
  }
}

// Per-lane offsets into a staged float32 tile: the warp's A rows and the B
// rows as stored for ldmatrix (bytes; GradLane's matrices, 4 floats a
// matrix row), and the lane's (row 2 t, column g) for a B fragment along the
// rows (floats)
template <int HD>
struct GradLaneF32 {
  int a, b, bk;
  __device__ __forceinline__ GradLaneF32() {
    constexpr int RB = GradTf32<HD>::kRowBytes;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    a = (16 * warp + lane % 16) * RB + (lane / 16) * 16;
    b = (lane % 8 + 8 * (lane / 16)) * RB + ((lane / 8) % 2) * 16;
    bk = 2 * (lane % 4) * GradTf32<HD>::kRowFloats + lane / 4;
  }
};

// x[j] = A . B^T as 3xTF32 for the warp's 16 rows against rows 32 c + 8 j ..
// + 7 of a staged tile: A's fragments from the tile at a_tile, B's from the
// tile at b_tile as its rows stand (shared-memory addresses). The k8 steps
// stay a loop: unrolled, ptxas hoisted every step's fragments and splits
// (the band rows kernel's statistics pass 185 registers against 149 rolled,
// row 10's attn_dkv 235 against 198), and on the H100 the float32 rows and
// gradient kernels ran 1.2-1.5 x slower (PERF.md, PR 19); the sums' order
// is the same either way.
template <int HD>
__device__ __forceinline__ void scores_tf32(uint32_t a_tile, uint32_t b_tile,
                                            const GradLaneF32<HD>& lane, int c,
                                            float (&x)[4][4]) {
  constexpr int RB = GradTf32<HD>::kRowBytes;
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.0f;
#pragma unroll 1
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t r[4], ab[4], as[4];
    ldmatrix_x4(a_tile + lane.a + kk * 32, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(__uint_as_float(r[i]), ab[i], as[i]);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t bb[4], bs[4];
      ldmatrix_x4(b_tile + lane.b + (32 * c + 16 * nj) * RB + kk * 32, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) tf32_split(__uint_as_float(r[i]), bb[i], bs[i]);
      mma_tf32x3(x[2 * nj], ab, as, bb[0], bb[1], bs[0], bs[1]);
      mma_tf32x3(x[2 * nj + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
    }
  }
}

// acc += X . Z as 3xTF32 over chunk c's 32 rows of a staged tile Z (its
// rows run along k): x[j] holds the warp's accumulators of Z's rows 32 c +
// 8 j + 2 t and + 1 (the k8 step's column order 0, 2, 4, 6, 1, 3, 5, 7), z
// points at the tile plus the lane's offset (GradLaneF32::bk)
template <int HD>
__device__ __forceinline__ void accumulate_tf32(const float (&x)[4][4], const float* z, int c,
                                                float (&acc)[HD / 8][4]) {
  constexpr int RF = GradTf32<HD>::kRowFloats;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t ab[4], as[4];
    tf32_split(x[j][0], ab[0], as[0]);
    tf32_split(x[j][2], ab[1], as[1]);
    tf32_split(x[j][1], ab[2], as[2]);
    tf32_split(x[j][3], ab[3], as[3]);
    const float* rows = z + (32 * c + 8 * j) * RF;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      uint32_t bb0, bs0, bb1, bs1;
      tf32_split(rows[8 * dn], bb0, bs0);
      tf32_split(rows[RF + 8 * dn], bb1, bs1);
      mma_tf32x3(acc[dn], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// grad_tile_mma in float32: the tiles at as_ / ap (the block's own k and
// v) and bs / bp (the staged q and dctx) are float32 rows of HD + 4; grad
// and sink as there (dS and p_eff float32 values), acc0 += dS . B_s, acc1
// += p_eff . B_p.
template <int HD, typename Grad, typename Sink>
__device__ __forceinline__ void grad_tile_tf32(const unsigned char* as_, const unsigned char* ap,
                                               const unsigned char* bs, const unsigned char* bp,
                                               const GradLaneF32<HD>& lane, Grad grad, Sink sink,
                                               float (&acc0)[HD / 8][4],
                                               float (&acc1)[HD / 8][4]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int c = 0; c < kTile / 32; ++c) {
    float x[4][4], y[4][4];
    scores_tf32<HD>(smem_addr(as_), smem_addr(bs), lane, c, x);
    scores_tf32<HD>(smem_addr(ap), smem_addr(bp), lane, c, y);
    // the gradient on the fragments: x becomes dS, y p_eff
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = 0.0f;
        x[j][e] = grad(x[j][e], y[j][e], e / 2, 32 * c + 8 * j + 2 * t + e % 2, pe);
        y[j][e] = pe;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) sink(hi, 32 * c + 8 * j + 2 * t, x[j][2 * hi], x[j][2 * hi + 1]);
    accumulate_tf32<HD>(x, reinterpret_cast<const float*>(bs) + lane.bk, c, acc0);
    accumulate_tf32<HD>(y, reinterpret_cast<const float*>(bp) + lane.bk, c, acc1);
  }
}

// a stored float32 dS tile (64 keys, 64 rows), staged as rows of 72 floats
constexpr int kDsRowFloatsF = kTile + 8;
constexpr int kDsTileBytesF = kTile * 4 * kDsRowFloatsF;

__device__ __forceinline__ void stage_ds_tile_f32(const float* src, unsigned char* dst) {
  constexpr int kChunks = kTile / 4;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kGradThreads) {
    const int r = e / kChunks, c = e % kChunks;
    cp_async16(smem_addr(dst + r * 4 * kDsRowFloatsF + 16 * c), src + r * kTile + 4 * c, 16);
  }
}

// acc += dS . K as 3xTF32 over one staged float32 dS tile ds (64 keys, 64
// rows, keys major) and the (64 keys, HD) k tile ks (rows of HD + 8), for
// the warp's 16 rows: the lane's A values (row g (+ 8), key t (+ 4)) and B
// values (key t (+ 4), column g) by 32-bit loads
template <int HD>
__device__ __forceinline__ void dq_from_ds_tile_tf32(const unsigned char* ds,
                                                     const unsigned char* ks,
                                                     float (&acc)[HD / 8][4]) {
  constexpr int DF = kDsRowFloatsF, KF = GradTf32<HD>::kKRowFloats;
  const int l = threadIdx.x % 32, warp = threadIdx.x / 32, g = l / 4, t = l % 4;
  const float* a = reinterpret_cast<const float*>(ds) + t * DF + 16 * warp + g;
  const float* b = reinterpret_cast<const float*>(ks) + t * KF + g;
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    uint32_t ab[4], as[4];
    tf32_split(a[8 * kk * DF], ab[0], as[0]);
    tf32_split(a[8 * kk * DF + 8], ab[1], as[1]);
    tf32_split(a[(8 * kk + 4) * DF], ab[2], as[2]);
    tf32_split(a[(8 * kk + 4) * DF + 8], ab[3], as[3]);
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      uint32_t bb0, bs0, bb1, bs1;
      tf32_split(b[8 * kk * KF + 8 * dn], bb0, bs0);
      tf32_split(b[(8 * kk + 4) * KF + 8 * dn], bb1, bs1);
      mma_tf32x3(acc[dn], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// row g + 8 hi of the warp's accumulator into dst (a float32 row of HD),
// each element through f
template <int HD, typename F>
__device__ __forceinline__ void store_acc_row(const float (&acc)[HD / 8][4], int hi, float* dst,
                                              F f) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    *reinterpret_cast<float2*>(dst + 8 * n + 2 * t) =
        make_float2(f(acc[n][2 * hi]), f(acc[n][2 * hi + 1]));
}

// ------------------------------------------------------ by element type

// A kernel that runs both element types' bodies (the rows and gradient
// kernels of rows 10, 12 and 13 and kernels 7 and 8) stages its tiles
// through these: bf16's tiles (GradMma), or float32's (GradTf32).
template <typename T, int HD>
__host__ __device__ constexpr size_t grad_tile_bytes() {
  if constexpr (std::is_same<T, float>::value) {
    return GradTf32<HD>::kTileBytes;
  } else {
    return GradMma<HD>::kTileBytes;
  }
}

template <int HD>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* X, size_t stride, int r0, int lo,
                                           int hi, unsigned char* dst) {
  stage_grad_rows<HD>(X, stride, r0, lo, hi, dst);
}

template <int HD>
__device__ __forceinline__ void stage_tile(const float* X, size_t stride, int r0, int lo, int hi,
                                           unsigned char* dst) {
  stage_f32_rows<HD>(X, stride, r0, lo, hi, dst);
}

// a stage of the dq pass: the k tile, then the dS tile
template <typename T, int HD>
__host__ __device__ constexpr size_t grad_dq_stage() {
  if constexpr (std::is_same<T, float>::value) {
    return (size_t)GradTf32<HD>::kKTileBytes + kDsTileBytesF;
  } else {
    return (size_t)GradMma<HD>::kTileBytes + kDsTileBytes;
  }
}

// The dq pass of a gradient kernel (row 10's, the Longformer's, BigBird's)
// over the key tiles t < n that next(t) walks (next as grad_ring's): k's
// rows from k0_of(t) of the (L, HD) slab K and the stored dS tile at tile(t)
// into a ring of two stages at smem, acc += dS . K for the warp's 16 rows
// where ``live``.
template <typename T, int HD, typename Next, typename K0, typename Tile>
__device__ __forceinline__ void dq_from_ds_tiles(const T* K, int L, int n, Next next, K0 k0_of,
                                                 Tile tile, bool live, unsigned char* smem,
                                                 float (&acc)[HD / 8][4]) {
  const auto stage_of = [&](int s) { return smem + s * grad_dq_stage<T, HD>(); };
  if constexpr (std::is_same<T, float>::value) {
    constexpr int KB = GradTf32<HD>::kKTileBytes;
    grad_ring(
        n, next,
        [&](int s, int t) {
          stage_f32_rows<HD, GradTf32<HD>::kKRowFloats>(K, HD, k0_of(t), 0, L, stage_of(s));
          stage_ds_tile_f32(tile(t), stage_of(s) + KB);
        },
        [&](int s, int) {
          if (live) dq_from_ds_tile_tf32<HD>(stage_of(s) + KB, stage_of(s), acc);
        });
  } else {
    constexpr int KB = GradMma<HD>::kTileBytes;
    const GradLane<HD> lane;
    grad_ring(
        n, next,
        [&](int s, int t) {
          stage_grad_rows<HD>(K, HD, k0_of(t), 0, L, stage_of(s));
          stage_ds_tile(tile(t), stage_of(s) + KB);
        },
        [&](int s, int) {
          if (live)
            dq_from_ds_tile<HD>(smem_addr(stage_of(s) + KB), smem_addr(stage_of(s)), lane, acc);
        });
  }
}

// the shared memory of the Longformer and BigBird gradient kernels: the dq
// pass holds two stages of (k, dS); the dk/dv pass k and v, then two stages
// of (q, dctx, the 64 rows' m, D and rowsum(dp p_eff))
template <typename T, int HD>
__host__ __device__ constexpr size_t grad_dq_smem() {
  return 2 * grad_dq_stage<T, HD>();
}

template <typename T, int HD>
__host__ __device__ constexpr size_t grad_dkv_stage() {
  return 2 * grad_tile_bytes<T, HD>() + 3 * kTile * sizeof(float);
}

template <typename T, int HD>
__host__ __device__ constexpr size_t grad_dkv_smem() {
  return 2 * grad_tile_bytes<T, HD>() + 2 * grad_dkv_stage<T, HD>();
}

// The dk/dv pass's body on one staged query tile for the warp's 16 keys:
// the tiles at ks / vs (the block's own k and v) and qs / dcs (the staged q
// and dctx), grad and sink as grad_tile_mma takes them; bf16 or float32.
template <typename T, int HD, typename Grad, typename Sink>
__device__ __forceinline__ void grad_tile(const unsigned char* ks, const unsigned char* vs,
                                          const unsigned char* qs, const unsigned char* dcs,
                                          Grad grad, Sink sink, float (&acc0)[HD / 8][4],
                                          float (&acc1)[HD / 8][4]) {
  if constexpr (std::is_same<T, float>::value) {
    const GradLaneF32<HD> lane;
    grad_tile_tf32<HD>(ks, vs, qs, dcs, lane, grad, sink, acc0, acc1);
  } else {
    const GradLane<HD> lane;
    grad_tile_mma<HD>(smem_addr(ks), smem_addr(vs), smem_addr(qs), smem_addr(dcs), lane, grad,
                      sink, acc0, acc1);
  }
}

}  // namespace spk
