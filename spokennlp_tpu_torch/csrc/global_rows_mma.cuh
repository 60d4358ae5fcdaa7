// The bodies of global_rows_kernel (sliding_attention.cuh) on the tensor
// cores: the Longformer global rows' full attention, in kernel 7 (float and
// W8A8 modes), row 12's forward and, with kGrad, row 12's backward
// statistics pass (ctx, qg, the rows' statistics and dqg). bf16 runs
// global_rows_tile_mma (mma.sync m16n8k16 bf16), float32 its 3xTF32
// sibling global_rows_tile_tf32 (mma.sync m16n8k8 TF32, below).
//
// Replaces the global-row stage of the TPU kernels
// spokennlp_tpu/ops/pallas/sliding_block.py:193-254 and, for the backward,
// spokennlp_tpu/ops/pallas/train_sliding.py:477-555: qg = round((x_g Wgq +
// bgq) sm_scale), S = qg kg^T over the keys below n_valid, e = exp((s -
// m).astype(dtype)) against the row's exact maximum, D = sum e in float32,
// ctx = (kept e) . vg / (D keep_prob); with kGrad dP = dctx_g vg^T, rs =
// rowsum(dp p_eff), dS = round(p_eff dp - (e / D) rs / (D keep_prob)) and
// dqg = round((dS . kg) sm_scale). Every rounding point stays where the TPU
// kernel has it; the products' float32 sums run in another order (and in
// float32 as 3xTF32, each operand split into two TF32 parts).
//
// What bounds it. The main paths mark CLS as the one global token, so a
// sequence has one global row of G = 16: the work is that row's attention
// over every key of each (head, sequence), some 6e7 operations at B=8, L=2048,
// against the 50 MB of kg and vg it must read in bf16 (0.015 ms at 3.35
// TB/s; 100 MB and 0.03 ms in float32). The CUDA-core bodies ran one
// 256-thread block per global row (15 of 16 blocks returned at once)
// through a serial chain of query projection, scores and P.V over the whole
// sequence, at 9-43 x that bound, and their chain is as long at any batch:
// at the recipe's micro-batch of 2, 24 chains on 132 SMs.
//
// The design. A block owns a tile of kGlobRows = 16 global rows of one
// (head, sequence), one m16 row tile; a tile wholly at or beyond n_glob
// returns, so the main paths launch one working block (float32: one
// cluster) per (head, sequence). Rows at or beyond n_glob are zero rows of
// the tile.
//   query  once per tile: in bf16 x's 16 rows times the head's (H, HD)
//          slice of Wgq on mma.sync m16n8k16 over K = H, in stages of 64
//          through attention_grad_mma.cuh's two-stage block ring (each warp
//          owns 16-column groups of the head dim); in W8A8 the int32 product
//          of the int8 rows and weights on the CUDA cores (exact in any
//          order, so qg equals the plain int8 query bit for bit),
//          dequantised as the projections are;
//   keys   split over the kGradWarps = 4 warps, each a contiguous range of
//          32-key tiles, which it stages through its own kGlobStages-deep
//          cp.async ring (16-byte copies, keys at or beyond n_valid
//          zero-filled; rows padded as attention_grad_mma.cuh's, read with
//          its ldmatrix offsets) with no block barrier;
//   pass 1 S on mma.sync from the tile's q fragments and k's, each warp's
//          row maxima, then their maximum over the warps: the row's exact
//          maximum;
//   pass 2 S again, e = rounded_exp<bf16>(s, m), D += e, the keep bit, P.V
//          on mma.sync from the kept e packed into A fragments (e is a bf16
//          value: the pack is exact); with kGrad dP = dctx vg^T on mma.sync
//          and rs += p_eff dp;
//   pass 3 (kGrad) S and dP again, dS on the fragments, dqg += dS . kg on
//          mma.sync with kg's tile read transposed.
// Each warp's partial D, rs, O and dqg are combined over the warps in a
// fixed order in shared memory, with no atomics: two calls give the same
// bits. The dropout draw of (row g, key) is keep_prob_bits(seed, thr, b, h
// | kGlobalRowStream, g, key), as before; a warp takes a 32-key tile's draws
// one live row at a time, lane j drawing key k0 + j (__ballot_sync gathers
// them), so a tile with one live row costs one draw a lane, not sixteen.
// The float32 body keeps these passes and splits the keys of a (head,
// sequence) further over a cluster of blocks (global_rows_tile_tf32).
#pragma once

#include "attention_rows_mma.cuh"
#include "int8_gemm.cuh"

namespace spk {

constexpr int kGlobRows = 16;    // global rows a block owns: one m16 row tile
constexpr int kGlobKeys = 32;    // keys a warp stages at a time
constexpr int kGlobStages = 3;   // depth of a warp's cp.async ring
constexpr int kQueryK = 64;      // depth of a query-projection stage
constexpr int kQueryRowBytes = 2 * kQueryK + 16;  // an odd number of 16-byte units

// the block's shared memory: the q tile, dctx's with kGrad, the warps'
// (m, D, rs) partials, then each warp's ring of (k, v) tiles; the query
// projection's two stages of (x rows, Wgq rows) and the warps' partial O or
// dqg (a warp's in its own ring) reuse the rings
template <int HD>
struct GlobMma {
  static constexpr int RB = GradMma<HD>::kRowBytes;
  static constexpr int kRowTile = kGlobRows * RB;
  static constexpr int kKeyTile = kGlobKeys * RB;
  static constexpr int kWarpRing = kGlobStages * 2 * kKeyTile;
  static constexpr int kRed = 3 * kGradWarps * kGlobRows * (int)sizeof(float);
  static constexpr int kXStage = kGlobRows * kQueryRowBytes;
  static constexpr int kQStage = kXStage + kQueryK * RB;
  static_assert(2 * kQStage <= kGradWarps * kWarpRing, "the query stages fit the rings");
  static_assert(kGlobRows * HD * (int)sizeof(float) <= kWarpRing, "a warp's partial fits its slot");
  static_assert(kRowTile % 16 == 0 && kRed % 16 == 0, "16-byte aligned regions");
};

template <int HD, bool kGrad>
__host__ __device__ constexpr size_t global_rows_smem_mma() {
  using M = GlobMma<HD>;
  return (size_t)(kGrad ? 2 : 1) * M::kRowTile + M::kRed + (size_t)kGradWarps * M::kWarpRing;
}

// rows [r0, r0 + R) and columns [c0, c0 + 8 NC) of a bf16 matrix X (row
// stride `stride` elements) into dst (row stride rb bytes) by nt threads,
// this one tid: rows at or beyond `hi` and columns at or beyond `width`
// zero. 16-byte cp.async copies when `vec` (stride, c0 and width multiples
// of 8, X 16-byte aligned), else element-wise stores.
template <int R, int NC>
__device__ __forceinline__ void stage_bf16_rows(const __nv_bfloat16* X, size_t stride, int r0,
                                                int hi, int c0, int width, bool vec,
                                                unsigned char* dst, int rb, int tid, int nt) {
  for (int e = tid; e < R * NC; e += nt) {
    const int r = e / NC, c = e % NC, l = r0 + r, col = c0 + 8 * c;
    unsigned char* d = dst + r * rb + 16 * c;
    if (vec) {
      const bool in = l < hi && col < width;
      cp_async16(smem_addr(d), in ? X + (size_t)l * stride + col : X, in ? 16 : 0);
    } else {
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(d);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = l < hi && col + i < width ? X[(size_t)l * stride + col + i]
                                         : __float2bfloat16(0.0f);
    }
  }
}

// A warp's walk over its key tiles [t0, t1) in order through its own
// kStages-deep cp.async ring: load(slot, t) stages tile t (the warp's lanes
// issue the copies), body(slot, t) computes on it. No block barrier. One
// stage loads each tile just before its body.
template <int kStages = kGlobStages, typename Load, typename Body>
__device__ __forceinline__ void warp_ring(int t0, int t1, Load load, Body body) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < t1) load(s, t0 + s);
    cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, tn = t + kStages - 1;
    if (tn < t1) load((i + kStages - 1) % kStages, tn);  // freed after tile t - 1
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t has landed
    __syncwarp();
    body(i % kStages, t);
    __syncwarp();  // every lane is done with the slot
  }
  cp_async_wait<0>();
}

// x[j] = A . B^T for the tile's 16 rows (this lane's ldmatrix address of
// the A tile: a_addr) against rows 8 j .. 8 j + 7 of the 32-row B tile at
// b_tile (k for S, v for dP), read as they stand
template <int HD>
__device__ __forceinline__ void glob_scores(uint32_t a_addr, uint32_t b_tile, int lane_b,
                                            float (&x)[4][4]) {
  constexpr int RB = GradMma<HD>::kRowBytes;
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a_addr + kk * 32, a);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
      ldmatrix_x4(b_tile + lane_b + 16 * nj * RB + kk * 32, r);
      mma_bf16(x[2 * nj], a, r[0], r[1]);
      mma_bf16(x[2 * nj + 1], a, r[2], r[3]);
    }
  }
}

// acc += P . B over a tile of 32 keys: P's A fragments packed from the
// fragments x (bf16 values), B the 32-row tile at b_tile (v, or k for dqg)
// read transposed
template <int HD>
__device__ __forceinline__ void glob_times_tile(const float (&x)[4][4], uint32_t b_tile,
                                                int lane_bt, float (&acc)[HD / 8][4]) {
  constexpr int RB = GradMma<HD>::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint32_t a[4] = {bf16_pair(x[2 * kk][0], x[2 * kk][1]),
                           bf16_pair(x[2 * kk][2], x[2 * kk][3]),
                           bf16_pair(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           bf16_pair(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t r[4];
      ldmatrix_x4_trans(b_tile + lane_bt + 16 * kk * RB + dn * 32, r);
      mma_bf16(acc[2 * dn], a, r[0], r[1]);
      mma_bf16(acc[2 * dn + 1], a, r[2], r[3]);
    }
  }
}

// The warp's (16, HD) fragments into its partial at dst (row-major floats)
template <int HD>
__device__ __forceinline__ void glob_partial(const float (&acc)[HD / 8][4], float* dst) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      *reinterpret_cast<float2*>(dst + (g + 8 * hi) * HD + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hi], acc[n][2 * hi + 1]);
}

// The sum over the warps, in order, of element (row, col) of their
// partials (warp w's at rings + w ring_bytes)
template <int HD>
__device__ __forceinline__ float glob_combined(const unsigned char* rings, int ring_bytes, int row,
                                               int col) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kGradWarps; ++w)
    s += reinterpret_cast<const float*>(rings + w * ring_bytes)[row * HD + col];
  return s;
}

// The warps' partials of row `row` in r (warp w's at r[16 w + row]), their
// maximum or their sum in warp order
__device__ __forceinline__ float glob_over_warps(const float* r, int row, bool take_max) {
  float v = r[row];
#pragma unroll
  for (int w = 1; w < kGradWarps; ++w)
    v = take_max ? fmaxf(v, r[w * kGlobRows + row]) : v + r[w * kGlobRows + row];
  return v;
}

// This lane's keep bits of keys k0 .. k0 + 31 for its rows g (lo) and g + 8
// (hi) of the tile at global row r0, bit j for key k0 + j (all ones without
// dropout): lane j draws key k0 + j of each live row, __ballot_sync gathers
// them
template <typename Keep>
__device__ __forceinline__ void glob_keep_bits(Keep keep, bool dropout, int r0, int n_live,
                                               int k0, uint32_t& lo, uint32_t& hi) {
  lo = hi = 0xffffffffu;
  if (!dropout) return;
  const int lane = threadIdx.x % 32, g = lane / 4;
  for (int i = 0; i < n_live; ++i) {
    const uint32_t m = __ballot_sync(0xffffffffu, keep(r0 + i, k0 + lane));
    if (i == g) lo = m;
    if (i == g + 8) hi = m;
  }
}

// The W8A8 query of the tile's rows i < n_live (rows seq + r0 + i of x8):
// the int32 product of the int8 row and the head's int8 weights w8 (H, HN)
// on the CUDA cores (exact in any order), dequantised as the projections
// are, plus bgq, times sm_scale, rounded to T. Thread (p, cq) sums k = p, p
// + KP, ... for columns 4 cq .. 4 cq + 3 (one 32-bit load of the int8
// weights a k), the KP parts added in `part` (KP x HD ints of shared
// memory). store(i, col, q, live) then takes element (i, col) of the
// tile's 16 rows (0 beyond n_live) from the threads col < HD. Every thread
// of the block calls it.
template <typename T, int HD, typename Store>
__device__ __forceinline__ void glob_query_i8(const int8_t* x8, const float* sx, const int8_t* w8,
                                              const float* sw, const float* bgq, size_t seq,
                                              int r0, int n_live, int H, int HN, int h,
                                              float sm_scale, int* part, Store store) {
  constexpr int CQ = HD / 4, KP = kGradThreads / CQ;
  const int tid = threadIdx.x, cq = tid % CQ, p = tid / CQ;
  for (int i = 0; i < kGlobRows; ++i) {  // the same for the whole block
    const size_t grow = seq + r0 + i;
    if (i < n_live) {
      int acc[4] = {0, 0, 0, 0};
      for (int k = p; k < H; k += KP) {
        const int w4 = *reinterpret_cast<const int*>(w8 + (size_t)k * HN + h * HD + 4 * cq);
        const int xk = x8[grow * H + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += xk * ((int)((uint32_t)w4 << (24 - 8 * j)) >> 24);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) part[p * HD + 4 * cq + j] = acc[j];
    }
    __syncthreads();
    if (tid < HD) {
      float q = 0.0f;
      if (i < n_live) {
        int isum = 0;
        for (int pp = 0; pp < KP; ++pp) isum += part[pp * HD + tid];
        q = round_to<T>(__fmul_rn(
            __fadd_rn(dequant(isum, sx[grow], sw[h * HD + tid]), bgq[h * HD + tid]), sm_scale));
      }
      store(i, tid, q, i < n_live);
    }
    __syncthreads();
  }
}

// The global rows [16 blockIdx.x, + 16) of head blockIdx.y of sequence
// blockIdx.z, those below n_glob real: global_rows_kernel's arguments (its
// bf16 instances) with the W8A8 query's x8, sx, w8 and sw (x8 null: the
// float query from x and wgq); keep(row, key) is the dropout bit of global
// row `row` and key `key` (taken only with `dropout`). 128 threads; smem
// holds global_rows_smem_mma<HD, kGrad>() bytes, 16-byte aligned.
template <int HD, bool kGrad, typename Tc, typename Keep>
__device__ __forceinline__ void global_rows_tile_mma(
    const __nv_bfloat16* x, const __nv_bfloat16* wgq, const float* bgq,
    const __nv_bfloat16* gkv, const int32_t* counts, bool dropout, Keep keep,
    const __nv_bfloat16* dctx, Tc* ctx, __nv_bfloat16* qg_buf, float* gstats,
    __nv_bfloat16* dqg, int B, int L, int H, int nh, int G, int ld, float sm_scale,
    float keep_prob, const int8_t* x8, const float* sx, const int8_t* w8, const float* sw,
    unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  using M = GlobMma<HD>;
  constexpr int RB = M::RB, ND = HD / 8, W = kGradWarps;
  const int r0 = blockIdx.x * kGlobRows, h = blockIdx.y, b = blockIdx.z;
  const int n_valid = counts[2 * b], n_glob = counts[2 * b + 1];
  if (r0 >= n_glob) return;  // the same for the whole block
  const int n_live = min(kGlobRows, n_glob - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int HN = nh * HD;
  const size_t head = (size_t)L * HD, seq = (size_t)b * L;
  const bf16* KG = gkv + ((size_t)b * nh + h) * head;
  const bf16* VG = gkv + (((size_t)B + b) * nh + h) * head;
  unsigned char* Qs = smem;
  unsigned char* dCs = Qs + M::kRowTile;
  float* red = reinterpret_cast<float*>(dCs + (kGrad ? M::kRowTile : 0));  // (m, D, rs) x (W, 16)
  unsigned char* rings = reinterpret_cast<unsigned char*>(red) + M::kRed;
  unsigned char* ring = rings + warp * M::kWarpRing;
  const GradLane<HD> gl;  // its b and bt offsets
  const uint32_t a_q = smem_addr(Qs) + (lane % 16) * RB + (lane / 16) * 16;
  const uint32_t a_dc = a_q + M::kRowTile;

  // ---- qg = round((x_g Wgq + bgq) sm_scale) for the tile's rows
  if (x8 == nullptr) {
    constexpr int NQ = (HD / 16 + W - 1) / W;  // 16-column groups of a warp
    float acc[NQ][2][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
    const bool vec = H % 8 == 0;
    const auto slot = [&](int s) { return rings + s * M::kQStage; };
    grad_ring(
        (H + kQueryK - 1) / kQueryK, [](int i) { return i; },
        [&](int s, int i) {
          stage_bf16_rows<kGlobRows, kQueryK / 8>(x + seq * H, H, r0, n_glob, i * kQueryK, H, vec,
                                                  slot(s), kQueryRowBytes, tid, kGradThreads);
          stage_bf16_rows<kQueryK, HD / 8>(wgq + h * HD, HN, i * kQueryK, H, 0, HD, true,
                                           slot(s) + M::kXStage, RB, tid, kGradThreads);
        },
        [&](int s, int) {
          const uint32_t xs = smem_addr(slot(s)), ws = xs + M::kXStage;
#pragma unroll
          for (int kk = 0; kk < kQueryK / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(xs + (lane % 16) * kQueryRowBytes + (lane / 16) * 16 + kk * 32, a);
#pragma unroll
            for (int qi = 0; qi < NQ; ++qi) {
              const int dn = warp + W * qi;
              if (dn < HD / 16) {
                uint32_t r[4];
                ldmatrix_x4_trans(ws + gl.bt + 16 * kk * RB + dn * 32, r);
                mma_bf16(acc[qi][0], a, r[0], r[1]);
                mma_bf16(acc[qi][1], a, r[2], r[3]);
              }
            }
          }
        });
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi) {
      const int dn = warp + W * qi;
      if (dn >= HD / 16) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = g + 8 * hi, col = 16 * dn + 8 * half + 2 * t;
          const bool live = row < n_live;
          const auto query = [&](float sum, int c) {
            return live ? round_to<bf16>(__fmul_rn(__fadd_rn(sum, bgq[h * HD + c]), sm_scale))
                        : 0.0f;
          };
          const float q0 = query(acc[qi][half][2 * hi], col);
          const float q1 = query(acc[qi][half][2 * hi + 1], col + 1);
          store_pair(reinterpret_cast<bf16*>(Qs + row * RB) + col, q0, q1);
          if (qg_buf != nullptr && live)
            store_pair(qg_buf + (((size_t)b * nh + h) * G + r0 + row) * HD + col, q0, q1);
        }
    }
  } else {
    glob_query_i8<bf16, HD>(x8, sx, w8, sw, bgq, seq, r0, n_live, H, HN, h, sm_scale,
                            reinterpret_cast<int*>(rings), [&](int i, int col, float q, bool live) {
                              if (qg_buf != nullptr && live)
                                qg_buf[(((size_t)b * nh + h) * G + r0 + i) * HD + col] =
                                    __float2bfloat16(q);
                              reinterpret_cast<bf16*>(Qs + i * RB)[col] = __float2bfloat16(q);
                            });
  }
  if constexpr (kGrad) {
    stage_bf16_rows<kGlobRows, HD / 8>(dctx + seq * HN + h * HD, HN, r0, n_glob, 0, HD, true, dCs,
                                       RB, tid, kGradThreads);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();  // q (and dctx) staged; the rings are free

  // ---- the warp's keys: 32-key tiles [t0, t1) of the n_valid real ones
  const int nt = (n_valid + kGlobKeys - 1) / kGlobKeys;
  const int t0 = warp * nt / W, t1 = (warp + 1) * nt / W;
  const auto kslot = [&](int s) { return ring + s * 2 * M::kKeyTile; };
  const auto stage_k = [&](int s, int tt) {
    stage_bf16_rows<kGlobKeys, HD / 8>(KG, HD, tt * kGlobKeys, n_valid, 0, HD, true, kslot(s), RB,
                                       lane, 32);
  };
  const auto stage_kv = [&](int s, int tt) {
    stage_k(s, tt);
    stage_bf16_rows<kGlobKeys, HD / 8>(VG, HD, tt * kGlobKeys, n_valid, 0, HD, true,
                                       kslot(s) + M::kKeyTile, RB, lane, 32);
  };
  const bool lo_live = g < n_live, hi_live = g + 8 < n_live;
  float* red_m = red;
  float* red_d = red + W * kGlobRows;
  float* red_r = red + 2 * W * kGlobRows;

  // ---- pass 1: the row maxima over the real keys
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;
  warp_ring(t0, t1, stage_k, [&](int s, int tt) {
    float xs[4][4];
    glob_scores<HD>(a_q, smem_addr(kslot(s)), gl.b, xs);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (tt * kGlobKeys + 8 * j + 2 * t + e % 2 >= n_valid) continue;
        if (e < 2) {
          m_lo = fmaxf(m_lo, xs[j][e]);
        } else {
          m_hi = fmaxf(m_hi, xs[j][e]);
        }
      }
  });
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);
  if (t == 0) {
    red_m[warp * kGlobRows + g] = m_lo;
    red_m[warp * kGlobRows + g + 8] = m_hi;
  }
  __syncthreads();
  m_lo = glob_over_warps(red_m, g, true);  // the row's exact maximum
  m_hi = glob_over_warps(red_m, g + 8, true);

  // ---- pass 2: e, D, the kept e into P.V; with kGrad dP and rs
  float D_lo = 0.0f, D_hi = 0.0f, rs_lo = 0.0f, rs_hi = 0.0f;
  {
    float o[ND][4];
    zero_acc<HD>(o);
    warp_ring(t0, t1, stage_kv, [&](int s, int tt) {
      const uint32_t ks = smem_addr(kslot(s)), vs = ks + M::kKeyTile;
      const int k0 = tt * kGlobKeys;
      float xs[4][4], ys[4][4];
      glob_scores<HD>(a_q, ks, gl.b, xs);
      if constexpr (kGrad) glob_scores<HD>(a_dc, vs, gl.b, ys);
      uint32_t kb_lo, kb_hi;
      glob_keep_bits(keep, dropout, r0, n_live, k0, kb_lo, kb_hi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const int c = 8 * j + 2 * t + e % 2;
          float pe = 0.0f;
          if ((hi ? hi_live : lo_live) && k0 + c < n_valid) {
            const float ex = rounded_exp<bf16>(xs[j][e], hi ? m_hi : m_lo);
            (hi ? D_hi : D_lo) += ex;
            if (((hi ? kb_hi : kb_lo) >> c) & 1u) pe = ex;
            if constexpr (kGrad) {
              float& rs = hi ? rs_hi : rs_lo;
              rs = fmaf(pe, ys[j][e], rs);
            }
          }
          xs[j][e] = pe;
        }
      glob_times_tile<HD>(xs, vs, gl.bt, o);
    });
    glob_partial<HD>(o, reinterpret_cast<float*>(ring));  // the warp's ring is drained
  }
  D_lo = quad_sum(D_lo);
  D_hi = quad_sum(D_hi);
  if (t == 0) {
    red_d[warp * kGlobRows + g] = D_lo;
    red_d[warp * kGlobRows + g + 8] = D_hi;
  }
  if constexpr (kGrad) {
    rs_lo = quad_sum(rs_lo);
    rs_hi = quad_sum(rs_hi);
    if (t == 0) {
      red_r[warp * kGlobRows + g] = rs_lo;
      red_r[warp * kGlobRows + g + 8] = rs_hi;
    }
  }
  __syncthreads();

  // ctx rows r0 + row < n_glob: O / (D keep_prob), zero where D = 0
  for (int e = tid; e < kGlobRows * HD; e += kGradThreads) {
    const int row = e / HD, col = e % HD;
    if (row >= n_live) break;
    const float d = glob_over_warps(red_d, row, false);
    const float o = glob_combined<HD>(rings, M::kWarpRing, row, col);
    ctx[(seq + r0 + row) * HN + h * HD + col] = from_f32<Tc>(d > 0.0f ? o / (d * keep_prob) : 0.0f);
  }
  if constexpr (kGrad) {
    if (tid < n_live) {
      const float d = glob_over_warps(red_d, tid, false), rs = glob_over_warps(red_r, tid, false);
      const size_t r = ((size_t)b * nh + h) * G + r0 + tid, plane = (size_t)B * nh * G;
      gstats[r] = glob_over_warps(red_m, tid, true);
      gstats[plane + r] = d;
      gstats[2 * plane + r] = d > 0.0f ? rs / (d * keep_prob) : 0.0f;
    }
    // ---- pass 3: dS = round(p_eff dp - (e / D) rs / (D keep_prob)), dqg += dS . kg
    const float Dt_lo = glob_over_warps(red_d, g, false);
    const float Dt_hi = glob_over_warps(red_d, g + 8, false);
    const auto rsn = [&](float d, int row) {
      return d > 0.0f ? glob_over_warps(red_r, row, false) / (d * keep_prob) : 0.0f;
    };
    const float rsn_lo = rsn(Dt_lo, g), rsn_hi = rsn(Dt_hi, g + 8);
    __syncthreads();  // every partial O is read: the rings are free
    float dq[ND][4];
    zero_acc<HD>(dq);
    warp_ring(t0, t1, stage_kv, [&](int s, int tt) {
      const uint32_t ks = smem_addr(kslot(s)), vs = ks + M::kKeyTile;
      const int k0 = tt * kGlobKeys;
      float xs[4][4], ys[4][4];
      glob_scores<HD>(a_q, ks, gl.b, xs);
      glob_scores<HD>(a_dc, vs, gl.b, ys);
      uint32_t kb_lo, kb_hi;
      glob_keep_bits(keep, dropout, r0, n_live, k0, kb_lo, kb_hi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const int c = 8 * j + 2 * t + e % 2;
          float ds = 0.0f;
          if ((hi ? hi_live : lo_live) && k0 + c < n_valid) {
            const float D = hi ? Dt_hi : Dt_lo;
            const float ex = rounded_exp<bf16>(xs[j][e], hi ? m_hi : m_lo);
            const float pe = ((hi ? kb_hi : kb_lo) >> c) & 1u ? ex / (D * keep_prob) : 0.0f;
            ds = round_to<bf16>(pe * ys[j][e] - (ex / D) * (hi ? rsn_hi : rsn_lo));
          }
          xs[j][e] = ds;
        }
      glob_times_tile<HD>(xs, ks, gl.bt, dq);
    });
    glob_partial<HD>(dq, reinterpret_cast<float*>(ring));
    __syncthreads();
    for (int e = tid; e < kGlobRows * HD; e += kGradThreads) {
      const int row = e / HD, col = e % HD;
      if (row >= n_live) break;
      dqg[(seq + r0 + row) * ld + h * HD + col] =
          __float2bfloat16(glob_combined<HD>(rings, M::kWarpRing, row, col) * sm_scale);
    }
  }
}


// ---------------------------------------------------------------- float32

// Blocks of a cluster that share one (row tile, head, sequence) of the
// float32 body, each walking its own contiguous range of the keys. Fixed,
// so the order of every sum, and a row's bits, are the same at any batch.
// On the H100 (rows_core_turns.py; PERF.md) clusters of 4 took kernel 7's
// float32 global rows from 0.100 ms (one block) to 0.038 at the recipe's
// B=2, L=2048, and from 0.099 to 0.084 at B=8; clusters of 2 to 0.064 and
// 0.083.
constexpr int kGlobCluster = 4;
constexpr int kQueryChunk = 16;  // query rows of K a warp stages at a time (float32)

// The float32 body's layout: q's tile and dctx's as float32 rows of HD + 4
// (GradTf32's: ldmatrix reads them, and 32-bit B loads of rows 2 t and 2 t
// + 1, column g, fall on distinct banks), the warps' (m, D, rs) partials,
// the block's (m, D, rs) and partial query that the cluster reads, then
// each warp's slot for a 32-key (k, v) tile in the same rows: one stage,
// so that two blocks fit an SM (83 KB at head dim 64). With clusters of 4
// at B=8, L=2048 that read 0.084 ms for kernel 7's global rows against
// 0.112 with three stages at one block an SM (rows_core_turns.py on the
// H100; PERF.md). The query's chunks of x (kQueryChunk + 4 floats a row, for
// ldmatrix) and Wgq (HD + 8: a lane reads column g of rows t and t + 4, on
// distinct banks) go through the same slots, and the warps' partial q, O
// and dqg (a warp's in its own slot; the block's, summed over the warps, O's
// and dqg's in warp 0's) reuse them.
template <int HD>
struct GlobTf32 {
  static constexpr int RF = GradTf32<HD>::kRowFloats;
  static constexpr int RB = GradTf32<HD>::kRowBytes;
  static constexpr int kRowTile = kGlobRows * RB;
  static constexpr int kKeyTile = kGlobKeys * RB;
  static constexpr int kWarpRing = 2 * kKeyTile;
  static constexpr int kRed = 3 * kGradWarps * kGlobRows * (int)sizeof(float);
  static constexpr int kClusterRed = 3 * kGlobRows * (int)sizeof(float);
  static constexpr int kQueryPart = kGlobRows * HD * (int)sizeof(float);
  static constexpr int kXFloats = kQueryChunk + 4;
  static constexpr int kWFloats = HD + 8;
  static constexpr int kXChunk = kGlobRows * kXFloats * (int)sizeof(float);
  static constexpr int kQChunk = kXChunk + kQueryChunk * kWFloats * (int)sizeof(float);
  static_assert(kQChunk <= kWarpRing, "a query chunk fits a warp's slot");
  static_assert(kGlobRows * HD * (int)sizeof(float) <= kWarpRing, "a warp's partial fits its slot");
  static_assert(kRowTile % 16 == 0 && kXChunk % 16 == 0 && kQueryPart % 16 == 0,
                "16-byte aligned regions");
};

template <int HD, bool kGrad>
__host__ __device__ constexpr size_t global_rows_smem_tf32() {
  using M = GlobTf32<HD>;
  return (size_t)(kGrad ? 2 : 1) * M::kRowTile + M::kRed + M::kClusterRed + M::kQueryPart +
         (size_t)kGradWarps * M::kWarpRing;
}

// rows [r0, r0 + R) and columns [c0, c0 + 4 NC) of a float32 matrix X (row
// stride `stride` elements) into dst (rows of `pitch` floats) by nt threads,
// this one tid: rows at or beyond `hi` and columns at or beyond `width`
// zero. 16-byte cp.async copies when `vec` (stride, c0 and width multiples
// of 4, X 16-byte aligned), else element-wise stores.
template <int R, int NC>
__device__ __forceinline__ void stage_f32_block(const float* X, size_t stride, int r0, int hi,
                                                int c0, int width, bool vec, unsigned char* dst,
                                                int pitch, int tid, int nt) {
  for (int e = tid; e < R * NC; e += nt) {
    const int r = e / NC, c = e % NC, l = r0 + r, col = c0 + 4 * c;
    float* d = reinterpret_cast<float*>(dst) + r * pitch + 4 * c;
    if (vec) {
      const bool in = l < hi && col < width;
      cp_async16(smem_addr(d), in ? X + (size_t)l * stride + col : X, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d[i] = l < hi && col + i < width ? X[(size_t)l * stride + col + i] : 0.0f;
    }
  }
}

// The float32 global rows: global_rows_tile_mma's computation on float32
// x, Wgq, kg, vg and dctx (ctx, qg and dqg float32; e = exp(s - m)
// unrounded, the TPU kernel's float32 exponent), every product as 3xTF32 on
// mma.sync m16n8k8 (ptx.cuh tf32_split and mma_tf32x3):
//   query  x's 16 rows times the head's (H, HD) slice of Wgq, K = H split
//          over the cluster's warps (rank r's warp w the (r W + w)-th of
//          W kGlobCluster ranges), each staged in 16-deep chunks through
//          the warp's slot (A by ldmatrix, B by 32-bit loads); the partials
//          summed over the warps in order, then, in every block, over the
//          ranks in order (so each holds the same q); in W8A8 (float32
//          activations) the exact int32 loop of the bf16 body
//          (glob_query_i8);
//   S, dP  attention_grad_mma.cuh's scores_tf32 on the q (or dctx) tile and
//          a key tile, the warp's A rows being the tile's 16;
//   P.V, dS . kg  its accumulate_tf32, which takes P (or dS) from the
//          accumulators in the k8 step's order 0, 2, 4, 6, 1, 3, 5, 7.
// One (row tile, head, sequence) belongs to a cluster of kGlobCluster
// blocks (blockIdx.x / kGlobCluster is the row tile): block r walks the
// r-th of kGlobCluster contiguous ranges of the 32-key tiles, split over
// its warps as in the bf16 body (each warp staging one tile at a time), so
// at the recipe's micro-batch of 2 the 24 (head, sequence) chains run on
// 96 SMs, not 24. The blocks take the
// rows' maxima from every block's shared memory (ld_cluster) after pass 1,
// so e is taken against the row's exact maximum, and D and rs after pass
// 2; rank 0 adds the blocks' partial O and dqg, each the sum of its warps'
// in warp order, in rank order. Every sum runs in a fixed order with no
// atomics: two calls give the same bits. smem holds
// global_rows_smem_tf32<HD, kGrad>() bytes, 16-byte aligned; 128 threads,
// launched in clusters of (kGlobCluster, 1, 1).
template <int HD, bool kGrad, typename Keep>
__device__ __forceinline__ void global_rows_tile_tf32(
    const float* x, const float* wgq, const float* bgq, const float* gkv, const int32_t* counts,
    bool dropout, Keep keep, const float* dctx, float* ctx, float* qg_buf, float* gstats,
    float* dqg, int B, int L, int H, int nh, int G, int ld, float sm_scale, float keep_prob,
    const int8_t* x8, const float* sx, const int8_t* w8, const float* sw, unsigned char* smem) {
  using M = GlobTf32<HD>;
  constexpr int RB = M::RB, ND = HD / 8, W = kGradWarps, CS = kGlobCluster;
  const int r0 = blockIdx.x / CS * kGlobRows, h = blockIdx.y, b = blockIdx.z;
  const int n_valid = counts[2 * b], n_glob = counts[2 * b + 1];
  if (r0 >= n_glob) return;  // the same for the whole cluster
  const int rank = cluster_rank(), n_live = min(kGlobRows, n_glob - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int HN = nh * HD;
  const size_t head = (size_t)L * HD, seq = (size_t)b * L;
  const float* KG = gkv + ((size_t)b * nh + h) * head;
  const float* VG = gkv + (((size_t)B + b) * nh + h) * head;
  unsigned char* Qs = smem;
  unsigned char* dCs = Qs + M::kRowTile;
  float* red = reinterpret_cast<float*>(dCs + (kGrad ? M::kRowTile : 0));  // (m, D, rs) x (W, 16)
  float* cl = red + 3 * W * kGlobRows;  // the block's (m, D, rs) x 16, which the cluster reads
  float* qpart = cl + 3 * kGlobRows;     // the block's partial q (16, HD), which it reads too
  unsigned char* rings = reinterpret_cast<unsigned char*>(qpart) + M::kQueryPart;
  unsigned char* ring = rings + warp * M::kWarpRing;
  float* part = reinterpret_cast<float*>(rings);  // the block's partial O or dqg, for rank 0
  GradLaneF32<HD> gl;  // its b and bk offsets; its A rows the tile's 16, whatever the warp
  gl.a = (lane % 16) * RB + (lane / 16) * 16;
  const uint32_t a_q = smem_addr(Qs), a_dc = smem_addr(dCs);
  // the live rows of the warps' (16, HD) partials in their rings, summed in
  // warp order into dst
  const auto sum_warps = [&](float* dst) {
    for (int e = tid; e < n_live * HD; e += kGradThreads)
      dst[e] = glob_combined<HD>(rings, M::kWarpRing, e / HD, e % HD);
  };
  // element i of every block's copy of v (v + i), their maximum or their
  // sum in rank order
  const auto over_ranks = [&](const float* v, int i, bool take_max) {
    float s = ld_cluster(v + i, 0);
#pragma unroll
    for (int r = 1; r < CS; ++r) {
      const float u = ld_cluster(v + i, r);
      s = take_max ? fmaxf(s, u) : s + u;
    }
    return s;
  };

  // ---- qg = (x_g Wgq + bgq) sm_scale for the tile's rows
  if (x8 == nullptr) {
    constexpr int KC = kQueryChunk;
    const int span = ((H + CS * W - 1) / (CS * W) + KC - 1) / KC * KC;  // K rows a warp
    const int k_lo = (rank * W + warp) * span, k_hi = min(H, k_lo + span);
    float acc[ND][4];
    zero_acc<HD>(acc);
    const bool vec = H % 4 == 0;
    warp_ring<1>(
        0, k_hi > k_lo ? (k_hi - k_lo + KC - 1) / KC : 0,
        [&](int, int c) {
          stage_f32_block<kGlobRows, KC / 4>(x + seq * H, H, r0, n_glob, k_lo + KC * c, k_hi, vec,
                                             ring, M::kXFloats, lane, 32);
          stage_f32_block<KC, HD / 4>(wgq + h * HD, HN, k_lo + KC * c, k_hi, 0, HD, true,
                                      ring + M::kXChunk, M::kWFloats, lane, 32);
        },
        [&](int, int) {
          const uint32_t xs = smem_addr(ring) + (lane % 16) * 4 * M::kXFloats + (lane / 16) * 16;
          const float* ws =
              reinterpret_cast<const float*>(ring + M::kXChunk) + t * M::kWFloats + g;
#pragma unroll
          for (int kk = 0; kk < KC / 8; ++kk) {
            uint32_t r[4], ab[4], as[4];
            ldmatrix_x4(xs + kk * 32, r);
#pragma unroll
            for (int i = 0; i < 4; ++i) tf32_split(__uint_as_float(r[i]), ab[i], as[i]);
#pragma unroll
            for (int dn = 0; dn < ND; ++dn) {
              const float* wc = ws + 8 * kk * M::kWFloats + 8 * dn;
              uint32_t bb0, bs0, bb1, bs1;
              tf32_split(wc[0], bb0, bs0);
              tf32_split(wc[4 * M::kWFloats], bb1, bs1);
              mma_tf32x3(acc[dn], ab, as, bb0, bb1, bs0, bs1);
            }
          }
        });
    glob_partial<HD>(acc, reinterpret_cast<float*>(ring));  // the warp's ring is drained
    __syncthreads();
    sum_warps(qpart);
    cluster_sync();
    for (int e = tid; e < kGlobRows * HD; e += kGradThreads) {
      const int row = e / HD, col = e % HD;
      float q = 0.0f;
      if (row < n_live) {
        q = __fmul_rn(__fadd_rn(over_ranks(qpart, e, false), bgq[h * HD + col]), sm_scale);
        if (qg_buf != nullptr && rank == 0)
          qg_buf[(((size_t)b * nh + h) * G + r0 + row) * HD + col] = q;
      }
      reinterpret_cast<float*>(Qs + row * RB)[col] = q;
    }
  } else {
    const auto store = [&](int i, int col, float q, bool live) {
      if (qg_buf != nullptr && live && rank == 0)
        qg_buf[(((size_t)b * nh + h) * G + r0 + i) * HD + col] = q;
      reinterpret_cast<float*>(Qs + i * RB)[col] = q;
    };
    glob_query_i8<float, HD>(x8, sx, w8, sw, bgq, seq, r0, n_live, H, HN, h, sm_scale,
                             reinterpret_cast<int*>(rings), store);
  }
  if constexpr (kGrad) {
    stage_f32_block<kGlobRows, HD / 4>(dctx + seq * HN + h * HD, HN, r0, n_glob, 0, HD, true, dCs,
                                       M::RF, tid, kGradThreads);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();  // q (and dctx) staged; the rings are free

  // ---- the warp's keys: its part of the block's range of 32-key tiles of
  // the n_valid real ones
  const int nt = (n_valid + kGlobKeys - 1) / kGlobKeys;
  const int b0 = rank * nt / CS, nb = (rank + 1) * nt / CS - b0;
  const int t0 = b0 + warp * nb / W, t1 = b0 + (warp + 1) * nb / W;
  unsigned char* vslot = ring + M::kKeyTile;  // the warp's one stage: k, then v
  const auto stage_k = [&](int, int tt) {
    stage_f32_block<kGlobKeys, HD / 4>(KG, HD, tt * kGlobKeys, n_valid, 0, HD, true, ring, M::RF,
                                       lane, 32);
  };
  const auto stage_kv = [&](int, int tt) {
    stage_k(0, tt);
    stage_f32_block<kGlobKeys, HD / 4>(VG, HD, tt * kGlobKeys, n_valid, 0, HD, true, vslot, M::RF,
                                       lane, 32);
  };
  const bool lo_live = g < n_live, hi_live = g + 8 < n_live;
  float* red_m = red;
  float* red_d = red + W * kGlobRows;
  float* red_r = red + 2 * W * kGlobRows;
  float* cl_m = cl;
  float* cl_d = cl + kGlobRows;
  float* cl_r = cl + 2 * kGlobRows;

  // ---- pass 1: the row maxima over the real keys, the block's, then the
  // cluster's: the row's exact maximum
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;
  warp_ring<1>(t0, t1, stage_k, [&](int, int tt) {
    float xs[4][4];
    scores_tf32<HD>(a_q, smem_addr(ring), gl, 0, xs);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (tt * kGlobKeys + 8 * j + 2 * t + e % 2 >= n_valid) continue;
        if (e < 2) {
          m_lo = fmaxf(m_lo, xs[j][e]);
        } else {
          m_hi = fmaxf(m_hi, xs[j][e]);
        }
      }
  });
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);
  if (t == 0) {
    red_m[warp * kGlobRows + g] = m_lo;
    red_m[warp * kGlobRows + g + 8] = m_hi;
  }
  __syncthreads();
  if (tid < kGlobRows) cl_m[tid] = glob_over_warps(red_m, tid, true);
  cluster_sync();
  m_lo = over_ranks(cl_m, g, true);
  m_hi = over_ranks(cl_m, g + 8, true);

  // ---- pass 2: e, D, the kept e into P.V; with kGrad dP and rs
  float D_lo = 0.0f, D_hi = 0.0f, rs_lo = 0.0f, rs_hi = 0.0f;
  {
    float o[ND][4];
    zero_acc<HD>(o);
    warp_ring<1>(t0, t1, stage_kv, [&](int, int tt) {
      const uint32_t ks = smem_addr(ring), vs = smem_addr(vslot);
      const int k0 = tt * kGlobKeys;
      float xs[4][4], ys[4][4];
      scores_tf32<HD>(a_q, ks, gl, 0, xs);
      if constexpr (kGrad) scores_tf32<HD>(a_dc, vs, gl, 0, ys);
      uint32_t kb_lo, kb_hi;
      glob_keep_bits(keep, dropout, r0, n_live, k0, kb_lo, kb_hi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const int c = 8 * j + 2 * t + e % 2;
          float pe = 0.0f;
          if ((hi ? hi_live : lo_live) && k0 + c < n_valid) {
            const float ex = rounded_exp<float>(xs[j][e], hi ? m_hi : m_lo);
            (hi ? D_hi : D_lo) += ex;
            if (((hi ? kb_hi : kb_lo) >> c) & 1u) pe = ex;
            if constexpr (kGrad) {
              float& rs = hi ? rs_hi : rs_lo;
              rs = fmaf(pe, ys[j][e], rs);
            }
          }
          xs[j][e] = pe;
        }
      accumulate_tf32<HD>(xs, reinterpret_cast<const float*>(vslot) + gl.bk, 0, o);
    });
    glob_partial<HD>(o, reinterpret_cast<float*>(ring));  // the warp's ring is drained
  }
  D_lo = quad_sum(D_lo);
  D_hi = quad_sum(D_hi);
  if (t == 0) {
    red_d[warp * kGlobRows + g] = D_lo;
    red_d[warp * kGlobRows + g + 8] = D_hi;
  }
  if constexpr (kGrad) {
    rs_lo = quad_sum(rs_lo);
    rs_hi = quad_sum(rs_hi);
    if (t == 0) {
      red_r[warp * kGlobRows + g] = rs_lo;
      red_r[warp * kGlobRows + g + 8] = rs_hi;
    }
  }
  __syncthreads();
  if (tid < kGlobRows) {
    cl_d[tid] = glob_over_warps(red_d, tid, false);
    if (kGrad) cl_r[tid] = glob_over_warps(red_r, tid, false);
  }
  sum_warps(part);
  cluster_sync();

  // ctx rows r0 + row < n_glob: O / (D keep_prob), zero where D = 0; with
  // kGrad the rows' statistics
  if (rank == 0) {
    for (int e = tid; e < n_live * HD; e += kGradThreads) {
      const int row = e / HD, col = e % HD;
      const float d = over_ranks(cl_d, row, false), o = over_ranks(part, e, false);
      ctx[(seq + r0 + row) * HN + h * HD + col] = d > 0.0f ? o / (d * keep_prob) : 0.0f;
    }
    if (kGrad && tid < n_live) {
      const float d = over_ranks(cl_d, tid, false), rs = over_ranks(cl_r, tid, false);
      const size_t r = ((size_t)b * nh + h) * G + r0 + tid, plane = (size_t)B * nh * G;
      gstats[r] = over_ranks(cl_m, tid, true);
      gstats[plane + r] = d;
      gstats[2 * plane + r] = d > 0.0f ? rs / (d * keep_prob) : 0.0f;
    }
  }
  if constexpr (kGrad) {
    // ---- pass 3: dS = p_eff dp - (e / D) rs / (D keep_prob), dqg += dS . kg
    const float Dt_lo = over_ranks(cl_d, g, false), Dt_hi = over_ranks(cl_d, g + 8, false);
    const auto rsn = [&](float d, int row) {
      return d > 0.0f ? over_ranks(cl_r, row, false) / (d * keep_prob) : 0.0f;
    };
    const float rsn_lo = rsn(Dt_lo, g), rsn_hi = rsn(Dt_hi, g + 8);
    cluster_sync();  // rank 0 has read every block's partial O: the rings are free
    float dq[ND][4];
    zero_acc<HD>(dq);
    warp_ring<1>(t0, t1, stage_kv, [&](int, int tt) {
      const uint32_t ks = smem_addr(ring), vs = smem_addr(vslot);
      const int k0 = tt * kGlobKeys;
      float xs[4][4], ys[4][4];
      scores_tf32<HD>(a_q, ks, gl, 0, xs);
      scores_tf32<HD>(a_dc, vs, gl, 0, ys);
      uint32_t kb_lo, kb_hi;
      glob_keep_bits(keep, dropout, r0, n_live, k0, kb_lo, kb_hi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const int c = 8 * j + 2 * t + e % 2;
          float ds = 0.0f;
          if ((hi ? hi_live : lo_live) && k0 + c < n_valid) {
            const float D = hi ? Dt_hi : Dt_lo;
            const float ex = rounded_exp<float>(xs[j][e], hi ? m_hi : m_lo);
            const float pe = ((hi ? kb_hi : kb_lo) >> c) & 1u ? ex / (D * keep_prob) : 0.0f;
            ds = pe * ys[j][e] - (ex / D) * (hi ? rsn_hi : rsn_lo);
          }
          xs[j][e] = ds;
        }
      accumulate_tf32<HD>(xs, reinterpret_cast<const float*>(ring) + gl.bk, 0, dq);
    });
    glob_partial<HD>(dq, reinterpret_cast<float*>(ring));
    __syncthreads();
    sum_warps(part);
    cluster_sync();
    if (rank == 0)
      for (int e = tid; e < n_live * HD; e += kGradThreads)
        dqg[(seq + r0 + e / HD) * ld + h * HD + e % HD] = over_ranks(part, e, false) * sm_scale;
  }
  cluster_sync();  // no block leaves while rank 0 reads its shared memory
}

}  // namespace spk
