// The bf16 body of the rows kernels on the tensor cores (band_rows_kernel in
// sliding_attention.cuh, bigbird_rows_kernel in bigbird_attention.cuh,
// attn_rows_kernel in train_attention.cu): the attention of 64 query rows
// of one (head, sequence) over the key tiles their pattern reaches, as the
// inference blocks' attention (kernels 7 and 8, float and W8A8 modes), the
// training forwards' attention and, with kGrad, the training backwards'
// statistics pass (rows 10, 12 and 13).
//
// Replaces the score and context products of the TPU kernels
// spokennlp_tpu/ops/pallas/sliding_block.py:156-186,
// spokennlp_tpu/ops/pallas/bigbird_block_kernel.py:150-186 and
// spokennlp_tpu/ops/pallas/train_blocks.py:103-122: S = q k^T and
// P V as dot_general on bf16 operands with float32 sums, e = exp((s -
// m).astype(bf16)) rounded to bf16 against the row's true maximum over all
// its key groups, the denominator D = sum e in float32, ctx = (kept e) . v /
// (D keep_prob). mma.sync m16n8k16 bf16 with float32 sums computes those
// products; every rounding point stays where the CUDA-core bodies (and the
// TPU kernels) have it, and only the order of the float32 sums differs.
//
// The block: kGradWarps = 4 warps over 64 query rows, warp w owning rows
// 16 w .. 16 w + 15. In the m16n8 fragments lane (g, t) = (lane / 4, lane %
// 4) holds rows g and g + 8 and columns 2 t and 2 t + 1 of each n8 tile
// (attention_core.cuh's layout), so an element's key is k0 + 32 c + 8 j +
// 2 t (+ 1) for chunk c and n8 tile j, and a row's maximum and sums reduce
// over the 4 lanes of a quad. q's 64 rows (and with kGrad dctx's, rows
// below dc_lo read as zero) are staged once; key and value tiles of 64
// rows stream through attention_grad_mma.cuh's two-stage cp.async ring
// (stage_grad_rows, grad_ring: rows padded to an odd number of 16-byte
// units, rows outside [0, L) zero-filled through the copy's source size)
// and are read with its ldmatrix offsets (GradLane). Two passes over the
// live key tiles, each in chunks of 32 keys:
//   pass 1  S from q's A fragments and k's B fragments, the mask on each
//           element from its (row, key), the running maximum; then the
//           quad's maximum: the row's true maximum, which the exponent
//           needs and the backward's statistics keep;
//   pass 2  S again, e = rounded_exp<bf16>(s, m) on the fragments, D += e,
//           the keep bit from the caller's Philox counters, p_eff = kept e
//           packed into A fragments with bf16_pair (e is a bf16 value, so
//           the pack is exact), O += P V through ldmatrix.trans of v; with
//           kGrad also dP = dctx v^T on the tensor cores and rs += p_eff dp
//           on the fragments.
// The epilogue writes ctx = O / (D keep_prob) rounded to Tc (bf16, or
// float32 in W8A8, where the block's row quantisation reads it) and zero
// for a row with D = 0, and with kGrad the row statistics (m, D,
// rowsum(dp p_eff) / (D keep_prob)).
//
// A Split policy decides whose rows a block's maxima and sums are:
// WholeRows (every rows kernel but one) has the block walk every key tile
// of its rows; ClusterRows (BigBird's global tiles, bigbird_attention.cuh)
// splits one query tile's key tiles over a thread-block cluster, takes the
// rows' maxima over the cluster between the passes and adds the blocks' D,
// O and rs in rank order into rank 0, which stores them.
//
// The dense training kernels (train_attention.cu) run the same body over
// every key tile of the sequence, with a score functor that scales the
// product and adds the TPU kernel's -1e9 on masked keys (RawScore, the
// product itself, for the others).
//
// float32 has a sibling on the same warps, ring and callbacks
// (rows_tile_tf32): S, dP and P V as 3xTF32 on mma.sync m16n8k8
// (attention_grad_mma.cuh's float32 helpers: q, k, dctx and v's fragments
// for S and dP through ldmatrix of float32 rows padded to HD + 4, P from
// the score accumulators in the column order (0, 2, 4, 6, 1, 3, 5, 7) of
// each k8 step, v's rows 2 t and 2 t + 1 by 32-bit loads), e = exp(s - m)
// in float32. Every rows kernel takes both through rows_tile, the same
// callbacks in either element type: the float32 forwards and statistics
// passes of rows 10, 12 and 13 and kernels 7 and 8's float32 modes (float,
// and W8A8 with float32 activations) run the float32 sibling.
//
// What bounds it. At kernel 7's shape (B=8, L=2048, 12 heads of 64, window
// 512) the three products the block runs (S twice, P V) over its 9 band
// tiles and the global-column tile take about 4.8e10 operations, 0.05 ms at
// the bf16 tensor-core peak (0.29 ms as 3xTF32, whose three TF32 products a
// float32 product take a third of the TF32 peak each), against some 100 MB
// of q, k, v and ctx in bf16, 0.03 ms at 3.35 TB/s (0.06 ms in float32).
// What stays on the CUDA cores is the work on each of about 1e8 allowed
// (row, key) pairs: the mask, two roundings and an exp, and in training a
// Philox-4x32-10 draw.
#pragma once

#include "attention_grad_mma.cuh"

namespace spk {

// One key tile of a query tile: its first key k0, the end k_end of the keys
// the BigBird kernel allows in it, the dropout tag of its counter space and
// the offset from key to the counter's column.
struct KeyTile {
  int k0, k_end;
  uint32_t tag;
  int col_off;
};

// shared memory of the bf16 body: q's tile, dctx's with kGrad, then two
// stages of (k tile, v tile)
template <int HD, bool kGrad>
__host__ __device__ constexpr size_t rows_smem_mma() {
  return (size_t)(kGrad ? 6 : 5) * GradMma<HD>::kTileBytes;
}

// x[j] = A . B^T for the warp's 16 rows against keys 32 c + 8 j .. + 7 of a
// staged tile: A's fragments from the tile at a_tile (q or dctx), B's from
// the tile at b_tile (k or v) as its rows stand
template <int HD>
__device__ __forceinline__ void rows_scores(uint32_t a_tile, uint32_t b_tile,
                                            const GradLane<HD>& lane, int c, float (&x)[4][4]) {
  constexpr int RB = GradMma<HD>::kRowBytes;
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a_tile + lane.a + kk * 32, a);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
      ldmatrix_x4(b_tile + lane.b + (32 * c + 16 * nj) * RB + kk * 32, r);
      mma_bf16(x[2 * nj], a, r[0], r[1]);
      mma_bf16(x[2 * nj + 1], a, r[2], r[3]);
    }
  }
}

// The score of an element as the sliding-window and BigBird kernels take it:
// the product itself (their q is pre-scaled; their mask is the Allowed
// functor's). The dense training kernels scale it and add the TPU kernel's
// -1e9 on masked keys instead (train_attention.cu).
struct RawScore {
  __device__ __forceinline__ float operator()(const KeyTile&, int, int, float x) const {
    return x;
  }
};

// Whose rows a block's maxima and sums are. WholeRows: the block walks
// every key tile of its rows, so they are the rows' own (every rows kernel
// but BigBird's global tiles).
struct WholeRows {
  __device__ __forceinline__ void maxima(float&, float&) const {}
  template <bool kGrad, int ND>
  __device__ __forceinline__ bool totals(float (&)[ND][4], float&, float&, float&, float&,
                                         unsigned char*) const {
    return true;
  }
};

// ClusterRows: the key tiles of one query tile split over the `size` blocks
// (kMaxCluster at most) of a thread-block cluster, this one `rank`; xch: 3
// kTile floats of its shared memory (the rows' m, D and rs, which the
// cluster reads). maxima takes each row's maximum over every block, so e is
// taken against the row's true maximum (the same bits as one block's walk);
// totals adds the blocks' D, rs and O in rank order into rank 0 (each
// block's partial O, float32 (64, HD), through its drained ring) and says
// whether this block stores the rows (rank 0 does). Every thread of every
// block calls both; nothing is atomic, so two calls give the same bits. A
// lane reads a block's values all before it adds them, so its reads of
// the other blocks' shared memory are in flight together.
constexpr int kMaxCluster = 8;  // the portable cluster size

struct ClusterRows {
  float* xch;
  int rank, size;

  __device__ __forceinline__ void maxima(float& m_lo, float& m_hi) const {
    const int g = (threadIdx.x % 32) / 4, lo = 16 * (threadIdx.x / 32) + g;
    if (threadIdx.x % 4 == 0) {
      xch[lo] = m_lo;
      xch[lo + 8] = m_hi;
    }
    cluster_sync();
    float v_lo[kMaxCluster], v_hi[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < size) {
        const uint32_t at = cluster_addr(xch + lo, r);
        v_lo[r] = ld_cluster_at(at);
        v_hi[r] = ld_cluster_at(at + 8 * sizeof(float));
      }
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < size) {
        m_lo = fmaxf(m_lo, v_lo[r]);
        m_hi = fmaxf(m_hi, v_hi[r]);
      }
  }

  template <bool kGrad, int ND>
  __device__ __forceinline__ bool totals(float (&o)[ND][4], float& D_lo, float& D_hi,
                                         float& rs_lo, float& rs_hi, unsigned char* ring) const {
    constexpr int HD = 8 * ND;
    const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4, lo = 16 * (threadIdx.x / 32) + g;
    // the byte offset of accumulator (nn, e) in a block's partial O
    const auto at = [&](int nn, int e) {
      return ((lo + 8 * (e / 2)) * HD + 8 * nn + 2 * t + e % 2) * 4;
    };
    float* part = reinterpret_cast<float*>(ring);
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int nn = 0; nn < ND; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[at(nn, e) / 4] = o[nn][e];
    if (t == 0) {
      xch[kTile + lo] = D_lo;
      xch[kTile + lo + 8] = D_hi;
      if (kGrad) {
        xch[2 * kTile + lo] = rs_lo;
        xch[2 * kTile + lo + 8] = rs_hi;
      }
    }
    cluster_sync();
    if (rank == 0) {
      for (int r = 0; r < size; ++r) {
        const uint32_t pr = cluster_addr(part, r), xr = cluster_addr(xch, r);
        float v[ND][4], d[4];
#pragma unroll
        for (int nn = 0; nn < ND; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[nn][e] = ld_cluster_at(pr + at(nn, e));
        d[0] = ld_cluster_at(xr + (kTile + lo) * 4);
        d[1] = ld_cluster_at(xr + (kTile + lo + 8) * 4);
        if (kGrad) {
          d[2] = ld_cluster_at(xr + (2 * kTile + lo) * 4);
          d[3] = ld_cluster_at(xr + (2 * kTile + lo + 8) * 4);
        }
        const auto add = [&](float& acc, float x) { acc = r == 0 ? x : acc + x; };
#pragma unroll
        for (int nn = 0; nn < ND; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) add(o[nn][e], v[nn][e]);
        add(D_lo, d[0]);
        add(D_hi, d[1]);
        if (kGrad) {
          add(rs_lo, d[2]);
          add(rs_hi, d[3]);
        }
      }
    }
    cluster_sync();  // no block leaves while rank 0 reads its shared memory
    return rank == 0;
  }
};

// two adjacent outputs of a row
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store_pair(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

// The rows [q0, q0 + 64) of one (head, sequence), those below q_end stored.
// Q, K, V: the (L, HD) slabs; dC: dctx's rows (stride dc_stride), rows
// below dc_lo read as zero (kGrad only). live(i, kt) fills key tile i < n
// and says whether it holds an allowed key (the same for every thread);
// allowed(kt, row, key) is the mask, score(kt, row, key, x) the score of an
// allowed element from its product x, and keep(kt, row, key) the dropout
// bit. out: ctx's row 0 of the head (row stride out_stride); stats: the
// statistics' row 0 of (b, h) in its first plane (kGrad only). smem holds
// rows_smem_mma<HD, kGrad>(), 16-byte aligned; 128 threads.
template <int HD, bool kGrad, typename Tc, typename Live, typename Allowed, typename Keep,
          typename Score = RawScore, typename Split = WholeRows>
__device__ __forceinline__ void rows_tile_mma(const __nv_bfloat16* Q, const __nv_bfloat16* K,
                                              const __nv_bfloat16* V, const __nv_bfloat16* dC,
                                              size_t dc_stride, int dc_lo, int q0, int q_end,
                                              int L, int n, Live live, Allowed allowed, Keep keep,
                                              float keep_prob, Tc* out, size_t out_stride,
                                              float* stats, size_t plane, unsigned char* smem,
                                              Score score = Score{}, Split split = Split{}) {
  using Mm = GradMma<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int RB = Mm::kRowBytes, ND = HD / 8;
  unsigned char* Qs = smem;
  unsigned char* dCs = smem + Mm::kTileBytes;
  unsigned char* ring = dCs + (kGrad ? Mm::kTileBytes : 0);  // stage s: k, then v
  const auto slot = [&](int s) { return ring + s * 2 * Mm::kTileBytes; };
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
  const bool live_w = q0 + 16 * warp < q_end;  // warp-uniform
  const GradLane<HD> lane;
  const uint32_t qs = smem_addr(Qs), dcs = smem_addr(dCs);
  const auto next = [&](int i) {
    KeyTile kt;
    while (i < n && !live(i, kt)) ++i;
    return i;
  };
  // key tile i's k (and with_v its v) into ring slot s
  const auto stage = [&](int s, int i, bool with_v) {
    KeyTile kt;
    live(i, kt);
    stage_grad_rows<HD>(K, HD, kt.k0, 0, L, slot(s));
    if (with_v) stage_grad_rows<HD>(V, HD, kt.k0, 0, L, slot(s) + Mm::kTileBytes);
  };

  stage_grad_rows<HD>(Q, HD, q0, 0, L, Qs);
  if constexpr (kGrad) stage_grad_rows<HD>(dC, dc_stride, q0, dc_lo, L, dCs);

  // pass 1: the row maxima over the allowed keys of every live tile
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;
  grad_ring(n, next, [&](int s, int i) { stage(s, i, false); }, [&](int s, int i) {
    if (!live_w) return;
    KeyTile kt;
    live(i, kt);
#pragma unroll
    for (int c = 0; c < kTile / 32; ++c) {
      float x[4][4];
      rows_scores<HD>(qs, smem_addr(slot(s)), lane, c, x);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt.k0 + 32 * c + 8 * j + 2 * t + e % 2;
          if (e < 2) {
            if (allowed(kt, r_lo, key)) m_lo = fmaxf(m_lo, score(kt, r_lo, key, x[j][e]));
          } else if (allowed(kt, r_hi, key)) {
            m_hi = fmaxf(m_hi, score(kt, r_hi, key, x[j][e]));
          }
        }
    }
  });
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);
  split.maxima(m_lo, m_hi);

  // pass 2: e, D, the kept e into P V, with kGrad dP and rowsum(dp p_eff)
  float D_lo = 0.0f, D_hi = 0.0f, rs_lo = 0.0f, rs_hi = 0.0f;
  float o[ND][4];
  zero_acc<HD>(o);
  grad_ring(
      n, next, [&](int s, int i) { stage(s, i, true); },
      [&](int s, int i) {
        if (!live_w) return;
        KeyTile kt;
        live(i, kt);
        const uint32_t ks = smem_addr(slot(s)), vs = ks + Mm::kTileBytes;
#pragma unroll
        for (int c = 0; c < kTile / 32; ++c) {
          float x[4][4], y[4][4];
          rows_scores<HD>(qs, ks, lane, c, x);
          if constexpr (kGrad) rows_scores<HD>(dcs, vs, lane, c, y);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool hi = e >= 2;
              const int key = kt.k0 + 32 * c + 8 * j + 2 * t + e % 2, row = hi ? r_hi : r_lo;
              float pe = 0.0f;
              if (allowed(kt, row, key)) {
                const float ex =
                    rounded_exp<bf16>(score(kt, row, key, x[j][e]), hi ? m_hi : m_lo);
                (hi ? D_hi : D_lo) += ex;
                if (keep(kt, row, key)) pe = ex;
                if constexpr (kGrad) {
                  float& rs = hi ? rs_hi : rs_lo;
                  rs = fmaf(pe, y[j][e], rs);
                }
              }
              x[j][e] = pe;
            }
          // O += P V over the chunk's 32 keys, 16 a k-step
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint32_t a[4] = {bf16_pair(x[2 * kk][0], x[2 * kk][1]),
                                   bf16_pair(x[2 * kk][2], x[2 * kk][3]),
                                   bf16_pair(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                                   bf16_pair(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
            for (int dn = 0; dn < HD / 16; ++dn) {
              uint32_t r[4];
              ldmatrix_x4_trans(vs + lane.bt + (32 * c + 16 * kk) * RB + dn * 32, r);
              mma_bf16(o[2 * dn], a, r[0], r[1]);
              mma_bf16(o[2 * dn + 1], a, r[2], r[3]);
            }
          }
        }
      });

  D_lo = quad_sum(D_lo);
  D_hi = quad_sum(D_hi);
  if constexpr (kGrad) {
    rs_lo = quad_sum(rs_lo);
    rs_hi = quad_sum(rs_hi);
  }
  if (!split.template totals<kGrad>(o, D_lo, D_hi, rs_lo, rs_hi, ring) || !live_w) return;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int l = hi ? r_hi : r_lo;
    if (l >= q_end) continue;
    const float d = hi ? D_hi : D_lo, denom = d * keep_prob;
    Tc* dst = out + (size_t)l * out_stride + 2 * t;
#pragma unroll
    for (int nn = 0; nn < ND; ++nn)
      store_pair(dst + 8 * nn, d > 0.0f ? o[nn][2 * hi] / denom : 0.0f,
                 d > 0.0f ? o[nn][2 * hi + 1] / denom : 0.0f);
    if (kGrad && t == 0) {
      stats[l] = hi ? m_hi : m_lo;
      stats[plane + l] = d;
      stats[2 * plane + l] = d > 0.0f ? (hi ? rs_hi : rs_lo) / denom : 0.0f;
    }
  }
}

// shared memory of the float32 body: q's tile, dctx's with kGrad, then two
// stages of (k tile, v tile), float32 rows of HD + 4
template <int HD, bool kGrad>
__host__ __device__ constexpr size_t rows_smem_tf32() {
  return (size_t)(kGrad ? 6 : 5) * GradTf32<HD>::kTileBytes;
}

// rows_tile_mma in float32 (Q, K, V, dC float32 slabs; ctx float32; e =
// exp(s - m) unrounded), the products as 3xTF32. smem holds
// rows_smem_tf32<HD, kGrad>(), 16-byte aligned; 128 threads.
template <int HD, bool kGrad, typename Live, typename Allowed, typename Keep,
          typename Score = RawScore, typename Split = WholeRows>
__device__ __forceinline__ void rows_tile_tf32(const float* Q, const float* K, const float* V,
                                               const float* dC, size_t dc_stride, int dc_lo,
                                               int q0, int q_end, int L, int n, Live live,
                                               Allowed allowed, Keep keep, float keep_prob,
                                               float* out, size_t out_stride, float* stats,
                                               size_t plane, unsigned char* smem,
                                               Score score = Score{}, Split split = Split{}) {
  using Mm = GradTf32<HD>;
  constexpr int ND = HD / 8;
  unsigned char* Qs = smem;
  unsigned char* dCs = smem + Mm::kTileBytes;
  unsigned char* ring = dCs + (kGrad ? Mm::kTileBytes : 0);  // stage s: k, then v
  const auto slot = [&](int s) { return ring + s * 2 * Mm::kTileBytes; };
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
  const bool live_w = q0 + 16 * warp < q_end;  // warp-uniform
  const GradLaneF32<HD> lane;
  const uint32_t qs = smem_addr(Qs), dcs = smem_addr(dCs);
  const auto next = [&](int i) {
    KeyTile kt;
    while (i < n && !live(i, kt)) ++i;
    return i;
  };
  // key tile i's k (and with_v its v) into ring slot s
  const auto stage = [&](int s, int i, bool with_v) {
    KeyTile kt;
    live(i, kt);
    stage_f32_rows<HD>(K, HD, kt.k0, 0, L, slot(s));
    if (with_v) stage_f32_rows<HD>(V, HD, kt.k0, 0, L, slot(s) + Mm::kTileBytes);
  };

  stage_f32_rows<HD>(Q, HD, q0, 0, L, Qs);
  if constexpr (kGrad) stage_f32_rows<HD>(dC, dc_stride, q0, dc_lo, L, dCs);

  // pass 1: the row maxima over the allowed keys of every live tile
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;
  grad_ring(n, next, [&](int s, int i) { stage(s, i, false); }, [&](int s, int i) {
    if (!live_w) return;
    KeyTile kt;
    live(i, kt);
#pragma unroll
    for (int c = 0; c < kTile / 32; ++c) {
      float x[4][4];
      scores_tf32<HD>(qs, smem_addr(slot(s)), lane, c, x);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt.k0 + 32 * c + 8 * j + 2 * t + e % 2;
          if (e < 2) {
            if (allowed(kt, r_lo, key)) m_lo = fmaxf(m_lo, score(kt, r_lo, key, x[j][e]));
          } else if (allowed(kt, r_hi, key)) {
            m_hi = fmaxf(m_hi, score(kt, r_hi, key, x[j][e]));
          }
        }
    }
  });
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);
  split.maxima(m_lo, m_hi);

  // pass 2: e, D, the kept e into P V, with kGrad dP and rowsum(dp p_eff)
  float D_lo = 0.0f, D_hi = 0.0f, rs_lo = 0.0f, rs_hi = 0.0f;
  float o[ND][4];
  zero_acc<HD>(o);
  grad_ring(
      n, next, [&](int s, int i) { stage(s, i, true); },
      [&](int s, int i) {
        if (!live_w) return;
        KeyTile kt;
        live(i, kt);
        const uint32_t ks = smem_addr(slot(s)), vs = ks + Mm::kTileBytes;
        const float* vz = reinterpret_cast<const float*>(slot(s) + Mm::kTileBytes) + lane.bk;
#pragma unroll
        for (int c = 0; c < kTile / 32; ++c) {
          float x[4][4], y[4][4];
          scores_tf32<HD>(qs, ks, lane, c, x);
          if constexpr (kGrad) scores_tf32<HD>(dcs, vs, lane, c, y);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool hi = e >= 2;
              const int key = kt.k0 + 32 * c + 8 * j + 2 * t + e % 2, row = hi ? r_hi : r_lo;
              float pe = 0.0f;
              if (allowed(kt, row, key)) {
                const float ex =
                    rounded_exp<float>(score(kt, row, key, x[j][e]), hi ? m_hi : m_lo);
                (hi ? D_hi : D_lo) += ex;
                if (keep(kt, row, key)) pe = ex;
                if constexpr (kGrad) {
                  float& rs = hi ? rs_hi : rs_lo;
                  rs = fmaf(pe, y[j][e], rs);
                }
              }
              x[j][e] = pe;
            }
          accumulate_tf32<HD>(x, vz, c, o);  // O += P V over the chunk's 32 keys
        }
      });

  D_lo = quad_sum(D_lo);
  D_hi = quad_sum(D_hi);
  if constexpr (kGrad) {
    rs_lo = quad_sum(rs_lo);
    rs_hi = quad_sum(rs_hi);
  }
  if (!split.template totals<kGrad>(o, D_lo, D_hi, rs_lo, rs_hi, ring) || !live_w) return;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int l = hi ? r_hi : r_lo;
    if (l >= q_end) continue;
    const float d = hi ? D_hi : D_lo, denom = d * keep_prob;
    float* dst = out + (size_t)l * out_stride + 2 * t;
#pragma unroll
    for (int nn = 0; nn < ND; ++nn)
      store_pair(dst + 8 * nn, d > 0.0f ? o[nn][2 * hi] / denom : 0.0f,
                 d > 0.0f ? o[nn][2 * hi + 1] / denom : 0.0f);
    if (kGrad && t == 0) {
      stats[l] = hi ? m_hi : m_lo;
      stats[plane + l] = d;
      stats[2 * plane + l] = d > 0.0f ? (hi ? rs_hi : rs_lo) / denom : 0.0f;
    }
  }
}

// the shared memory of rows_tile: the staged tiles of the element type's body
template <typename T, int HD, bool kGrad>
__host__ __device__ constexpr size_t rows_tiles_bytes() {
  if constexpr (std::is_same<T, float>::value) {
    return rows_smem_tf32<HD, kGrad>();
  } else {
    return rows_smem_mma<HD, kGrad>();
  }
}

// rows_tile_mma on bf16 q, k, v, or rows_tile_tf32 on float32 ones (whose
// ctx is float32): one call for both element types, with the same callbacks.
// smem holds rows_tiles_bytes<T, HD, kGrad>(), 16-byte aligned; 128 threads.
template <int HD, bool kGrad, typename T, typename Tc, typename Live, typename Allowed,
          typename Keep, typename Score = RawScore, typename Split = WholeRows>
__device__ __forceinline__ void rows_tile(const T* Q, const T* K, const T* V, const T* dC,
                                          size_t dc_stride, int dc_lo, int q0, int q_end, int L,
                                          int n, Live live, Allowed allowed, Keep keep,
                                          float keep_prob, Tc* out, size_t out_stride,
                                          float* stats, size_t plane, unsigned char* smem,
                                          Score score = Score{}, Split split = Split{}) {
  if constexpr (std::is_same<T, float>::value) {
    static_assert(std::is_same<Tc, float>::value, "the float32 body stores a float32 ctx");
    rows_tile_tf32<HD, kGrad>(Q, K, V, dC, dc_stride, dc_lo, q0, q_end, L, n, live, allowed, keep,
                              keep_prob, out, out_stride, stats, plane, smem, score, split);
  } else {
    rows_tile_mma<HD, kGrad>(Q, K, V, dC, dc_stride, dc_lo, q0, q_end, L, n, live, allowed, keep,
                             keep_prob, out, out_stride, stats, plane, smem, score, split);
  }
}

}  // namespace spk
