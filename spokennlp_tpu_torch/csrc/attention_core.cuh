// Segment-masked softmax attention of one (query tile, head, sequence),
// shared by the attention block (attention_block.cu), the attention over a
// projected qkv (blhd_attention.cu) and the whole-stack kernel
// (stack_block.cu), so the three compute the same function the same way.
//
// allowed = (seg_q == seg_k) & (seg_k > 0); a masked key's score gets the
// TPU kernels' additive -1e9, a key beyond the sequence -inf. Scores are
// (q . k) * score_scale in float32. The block streams key tiles of 64
// through shared memory with an online softmax (running max and sum in
// float32). As on the TPU, the exponent is taken in the type ExpT: e =
// exp(s - m) with s - m and e rounded to ExpT (the compute type in the
// attention block and the stack, bfloat16 always over a projected qkv); e is
// rounded to T before it meets v, the row sums add the rounded e in float32,
// alpha = exp(m_old - m_new) rescales them unrounded, and the context is
// divided by the sum after P.V, then rounded to T.
//
// Two cores keep those rounding points, both on the tensor cores, 128 query
// rows a block (16 a warp), the key and value tiles staged through a
// two-stage cp.async ring and read with ldmatrix, the softmax on the score
// fragments in registers. In bfloat16 (T = __nv_bfloat16) both products run
// on mma.sync m16n8k16 bf16 with float32 sums: q, k, v and the rounded p are
// bf16 values, so the products are exact but for the order of the float32
// sums. In float32 (T = float) they run as 3xTF32 on mma.sync m16n8k8 (the
// split of tf32x3_gemm.cuh): each product keeps about float32's accuracy
// (2^-21 or so of a term; one plain TF32 product would err by 2^-11), and
// the tensor cores' float32 sums truncate. The plain versions' rounding
// model takes the core's products through attention_models.core_product
// (int8_matmul.tf32x3_product on the card's gate).
#pragma once

#include "attention_tiles.cuh"
#include "ptx.cuh"

namespace spk {

// Where q, k, v and the output of (sequence b, head h) live: element
// (slot s, b, h, row l, dim d) of the input at s * s_stride + b * b_stride +
// h * h_stride + l * HD + d; output (b, h, l, d) at b * ob_stride + h *
// oh_stride + l * ol_stride + d.
struct CoreLayout {
  size_t s_stride, b_stride, h_stride;
  size_t ob_stride, oh_stride, ol_stride;
};

// (3, B, nh, L, hd) in, ctx (B, L, nh * hd) out: the attention block's layouts
__host__ __device__ inline CoreLayout block_layout(int B, int L, int nh, int hd) {
  const size_t head = (size_t)L * hd;
  return {(size_t)B * nh * head, (size_t)nh * head, head, (size_t)L * nh * hd, (size_t)hd,
          (size_t)nh * hd};
}

// The bfloat16 core's shared memory: q's tile of kRows rows, then two
// stages of (k tile, v tile, the key tile's segment ids). A staged row of
// HD bf16 is padded by 16 bytes, so the 8 row addresses of an ldmatrix
// phase fall on 8 distinct 16-byte bank groups (the row stride is an odd
// number of 16-byte units).
template <int HD>
struct CoreMma {
  static constexpr int kRows = 16 * (kThreads / 32);  // query rows a block: 16 a warp
  static constexpr int kRowBytes = 2 * HD + 16;
  static constexpr int kKvBytes = kTile * kRowBytes;
  static constexpr int kStageBytes = 2 * kKvBytes + kTile * (int)sizeof(int);
  static constexpr size_t kSmemBytes = (size_t)kRows * kRowBytes + 2 * (size_t)kStageBytes;
  static_assert(HD % 16 == 0 && kRowBytes % 32 == 16, "whole k16 steps, odd 16-byte row stride");
};

// The float32 core's shared memory: q's tile of kRows rows, then two
// stages of (k tile, v tile, the key tile's segment ids), each row of HD
// floats padded to HD + 4: an odd number of 16-byte units, so the 8 row
// addresses of an ldmatrix phase (q's and k's fragments) fall on distinct
// bank groups, and the 32 lanes of one read of v's fragments (keys 2 t and
// 2 t + 1, column g) on 32 distinct banks.
template <int HD>
struct CoreTf32 {
  static constexpr int kRows = 16 * (kThreads / 32);  // query rows a block: 16 a warp
  static constexpr int kRowFloats = HD + 4;
  static constexpr int kRowBytes = 4 * kRowFloats;
  static constexpr int kKvBytes = kTile * kRowBytes;
  static constexpr int kStageBytes = 2 * kKvBytes + kTile * (int)sizeof(int);
  static constexpr size_t kSmemBytes = (size_t)kRows * kRowBytes + 2 * (size_t)kStageBytes;
  static_assert(HD % 8 == 0 && kRowFloats % 8 == 4, "whole k8 steps, odd 16-byte row stride");
};

// query rows a block owns: 128 in both dtypes (16 a warp)
template <typename T>
__host__ __device__ constexpr int core_rows() {
  return CoreMma<16>::kRows;
}

template <typename T, int HD>
constexpr size_t attn_core_smem_bytes() {
  if constexpr (std::is_same<T, float>::value) {
    return CoreTf32<HD>::kSmemBytes;
  } else {
    return CoreMma<HD>::kSmemBytes;
  }
}

// two float32 values that are bf16 values, as one bf16 pair (lo first)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The bfloat16 core on the tensor cores, rows [q0, q0 + 128) of (b, h).
// Warp w owns query rows q0 + 16 w .. + 15; in the m16n8 fragments of its
// scores and its output, lane (g, t) = (lane / 4, lane % 4) holds rows g and
// g + 8, columns 2 t and 2 t + 1 of each n8 tile, so a row's maxima and sums
// reduce over the 4 lanes of a quad. Per key tile of 64: S (16 x 64) = Q K^T
// from q's A fragments and k's B fragments (ldmatrix of the k rows as they
// stand), the scale, the mask and the -inf tail on S's fragments, the online
// max and rescale, then p in registers: S's accumulator layout is P's A
// fragment layout, so each pair of rounded p becomes one bf16x2 register;
// O += P V with v's B fragments from ldmatrix.trans. A warp whose rows all
// lie beyond L skips the products but keeps the block's barriers.
template <int HD, typename ExpT>
__device__ __forceinline__ void attn_core_tile_mma(const __nv_bfloat16* qkv, const int32_t* seg,
                                                   __nv_bfloat16* out, int L, CoreLayout lay,
                                                   float score_scale, int q0, int h, int b,
                                                   unsigned char* smem) {
  using C = CoreMma<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int kChunks = HD / 8;  // 16-byte copies a staged row
  constexpr int KS = HD / 16;      // k16 steps of Q K^T
  constexpr int ND = HD / 8;       // n8 tiles of the output
  constexpr int NS = kTile / 8;    // n8 tiles of a key tile's scores
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bf16* Q = qkv + (size_t)b * lay.b_stride + (size_t)h * lay.h_stride;
  const bf16* K = Q + lay.s_stride;
  const bf16* V = K + lay.s_stride;
  const int32_t* seg_b = seg + (size_t)b * L;
  unsigned char* stages = smem + C::kRows * C::kRowBytes;

  // rows [r0, r0 + R) of the (L, HD) slab X into dst, zero-filled beyond L
  const auto copy_rows = [&](const bf16* X, int r0, int R, unsigned char* dst) {
    for (int e = tid; e < R * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks, l = r0 + r;
      const bool in = l < L;
      cp_async16(smem_addr(dst + r * C::kRowBytes + 16 * c), in ? X + (size_t)l * HD + 8 * c : X,
                 in ? 16 : 0);
    }
  };
  const auto load_keys = [&](int kt) {
    unsigned char* s = stages + (kt % 2) * C::kStageBytes;
    const int k0 = kt * kTile;
    copy_rows(K, k0, kTile, s);
    copy_rows(V, k0, kTile, s + C::kKvBytes);
    if (tid < kTile)
      reinterpret_cast<int*>(s + 2 * C::kKvBytes)[tid] = k0 + tid < L ? seg_b[k0 + tid] : 0;
  };

  __syncthreads();  // a previous item of this block is done with the shared memory
  copy_rows(Q, q0, C::kRows, smem);
  load_keys(0);
  cp_async_commit();

  const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
  const bool live = q0 + 16 * warp < L;  // warp-uniform
  const int seg_lo = r_lo < L ? seg_b[r_lo] : 0, seg_hi = r_hi < L ? seg_b[r_hi] : 0;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, sum_lo = 0.0f, sum_hi = 0.0f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  // q's fragments are read from shared memory at every key tile: held in
  // registers they take HD / 4 of the 128 a thread has at two blocks an SM,
  // and the core spills more and runs slower (PERF.md)
  // ldmatrix row addresses: q's four 8 x 8 matrices are (rows 0-7, d 0-7),
  // (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) of an m16 x k16 fragment; k's
  // are (keys 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) of two n8
  // x k16 fragments; v's, transposed, (keys 0-7, d 0-7), (8-15, 0-7), (0-7,
  // 8-15), (8-15, 8-15) of two k16 x n8 fragments
  const uint32_t q_addr = smem_addr(smem + (16 * warp + lane % 16) * C::kRowBytes + (lane / 16) * 16);
  const int k_off = (lane % 8 + 8 * (lane / 16)) * C::kRowBytes + ((lane / 8) % 2) * 16;
  const int v_off = (lane % 8 + 8 * ((lane / 8) % 2)) * C::kRowBytes + (lane / 16) * 16;

  const int nk = (L + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_keys(kt + 1);  // its slot was freed by the barrier ending kt - 1
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and q) have landed
    __syncthreads();
    if (live) {
      const unsigned char* s = stages + (kt % 2) * C::kStageBytes;
      const uint32_t k_base = smem_addr(s) + k_off, v_base = smem_addr(s) + C::kKvBytes + v_off;
      const int* seg_k = reinterpret_cast<const int*>(s + 2 * C::kKvBytes);
      float sc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(q_addr + kk * 32, a);
#pragma unroll
        for (int nj = 0; nj < NS / 2; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(k_base + nj * 16 * C::kRowBytes + kk * 32, r);
          mma_bf16(sc[2 * nj], a, r[0], r[1]);
          mma_bf16(sc[2 * nj + 1], a, r[2], r[3]);
        }
      }

      // scale, mask, -inf tail; the tile's row maxima
      const int k0 = kt * kTile;
      float max_lo = -CUDART_INF_F, max_hi = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = 8 * j + 2 * t;
        const int2 sk = *reinterpret_cast<const int2*>(seg_k + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key_seg = e % 2 ? sk.y : sk.x;
          const int row_seg = e < 2 ? seg_lo : seg_hi;
          float v;
          if (k0 + c + e % 2 >= L) {
            v = -CUDART_INF_F;  // beyond the sequence: not a key at all
          } else {
            v = sc[j][e] * score_scale;
            if (!(row_seg == key_seg && key_seg > 0)) v += kNegInf;
          }
          sc[j][e] = v;
          if (e < 2) max_lo = fmaxf(max_lo, v);
          else max_hi = fmaxf(max_hi, v);
        }
      }
      // every key tile holds at least one in-range key, so the maxima are finite
      const float new_lo = fmaxf(m_lo, quad_max(max_lo)), new_hi = fmaxf(m_hi, quad_max(max_hi));
      const float alpha_lo = expf(m_lo - new_lo), alpha_hi = expf(m_hi - new_hi);
      m_lo = new_lo;
      m_hi = new_hi;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha_lo;
        o[n][1] *= alpha_lo;
        o[n][2] *= alpha_hi;
        o[n][3] *= alpha_hi;
      }

      // p = e rounded to bf16, A fragments of P V, 16 keys a k-step
      float tile_lo = 0.0f, tile_hi = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float(&x)[4] = sc[2 * kk + half];
          // e rounded to ExpT, then to bf16 (a bf16 e already is)
          const auto p = [](float s, float m) {
            const float e = rounded_exp<ExpT>(s, m);
            return std::is_same<ExpT, bf16>::value ? e : round_to<bf16>(e);
          };
          const float p0 = p(x[0], m_lo), p1 = p(x[1], m_lo), p2 = p(x[2], m_hi),
                      p3 = p(x[3], m_hi);
          tile_lo += p0 + p1;
          tile_hi += p2 + p3;
          a[2 * half] = bf16_pair(p0, p1);
          a[2 * half + 1] = bf16_pair(p2, p3);
        }
#pragma unroll
        for (int dn = 0; dn < ND / 2; ++dn) {
          uint32_t r[4];
          ldmatrix_x4_trans(v_base + kk * 16 * C::kRowBytes + dn * 32, r);
          mma_bf16(o[2 * dn], a, r[0], r[1]);
          mma_bf16(o[2 * dn + 1], a, r[2], r[3]);
        }
      }
      sum_lo = sum_lo * alpha_lo + tile_lo;  // each lane's share of its rows' sums
      sum_hi = sum_hi * alpha_hi + tile_hi;
    }
    __syncthreads();  // every warp is done with slot kt % 2
  }
  cp_async_wait<0>();

  if (live) {
    sum_lo = quad_sum(sum_lo);
    sum_hi = quad_sum(sum_hi);
    bf16* dst = out + (size_t)b * lay.ob_stride + (size_t)h * lay.oh_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (r_lo < L)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r_lo * lay.ol_stride + 8 * n) =
            __floats2bfloat162_rn(o[n][0] / sum_lo, o[n][1] / sum_lo);
      if (r_hi < L)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r_hi * lay.ol_stride + 8 * n) =
            __floats2bfloat162_rn(o[n][2] / sum_hi, o[n][3] / sum_hi);
    }
  }
}

// The float32 core on the tensor cores, rows [q0, q0 + 128) of (b, h): the
// bf16 core's walk (warp w owns query rows q0 + 16 w .. + 15, key tiles of
// 64 through a two-stage cp.async ring, the online softmax on the score
// fragments in registers) with both products as 3xTF32 on mma.sync m16n8k8
// (ptx.cuh mma_tf32x3: every operand split into big = tf32(x) and small =
// tf32(x - big), small . big + big . small + big . big in float32, as
// tf32x3_gemm.cuh takes a float32 product). S = Q K^T: q's A fragments and
// k's B fragments through ldmatrix of the float32 rows as they stand (an 8 x
// 8 b16 matrix is 8 rows of 4 floats: a TF32 fragment's layout). P V: the
// score accumulator holds keys 2 t and 2 t + 1 of an n8 tile where a TF32 A
// fragment wants keys t and t + 4, so each k8 step takes the tile's keys in
// the order (0, 2, 4, 6, 1, 3, 5, 7): its A fragment is the accumulator as
// it stands, and the lane reads v's rows 2 t and 2 t + 1 (column g) for the
// B fragment, 32-bit loads from the padded rows.
template <int HD, typename ExpT>
__device__ __forceinline__ void attn_core_tile_tf32(const float* qkv, const int32_t* seg,
                                                    float* out, int L, CoreLayout lay,
                                                    float score_scale, int q0, int h, int b,
                                                    unsigned char* smem) {
  using C = CoreTf32<HD>;
  constexpr int kChunks = HD / 4;  // 16-byte copies a staged row
  constexpr int RF = C::kRowFloats;
  constexpr int ND = HD / 8;       // n8 tiles of the output
  constexpr int NS = kTile / 8;    // n8 tiles of a key tile's scores
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float* Q = qkv + (size_t)b * lay.b_stride + (size_t)h * lay.h_stride;
  const float* K = Q + lay.s_stride;
  const float* V = K + lay.s_stride;
  const int32_t* seg_b = seg + (size_t)b * L;
  unsigned char* stages = smem + C::kRows * C::kRowBytes;

  // rows [r0, r0 + R) of the (L, HD) slab X into dst, zero-filled beyond L
  const auto copy_rows = [&](const float* X, int r0, int R, unsigned char* dst) {
    for (int e = tid; e < R * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks, l = r0 + r;
      const bool in = l < L;
      cp_async16(smem_addr(dst + r * C::kRowBytes + 16 * c), in ? X + (size_t)l * HD + 4 * c : X,
                 in ? 16 : 0);
    }
  };
  const auto load_keys = [&](int kt) {
    unsigned char* s = stages + (kt % 2) * C::kStageBytes;
    const int k0 = kt * kTile;
    copy_rows(K, k0, kTile, s);
    copy_rows(V, k0, kTile, s + C::kKvBytes);
    if (tid < kTile)
      reinterpret_cast<int*>(s + 2 * C::kKvBytes)[tid] = k0 + tid < L ? seg_b[k0 + tid] : 0;
  };

  __syncthreads();  // a previous item of this block is done with the shared memory
  copy_rows(Q, q0, C::kRows, smem);
  load_keys(0);
  cp_async_commit();

  const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;
  const bool live = q0 + 16 * warp < L;  // warp-uniform
  const int seg_lo = r_lo < L ? seg_b[r_lo] : 0, seg_hi = r_hi < L ? seg_b[r_hi] : 0;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, sum_lo = 0.0f, sum_hi = 0.0f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  // ldmatrix row addresses: q's four 8 x 4-float matrices are (rows 0-7, d
  // 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) of an m16 x k8 fragment; k's
  // (keys 0-7, d 0-3), (0-7, 4-7), (8-15, 0-3), (8-15, 4-7) of two n8 x k8
  // fragments; v's B fragments: the lane's (key 2 t, d g) and (2 t + 1, g)
  const uint32_t q_addr = smem_addr(smem + (16 * warp + lane % 16) * C::kRowBytes + (lane / 16) * 16);
  const int k_off = (lane % 8 + 8 * (lane / 16)) * C::kRowBytes + ((lane / 8) % 2) * 16;
  const int v_off = 2 * t * RF + g;

  const int nk = (L + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_keys(kt + 1);  // its slot was freed by the barrier ending kt - 1
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and q) have landed
    __syncthreads();
    if (live) {
      const unsigned char* s = stages + (kt % 2) * C::kStageBytes;
      const uint32_t k_base = smem_addr(s) + k_off;
      const float* vs = reinterpret_cast<const float*>(s + C::kKvBytes) + v_off;
      const int* seg_k = reinterpret_cast<const int*>(s + 2 * C::kKvBytes);
      float sc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t r[4], ab[4], as[4];
        ldmatrix_x4(q_addr + kk * 32, r);
#pragma unroll
        for (int i = 0; i < 4; ++i) tf32_split(__uint_as_float(r[i]), ab[i], as[i]);
#pragma unroll
        for (int nj = 0; nj < NS / 2; ++nj) {
          uint32_t bb[4], bs[4];
          ldmatrix_x4(k_base + nj * 16 * C::kRowBytes + kk * 32, r);
#pragma unroll
          for (int i = 0; i < 4; ++i) tf32_split(__uint_as_float(r[i]), bb[i], bs[i]);
          mma_tf32x3(sc[2 * nj], ab, as, bb[0], bb[1], bs[0], bs[1]);
          mma_tf32x3(sc[2 * nj + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
        }
      }

      // scale, mask, -inf tail; the tile's row maxima
      const int k0 = kt * kTile;
      float max_lo = -CUDART_INF_F, max_hi = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = 8 * j + 2 * t;
        const int2 sk = *reinterpret_cast<const int2*>(seg_k + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key_seg = e % 2 ? sk.y : sk.x;
          const int row_seg = e < 2 ? seg_lo : seg_hi;
          float v;
          if (k0 + c + e % 2 >= L) {
            v = -CUDART_INF_F;  // beyond the sequence: not a key at all
          } else {
            v = sc[j][e] * score_scale;
            if (!(row_seg == key_seg && key_seg > 0)) v += kNegInf;
          }
          sc[j][e] = v;
          if (e < 2) max_lo = fmaxf(max_lo, v);
          else max_hi = fmaxf(max_hi, v);
        }
      }
      // every key tile holds at least one in-range key, so the maxima are finite
      const float new_lo = fmaxf(m_lo, quad_max(max_lo)), new_hi = fmaxf(m_hi, quad_max(max_hi));
      const float alpha_lo = expf(m_lo - new_lo), alpha_hi = expf(m_hi - new_hi);
      m_lo = new_lo;
      m_hi = new_hi;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha_lo;
        o[n][1] *= alpha_lo;
        o[n][2] *= alpha_hi;
        o[n][3] *= alpha_hi;
      }

      // p = e rounded to ExpT (a float32 e in float32 blocks, a bf16 one
      // over a projected qkv), O += P V, 8 keys a k-step
      float tile_lo = 0.0f, tile_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = rounded_exp<ExpT>(sc[j][0], m_lo), p1 = rounded_exp<ExpT>(sc[j][1], m_lo),
                    p2 = rounded_exp<ExpT>(sc[j][2], m_hi), p3 = rounded_exp<ExpT>(sc[j][3], m_hi);
        tile_lo += p0 + p1;
        tile_hi += p2 + p3;
        // A fragment (rows g, g + 8; k t, t + 4) = keys 2 t, 2 t + 1
        uint32_t ab[4], as[4];
        tf32_split(p0, ab[0], as[0]);
        tf32_split(p2, ab[1], as[1]);
        tf32_split(p1, ab[2], as[2]);
        tf32_split(p3, ab[3], as[3]);
        const float* vj = vs + 8 * j * RF;
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          uint32_t bb0, bs0, bb1, bs1;
          tf32_split(vj[8 * dn], bb0, bs0);
          tf32_split(vj[RF + 8 * dn], bb1, bs1);
          mma_tf32x3(o[dn], ab, as, bb0, bb1, bs0, bs1);
        }
      }
      sum_lo = sum_lo * alpha_lo + tile_lo;  // each lane's share of its rows' sums
      sum_hi = sum_hi * alpha_hi + tile_hi;
    }
    __syncthreads();  // every warp is done with slot kt % 2
  }
  cp_async_wait<0>();

  if (live) {
    sum_lo = quad_sum(sum_lo);
    sum_hi = quad_sum(sum_hi);
    float* dst = out + (size_t)b * lay.ob_stride + (size_t)h * lay.oh_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (r_lo < L)
        *reinterpret_cast<float2*>(dst + (size_t)r_lo * lay.ol_stride + 8 * n) =
            make_float2(o[n][0] / sum_lo, o[n][1] / sum_lo);
      if (r_hi < L)
        *reinterpret_cast<float2*>(dst + (size_t)r_hi * lay.ol_stride + 8 * n) =
            make_float2(o[n][2] / sum_hi, o[n][3] / sum_hi);
    }
  }
}

// One (query tile of core_rows<T>() rows, head, sequence) on the tensor
// cores: the bf16 core, or the float32 one on 3xTF32. smem holds
// attn_core_smem_bytes<T, HD>(), 16-byte aligned.
template <typename T, int HD, typename ExpT>
__device__ __forceinline__ void attn_core_tile(const T* qkv, const int32_t* seg, T* out, int L,
                                               CoreLayout lay, float score_scale, int q0, int h,
                                               int b, float* smem) {
  if constexpr (std::is_same<T, float>::value) {
    attn_core_tile_tf32<HD, ExpT>(qkv, seg, out, L, lay, score_scale, q0, h, b,
                                  reinterpret_cast<unsigned char*>(smem));
  } else {
    attn_core_tile_mma<HD, ExpT>(qkv, seg, out, L, lay, score_scale, q0, h, b,
                                 reinterpret_cast<unsigned char*>(smem));
  }
}

namespace {

// Grid (ceil(L / 128), nh, B), two blocks an SM: at most 128 registers a
// thread (bf16 unbounded takes 138 and one block an SM, PERF.md); float32
// at head dim 64 takes 105 KB of shared memory a block
template <typename T, int HD, typename ExpT>
__global__ void __launch_bounds__(kThreads, 2)
    attn_core_kernel(const T* qkv, const int32_t* seg, T* out, int L, CoreLayout lay,
                     float score_scale) {
  extern __shared__ __align__(16) float smem[];
  attn_core_tile<T, HD, ExpT>(qkv, seg, out, L, lay, score_scale, blockIdx.x * core_rows<T>(),
                              blockIdx.y, blockIdx.z, smem);
}

}  // namespace

// The core over (3, B, nh, L, hd) q, k, v in the layout `lay`; qkv 16-byte
// aligned (its cp.async copies).
template <typename T, typename ExpT>
cudaError_t launch_attn_core(const T* qkv, const int32_t* seg, T* out, int B, int L, int nh,
                             int hd, CoreLayout lay, float score_scale, cudaStream_t stream) {
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    constexpr size_t smem = attn_core_smem_bytes<T, HD>();  // above 48 KB for HD >= 64
    const auto kernel = attn_core_kernel<T, HD, ExpT>;
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + core_rows<T>() - 1) / core_rows<T>(), nh, B);
    kernel<<<grid, kThreads, smem, stream>>>(qkv, seg, out, L, lay, score_scale);
    return cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// The int8 attention core of the W8A8 attention block (the TPU kernel's
// core_int8, spokennlp_tpu/ops/pallas/attention_block.py:118-193), for a
// (sequence b, head h) of head group g = h / HB:
//   "qk": q and k quantised with one scale each per (b, g), over the whole
//         (L, HB hd) block of q (already scaled and rounded) or k, padded rows
//         included: s = max(absmax, 1e-6) / 127, q8 = clip(rint(q (1 / s)));
//         s_int = q8 . k8 in int32 (__dp4a); m = the row max over the
//         allowed keys (-3e38 with none); arg = (s_int - m) (sq sk) where
//         allowed, -30 elsewhere, so a row with no allowed key is uniform;
//   "av": p = exp(arg + ln 127) in float32, the denominator max(sum p,
//         1e-6) over every key of the row (masked ones included, unrounded
//         p), p8 = clip(rint(p), 0, 127), v8 = v quantised per column over
//         the L rows of b (s_v = max(absmax, 1e-6) / 127); ctx = float(p8 .
//         v8) s_v (1 / denom), in int32 (__dp4a), rounded to T;
//   "qk" alone: the float softmax branch on that arg: e = exp(arg) taken in
//         T, the float32 sum of e, ctx = (e . v) / sum, rounded to T;
//   "av" alone: arg = q . k + (allowed ? 0 : -1e9) - the row max, in float32.
// The static scale 127 of p needs the final row max before any p is formed,
// so the block makes two passes over the key tiles (max, then p and the
// products) instead of an online softmax: the exponents are those of the TPU
// kernel, not rescaled ones. Integer products are exact: |s_int| <= 127^2 hd
// and |p8 . v8| <= 127^2 64 a key tile, summed in int32.

enum CoreInt8 : int { kCoreQK = 1, kCoreAV = 2 };  // bit flags; 3 = both

constexpr float kLn127 = 4.844187086458591f;

// (max |x| over n values strided by 1 from p), one block; `red` holds 8
// floats.
template <typename T>
__device__ __forceinline__ float block_absmax(const T* p, size_t n, float* red) {
  float a = 0.0f;
  for (size_t e = threadIdx.x; e < n; e += kThreads) a = fmaxf(a, fabsf(to_f32(p[e])));
  a = warp_max(a);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = a;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t = fmaxf(t, red[w]);
  return t;
}

__device__ __forceinline__ float int8_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-6f), 1.0f / 127.0f);
}

__device__ __forceinline__ int quantize_i8(float x, float inv) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.0f), 127.0f);
}

// Grid (G, 2, B): the scale of q (y = 0) or k (y = 1) of head group x of
// sequence z, over its HB heads of L rows, into sqk[(y * B + z) * G + x].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    core_qk_scale_kernel(const T* qkv, CoreLayout lay, int B, int L, int HB, int HD,
                         float* sqk) {
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  float amax = 0.0f;
  for (int i = 0; i < HB; ++i) {
    const T* head = qkv + s * lay.s_stride + b * lay.b_stride + (size_t)(g * HB + i) * lay.h_stride;
    amax = fmaxf(amax, block_absmax(head, (size_t)L * HD, red));
  }
  if (threadIdx.x == 0) sqk[((size_t)s * B + b) * gridDim.x + g] = int8_scale(amax);
}

// Grid (ceil(nh hd / 256), B): the scale of each column c = h hd + d of v
// of sequence y over its L rows, into sv[y * nh hd + c].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    core_v_scale_kernel(const T* qkv, CoreLayout lay, int L, int nh, int HD, float* sv) {
  const int c = blockIdx.x * kThreads + threadIdx.x, b = blockIdx.y;
  if (c >= nh * HD) return;
  const T* col = qkv + 2 * lay.s_stride + b * lay.b_stride + (size_t)(c / HD) * lay.h_stride + c % HD;
  float amax = 0.0f;
  for (int l = 0; l < L; ++l) amax = fmaxf(amax, fabsf(to_f32(col[(size_t)l * HD])));
  sv[(size_t)b * nh * HD + c] = int8_scale(amax);
}

template <int HD>
struct CoreI8Smem {
  static constexpr int QW = HD / 4 + 1;     // words a staged int8 row of q or k takes
  static constexpr int PW = kTile / 4 + 1;  // words a staged row of p8, or column of v8, takes
  static constexpr int S = HD + 1;          // float row stride of the q, k, v tiles
  // float Qs, Ks, Vs [64][S], Ps [64][kPS]; int Q8, K8 [64][QW], P8 [64][PW],
  // V8 [HD][PW]; v's inverse scales [HD]; segment ids [64]
  static constexpr size_t kFloats = 3 * (size_t)kTile * S + (size_t)kTile * kPS;
  static constexpr size_t kInts = 2 * (size_t)kTile * QW + (size_t)kTile * PW + (size_t)HD * PW;
  static constexpr size_t kBytes = sizeof(float) * (kFloats + HD) + sizeof(int) * (kInts + kTile);
};

// byte j of 32-bit word w of a staged int8 row
__device__ __forceinline__ void put_i8(int* row, int j, int v) {
  reinterpret_cast<int8_t*>(row)[j] = static_cast<int8_t>(v);
}

// One (query tile of 64 rows, head, sequence) of the int8 core. Thread (ty,
// tx) owns rows ty + 16 i and key columns / head-dim columns tx + 16 j, as in
// attn_core_tile. Grid (ceil(L / 64), nh, B).
template <typename T, int HD, int kMode>
__global__ void __launch_bounds__(kThreads)
    attn_core_i8_kernel(const T* qkv, const int32_t* seg, T* out, int B, int L, int nh, int HB,
                        CoreLayout lay, const float* sqk, const float* sv) {
  constexpr bool kQK8 = kMode & kCoreQK, kAV8 = kMode & kCoreAV;
  using Sm = CoreI8Smem<HD>;
  constexpr int TD = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * Sm::S;
  float* Vs = Ks + kTile * Sm::S;
  float* Ps = Vs + kTile * Sm::S;
  float* inv_sv = Ps + kTile * kPS;
  int* Q8 = reinterpret_cast<int*>(inv_sv + HD);
  int* K8 = Q8 + kTile * Sm::QW;
  int* P8 = K8 + kTile * Sm::QW;
  int* V8 = P8 + kTile * Sm::PW;
  int* seg_k = V8 + HD * Sm::PW;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z, G = nh / HB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* Q = qkv + (size_t)b * lay.b_stride + (size_t)h * lay.h_stride;
  const T* K = Q + lay.s_stride;
  const T* V = K + lay.s_stride;
  const int32_t* seg_b = seg + (size_t)b * L;
  float c = 1.0f, inv_q = 1.0f, inv_k = 1.0f;
  if constexpr (kQK8) {
    const float sq = sqk[(size_t)b * G + h / HB], sk = sqk[((size_t)B + b) * G + h / HB];
    c = __fmul_rn(sq, sk);
    inv_q = 1.0f / sq;
    inv_k = 1.0f / sk;
  }
  if constexpr (kAV8) {
    if (tid < HD) inv_sv[tid] = 1.0f / sv[(size_t)b * nh * HD + h * HD + tid];
  }

  for (int e = tid; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, l = q0 + r;
    const float x = l < L ? to_f32(Q[(size_t)l * HD + d]) : 0.0f;
    if constexpr (kQK8) put_i8(Q8 + r * Sm::QW, d, quantize_i8(x, inv_q));
    else Qs[r * Sm::S + d] = x;
  }
  int seg_q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = q0 + ty + 16 * i;
    seg_q[i] = l < L ? seg_b[l] : 0;
  }

  // the scores of key tile k0 (staged), masked: scores of keys beyond L are
  // never read; ok[i][j] says whether key j is allowed for row i
  auto scores = [&](int k0, float (&s)[4][4], bool (&ok)[4][4]) {
    if constexpr (kQK8) {
      int acc[4][4] = {};
#pragma unroll 4
      for (int w = 0; w < HD / 4; ++w) {
        int a[4], k[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Q8[(ty + 16 * i) * Sm::QW + w];
#pragma unroll
        for (int j = 0; j < 4; ++j) k[j] = K8[(tx + 16 * j) * Sm::QW + w];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], k[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = (float)acc[i][j];
    } else {
      tile_dot<HD>(Qs, Ks, s);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        ok[i][j] = seg_q[i] == seg_k[col] && seg_k[col] > 0;
        if (!kQK8 && !ok[i][j]) s[i][j] += kNegInf;
      }
  };
  auto stage_keys = [&](int k0, bool with_v) {
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, key = k0 + r;
      const bool in = key < L;
      const float kv = in ? to_f32(K[(size_t)key * HD + d]) : 0.0f;
      if constexpr (kQK8) put_i8(K8 + r * Sm::QW, d, quantize_i8(kv, inv_k));
      else Ks[r * Sm::S + d] = kv;
      if (with_v) {
        const float vv = in ? to_f32(V[(size_t)key * HD + d]) : 0.0f;
        if constexpr (kAV8) put_i8(V8 + d * Sm::PW, r, quantize_i8(vv, inv_sv[d]));
        else Vs[r * Sm::S + d] = vv;
      }
    }
    if (tid < kTile) seg_k[tid] = k0 + tid < L ? seg_b[k0 + tid] : 0;
  };

  // pass 1: the row maxima
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kQK8 ? -3e38f : -CUDART_INF_F;
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    stage_keys(k0, false);
    __syncthreads();
    float s[4][4];
    bool ok[4][4];
    scores(k0, s, ok);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < L && (ok[i][j] || !kQK8)) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = half_warp_max(m[i]);

  // pass 2: p, its sum and the products with v
  float D[4] = {0.0f, 0.0f, 0.0f, 0.0f}, o[4][TD];
  int acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) o[i][j] = 0.0f, acc[i][j] = 0;
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    stage_keys(k0, true);
    __syncthreads();
    float s[4][4];
    bool ok[4][4];
    scores(k0, s, ok);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool in = k0 + col < L;
        float arg;
        if constexpr (kQK8) arg = ok[i][j] ? __fmul_rn(s[i][j] - m[i], c) : -30.0f;
        else arg = s[i][j] - m[i];
        if constexpr (kAV8) {
          const float p = in ? expf(__fadd_rn(arg, kLn127)) : 0.0f;
          D[i] += p;
          put_i8(P8 + r * Sm::PW, col, (int)fminf(fmaxf(rintf(p), 0.0f), 127.0f));
        } else {
          const float p = in ? round_to<T>(expf(round_to<T>(arg))) : 0.0f;
          D[i] += p;
          Ps[r * kPS + col] = p;
        }
      }
    }
    __syncthreads();
    if constexpr (kAV8) {
#pragma unroll
      for (int w = 0; w < kTile / 4; ++w) {
        int pw[4], vw[TD];
#pragma unroll
        for (int i = 0; i < 4; ++i) pw[i] = P8[(ty + 16 * i) * Sm::PW + w];
#pragma unroll
        for (int j = 0; j < TD; ++j) vw[j] = V8[(tx + 16 * j) * Sm::PW + w];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TD; ++j) acc[i][j] = __dp4a(pw[i], vw[j], acc[i][j]);
      }
    } else {
      tile_accumulate<HD>(Ps, Vs, o);
    }
  }

  const float* svh = sv + (size_t)b * nh * HD + h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d_sum = half_warp_sum(D[i]);
    const int l = q0 + ty + 16 * i;
    if (l >= L) continue;
    T* dst = out + (size_t)b * lay.ob_stride + (size_t)h * lay.oh_stride + (size_t)l * lay.ol_stride;
    if constexpr (kAV8) {
      const float inv = 1.0f / fmaxf(d_sum, 1e-6f);
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const int d = tx + 16 * j;
        dst[d] = from_f32<T>(__fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), svh[d]), inv));
      }
    } else {
#pragma unroll
      for (int j = 0; j < TD; ++j) dst[tx + 16 * j] = from_f32<T>(o[i][j] / d_sum);
    }
  }
}

// The int8 core over (3, B, nh, L, hd) q, k, v in the layout `lay`, heads in
// groups of HB, into out; mode = CoreInt8 flags (1 qk, 2 av, 3 both).
// scales: scratch of 2 B (nh / HB) + B nh hd floats.
template <typename T>
cudaError_t launch_attn_core_i8(const T* qkv, const int32_t* seg, T* out, int B, int L, int nh,
                                int hd, int HB, int mode, CoreLayout lay, float* scales,
                                cudaStream_t stream) {
  if (HB <= 0 || nh % HB || mode < 1 || mode > 3) return cudaErrorInvalidValue;
  const int G = nh / HB;
  float* sqk = scales;
  float* sv = scales + 2 * (size_t)B * G;
  if (mode & kCoreQK) {
    core_qk_scale_kernel<T><<<dim3(G, 2, B), kThreads, 0, stream>>>(qkv, lay, B, L, HB, hd, sqk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (mode & kCoreAV) {
    const dim3 grid((nh * hd + kThreads - 1) / kThreads, B);
    core_v_scale_kernel<T><<<grid, kThreads, 0, stream>>>(qkv, lay, L, nh, hd, sv);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    constexpr size_t smem = CoreI8Smem<HD>::kBytes;
    const dim3 grid((L + kTile - 1) / kTile, nh, B);
    const auto run = [&](auto kernel) {
      const cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, stream>>>(qkv, seg, out, B, L, nh, HB, lay, sqk, sv);
      return cudaGetLastError();
    };
    return mode == 1 ? run(attn_core_i8_kernel<T, HD, 1>)
           : mode == 2 ? run(attn_core_i8_kernel<T, HD, 2>)
                       : run(attn_core_i8_kernel<T, HD, 3>);
  });
}

}  // namespace spk
