// Segment-masked softmax attention of one (query tile of 64 rows, head,
// sequence), shared by the attention block (attention_block.cu), the
// attention over a projected qkv (blhd_attention.cu) and the whole-stack
// kernel (stack_block.cu), so the three compute the same function the same
// way.
//
// allowed = (seg_q == seg_k) & (seg_k > 0); a masked key's score gets the
// TPU kernels' additive -1e9, a key beyond the sequence -inf. The block
// streams key tiles of 64 through shared memory with an online softmax
// (running max and sum in float32). As on the TPU, the exponent is taken in
// the type ExpT: e = exp(s - m) with s - m and e rounded to ExpT (the
// compute type in the attention block and the stack, bfloat16 always over a
// projected qkv); e is rounded to T before it meets v, the row sums add the
// rounded e in float32, and the context is divided by the sum after P.V.
#pragma once

#include "attention_tiles.cuh"

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

template <int HD>
constexpr size_t attn_core_smem_bytes() {
  // Qs [64][HD+1], Kt [HD][64+1], Vs [64][HD], Ps [64][64+1] as float, then
  // the key tile's segment ids
  return sizeof(float) * ((size_t)kTile * (HD + 1) + (size_t)HD * (kTile + 1) +
                          (size_t)kTile * HD + (size_t)kTile * (kTile + 1)) +
         sizeof(int) * kTile;
}

// Thread (ty, tx) owns query rows ty + 16 i (i < 4), score columns tx + 16 j
// of each key tile (j < 4) and output columns tx + 16 j (j < HD/16). The 16
// threads that share a row sit in one half-warp, so row maxima and sums
// reduce with shuffles. Scores are (q . k) * score_scale. No __restrict__ on
// qkv: the stack kernel wrote it earlier in the same launch.
template <typename T, int HD, typename ExpT>
__device__ __forceinline__ void attn_core_tile(const T* qkv, const int32_t* seg, T* out, int L,
                                               CoreLayout lay, float score_scale, int q0, int h,
                                               int b, float* smem) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = HD + 1;
  constexpr int KS = kTile + 1;
  constexpr int TR = kTile / 16;  // rows per thread
  constexpr int TC = kTile / 16;  // score columns per thread
  constexpr int TD = HD / 16;     // output columns per thread
  float* Qs = smem;
  float* Kt = Qs + kTile * QS;
  float* Vs = Kt + HD * KS;
  float* Ps = Vs + kTile * HD;
  int* seg_k = reinterpret_cast<int*>(Ps + kTile * KS);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* Q = qkv + (size_t)b * lay.b_stride + (size_t)h * lay.h_stride;
  const T* K = Q + lay.s_stride;
  const T* V = K + lay.s_stride;
  const int32_t* seg_b = seg + (size_t)b * L;

  __syncthreads();  // a previous item of this block is done with the tiles
  for (int e = tid; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int l = q0 + r;
    Qs[r * QS + d] = l < L ? to_f32(Q[(size_t)l * HD + d]) : 0.0f;
  }
  int seg_q[TR];
  float row_max[TR], row_sum[TR], o[TR][TD];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int l = q0 + ty + 16 * i;
    seg_q[i] = l < L ? seg_b[l] : 0;
    row_max[i] = -CUDART_INF_F;
    row_sum[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < TD; ++j) o[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the previous step is done with Kt, Vs, Ps
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int key = k0 + c;
      const bool in = key < L;
      Kt[d * KS + c] = in ? to_f32(K[(size_t)key * HD + d]) : 0.0f;
      Vs[c * HD + d] = in ? to_f32(V[(size_t)key * HD + d]) : 0.0f;
    }
    if (tid < kTile) seg_k[tid] = k0 + tid < L ? seg_b[k0 + tid] : 0;
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kv[j] = Kt[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = tx + 16 * j;
        if (k0 + c >= L) {
          s[i][j] = -CUDART_INF_F;  // beyond the sequence: not a key at all
        } else {
          s[i][j] *= score_scale;
          if (!(seg_q[i] == seg_k[c] && seg_k[c] > 0)) s[i][j] += kNegInf;
        }
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      tile_max = half_warp_max(tile_max);
      // every key tile holds at least one in-range key, so new_max is finite
      const float new_max = fmaxf(row_max[i], tile_max);
      const float alpha = expf(row_max[i] - new_max);
      float tile_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = round_to<T>(rounded_exp<ExpT>(s[i][j], new_max));
        tile_sum += p;
        Ps[(ty + 16 * i) * KS + tx + 16 * j] = p;
      }
      row_sum[i] = row_sum[i] * alpha + half_warp_sum(tile_sum);
      row_max[i] = new_max;
#pragma unroll
      for (int j = 0; j < TD; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      float vv[TD];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float p = Ps[(ty + 16 * i) * KS + c];
#pragma unroll
        for (int j = 0; j < TD; ++j) o[i][j] = fmaf(p, vv[j], o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int l = q0 + ty + 16 * i;
    if (l >= L) continue;
    T* dst = out + (size_t)b * lay.ob_stride + (size_t)h * lay.oh_stride + (size_t)l * lay.ol_stride;
#pragma unroll
    for (int j = 0; j < TD; ++j) dst[tx + 16 * j] = from_f32<T>(o[i][j] / row_sum[i]);
  }
}

namespace {

// Grid (ceil(L / 64), nh, B).
template <typename T, int HD, typename ExpT>
__global__ void __launch_bounds__(kThreads)
    attn_core_kernel(const T* qkv, const int32_t* seg, T* out, int L, CoreLayout lay,
                     float score_scale) {
  extern __shared__ float smem[];
  attn_core_tile<T, HD, ExpT>(qkv, seg, out, L, lay, score_scale, blockIdx.x * kTile, blockIdx.y,
                              blockIdx.z, smem);
}

}  // namespace

template <typename T, typename ExpT>
cudaError_t launch_attn_core(const T* qkv, const int32_t* seg, T* out, int B, int L, int nh,
                             int hd, CoreLayout lay, float score_scale, cudaStream_t stream) {
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    constexpr size_t smem = attn_core_smem_bytes<HD>();  // above 48 KB for HD >= 64
    const cudaError_t err = prepare(attn_core_kernel<T, HD, ExpT>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + kTile - 1) / kTile, nh, B);
    attn_core_kernel<T, HD, ExpT><<<grid, kThreads, smem, stream>>>(qkv, seg, out, L, lay,
                                                                   score_scale);
    return cudaGetLastError();
  });
}

}  // namespace spk
