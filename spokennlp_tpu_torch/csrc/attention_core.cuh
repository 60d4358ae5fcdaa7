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
