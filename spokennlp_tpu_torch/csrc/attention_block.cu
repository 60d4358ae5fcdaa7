// Fused attention block for the H100 (sm_90a):
//   out = LayerNorm(x + (softmax_masked(q k^T) v) Wo + bo)
// with q = (x Wq + bq) * sm_scale, k = x Wk + bk, v = x Wv + bv, and the
// segment-id mask allowed = (seg_q == seg_k) & (seg_k > 0): 0 marks padding,
// equal ids attend, which covers padding and window packing alike.
//
// Replaces the TPU kernel spokennlp_tpu/ops/pallas/attention_block.py,
// fused_attention_block (_attn_block_kernel, quantized=False).
//
// What bounds it here. At BERT-base (B=32, L=512, H=768, 12 heads of 64) a
// layer's attention block is about 103 GFLOP: 56% in the QKV projection, 25%
// in the two attention products and 19% in the output projection. That is
// far above the card's ratio of operations to bytes, so the block is bound by
// arithmetic: these SIMT kernels run on the CUDA cores in float32 and reach a
// small share of what the tensor cores offer. Moving the products onto
// mma.sync / wgmma is the next step.
//
// What the design does about the TPU kernel's assumptions. On the TPU one
// grid step owned a whole (sequence, head group), kept q, k and v in VMEM
// and summed ctx . Wo over head groups in a scratch buffer across sequential
// grid steps. Hopper blocks run in parallel and carry nothing from one to
// the next, so the block is three launches:
//   1. qkv_proj_kernel (common.cuh): one GEMM over all B*L rows, bias added, q scaled by
//      sm_scale, stored in the element type as (3, B, nh, L, hd);
//   2. attn_core_kernel: one block per (query tile of 64 rows, head,
//      sequence); it streams key tiles of 64 through shared memory with an
//      online softmax (running max and sum in float32) and normalises after
//      P.V, as the TPU kernel does;
//   3. gemm_bias_residual_ln_kernel (common.cuh): ctx . Wo + bo + x and the
//      LayerNorm, with one block owning whole rows so the norm needs no
//      second launch.
// q, k, v, ctx and the pre-norm rows make one round trip through device
// memory (or L2) each; keeping them on chip is later work. exp runs in float32 here (the TPU kernel takes
// it in the compute dtype); probabilities are rounded to the element type
// before they are summed and multiplied with v, as on the TPU.
#include "common.cuh"

namespace spk {
namespace {

constexpr int kQTile = 64;    // query rows a block owns
constexpr int kKeyTile = 64;  // keys a block stages per step

template <int HD>
constexpr size_t attn_core_smem_bytes() {
  // Qs [kQTile][HD+1], Kt [HD][kKeyTile+1], Vs [kKeyTile][HD],
  // Ps [kQTile][kKeyTile+1] as float, then the key tile's segment ids
  return sizeof(float) * ((size_t)kQTile * (HD + 1) + (size_t)HD * (kKeyTile + 1) +
                          (size_t)kKeyTile * HD + (size_t)kQTile * (kKeyTile + 1)) +
         sizeof(int) * kKeyTile;
}

// Segment-masked softmax attention of one (query tile, head, sequence).
// Thread (ty, tx) owns query rows ty + 16 i (i < 4), score columns
// tx + 16 j of each key tile (j < 4) and output columns tx + 16 j (j < HD/16).
// The 16 threads that share a row sit in one half-warp, so row maxima and
// sums reduce with shuffles. Grid (ceil(L / 64), nh, B).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    attn_core_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ seg,
                     T* __restrict__ ctx, int B, int L, int nh) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = HD + 1;
  constexpr int KS = kKeyTile + 1;
  constexpr int TR = kQTile / 16;   // rows per thread
  constexpr int TC = kKeyTile / 16;  // score columns per thread
  constexpr int TD = HD / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + kQTile * QS;
  float* Vs = Kt + HD * KS;
  float* Ps = Vs + kKeyTile * HD;
  int* seg_k = reinterpret_cast<int*>(Ps + kQTile * KS);

  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t head = (size_t)L * HD;
  const T* Q = qkv + (((size_t)0 * B + b) * nh + h) * head;
  const T* K = qkv + (((size_t)1 * B + b) * nh + h) * head;
  const T* V = qkv + (((size_t)2 * B + b) * nh + h) * head;
  const int32_t* seg_b = seg + (size_t)b * L;

  for (int e = tid; e < kQTile * HD; e += kThreads) {
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

  for (int k0 = 0; k0 < L; k0 += kKeyTile) {
    __syncthreads();  // the previous step is done with Kt, Vs, Ps
    for (int e = tid; e < kKeyTile * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int key = k0 + c;
      const bool in = key < L;
      Kt[d * KS + c] = in ? to_f32(K[(size_t)key * HD + d]) : 0.0f;
      Vs[c * HD + d] = in ? to_f32(V[(size_t)key * HD + d]) : 0.0f;
    }
    if (tid < kKeyTile) seg_k[tid] = k0 + tid < L ? seg_b[k0 + tid] : 0;
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
        } else if (!(seg_q[i] == seg_k[c] && seg_k[c] > 0)) {
          s[i][j] += kNegInf;  // masked key: the TPU kernel's additive -1e9
        }
        tile_max = fmaxf(tile_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // every key tile holds at least one in-range key, so new_max is finite
      const float new_max = fmaxf(row_max[i], tile_max);
      const float alpha = expf(row_max[i] - new_max);
      float tile_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = round_to<T>(expf(s[i][j] - new_max));
        tile_sum += p;
        Ps[(ty + 16 * i) * KS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
      row_sum[i] = row_sum[i] * alpha + tile_sum;
      row_max[i] = new_max;
#pragma unroll
      for (int j = 0; j < TD; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kKeyTile; ++c) {
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

  const size_t row_stride = (size_t)nh * HD;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int l = q0 + ty + 16 * i;
    if (l >= L) continue;
    const float inv = 1.0f / row_sum[i];
    T* out = ctx + ((size_t)b * L + l) * row_stride + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < TD; ++j) out[tx + 16 * j] = from_f32<T>(o[i][j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_attn_core(const T* qkv, const int32_t* seg, T* ctx, int B, int L, int nh,
                             cudaStream_t stream) {
  constexpr size_t smem = attn_core_smem_bytes<HD>();  // above 48 KB for HD >= 64
  const cudaError_t err = cudaFuncSetAttribute(
      attn_core_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kQTile - 1) / kQTile, nh, B);
  attn_core_kernel<T, HD><<<grid, kThreads, smem, stream>>>(qkv, seg, ctx, B, L, nh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_block(const T* hidden, const int32_t* seg, const T* wqkv, const float* bqkv,
                            const T* wo, const float* bo, const float* ln_scale,
                            const float* ln_bias, T* qkv_buf, T* ctx_buf, float* ln_buf, T* out,
                            int B, int L,
                            int H, int nh, int hd, float sm_scale, float eps, int fuse_ln,
                            cudaStream_t stream) {
  const int M = B * L, HN = nh * hd;
  cudaError_t err = launch_qkv_proj<T>(hidden, wqkv, bqkv, qkv_buf, B, L, H, nh, hd, sm_scale,
                                       stream);
  if (err != cudaSuccess) return err;
  switch (hd) {
    case 32:
      err = launch_attn_core<T, 32>(qkv_buf, seg, ctx_buf, B, L, nh, stream);
      break;
    case 64:
      err = launch_attn_core<T, 64>(qkv_buf, seg, ctx_buf, B, L, nh, stream);
      break;
    case 128:
      err = launch_attn_core<T, 128>(qkv_buf, seg, ctx_buf, B, L, nh, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_residual_ln<T>(ctx_buf, wo, bo, hidden, ln_scale, ln_bias, ln_buf, out, M, H,
                               HN, eps, fuse_ln, stream);
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (hidden, weights, qkv_buf, ctx_buf and
// out); biases, LayerNorm parameters and ln_buf (B*L, H) are float32.
// ln_scale and ln_bias may be null when fuse_ln == 0. Returns the first CUDA
// error, or 0.
extern "C" int spk_attention_block(int dtype, const void* hidden, const void* seg,
                                   const void* wqkv, const void* bqkv, const void* wo,
                                   const void* bo, const void* ln_scale, const void* ln_bias,
                                   void* qkv_buf, void* ctx_buf, void* ln_buf, void* out, int B,
                                   int L, int H,
                                   int nh, int hd, float sm_scale, float eps, int fuse_ln,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  const auto bq = static_cast<const float*>(bqkv);
  const auto bo_ = static_cast<const float*>(bo);
  const auto lns = static_cast<const float*>(ln_scale);
  const auto lnb = static_cast<const float*>(ln_bias);
  cudaError_t err;
  if (dtype == 0) {
    err = spk::attention_block<float>(
        static_cast<const float*>(hidden), sg, static_cast<const float*>(wqkv), bq,
        static_cast<const float*>(wo), bo_, lns, lnb, static_cast<float*>(qkv_buf),
        static_cast<float*>(ctx_buf), static_cast<float*>(ln_buf), static_cast<float*>(out), B, L,
        H, nh, hd, sm_scale, eps,
        fuse_ln, s);
  } else if (dtype == 1) {
    err = spk::attention_block<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(hidden), sg, static_cast<const __nv_bfloat16*>(wqkv),
        bq, static_cast<const __nv_bfloat16*>(wo), bo_, lns, lnb,
        static_cast<__nv_bfloat16*>(qkv_buf), static_cast<__nv_bfloat16*>(ctx_buf),
        static_cast<float*>(ln_buf), static_cast<__nv_bfloat16*>(out), B, L, H, nh, hd, sm_scale,
        eps, fuse_ln, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* spk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
