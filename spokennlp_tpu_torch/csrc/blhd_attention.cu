// Segment-masked self-attention over an already projected qkv for the H100
// (sm_90a): (B, 3, nh, L, hd) -> (B, nh, L, hd), scores (q . k) * sm_scale,
// the additive -1e9 mask of allowed = (seg_q == seg_k) & (seg_k > 0), exp in
// bfloat16 whatever the element type, normalised after P.V.
//
// Replaces the TPU kernel spokennlp_tpu/ops/pallas/blhd_attention.py,
// snld_self_attention (_attn_kernel), which serves attention_impl="pallas".
//
// What bounds it here. At BERT-base (B=32, L=512, 12 heads of 64) it is 25.8
// GFLOP of attention products and 100M exponentials against 75 MB of qkv and
// 25 MB of output in bfloat16: about 260 operations a byte, below the card's
// bf16 ridge (about 295), so on the tensor cores its bound is the bytes
// (0.030 ms); its softmax (an exponential, the mask and four roundings a
// score, on the CUDA cores) is the larger share of its instructions.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// took a whole (L, L) score matrix of HB heads into VMEM (L=512 fits) and
// normalised after P.V. A Hopper block cannot hold that, so this is the
// attention block's core (attention_core.cuh): one block per (128 query
// rows, head, sequence) runs both products on the tensor cores (mma.sync
// m16n8k16 bf16 in bfloat16, 3xTF32 m16n8k8 in float32; float32 sums) over
// key tiles of 64 streamed through a two-stage cp.async ring, with the
// online softmax in registers. Both use this kernel's
// layouts, apply the scale to the scores (q arrives unscaled) and round the
// exponent to bfloat16 as the TPU kernel takes it.
#include "attention_core.cuh"

namespace spk {
namespace {

// (B, 3, nh, L, hd) in, (B, nh, L, hd) out
CoreLayout snld_layout(int L, int nh, int hd) {
  const size_t head = (size_t)L * hd;
  return {(size_t)nh * head, (size_t)3 * nh * head, head, (size_t)nh * head, head, (size_t)hd};
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 of qkv and out; seg (B, L) int32.
extern "C" int spk_snld_attention(int dtype, const void* qkv, const void* seg, void* out, int B,
                                  int L, int nh, int hd, float sm_scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sg = static_cast<const int32_t*>(seg);
  const spk::CoreLayout lay = spk::snld_layout(L, nh, hd);
  cudaError_t err;
  if (dtype == 0) {
    err = spk::launch_attn_core<float, __nv_bfloat16>(static_cast<const float*>(qkv), sg,
                                                      static_cast<float*>(out), B, L, nh, hd, lay,
                                                      sm_scale, s);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    err = spk::launch_attn_core<T, T>(static_cast<const T*>(qkv), sg, static_cast<T*>(out), B, L,
                                      nh, hd, lay, sm_scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
