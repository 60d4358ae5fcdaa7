// The whole post-LayerNorm encoder stack in one launch for the H100
// (sm_90a): for each of NL layers,
//   h1 = LayerNorm(x + MHA(x) Wo + bo),  x' = LayerNorm(h1 + act(h1 W1 + b1) W2 + b2)
// in float32, bfloat16 or W8A8, exactly the chain of the attention block
// (attention_block.cu) and the MLP block (mlp_block.cu) layer after layer.
//
// Replaces the TPU kernel spokennlp_tpu/ops/pallas/stack_block.py,
// fused_encoder_stack (_stack_kernel), which attention_impl="auto" picks for
// inference batches of 32 windows or fewer.
//
// What bounds it here. Its work is the two blocks' work times NL (about 3.1
// TFLOP for 12 BERT-base layers at B=32, L=512), so it is bound by
// arithmetic, as they are: the bf16 attention core, the float GEMMs and the
// W8A8 products run on the tensor cores (attention_core.cuh's bf16 mma.sync
// core; bf16_gemm.cuh's bf16 tile, tf32x3_gemm.cuh's 3xTF32 tile in float32
// and int8_gemm.cuh's s8 mma.sync tile), the float32 core on the CUDA cores.
// What the TPU kernel saved is what a stack of launches costs besides: 2-5
// launches a block, 24-108 a forward, each with a ramp-up and a tail where
// SMs idle, and the hidden state's trips through device memory between them.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// kept one sequence's hidden state in VMEM and walked the layers in a
// sequential grid. Hopper has no 25 MB of on-chip memory a block, but its
// 50 MB L2 holds the bfloat16 hidden state of B=32, L=512 (25 MB), so the
// counterpart is one persistent cooperative launch: as many blocks as fit
// on the SMs at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs;
// the launch fails rather than run a grid that cannot be co-resident), each
// walking every phase of every layer over a strided share of its tiles,
// with a grid-wide barrier (cooperative_groups::this_grid().sync()) between
// phases:
//   [W8A8: row-quantise x] -> QKV tiles -> attention-core items ->
//   [W8A8: row-quantise ctx] -> out-projection + LayerNorm row blocks ->
//   [W8A8: row-quantise h1] -> W1 + activation tiles ->
//   [W8A8: row-quantise the float32 intermediate] -> W2 + LayerNorm rows.
// Every phase calls the device function the per-layer kernels launch, with
// the same tiles, so the result equals the chain of kernels 1 and 2 bit for
// bit. Weights are read per layer from the stacked (NL, ...) tensors that
// the wrapper prepared (layout, and int8 with per-column scales) once a
// call.
#include <cooperative_groups.h>

#include "attention_core.cuh"
#include "int8_gemm.cuh"

namespace cg = cooperative_groups;

namespace spk {
namespace {

struct StackArgs {
  const void* hidden;
  const int32_t* seg;
  const void* wqkv;  // (NL, H, 3 HN) T, or (NL, 3 HN, H) int8 (K-major)
  const float* swqkv;  // (NL, 3 HN) in W8A8
  const float* bqkv;  // (NL, 3 HN)
  const void* wo;  // (NL, HN, H) T, or (NL, H, HN) int8
  const float* swo;  // (NL, H)
  const float* bo;  // (NL, H)
  const float* ln1s;
  const float* ln1b;
  const void* w1;  // (NL, H, I) T, or (NL, I, H) int8
  const float* sw1;  // (NL, I)
  const float* b1;  // (NL, I)
  const void* w2;  // (NL, I, H) T, or (NL, H, I) int8
  const float* sw2;  // (NL, H)
  const float* b2;  // (NL, H)
  const float* ln2s;
  const float* ln2b;
  void* qkv;  // (3, B, nh, L, hd) T
  void* ctx;  // (B L, HN) T
  void* h1;  // (B L, H) T
  void* mid;  // (B L, I): T, or float32 in W8A8
  int8_t* q8;  // (B L, max(H, I)) in W8A8
  float* scales;  // (B L) in W8A8
  float* rows;  // (B L, H) float32 pre-norm rows
  void* out;  // (B L, H) T: the hidden state between layers, then the result
  int B, L, H, nh, hd, I, NL, act;
  float sm_scale, eps;
};

// The dynamic shared memory of a block: the largest of its phases' needs,
// the float tiles' rings or (W8A8) the int8 tiles' rings, and the attention
// core.
template <typename T, int HD, bool kQuant>
constexpr size_t stack_smem_bytes() {
  constexpr size_t gemm = kQuant ? GemmTileI8::kSmemBytes : GemmTile<T>::kSmemBytes;
  constexpr size_t ln = kQuant ? LnTileI8::kSmemBytes : LnTile<T>::kSmemBytes;
  constexpr size_t core = attn_core_smem_bytes<T, HD>();
  constexpr size_t a = gemm > ln ? gemm : ln;
  return a > core ? a : core;
}

// The float stacks' tensor-core GEMM items (bf16, and float32 on the 3xTF32
// tile), kept out of line as the bf16 core item is: inlined, their
// registers would add to the whole kernel's pressure.
template <typename T>
__device__ __noinline__ void stack_qkv_item(const T* x, const T* w, const float* bias, T* qkv,
                                            int B, int L, int H, int nh, int hd, float sm_scale,
                                            int row0, int col0, float* smem) {
  qkv_proj_tile<T>(x, w, bias, qkv, B, L, H, nh, hd, sm_scale, 3, row0, col0, smem);
}

template <typename T>
__device__ __noinline__ void stack_gemm_act_item(const T* A, const T* W, const float* bias, T* out,
                                                 int M, int N, int K, int act, int row0,
                                                 int col0, float* smem) {
  gemm_bias_act_tile<T>(A, W, bias, out, M, N, K, act, nullptr, row0, col0, smem);
}

template <typename T>
__device__ __noinline__ void stack_residual_ln_item(const T* A, const T* W, const float* bias,
                                                    const T* resid, const float* ln_scale,
                                                    const float* ln_bias, float* rows, T* out,
                                                    int M, int N, int K, float eps, int row0,
                                                    float* smem) {
  residual_ln_rowblock<T>(A, W, bias, resid, ln_scale, ln_bias, rows, out, M, N, K, eps, 1, row0,
                          smem);
}

// One bf16 attention-core item of the stack, kept out of line: inlined, the
// tensor-core core's registers raise the pressure of the whole kernel, and
// the float bf16 stack spills more and runs about 1.5 times as long
// (PERF.md). The float32 core stays inline, as it costs the float32 stack
// nothing there.
template <int HD>
__device__ __noinline__ void stack_core_item(const __nv_bfloat16* qkv, const int32_t* seg,
                                             __nv_bfloat16* ctx, int L, CoreLayout lay, int q0,
                                             int h, int b, float* smem) {
  attn_core_tile<__nv_bfloat16, HD, __nv_bfloat16>(qkv, seg, ctx, L, lay, 1.0f, q0, h, b, smem);
}

// Every layer of the stack, for one block of the cooperative grid.
template <typename T, int HD, bool kQuant>
__device__ __forceinline__ void stack_layers(StackArgs a) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* smem8 = reinterpret_cast<unsigned char*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, L = a.L, H = a.H, nh = a.nh, I = a.I, M = B * L, HN = nh * HD;
  const int nblk = gridDim.x, blk = blockIdx.x;
  constexpr int kWarps = kThreads / 32;
  const int warp0 = blk * kWarps + threadIdx.x / 32, nwarps = nblk * kWarps;
  constexpr bool kF32 = std::is_same<T, float>::value;
  // the float tiles' counts
  constexpr int TR = kGemmRowsB, TC = kGemmColsB, LR = kLnRowsB;
  const int mt = (M + TR - 1) / TR, rb = (M + LR - 1) / LR;
  // the int8 tiles' counts
  const int mt8 = (M + kGemmRows8 - 1) / kGemmRows8, rb8 = (M + kLnRows8 - 1) / kLnRows8;
  const CoreLayout lay = block_layout(B, L, nh, HD);
  T* qkv = static_cast<T*>(a.qkv);
  T* ctx = static_cast<T*>(a.ctx);
  T* h1 = static_cast<T*>(a.h1);
  T* out = static_cast<T*>(a.out);

  for (int layer = 0; layer < a.NL; ++layer) {
    const T* x = layer == 0 ? static_cast<const T*>(a.hidden) : out;
    const size_t lq = (size_t)layer * H * 3 * HN, lo = (size_t)layer * HN * H,
                 lm = (size_t)layer * H * I;
    const float* bqkv = a.bqkv + (size_t)layer * 3 * HN;
    const float* bo = a.bo + (size_t)layer * H;
    const float* b1 = a.b1 + (size_t)layer * I;
    const float* b2 = a.b2 + (size_t)layer * H;
    const float* ln1s = a.ln1s + (size_t)layer * H;
    const float* ln1b = a.ln1b + (size_t)layer * H;
    const float* ln2s = a.ln2s + (size_t)layer * H;
    const float* ln2b = a.ln2b + (size_t)layer * H;

    // ---- attention half-layer: h1 = LN(x + outproj(MHA(qkv(x))))
    const int qt = (3 * HN + TC - 1) / TC;
    if constexpr (kQuant) {
      const int qt8 = (3 * HN + kGemmCols8 - 1) / kGemmCols8;
      rowquant_items<T>(x, M, H, 1, a.q8, a.scales, warp0, nwarps);
      grid.sync();
      const int8_t* w = static_cast<const int8_t*>(a.wqkv) + lq;
      for (int t = blk; t < mt8 * qt8; t += nblk)
        qkv_proj_tile_i8<T>(a.q8, a.scales, w, a.swqkv + (size_t)layer * 3 * HN, bqkv, qkv, B, L,
                            H, nh, HD, a.sm_scale, (t / qt8) * kGemmRows8,
                            (t % qt8) * kGemmCols8, smem8);
    } else {
      const T* w = static_cast<const T*>(a.wqkv) + lq;
      for (int t = blk; t < mt * qt; t += nblk)
        stack_qkv_item<T>(x, w, bqkv, qkv, B, L, H, nh, HD, a.sm_scale, (t / qt) * TR,
                          (t % qt) * TC, smem);
    }
    grid.sync();
    constexpr int kRows = core_rows<T>();  // the query tile of kernel 1's core launch
    const int lt = (L + kRows - 1) / kRows;
    for (int t = blk; t < lt * nh * B; t += nblk) {
      const int q0 = (t % lt) * kRows, h = (t / lt) % nh, b = t / (lt * nh);
      if constexpr (kF32) {
        attn_core_tile<T, HD, T>(qkv, a.seg, ctx, L, lay, 1.0f, q0, h, b, smem);
      } else {
        stack_core_item<HD>(qkv, a.seg, ctx, L, lay, q0, h, b, smem);
      }
    }
    grid.sync();
    if constexpr (kQuant) {
      rowquant_items<T>(ctx, M, HN, 1, a.q8, a.scales, warp0, nwarps);
      grid.sync();
      const int8_t* w = static_cast<const int8_t*>(a.wo) + lo;
      for (int t = blk; t < rb8; t += nblk)
        residual_ln_rowblock_i8<T>(a.q8, a.scales, w, a.swo + (size_t)layer * H, bo, x, ln1s,
                                   ln1b, a.rows, h1, M, H, HN, 1, a.eps, 1, t * kLnRows8, smem8);
    } else {
      const T* w = static_cast<const T*>(a.wo) + lo;
      for (int t = blk; t < rb; t += nblk)
        stack_residual_ln_item<T>(ctx, w, bo, x, ln1s, ln1b, a.rows, h1, M, H, HN, a.eps, t * LR,
                                  smem);
    }
    grid.sync();

    // ---- MLP half-layer: x' = LN(h1 + W2 . act(W1 . h1 + b1) + b2)
    const int it = (I + TC - 1) / TC;
    if constexpr (kQuant) {
      const int it8 = (I + kGemmCols8 - 1) / kGemmCols8;
      float* mid = static_cast<float*>(a.mid);
      rowquant_items<T>(h1, M, H, 1, a.q8, a.scales, warp0, nwarps);
      grid.sync();
      const int8_t* w1 = static_cast<const int8_t*>(a.w1) + lm;
      for (int t = blk; t < mt8 * it8; t += nblk)
        gemm_act_tile_i8<float>(a.q8, a.scales, w1, a.sw1 + (size_t)layer * I, b1, mid, M, I, H,
                                a.act, (t / it8) * kGemmRows8, (t % it8) * kGemmCols8, smem8);
      grid.sync();
      rowquant_items<float>(mid, M, I, 1, a.q8, a.scales, warp0, nwarps);
      grid.sync();
      const int8_t* w2 = static_cast<const int8_t*>(a.w2) + lm;
      for (int t = blk; t < rb8; t += nblk)
        residual_ln_rowblock_i8<T>(a.q8, a.scales, w2, a.sw2 + (size_t)layer * H, b2, h1, ln2s,
                                   ln2b, a.rows, out, M, H, I, 1, a.eps, 1, t * kLnRows8, smem8);
    } else {
      T* mid = static_cast<T*>(a.mid);
      const T* w1 = static_cast<const T*>(a.w1) + lm;
      for (int t = blk; t < mt * it; t += nblk)
        stack_gemm_act_item<T>(h1, w1, b1, mid, M, I, H, a.act, (t / it) * TR, (t % it) * TC,
                               smem);
      grid.sync();
      const T* w2 = static_cast<const T*>(a.w2) + lm;
      for (int t = blk; t < rb; t += nblk)
        stack_residual_ln_item<T>(mid, w2, b2, h1, ln2s, ln2b, a.rows, out, M, H, I, a.eps,
                                  t * LR, smem);
    }
    grid.sync();
  }
}

// The float entry at two blocks an SM, as its tiles run alone (128
// registers a thread): in bf16 unbounded it takes 234-248 and one block an
// SM; in float32 the 3xTF32 tiles' rings (105 KB) leave room for two blocks,
// which the bound keeps: at one (248 registers, no spill) the float32
// stack ran 6 % slower (PERF.md).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2) encoder_stack_kernel(StackArgs a) {
  stack_layers<T, HD, false>(a);
}

// W8A8 at two blocks an SM: 128 registers a thread (the int8 phases
// otherwise take 246-255 and leave one block an SM; PERF.md has both times).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2) encoder_stack_i8_kernel(StackArgs a) {
  stack_layers<T, HD, true>(a);
}

// The largest co-resident grid, or 0 when one block does not fit.
template <typename Kernel>
cudaError_t cooperative_grid(Kernel kernel, size_t smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = prepare(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  *grid = per_sm * sms;
  return *grid > 0 ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

template <typename T, bool kQuant>
cudaError_t encoder_stack(StackArgs a, int* grid_out, cudaStream_t stream) {
  if (a.H % 4 || a.I % 4) return cudaErrorInvalidValue;
  return with_head_dim(a.hd, [&](auto hd_c) -> cudaError_t {
    constexpr int HD = decltype(hd_c)::value;
    if constexpr (HD < 32) {
      return cudaErrorInvalidValue;
    } else {
      void (*kernel)(StackArgs);
      if constexpr (kQuant) {
        kernel = encoder_stack_i8_kernel<T, HD>;
      } else {
        kernel = encoder_stack_kernel<T, HD>;
      }
      constexpr size_t smem = stack_smem_bytes<T, HD, kQuant>();
      int grid = 0;
      const cudaError_t err = cooperative_grid(kernel, smem, &grid);
      if (err != cudaSuccess) return err;
      if (grid_out != nullptr) *grid_out = grid;
      void* args[] = {&a};
      return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                         dim3(kThreads), args, smem, stream);
    }
  });
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 of hidden, out and the T buffers
// (qkv_buf, ctx_buf, h1_buf, and mid_buf unless quantized); quantized: the
// weights are int8, K-major, with per-column scales and mid_buf is float32. Stacked
// weights in the layouts of StackArgs; seg (B, L) int32; q8_buf and s_buf
// are read only in W8A8 and may be null otherwise; *grid_out receives the
// number of blocks launched. hd is 32, 64 or 128.
extern "C" int spk_encoder_stack(int dtype, int quantized, const void* hidden, const void* seg,
                                 const void* wqkv, const void* swqkv, const void* bqkv,
                                 const void* wo, const void* swo, const void* bo,
                                 const void* ln1s, const void* ln1b, const void* w1,
                                 const void* sw1, const void* b1, const void* w2,
                                 const void* sw2, const void* b2, const void* ln2s,
                                 const void* ln2b, void* qkv_buf, void* ctx_buf, void* h1_buf,
                                 void* mid_buf, void* q8_buf, void* s_buf, void* ln_buf,
                                 void* out, void* grid_out, int B, int L, int H, int nh, int hd,
                                 int I, int NL, int act, float sm_scale, float eps,
                                 void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  spk::StackArgs a{hidden, static_cast<const int32_t*>(seg), wqkv, f(swqkv), f(bqkv), wo, f(swo),
                   f(bo), f(ln1s), f(ln1b), w1, f(sw1), f(b1), w2, f(sw2), f(b2), f(ln2s),
                   f(ln2b), qkv_buf, ctx_buf, h1_buf, mid_buf, static_cast<int8_t*>(q8_buf),
                   static_cast<float*>(s_buf), static_cast<float*>(ln_buf), out,
                   B, L, H, nh, hd, I, NL, act, sm_scale, eps};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto g = static_cast<int*>(grid_out);
  cudaError_t err;
  if (dtype == 0 && !quantized) {
    err = spk::encoder_stack<float, false>(a, g, s);
  } else if (dtype == 0) {
    err = spk::encoder_stack<float, true>(a, g, s);
  } else if (dtype == 1 && !quantized) {
    err = spk::encoder_stack<__nv_bfloat16, false>(a, g, s);
  } else if (dtype == 1) {
    err = spk::encoder_stack<__nv_bfloat16, true>(a, g, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
