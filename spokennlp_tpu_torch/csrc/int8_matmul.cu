// W8A8 matrix product for the H100 (sm_90a):
//   out = act(float(x8 . w8) * s_x[row] * s_w[col] + b[col])
// with int8 x8 (M, K), int8 w8 (K, N) (handed over K-major), an int32
// accumulator and a float32 dequant epilogue, stored as float32 or
// bfloat16; and the row quantiser
// that makes x8 and s_x from a float32 or bfloat16 x.
//
// Replaces the TPU kernels of spokennlp_tpu/ops/pallas/int8_matmul.py:
// w8a8_matmul (_w8a8_kernel: int8 x with its row scales, spk_w8a8_matmul
// alone) and w8a8_matmul_bf16in (_w8a8_bf16in_kernel: x quantised per row
// inside the kernel, then the product and the activation epilogue, here
// spk_rowquant followed by spk_w8a8_matmul), which quant_dense calls for
// every projection of the encoder's W8A8 einsum path.
//
// What bounds it here. At the main path's shapes (M = 16,384 rows, K x N =
// 768 x 2304, 768 x 768, 768 x 3072, 3072 x 768) a product does 19-58
// G int8 multiply-adds against 12-63 MB of int8 operands and bfloat16
// output: hundreds of operations a byte, so it is bound by arithmetic, at
// the tensor cores' int8 rate (1,979 TOPS dense). The product runs on them
// through mma.sync m16n8k32 s8 (int8_gemm.cuh), which reaches part of that
// rate: wgmma with TMA is later work.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// kept the whole (K, N) weight resident in VMEM and quantised a (bm, K)
// block of rows in VMEM before the product. Here a block owns a 128 x 128
// output tile and streams 64-deep slices of both operands through a
// three-stage cp.async ring in shared memory; the weight comes K-major (the
// wrapper transposes it once a call), so both operands are copied 16 bytes
// at a time and read by ldmatrix as the mma fragments want them. The row
// quantiser is a launch of its own (one warp a row writes int8 and its
// scale), so the product reads one byte an element instead of two.
#include "int8_gemm.cuh"

// dtype: 0 = float32, 1 = bfloat16 of x. x (M, K) -> x8 (M, K) int8 and
// scales (M * G) float32, each row quantised over G groups of K / G columns.
extern "C" int spk_rowquant(int dtype, const void* x, void* x8, void* scales, int M, int K, int G,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto q = static_cast<int8_t*>(x8);
  const auto sc = static_cast<float*>(scales);
  cudaError_t err;
  if (dtype == 0) {
    err = spk::launch_rowquant<float>(static_cast<const float*>(x), M, K, G, q, sc, s);
  } else if (dtype == 1) {
    err = spk::launch_rowquant<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), M, K, G, q,
                                              sc, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// out_dtype: 0 = float32, 1 = bfloat16. x8 (M, K) int8 with scales sx (M),
// w8 (N, K) int8 K-major (each output column's K bytes contiguous) with
// scales sw (N), bias (N) float32 or null; act is an
// ACTIVATION_CODES value; K a multiple of 4.
extern "C" int spk_w8a8_matmul(int out_dtype, const void* x8, const void* sx, const void* w8,
                               const void* sw, const void* bias, void* out, int M, int N, int K,
                               int act, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const int8_t*>(x8);
  const auto sa = static_cast<const float*>(sx);
  const auto w = static_cast<const int8_t*>(w8);
  const auto sw_ = static_cast<const float*>(sw);
  const auto b = static_cast<const float*>(bias);
  cudaError_t err;
  if (out_dtype == 0) {
    err = spk::launch_gemm_i8<float>(a, sa, w, sw_, b, static_cast<float*>(out), M, N, K, act, s);
  } else if (out_dtype == 1) {
    err = spk::launch_gemm_i8<__nv_bfloat16>(a, sa, w, sw_, b, static_cast<__nv_bfloat16*>(out),
                                             M, N, K, act, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory of the int8 tile kernels, in bytes: which = 0
// the GEMM, 2b and projection kernels' (GemmTileI8), 1 the residual-LN
// kernel's (LnTileI8); -1 for another value.
extern "C" int spk_int8_tile_smem(int which) {
  return which == 0 ? spk::GemmTileI8::kSmemBytes
                    : which == 1 ? spk::LnTileI8::kSmemBytes : -1;
}

// The bf16 tensor-core tiles' dynamic shared memory (bf16_gemm.cuh): which 0
// the GEMM and projection tile, 1 the residual-LayerNorm tile.
extern "C" int spk_bf16_tile_smem(int which) {
  return which == 0 ? spk::GemmTileB::kSmemBytes
                    : which == 1 ? spk::LnTileB::kSmemBytes : -1;
}
