"""W8A8 (int8 weight, int8 activation) matrix product with a dequant
epilogue, and the activation table of the fused kernels.

Counterpart of ``spokennlp_tpu/ops/pallas/int8_matmul.py``:

  x_int8 (M, K) . w_int8 (K, N) -> int32 -> float32 * s_x[row] * s_w[col]
  (+ bias) -> activation -> bf16 (or float32)

Weights are quantised per output column, activations per row, both
symmetric absmax with the scale floor max(absmax, 1e-6) / 127 and rounding
half to even. On a CUDA tensor ``w8a8_matmul`` runs the hand-written kernel
of ``csrc/int8_matmul.cu`` and ``w8a8_matmul_bf16in`` runs its row-quant
kernel, then ``w8a8_matmul``; on a CPU tensor each runs its plain version.

Where the functions divide and where they multiply, as in JAX:
``quantize_rowwise`` and ``quantize_colwise`` divide by the scale;
``rowquant_plain`` (JAX's in-kernel ``rowquant_in_kernel``) and the row-quant
kernel multiply by its reciprocal. ``quant_dense`` on the CPU takes JAX's
off-TPU branch (divide, then the activation after rounding to out_dtype); on
the card it runs the kernels, which multiply and apply the activation in
float32 before rounding, like the TPU kernel. The two can differ by one int8
step where x / s and x * (1 / s) fall on either side of a rounding boundary.

Inside the kernels "gelu" is the tanh form, as on the TPU, while the einsum
path of the encoder uses the exact erf form (``models/encoder.py ACT2FN``);
the encoder's W8A8 MLP takes the tanh form from this table, as JAX's
``QuantDense`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from spokennlp_tpu_torch.ops.cuda import build


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=True)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


ACTIVATIONS = {
    "none": lambda x: x,
    "gelu": gelu_tanh,
    "gelu_new": gelu_tanh,
    "relu": torch.relu,
    "silu": F.silu,
}

# the codes csrc/common.cuh's apply_activation takes
ACTIVATION_CODES = {"none": 0, "gelu": 1, "gelu_new": 1, "relu": 2, "silu": 3}
# element types of the kernels' float operands
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_rowwise(x: torch.Tensor):
    """(..., K) float -> (int8 (..., K), float32 (..., 1)) per-row absmax scales."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_colwise(w: torch.Tensor):
    """(..., K, N) float -> (int8 (..., K, N), float32 (..., 1, N)) per-output-
    column scales (over the K axis of each matrix of a stack)."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-6) / 127.0
    return torch.round(wf / scale).clamp(-127, 127).to(torch.int8), scale


def rowquant_plain(x: torch.Tensor, groups: int = 1):
    """JAX's ``rowquant_in_kernel``: (M, K) -> int8 (M, K) and float32
    (M, groups) scales, each row quantised over ``groups`` equal column
    groups, multiplying by the reciprocal of the scale."""
    M, K = x.shape
    xf = x.float().reshape(M, groups, K // groups)
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    q = torch.round(xf * (1.0 / s)).clamp(-127, 127).to(torch.int8)
    return q.reshape(M, K), s.reshape(M, groups)


def kmajor(w8: torch.Tensor) -> torch.Tensor:
    """The kernels' layout of int8 weights (..., K, N): (..., N, K), each
    output column's K bytes contiguous, as the tensor-core tile reads its B
    operand (``csrc/int8_gemm.cuh``). A stack (NL, K, N) becomes (NL, N, K);
    a grouped out-projection is transposed whole, so head group g is
    K-columns [g K / G, (g + 1) K / G) of the result. The wrappers call it
    once a call, at the launch, on the weights they quantised."""
    return w8.transpose(-1, -2).contiguous()


def float_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) . (K, N) in float32: the products of the float modes' plain
    versions (the planted faults of their card limits replace it)."""
    return x.float() @ w.float()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x in float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds it: on the int32 view, half a
    unit of the 13 dropped bits added to the magnitude's bits, then those
    bits cleared (finite values)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_product(x: torch.Tensor, w: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """(..., K) . (K, N) as kernel 9's float32 tile takes it
    (``csrc/tf32x3_gemm.cuh``): each operand split into big = tf32(a) and
    small = tf32(a - big), and small_x . big_w + big_x . small_w + big_x .
    big_w summed in float32, each TF32 product exact in float32. terms=1
    keeps big_x . big_w alone: a plain TF32 product (the planted fault of
    kernel 9's float32 card limit)."""
    x, w = x.float(), w.float()
    xb, wb = tf32_round(x), tf32_round(w)
    if terms == 1:
        return xb @ wb
    return (tf32_round(x - xb) @ wb + xb @ tf32_round(w - wb)) + xb @ wb


def int8_product(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The exact int32 accumulator of int8 (M, K) . int8 (K, N), as float32:
    in int64 on the CPU, in float64 on the card (exact below 2^53; the card
    has no integer matmul). float32 itself would round sums above 2^24."""
    if x8.device.type == "cpu":
        acc = x8.long() @ w8.long()
    else:
        acc = x8.double() @ w8.double()
    return acc.float()


def w8a8_matmul_reference(x8, sx, w8, sw, bias=None, out_dtype=torch.bfloat16):
    """JAX's ``w8a8_matmul_reference``: the integer product, then
    (acc * s_x) * s_w + bias in float32, rounded to out_dtype."""
    out = int8_product(x8, w8) * sx.reshape(-1, 1).float() * sw.reshape(1, -1).float()
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out.to(out_dtype)


def w8a8_matmul_plain(x8, sx, w8, sw, bias=None, out_dtype=torch.bfloat16, activation="none"):
    """The W8A8 kernel in plain PyTorch: the reference with the activation
    applied in float32 before the rounding to out_dtype."""
    out = w8a8_matmul_reference(x8, sx, w8, sw, bias, torch.float32)
    return ACTIVATIONS[activation](out).to(out_dtype)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def w8a8_matmul(
    x8: torch.Tensor,  # (M, K) int8
    sx: torch.Tensor,  # (M, 1) float32 row scales
    w8: torch.Tensor,  # (K, N) int8
    sw: torch.Tensor,  # (1, N) float32 column scales
    bias: Optional[torch.Tensor] = None,  # (N,) float32
    out_dtype: torch.dtype = torch.bfloat16,
    activation: str = "none",
) -> torch.Tensor:
    """int8 (M, K) . int8 (K, N) -> out_dtype (M, N) with the fused dequant
    (and activation) epilogue. ``w8a8_matmul.launches`` counts the calls that
    ran the kernel on the card."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"w8a8_matmul: unknown activation {activation!r}")
    if x8.device.type == "cpu":
        return w8a8_matmul_plain(x8, sx, w8, sw, bias, out_dtype, activation)
    if x8.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {x8.device}")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError("w8a8_matmul: x8 and w8 must be int8")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"w8a8_matmul: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x8.dim() != 2 or w8.dim() != 2 or x8.shape[1] != w8.shape[0]:
        raise ValueError(f"w8a8_matmul: shapes {tuple(x8.shape)} . {tuple(w8.shape)}")
    M, K = x8.shape
    N = w8.shape[1]
    if K % 4:
        raise ValueError(f"w8a8_matmul: K = {K} must be a multiple of 4")
    for name, t, n in (("sx", sx, M), ("sw", sw, N), ("bias", bias, N)):
        if t is not None and (t.numel() != n or t.device != x8.device):
            raise ValueError(f"w8a8_matmul: {name} must hold {n} values on {x8.device}")
    f32 = lambda t: None if t is None else t.to(torch.float32).reshape(-1).contiguous()
    x8c, w8c, sxc, swc, bc = x8.contiguous(), kmajor(w8), f32(sx), f32(sw), f32(bias)
    out = torch.empty((M, N), dtype=out_dtype, device=x8.device)
    with torch.cuda.device(x8.device):
        code = build.library().spk_w8a8_matmul(
            DTYPE_CODES[out_dtype], x8c.data_ptr(), sxc.data_ptr(), w8c.data_ptr(),
            swc.data_ptr(), _ptr(bc), out.data_ptr(), M, N, K, ACTIVATION_CODES[activation],
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def rowquant_cuda(x: torch.Tensor, groups: int = 1):
    """The row-quant kernel on a contiguous (M, K) float32 or bfloat16 CUDA
    tensor: int8 (M, K) and float32 (M, groups) scales."""
    M, K = x.shape
    x8 = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scales = torch.empty((M, groups), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = build.library().spk_rowquant(
            DTYPE_CODES[x.dtype], x.data_ptr(), x8.data_ptr(), scales.data_ptr(), M, K, groups,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "rowquant")
    return x8, scales


def w8a8_matmul_bf16in(
    x: torch.Tensor,  # (M, K) float32 or bfloat16
    w8: torch.Tensor,  # (K, N) int8
    sw: torch.Tensor,  # (1, N) float32
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    activation: str = "none",
) -> torch.Tensor:
    """Float (M, K) . int8 (K, N) -> out_dtype (M, N): x quantised per row
    (``rowquant_plain``'s arithmetic), then ``w8a8_matmul`` with the
    activation epilogue. ``w8a8_matmul_bf16in.launches`` counts the calls
    that ran the row-quant kernel on the card."""
    if x.device.type == "cpu":
        x8, sx = rowquant_plain(x)
        return w8a8_matmul_plain(x8, sx, w8, sw, bias, out_dtype, activation)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matmul_bf16in: unsupported device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"w8a8_matmul_bf16in: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"w8a8_matmul_bf16in: x must be (M, K), got {tuple(x.shape)}")
    x8, sx = rowquant_cuda(x.contiguous())
    w8a8_matmul_bf16in.launches += 1
    return w8a8_matmul(x8, sx, w8, sw, bias, out_dtype, activation)


w8a8_matmul_bf16in.launches = 0


def quant_dense(
    x: torch.Tensor,  # (..., K)
    kernel: torch.Tensor,  # (K, N) float32 parameter
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    activation: str = "none",
) -> torch.Tensor:
    """A dense layer on the W8A8 path: the kernel quantised per output column
    on the fly, x per row. On the card through ``w8a8_matmul_bf16in``; on the
    CPU JAX's off-TPU arithmetic (``quantize_rowwise``, the reference, the
    activation on the rounded output)."""
    lead, K = x.shape[:-1], x.shape[-1]
    N = kernel.shape[-1]
    x2 = x.reshape(-1, K)
    w8, sw = quantize_colwise(kernel)
    if x.device.type == "cpu":
        x8, sx = quantize_rowwise(x2)
        out = w8a8_matmul_reference(x8, sx, w8, sw, bias, out_dtype)
        out = ACTIVATIONS[activation](out.float()).to(out_dtype)
    else:
        out = w8a8_matmul_bf16in(x2, w8, sw, bias, out_dtype, activation)
    return out.reshape(*lead, N)
