"""Fused MLP half-layer: out = LN(x + W2 . act(W1 . x + b1) + b2).

Counterpart of ``spokennlp_tpu/ops/pallas/mlp_block.py``. On a CUDA tensor
``fused_mlp_block`` runs the hand-written kernels of ``csrc/mlp_block.cu``;
on a CPU tensor it runs ``mlp_block_plain``, the same function in float32
PyTorch. "gelu" is the tanh form here, as in the TPU kernel.

``quantized=True`` is the TPU kernel's W8A8 mode: both products int8 x int8
-> int32, the weights quantised per output column (once a call, in the
wrapper), x quantised per row, and the intermediate act(x W1 + b1)
quantised per row in float32, before any rounding to the element type.
``static_h_scale=True`` (with ``quantized``) quantises the intermediate with
one per-tensor scale instead, estimated outside the kernel as JAX does
(``static_h_scale_estimate``); without ``quantized`` it is ignored, as in
JAX.
"""

from __future__ import annotations

import torch

from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.attention_block import _DTYPES, _layer_norm
from spokennlp_tpu_torch.ops.cuda.int8_matmul import (
    ACTIVATION_CODES,
    ACTIVATIONS,
    float_product,
    int8_product,
    kmajor,
    quantize_colwise,
    rowquant_plain,
)


def static_h_scale_estimate(x, w1, b1, activation):
    """The per-tensor intermediate scale of ``static_h_scale`` as JAX's
    ``fused_mlp_block`` estimates it, outside the kernel: the rows
    ``x[::max(1, M // 512)]`` (so up to 1023 rows when M < 1024), an
    unquantised product with the weights in x's dtype and a float32
    accumulator, + b1, the activation; s = max(max |h|, 1e-3) / 127, as a
    one-element float32 tensor on x's device."""
    xs = x[:: max(1, x.shape[0] // 512)]
    h = ACTIVATIONS[activation](xs.float() @ w1.to(x.dtype).float() + b1.float())
    return (h.abs().amax().clamp_min(1e-3) * (1.0 / 127.0)).reshape(1)


def mlp_block_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, *, activation, eps, quantized=False,
                    static_h_scale=False):
    """The fused block in plain PyTorch; returns x's dtype. Float modes in
    float32; W8A8 with the TPU kernel's integer arithmetic, the intermediate
    quantised per row or, with ``static_h_scale``, by one estimated scale
    (``rint(h * (1 / s))`` clipped to +-127, dequantised by s)."""
    xf = x.float()
    if quantized:
        w1q, sw1 = quantize_colwise(w1)
        w2q, sw2 = quantize_colwise(w2)
        x8, sx = rowquant_plain(xf)
        h = ACTIVATIONS[activation](int8_product(x8, w1q) * sx * sw1 + b1.float())
        if static_h_scale:
            sh = static_h_scale_estimate(x, w1, b1, activation)
            h8 = torch.round(h * (1.0 / sh)).clamp(-127, 127).to(torch.int8)
        else:
            h8, sh = rowquant_plain(h)
        y = int8_product(h8, w2q) * sh * sw2 + b2.float()
    else:
        h = ACTIVATIONS[activation](float_product(xf, w1) + b1.float())
        y = float_product(h, w2) + b2.float()
    return _layer_norm(y + xf, ln_scale, ln_bias, eps).to(x.dtype)


def fused_mlp_block(
    x: torch.Tensor,  # (M, H) float32 or bfloat16: the post-attention hidden
    w1: torch.Tensor,  # (H, I)
    b1: torch.Tensor,  # (I,)
    w2: torch.Tensor,  # (I, H)
    b2: torch.Tensor,  # (H,)
    ln_scale: torch.Tensor,  # (H,)
    ln_bias: torch.Tensor,  # (H,)
    *,
    activation: str,
    eps: float,
    quantized: bool,
    static_h_scale: bool = False,
) -> torch.Tensor:
    """h2 = LN(x + W2 . act(W1 . x + b1) + b2); returns (M, H) in x's dtype.

    Float modes: weights rounded to x's dtype, and the (M, I) intermediate
    rounded to it before the second product, as in the TPU kernel. W8A8
    (``quantized``): weights quantised from their float32 values; with
    ``static_h_scale`` the intermediate takes one scale, estimated here
    (``static_h_scale_estimate``) and quantised in the first product's
    epilogue. ``fused_mlp_block.launches`` counts the calls that ran the
    kernels on the card, ``fused_mlp_block.static_h_launches`` those of them
    with the static scale.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(f"fused_mlp_block: unknown activation {activation!r}")
    static_h = bool(static_h_scale) and quantized
    if x.device.type == "cpu":
        return mlp_block_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, activation=activation,
                               eps=eps, quantized=quantized, static_h_scale=static_h)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_block: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_mlp_block: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fused_mlp_block: x must be a contiguous (M, H) tensor")
    M, H = x.shape
    if w1.dim() != 2 or w1.shape[0] != H:
        raise ValueError(f"fused_mlp_block: w1 must be (H, I), got {tuple(w1.shape)}")
    I = w1.shape[1]
    expect = {
        "w1": (w1, (H, I)), "b1": (b1, (I,)), "w2": (w2, (I, H)), "b2": (b2, (H,)),
        "ln_scale": (ln_scale, (H,)), "ln_bias": (ln_bias, (H,)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_mlp_block: {name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"fused_mlp_block: {name} is on {t.device}, x on {x.device}")
    if quantized and (H % 4 or I % 4):
        raise ValueError(f"fused_mlp_block: W8A8 needs H and I multiples of 4, got {H}, {I}")

    dt = x.dtype
    b1c, b2c, lns, lnb = (
        t.to(torch.float32).contiguous() for t in (b1, b2, ln_scale, ln_bias)
    )
    ln_buf = torch.empty((M, H), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    act = ACTIVATION_CODES[activation]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if quantized:
            (w1q, sw1), (w2q, sw2) = quantize_colwise(w1), quantize_colwise(w2)
            w1q, w2q = kmajor(w1q), kmajor(w2q)
            if static_h:
                hs = static_h_scale_estimate(x, w1, b1, activation).contiguous()
                x8 = torch.empty((M * (H + I),), dtype=torch.int8, device=x.device)
                scales = torch.empty((2 * M,), dtype=torch.float32, device=x.device)
                h_buf = None
            else:
                hs = None
                x8 = torch.empty((M * max(H, I),), dtype=torch.int8, device=x.device)
                scales = torch.empty((M,), dtype=torch.float32, device=x.device)
                h_buf = torch.empty((M, I), dtype=torch.float32, device=x.device)
            ptr = lambda t: None if t is None else t.data_ptr()
            code = build.library().spk_mlp_block_w8a8(
                _DTYPES[dt], x.data_ptr(), x8.data_ptr(), scales.data_ptr(), w1q.data_ptr(),
                sw1.data_ptr(), b1c.data_ptr(), w2q.data_ptr(), sw2.data_ptr(), b2c.data_ptr(),
                lns.data_ptr(), lnb.data_ptr(), ptr(hs), ptr(h_buf), ln_buf.data_ptr(),
                out.data_ptr(), M, H, I, act, float(eps), stream,
            )
        else:
            w1c, w2c = w1.to(dt).contiguous(), w2.to(dt).contiguous()
            h_buf = torch.empty((M, I), dtype=dt, device=x.device)
            code = build.library().spk_mlp_block(
                _DTYPES[dt], x.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(),
                b2c.data_ptr(), lns.data_ptr(), lnb.data_ptr(), h_buf.data_ptr(),
                ln_buf.data_ptr(), out.data_ptr(), M, H, I, act, float(eps), stream,
            )
    build.check(code, "fused_mlp_block")
    fused_mlp_block.launches += 1
    fused_mlp_block.static_h_launches += static_h
    return out


fused_mlp_block.launches = 0
fused_mlp_block.static_h_launches = 0
