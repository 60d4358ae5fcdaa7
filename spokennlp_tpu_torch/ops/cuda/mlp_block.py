"""Fused MLP half-layer: out = LN(x + W2 . act(W1 . x + b1) + b2).

Counterpart of ``spokennlp_tpu/ops/pallas/mlp_block.py``. On a CUDA tensor
``fused_mlp_block`` runs the hand-written kernels of ``csrc/mlp_block.cu``;
on a CPU tensor it runs ``mlp_block_plain``, the same function in float32
PyTorch. "gelu" is the tanh form here, as in the TPU kernel.
"""

from __future__ import annotations

import torch

from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.attention_block import _DTYPES, _layer_norm
from spokennlp_tpu_torch.ops.cuda.int8_matmul import ACTIVATION_CODES, ACTIVATIONS


def mlp_block_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, *, activation, eps):
    """The fused block in plain float32 PyTorch; returns x's dtype."""
    xf = x.float()
    h = ACTIVATIONS[activation](xf @ w1.float() + b1.float())
    y = h @ w2.float() + b2.float()
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
) -> torch.Tensor:
    """h2 = LN(x + W2 . act(W1 . x + b1) + b2); returns (M, H) in x's dtype.

    Weights are rounded to x's dtype, and the (M, I) intermediate is rounded
    to it before the second product, as in the TPU kernel.
    ``fused_mlp_block.launches`` counts the calls that ran the kernels on the
    card.
    """
    if quantized:
        raise NotImplementedError("W8A8 MLP block is not ported yet")
    if activation not in ACTIVATIONS:
        raise ValueError(f"fused_mlp_block: unknown activation {activation!r}")
    if x.device.type == "cpu":
        return mlp_block_plain(
            x, w1, b1, w2, b2, ln_scale, ln_bias, activation=activation, eps=eps
        )
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

    dt = x.dtype
    w1c, w2c = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    b1c, b2c, lns, lnb = (
        t.to(torch.float32).contiguous() for t in (b1, b2, ln_scale, ln_bias)
    )
    h_buf = torch.empty((M, I), dtype=dt, device=x.device)
    ln_buf = torch.empty((M, H), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = build.library().spk_mlp_block(
            _DTYPES[dt], x.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(),
            b2c.data_ptr(), lns.data_ptr(), lnb.data_ptr(), h_buf.data_ptr(), ln_buf.data_ptr(),
            out.data_ptr(),
            M, H, I, ACTIVATION_CODES[activation], float(eps),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "fused_mlp_block")
    fused_mlp_block.launches += 1
    return out


fused_mlp_block.launches = 0
