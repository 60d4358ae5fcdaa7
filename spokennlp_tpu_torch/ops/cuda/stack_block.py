"""The whole post-LayerNorm encoder stack in one kernel launch.

Counterpart of ``spokennlp_tpu/ops/pallas/stack_block.py``
(``fused_encoder_stack``): every layer's attention block (h1 = LN(x +
MHA(x) Wo + bo)) and MLP block (x' = LN(h1 + act(h1 W1 + b1) W2 + b2)) in
float32, bfloat16 or W8A8, the hidden state kept between layers. On a CUDA
tensor it runs the persistent cooperative kernel of ``csrc/stack_block.cu``,
which computes exactly the chain of ``fused_attention_block`` and
``fused_mlp_block``; on a CPU tensor ``stack_plain``, that chain's plain
versions layer after layer (one head group, as the TPU stack kernel
quantises ctx over whole rows).
"""

from __future__ import annotations

import ctypes

import torch

from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.attention_block import (
    attention_block_plain,
    quantize_attention_weights,
)
from spokennlp_tpu_torch.ops.cuda.int8_matmul import (
    ACTIVATION_CODES,
    ACTIVATIONS,
    DTYPE_CODES,
    kmajor,
    quantize_colwise,
)
from spokennlp_tpu_torch.ops.cuda.mlp_block import mlp_block_plain

# the stacked parameters, in the order the functions take them
PARAM_NAMES = ("qkv_kernel", "qkv_bias", "out_kernel", "out_bias", "ln1_scale", "ln1_bias",
               "mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2", "ln2_scale", "ln2_bias")


def stack_plain(hidden, segment_ids, qkv_kernels, qkv_biases, out_kernels, out_biases,
                ln1_scales, ln1_biases, mlp_w1, mlp_b1, mlp_w2, mlp_b2, ln2_scales, ln2_biases,
                *, sm_scale, quantized=True, activation="gelu", eps=1e-12):
    """The loop of layers the stack kernel equals, in the blocks' plain
    versions; returns (B, L, H) in hidden's dtype."""
    B, L, H = hidden.shape
    nh = qkv_kernels.shape[3]
    h = hidden
    for l in range(qkv_kernels.shape[0]):
        h = attention_block_plain(
            h, segment_ids, qkv_kernels[l], qkv_biases[l], out_kernels[l], out_biases[l],
            sm_scale=sm_scale, ln_scale=ln1_scales[l], ln_bias=ln1_biases[l], eps=eps,
            quantized=quantized, heads_per_block=nh,
        )
        h = mlp_block_plain(
            h.reshape(B * L, H), mlp_w1[l], mlp_b1[l], mlp_w2[l], mlp_b2[l], ln2_scales[l],
            ln2_biases[l], activation=activation, eps=eps, quantized=quantized,
        ).reshape(B, L, H)
    return h


def fused_encoder_stack(
    hidden: torch.Tensor,  # (B, L, H) float32 or bfloat16
    segment_ids: torch.Tensor,  # (B, L) int; 0 = padding, >0 = window/segment id
    qkv_kernels: torch.Tensor,  # (NL, H, 3, nh, hd) float32 parameters, stacked over layers
    qkv_biases: torch.Tensor,  # (NL, 3, nh, hd)
    out_kernels: torch.Tensor,  # (NL, nh, hd, H)
    out_biases: torch.Tensor,  # (NL, H)
    ln1_scales: torch.Tensor,  # (NL, H)
    ln1_biases: torch.Tensor,  # (NL, H)
    mlp_w1: torch.Tensor,  # (NL, H, I)
    mlp_b1: torch.Tensor,  # (NL, I)
    mlp_w2: torch.Tensor,  # (NL, I, H)
    mlp_b2: torch.Tensor,  # (NL, H)
    ln2_scales: torch.Tensor,  # (NL, H)
    ln2_biases: torch.Tensor,  # (NL, H)
    *,
    sm_scale: float,
    quantized: bool = True,
    activation: str = "gelu",
    eps: float = 1e-12,
) -> torch.Tensor:
    """Run the full post-LN stack; returns (B, L, H) in hidden's dtype.

    The weights are prepared here once a call, as JAX prepares them: the
    float modes round them to hidden's dtype; W8A8 quantises them per output
    column from their float32 values. ``fused_encoder_stack.launches``
    counts the calls that ran the kernel on the card, and
    ``fused_encoder_stack.grid`` holds the number of blocks the last one
    launched.
    """
    params = (qkv_kernels, qkv_biases, out_kernels, out_biases, ln1_scales, ln1_biases, mlp_w1,
              mlp_b1, mlp_w2, mlp_b2, ln2_scales, ln2_biases)
    if activation not in ACTIVATIONS:
        raise ValueError(f"fused_encoder_stack: unknown activation {activation!r}")
    if hidden.device.type == "cpu":
        return stack_plain(hidden, segment_ids, *params, sm_scale=sm_scale, quantized=quantized,
                           activation=activation, eps=eps)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_encoder_stack: unsupported device {hidden.device}")
    if hidden.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_encoder_stack: hidden must be float32 or bfloat16, got {hidden.dtype}")
    if hidden.dim() != 3 or not hidden.is_contiguous():
        raise ValueError("fused_encoder_stack: hidden must be a contiguous (B, L, H) tensor")
    B, L, H = hidden.shape
    if qkv_kernels.dim() != 5 or qkv_kernels.shape[1] != H or qkv_kernels.shape[2] != 3:
        raise ValueError(f"fused_encoder_stack: qkv_kernels must be (NL, H, 3, nh, hd), got "
                         f"{tuple(qkv_kernels.shape)}")
    NL, _, _, nh, hd = qkv_kernels.shape
    I, HN = mlp_w1.shape[-1], nh * hd
    if hd not in (32, 64, 128):
        raise ValueError(f"fused_encoder_stack: head_dim {hd} not supported (32, 64 or 128)")
    if H % 4 or I % 4:
        raise ValueError(f"fused_encoder_stack: H and I must be multiples of 4, got {H}, {I}")
    shapes = ((NL, H, 3, nh, hd), (NL, 3, nh, hd), (NL, nh, hd, H), (NL, H), (NL, H), (NL, H),
              (NL, H, I), (NL, I), (NL, I, H), (NL, H), (NL, H), (NL, H))
    for name, t, shape in zip(PARAM_NAMES, params, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_encoder_stack: {name} must be {shape}, got {tuple(t.shape)}")
        if t.device != hidden.device:
            raise ValueError(f"fused_encoder_stack: {name} is on {t.device}, hidden on {hidden.device}")
    if tuple(segment_ids.shape) != (B, L) or segment_ids.device != hidden.device:
        raise ValueError(f"fused_encoder_stack: segment_ids must be ({B}, {L}) on {hidden.device}")
    if segment_ids.dtype.is_floating_point:
        raise TypeError("fused_encoder_stack: segment_ids must be integers")

    dt, dev, M = hidden.dtype, hidden.device, B * L
    f32 = lambda t, *shape: t.to(torch.float32).reshape(*shape).contiguous()
    if quantized:
        wqkv, swqkv, wo, swo = quantize_attention_weights(qkv_kernels, out_kernels, 1)
        (w1, sw1), (w2, sw2) = quantize_colwise(mlp_w1), quantize_colwise(mlp_w2)
        wqkv, wo, w1, w2 = (kmajor(t) for t in (wqkv, wo, w1, w2))
        swqkv, swo, sw1, sw2 = (f32(swqkv, NL, -1), f32(swo, NL, -1), f32(sw1, NL, -1),
                                f32(sw2, NL, -1))
        mid = torch.empty((M, I), dtype=torch.float32, device=dev)
        q8 = torch.empty((M * max(H, HN, I),), dtype=torch.int8, device=dev)
        scales = torch.empty((M,), dtype=torch.float32, device=dev)
    else:
        wqkv = qkv_kernels.reshape(NL, H, 3 * HN).to(dt)
        wo, w1, w2 = out_kernels.reshape(NL, HN, H).to(dt), mlp_w1.to(dt), mlp_w2.to(dt)
        swqkv = swo = sw1 = sw2 = q8 = scales = None
        mid = torch.empty((M, I), dtype=dt, device=dev)
    wqkv, wo, w1, w2 = (t.contiguous() for t in (wqkv, wo, w1, w2))
    bqkv, bo, b1, b2 = (f32(qkv_biases, NL, -1), f32(out_biases, NL, -1), f32(mlp_b1, NL, -1),
                        f32(mlp_b2, NL, -1))
    ln1s, ln1b, ln2s, ln2b = (f32(t, NL, H) for t in (ln1_scales, ln1_biases, ln2_scales,
                                                      ln2_biases))
    seg = segment_ids.to(torch.int32).contiguous()
    qkv = torch.empty((3, B, nh, L, hd), dtype=dt, device=dev)
    ctx = torch.empty((M, HN), dtype=dt, device=dev)
    h1 = torch.empty((M, H), dtype=dt, device=dev)
    rows = torch.empty((M, H), dtype=torch.float32, device=dev)
    out = torch.empty_like(hidden)
    grid = ctypes.c_int(0)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = build.library().spk_encoder_stack(
            DTYPE_CODES[dt], int(quantized), ptr(hidden), ptr(seg), ptr(wqkv), ptr(swqkv),
            ptr(bqkv), ptr(wo), ptr(swo), ptr(bo), ptr(ln1s), ptr(ln1b), ptr(w1), ptr(sw1),
            ptr(b1), ptr(w2), ptr(sw2), ptr(b2), ptr(ln2s), ptr(ln2b), ptr(qkv), ptr(ctx),
            ptr(h1), ptr(mid), ptr(q8), ptr(scales), ptr(rows), ptr(out), ctypes.addressof(grid),
            B, L, H, nh, hd, I, NL, ACTIVATION_CODES[activation], float(sm_scale), float(eps),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "fused_encoder_stack")
    fused_encoder_stack.launches += 1
    fused_encoder_stack.grid = grid.value
    return out


fused_encoder_stack.launches = 0
fused_encoder_stack.grid = 0
