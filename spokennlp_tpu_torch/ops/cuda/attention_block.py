"""Fused attention block: QKV projection, segment-masked attention, output
projection, residual and LayerNorm.

Counterpart of ``spokennlp_tpu/ops/pallas/attention_block.py``. On a CUDA
tensor ``fused_attention_block`` runs the hand-written kernels of
``csrc/attention_block.cu``; on a CPU tensor it runs
``attention_block_plain``, the same function in float32 PyTorch, which the
tests hold against the JAX kernel and the kernel is held against on the card.

Masking is by segment id: 0 marks padding, positions with equal ids > 0
attend to each other, which covers padding and window packing alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from spokennlp_tpu_torch.ops.cuda import build

NEG_INF = -1e9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _layer_norm(r, scale, bias, eps):
    mean = r.mean(dim=-1, keepdim=True)
    c = r - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * scale.float() + bias.float()


def attention_block_plain(
    hidden: torch.Tensor,
    segment_ids: torch.Tensor,
    qkv_kernel: torch.Tensor,
    qkv_bias: torch.Tensor,
    out_kernel: torch.Tensor,
    out_bias: torch.Tensor,
    *,
    sm_scale: float,
    ln_scale: Optional[torch.Tensor] = None,
    ln_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
) -> torch.Tensor:
    """The fused block in plain float32 PyTorch; returns hidden's dtype.

    Masked keys get an additive -1e9, as in the TPU kernel, so a fully padded
    query row becomes a uniform average of v: compare only rows with seg > 0.
    """
    x = hidden.float()
    qkv = torch.einsum("blh,hsnd->blsnd", x, qkv_kernel.float()) + qkv_bias.float()
    q, k, v = qkv.unbind(2)  # (B, L, nh, hd)
    scores = torch.einsum("blnd,bmnd->bnlm", q * sm_scale, k)
    seg = segment_ids
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    scores = scores + torch.where(allowed, 0.0, NEG_INF)[:, None]
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bnlm,bmnd->blnd", probs, v)
    out = torch.einsum("blnd,ndh->blh", ctx, out_kernel.float()) + out_bias.float()
    if ln_scale is not None:
        out = _layer_norm(out + x, ln_scale, ln_bias, eps)
    return out.to(hidden.dtype)


def fused_attention_block(
    hidden: torch.Tensor,  # (B, L, H) float32 or bfloat16
    segment_ids: torch.Tensor,  # (B, L) int; 0 = padding, >0 = segment id
    qkv_kernel: torch.Tensor,  # (H, 3, nh, hd)
    qkv_bias: torch.Tensor,  # (3, nh, hd)
    out_kernel: torch.Tensor,  # (nh, hd, H)
    out_bias: torch.Tensor,  # (H,)
    *,
    sm_scale: float,
    ln_scale: Optional[torch.Tensor] = None,  # (H,): out = LN(hidden + attn)
    ln_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
    quantized: bool = False,
) -> torch.Tensor:
    """Full attention block; returns (B, L, H) in hidden's dtype.

    Weights are rounded to hidden's dtype and biases and LayerNorm parameters
    kept in float32, as the TPU kernel does. ``fused_attention_block.launches``
    counts the calls that ran the kernels on the card.
    """
    if quantized:
        raise NotImplementedError("W8A8 attention block is not ported yet")
    if hidden.device.type == "cpu":
        return attention_block_plain(
            hidden, segment_ids, qkv_kernel, qkv_bias, out_kernel, out_bias,
            sm_scale=sm_scale, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps,
        )
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_attention_block: unsupported device {hidden.device}")
    if hidden.dtype not in _DTYPES:
        raise TypeError(f"fused_attention_block: hidden must be float32 or bfloat16, got {hidden.dtype}")
    if hidden.dim() != 3 or not hidden.is_contiguous():
        raise ValueError("fused_attention_block: hidden must be a contiguous (B, L, H) tensor")
    B, L, H = hidden.shape
    if qkv_kernel.dim() != 4 or qkv_kernel.shape[0] != H or qkv_kernel.shape[1] != 3:
        raise ValueError(f"fused_attention_block: qkv_kernel must be (H, 3, nh, hd), got {tuple(qkv_kernel.shape)}")
    nh, hd = qkv_kernel.shape[2], qkv_kernel.shape[3]
    if hd not in (32, 64, 128):
        raise ValueError(f"fused_attention_block: head_dim {hd} not supported (32, 64 or 128)")
    expect = {
        "segment_ids": (segment_ids, (B, L)),
        "qkv_bias": (qkv_bias, (3, nh, hd)),
        "out_kernel": (out_kernel, (nh, hd, H)),
        "out_bias": (out_bias, (H,)),
    }
    if ln_scale is not None:
        expect["ln_scale"] = (ln_scale, (H,))
        expect["ln_bias"] = (ln_bias, (H,))
    for name, (t, shape) in expect.items():
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"fused_attention_block: {name} must be {shape}")
        if t.device != hidden.device:
            raise ValueError(f"fused_attention_block: {name} is on {t.device}, hidden on {hidden.device}")
    if segment_ids.dtype.is_floating_point:
        raise TypeError("fused_attention_block: segment_ids must be integers")

    dt = hidden.dtype
    seg = segment_ids.to(torch.int32).contiguous()
    wqkv = qkv_kernel.to(dt).contiguous()
    wo = out_kernel.to(dt).contiguous()
    f32 = lambda t: t.to(torch.float32).contiguous()
    bqkv, bo = f32(qkv_bias), f32(out_bias)
    fuse_ln = ln_scale is not None
    lns = f32(ln_scale) if fuse_ln else None
    lnb = f32(ln_bias) if fuse_ln else None
    qkv_buf = torch.empty((3, B, nh, L, hd), dtype=dt, device=hidden.device)
    ctx_buf = torch.empty((B, L, nh * hd), dtype=dt, device=hidden.device)
    ln_buf = torch.empty((B * L, H), dtype=torch.float32, device=hidden.device)
    out = torch.empty_like(hidden)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(hidden.device):
        code = build.library().spk_attention_block(
            _DTYPES[dt], ptr(hidden), ptr(seg), ptr(wqkv), ptr(bqkv), ptr(wo), ptr(bo),
            ptr(lns), ptr(lnb), ptr(qkv_buf), ptr(ctx_buf), ptr(ln_buf), ptr(out),
            B, L, H, nh, hd, float(sm_scale), float(eps), int(fuse_ln),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "fused_attention_block")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0
