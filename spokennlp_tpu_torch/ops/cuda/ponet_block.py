"""Fused PoNet mixer block: the five projections, GA, SMP, LMP, the out
projection, residual and LayerNorm.

Counterpart of ``spokennlp_tpu/ops/pallas/ponet_block.py``. On a CUDA tensor
``fused_ponet_mixer_block`` runs the hand-written kernels of
``csrc/ponet_block.cu``; on a CPU tensor it runs ``ponet_mixer_block_plain``,
the same function in PyTorch, which the tests hold against the JAX kernel
and the kernel is held against on the card.

The function is the TPU kernel's, which differs from the XLA mixer of
``models/ponet.py`` (``PoNetMixer``) on padded rows and segment ids:

- SMP pools over RUNS of equal adjacent ids (a run starts where the id
  changes), with pad rows at -1e9; the XLA mixer pools over equal ids
  anywhere, forces pad rows into segment 0 with their s projections, and
  drops ids >= L + 1;
- only the single-head GA (``ponet_ga_per_head=False``), fused with q.

``quantized=True`` is the TPU kernel's W8A8 mode: the five projections and
the out projection int8 x int8 -> int32, weights quantised per (projection,
output column) over the input axis (once a call, in the wrapper), x
quantised per row once for the five, and the mixed rows quantised per row
from float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.attention_block import _DTYPES, NEG_INF, _layer_norm
from spokennlp_tpu_torch.ops.cuda.int8_matmul import (
    float_product,
    int8_product,
    kmajor,
    quantize_colwise,
    rowquant_plain,
)

GA_ROWS, SMP_ROWS = 128, 64  # csrc/ponet_block.cu kGaRows, kSmpRows


def run_starts(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, L) bool: True where a run of equal adjacent ids starts."""
    prev = torch.cat([torch.full_like(segment_ids[:, :1], -1), segment_ids[:, :-1]], dim=1)
    return segment_ids != prev


def run_top2(values: torch.Tensor, segment_ids: torch.Tensor):
    """Each row's run (max, strict second max) over float32 values (B, L, H):
    the second max is the largest value below the max, -1e9 when there is
    none (ponet_block.py's scan, whose combine has -1e9 as its floor)."""
    B, L, H = values.shape
    run = torch.cumsum(run_starts(segment_ids).long(), dim=1) - 1  # (B, L) run index
    index = (run + torch.arange(B, device=run.device)[:, None] * L).reshape(-1)
    flat = values.reshape(B * L, H)
    idx = index[:, None].expand(-1, H)
    m1 = torch.full((B * L, H), NEG_INF, dtype=torch.float32, device=values.device)
    m1 = m1.scatter_reduce(0, idx, flat, "amax", include_self=True)
    tok_m1 = m1[index]
    below = torch.where(flat < tok_m1, flat, NEG_INF)
    m2 = torch.full_like(m1, NEG_INF).scatter_reduce(0, idx, below, "amax", include_self=True)
    return tok_m1.reshape(B, L, H), m2[index].reshape(B, L, H)


def ga_plain(q, k, v, mrow, sm_scale: float):
    """GA of the (B, L, H) projections in their element type: the masked mean
    query, the one-query softmax over the sequence (pad rows at -1e9), and
    the pooled value fused with q; sums in float32, rounded where the TPU
    kernel rounds."""
    dt = q.dtype
    mf = mrow.float()
    denom = mf.sum(dim=1, keepdim=True).clamp_min(1.0)
    g = ((q.float() * mf).sum(dim=1, keepdim=True) / denom).to(dt)  # (B, 1, H)
    att = (k.float() * g.float()).sum(dim=2, keepdim=True) * sm_scale
    att = att + torch.where(mrow, 0.0, NEG_INF)
    p = torch.exp(att - att.amax(dim=1, keepdim=True))
    w = (p / p.sum(dim=1, keepdim=True)).to(dt)
    gp = (v.float() * w.float()).sum(dim=1, keepdim=True).to(dt)
    return gp * q


def smp_plain(s, mrow, segment_ids):
    """SMP over runs of the s projection, pad rows at -1e9: the second-max
    trick with the singleton fallback."""
    sm = torch.where(mrow, s.float(), NEG_INF)
    m1, m2 = run_top2(sm, segment_ids)
    tok_m2 = torch.where(m2 <= NEG_INF / 2, m1, m2)
    return torch.where(sm >= m1, tok_m2, m1).to(s.dtype)


def lmp_offsets(local_window: int) -> range:
    """The window's offsets around a row: -w // 2 .. w - 1 - w // 2."""
    half = local_window // 2
    return range(-half, local_window - half)


def lmp_plain(l, mrow, local_window: int):
    """LMP: the max of the l projection over the window's offsets, pad rows
    and the sequence's edges at -1e9."""
    B, L, H = l.shape
    neg = torch.tensor(NEG_INF, dtype=l.dtype, device=l.device)
    lm = torch.where(mrow, l, neg)
    lmp = lm
    for off in lmp_offsets(local_window):
        if off == 0 or abs(off) >= L:
            continue
        fill = neg.expand(B, abs(off), H)
        shifted = (torch.cat([fill, lm[:, :off]], dim=1) if off < 0
                   else torch.cat([lm[:, off:], fill], dim=1))
        lmp = torch.maximum(lmp, shifted)
    return lmp


def ponet_mixer_block_plain(hidden, attention_mask, segment_ids, proj_kernels, proj_biases,
                            out_kernel, out_bias, *, local_window: int, sm_scale: float,
                            quantized: bool = False, ln_scale=None, ln_bias=None,
                            eps: float = 1e-12, proj: Optional[torch.Tensor] = None):
    """The TPU kernel's function in PyTorch; returns hidden's dtype. Sums and
    the epilogue in float32, values rounded to the element type where the
    TPU kernel rounds them; W8A8 with its integer arithmetic. The float
    modes' six products go through ``float_product`` (a planted fault of
    the card limit replaces it). ``proj`` (B*L, 5H) in hidden's dtype, the
    five projections side by side as the kernel's buffer holds them, takes
    the place of the first products (the card check of the float32 mode
    feeds the kernel's own: see ``fused_ponet_mixer_block``)."""
    dt = hidden.dtype
    B, L, H = hidden.shape
    x = hidden.float()
    bp = proj_biases.float().reshape(5, 1, H)
    if proj is not None:
        proj = [p.reshape(B, L, H) for p in proj.to(dt).split(H, dim=-1)]
    elif quantized:
        wp8, swp = quantize_colwise(proj_kernels)  # (5, H, H), (5, 1, H)
        x8, sx = rowquant_plain(x.reshape(B * L, H))
        proj = [(int8_product(x8, wp8[i]) * sx * swp[i] + bp[i]).to(dt).reshape(B, L, H)
                for i in range(5)]
    else:
        wp = proj_kernels.to(dt)
        proj = [(float_product(x, wp[i]) + bp[i]).to(dt) for i in range(5)]
    q, k, v, s, l = proj
    mrow = (attention_mask > 0)[..., None]  # (B, L, 1)
    pooled = ga_plain(q, k, v, mrow, sm_scale) + smp_plain(s, mrow, segment_ids)
    mixed = torch.where(mrow, pooled + lmp_plain(l, mrow, local_window), 0.0).float()
    if quantized:
        wo8, swo = quantize_colwise(out_kernel)
        c8, sc = rowquant_plain(mixed.reshape(B * L, H))
        out = (int8_product(c8, wo8) * sc * swo).reshape(B, L, H)
    else:
        out = float_product(mixed.to(dt), out_kernel.to(dt))
    out = out + out_bias.float()
    if ln_scale is None:
        return out.to(dt)
    return _layer_norm(out + x, ln_scale, ln_bias, eps).to(dt)


def fused_ponet_mixer_block(
    hidden: torch.Tensor,  # (B, L, H) float32 or bfloat16
    attention_mask: torch.Tensor,  # (B, L) int, 1 = real
    segment_ids: torch.Tensor,  # (B, L) int; runs of equal adjacent ids pool together
    proj_kernels: torch.Tensor,  # (5, H, H) float32: q, k, v, s, l
    proj_biases: torch.Tensor,  # (5, H)
    out_kernel: torch.Tensor,  # (H, H)
    out_bias: torch.Tensor,  # (H,)
    *,
    local_window: int,
    sm_scale: float,
    quantized: bool = False,
    ln_scale: Optional[torch.Tensor] = None,
    ln_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
    buffers: Optional[dict] = None,
) -> torch.Tensor:
    """LN(x + mixer(x) Wo + bo) when ln_scale and ln_bias are given, else
    mixer(x) Wo + bo; returns (B, L, H) in hidden's dtype. Float modes:
    weights rounded to hidden's dtype. A ``buffers`` dict receives the five
    projections the kernel computed, ``proj`` (B*L, 5H) in hidden's dtype
    (on the card only). ``fused_ponet_mixer_block.launches`` counts the
    calls that ran the kernels on the card."""
    if hidden.device.type == "cpu":
        return ponet_mixer_block_plain(
            hidden, attention_mask, segment_ids, proj_kernels, proj_biases, out_kernel, out_bias,
            local_window=local_window, sm_scale=sm_scale, quantized=quantized, ln_scale=ln_scale,
            ln_bias=ln_bias, eps=eps)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_ponet_mixer_block: unsupported device {hidden.device}")
    if hidden.dtype not in _DTYPES:
        raise TypeError(f"fused_ponet_mixer_block: hidden must be float32 or bfloat16, got "
                        f"{hidden.dtype}")
    if hidden.dim() != 3 or not hidden.is_contiguous():
        raise ValueError("fused_ponet_mixer_block: hidden must be a contiguous (B, L, H) tensor")
    B, L, H = hidden.shape
    fuse_ln = ln_scale is not None
    expect = {
        "attention_mask": (attention_mask, (B, L)), "segment_ids": (segment_ids, (B, L)),
        "proj_kernels": (proj_kernels, (5, H, H)), "proj_biases": (proj_biases, (5, H)),
        "out_kernel": (out_kernel, (H, H)), "out_bias": (out_bias, (H,)),
    }
    if fuse_ln:
        expect.update(ln_scale=(ln_scale, (H,)), ln_bias=(ln_bias, (H,)))
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_ponet_mixer_block: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != hidden.device:
            raise ValueError(f"fused_ponet_mixer_block: {name} is on {t.device}, hidden on "
                             f"{hidden.device}")
    if local_window <= 0:
        raise ValueError(f"fused_ponet_mixer_block: local_window must be positive, got "
                         f"{local_window}")
    if quantized and H % 4:
        raise ValueError(f"fused_ponet_mixer_block: W8A8 needs H a multiple of 4, got {H}")

    dt, dev, M = hidden.dtype, hidden.device, B * L
    f32 = lambda t: t.to(torch.float32).reshape(-1).contiguous()
    mask = attention_mask.to(torch.int32).contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    bp, bo = f32(proj_biases), f32(out_bias)
    lns = f32(ln_scale) if fuse_ln else torch.ones(H, device=dev)
    lnb = f32(ln_bias) if fuse_ln else torch.zeros(H, device=dev)
    # the five (H, H) projections side by side: (H, 5H)
    side_by_side = lambda w: w.permute(1, 0, 2).reshape(H, 5 * H).contiguous()
    if quantized:
        wp8, swp = quantize_colwise(proj_kernels)
        wo8, swo = quantize_colwise(out_kernel)
        wp, swp, wo, swo = kmajor(side_by_side(wp8)), f32(swp), kmajor(wo8), f32(swo)
        x8 = torch.empty((M, H), dtype=torch.int8, device=dev)
        scales = torch.empty((M,), dtype=torch.float32, device=dev)
    else:
        wp, wo = side_by_side(proj_kernels.to(dt)), out_kernel.to(dt).contiguous()
        swp = swo = x8 = scales = None
    tiles = -(-L // SMP_ROWS)
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    scratch = [empty(M, 5 * H, dtype=dt), empty(B, -(-L // GA_ROWS), H), empty(B, H),
               empty(B, L), empty(B, H), empty(M, H, dtype=dt), empty(B, tiles, H, 2),
               empty(B, tiles, H, 2), empty(B, tiles, dtype=torch.int32)]
    rows = empty(M, H)
    out = torch.empty_like(hidden)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = build.library().spk_ponet_block(
            _DTYPES[dt], int(quantized), hidden.data_ptr(), mask.data_ptr(), seg.data_ptr(),
            wp.data_ptr(), ptr(swp), bp.data_ptr(), wo.data_ptr(), ptr(swo), bo.data_ptr(),
            lns.data_ptr(), lnb.data_ptr(), *(t.data_ptr() for t in scratch), ptr(x8), ptr(scales),
            rows.data_ptr(), out.data_ptr(), B, L, H, int(local_window), int(fuse_ln),
            float(sm_scale), float(eps), torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "fused_ponet_mixer_block")
    fused_ponet_mixer_block.launches += 1
    if buffers is not None:
        buffers["proj"] = scratch[0]
    return out


fused_ponet_mixer_block.launches = 0
