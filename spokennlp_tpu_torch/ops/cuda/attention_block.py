"""Fused attention block: QKV projection, segment-masked attention, output
projection, residual and LayerNorm.

Counterpart of ``spokennlp_tpu/ops/pallas/attention_block.py``. On a CUDA
tensor ``fused_attention_block`` runs the hand-written kernels of
``csrc/attention_block.cu``; on a CPU tensor it runs
``attention_block_plain``, the same function in float32 PyTorch, which the
tests hold against the JAX kernel and the kernel is held against on the card.

Masking is by segment id: 0 marks padding, positions with equal ids > 0
attend to each other, which covers padding and window packing alike.

``quantized=True`` is the TPU kernel's W8A8 mode: the QKV and output
projections run int8 x int8 -> int32 with weights quantised per output
column (once a call, in the wrapper) and x and ctx quantised per row inside
the kernel; ctx is quantised over each head group's ``heads_per_block * hd``
columns, as the TPU kernel, whose grid step owned one head group, did. Its
plain version follows the TPU kernel's arithmetic: q, k, v and ctx rounded
to the element type, the exponent taken in it. ``core_int8`` ("qk", "av",
"both" or True for both) also runs the attention core on int8 operands as
the TPU kernel does (``attention_core_int8_plain``); without ``quantized``
it is ignored, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from spokennlp_tpu_torch.ops.cuda import attention_models as am
from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.int8_matmul import (
    DTYPE_CODES as _DTYPES,
    float_product,
    int8_product,
    kmajor,
    quantize_colwise,
    rowquant_plain,
)

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the attention kernels are built for
LN127 = 4.844187086458591  # ln(127)
# core_int8 values -> the kernel's CoreInt8 flags (csrc/attention_core.cuh)
CORE_INT8_CODES = {False: 0, None: 0, "qk": 1, "av": 2, "both": 3, True: 3}


def _layer_norm(r, scale, bias, eps):
    mean = r.mean(dim=-1, keepdim=True)
    c = r - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * scale.float() + bias.float()


def head_groups(num_heads: int, heads_per_block: int) -> int:
    """The number of head groups G of the TPU kernel: heads_per_block heads
    a group, or one head a group when it does not divide num_heads."""
    hb = heads_per_block if heads_per_block > 0 and num_heads % heads_per_block == 0 else 1
    return num_heads // hb


def quantize_attention_weights(qkv_kernel, out_kernel, groups: int):
    """int8 weights with per-column scales, as the TPU kernel prepares them:
    wqkv (H, 3 nh hd) and its scales (3 nh hd,); wo (nh hd, H) quantised per
    head group and its scales (groups, H). Works on stacks of layers too
    (leading axes carried through)."""
    *lead, H, _, nh, hd = qkv_kernel.shape
    wqkv8, swqkv = quantize_colwise(qkv_kernel.reshape(*lead, H, 3 * nh * hd))
    wo8, swo = quantize_colwise(out_kernel.reshape(*lead, groups, nh * hd // groups, H))
    return (wqkv8, swqkv.reshape(*lead, 3 * nh * hd), wo8.reshape(*lead, nh * hd, H),
            swo.reshape(*lead, groups, H))


def attention_core_plain(q, k, v, segment_ids, exp_dtype):
    """Masked softmax attention of (B, L, nh, hd) q (already scaled), k, v
    as the TPU kernels compute it: float32 scores plus the additive -1e9
    mask, e = exp(s - max) taken in ``exp_dtype`` and rounded to v's type,
    the float32 sum of e, and the context divided by it after P.V; both
    products through ``attention_models.core_product``. Returns the float32
    context (B, L, nh, hd)."""
    scores = am.core_product(q.transpose(1, 2), k.permute(0, 2, 3, 1))
    seg = segment_ids
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    scores = scores + torch.where(allowed, 0.0, NEG_INF)[:, None]
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp((scores - m).to(exp_dtype)).to(v.dtype).float()
    denom = p.sum(dim=-1, keepdim=True)  # (B, nh, L, 1)
    ctx = am.core_product(p, v.transpose(1, 2)).transpose(1, 2)
    return ctx / denom.permute(0, 2, 1, 3)


def _int_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An exact integer product of integer-valued tensors, as float32: in
    int64 on the CPU, in float64 on the card (exact below 2^53)."""
    wide = torch.int64 if a.device.type == "cpu" else torch.float64
    return torch.einsum(eq, a.to(wide), b.to(wide)).float()


def core_int8_quantize(t, groups: int):
    """The int8 core's q or k: (B, L, nh, hd) float32 quantised with one
    scale per (sequence, head group) over all L rows; returns the int8
    values (as float32) and the scales per head (B, nh)."""
    B, L, nh, hd = t.shape
    tg = t.reshape(B, L, groups, nh // groups * hd)
    s = tg.abs().amax(dim=(1, 3)).clamp_min(1e-6) * (1.0 / 127.0)  # (B, groups)
    t8 = torch.round(tg * (1.0 / s)[:, None, :, None]).clamp(-127, 127)
    return t8.reshape(B, L, nh, hd), s.repeat_interleave(nh // groups, dim=1)


def core_int8_denominator(p):
    """The "av" core's softmax denominator of (B, nh, L, L) p = exp(arg +
    ln 127): max(sum p, 1e-6) over every key, before p is rounded; (B, L, nh,
    1)."""
    return p.sum(dim=-1).clamp_min(1e-6).permute(0, 2, 1)[..., None]


def attention_core_int8_plain(q, k, v, segment_ids, groups: int, core: int):
    """The TPU kernel's int8 attention core (``core`` = CORE_INT8_CODES
    value: 1 "qk", 2 "av", 3 both) on (B, L, nh, hd) q (scaled and rounded),
    k, v in the compute dtype, heads in ``groups`` groups; returns ctx (B, L,
    nh, hd) rounded to v's dtype.

    "qk": q and k quantised with one scale each per (sequence, head group)
    over all L rows (padded ones too); the row max of the int32 scores over
    the allowed keys (-3e38 with none); arg = (s - m) sq sk where allowed,
    -30 elsewhere. "av": p = exp(arg + ln 127), denominator max(sum p, 1e-6)
    over every key, p8 = clip(rint(p), 0, 127), v quantised per column over
    the L rows; ctx = (p8 . v8) s_v (1 / denom). Without "av" the float
    branch: e = exp(arg) in the compute dtype, ctx = (e . v) / sum e."""
    dt = v.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    seg = segment_ids
    allowed = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0))[:, None]  # (B,1,L,L)
    if core & 1:
        (q8, sq), (k8, sk) = core_int8_quantize(qf, groups), core_int8_quantize(kf, groups)
        c = (sq * sk)[:, :, None, None]  # (B, nh, 1, 1)
        s_int = _int_einsum("blnd,bmnd->bnlm", q8, k8)
        m = torch.where(allowed, s_int, -3e38).amax(dim=-1, keepdim=True)
        arg = torch.where(allowed, (s_int - m) * c, -30.0)
    else:
        scores = torch.einsum("blnd,bmnd->bnlm", qf, kf) + torch.where(allowed, 0.0, NEG_INF)
        arg = scores - scores.amax(dim=-1, keepdim=True)
    if core & 2:
        sv = vf.abs().amax(dim=1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)  # (B,1,nh,hd)
        v8 = torch.round(vf * (1.0 / sv)).clamp(-127, 127)
        p = torch.exp(arg + LN127)
        denom = core_int8_denominator(p)
        p8 = torch.round(p).clamp(0, 127)
        ctx = _int_einsum("bnlm,bmnd->blnd", p8, v8) * sv * (1.0 / denom)
    else:
        p = torch.exp(arg.to(dt)).to(dt).float()
        denom = p.sum(dim=-1).permute(0, 2, 1)[..., None]
        ctx = torch.einsum("bnlm,bmnd->blnd", p, vf) / denom
    return ctx.to(dt)


def core_int8_code(core_int8, quantized: bool, multi: bool = False) -> int:
    """The int8 core's mode (CORE_INT8_CODES) of a call: 0 unless
    ``quantized``, and 0 on the TPU's multi-sequence kernel (``multi``),
    which has no int8 core; raises for a value JAX does not name."""
    if not isinstance(core_int8, (bool, str, type(None))) or core_int8 not in CORE_INT8_CODES:
        raise ValueError(f"core_int8={core_int8!r}: False, 'qk', 'av', 'both' or True")
    return CORE_INT8_CODES[core_int8] if quantized and not multi else 0


def _attention_w8a8_plain(hidden, segment_ids, qkv_kernel, qkv_bias, out_kernel, out_bias,
                          sm_scale, ln_scale, ln_bias, eps, groups, core=0):
    dt = hidden.dtype
    B, L, H = hidden.shape
    _, _, nh, hd = qkv_kernel.shape
    HN, G = nh * hd, groups
    wqkv8, swqkv, wo8, swo = quantize_attention_weights(qkv_kernel, out_kernel, G)
    x = hidden.reshape(B * L, H)
    x8, sx = rowquant_plain(x)
    qkv = int8_product(x8, wqkv8) * sx * swqkv + qkv_bias.reshape(-1).float()
    q, k, v = qkv.reshape(B, L, 3, nh, hd).unbind(2)
    q, k, v = (q * sm_scale).to(dt), k.to(dt), v.to(dt)
    if core:
        ctx = attention_core_int8_plain(q, k, v, segment_ids, G, core).reshape(B * L, HN)
    else:
        ctx = attention_core_plain(q, k, v, segment_ids, dt).to(dt).reshape(B * L, HN)
    c8, sc = rowquant_plain(ctx, G)
    W = HN // G
    out = None
    for g in range(G):  # each head group its own int32 product, in the TPU kernel's order
        part = int8_product(c8[:, g * W:(g + 1) * W], wo8[g * W:(g + 1) * W])
        part = part * sc[:, g:g + 1] * swo[g]
        out = part + out_bias.float() if out is None else out + part
    if ln_scale is not None:
        out = _layer_norm(out + x.float(), ln_scale, ln_bias, eps)
    return out.reshape(B, L, H).to(dt)


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
    quantized: bool = False,
    heads_per_block: int = 12,
    core_int8=False,
) -> torch.Tensor:
    """The fused block in plain PyTorch; returns hidden's dtype.

    Float modes: everything in float32, the projections through
    ``float_product`` and the core's two products through
    ``attention_models.core_product``. W8A8: the TPU kernel's integer
    arithmetic and roundings (``heads_per_block`` sets the ctx groups and,
    with ``core_int8``, the q and k scales). Masked keys get an additive
    -1e9, as in the TPU kernel, so a fully padded query row becomes a uniform
    average of v: compare only rows with seg > 0 (with a "qk" core such a row
    is uniform by construction and can be compared too).
    """
    core = core_int8_code(core_int8, quantized)
    if quantized:
        groups = head_groups(qkv_kernel.shape[2], heads_per_block)
        return _attention_w8a8_plain(hidden, segment_ids, qkv_kernel, qkv_bias, out_kernel,
                                     out_bias, sm_scale, ln_scale, ln_bias, eps, groups, core)
    x = hidden.float()
    B, L, H = x.shape
    qkv = float_product(x, qkv_kernel.reshape(H, -1)).reshape(B, L, *qkv_kernel.shape[1:])
    qkv = qkv + qkv_bias.float()
    q, k, v = qkv.unbind(2)  # (B, L, nh, hd)
    scores = am.core_product((q * sm_scale).transpose(1, 2), k.permute(0, 2, 3, 1))
    seg = segment_ids
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    scores = scores + torch.where(allowed, 0.0, NEG_INF)[:, None]
    probs = torch.softmax(scores, dim=-1)
    ctx = am.core_product(probs, v.transpose(1, 2)).transpose(1, 2)
    out = float_product(ctx.reshape(B, L, -1), out_kernel.reshape(-1, H)) + out_bias.float()
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
    heads_per_block: int = 12,
    seqs_per_block: int = 1,
    core_int8=False,
) -> torch.Tensor:
    """Full attention block; returns (B, L, H) in hidden's dtype.

    Float modes: weights rounded to hidden's dtype, biases and LayerNorm
    parameters kept in float32, as the TPU kernel does. ``quantized``: the
    W8A8 mode, the weights quantised from their float32 values.
    ``heads_per_block`` groups the heads as the TPU kernel's grid did, which
    changes the W8A8 result only. ``seqs_per_block`` > 1 is the TPU's tiling
    of the same function over several sequences a grid step
    (``_attn_block_kernel_multi``); it computes what one sequence a step
    computes and runs the same kernel here; as there, it has no int8 core,
    so it ignores ``core_int8`` where the TPU took that kernel (one head
    group, B a multiple of it). ``core_int8`` ("qk", "av", "both", True)
    runs the W8A8 attention core on int8 operands (ignored without
    ``quantized``). ``fused_attention_block.launches`` counts the calls that
    ran the kernels on the card, ``fused_attention_block.core_int8_launches``
    those of them that ran the int8 core.
    """
    if int(seqs_per_block) < 1:
        raise ValueError(f"fused_attention_block: seqs_per_block {seqs_per_block} < 1")
    B, nh = hidden.shape[0], qkv_kernel.shape[2]
    multi = (int(seqs_per_block) > 1 and head_groups(nh, heads_per_block) == 1
             and B % int(seqs_per_block) == 0)
    core = core_int8_code(core_int8, quantized, multi)
    if hidden.device.type == "cpu":
        return attention_block_plain(
            hidden, segment_ids, qkv_kernel, qkv_bias, out_kernel, out_bias,
            sm_scale=sm_scale, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps,
            quantized=quantized, heads_per_block=heads_per_block,
            core_int8=False if multi else core_int8,
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"fused_attention_block: head_dim {hd} not supported {HEAD_DIMS}")
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
    if quantized and H % 4:
        raise ValueError(f"fused_attention_block: W8A8 needs H % 4 == 0, got H = {H}")

    dt = hidden.dtype
    seg = segment_ids.to(torch.int32).contiguous()
    f32 = lambda t: t.to(torch.float32).contiguous()
    bqkv, bo = f32(qkv_bias), f32(out_bias)
    fuse_ln = ln_scale is not None
    lns = f32(ln_scale) if fuse_ln else None
    lnb = f32(ln_bias) if fuse_ln else None
    M, HN = B * L, nh * hd
    qkv_buf = torch.empty((3, B, nh, L, hd), dtype=dt, device=hidden.device)
    ctx_buf = torch.empty((M, HN), dtype=dt, device=hidden.device)
    ln_buf = torch.empty((M, H), dtype=torch.float32, device=hidden.device)
    out = torch.empty_like(hidden)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(hidden.device):
        stream = torch.cuda.current_stream().cuda_stream
        if quantized:
            G = head_groups(nh, heads_per_block)
            wqkv8, swqkv, wo8, swo = quantize_attention_weights(qkv_kernel, out_kernel, G)
            wqkv8, wo8 = kmajor(wqkv8), kmajor(wo8)
            swqkv, swo = swqkv.contiguous(), swo.contiguous()
            x8 = torch.empty((M * max(H, HN),), dtype=torch.int8, device=hidden.device)
            scales = torch.empty((M * G,), dtype=torch.float32, device=hidden.device)
            core_scales = (torch.empty((2 * B * G + B * HN,), dtype=torch.float32,
                                       device=hidden.device) if core else None)
            code = build.library().spk_attention_block_w8a8(
                _DTYPES[dt], ptr(hidden), ptr(seg), ptr(x8), ptr(scales), ptr(wqkv8),
                ptr(swqkv), ptr(bqkv), ptr(wo8), ptr(swo), ptr(bo), ptr(lns), ptr(lnb),
                ptr(qkv_buf), ptr(ctx_buf), ptr(ln_buf), ptr(out), ptr(core_scales), B, L, H,
                nh, hd, G, core, float(sm_scale), float(eps), int(fuse_ln), stream,
            )
        else:
            wqkv = qkv_kernel.to(dt).contiguous()
            wo = out_kernel.to(dt).contiguous()
            code = build.library().spk_attention_block(
                _DTYPES[dt], ptr(hidden), ptr(seg), ptr(wqkv), ptr(bqkv), ptr(wo), ptr(bo),
                ptr(lns), ptr(lnb), ptr(qkv_buf), ptr(ctx_buf), ptr(ln_buf), ptr(out),
                B, L, H, nh, hd, float(sm_scale), float(eps), int(fuse_ln), stream,
            )
    build.check(code, "fused_attention_block")
    fused_attention_block.launches += 1
    fused_attention_block.core_int8_launches += bool(core)
    return out


fused_attention_block.launches = 0
fused_attention_block.core_int8_launches = 0


def attention_core(qkv_buf: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """The attention core alone, as ``fused_attention_block`` launches it
    between its projections (float modes, and W8A8 without ``core_int8``):
    qkv_buf (3, B, nh, L, hd) float32 or bfloat16 as the QKV projection
    leaves it, q already scaled; the exponent taken in qkv_buf's type.
    Returns ctx (B, L, nh * hd) in that type. No model path calls it: it
    times the block's core at the block's own launch.
    ``attention_core.launches`` counts the calls that ran the kernel on the
    card. On a CPU tensor it runs ``attention_core_plain``."""
    if qkv_buf.dim() != 5 or qkv_buf.shape[0] != 3:
        raise ValueError(f"attention_core: qkv_buf must be (3, B, nh, L, hd), got {tuple(qkv_buf.shape)}")
    _, B, nh, L, hd = qkv_buf.shape
    if qkv_buf.device.type == "cpu":
        q, k, v = (t.transpose(1, 2) for t in qkv_buf.unbind(0))
        ctx = attention_core_plain(q, k, v, segment_ids, qkv_buf.dtype)
        return ctx.reshape(B, L, nh * hd).to(qkv_buf.dtype)
    if qkv_buf.device.type != "cuda":
        raise ValueError(f"attention_core: unsupported device {qkv_buf.device}")
    if qkv_buf.dtype not in _DTYPES:
        raise TypeError(f"attention_core: qkv_buf must be float32 or bfloat16, got {qkv_buf.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention_core: head_dim {hd} not supported {HEAD_DIMS}")
    if tuple(segment_ids.shape) != (B, L) or segment_ids.device != qkv_buf.device:
        raise ValueError(f"attention_core: segment_ids must be ({B}, {L}) on {qkv_buf.device}")
    if segment_ids.dtype.is_floating_point:
        raise TypeError("attention_core: segment_ids must be integers")
    x = qkv_buf.contiguous()
    if x.data_ptr() % 16:  # the bf16 core copies 16 bytes at a time
        x = x.clone()
    seg = segment_ids.to(torch.int32).contiguous()
    ctx = torch.empty((B, L, nh * hd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = build.library().spk_attention_core(
            _DTYPES[x.dtype], x.data_ptr(), seg.data_ptr(), ctx.data_ptr(), B, L, nh, hd,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "attention_core")
    attention_core.launches += 1
    return ctx


attention_core.launches = 0
