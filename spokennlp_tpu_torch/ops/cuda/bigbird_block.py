"""Fused BigBird attention block: QKV projection, ITC block-sparse attention
(window, global and random key blocks under one softmax; global rows dense
over every real key), output projection, residual and LayerNorm.

Counterpart of ``spokennlp_tpu/ops/pallas/bigbird_block_kernel.py``. On a
CUDA tensor ``fused_bigbird_attention_block`` runs the hand-written kernels
of ``csrc/bigbird_block.cu``; on a CPU tensor it runs ``bigbird_block_plain``,
the same function in float32 PyTorch on the block-sparse formulation (nothing
of size (L, L)), which the tests hold against the JAX kernel and the kernel is
held against on the card.

Contract, as on the TPU: padding is a suffix of each row; L is a multiple of
the block size and the block size of 8. The random blocks come from
``ops/bigbird_attention.py:bigbird_block_indices`` at ``seed``: the same
pattern as the gather and bias paths.

``quantized=True`` is the TPU kernel's W8A8 mode: the QKV and output
projections run int8 x int8 -> int32, weights quantised per output column
(once a call, in the wrapper), x quantised per row, and the float32 ctx
quantised per row. Its plain version follows the TPU kernel's roundings: q,
k, v rounded to the element type, the exponent taken in it.
"""

from __future__ import annotations

from typing import Optional

import torch

from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables, random_tail
from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.attention_block import (
    _DTYPES, NEG_INF, _layer_norm, quantize_attention_weights,
)
from spokennlp_tpu_torch.ops.cuda.int8_matmul import (
    float_product, int8_product, kmajor, rowquant_plain,
)
from spokennlp_tpu_torch.ops.cuda.sliding_block import _divide, _softmax
from spokennlp_tpu_torch.ops.cuda.train_blocks import HEAD_DIMS
from spokennlp_tpu_torch.ops.sliding_attention import _ctx_windows


def check_contract(L: int, block_size: int, where: str) -> None:
    """Raise unless the kernels' shape contract holds: L % block_size == 0
    and block_size % 8 == 0."""
    if block_size <= 0 or L % block_size or block_size % 8:
        raise ValueError(f"{where}: the BigBird kernels need L % block_size == 0 and "
                         f"block_size % 8 == 0; got L={L}, block_size={block_size}")


def bigbird_attend(q, k, v, attention_mask, *, block_size: int, num_global_blocks: int,
                   num_random_blocks: int, seed: int, exp_dtype=None, dropout_rate: float = 0.0,
                   keep=None) -> torch.Tensor:
    """The attention context (B, L, nh, hd) float32 of the kernels' semantics
    from projected (B, L, nh, hd) q (scaled), k, v, piece by piece as the
    kernels take them. ``exp_dtype``: the TPU kernels' rounded exponent
    (``sliding_block._softmax``). ``keep`` as in ``bigbird_context_plain``."""
    q, k, v = q.float(), k.float(), v.float()
    B, L, nh, hd = q.shape
    C = block_size
    nb = L // C
    G, R, rand, rok = random_tail(nb, num_global_blocks, num_random_blocks, seed)
    GC, dev = G * C, q.device
    n_valid = (attention_mask > 0).sum(1)
    real = lambda keys: keys[None] < n_valid.reshape(-1, *[1] * keys.dim())  # (B, *keys.shape)
    qc = q.reshape(B, nb, C, nh, hd)

    # window blocks i - 1, i, i + 1 without the global blocks; then the
    # global columns; then the random blocks: (scores, values, keys allowed)
    key_w = torch.arange(nb, device=dev)[:, None] * C - C + torch.arange(3 * C, device=dev)[None]
    pieces = [(_ctx_windows(k, C), _ctx_windows(v, C), real(key_w) & (key_w >= GC)[None])]
    if GC:
        ok = real(torch.arange(GC, device=dev))[:, None].expand(B, nb, GC)
        pieces.append((k[:, None, :GC].expand(B, nb, GC, nh, hd),
                       v[:, None, :GC].expand(B, nb, GC, nh, hd), ok))
    if R:
        blocks = torch.from_numpy(rand).long().to(dev)
        keys_r = (blocks[:, :, None] * C + torch.arange(C, device=dev)).reshape(nb, R * C)
        live = torch.from_numpy(rok).bool().to(dev).repeat_interleave(C, dim=1)
        gather = lambda t: t[:, keys_r.reshape(-1)].reshape(B, nb, R * C, nh, hd)
        pieces.append((gather(k), gather(v), real(keys_r) & live[None]))
    scores = torch.cat([
        torch.where(ok[:, None, :, None, :], torch.einsum("bicnd,bijnd->bnicj", qc, kp), NEG_INF)
        for kp, _, ok in pieces], dim=-1)  # (B, nh, nb, C, K C)
    probs, denom = _softmax(scores, exp_dtype)
    probs = probs.split([kp.shape[2] for kp, _, _ in pieces], dim=-1)
    if dropout_rate > 0.0:
        win, gcol, rnd, _ = keep
        masks = [win, gcol.reshape(B, nh, nb, C, GC), rnd.reshape(B, nh, nb, C, R * C)]
        masks = [m for m, n in zip(masks, (1, GC, R)) if n]
        scale = 1.0 / (1.0 - dropout_rate)
        probs = [torch.where(m, p * scale, 0.0) for m, p in zip(masks, probs)]
    ctx = sum(torch.einsum("bnicj,bijnd->bicnd", p, vp) for p, (_, vp, _) in zip(probs, pieces))
    ctx = _divide(ctx, denom, (0, 2, 3, 1, 4)).reshape(B, L, nh, hd)
    if not GC:
        return ctx

    # the global rows: dense over every real key
    s = torch.einsum("bgnd,blnd->bngl", q[:, :GC], k)
    p, denom = _softmax(torch.where(real(torch.arange(L, device=dev))[:, None, None], s,
                                    NEG_INF), exp_dtype)
    if dropout_rate > 0.0:
        p = torch.where(keep[3], p / (1.0 - dropout_rate), 0.0)
    cg = _divide(torch.einsum("bngl,blnd->bgnd", p, v), denom, (0, 2, 1, 3))
    return torch.cat([cg, ctx[:, GC:]], dim=1)


def bigbird_context_plain(
    hidden: torch.Tensor,
    attention_mask: torch.Tensor,
    qkv_kernel: torch.Tensor,
    qkv_bias: torch.Tensor,
    *,
    sm_scale: float,
    block_size: int,
    num_global_blocks: int,
    num_random_blocks: int,
    seed: int,
    dropout_rate: float = 0.0,
    keep=None,
) -> torch.Tensor:
    """The attention context (B, L, nh, hd) of the kernels' semantics in
    float32, piece by piece as the kernels take them.

    ``keep`` = (window (B, nh, nb, C, 3C), global columns (B, nh, L, G C),
    random (B, nh, L, R C), global rows (B, nh, G C, L)) bool masks, needed
    when ``dropout_rate`` > 0 (``ops/cuda/train_bigbird.py
    bigbird_keep_masks``): kept probabilities are scaled by 1 / (1 - rate).
    Disallowed scores are replaced by -1e9, as in the TPU kernels, so a row
    with no allowed key (none without a real token) averages its pieces:
    compare real rows only.
    """
    B, L, H = hidden.shape
    qkv = float_product(hidden, qkv_kernel.reshape(H, -1)).reshape(B, L, *qkv_kernel.shape[1:])
    q, k, v = (qkv + qkv_bias.float()).unbind(2)  # (B, L, nh, hd)
    return bigbird_attend(q * sm_scale, k, v, attention_mask, block_size=block_size,
                          num_global_blocks=num_global_blocks,
                          num_random_blocks=num_random_blocks, seed=seed,
                          dropout_rate=dropout_rate, keep=keep)


def _bigbird_block_w8a8_plain(hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel, out_bias,
                              pattern, sm_scale, ln_scale, ln_bias, eps):
    dt = hidden.dtype
    B, L, H = hidden.shape
    nh, hd = qkv_kernel.shape[2], qkv_kernel.shape[3]
    wqkv8, swqkv, wo8, swo = quantize_attention_weights(qkv_kernel.float(), out_kernel.float(), 1)
    x = hidden.reshape(B * L, H)
    x8, sx = rowquant_plain(x)
    qkv = int8_product(x8, wqkv8) * sx * swqkv + qkv_bias.reshape(-1).float()
    q, k, v = qkv.reshape(B, L, 3, nh, hd).unbind(2)
    ctx = bigbird_attend((q * sm_scale).to(dt), k.to(dt), v.to(dt), attention_mask, **pattern,
                         exp_dtype=dt)
    c8, sc = rowquant_plain(ctx.reshape(B * L, nh * hd))
    out = int8_product(c8, wo8) * sc * swo + out_bias.float()
    if ln_scale is not None:
        out = _layer_norm(out + x.float(), ln_scale, ln_bias, eps)
    return out.reshape(B, L, H).to(dt)


def bigbird_block_plain(
    hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel, out_bias, block_size: int,
    num_global_blocks: int, num_random_blocks: int, seed: int, sm_scale: float,
    ln_scale: Optional[torch.Tensor] = None, ln_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-12, quantized: bool = False,
) -> torch.Tensor:
    """The fused block in plain PyTorch; returns hidden's dtype. Float
    modes in float32; W8A8 (``quantized``) with the TPU kernel's integer
    arithmetic and roundings."""
    if quantized:
        pattern = dict(block_size=block_size, num_global_blocks=num_global_blocks,
                       num_random_blocks=num_random_blocks, seed=seed)
        return _bigbird_block_w8a8_plain(hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel,
                                         out_bias, pattern, sm_scale, ln_scale, ln_bias, eps)
    ctx = bigbird_context_plain(
        hidden, attention_mask, qkv_kernel, qkv_bias, sm_scale=sm_scale, block_size=block_size,
        num_global_blocks=num_global_blocks, num_random_blocks=num_random_blocks, seed=seed,
    )
    B, L = ctx.shape[:2]
    out = float_product(ctx.reshape(B, L, -1), out_kernel.reshape(-1, out_kernel.shape[-1]))
    out = out + out_bias.float()
    if ln_scale is not None:
        out = _layer_norm(out + hidden.float(), ln_scale, ln_bias, eps)
    return out.to(hidden.dtype)


def card_weights(qkv_kernel, qkv_bias, out_kernel, dt):
    """The weights as the kernels read them: wqkv (H, 3 Hn) and wo (Hn, H) in
    the compute dtype, bqkv (3 Hn,) float32."""
    H, _, nh, hd = qkv_kernel.shape
    HN = nh * hd
    return dict(wqkv=qkv_kernel.detach().to(dt).reshape(H, 3 * HN).contiguous(),
                bqkv=qkv_bias.detach().float().reshape(-1).contiguous(),
                wo=out_kernel.detach().to(dt).reshape(HN, H).contiguous())


def check_card_inputs(where, hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel, out_bias,
                      block_size):
    """Raise unless the tensors fit the kernels: a (B, L, H) float32 or
    bfloat16 hidden on the card, the weights' shapes, the shape contract."""
    if hidden.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {hidden.device}")
    if hidden.dtype not in _DTYPES:
        raise TypeError(f"{where}: hidden must be float32 or bfloat16, got {hidden.dtype}")
    if hidden.dim() != 3:
        raise ValueError(f"{where}: hidden must be (B, L, H), got {tuple(hidden.shape)}")
    B, L, H = hidden.shape
    if qkv_kernel.dim() != 4 or qkv_kernel.shape[:2] != (H, 3):
        raise ValueError(f"{where}: qkv_kernel must be (H, 3, nh, hd), got {tuple(qkv_kernel.shape)}")
    nh, hd = qkv_kernel.shape[2], qkv_kernel.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{where}: head_dim {hd} not supported {HEAD_DIMS}")
    check_contract(L, block_size, where)
    for name, t, shape in (("attention_mask", attention_mask, (B, L)),
                           ("qkv_bias", qkv_bias, (3, nh, hd)),
                           ("out_kernel", out_kernel, (nh, hd, H)), ("out_bias", out_bias, (H,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{where}: {name} must be {shape}, got {tuple(t.shape)}")
        if t.device != hidden.device:
            raise ValueError(f"{where}: {name} is on {t.device}, hidden on {hidden.device}")


def fused_bigbird_attention_block(
    hidden: torch.Tensor,  # (B, L, H) float32 or bfloat16
    attention_mask: torch.Tensor,  # (B, L) int, 1 = real token (suffix padding)
    qkv_kernel: torch.Tensor,  # (H, 3, nh, hd)
    qkv_bias: torch.Tensor,  # (3, nh, hd)
    out_kernel: torch.Tensor,  # (nh, hd, H)
    out_bias: torch.Tensor,  # (H,)
    block_size: int,
    num_global_blocks: int,
    num_random_blocks: int,
    seed: int,
    sm_scale: float,
    quantized: bool = False,
    ln_scale: Optional[torch.Tensor] = None,  # (H,): out = LN(hidden + attn)
    ln_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
) -> torch.Tensor:
    """BigBird ITC attention block; returns (B, L, H) in hidden's dtype
    (post-LN with ``ln_scale``).

    Weights are rounded to hidden's dtype and biases and LayerNorm parameters
    kept in float32, as the TPU kernel does; ``quantized``: the W8A8 mode,
    the weights quantised from their float32 values. A CUDA tensor that
    breaks the contract raises. ``fused_bigbird_attention_block.launches``
    counts the calls that ran the kernels on the card.
    """
    where = "fused_bigbird_attention_block"
    pattern = dict(block_size=block_size, num_global_blocks=num_global_blocks,
                   num_random_blocks=num_random_blocks, seed=seed, sm_scale=sm_scale)
    if hidden.device.type == "cpu":
        return bigbird_block_plain(hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel,
                                   out_bias, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps,
                                   quantized=quantized, **pattern)
    check_card_inputs(where, hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel, out_bias,
                      block_size)
    B, L, H = hidden.shape
    nh, hd = qkv_kernel.shape[2], qkv_kernel.shape[3]
    HN = nh * hd
    if quantized and H % 4:
        raise ValueError(f"{where}: W8A8 needs H % 4 == 0, got H = {H}")
    dt, dev = hidden.dtype, hidden.device
    tables = bigbird_tables(L // block_size, num_global_blocks, num_random_blocks, seed, dev)
    f32 = lambda t: t.float().contiguous()
    fuse_ln = ln_scale is not None
    lns, lnb = (f32(ln_scale), f32(ln_bias)) if fuse_ln else (None, None)
    bo = f32(out_bias)
    hidden = hidden.contiguous()
    mask = attention_mask.to(torch.int32).contiguous()
    empty = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    counts = empty(B, 2, dtype=torch.int32)
    qkv_buf = empty(3, B, nh, L, hd)
    ln_buf, out = empty(B * L, H, dtype=torch.float32), torch.empty_like(hidden)
    ptr = lambda t: None if t is None else t.data_ptr()
    shape = (B, L, H, nh, hd, block_size, tables.G, tables.R, float(sm_scale), float(eps),
             int(fuse_ln))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if quantized:
            wqkv8, swqkv, wo8, swo = quantize_attention_weights(
                qkv_kernel.detach().float(), out_kernel.detach().float(), 1)
            wqkv8, wo8 = kmajor(wqkv8), kmajor(wo8)
            swqkv, swo = swqkv.contiguous(), swo.contiguous()
            x8 = empty(B * L * max(H, HN), dtype=torch.int8)
            scales, ctx_buf = empty(B * L, dtype=torch.float32), empty(B * L, HN,
                                                                         dtype=torch.float32)
            code = build.library().spk_bigbird_block_w8a8(
                _DTYPES[dt], *(ptr(t) for t in (hidden, mask, tables.rand, tables.rok, x8, scales,
                                                 wqkv8, swqkv, f32(qkv_bias), wo8, swo, bo, lns,
                                                 lnb, counts, qkv_buf, ctx_buf, ln_buf, out)),
                *shape, stream,
            )
        else:
            w = card_weights(qkv_kernel, qkv_bias, out_kernel, dt)
            ctx_buf = empty(B, L, HN)
            code = build.library().spk_bigbird_block(
                _DTYPES[dt], *(ptr(t) for t in (hidden, mask, tables.rand, tables.rok, w["wqkv"],
                                                 w["bqkv"], w["wo"], bo, lns, lnb, counts,
                                                 qkv_buf, ctx_buf, ln_buf, out)),
                *shape, stream,
            )
    build.check(code, where)
    fused_bigbird_attention_block.launches += 1
    return out


fused_bigbird_attention_block.launches = 0
