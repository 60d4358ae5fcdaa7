"""Fused Longformer attention block: local and global QKV projections,
sliding-window attention with global columns, global rows through the
``*_global`` projections, output projection, residual and LayerNorm.

Counterpart of ``spokennlp_tpu/ops/pallas/sliding_block.py``. On a CUDA
tensor ``fused_sliding_attention_block`` runs the hand-written kernels of
``csrc/sliding_block.cu``; on a CPU tensor it runs ``sliding_block_plain``,
the same function in float32 PyTorch on the chunked formulation, which the
tests hold against the JAX kernel and the kernel is held against on the card.

``quantized=True`` is the TPU kernel's W8A8 mode: the local q, k, v, the
global k, v and query and the output projection run int8 x int8 -> int32,
weights quantised per output column (once a call, in the wrapper), x
quantised per row once for all of them, and the float32 ctx quantised per
row. Its plain version follows the TPU kernel's roundings: q, k, v, qg, kg,
vg rounded to the element type, the exponent taken in it.

Contract, as on the TPU: padding is a suffix of each row and the global
tokens are a prefix of at most ``max_globals`` positions (the topic
segmentation model marks CLS only); L is a multiple of C = window // 2 and C
of 8. Row r attends to keys j with |j - r| <= C that are real and not global,
and to the global columns (the local k and v of the first G positions), with
one softmax over both; rows r < n_glob are replaced by full attention through
the global projections.
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
from spokennlp_tpu_torch.ops.cuda.train_blocks import HEAD_DIMS
from spokennlp_tpu_torch.ops.sliding_attention import _ctx_windows

MAX_GLOBAL_COLUMNS = 64  # G, the global-column block the kernels hold in one tile


def global_columns(max_globals: int, L: int) -> int:
    """G, the width of the global-column block: at least 8, at most L (as the
    TPU kernels size it)."""
    return min(max(int(max_globals), 8), L)


def check_contract(L: int, window: int, max_globals: int, where: str) -> None:
    """Raise unless the kernels' shape contract holds: L % C == 0, C % 8 == 0
    and G <= 64, with C = window // 2."""
    C = window // 2
    if C <= 0 or L % C or C % 8:
        raise ValueError(f"{where}: the sliding-window kernels need L % (window // 2) == 0 and "
                         f"(window // 2) % 8 == 0; got L={L}, window={window}")
    if global_columns(max_globals, L) > MAX_GLOBAL_COLUMNS:
        raise ValueError(f"{where}: max_globals {max_globals} above {MAX_GLOBAL_COLUMNS}")


def _softmax(scores: torch.Tensor, exp_dtype):
    """(weights, denominator) of a softmax over the last axis: in float32
    (``exp_dtype`` None) the probabilities and 1; else as the TPU kernels
    take it, e = exp(s - max) with s - max and e rounded to ``exp_dtype``,
    and the float32 sum of e, which the kernels divide by after the
    product with v."""
    if exp_dtype is None:
        return torch.softmax(scores, dim=-1), None
    e = torch.exp((scores - scores.amax(dim=-1, keepdim=True)).to(exp_dtype)).to(exp_dtype)
    e = e.float()
    return e, e.sum(dim=-1, keepdim=True)


def _divide(ctx: torch.Tensor, denom, order) -> torch.Tensor:
    """ctx / denom with denom's axes permuted by ``order`` (no-op for None)."""
    return ctx if denom is None else ctx / denom.permute(*order)


def sliding_attend(q, k, v, glob_qkv, n_valid, n_glob, *, window: int, G: int, exp_dtype=None,
                   dropout_rate: float = 0.0, keep=None) -> torch.Tensor:
    """The attention context (B, L, nh, hd) float32 of the kernels' semantics
    from projected (B, L, nh, hd) q (scaled), k, v and, for the global rows,
    ``glob_qkv`` = (qg (B, G, nh, hd) scaled, kg, vg (B, L, nh, hd)) or
    None; ``n_valid``, ``n_glob`` (B,) counts. ``exp_dtype``: the TPU
    kernels' rounded exponent (``_softmax``). ``keep`` as in
    ``sliding_context_plain``."""
    q, k, v = q.float(), k.float(), v.float()
    B, L, nh, hd = q.shape
    C = window // 2
    nc, dev = L // C, q.device
    row = (torch.arange(nc, device=dev)[:, None] * C + torch.arange(C, device=dev)[None])
    key = row[:, :1] - C + torch.arange(3 * C, device=dev)[None]  # (nc, 3C)
    in_band = (key[:, None, :] - row[:, :, None]).abs() <= C  # (nc, C, 3C)
    key_ok = (key[None] >= n_glob[:, None, None]) & (key[None] < n_valid[:, None, None])
    allowed = in_band[None] & key_ok[:, :, None, :]  # (B, nc, C, 3C)
    q_chunks = q.reshape(B, nc, C, nh, hd)
    scores = torch.einsum("bicnd,bijnd->bnicj", q_chunks, _ctx_windows(k, C))
    scores = torch.where(allowed[:, None], scores, NEG_INF)
    g_ok = torch.arange(G, device=dev)[None] < n_glob[:, None]  # (B, G)
    g_scores = torch.einsum("bicnd,bgnd->bnicg", q_chunks, k[:, :G])
    g_scores = torch.where(g_ok[:, None, None, None], g_scores, NEG_INF)
    probs, denom = _softmax(torch.cat([scores, g_scores], dim=-1), exp_dtype)
    p_band, p_g = probs[..., : 3 * C], probs[..., 3 * C:]
    if dropout_rate > 0.0:
        band_keep, gcol_keep, grow_keep = keep
        scale = 1.0 / (1.0 - dropout_rate)
        p_band = torch.where(band_keep, p_band * scale, 0.0)
        p_g = torch.where(gcol_keep.reshape(B, nh, nc, C, G), p_g * scale, 0.0)
    ctx = (torch.einsum("bnicj,bijnd->bicnd", p_band, _ctx_windows(v, C))
           + torch.einsum("bnicg,bgnd->bicnd", p_g, v[:, :G]))
    ctx = _divide(ctx, denom, (0, 2, 3, 1, 4)).reshape(B, L, nh, hd)
    if glob_qkv is None:
        return ctx

    qg, kg, vg = (t.float() for t in glob_qkv)
    key_real = torch.arange(L, device=dev)[None] < n_valid[:, None]  # (B, L)
    s = torch.einsum("bgnd,blnd->bngl", qg, kg)
    p, denom = _softmax(torch.where(key_real[:, None, None], s, NEG_INF), exp_dtype)
    if dropout_rate > 0.0:
        p = torch.where(keep[2], p / (1.0 - dropout_rate), 0.0)
    cg = _divide(torch.einsum("bngl,blnd->bgnd", p, vg), denom, (0, 2, 1, 3))
    is_global = (torch.arange(G, device=dev)[None] < n_glob[:, None])[:, :, None, None]
    return torch.cat([torch.where(is_global, cg, ctx[:, :G]), ctx[:, G:]], dim=1)


def _counts(attention_mask, global_mask, G: int, global_rows: bool):
    """(n_valid, n_glob) (B,): real tokens, global tokens capped at G (0
    without global rows)."""
    n_valid = (attention_mask > 0).sum(1)
    n_glob = (global_mask > 0).sum(1).clamp(max=G) if global_rows else torch.zeros_like(n_valid)
    return n_valid, n_glob


def sliding_context_plain(
    hidden: torch.Tensor,
    attention_mask: torch.Tensor,
    global_mask: torch.Tensor,
    qkv_kernel: torch.Tensor,
    qkv_bias: torch.Tensor,
    gqkv_kernel: torch.Tensor,
    gqkv_bias: torch.Tensor,
    *,
    sm_scale: float,
    window: int,
    max_globals: int = 16,
    global_rows: bool = True,
    dropout_rate: float = 0.0,
    keep=None,
) -> torch.Tensor:
    """The attention context (B, L, nh, hd) of the kernels' semantics in
    float32, on the chunked formulation (nothing of size (L, L)).

    ``keep`` = (band (B, nh, L / C, C, 3C), global columns (B, nh, L, G),
    global rows (B, nh, G, L)) bool masks, needed when ``dropout_rate`` > 0:
    kept probabilities are scaled by 1 / (1 - rate). Disallowed scores are
    replaced by -1e9, as in the TPU kernels, so a row with no allowed key
    (a padding row far from any real token) averages its window: compare
    real rows only.
    """
    B, L, H = hidden.shape
    G = global_columns(max_globals, L)
    x = hidden.float()
    qkv = float_product(x, qkv_kernel.reshape(H, -1)).reshape(B, L, *qkv_kernel.shape[1:])
    q, k, v = (qkv + qkv_bias.float()).unbind(2)  # (B, L, nh, hd)
    glob_qkv = None
    if global_rows:
        # the global k and v are the kernels' projection GEMM (float_product);
        # the global query is summed inside the global-rows kernel, not on it
        wg, bg = gqkv_kernel.float(), gqkv_bias.float()
        kv = float_product(x, wg[:, 1:].reshape(H, -1)).reshape(B, L, 2, *wg.shape[2:]) + bg[1:]
        glob_qkv = ((torch.einsum("bgh,hnd->bgnd", x[:, :G], wg[:, 0]) + bg[0]) * sm_scale,
                    kv[:, :, 0], kv[:, :, 1])
    return sliding_attend(q * sm_scale, k, v, glob_qkv,
                          *_counts(attention_mask, global_mask, G, global_rows), window=window,
                          G=G, dropout_rate=dropout_rate, keep=keep)


def quantize_sliding_weights(qkv_kernel, gqkv_kernel, out_kernel) -> dict:
    """The int8 weights of the W8A8 mode with their per-column scales, as
    the TPU kernel prepares them (amax / 127, rounding half to even): wqkv8
    (H, 3 Hn), wgq8 (H, Hn), wgkv8 (H, 2 Hn), wo8 (Hn, H) and swqkv, swgq,
    swgkv, swo."""
    H, _, nh, hd = qkv_kernel.shape
    HN = nh * hd
    f = lambda t: t.detach().float()
    wqkv8, swqkv = quantize_colwise(f(qkv_kernel).reshape(H, 3 * HN))
    wg8, swg = quantize_colwise(f(gqkv_kernel).reshape(H, 3 * HN))
    wo8, swo = quantize_colwise(f(out_kernel).reshape(HN, H))
    c = lambda t: t.contiguous()
    return dict(wqkv8=c(wqkv8), swqkv=c(swqkv.reshape(-1)), wgq8=c(wg8[:, :HN]),
                swgq=c(swg.reshape(-1)[:HN]), wgkv8=c(wg8[:, HN:]), swgkv=c(swg.reshape(-1)[HN:]),
                wo8=c(wo8), swo=c(swo.reshape(-1)))


def _sliding_block_w8a8_plain(hidden, attention_mask, global_mask, qkv_kernel, qkv_bias,
                              gqkv_kernel, gqkv_bias, out_kernel, out_bias, *, sm_scale, window,
                              max_globals, ln_scale, ln_bias, eps, global_rows):
    dt = hidden.dtype
    B, L, H = hidden.shape
    nh, hd = qkv_kernel.shape[2], qkv_kernel.shape[3]
    G = global_columns(max_globals, L)
    w = quantize_sliding_weights(qkv_kernel, gqkv_kernel, out_kernel)
    x = hidden.reshape(B * L, H)
    x8, sx = rowquant_plain(x)
    proj = lambda x8_, sx_, w8, sw, b: int8_product(x8_, w8) * sx_ * sw + b.reshape(-1).float()
    q, k, v = proj(x8, sx, w["wqkv8"], w["swqkv"], qkv_bias).reshape(B, L, 3, nh, hd).unbind(2)
    q, k, v = (q * sm_scale).to(dt), k.to(dt), v.to(dt)
    glob_qkv = None
    if global_rows:
        xg8, sxg = x8.reshape(B, L, H)[:, :G].reshape(-1, H), sx.reshape(B, L, 1)[:, :G]
        qg = proj(xg8, sxg.reshape(-1, 1), w["wgq8"], w["swgq"], gqkv_bias[0])
        kvg = proj(x8, sx, w["wgkv8"], w["swgkv"], gqkv_bias[1:]).reshape(B, L, 2, nh, hd)
        glob_qkv = ((qg.reshape(B, G, nh, hd) * sm_scale).to(dt), kvg[:, :, 0].to(dt),
                    kvg[:, :, 1].to(dt))
    ctx = sliding_attend(q, k, v, glob_qkv, *_counts(attention_mask, global_mask, G, global_rows),
                         window=window, G=G, exp_dtype=dt)
    c8, sc = rowquant_plain(ctx.reshape(B * L, nh * hd))
    out = int8_product(c8, w["wo8"]) * sc * w["swo"] + out_bias.float()
    if ln_scale is not None:
        out = _layer_norm(out + x.float(), ln_scale, ln_bias, eps)
    return out.reshape(B, L, H).to(dt)


def sliding_block_plain(
    hidden, attention_mask, global_mask, qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias,
    out_kernel, out_bias, *, sm_scale: float, window: int, max_globals: int = 16,
    ln_scale: Optional[torch.Tensor] = None, ln_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-12, global_rows: bool = True, quantized: bool = False,
) -> torch.Tensor:
    """The fused block in plain PyTorch; returns hidden's dtype. Float
    modes in float32; W8A8 (``quantized``) with the TPU kernel's integer
    arithmetic and roundings."""
    if quantized:
        return _sliding_block_w8a8_plain(
            hidden, attention_mask, global_mask, qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias,
            out_kernel, out_bias, sm_scale=sm_scale, window=window, max_globals=max_globals,
            ln_scale=ln_scale, ln_bias=ln_bias, eps=eps, global_rows=global_rows)
    ctx = sliding_context_plain(
        hidden, attention_mask, global_mask, qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias,
        sm_scale=sm_scale, window=window, max_globals=max_globals, global_rows=global_rows,
    )
    B, L = ctx.shape[:2]
    out = float_product(ctx.reshape(B, L, -1), out_kernel.reshape(-1, out_kernel.shape[-1]))
    out = out + out_bias.float()
    if ln_scale is not None:
        out = _layer_norm(out + hidden.float(), ln_scale, ln_bias, eps)
    return out.to(hidden.dtype)


def card_weights(qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias, out_kernel, dt):
    """The weights as the kernels read them: wqkv (H, 3 Hn), wgq (H, Hn) and
    wgkv (H, 2 Hn), wo (Hn, H) in the compute dtype, biases float32."""
    H, _, nh, hd = qkv_kernel.shape
    HN = nh * hd
    f32 = lambda t: t.detach().float().reshape(-1).contiguous()
    wg = gqkv_kernel.detach().to(dt)
    return dict(
        wqkv=qkv_kernel.detach().to(dt).reshape(H, 3 * HN).contiguous(), bqkv=f32(qkv_bias),
        wgq=wg[:, 0].reshape(H, HN).contiguous(), bgq=f32(gqkv_bias[0]),
        wgkv=wg[:, 1:].reshape(H, 2 * HN).contiguous(), bgkv=f32(gqkv_bias[1:]),
        wo=out_kernel.detach().to(dt).reshape(HN, H).contiguous(),
    )


def check_card_inputs(where, hidden, attention_mask, global_mask, qkv_kernel, qkv_bias,
                      gqkv_kernel, gqkv_bias, out_kernel, out_bias, window, max_globals):
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
    check_contract(L, window, max_globals, where)
    for name, t, shape in (("attention_mask", attention_mask, (B, L)),
                           ("global_mask", global_mask, (B, L)),
                           ("qkv_bias", qkv_bias, (3, nh, hd)),
                           ("gqkv_kernel", gqkv_kernel, (H, 3, nh, hd)),
                           ("gqkv_bias", gqkv_bias, (3, nh, hd)),
                           ("out_kernel", out_kernel, (nh, hd, H)), ("out_bias", out_bias, (H,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{where}: {name} must be {shape}, got {tuple(t.shape)}")
        if t.device != hidden.device:
            raise ValueError(f"{where}: {name} is on {t.device}, hidden on {hidden.device}")


def fused_sliding_attention_block(
    hidden: torch.Tensor,  # (B, L, H) float32 or bfloat16
    attention_mask: torch.Tensor,  # (B, L) int, 1 = real token (suffix padding)
    global_mask: torch.Tensor,  # (B, L) int, 1 = global (a prefix)
    qkv_kernel: torch.Tensor,  # (H, 3, nh, hd)
    qkv_bias: torch.Tensor,  # (3, nh, hd)
    gqkv_kernel: torch.Tensor,  # (H, 3, nh, hd): the global projections
    gqkv_bias: torch.Tensor,
    out_kernel: torch.Tensor,  # (nh, hd, H)
    out_bias: torch.Tensor,  # (H,)
    *,
    sm_scale: float,
    window: int,
    max_globals: int = 16,
    ln_scale: Optional[torch.Tensor] = None,  # (H,): out = LN(hidden + attn)
    ln_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
    global_rows: bool = True,  # False: the caller promises no global tokens
    quantized: bool = False,
) -> torch.Tensor:
    """Longformer attention block; returns (B, L, H) in hidden's dtype.

    Weights are rounded to hidden's dtype and biases and LayerNorm parameters
    kept in float32, as the TPU kernel does; ``quantized``: the W8A8 mode,
    the weights quantised from their float32 values (``quantize_sliding_
    weights``). A CUDA tensor that breaks the contract raises.
    ``fused_sliding_attention_block.launches`` counts the calls that ran the
    kernels on the card.
    """
    kw = dict(sm_scale=sm_scale, window=window, max_globals=max_globals, global_rows=global_rows)
    if hidden.device.type == "cpu":
        return sliding_block_plain(hidden, attention_mask, global_mask, qkv_kernel, qkv_bias,
                                   gqkv_kernel, gqkv_bias, out_kernel, out_bias, ln_scale=ln_scale,
                                   ln_bias=ln_bias, eps=eps, quantized=quantized, **kw)
    where = "fused_sliding_attention_block"
    check_card_inputs(where, hidden, attention_mask, global_mask, qkv_kernel, qkv_bias,
                      gqkv_kernel, gqkv_bias, out_kernel, out_bias, window, max_globals)
    B, L, H = hidden.shape
    nh, hd = qkv_kernel.shape[2], qkv_kernel.shape[3]
    HN = nh * hd
    if quantized and H % 4:
        raise ValueError(f"{where}: W8A8 needs H % 4 == 0, got H = {H}")
    dt, dev = hidden.dtype, hidden.device
    G = global_columns(max_globals, L)
    f32 = lambda t: t.float().contiguous()
    fuse_ln = ln_scale is not None
    lns, lnb = (f32(ln_scale), f32(ln_bias)) if fuse_ln else (None, None)
    hidden = hidden.contiguous()
    mask = attention_mask.to(torch.int32).contiguous()
    glob = global_mask.to(torch.int32).contiguous()
    empty = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    counts = empty(B, 2, dtype=torch.int32)
    qkv_buf = empty(3, B, nh, L, hd)
    gkv_buf = empty(2, B, nh, L, hd) if global_rows else None
    ln_buf, out = empty(B * L, H, dtype=torch.float32), torch.empty_like(hidden)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if quantized:
            w = quantize_sliding_weights(qkv_kernel, gqkv_kernel, out_kernel)
            # the tile's operands K-major; the global query's loop reads wgq8 as it stands
            w.update({k: kmajor(w[k]) for k in ("wqkv8", "wgkv8", "wo8")})
            b = [f32(t).reshape(-1) for t in (qkv_bias, gqkv_bias[0], gqkv_bias[1:], out_bias)]
            x8 = empty(B * L * max(H, HN), dtype=torch.int8)
            scales, ctx_buf = empty(B * L, dtype=torch.float32), empty(B * L, HN,
                                                                         dtype=torch.float32)
            code = build.library().spk_sliding_block_w8a8(
                _DTYPES[dt], ptr(hidden), ptr(mask), ptr(glob), ptr(x8), ptr(scales),
                ptr(w["wqkv8"]), ptr(w["swqkv"]), ptr(b[0]), ptr(w["wgq8"]), ptr(w["swgq"]),
                ptr(b[1]), ptr(w["wgkv8"]), ptr(w["swgkv"]), ptr(b[2]), ptr(w["wo8"]),
                ptr(w["swo"]), ptr(b[3]), ptr(lns), ptr(lnb), ptr(counts), ptr(qkv_buf),
                ptr(gkv_buf), ptr(ctx_buf), ptr(ln_buf), ptr(out), B, L, H, nh, hd, window // 2,
                G, int(global_rows), float(sm_scale), float(eps), int(fuse_ln), stream,
            )
        else:
            w = card_weights(qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias, out_kernel, dt)
            ctx_buf = empty(B, L, HN)
            code = build.library().spk_sliding_block(
                _DTYPES[dt], ptr(hidden), ptr(mask), ptr(glob), ptr(w["wqkv"]), ptr(w["bqkv"]),
                ptr(w["wgq"]), ptr(w["bgq"]), ptr(w["wgkv"]), ptr(w["bgkv"]), ptr(w["wo"]),
                ptr(f32(out_bias)), ptr(lns), ptr(lnb), ptr(counts), ptr(qkv_buf), ptr(gkv_buf),
                ptr(ctx_buf), ptr(ln_buf), ptr(out), B, L, H, nh, hd, window // 2, G,
                int(global_rows), float(sm_scale), float(eps), int(fuse_ln), stream,
            )
    build.check(code, where)
    fused_sliding_attention_block.launches += 1
    return out


fused_sliding_attention_block.launches = 0
