"""Fused Longformer attention block: local and global QKV projections,
sliding-window attention with global columns, global rows through the
``*_global`` projections, output projection, residual and LayerNorm.

Counterpart of ``spokennlp_tpu/ops/pallas/sliding_block.py``. On a CUDA
tensor ``fused_sliding_attention_block`` runs the hand-written kernels of
``csrc/sliding_block.cu``; on a CPU tensor it runs ``sliding_block_plain``,
the same function in float32 PyTorch on the chunked formulation, which the
tests hold against the JAX kernel and the kernel is held against on the card.

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
    B, L, _ = hidden.shape
    nh, hd = qkv_kernel.shape[2], qkv_kernel.shape[3]
    C = window // 2
    nc, G = L // C, global_columns(max_globals, L)
    dev = hidden.device
    x = hidden.float()
    n_valid = (attention_mask > 0).sum(1)
    n_glob = (global_mask > 0).sum(1).clamp(max=G) if global_rows else torch.zeros_like(n_valid)
    qkv = torch.einsum("blh,hsnd->blsnd", x, qkv_kernel.float()) + qkv_bias.float()
    q, k, v = qkv.unbind(2)  # (B, L, nh, hd)
    q = q * sm_scale

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
    probs = torch.softmax(torch.cat([scores, g_scores], dim=-1), dim=-1)
    p_band, p_g = probs[..., : 3 * C], probs[..., 3 * C:]
    if dropout_rate > 0.0:
        band_keep, gcol_keep, grow_keep = keep
        scale = 1.0 / (1.0 - dropout_rate)
        p_band = torch.where(band_keep, p_band * scale, 0.0)
        p_g = torch.where(gcol_keep.reshape(B, nh, nc, C, G), p_g * scale, 0.0)
    ctx = (torch.einsum("bnicj,bijnd->bicnd", p_band, _ctx_windows(v, C))
           + torch.einsum("bnicg,bgnd->bicnd", p_g, v[:, :G])).reshape(B, L, nh, hd)
    if not global_rows:
        return ctx

    wg, bg = gqkv_kernel.float(), gqkv_bias.float()
    qg = (torch.einsum("bgh,hnd->bgnd", x[:, :G], wg[:, 0]) + bg[0]) * sm_scale
    kg = torch.einsum("blh,hnd->blnd", x, wg[:, 1]) + bg[1]
    vg = torch.einsum("blh,hnd->blnd", x, wg[:, 2]) + bg[2]
    key_real = torch.arange(L, device=dev)[None] < n_valid[:, None]  # (B, L)
    s = torch.einsum("bgnd,blnd->bngl", qg, kg)
    p = torch.softmax(torch.where(key_real[:, None, None], s, NEG_INF), dim=-1)
    if dropout_rate > 0.0:
        p = torch.where(grow_keep, p / (1.0 - dropout_rate), 0.0)
    cg = torch.einsum("bngl,blnd->bgnd", p, vg)
    is_global = (torch.arange(G, device=dev)[None] < n_glob[:, None])[:, :, None, None]
    return torch.cat([torch.where(is_global, cg, ctx[:, :G]), ctx[:, G:]], dim=1)


def sliding_block_plain(
    hidden, attention_mask, global_mask, qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias,
    out_kernel, out_bias, *, sm_scale: float, window: int, max_globals: int = 16,
    ln_scale: Optional[torch.Tensor] = None, ln_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-12, global_rows: bool = True,
) -> torch.Tensor:
    """The fused block in plain float32 PyTorch; returns hidden's dtype."""
    ctx = sliding_context_plain(
        hidden, attention_mask, global_mask, qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias,
        sm_scale=sm_scale, window=window, max_globals=max_globals, global_rows=global_rows,
    )
    out = torch.einsum("blnd,ndh->blh", ctx, out_kernel.float()) + out_bias.float()
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
) -> torch.Tensor:
    """Longformer attention block; returns (B, L, H) in hidden's dtype.

    Weights are rounded to hidden's dtype and biases and LayerNorm parameters
    kept in float32, as the TPU kernel does. A CUDA tensor that breaks the
    contract raises. ``fused_sliding_attention_block.launches`` counts the
    calls that ran the kernels on the card.
    """
    kw = dict(sm_scale=sm_scale, window=window, max_globals=max_globals, global_rows=global_rows)
    if hidden.device.type == "cpu":
        return sliding_block_plain(hidden, attention_mask, global_mask, qkv_kernel, qkv_bias,
                                   gqkv_kernel, gqkv_bias, out_kernel, out_bias, ln_scale=ln_scale,
                                   ln_bias=ln_bias, eps=eps, **kw)
    where = "fused_sliding_attention_block"
    check_card_inputs(where, hidden, attention_mask, global_mask, qkv_kernel, qkv_bias,
                      gqkv_kernel, gqkv_bias, out_kernel, out_bias, window, max_globals)
    B, L, H = hidden.shape
    nh, hd = qkv_kernel.shape[2], qkv_kernel.shape[3]
    dt, dev = hidden.dtype, hidden.device
    G = global_columns(max_globals, L)
    w = card_weights(qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias, out_kernel, dt)
    f32 = lambda t: t.float().contiguous()
    fuse_ln = ln_scale is not None
    lns, lnb = (f32(ln_scale), f32(ln_bias)) if fuse_ln else (None, None)
    hidden = hidden.contiguous()
    mask = attention_mask.to(torch.int32).contiguous()
    glob = global_mask.to(torch.int32).contiguous()
    empty = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    counts = empty(B, 2, dtype=torch.int32)
    qkv_buf, ctx_buf = empty(3, B, nh, L, hd), empty(B, L, nh * hd)
    gkv_buf = empty(2, B, nh, L, hd) if global_rows else None
    ln_buf, out = empty(B * L, H, dtype=torch.float32), torch.empty_like(hidden)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = build.library().spk_sliding_block(
            _DTYPES[dt], ptr(hidden), ptr(mask), ptr(glob), ptr(w["wqkv"]), ptr(w["bqkv"]),
            ptr(w["wgq"]), ptr(w["bgq"]), ptr(w["wgkv"]), ptr(w["bgkv"]), ptr(w["wo"]),
            ptr(f32(out_bias)), ptr(lns), ptr(lnb), ptr(counts), ptr(qkv_buf), ptr(gkv_buf),
            ptr(ctx_buf), ptr(ln_buf), ptr(out), B, L, H, nh, hd, window // 2, G,
            int(global_rows), float(sm_scale), float(eps), int(fuse_ln),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, where)
    fused_sliding_attention_block.launches += 1
    return out


fused_sliding_attention_block.launches = 0
