"""Sliding-window (+ global token) attention structure for Longformer-style
models, PyTorch.

The port's copy of ``spokennlp_tpu/ops/sliding_attention.py``, two ways:

1. ``sliding_window_attention_mask_bias``: an additive (B, L, L) bias for the
   dense einsum path; exact, fine up to about 1k tokens.
2. ``chunked_sliding_window_attention``: the blocked O(L * window) local pass
   that never forms (L, L): queries in chunks of C = window // 2, each
   against its three neighbouring key chunks and the global keys.

Window convention: token i attends to j with |i - j| <= window // 2; global
keys are taken out of the band and attend through their own columns.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sliding_window_attention_mask_bias(
    attention_mask: torch.Tensor,
    window: int,
    global_mask: Optional[torch.Tensor] = None,
    neg_inf: float = -1e9,
) -> torch.Tensor:
    """(B, L, L) float32 bias: 0 where attention is allowed, ``neg_inf``
    elsewhere. ``attention_mask`` (B, L) is 1 on real tokens; global tokens
    (``global_mask`` 1) attend to and are attended by every real token."""
    B, L = attention_mask.shape
    idx = torch.arange(L, device=attention_mask.device)
    allowed = ((idx[:, None] - idx[None, :]).abs() <= window // 2)[None].expand(B, L, L)
    if global_mask is not None:
        g = global_mask.bool()
        allowed = allowed | g[:, :, None] | g[:, None, :]
    allowed = allowed & attention_mask.bool()[:, None, :]
    return torch.where(allowed, 0.0, neg_inf).float()


def _ctx_windows(x: torch.Tensor, C: int) -> torch.Tensor:
    """(B, L, ...) -> (B, nc, 3C, ...): key chunks [i-1, i, i+1] of each
    query chunk i, zero beyond the sequence."""
    B, L = x.shape[:2]
    nc = L // C
    pad = [0, 0] * (x.dim() - 2) + [C, C]
    xp = F.pad(x, pad)
    slabs = torch.stack([xp[:, off * C: off * C + L] for off in range(3)], dim=1)
    chunked = slabs.reshape(B, 3, nc, C, *x.shape[2:])
    return chunked.movedim(1, 2).reshape(B, nc, 3 * C, *x.shape[2:])


def global_key_index(attention_mask: torch.Tensor, global_mask: torch.Tensor, G: int):
    """(index (B, G), valid (B, G)): the first G positions that are global and
    real, by a stable sort, as the JAX path takes them."""
    is_global = global_mask.bool() & attention_mask.bool()
    g_idx = torch.argsort(-is_global.int(), dim=1, stable=True)[:, :G]
    return g_idx, torch.take_along_dim(is_global, g_idx, dim=1)


def chunked_sliding_window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: torch.Tensor,
    global_mask: Optional[torch.Tensor],
    window: int,
    max_globals: int = 16,
    neg_inf: float = -1e9,
    softmax_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sliding-window + global-key attention, local pass.

    q, k, v (B, L, nh, hd), L a multiple of window // 2. Returns the (B, L,
    nh, hd) context of every row; global query rows hold the LOCAL result
    and must be replaced by the caller's global pass. Matches
    ``sliding_window_attention_mask_bias`` on non-global rows.
    """
    B, L, nh, hd = q.shape
    C = window // 2
    if L % C:
        raise ValueError(f"sequence length {L} is not a multiple of window // 2 = {C}")
    nc = L // C
    G = max_globals
    scale = 1.0 / hd**0.5
    valid = attention_mask.bool()
    if global_mask is None:
        global_mask = torch.zeros_like(attention_mask)
    is_global = global_mask.bool() & valid

    k_ctx, v_ctx = _ctx_windows(k, C), _ctx_windows(v, C)
    key_valid = _ctx_windows(valid.int(), C).bool()  # (B, nc, 3C)
    key_is_global = _ctx_windows(is_global.int(), C).bool()
    ci = torch.arange(C, device=q.device)[:, None]
    cj = torch.arange(3 * C, device=q.device)[None, :]
    band = ((cj - C) - ci).abs() <= C  # (C, 3C)

    q_chunks = q.reshape(B, nc, C, nh, hd).float() * scale
    local_scores = torch.einsum("bicnd,bijnd->bnicj", q_chunks, k_ctx.float())
    local_ok = band[None, None, None] & (key_valid & ~key_is_global)[:, None, :, None, :]
    local_scores = torch.where(local_ok, local_scores, neg_inf)

    if G > 0:
        g_idx, g_valid = global_key_index(attention_mask, global_mask, G)
        gather = lambda x: torch.take_along_dim(x, g_idx[:, :, None, None], dim=1)
        kg, vg = gather(k), gather(v)
        g_scores = torch.einsum("bicnd,bgnd->bnicg", q_chunks, kg.float())
        g_scores = torch.where(g_valid[:, None, None, None, :], g_scores, neg_inf)
        all_scores = torch.cat([local_scores, g_scores], dim=-1)
    else:
        all_scores = local_scores
    probs = torch.softmax(all_scores.to(softmax_dtype), dim=-1)
    ctx = torch.einsum("bnicj,bijnd->bicnd", probs[..., : 3 * C].to(v.dtype), v_ctx)
    if G > 0:
        ctx = ctx + torch.einsum("bnicg,bgnd->bicnd", probs[..., 3 * C:].to(v.dtype), vg)
    return ctx.reshape(B, L, nh, hd)
