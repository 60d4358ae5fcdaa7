"""The rounding models of the attention kernels' tensor-core bodies
(``csrc/attention_rows_mma.cuh``, ``csrc/attention_grad_mma.cuh``): the
rows pass (the attention of a query row over its allowed keys, and the
backward's statistics) and the softmax-with-dropout gradient, on dense
(..., rows, keys) float32 scores with float32 sums and no tiles, rounded
where the kernels round. The Longformer (``train_sliding``), BigBird
(``train_bigbird``) and dense (``train_blocks``) training blocks build their
models from them; the card gates of ``chip_smoke.py`` hold the kernels to
those models and plant their faults by replacing ``round_ds``,
``round_p_eff``, ``rows_exponent`` or ``rows_softmax`` here.

``core_product`` is the attention cores' own product hook, beside the
projections' ``float_product``: the dense core's plain version and rounding
model (``attention_block``, ``blhd_attention``), row 10's plain core and
its rows and gradient models (``train_blocks``), the Longformer and BigBird
blocks' plain attention (``sliding_block.sliding_attend``,
``bigbird_block.bigbird_attend``) and their rows and gradient models
(``train_sliding``, ``train_bigbird``, the Longformer global rows' among
them) and ``rows_attend``'s P V take their products through it. The float32
cores run those products as 3xTF32 on the tensor cores; the card gates send
the hook to the 3xTF32 model (``int8_matmul.tf32x3_product``) and plant
plain TF32 there.
"""

from __future__ import annotations

import torch


def core_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, K) . (..., K, N) in float32: a product of an attention core
    (S = q k^T, dP = dctx v^T, P V, dS k, dS^T q, p_eff^T dctx) in the plain
    versions and rounding models (a card gate replaces it by the 3xTF32
    model, a planted fault by plain TF32)."""
    return a.float() @ b.float()


def round_ds(ds: torch.Tensor, dt) -> torch.Tensor:
    """dS rounded to the compute dtype, where the gradient kernels round it
    (a planted fault of the card gate replaces it)."""
    return ds.to(dt).float()


def round_p_eff(p_eff: torch.Tensor, dt) -> torch.Tensor:
    """p_eff rounded to the compute dtype for dv += p_eff^T dctx (a planted
    fault of the card gate replaces it)."""
    return p_eff.to(dt).float()


def rounded(x: torch.Tensor, dt) -> torch.Tensor:
    """x rounded to dt, back in float32."""
    return x.to(dt).float()


def dense_core_grad(s, dp, allowed, keep, stats, dt, keep_prob: float, scale: float = 1.0):
    """The softmax-with-dropout gradient of the training kernels on dense
    (..., rows, keys) float32 scores s and dp = dctx v^T: e = exp(s - m)
    with s - m and e rounded to dt, p_eff = e / (D keep_prob) where kept,
    dS = round((p_eff dp - (e / D) rowsum(dp p_eff)) scale) (the dense
    kernels scale the scores, the others pre-scale q); zero where not
    ``allowed``. ``stats`` = (m, D, rowsum(dp p_eff)) (..., rows), the
    kernels' own, or None: taken here in float32 as the statistics pass
    takes them. ``keep`` bool or None (dropout off). Returns (dS, p_eff
    rounded for dv), float32 tensors of dt values."""
    kept = allowed if keep is None else allowed & keep
    if stats is None:
        m, e = rows_softmax(s, allowed, dt)
        D = e.sum(-1)
        rs = (torch.where(kept, e, 0.0) * dp).sum(-1) / (D * keep_prob)
    else:
        m, D, rs = stats
    m, D, rs = m[..., None], D[..., None], rs[..., None]
    e = rows_exponent(s, m, dt)
    p_eff = torch.where(kept, e / (D * keep_prob), 0.0)
    ds = torch.where(allowed, round_ds((p_eff * dp - (e / D) * rs) * scale, dt), 0.0)
    return ds, torch.where(allowed, round_p_eff(p_eff, dt), 0.0)


def rows_exponent(s: torch.Tensor, m: torch.Tensor, dt) -> torch.Tensor:
    """e = exp(s - m) with s - m and e rounded to dt, where the rows kernels
    round it (a planted fault of the card gate replaces it)."""
    return rounded(torch.exp(rounded(s - m, dt)), dt)


def rows_softmax(s: torch.Tensor, allowed: torch.Tensor, dt):
    """(m, e) of the rows kernels on dense (..., rows, keys) float32 scores:
    the row's maximum over its allowed keys (-inf with none) and
    ``rows_exponent`` against it where allowed, else 0 (a planted fault of
    the card gate replaces it)."""
    m = torch.where(allowed, s, -torch.inf).amax(-1)
    e = rows_exponent(s, torch.where(torch.isfinite(m), m, 0.0)[..., None], dt)
    return m, torch.where(allowed, e, 0.0)


def rows_attend(s, v, allowed, keep, dt, keep_prob: float, dp=None, product=None):
    """(ctx, m, D, rs) of the rows kernels on dense float32 scores s (...,
    rows, keys), values v (..., keys, hd), ``allowed`` and ``keep`` (bool or
    None) and, for the statistics pass, dp = dctx v^T: D = sum e, ctx = (kept
    e) . v / (D keep_prob), rs = rowsum(dp p_eff) / (D keep_prob), both zero
    where D = 0 (rs None without dp). float32 sums, no tiles; P V through
    ``product`` (``core_product`` by default)."""
    m, e = rows_softmax(s, allowed, dt)
    pe = e if keep is None else torch.where(keep, e, 0.0)
    D = e.sum(-1)
    live = D > 0
    denom = torch.where(live, D * keep_prob, 1.0)
    ctx = torch.where(live[..., None], (product or core_product)(pe, v) / denom[..., None], 0.0)
    rs = None if dp is None else torch.where(live, (pe * dp).sum(-1) / denom, 0.0)
    return ctx, m, D, rs
