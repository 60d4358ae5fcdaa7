"""Training Longformer attention block with hand-written forward and
backward kernels.

Counterpart of ``spokennlp_tpu/ops/pallas/train_sliding.py``:
``sliding_attention_block_train`` is the attention of
``ops/cuda/sliding_block.py`` (band, global columns, global rows through the
``*_global`` projections) followed by the output projection, without the
LayerNorm epilogue, with dropout on the band, global-column and global-row
probabilities inside the kernels (``csrc/train_sliding.cu``). Residual,
LayerNorm and hidden-state dropout stay in PyTorch.

On a CUDA tensor it runs the kernels through a ``torch.autograd.Function``
whose backward is a kernel too; the forward saves only its inputs and the
seed, and the backward recomputes the rest. On a CPU tensor it runs
``sliding_train_plain`` (float32 PyTorch on the chunked formulation, with
explicit keep masks), whose gradient comes from autograd.

Dropout draws one Philox4x32-10 word per probability from three counter
spaces that never meet, the second word carrying the head and a tag:

    band keys       (b, h,           row, key)
    global columns  (b, h | 1 << 16, row, g)
    global rows     (b, h | 2 << 16, g,   key)

and keeps a probability iff its bits are >= ``dropout_threshold(rate)``.
``sliding_keep_masks`` gives the three masks on either device (the numpy twin
``philox_bits`` on the CPU), so the plain version replays the kernels'
dropout exactly. The TPU kernel's hardware-PRNG pattern cannot be matched bit
for bit, so parity with JAX runs at rate 0.

``sliding_train_bwd_plain`` is the backward kernel written out, every
product through ``train_blocks.backward_product`` (no model path runs it;
the card checks hold the kernel's products to it). ``sliding_core_bwd_model``
is the rounding model of its gradient kernels: dense over a sequence's
keys, float32 sums, rounded where the kernels round (the card checks hold
the kernels' dproj to it element by element).
"""

from __future__ import annotations

import numpy as np
import torch

from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
from spokennlp_tpu_torch.ops.cuda.attention_models import (
    dense_core_grad, rounded, rows_attend,
)
from spokennlp_tpu_torch.ops.cuda.attention_block import _DTYPES
from spokennlp_tpu_torch.ops.cuda.int8_matmul import float_product, int8_product
from spokennlp_tpu_torch.ops.cuda.sliding_block import (
    _counts, card_weights, check_card_inputs, global_columns, sliding_attend,
    sliding_context_plain,
)
from spokennlp_tpu_torch.ops.cuda.train_blocks import (
    _ptr, _stream, dropout_threshold, philox_bits, weight_grad_plan,
)

GLOBAL_COL_STREAM, GLOBAL_ROW_STREAM = 1 << 16, 2 << 16


def _u32(a) -> np.ndarray:
    """Counters as the kernels pass them: int values wrapped to 32 bits."""
    return np.asarray(a, np.int64) & 0xFFFFFFFF


def _global_row_keep(seed: int, B: int, nh: int, G: int, L: int, thr: int) -> torch.Tensor:
    """The global-row plane (B, nh, G, L) of the keep masks on the CPU."""
    b, h, g, k = np.ix_(np.arange(B), np.arange(nh), np.arange(G), np.arange(L))
    return torch.from_numpy(philox_bits(seed, b, h | GLOBAL_ROW_STREAM, g, k) >= np.uint32(thr))


def sliding_keep_masks(seed: torch.Tensor, B: int, nh: int, L: int, window: int, G: int,
                       rate: float):
    """(band (B, nh, L / C, C, 3C), global columns (B, nh, L, G), global rows
    (B, nh, G, L)) bool: where the training kernels keep a probability for
    this (1,) int32 seed, on the seed's device. Band entry (i, ci, cj) is
    row i C + ci against key i C - C + cj."""
    C = window // 2
    nc = L // C
    thr = dropout_threshold(rate)
    if seed.device.type == "cpu":
        s = int(seed.reshape(-1)[0])
        b, h, i, ci, cj = np.ix_(np.arange(B), np.arange(nh), np.arange(nc), np.arange(C),
                                 np.arange(3 * C))
        band = philox_bits(s, b, h, _u32(i * C + ci), _u32(i * C - C + cj))
        b, h, r, g = np.ix_(np.arange(B), np.arange(nh), np.arange(L), np.arange(G))
        gcol = philox_bits(s, b, h | GLOBAL_COL_STREAM, r, g)
        return (*(torch.from_numpy(m >= np.uint32(thr)) for m in (band, gcol)),
                _global_row_keep(s, B, nh, G, L, thr))
    masks = [torch.empty(shape, dtype=torch.uint8, device=seed.device)
             for shape in ((B, nh, nc, C, 3 * C), (B, nh, L, G), (B, nh, G, L))]
    seed = seed.to(torch.int32).contiguous()
    with torch.cuda.device(seed.device):
        code = build.library().spk_sliding_dropout_mask(
            seed.data_ptr(), *(m.data_ptr() for m in masks), B, nh, L, C, G, thr, _stream())
    build.check(code, "sliding_keep_masks")
    return tuple(m.bool() for m in masks)


def sliding_train_plain(
    hidden, attention_mask, global_mask, qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias,
    out_kernel, out_bias, *, sm_scale: float, window: int, max_globals: int = 16,
    global_rows: bool = True, dropout_rate: float = 0.0, keep=None,
) -> torch.Tensor:
    """The training block in plain float32 PyTorch; returns hidden's dtype.
    ``keep`` (the three masks of ``sliding_keep_masks``) is needed when
    ``dropout_rate`` > 0. The projections and the out projection go through
    ``float_product`` (this module's and sliding_block's)."""
    if dropout_rate > 0.0 and keep is None:
        raise ValueError("sliding_train_plain: dropout_rate > 0 needs the keep masks")
    ctx = sliding_context_plain(
        hidden, attention_mask, global_mask, qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias,
        sm_scale=sm_scale, window=window, max_globals=max_globals, global_rows=global_rows,
        dropout_rate=dropout_rate, keep=keep,
    )
    B, L, H = hidden.shape
    out = float_product(ctx.reshape(B, L, -1), out_kernel.reshape(-1, H)) + out_bias.float()
    return out.to(hidden.dtype)


def sliding_train_bwd_plain(
    hidden, attention_mask, global_mask, qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias,
    out_kernel, g, *, sm_scale: float, window: int, max_globals: int = 16,
    global_rows: bool = True, dropout_rate: float = 0.0, keep=None, model_core: bool = False,
):
    """The backward kernel written out: the projections [q k v qg kg vg]
    recomputed (qg of every row; the core reads the first G) and rounded to
    hidden's dtype, dctx = g Wo^T rounded, the core's gradient (autograd of
    ``sliding_attend`` in float32) rounded, then
    ``train_blocks.projection_grads_plain`` on the rounded ctx. Returns (dx,
    dWqkv, dbqkv, dWg, dbg, dWo, dbo) as ``sliding_train_bwd`` does (dWg and
    dbg zero without global rows); in float32 it is autograd of
    ``sliding_train_plain``. ``model_core``: the core's gradient from
    ``sliding_core_bwd_model`` instead, on q and qg scaled before they are
    rounded and a ctx with the kernels' rounded exponent, as the kernels
    take them."""
    B, L, H = hidden.shape
    _, _, nh, hd = qkv_kernel.shape
    dt, M, HN = hidden.dtype, B * L, nh * hd
    G = global_columns(max_globals, L)
    x, g2, wo = hidden.reshape(M, H), g.reshape(M, H), out_kernel.reshape(HN, H)
    kernels, biases = [qkv_kernel], [qkv_bias]
    if global_rows:
        kernels, biases = [qkv_kernel, gqkv_kernel], [qkv_bias, gqkv_bias]
    w_all = torch.cat([k.reshape(H, 3 * HN) for k in kernels], dim=1)
    b_all = torch.cat([b.float().reshape(-1) for b in biases])
    if model_core:
        return _bwd_plain_model_core(x, g2, w_all, b_all, wo, attention_mask, global_mask,
                                     B, L, nh, hd, G, sm_scale=sm_scale, window=window,
                                     global_rows=global_rows, dropout_rate=dropout_rate,
                                     keep=keep)
    proj = (tb.backward_product(x, w_all) + b_all).to(dt).float()
    with torch.enable_grad():
        proj = proj.requires_grad_()
        p = proj.reshape(B, L, -1, nh, hd)
        glob_qkv = (p[:, :G, 3] * sm_scale, p[:, :, 4], p[:, :, 5]) if global_rows else None
        ctx = sliding_attend(p[:, :, 0] * sm_scale, p[:, :, 1], p[:, :, 2], glob_qkv,
                             *_counts(attention_mask, global_mask, G, global_rows),
                             window=window, G=G, dropout_rate=dropout_rate, keep=keep)
        ctx = ctx.reshape(M, HN)
        (dproj,) = torch.autograd.grad(ctx, proj, tb.out_grad_plain(g2, wo).float())
    dx, dw_all, db_all, dwo, dbo = tb.projection_grads_plain(
        x, g2, ctx.detach().to(dt), dproj.to(dt), w_all, wo)
    return _split_grads(B, L, H, HN, global_rows, dx, dw_all, db_all, dwo, dbo)


def _split_grads(B, L, H, HN, global_rows, dx, dw_all, db_all, dwo, dbo):
    if global_rows:
        dwg, dbg = dw_all[:, 3 * HN:], db_all[3 * HN:]
    else:
        dwg, dbg = torch.zeros_like(dw_all), torch.zeros_like(db_all)
    return (dx.reshape(B, L, H), dw_all[:, :3 * HN], db_all[:3 * HN], dwg, dbg, dwo, dbo)


def _bwd_plain_model_core(x, g2, w_all, b_all, wo, attention_mask, global_mask, B, L, nh, hd, G,
                          *, sm_scale, window, global_rows, dropout_rate, keep):
    """``sliding_train_bwd_plain`` with the core's gradient from the rounding
    model."""
    dt, M, HN, H = x.dtype, B * L, nh * hd, x.shape[1]
    p = (tb.backward_product(x, w_all) + b_all).reshape(B, L, -1, nh, hd)
    q, k, v = (p[:, :, 0] * sm_scale).to(dt), p[:, :, 1].to(dt), p[:, :, 2].to(dt)
    glob_qkv = None
    if global_rows:
        glob_qkv = ((p[:, :G, 3] * sm_scale).to(dt), p[:, :, 4].to(dt), p[:, :, 5].to(dt))
    counts = _counts(attention_mask, global_mask, G, global_rows)
    dctx = tb.out_grad_plain(g2, wo)
    ctx = sliding_attend(q, k, v, glob_qkv, *counts, window=window, G=G, exp_dtype=dt,
                         dropout_rate=dropout_rate, keep=keep).reshape(M, HN)
    heads = lambda t: t.transpose(1, 2)  # (B, L, nh, hd) -> the kernels' (B, nh, L, hd)
    grads = sliding_core_bwd_model(
        heads(q), heads(k), heads(v), None if glob_qkv is None else tuple(map(heads, glob_qkv)),
        dctx.reshape(B, L, nh, hd), *counts, window=window, sm_scale=sm_scale,
        dropout_rate=dropout_rate, keep=keep)
    dproj = torch.stack(grads, dim=2).reshape(M, -1)
    dx, dw_all, db_all, dwo, dbo = tb.projection_grads_plain(x, g2, ctx.to(dt), dproj, w_all, wo)
    return _split_grads(B, L, H, HN, global_rows, dx, dw_all, db_all, dwo, dbo)


# ------------------------------------------------- the gradient kernels' model


def dense_band_keep(band: torch.Tensor, L: int, C: int) -> torch.Tensor:
    """A band keep mask (..., L / C, C, 3C) (entry (i, ci, cj): row i C + ci
    against key i C - C + cj) as a dense (..., L, L) one."""
    nc, dev = L // C, band.device
    i, ci, cj = (torch.arange(n, device=dev) for n in (nc, C, 3 * C))
    rows = (i[:, None, None] * C + ci[None, :, None]).expand(nc, C, 3 * C)
    keys = (i[:, None, None] * C - C + cj[None, None, :]).expand(nc, C, 3 * C)
    ok = (keys >= 0) & (keys < L)
    out = torch.zeros(*band.shape[:-3], L, L, dtype=torch.bool, device=dev)
    out[..., rows[ok], keys[ok]] = band[..., ok]
    return out


def sliding_model_allowed(L: int, C: int, n_valid: int, n_glob: int, device) -> torch.Tensor:
    """(L, L) bool: the keys a local row reaches, its band's real non-global
    keys and the global columns (keys < n_glob)."""
    r = torch.arange(L, device=device)
    d = r[None] - r[:, None]
    band = (d.abs() <= C) & (r[None] >= n_glob) & (r[None] < n_valid)
    return band | (r[None] < n_glob)


def sliding_global_allowed(L: int, n_valid: int, n_glob: int, device) -> torch.Tensor:
    """(n_glob, L) bool: the keys a global row reaches, every real one."""
    return (torch.arange(L, device=device) < n_valid)[None].expand(n_glob, L)


def sliding_core_bwd_model(q, k, v, glob_qkv, dctx, n_valid, n_glob, *, window: int,
                           sm_scale: float, stats=None, gstats=None, dropout_rate: float = 0.0,
                           keep=None):
    """The rounding model of the Longformer backward's gradient kernels
    (band_dq_kernel, band_dkv_kernel, global_kv_grad_kernel) and of the
    global rows' dq (global_rows_kernel), from the kernels' own q (scaled),
    k, v (B, nh, L, hd), glob_qkv = (qg (B, nh, G, hd) scaled, kg, vg (B,
    nh, L, hd)) or None, dctx (B, L, nh, hd), the counts n_valid, n_glob
    (B,), the row statistics stats (3, B, nh, L) and gstats (3, B, nh, G)
    (None: taken here) and the keep masks of ``sliding_keep_masks``. Dense
    over a sequence's keys with float32 sums and no tiles; rounds where the
    kernels round (``dense_core_grad``; dq before and after the scale, the
    global rows' dq after it, dk and dv once). The banded rows' cotangent is
    zero on global rows. Returns (dq, dk, dv) and with glob_qkv (dqg, dkg,
    dvg), each (B, L, nh, hd) in q's dtype (dqg zero beyond the global
    rows)."""
    dt, dev = q.dtype, q.device
    B, nh, L, hd = q.shape
    C, kp = window // 2, 1.0 - dropout_rate
    outs = [torch.zeros(B, nh, L, hd, device=dev) for _ in range(3 if glob_qkv is None else 6)]
    tr = lambda t: t.transpose(-1, -2)
    for b in range(B):
        nv, ng = int(n_valid[b]), int(n_glob[b])
        qb, kb, vb = (t[b].float() for t in (q, k, v))
        dc = dctx[b].float().transpose(0, 1)  # (nh, L, hd)
        dcl = dc.clone()
        dcl[:, :ng] = 0.0
        kd = None if keep is None else _sliding_dense_keep(keep, b, L, C, ng)
        ds, pe = dense_core_grad(qb @ tr(kb), dcl @ tr(vb), sliding_model_allowed(L, C, nv, ng, dev),
                                 kd, None if stats is None else stats[:, b], dt, kp)
        outs[0][b] = rounded(rounded(ds @ kb, dt) * sm_scale, dt)
        outs[1][b] = rounded(tr(ds) @ qb, dt)
        outs[2][b] = rounded(tr(pe) @ dcl, dt)
        if glob_qkv is None or ng == 0:
            continue
        qg, kg, vg = (t[b].float() for t in glob_qkv)
        qg = qg[:, :ng]
        ds, pe = dense_core_grad(qg @ tr(kg), dc[:, :ng] @ tr(vg),
                                 sliding_global_allowed(L, nv, ng, dev),
                                 None if keep is None else keep[2][b][:, :ng],
                                 None if gstats is None else gstats[:, b, :, :ng], dt, kp)
        outs[3][b, :, :ng] = rounded(ds @ kg * sm_scale, dt)
        outs[4][b] = rounded(tr(ds) @ qg, dt)
        outs[5][b] = rounded(tr(pe) @ dc[:, :ng], dt)
    return tuple(o.transpose(1, 2).to(dt) for o in outs)


def sliding_core_model_dproj(buffers: dict, *, window: int, sm_scale: float,
                             dropout_rate: float = 0.0, keep=None) -> torch.Tensor:
    """The model's [dq dk dv (dqg dkg dvg)] (B*L, ld) on the intermediates
    that ``sliding_train_bwd`` put into ``buffers``: the layout of the
    kernel's dproj."""
    qkv, gkv, counts = buffers["qkv"], buffers["gkv"], buffers["counts"].long()
    B, nh, L, hd = qkv.shape[1:]
    glob_qkv = None if gkv is None else (buffers["qg"], gkv[0], gkv[1])
    grads = sliding_core_bwd_model(
        qkv[0], qkv[1], qkv[2], glob_qkv, buffers["dctx"].reshape(B, L, nh, hd), counts[:, 0],
        counts[:, 1], window=window, sm_scale=sm_scale, stats=buffers["stats"],
        gstats=buffers["gstats"], dropout_rate=dropout_rate, keep=keep)
    return torch.stack(grads, dim=2).reshape(B * L, -1)


# ------------------------------------------------------ the rows kernels' model


def _sliding_dense_keep(keep, b: int, L: int, C: int, ng: int):
    """The band and global-column keep masks of sequence b as one dense (nh,
    L, L) mask of a local row's keys."""
    kd = dense_band_keep(keep[0][b], L, C)
    kd[:, :, :ng] = keep[1][b][:, :, :ng]
    return kd


def sliding_rows_model(q, k, v, glob_qkv, n_valid, n_glob, *, window: int, dctx=None,
                       dropout_rate: float = 0.0, keep=None, ctx_dtype=None):
    """The rounding model of band_rows_kernel and, with ``glob_qkv``, of
    global_rows_kernel over it: the attention the Longformer blocks run,
    from the kernels' own q (scaled), k, v (B, nh, L, hd), glob_qkv = (qg
    (B, nh, G, hd) scaled, kg, vg (B, nh, L, hd)) or None, the counts
    n_valid, n_glob (B,) and the keep masks of ``sliding_keep_masks``. With
    ``dctx`` (B, L, nh, hd), zero on global rows as the statistics pass
    reads it, also rowsum(dp p_eff). Dense over a sequence's keys with
    float32 sums and no tiles; e rounded where the kernels round it
    (``rows_exponent``, against the row's true maximum), ctx rounded to
    ``ctx_dtype`` (q's dtype by default). Returns ctx (B, L, nh, hd) and the
    row statistics (3, B, nh, L) float32 = (m, D, rowsum(dp p_eff)) of the
    band rows (-inf, 0, 0 for a row with no allowed key; rs zero without
    dctx)."""
    dt, dev = q.dtype, q.device
    B, nh, L, hd = q.shape
    C, kp = window // 2, 1.0 - dropout_rate
    ctx = torch.zeros(B, nh, L, hd, device=dev)
    stats = torch.zeros(3, B, nh, L, device=dev)
    tr = lambda t: t.transpose(-1, -2)
    for b in range(B):
        nv, ng = int(n_valid[b]), int(n_glob[b])
        qb, kb, vb = (t[b].float() for t in (q, k, v))
        dp = None
        if dctx is not None:
            dcl = dctx[b].float().transpose(0, 1).clone()  # (nh, L, hd)
            dcl[:, :ng] = 0.0
            dp = dcl @ tr(vb)
        kd = None if keep is None else _sliding_dense_keep(keep, b, L, C, ng)
        c, m, D, rs = rows_attend(qb @ tr(kb), vb, sliding_model_allowed(L, C, nv, ng, dev), kd,
                                  dt, kp, dp)
        ctx[b], stats[0, b], stats[1, b] = c, m, D
        if rs is not None:
            stats[2, b] = rs
    if glob_qkv is not None:
        gctx = sliding_global_rows_model(*glob_qkv, n_valid, n_glob, dropout_rate=dropout_rate,
                                         keep=None if keep is None else keep[2],
                                         ctx_dtype=torch.float32)[0]
        for b in range(B):
            ng = int(n_glob[b])
            ctx[b, :, :ng] = gctx[b, :ng].transpose(0, 1)
    return ctx.transpose(1, 2).to(ctx_dtype or dt), stats


def sliding_global_rows_model(qg, kg, vg, n_valid, n_glob, *, sm_scale: float = 1.0, dctx=None,
                              dropout_rate: float = 0.0, keep=None, ctx_dtype=None):
    """The rounding model of global_rows_kernel from its own qg (B, nh, G,
    hd) scaled, kg, vg (B, nh, L, hd), the counts n_valid, n_glob (B,) and
    the global-row keep mask (B, nh, G, L) of ``sliding_keep_masks`` (or
    None): each global row g < n_glob attends to every real key
    (``sliding_global_allowed``), e rounded against its true maximum
    (``rows_attend``), ctx rounded to ``ctx_dtype`` (qg's dtype by default).
    With ``dctx`` (B, L, nh, hd) also the statistics (m, D, rowsum(dp
    p_eff)) and dqg = round((dS . kg) sm_scale) with dS from
    ``dense_core_grad`` on those statistics. Dense over the keys with float32
    sums. Returns ctx (B, G, nh, hd), the statistics (3, B, nh, G) float32
    and dqg (B, G, nh, hd) in qg's dtype (the last two None without dctx),
    zero on rows g >= n_glob."""
    dt, dev = qg.dtype, qg.device
    B, nh, G, hd = qg.shape
    L = kg.shape[2]
    kp = 1.0 - dropout_rate
    ctx = torch.zeros(B, nh, G, hd, device=dev)
    stats = torch.zeros(3, B, nh, G, device=dev)
    dqg = torch.zeros(B, nh, G, hd, device=dev)
    tr = lambda t: t.transpose(-1, -2)
    for b in range(B):
        nv, ng = int(n_valid[b]), int(n_glob[b])
        if ng == 0:
            continue
        q, k, v = qg[b, :, :ng].float(), kg[b].float(), vg[b].float()
        s, allowed = q @ tr(k), sliding_global_allowed(L, nv, ng, dev)
        kb = None if keep is None else keep[b][:, :ng]
        dp = None if dctx is None else dctx[b, :ng].float().transpose(0, 1) @ tr(v)
        c, m, D, rs = rows_attend(s, v, allowed, kb, dt, kp, dp)
        ctx[b, :, :ng] = c
        if dctx is None:
            continue
        stats[0, b, :, :ng], stats[1, b, :, :ng], stats[2, b, :, :ng] = m, D, rs
        ds, _ = dense_core_grad(s, dp, allowed, kb, (m, D, rs), dt, kp)
        dqg[b, :, :ng] = rounded(ds @ k * sm_scale, dt)
    ctx = ctx.transpose(1, 2).to(ctx_dtype or dt)
    if dctx is None:
        return ctx, None, None
    return ctx, stats, dqg.transpose(1, 2).to(dt)


def sliding_rows(qkv, counts, seed, *, window: int, dctx=None, dropout_rate: float = 0.0,
                 ctx_dtype=None):
    """band_rows_kernel alone (no global rows): qkv (3, B, nh, L, hd) with q
    scaled, counts (B, 2) int32 = (n_valid, n_glob), seed (1,) int32 (read at
    a rate above 0) and, for the statistics pass, dctx (B, L, nh hd).
    Returns ctx (B, L, nh, hd) in ``ctx_dtype`` (qkv's dtype, or float32
    from bf16 q, k, v as the W8A8 blocks run it) and, with dctx, the row
    statistics (3, B, nh, L) float32 (else None). On the CPU it runs
    ``sliding_rows_model``; on the card the kernel, whose launches
    ``sliding_rows.launches`` counts. No model path calls it: the blocks
    launch the kernel inside their own entries."""
    _, B, nh, L, hd = qkv.shape
    dt = qkv.dtype
    ctx_dtype = ctx_dtype or dt
    if qkv.device.type == "cpu":
        n, keep = counts.long(), None
        if dropout_rate > 0.0:
            keep = sliding_keep_masks(seed, B, nh, L, window,
                                      global_columns(int(n[:, 1].max()), L), dropout_rate)
        ctx, stats = sliding_rows_model(qkv[0], qkv[1], qkv[2], None, n[:, 0], n[:, 1],
                                        window=window, dropout_rate=dropout_rate, keep=keep,
                                        ctx_dtype=ctx_dtype,
                                        dctx=None if dctx is None else dctx.reshape(B, L, nh, hd))
        return ctx, None if dctx is None else stats
    ctx = torch.empty(B, L, nh, hd, dtype=ctx_dtype, device=qkv.device)
    stats = None if dctx is None else torch.empty(3, B, nh, L, device=qkv.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(qkv.device):
        code = build.library().spk_sliding_rows(
            _DTYPES[dt], int(ctx_dtype != dt), int(dctx is not None), ptr(qkv), ptr(counts),
            ptr(seed), ptr(dctx), ptr(ctx), ptr(stats), B, L, nh, hd, window // 2,
            dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream())
    build.check(code, "sliding_rows")
    sliding_rows.launches += 1
    return ctx, stats


sliding_rows.launches = 0


def sliding_global_query(x, wgq, bgq, n_glob, *, num_heads: int, sm_scale: float, G: int,
                         quant=None):
    """The global rows' query as the plain versions take it: qg = round((x_g
    Wgq + bgq) sm_scale) of the first G rows of x (B, L, H), wgq (H, nh hd)
    in x's dtype, bgq (nh hd,) float32, float32 sums; with ``quant`` (as
    ``sliding_global_rows`` takes it) the exact int32 product of the int8
    rows and weights, dequantised as the projections are. Returns (B, nh,
    G, hd) in x's dtype, zero on rows g >= n_glob (B,)."""
    B, L, H = x.shape
    dev = x.device
    if quant is None:
        qg = x[:, :G].float() @ wgq.float() + bgq.float()
    else:
        rows = (torch.arange(B, device=dev)[:, None] * L + torch.arange(G, device=dev)[None])
        rows = rows.reshape(-1)
        qg = int8_product(quant["x8"][rows], quant["wgq8"]) * quant["sx"].reshape(-1)[rows, None]
        qg = (qg * quant["swgq"].float() + bgq.float()).reshape(B, G, -1)
    live = torch.arange(G, device=dev)[None] < n_glob[:, None].long()
    qg = torch.where(live[..., None], qg * sm_scale, 0.0).to(x.dtype)
    return qg.reshape(B, G, num_heads, -1).transpose(1, 2)


def sliding_global_rows(x, wgq, bgq, gkv, counts, seed, *, sm_scale: float, max_globals: int = 16,
                        dctx=None, dropout_rate: float = 0.0, quant=None):
    """global_rows_kernel alone: x (B, L, H), wgq (H, nh hd) in x's dtype,
    bgq (nh hd,) float32, gkv (2, B, nh, L, hd) = (kg, vg), counts (B, 2)
    int32 = (n_valid, n_glob), seed (1,) int32 (read at a rate above 0) and,
    for the statistics pass, dctx (B, L, nh hd). ``quant``: the W8A8 blocks'
    global query, a dict of x8 (B L, H) int8 with row scales sx (B L,) and
    wgq8 (H, nh hd) int8 with column scales swgq (nh hd,), and a float32
    ctx. Returns ctx (B, G, nh, hd), the kernel's own qg (B, nh, G, hd) and,
    with dctx, the statistics (3, B, nh, G) float32 and dqg (B, G, nh, hd)
    (else None, None); zero on rows g >= n_glob. On the CPU it runs the
    query of the plain versions and ``sliding_global_rows_model``; on the
    card the kernel, whose launches ``sliding_global_rows.launches`` counts.
    No model path calls it: the blocks launch the kernel inside their own
    entries."""
    B, L, H = x.shape
    _, _, nh, _, hd = gkv.shape
    HN, dt, dev = nh * hd, x.dtype, x.device
    G = global_columns(max_globals, L)
    ctx_dtype = torch.float32 if quant is not None else dt
    if dev.type == "cpu":
        n = counts.long()
        qg = sliding_global_query(x, wgq, bgq, n[:, 1], num_heads=nh, sm_scale=sm_scale, G=G,
                                  quant=quant)
        keep = None
        if dropout_rate > 0.0:
            keep = _global_row_keep(int(seed.reshape(-1)[0]), B, nh, G, L,
                                    dropout_threshold(dropout_rate))
        ctx, stats, dqg = sliding_global_rows_model(
            qg, gkv[0], gkv[1], n[:, 0], n[:, 1], sm_scale=sm_scale,
            dctx=None if dctx is None else dctx.reshape(B, L, nh, hd),
            dropout_rate=dropout_rate, keep=keep, ctx_dtype=ctx_dtype)
        return ctx, qg, stats, dqg
    q = quant or {}
    given = (x, wgq, bgq, gkv, counts, seed, dctx, *q.values())
    if any(t is not None and (t.device != dev or not t.is_contiguous()) for t in given):
        raise ValueError("sliding_global_rows: every tensor must be contiguous on x's device")
    grad = dctx is not None
    ctx = torch.empty(B, L, nh, hd, dtype=ctx_dtype, device=dev)
    qg = torch.empty(B, nh, G, hd, dtype=dt, device=dev)
    stats = torch.empty(3, B, nh, G, device=dev) if grad else None
    dqg = torch.empty(B, L, nh, hd, dtype=dt, device=dev) if grad else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = build.library().spk_sliding_global_rows(
            _DTYPES[dt], int(quant is not None), int(grad),
            *(ptr(t) for t in (x, wgq, bgq, gkv, counts, seed, dctx, ctx, qg, stats, dqg,
                               q.get("x8"), q.get("sx"), q.get("wgq8"), q.get("swgq"))),
            B, L, H, nh, hd, G, HN, float(sm_scale), dropout_threshold(dropout_rate),
            1.0 - dropout_rate, _stream())
    build.check(code, "sliding_global_rows")
    sliding_global_rows.launches += 1
    live = torch.arange(G, device=dev)[None] < counts[:, 1:2].long()  # (B, G): rows g < n_glob
    rows = live[:, :, None, None]
    ctx, qg = torch.where(rows, ctx[:, :G], 0.0), torch.where(live[:, None, :, None], qg, 0.0)
    if not grad:
        return ctx, qg, None, None
    return ctx, qg, torch.where(live[None, :, None], stats, 0.0), torch.where(rows, dqg[:, :G], 0.0)


sliding_global_rows.launches = 0


# ------------------------------------------------------------ kernel calls


def sliding_train_fwd(hidden, mask, glob, seed, w, bo, *, num_heads: int, window: int,
                      max_globals: int, global_rows: bool, sm_scale: float,
                      dropout_rate: float, buffers: dict = None) -> torch.Tensor:
    """Forward kernel: hidden (B, L, H), the weights of ``card_weights`` ``w``,
    bo (H,) float32, mask, glob (B, L) and seed (1,) int32, all on one card. A
    ``buffers`` dict receives the projections qkv (3, B, nh, L, hd) and gkv
    (2, B, nh, L, hd) or None. ``sliding_train_fwd.launches`` counts its
    launches."""
    B, L, H = hidden.shape
    HN = w["wo"].shape[0]
    hd = HN // num_heads
    dev, dt = hidden.device, hidden.dtype
    G = global_columns(max_globals, L)
    empty = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    counts, qkv_buf, ctx_buf = empty(B, 2, dtype=torch.int32), empty(3, B, num_heads, L, hd), \
        empty(B, L, HN)
    gkv_buf = empty(2, B, num_heads, L, hd) if global_rows else None
    out = torch.empty_like(hidden)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = build.library().spk_sliding_train_fwd(
            _DTYPES[dt], *(ptr(t) for t in (hidden, mask, glob, seed, w["wqkv"], w["bqkv"],
                                             w["wgq"], w["bgq"], w["wgkv"], w["bgkv"], w["wo"],
                                             bo, counts, qkv_buf, gkv_buf, ctx_buf, out)),
            B, L, H, num_heads, hd, window // 2, G, int(global_rows), float(sm_scale),
            dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream(),
        )
    build.check(code, "sliding_train_fwd")
    sliding_train_fwd.launches += 1
    if buffers is not None:
        buffers.update(qkv=qkv_buf, gkv=gkv_buf)
    return out


def sliding_ds_elements(B: int, nh: int, L: int, window: int) -> int:
    """bf16 elements of the dS tiles that the bf16 backward's dk/dv pass
    writes once for its dq pass: a (64, 64) tile for each of the
    band_tiles(C) band tiles and the global-column tile of every 64-row query
    tile (csrc/train_sliding.cu sliding_ds_tiles)."""
    band_tiles = (64 + 2 * (window // 2) + 63) // 64
    return B * nh * -(-L // 64) * (band_tiles + 1) * 64 * 64


def sliding_train_bwd(hidden, mask, glob, seed, w, g, *, num_heads: int, window: int,
                      max_globals: int, global_rows: bool, sm_scale: float,
                      dropout_rate: float, buffers: dict = None):
    """Backward kernel: recomputes the forward from its inputs and returns
    (dx in the compute dtype, dWqkv (H, 3 Hn), dbqkv (3 Hn,), dWg (H, 3 Hn),
    dbg (3 Hn,), dWo (Hn, H), dbo (H,) in float32, summed over the batch;
    dWg and dbg are zero without global rows). A ``buffers`` dict receives
    the intermediates its products read: ctx and dctx (M, Hn), dproj = [dq
    dk dv dqg dkg dvg] (M, ld) and w_all = [Wqkv Wg] (H, ld), ld = 6 Hn (3
    Hn without global rows); and those its gradient kernels read: qkv (3, B,
    nh, L, hd), gkv (2, B, nh, L, hd), qg (B, nh, G, hd) (None without global
    rows), the row statistics stats (3, B, nh, L) and gstats (3, B, nh, G)
    and counts (B, 2) (``sliding_core_model_dproj``). In bf16 the dk/dv
    pass stores dS in a buffer of ``sliding_ds_elements`` for the dq pass.
    ``sliding_train_bwd.launches`` counts its launches."""
    B, L, H = hidden.shape
    HN = w["wo"].shape[0]
    hd = HN // num_heads
    dev, dt = hidden.device, hidden.dtype
    G = global_columns(max_globals, L)
    slots = 6 if global_rows else 3
    f32 = torch.float32
    empty = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    w_all = w["wqkv"]
    if global_rows:
        wg = torch.cat([w["wgq"].reshape(H, 1, HN), w["wgkv"].reshape(H, 2, HN)], dim=1)
        w_all = torch.cat([w["wqkv"], wg.reshape(H, 3 * HN)], dim=1).contiguous()
    bufs = dict(
        counts=empty(B, 2, dtype=torch.int32), qkv=empty(3, B, num_heads, L, hd),
        gkv=empty(2, B, num_heads, L, hd) if global_rows else None, ctx=empty(B, L, HN),
        dctx=empty(B, L, HN), stats=empty(3, B, num_heads, L, dtype=f32),
        gstats=empty(3, B, num_heads, G, dtype=f32) if global_rows else None,
        qg=empty(B, num_heads, G, hd) if global_rows else None, dproj=empty(B * L, slots * HN),
    )
    ds = empty(sliding_ds_elements(B, num_heads, L, window)) if dt == torch.bfloat16 else None
    dx = torch.empty_like(hidden)
    dw_all, db_all = empty(H, slots * HN, dtype=f32), empty(slots * HN, dtype=f32)
    dwo, dbo = empty(HN, H, dtype=f32), empty(H, dtype=f32)
    splits, ws, floats = weight_grad_plan(dev, dt, B * L, (H, slots * HN), (HN, H))
    with torch.cuda.device(dev):
        code = build.library().spk_sliding_train_bwd(
            _DTYPES[dt], *(_ptr(t) for t in (hidden, mask, glob, seed, w["wqkv"], w["bqkv"],
                                              w["wgq"], w["bgq"], w["wgkv"], w["bgkv"], w["wo"],
                                              w_all, g, *bufs.values(), ds, dx, dw_all, db_all,
                                              dwo, dbo, ws)),
            floats, *splits, B, L, H, num_heads, hd, window // 2, G, int(global_rows),
            float(sm_scale), dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream(),
        )
    build.check(code, "sliding_train_bwd")
    sliding_train_bwd.launches += 1
    if buffers is not None:
        buffers.update(ctx=bufs["ctx"].reshape(B * L, HN), dctx=bufs["dctx"].reshape(B * L, HN),
                       dproj=bufs["dproj"], w_all=w_all, qkv=bufs["qkv"], gkv=bufs["gkv"],
                       qg=bufs["qg"], stats=bufs["stats"], gstats=bufs["gstats"],
                       counts=bufs["counts"])
    return _split_grads(B, L, H, HN, global_rows, dx, dw_all, db_all, dwo, dbo)


for _fn in (sliding_train_fwd, sliding_train_bwd):
    _fn.launches = 0


class _SlidingTrain(torch.autograd.Function):
    """The kernels as one differentiable function of (hidden and the float32
    parameters); saves only the inputs and the seed."""

    @staticmethod
    def forward(ctx, hidden, mask, glob, seed, qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias,
                out_kernel, out_bias, config):
        w = card_weights(qkv_kernel, qkv_bias, gqkv_kernel, gqkv_bias, out_kernel, hidden.dtype)
        out = sliding_train_fwd(hidden, mask, glob, seed, w, out_bias.detach().float().contiguous(),
                                **config)
        ctx.save_for_backward(hidden, mask, glob, seed, *w.values())
        ctx.names, ctx.config = list(w), config
        return out

    @staticmethod
    def backward(ctx, g):
        hidden, mask, glob, seed, *ws = ctx.saved_tensors
        w = dict(zip(ctx.names, ws))
        H = hidden.shape[-1]
        nh = ctx.config["num_heads"]
        hd = w["wo"].shape[0] // nh
        dx, dwqkv, dbqkv, dwg, dbg, dwo, dbo = sliding_train_bwd(
            hidden, mask, glob, seed, w, g.to(hidden.dtype).contiguous(), **ctx.config)
        return (dx, None, None, None, dwqkv.reshape(H, 3, nh, hd), dbqkv.reshape(3, nh, hd),
                dwg.reshape(H, 3, nh, hd), dbg.reshape(3, nh, hd), dwo.reshape(nh, hd, H), dbo,
                None)


def sliding_attention_block_train(
    hidden: torch.Tensor,  # (B, L, H) compute dtype
    attention_mask: torch.Tensor,  # (B, L) int; suffix padding
    global_mask: torch.Tensor,  # (B, L) int; a prefix of globals
    qkv_kernel: torch.Tensor,  # (H, 3, nh, hd) float32 parameter
    qkv_bias: torch.Tensor,  # (3, nh, hd)
    gqkv_kernel: torch.Tensor,  # (H, 3, nh, hd) global projections
    gqkv_bias: torch.Tensor,
    out_kernel: torch.Tensor,  # (nh, hd, H)
    out_bias: torch.Tensor,  # (H,)
    seed: torch.Tensor,  # (1,) int32: the dropout stream (ignored at rate 0)
    *,
    sm_scale: float,
    window: int,
    max_globals: int = 16,
    dropout_rate: float = 0.0,
    global_rows: bool = True,
) -> torch.Tensor:
    """Differentiable Longformer attention block of the training path;
    returns (B, L, H) in hidden's dtype, before hidden-state dropout,
    residual and LayerNorm. A CUDA tensor that breaks the contract of
    ``ops/cuda/sliding_block.py`` raises."""
    kw = dict(sm_scale=sm_scale, window=window, max_globals=max_globals, global_rows=global_rows,
              dropout_rate=dropout_rate)
    if hidden.device.type == "cpu":
        keep = None
        if dropout_rate > 0.0:
            B, L, _ = hidden.shape
            keep = sliding_keep_masks(seed, B, qkv_kernel.shape[2], L, window,
                                      global_columns(max_globals, L), dropout_rate)
        return sliding_train_plain(hidden, attention_mask, global_mask, qkv_kernel, qkv_bias,
                                   gqkv_kernel, gqkv_bias, out_kernel, out_bias, keep=keep, **kw)
    where = "sliding_attention_block_train"
    check_card_inputs(where, hidden, attention_mask, global_mask, qkv_kernel, qkv_bias,
                      gqkv_kernel, gqkv_bias, out_kernel, out_bias, window, max_globals)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"{where}: dropout_rate {dropout_rate} not in [0, 1)")
    config = dict(num_heads=qkv_kernel.shape[2], window=window, max_globals=max_globals,
                  global_rows=global_rows, sm_scale=float(sm_scale),
                  dropout_rate=float(dropout_rate))
    return _SlidingTrain.apply(
        hidden.contiguous(), attention_mask.to(torch.int32).contiguous(),
        global_mask.to(torch.int32).contiguous(), seed.to(torch.int32).contiguous(), qkv_kernel,
        qkv_bias, gqkv_kernel, gqkv_bias, out_kernel, out_bias, config)
